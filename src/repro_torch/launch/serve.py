"""Continuous-batching serve engine with a PAGED KV cache: batched bucketed
prefill and chunked greedy decode, optionally executing every matmul through
the IMC simulation.

  python -m repro_torch.launch.serve --arch musicgen-medium --smoke \
      --batch 4 --requests 8 --prompt-lens 4,6,48,5 --gen 8 --device cpu

Engine design (the PyTorch counterpart of ``repro.launch.serve.Engine``):

  paged KV cache       global-attention K/V lives in a shared block pool
                       (num_blocks, block, Hkv, hd) per layer, indexed through
                       a per-slot block table (slots, max_blocks) on the
                       device.  The host-side ``BlockAllocator`` hands out
                       blocks; physical block 0 is the garbage block that
                       inactive and overrun rows write to.  Sliding-window
                       rings (bounded at the window span) and recurrent
                       states (SSD, RG-LRU: fixed size) stay contiguous per
                       slot, are written whole at admission and count as
                       fixed KV bytes (``kv_pool_bytes``).  A pattern with
                       no global attention keeps a pool of one block.
  batched prefill      the FIFO prefix of pending requests sharing one
                       power-of-two bucket is admitted as ONE (R, bucket)
                       prefill (R padded to a power of two), then ONE insert
                       writes each row's prompt K/V into its blocks and its
                       block-table row.  Recurrent and MoE patterns prefill
                       at the exact length (``needs_exact_prefill``: pad
                       tokens would enter the state or contend for expert
                       capacity), and MoE admits one request per prefill.
  lazy allocation      admission allocates the prompt's blocks; generation
                       blocks are allocated on the block-boundary crossing
                       before each decode chunk.  Pool exhaustion preempts
                       the newest-admitted slot (recompute-preemption): its
                       blocks are freed and it re-queues with its generated
                       tokens, and re-admission prefills prompt + out.
  decode chunks        T decode steps run as a Python loop whose tokens,
                       positions and active mask stay on the device; the
                       (slots, T) int32 token block is the ONE device-to-host
                       transfer per chunk.  T is the largest power of two no
                       active request overruns.  (The reference fuses the
                       chunk with ``lax.scan``; a CUDA graph of the chunk is
                       later work.)
  metering             an optional ``launch.metering.DPMeter`` counts the
                       billed dot-product work of each prefill group and
                       decode chunk (host-side integers);
                       ``--energy-report`` bills it at the min-energy
                       QS/QR/CM design points.
  SLO serving          ``serve_slo`` releases seeded requests at their
                       virtual arrival times (``runtime.workload``), orders
                       and sheds the queue under a ``launch.scheduler``
                       policy, and may walk the EDAP frontier under load
                       (``PressureController`` -> ``swap_substrate``).  Time
                       is a ``VirtualClock`` in decode-step units, so every
                       SLO metric is a deterministic function of the seed.
  prefix sharing       with ``prefix_cache=True`` a radix index
                       (``runtime.prefix_cache``) maps full-block token
                       chunks to the pool blocks that hold their K/V.  A
                       head request whose prompt starts with a cached chain
                       links those blocks into its block-table row (refcounts
                       in the allocator) and prefills only the uncached
                       suffix, as a teacher-forced loop of decode steps with
                       one active row.  A fully cached prompt re-feeds its
                       last token into a private copy of the last shared
                       block (copy-on-write).  Idle cached blocks are evicted
                       LRU leaf-first when the free list runs short.
  drift monitoring     with a ``runtime.drift.DriftMonitor`` (frozen
                       substrates only), every Nth decode chunk / prefill
                       group runs under ``core.substrate.shadow_recording``:
                       outputs unchanged, running maxima kept on the device.
                       At the monitor's cadence the detector reads them and
                       a drifted report hot-swaps a refreshed calibration
                       between chunks (``swap_calibration``).
  failure isolation    a transient device error (``runtime.fault``) on a
                       prefill group, a warm prefill or a decode chunk is
                       retried once with the same call on the same device
                       (a decode chunk first puts back the ring rows and
                       the recurrent states it overwrote).  Under a mesh
                       the ranks vote on an error raised before the call's
                       first collective (the failure injector's), and
                       retry together; an error inside a collective is not
                       retried: every rank ends with an error.
                       If it persists, a batched group re-admits each member
                       alone (a poison row fails alone), a warm admission
                       fails its request, and a decode chunk fails only the
                       requests in flight.  Kernel launch or build failures
                       are not transient: they propagate.

  tensor parallelism   with ``mesh=`` (a ``launch.mesh.Mesh`` of shape
                       (1, N)) each rank runs this engine on its shard of
                       the weights (``launch.sharding``): query heads, SSD
                       heads, the RG-LRU width, d_ff, vocabulary and experts
                       split over the ranks, with explicit collectives
                       (``core.parallel``); a unit that does not divide N
                       stays whole on every rank and its sites run with no
                       collective.  The paged pools are head-sharded when N
                       divides Hkv and replicated otherwise; block tables
                       and the allocator stay whole on every rank, and the
                       paged-attention kernel runs per rank at the local
                       layout.  Recurrent states hold the rank's heads or
                       channels.  Every rank runs the same host loop on the
                       same gathered logits, so every scheduling decision
                       agrees; calibration and drift statistics are reduced
                       over the group, so every rank swaps at the same
                       chunk; a transient error before a call's first
                       collective is voted on, and every rank retries
                       together.  Only R > 1 raises.

Greedy sampling.  Noise seeds are integers (``rng``); with a frozen
calibration and ``rng=None`` the batched engine equals sequential execution,
a warm admission equals a cold one, and a (1, N) mesh gives the tokens of
one device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import parallel
from repro_torch.core import substrate as substrate_lib
from repro_torch.kernels import prng
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import (
    decode_step,
    init_paged_cache,
    init_params,
    param_bytes,
    prefill,
    resolve_device,
)
from repro_torch.runtime import fault as fault_lib
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.tree import map_leaves

log = logging.getLogger("repro_torch.serve")

MIN_BUCKET = 8
DEFAULT_BLOCK = 8  # tokens per KV block; divides every pow2 bucket >= 8


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,)
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: Optional[float] = None
    t_first: Optional[float] = None  # first generated token on the host
    error: Optional[str] = None
    error_kind: Optional[str] = None  # admission|prefill|decode|shed
    # SLO workload metadata (runtime.workload): virtual arrival time,
    # per-class deadlines (relative to arrival / between tokens), class
    arrive_at: Optional[float] = None
    ttft_deadline: Optional[float] = None
    itl_deadline: Optional[float] = None
    rclass: str = "default"
    # true generation length (an EOS the engine cannot know at admission)
    stop_at: Optional[int] = None
    preemptions: int = 0
    # virtual completion time of each generated token (stamped only when the
    # engine runs under a VirtualClock)
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

    @property
    def shed(self) -> bool:
        return self.error_kind == "shed"

    @property
    def effective_max(self) -> int:
        """Tokens this request will actually generate (EOS-capped)."""
        if self.stop_at is None:
            return self.max_new
        return min(self.max_new, self.stop_at)

    @property
    def full_prompt(self) -> np.ndarray:
        """The resume prompt: original prompt plus every generated token."""
        if not self.out:
            return self.prompt
        return np.concatenate([np.asarray(self.prompt),
                               np.asarray(self.out)]).astype(
                                   np.asarray(self.prompt).dtype)

    @property
    def ttft(self) -> Optional[float]:
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


def needs_exact_prefill(cfg) -> bool:
    """Patterns that cannot take padded (bucketed) prefill: recurrent state
    integrates pad garbage; MoE pad tokens contend for expert capacity."""
    kinds = tuple(cfg.pattern) + tuple(cfg.tail_kinds)
    return any(k in ("ssm", "rglru") for k in kinds) or cfg.n_experts > 0


def prefill_bucket(length: int, bucketable: bool, cache_len: int) -> int:
    """Power-of-two prefill bucket for a prompt length (>= length); exact
    length when the pattern requires it."""
    if not bucketable:
        return length
    p = MIN_BUCKET
    while p < length:
        p *= 2
    return min(p, cache_len) if cache_len >= length else p


class BlockAllocator:
    """Refcounting free-list allocator over the physical KV block pool.

    Contract (as in the reference, property-tested):
      - block 0 is reserved (the garbage block) and is never handed out;
      - ``alloc(n)`` returns n distinct free blocks or None (never partial);
      - ``free(blocks)`` releases one reference per block; a block returns
        to the free list when its last reference drops, and is reusable at
        once;
      - ``retain`` adds a sharer; ``register_cached`` parks a block whose
        refcount drops to zero on an insertion-ordered idle list instead of
        the free list; ``evict`` reclaims one idle cached block;
      - conservation: ``free_count + referenced + idle_cached`` is invariant
        at ``num_blocks - 1``.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("need at least the reserved garbage block")
        self.num_blocks = num_blocks
        # LIFO free list: recently freed blocks are reused first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._allocated: set = set()
        self._ref: Dict[int, int] = {}
        self._cached: set = set()
        self._idle: Dict[int, None] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._allocated)

    @property
    def evictable_count(self) -> int:
        return len(self._idle)

    def refcount(self, b: int) -> int:
        return self._ref.get(b, 0)

    def is_evictable(self, b: int) -> bool:
        return b in self._idle

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def retain(self, blocks: List[int]):
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"retain of unallocated block {b}")
            self._ref[b] = self._ref.get(b, 0) + 1
            self._idle.pop(b, None)

    def free(self, blocks: List[int]):
        for b in blocks:
            if b not in self._allocated or self._ref.get(b, 0) <= 0:
                raise ValueError(f"double free / foreign block {b}")
            self._ref[b] -= 1
            if self._ref[b] > 0:
                continue
            if b in self._cached:
                self._idle[b] = None
            else:
                del self._ref[b]
                self._allocated.remove(b)
                self._free.append(b)

    def register_cached(self, b: int):
        if b not in self._allocated:
            raise ValueError(f"cannot cache unallocated block {b}")
        self._cached.add(b)
        if self._ref.get(b, 0) == 0:
            self._idle[b] = None

    def evict(self, b: int):
        if b not in self._idle:
            raise ValueError(
                f"block {b} is not evictable (referenced or uncached)")
        del self._idle[b]
        self._cached.remove(b)
        self._ref.pop(b, None)
        self._allocated.remove(b)
        self._free.append(b)


class Engine:
    """Fixed-slot continuous-batching engine over a paged KV cache.

    Host-side state is bookkeeping (which request owns which slot and which
    physical blocks); the pools, block tables, per-slot positions and last
    tokens live on the device of ``params``.  ``meter`` (a
    ``launch.metering.DPMeter``) counts billed work; ``clock`` (a
    ``runtime.workload.VirtualClock``) makes admission and decode advance
    virtual time and stamp it on requests instead of the host clock.
    ``drift_monitor`` (a ``runtime.drift.DriftMonitor``, frozen substrates
    only) shadow-samples chunks; ``drift_pause_depth`` pauses the sampling
    while the serve loop's queue is deeper.  ``failure_injector(phase,
    info)`` is called right before the device work of a prefill
    (``"prefill"``, the rids) or a decode chunk (``"decode"``, the chunk
    index); raising there simulates a device error.  ``prefix_cache``
    enables prefix-sharing admission.  ``mesh`` (a ``launch.mesh.Mesh``)
    serves tensor-parallel: ``params`` is then this rank's shard
    (``launch.sharding.shard_params`` or ``launch.sharding.init_params``),
    and every rank of the mesh must drive its engine with the same calls.
    """

    def __init__(self, cfg, params, batch_slots: int, cache_len: int,
                 rng: Optional[int] = None, max_chunk: int = 8,
                 block_size: int = DEFAULT_BLOCK,
                 kv_blocks: Optional[int] = None, meter=None,
                 alloc_policy: str = "lazy", clock=None,
                 drift_monitor=None,
                 failure_injector: Optional[Callable[[str, Any], None]] = None,
                 drift_pause_depth: Optional[int] = None,
                 prefix_cache: bool = False, mesh=None):
        if alloc_policy not in ("lazy", "reserve"):
            raise ValueError(f"unknown alloc_policy {alloc_policy!r}")
        self.mesh = mesh
        self.tp = mesh_lib.axis_size(mesh, "model") if mesh else 1
        self.group = None  # the shard group, when tp > 1
        if mesh is not None:
            self._check_mesh(cfg, mesh)
        if self.tp > 1:
            self.group = sharding.shard_group(cfg, mesh)
        # head-sharded pools (else replicated, or one device's)
        self.kv_shard = self.group is not None and self.group.kv_shard
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.substrate = substrate_lib.as_substrate(cfg.imc)
        self.swap_count = 0
        # the meter bills the substrate that actually runs
        self.meter = meter
        if meter is not None and getattr(meter, "substrate", None) is None:
            meter.substrate = self.substrate
        if drift_monitor is not None and self.calibration is None:
            raise ValueError(
                "drift monitoring requires a frozen-policy substrate "
                "(there are no frozen ranges to compare shadow stats "
                "against)")
        self._drift = drift_monitor
        self.drift_pause_depth = drift_pause_depth
        self.failure_injector = failure_injector
        self.clock = clock
        # the SLO serve loop publishes its queue length here each tick
        self.queue_depth = 0
        self.batch_slots = batch_slots
        self.block = block_size
        self.max_blocks = -(-cache_len // block_size)
        self.cache_len = self.max_blocks * block_size
        self.max_chunk = max_chunk
        self.rng = rng
        self._key_count = 0
        self.bucketable = not needs_exact_prefill(cfg)
        # MoE expert capacity couples the rows of a batch: a batched prefill
        # would route differently than one request alone, so R = 1 there
        self.batch_prefill = cfg.n_experts == 0
        kinds = tuple(cfg.pattern) + tuple(cfg.tail_kinds)
        self.has_paged = "attn" in kinds
        if kv_blocks is None:
            # full provisioning: admission never stalls on blocks
            kv_blocks = batch_slots * self.max_blocks + 1
        if not self.has_paged:
            kv_blocks = 1  # nothing is paged: the garbage block alone
        self.alloc = BlockAllocator(kv_blocks)
        self.alloc_policy = alloc_policy
        # prefix sharing is sound only when EVERY per-request KV byte lives
        # in the paged pool, so that linking blocks reconstructs a cached
        # prefix exactly: a sliding-window ring, a recurrent state or MoE
        # routing (capacity couples the rows) cannot be, so those serve cold
        if prefix_cache and not (self.has_paged and cfg.n_experts == 0
                                 and all(k == "attn" for k in kinds)):
            log.info("prefix cache disabled: pattern %s carries non-paged "
                     "per-request state", kinds)
            prefix_cache = False
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(block_size) if prefix_cache else None)
        # prefix-sharing counters (a miss is a cold admission with the cache
        # on)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_saved_tokens = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        # decode steps run by warm admissions' suffix prefills
        self.warm_steps = 0

        self.slots: List[Optional[Request]] = [None] * batch_slots
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_slots)]
        self._slot_pos: List[int] = [0] * batch_slots
        self._slot_seq: List[int] = [0] * batch_slots
        self._admit_seq = 0
        self.preempted: List[Request] = []
        with parallel.use(self.group):  # this rank's KV heads
            cache = init_paged_cache(cfg, batch_slots, self.cache_len,
                                     kv_blocks, block_size,
                                     device=self.device)
        cache.pop("pos")
        self.cache = cache
        # every layer group's cache with a leading layer axis: the pattern
        # positions' stacked leaves, and views of each remainder layer's
        self._groups = _layer_groups(cache)
        # this rank's pools, rings and states
        (self._block_bytes, self._fixed_kv_bytes,
         self.state_bytes_per_slot) = self._kv_accounting(self._groups)
        # the whole cache (one device's): head-sharded pools and the
        # recurrent states' rank shares counted once each
        self._whole_kv = (self._block_bytes, self._fixed_kv_bytes)
        if self.group is not None:
            meta = init_paged_cache(cfg, batch_slots, self.cache_len,
                                    kv_blocks, block_size, device="meta")
            meta.pop("pos")
            self._whole_kv = self._kv_accounting(_layer_groups(meta))[:2]
        if self.prefix is not None and self._fixed_kv_bytes > 0:
            # a contiguous ring or recurrent leaf: part of the per-request
            # state is not addressable through block tables
            log.info("prefix cache disabled: %d bytes of contiguous "
                     "per-request KV state", self._fixed_kv_bytes)
            self.prefix = None
        self.pos = torch.zeros((batch_slots,), dtype=torch.int64,
                               device=self.device)
        self.last_token = torch.zeros((batch_slots,), dtype=torch.int64,
                                      device=self.device)
        self.finished: List[Request] = []

        self.decode_calls = 0
        self.decode_steps = 0
        self.host_transfer_bytes = 0
        self.prefill_calls = 0
        self.prefill_rows = 0
        self.failed_requests = 0
        self.decode_failures = 0
        self.shed_requests = 0
        self.preempt_count = 0
        self.substrate_swaps = 0
        # retried calls, and (under a mesh) the fault votes and their time
        self.retries = 0
        self.votes = 0
        self.vote_seconds = 0.0
        # pool-utilization accounting, sampled once per decode chunk
        self._util_token_sum = 0
        self._util_cap_sum = 0
        if meter is not None and mesh is not None:
            meter.note_mesh(self.mesh_shape, mesh.size,
                            self.kv_pool_bytes_per_device())

    # -- tensor parallelism ---------------------------------------------------
    @staticmethod
    def _check_mesh(cfg, mesh):
        """Refuse what this port does not shard yet (ROADMAP): slots over
        data replicas."""
        if mesh.data != 1:
            raise ValueError(f"a {mesh.data}x{mesh.model} mesh shards slots "
                             "over data replicas, which is not served yet: "
                             "use a 1xN mesh")
        if mesh.rank < 0:
            raise ValueError("this rank is not in the mesh")
        tp = mesh.model
        if tp == 1:
            return
        if sharding.kv_sharded(cfg, tp):
            # contiguous per-rank head ranges; raises on uneven splits
            sharding.kv_head_partition(cfg.n_kv_heads, tp)
        else:
            log.info("KV pools replicated: %d KV heads do not divide the "
                     "%d-way model axis", cfg.n_kv_heads, tp)
        whole = sharding.replicated_sites(cfg, tp)
        if whole:
            log.info("replicated on every rank (their units do not divide "
                     "the %d-way model axis): %s", tp, sorted(whole))

    @property
    def mesh_shape(self) -> Optional[str]:
        """The mesh as an ``RxC`` string ("1x4"), None when single-device."""
        if self.mesh is None:
            return None
        return f"{self.mesh.data}x{self.mesh.model}"

    def _retried(self, fn, describe: str, phase: str, info, undo=None):
        """``fn()`` after the failure injector's call ``(phase, info)``,
        retried once on a transient device error (``undo()`` first puts
        back what a failed run overwrote).

        Under a mesh a retry on one rank alone would leave the others
        waiting in a collective, so where an injector runs (every rank
        builds its engine with one) the ranks vote: after the injector,
        before ``fn``'s first collective, every rank says whether it failed
        (a host-side all-reduce, ``ShardGroup.vote``), and if any did,
        every rank undoes and retries together.  Without an injector
        nothing can fail before that collective, and there is no vote.  An
        error inside ``fn`` is raised inside a collective, where the others
        cannot hear of it: it is not retried, and every rank ends with an
        error (the others when their next collective times out,
        ``launch.mesh.RANK_TIMEOUT``)."""
        transient = fault_lib.is_transient_device_error
        for attempt in range(2):
            err = None
            try:
                if self.failure_injector is not None:
                    self.failure_injector(phase, info)
                if self.group is None:
                    return fn()
            except Exception as e:
                if not transient(e):
                    raise
                err = e
            if self.group is not None:
                failed = err is not None
                if self.failure_injector is not None:
                    t0 = time.perf_counter()
                    failed = self.group.vote(failed)
                    self.vote_seconds += time.perf_counter() - t0
                    self.votes += 1
                if not failed:
                    try:
                        return fn()
                    except Exception as e:
                        if transient(e):
                            raise RuntimeError(
                                f"{describe} failed on rank "
                                f"{self.group.rank} inside a collective: not "
                                "retried under a mesh") from e
                        raise
                if err is None:
                    err = fault_lib.TransientDeviceError(
                        f"{describe} failed on another rank")
            if undo is not None:
                undo()
            if attempt:
                raise err
            self.retries += 1
            log.warning("%s attempt 0 failed: %r; retrying", describe, err)
        raise AssertionError("unreachable")

    # -- bookkeeping ----------------------------------------------------------
    def _paged_layers(self):
        """The stacked {"pk","pv","bt"} dict of every paged layer group."""
        return [c for c in self._groups if "pk" in c]

    def _kv_accounting(self, groups) -> Tuple[int, int, int]:
        """(bytes per physical block summed over the paged layers, bytes of
        the always-allocated contiguous per-slot leaves: sliding-window rings
        and recurrent states, the recurrent part's bytes per slot) of a
        cache's layer groups.  The reference counts the rings only;
        ``state_bytes_per_slot`` is the recurrent part."""
        block_bytes = fixed = state = 0
        for c in groups:
            if "pk" in c:
                for leaf in (c["pk"], c["pv"]):  # (L, NB, bs, Hkv, hd)
                    block_bytes += (leaf.numel() // leaf.shape[1]
                                    * leaf.element_size())
                continue
            for key, leaf in c.items():
                n = leaf.numel() * leaf.element_size()
                fixed += n
                if key not in ("k", "v"):
                    state += n
        return block_bytes, fixed, state // self.batch_slots

    def kv_pool_bytes(self) -> int:
        """Bytes of the whole KV cache: every physical block plus the
        rings and recurrent states, as one device holds them (a mesh's
        head-sharded pools and state shares over every rank, its
        replicated ones once)."""
        block_bytes, fixed = self._whole_kv
        return fixed + self.alloc.num_blocks * block_bytes

    def kv_pool_bytes_per_device(self) -> int:
        """Bytes of the KV cache on this rank's device: head-sharded pools
        and rings and the recurrent states carry this rank's share,
        replicated ones all of it."""
        return (self._fixed_kv_bytes
                + self.alloc.num_blocks * self._block_bytes)

    def live_tokens(self) -> int:
        """Tokens currently resident in active slots' caches."""
        return sum(len(r.prompt) + len(r.out) for r in self.slots
                   if r is not None)

    def pool_utilization(self) -> float:
        """Chunk-averaged live tokens per allocated-block token capacity:
        the share of the reserved KV memory that backs live tokens."""
        if self._util_cap_sum == 0:
            return 0.0
        return self._util_token_sum / self._util_cap_sum

    def _now(self) -> float:
        return self.clock.now if self.clock is not None else time.perf_counter()

    def _next_key(self) -> Optional[int]:
        if self.rng is None:
            return None
        self._key_count += 1
        return prng.derive_seed(self.rng, self._key_count)

    @property
    def calibration(self) -> Optional[substrate_lib.Calibration]:
        """The live frozen calibration (None under a dynamic policy)."""
        if self.substrate.policy != "frozen":
            return None
        return self.substrate.calibration

    def _shadow(self, on: bool):
        """The context a sampled call runs in: shadow recording into the
        drift monitor's recorder, or nothing."""
        if not on:
            return contextlib.nullcontext()
        return substrate_lib.shadow_recording(self._drift.recorder)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _bucket(self, req: Request) -> int:
        return prefill_bucket(len(req.full_prompt), self.bucketable,
                              self.cache_len)

    def _total_positions(self, req: Request) -> int:
        """Worst-case K/V positions over the request's life (ignores
        ``stop_at``, which the engine cannot know at admission)."""
        return len(req.prompt) + req.max_new - 1

    def _blocks_total(self, req: Request) -> int:
        if not self.has_paged:
            return 0
        return -(-self._total_positions(req) // self.block)

    def _blocks_needed(self, req: Request) -> int:
        """Blocks allocated at admission: the prompt insert's coverage (lazy)
        or the worst case (reserve)."""
        if not self.has_paged:
            return 0
        if self.alloc_policy == "reserve":
            return self._blocks_total(req)
        return -(-len(req.full_prompt) // self.block)

    def _fits(self, req: Request) -> bool:
        return (self._total_positions(req) <= self.cache_len
                and self._blocks_total(req) <= self.alloc.num_blocks - 1)

    def _admission_error(self, req: Request) -> Optional[str]:
        if self._total_positions(req) > self.cache_len:
            return (f"prompt ({len(req.prompt)}) + max_new ({req.max_new}) "
                    f"exceeds cache_len ({self.cache_len})")
        if self._blocks_total(req) > self.alloc.num_blocks - 1:
            return (f"request {req.rid} needs {self._blocks_total(req)} KV "
                    f"blocks; pool has {self.alloc.num_blocks - 1}")
        return None

    def fail_request(self, req: Request, error: str,
                     kind: str = "admission"):
        """Retire an unadmitted request with a per-request error status;
        ``kind`` is "admission", "prefill", "decode" or "shed" (the
        scheduler's load-shedding path)."""
        req.done = True
        req.error = error
        req.error_kind = kind
        self.finished.append(req)
        self.failed_requests += 1
        if kind == "shed":
            self.shed_requests += 1
            if self.meter is not None:
                self.meter.note_shed()
        if self.meter is not None:
            self.meter.note_request_failure()
        log.warning("request %d failed (%s): %s", req.rid, kind, error)

    # -- admission ------------------------------------------------------------
    def admit_pending(self, pending: List[Request]) -> List[Request]:
        """Admit as many pending requests as slots and KV blocks allow, one
        batched (R, bucket) prefill per FIFO-prefix group sharing the head's
        bucket.  Removes admitted requests from ``pending``."""
        admitted: List[Request] = []
        while pending:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            err = self._admission_error(pending[0])
            if err is not None:
                self.fail_request(pending.pop(0), err)
                continue
            if self.prefix is not None:
                # a prefix-hit head admits alone through the warm path; only
                # the head is considered, so FIFO order holds
                state = self._try_admit_prefix(pending[0], free_slots[0])
                if state == "admitted":
                    admitted.append(pending.pop(0))
                    continue
                if state == "defer":
                    break  # the head waits for blocks or evictions
                if state == "failed":
                    pending.pop(0)  # retired through fail_request
                    continue
                # "miss": the cold batched path below
            bucket = self._bucket(pending[0])
            group: List[Request] = []
            reserved = 0
            limit = len(free_slots) if self.batch_prefill else 1
            for r in pending:
                if len(group) >= limit or self._bucket(r) != bucket:
                    break
                if not self._fits(r):
                    break
                need = self._blocks_needed(r)
                # idle cached prefix blocks count as capacity: _alloc_blocks
                # evicts them when the free list runs short
                if reserved + need > (self.alloc.free_count
                                      + self.alloc.evictable_count):
                    break
                group.append(r)
                reserved += need
            if not group:
                break  # head-of-line request waits for blocks to free
            ok = self._admit_group(group, free_slots[: len(group)], bucket)
            del pending[: len(group)]
            admitted.extend(ok)
        return admitted

    @torch.inference_mode()
    def _admit_group(self, group: List[Request], slot_ids: List[int],
                     bucket: int) -> List[Request]:
        """Prefill and insert one admitted group; returns the requests that
        reached a slot.  A transient device error is retried once; if the
        batched prefill still fails, its blocks are freed and each member
        retries alone, so a poison request fails alone."""
        now = self._now()
        r_real = len(group)
        r_pad = 1
        while r_pad < r_real:
            r_pad *= 2
        toks = np.zeros((r_pad, bucket), np.int64)
        true_len = np.ones((r_pad,), np.int64)
        bt_rows = np.zeros((r_real, self.max_blocks), np.int32)
        for r, req in enumerate(group):
            if req.t_submit is None:
                req.t_submit = now
            pvec = req.full_prompt
            toks[r, : len(pvec)] = pvec
            true_len[r] = len(pvec)
            blocks = self._alloc_blocks(self._blocks_needed(req))
            if blocks is None:
                raise RuntimeError("admission reserved blocks it cannot get")
            self._slot_blocks[slot_ids[r]] = blocks
            bt_rows[r, : len(blocks)] = blocks
        shadow = (self._drift is not None and not self._drift_paused()
                  and self._drift.take_prefill_sample())
        rids = tuple(r.rid for r in group)
        dev = self.device

        def run_pf():
            with self._shadow(shadow), parallel.use(self.group):
                logits, cache1 = prefill(
                    self.params, self.cfg, torch.as_tensor(toks, device=dev),
                    cache_len=bucket, rng=self._next_key(),
                    true_len=(torch.as_tensor(true_len, device=dev)
                              if self.bucketable else None))
            return torch.argmax(logits[:, -1], dim=-1), cache1

        try:
            tok0, cache1 = self._retried(
                run_pf, f"prefill group rids={list(rids)}", "prefill", rids)
        except Exception as e:
            if not fault_lib.is_transient_device_error(e):
                raise  # kernel and programming faults surface
            for sid in slot_ids:  # nothing was inserted: free the blocks
                if self._slot_blocks[sid]:
                    self.alloc.free(self._slot_blocks[sid])
                    self._slot_blocks[sid] = []
            if r_real == 1:
                self.fail_request(group[0],
                                  f"prefill failed after retry: {e!r}",
                                  kind="prefill")
                return []
            log.warning("batched prefill of %d requests failed (%r); "
                        "re-admitting each alone to isolate the poison row",
                        r_real, e)
            ok: List[Request] = []
            for r, req in enumerate(group):
                ok.extend(self._admit_group([req], [slot_ids[r]],
                                            self._bucket(req)))
            return ok
        self._insert(cache1, slot_ids, bt_rows, tok0[:r_real],
                     true_len[:r_real])
        self.prefill_calls += 1
        self.prefill_rows += r_real
        if self.meter is not None:
            # bucket padding is billed work; pow2 pad rows are not
            self.meter.note_prefill(r_real, bucket,
                                    [len(r.prompt) for r in group])
            if shadow:
                self.meter.note_shadow_sample()
        tok0_host = tok0.cpu().numpy()  # one sync per GROUP
        if self.clock is not None:
            # one bucket's worth of token-forwards (rows run in parallel)
            self.clock.advance(bucket * self.clock.prefill_token_cost)
        t_first = self._now()
        for r, req in enumerate(group):
            sid = slot_ids[r]
            self.slots[sid] = req
            self._slot_pos[sid] = int(true_len[r])
            self._slot_seq[sid] = self._admit_seq
            self._admit_seq += 1
            if self.prefix is not None:
                # a cold admission under an enabled cache is a miss; its
                # full prompt blocks are indexed for later sharers
                self.prefix_lookups += 1
                if self.meter is not None:
                    self.meter.note_prefix_miss()
                self._register_prefix(req, sid)
            req.out.append(int(tok0_host[r]))
            if req.t_first is None:  # a resumed request keeps its real TTFT
                req.t_first = t_first
            if self.clock is not None:
                req.token_times.append(t_first)
            if len(req.out) >= req.effective_max:
                self._retire(sid)
        return list(group)

    def _insert(self, cache1, slot_ids, bt_rows, tok0, true_len):
        """Write a prefill group into the engine cache: each row's prompt K/V
        into its allocated blocks (logical block j -> bt_rows[r, j]; blocks
        past the allocation go to garbage block 0) and its block-table row
        into every paged layer's table; each contiguous leaf (a local
        layer's ring, a recurrent layer's state and conv inputs) into its
        slot, right-padded on every other axis (a prefill ring narrower than
        the engine's span has the identity layout, bucket < window; a prompt
        shorter than the conv window leaves fewer conv rows, padded as the
        reference pads them); then its first token and position."""
        bs = self.block
        dev = self.device
        slots = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        rows = torch.as_tensor(bt_rows, device=dev)
        r = len(slot_ids)
        prefs = list(cache1["blocks"].values()) + [
            map_leaves(lambda t: t[None], cache1["tail"][k])
            for k in self.cache.get("tail", {})]
        for eng, pref in zip(self._groups, prefs):
            if "pk" not in eng:
                for key, leaf in eng.items():
                    src = pref[key][:, :r]
                    pads = []
                    for ax in range(src.dim() - 1, 1, -1):
                        pads += [0, leaf.shape[ax] - src.shape[ax]]
                    leaf[:, slots] = torch.nn.functional.pad(
                        src, pads).to(leaf.dtype)
                continue
            eng["bt"][:, slots] = rows
            for pool_key, kv_key in (("pk", "k"), ("pv", "v")):
                pool, src = eng[pool_key], pref[kv_key][:, :r]
                s = src.shape[2]
                nbb = -(-s // bs)
                src = torch.nn.functional.pad(
                    src, (0, 0, 0, 0, 0, nbb * bs - s)).to(pool.dtype)
                src = src.reshape(src.shape[0], r * nbb, bs, *src.shape[3:])
                dest = rows[:, :nbb].reshape(-1).to(torch.int64)
                pool[:, dest] = src
        self.last_token[slots] = tok0
        self.pos[slots] = torch.as_tensor(true_len, device=dev)

    def _retire(self, i: int, error: Optional[str] = None,
                kind: str = "decode"):
        req = self.slots[i]
        req.done = True
        req.error = error
        self.slots[i] = None
        self._slot_pos[i] = 0
        self.finished.append(req)
        if error is not None:
            req.error_kind = kind
            self.failed_requests += 1
            if self.meter is not None:
                self.meter.note_request_failure()
            log.warning("request %d failed in slot %d: %s", req.rid, i, error)
        if self._slot_blocks[i]:
            # the stale device block table keeps pointing at these blocks;
            # that is safe because inactive rows write to the garbage block
            self.alloc.free(self._slot_blocks[i])
            self._slot_blocks[i] = []

    # -- lazy allocation + recompute-preemption --------------------------------
    def _preempt(self, i: int):
        """Evict slot ``i`` mid-generation, keeping its generated tokens; the
        serve loop re-queues it and re-admission prefills prompt + out."""
        req = self.slots[i]
        self.slots[i] = None
        self._slot_pos[i] = 0
        req.preemptions += 1
        if self._slot_blocks[i]:
            self.alloc.free(self._slot_blocks[i])
            self._slot_blocks[i] = []
        self.preempted.append(req)
        self.preempt_count += 1
        if self.meter is not None:
            self.meter.note_preemption()
        log.info("preempted request %d from slot %d (%d tokens kept)",
                 req.rid, i, len(req.out))

    def _pick_victim(self, grower: int) -> Optional[int]:
        """The latest-admitted active slot newer than the grower, or None."""
        candidates = [i for i, s in enumerate(self.slots)
                      if s is not None and i != grower
                      and self._slot_seq[i] > self._slot_seq[grower]]
        if not candidates:
            return None
        return max(candidates, key=lambda i: self._slot_seq[i])

    def _ensure_blocks(self, n_steps: int):
        """Before ``n_steps`` decode writes, every active slot must own blocks
        covering positions ``0 .. pos + n_steps - 1``.  Grows oldest-first;
        an allocation failure preempts victims until the grow fits or the
        grower itself yields.  New table entries go to the device in one
        indexed write per paged pattern position."""
        if not self.has_paged or self.alloc_policy != "lazy":
            return
        triples: List[Tuple[int, int, int]] = []
        order = sorted((i for i, s in enumerate(self.slots) if s is not None),
                       key=lambda i: self._slot_seq[i])
        for i in order:
            if self.slots[i] is None:
                continue  # preempted as a victim earlier in this pass
            need = -(-(self._slot_pos[i] + n_steps) // self.block)
            deficit = need - len(self._slot_blocks[i])
            if deficit <= 0:
                continue
            got = self._alloc_blocks(deficit)
            while got is None:
                victim = self._pick_victim(i)
                if victim is None:
                    self._preempt(i)
                    break
                self._preempt(victim)
                got = self._alloc_blocks(deficit)
            if got is None:
                continue
            have = len(self._slot_blocks[i])
            triples.extend((i, have + j, b) for j, b in enumerate(got))
            self._slot_blocks[i].extend(got)
        if not triples:
            return
        s, lg, ph = (torch.as_tensor(v, device=self.device)
                     for v in zip(*triples))
        for eng in self._paged_layers():
            eng["bt"][:, s, lg] = ph.to(torch.int32)

    # -- prefix sharing --------------------------------------------------------
    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """``alloc`` under eviction pressure: when the free list runs short,
        reclaim idle cached prefix blocks until the allocation fits or
        nothing is evictable."""
        if n == 0:
            return []
        blocks = self.alloc.alloc(n)
        while blocks is None and self._evict_one():
            blocks = self.alloc.alloc(n)
        return blocks

    def _evict_one(self) -> bool:
        """Evict ONE idle cached block: the least-recently-used leaf of the
        radix index whose block holds no reference.  Leaf-first keeps every
        remaining chain reachable."""
        if self.prefix is None:
            return False
        for node in self.prefix.leaves_lru():
            if self.alloc.is_evictable(node.block):
                self.prefix.remove(node)
                self.alloc.evict(node.block)
                self.prefix_evictions += 1
                return True
        return False

    def _register_prefix(self, req: Request, sid: int):
        """Index the admitted request's full prompt blocks for later
        sharers.  Only full blocks enter the index: every later write of
        this slot lands at a position past the prompt."""
        n_full = len(req.full_prompt) // self.block
        chain = self._slot_blocks[sid][:n_full]
        if n_full == 0 or len(chain) < n_full:
            return
        for b in self.prefix.insert(req.full_prompt, chain):
            self.alloc.register_cached(b)

    def _try_admit_prefix(self, req: Request, slot: int) -> str:
        """Warm admission of a prefix-hit head request into ``slot``.

        Links the longest cached chain of full blocks prefixing the (resume)
        prompt into the slot's block-table row and prefills only the
        uncached suffix (:meth:`_warm_prefill`).  At least one token is
        always re-fed, so the last position's logits exist; when the whole
        prompt is cached that re-feed writes inside the last shared block,
        which is first copied into a private block (copy-on-write).

        Returns "miss" (no cached prefix: the cold path), "defer" (a hit,
        but blocks are short: the head waits), "failed" (a persistent
        device error retired the request) or "admitted"."""
        pvec = req.full_prompt
        nodes = self.prefix.match(pvec)
        if not nodes:
            return "miss"
        length = len(pvec)
        bs = self.block
        m = len(nodes)
        start = min(bs * m, length - 1)  # always re-feed >= 1 token
        t_true = length - start
        cow = (start // bs) < m  # the re-feed lands in a shared block
        keep = nodes[:-1] if cow else nodes
        total = (self._blocks_total(req) if self.alloc_policy == "reserve"
                 else -(-length // bs))
        # retain every matched block (a copy-on-write source too) BEFORE
        # allocating, so eviction pressure cannot reclaim one of them
        matched = [n.block for n in nodes]
        self.alloc.retain(matched)
        fresh = self._alloc_blocks(total - len(keep))
        if fresh is None:
            self.alloc.free(matched)
            return "defer"
        blocks = [n.block for n in keep] + fresh
        if req.t_submit is None:
            req.t_submit = self._now()
        if cow:
            # private copy of the shared block; the suffix step overwrites
            # only position ``length - 1``.  The source's extra reference
            # drops once the copy is taken (it stays indexed)
            self._cow(nodes[-1].block, fresh[0])
            self.alloc.free([nodes[-1].block])
            self.cow_copies += 1
            if self.meter is not None:
                self.meter.note_cow_copy()
        bt_row = np.zeros((self.max_blocks,), np.int32)
        bt_row[: len(blocks)] = blocks

        def run_warm():
            return self._warm_prefill(slot, bt_row, pvec[start:], start,
                                      self._next_key())

        try:
            last_token, pos, tok0 = self._retried(
                run_warm, f"warm prefill rid={req.rid}", "prefill",
                (req.rid,))
        except Exception as e:
            if not fault_lib.is_transient_device_error(e):
                raise
            # the slot is not active, so its linked table row is never
            # written through; releasing the references unwinds the rest
            self.alloc.free(blocks)
            self.fail_request(req, f"warm prefill failed after retry: {e!r}",
                              kind="prefill")
            return "failed"
        self.last_token, self.pos = last_token, pos
        self._slot_blocks[slot] = blocks
        self.slots[slot] = req
        self._slot_pos[slot] = length
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1
        self.prefill_calls += 1
        self.prefill_rows += 1
        self.prefix_lookups += 1
        self.prefix_hits += 1
        self.prefix_hit_tokens += start
        self.warm_steps += t_true
        cold_bucket = self._bucket(req)
        self.prefix_saved_tokens += max(0, cold_bucket - t_true)
        if self.meter is not None:
            self.meter.note_prefix_admission(t_true, cold_bucket, start)
        if self.clock is not None:
            self.clock.advance(t_true * self.clock.prefill_token_cost)
        # register BEFORE appending tok0: tok0's K/V is written when it is
        # fed back on the first decode step
        self._register_prefix(req, slot)
        req.out.append(int(tok0))
        t_first = self._now()
        if req.t_first is None:
            req.t_first = t_first
        if self.clock is not None:
            req.token_times.append(t_first)
        if len(req.out) >= req.effective_max:
            self._retire(slot)
        log.info("prefix hit request %d: %d/%d tokens cached (%d blocks, "
                 "suffix %d%s)", req.rid, start, length, m, t_true,
                 ", CoW" if cow else "")
        return "admitted"

    @torch.inference_mode()
    def _warm_prefill(self, slot: int, bt_row: np.ndarray, suffix,
                      start: int, key: Optional[int]):
        """The suffix prefill as teacher-forced decode steps: link the slot's
        block-table row, start at ``start`` and feed the suffix one token a
        step with only ``slot`` active (every other row is fed token 0 and
        writes to the garbage block).  The tokens stay on the device.
        Returns (last tokens, positions, the last step's argmax): exactly
        the ``tok0`` a cold prefill of the whole prompt gives."""
        dev = self.device
        row = torch.as_tensor(bt_row, device=dev)
        for eng in self._paged_layers():
            eng["bt"][:, slot] = row
        fed = torch.zeros((len(suffix), self.batch_slots), dtype=torch.int64,
                          device=dev)
        fed[:, slot] = torch.as_tensor(np.asarray(suffix), device=dev)
        active = torch.zeros((self.batch_slots,), dtype=torch.bool,
                             device=dev)
        active[slot] = True
        pos = self.pos.clone()
        pos[slot] = start
        for t in range(len(suffix)):
            k = None if key is None else prng.derive_seed(key, t)
            with parallel.use(self.group):
                logits, _ = decode_step(self.params, self.cfg, fed[t],
                                        dict(self.cache, pos=pos), rng=k,
                                        active=active)
            pos = torch.where(active, pos + 1, pos)
        tok0 = torch.argmax(logits[slot, 0], dim=-1)
        last_token = self.last_token.clone()
        last_token[slot] = tok0
        return last_token, pos, tok0

    def _cow(self, src: int, dst: int):
        """Copy one pool block's K/V across every paged layer: the device
        half of copy-on-write (the table row is linked by the warm
        prefill)."""
        with torch.inference_mode():
            for eng in self._paged_layers():
                for pool_key in ("pk", "pv"):
                    eng[pool_key][:, dst] = eng[pool_key][:, src]

    def prefix_stats(self) -> Dict[str, Any]:
        """The prefix-sharing scoreboard (host-side counters)."""
        lookups = self.prefix_lookups
        return {
            "enabled": self.prefix is not None,
            "lookups": lookups,
            "hits": self.prefix_hits,
            "hit_rate": round(self.prefix_hits / lookups, 4) if lookups
            else 0.0,
            "hit_tokens": self.prefix_hit_tokens,
            "saved_billed_tokens": self.prefix_saved_tokens,
            "cow_copies": self.cow_copies,
            "evictions": self.prefix_evictions,
            "cached_blocks": len(self.prefix) if self.prefix else 0,
        }

    # -- online calibration ----------------------------------------------------
    def swap_calibration(self, calibration: substrate_lib.Calibration):
        """Install a refreshed frozen calibration between chunks.  It must
        carry the frozen calibration's site names."""
        cur = self.calibration
        if cur is None:
            raise ValueError(
                "swap_calibration requires a frozen-policy substrate")
        if calibration.site_names() != cur.site_names():
            raise ValueError(
                "refreshed calibration must preserve the frozen site names: "
                f"{calibration.site_names()} != {cur.site_names()}")
        old = self.substrate
        self.substrate = old.frozen(calibration)
        self.cfg = self.cfg.replace(imc=self.substrate)
        self.swap_count += 1
        if self.meter is not None:
            self.meter.note_swap()
            if self.meter.substrate is old:
                self.meter.substrate = self.substrate

    def swap_substrate(self, substrate, time_scale: float = 1.0):
        """Hot-swap the execution substrate between chunks (load-adaptive
        frontier degradation).  The live frozen calibration, if any, is
        re-attached to the incoming substrate, so its site names are kept;
        ``time_scale`` is the new virtual cost of a decode step (a degraded
        design point's frontier delay ratio, < 1).  Under a mesh, a row
        site that moves on or off the bit-serial substrate is re-placed
        (``sharding.replace_params``)."""
        sub = substrate_lib.as_substrate(substrate)
        if self.substrate.policy == "frozen":
            sub = sub.frozen(self.substrate.calibration)
        if self.group is not None:
            # a row site moving on or off bit-serial is placed by output
            # columns there and by rows elsewhere: its shards are gathered
            # and cut again (every rank swaps at the same chunk)
            new_cfg = self.cfg.replace(imc=sub)
            cols = (sharding.row_sites_by_columns(new_cfg)
                    - self.group.replicated)
            if cols != self.group.row_columns:
                self.params = sharding.replace_params(
                    self.params, self.cfg, new_cfg, self.group)
                self.group = dataclasses.replace(self.group,
                                                 row_columns=cols)
        old = self.substrate
        self.substrate = sub
        self.cfg = self.cfg.replace(imc=sub)
        self.substrate_swaps += 1
        if self.clock is not None:
            self.clock.time_scale = time_scale
        if self.meter is not None:
            self.meter.note_substrate_swap(sub)
            if self.meter.substrate is old:
                self.meter.substrate = sub

    def _drift_paused(self) -> bool:
        """Shadow sampling pauses while the serve loop reports a queue deeper
        than ``drift_pause_depth``; the cadence resumes where it stopped."""
        return (self.drift_pause_depth is not None
                and self.queue_depth > self.drift_pause_depth)

    def _maybe_check_drift(self):
        """After a shadow-sampled chunk: run the detector at the monitor's
        cadence and hot-swap the refreshed calibration on a drifted report
        (between chunks, so the swap is atomic)."""
        mon = self._drift
        report = mon.check(self.calibration)
        if report is None:
            return
        if self.meter is not None:
            self.meter.note_drift_report(report.to_dict())
        log.info("drift check %d: %s", mon.checks, report.summary_line())
        if report.drifted and mon.cfg.auto_swap:
            self.swap_calibration(mon.refreshed(self.calibration))
            mon.note_swap()
            log.info("hot-swapped refreshed calibration (swap %d) at sites "
                     "%s", self.swap_count, list(report.drifted_sites))

    # -- decode ----------------------------------------------------------------
    def next_chunk(self) -> int:
        """Largest power-of-two chunk no active request overruns."""
        rem = [r.effective_max - len(r.out) for r in self.slots
               if r is not None]
        if not rem:
            return 0
        cap = min(min(rem), self.max_chunk)
        t = 1
        while t * 2 <= cap:
            t *= 2
        return t

    @torch.inference_mode()
    def _run_chunk(self, n_steps: int, active, key: Optional[int]):
        tok, pos = self.last_token, self.pos
        toks = []
        for t in range(n_steps):
            k = None if key is None else prng.derive_seed(key, t)
            with parallel.use(self.group):
                logits, _ = decode_step(self.params, self.cfg, tok,
                                        dict(self.cache, pos=pos), rng=k,
                                        active=active)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            toks.append(tok)
        self.last_token, self.pos = tok, pos
        return torch.stack(toks, dim=1).to(torch.int32)

    def _save_state(self, n_steps: int):
        """Copies of the contiguous per-slot state a chunk of ``n_steps``
        overwrites: the ring rows ``(pos + t) % span`` of every slot (local
        layers), t < n_steps, and the active slots' recurrent states and
        conv inputs, which every step rewrites whole.  A chunk that fails
        part way has replaced wrapped in-window keys and advanced the
        recurrences; paged pools need nothing, since decode masks their rows
        past ``pos``."""
        saved = []
        steps = torch.arange(n_steps, device=self.device)
        rows = torch.arange(self.batch_slots, device=self.device)[:, None]
        live = torch.as_tensor([i for i, s in enumerate(self.slots)
                                if s is not None], device=self.device)
        for c in self._groups:
            if "pk" in c:
                continue
            if "k" in c:
                idx = torch.remainder(self.pos[:, None] + steps,
                                      c["k"].shape[2])
                # (L, slots, n_steps, Hkv, hd) copies
                saved.append((c, (rows, idx), {k: c[k][:, rows, idx]
                                               for k in ("k", "v")}))
            else:
                saved.append((c, (live,), {k: v[:, live]
                                           for k, v in c.items()}))
        return saved

    @staticmethod
    def _restore_state(saved):
        for c, index, leaves in saved:
            for k, v in leaves.items():
                c[k][(slice(None),) + index] = v

    def decode_chunk(self, n_steps: Optional[int] = None) -> np.ndarray:
        """Run ``n_steps`` decode steps; returns the (slots, T) token block,
        the chunk's single device-to-host transfer.

        A transient device error is retried once: the engine's tokens and
        positions change only when a chunk returns, a re-run rewrites the
        same paged K/V positions with the same values, and the ring rows
        and recurrent states the failed run overwrote are put back first
        (``_save_state``), so the retry is exact.  If the error persists,
        only the requests in flight retire with an error status and the
        engine goes on."""
        if n_steps is None:
            n_steps = self.next_chunk()
        if n_steps <= 0:
            return np.zeros((self.batch_slots, 0), np.int32)
        self._ensure_blocks(n_steps)  # may preempt
        if self.active == 0:
            return np.zeros((self.batch_slots, 0), np.int32)
        shadow = (self._drift is not None and not self._drift_paused()
                  and self._drift.take_sample())
        active = torch.as_tensor([s is not None for s in self.slots],
                                 device=self.device)
        key = self._next_key()
        saved = self._save_state(n_steps)

        def run_chunk():
            with self._shadow(shadow):
                return self._run_chunk(n_steps, active, key)

        try:
            block = self._retried(run_chunk,
                                  f"decode chunk {self.decode_calls}",
                                  "decode", self.decode_calls,
                                  undo=lambda: self._restore_state(saved))
        except Exception as e:
            if not fault_lib.is_transient_device_error(e):
                raise  # kernel and programming faults surface
            self.decode_failures += 1
            msg = f"decode chunk failed after retry: {e!r}"
            log.warning("%s; failing %d in-flight requests", msg, self.active)
            for i, req in enumerate(self.slots):
                if req is not None:
                    self._retire(i, error=msg)
            return np.zeros((self.batch_slots, 0), np.int32)
        if self.meter is not None:
            # active slots at chunk start each ran n_steps token-forwards
            self.meter.note_decode(self.active, n_steps)
            if shadow:
                self.meter.note_shadow_sample()
        block = block.cpu().numpy()  # the one host transfer per chunk
        self.decode_calls += 1
        self.decode_steps += n_steps
        self.host_transfer_bytes += block.nbytes
        if self.alloc.used_count:
            # live tokens against the token capacity of the allocated blocks
            self._util_token_sum += self.live_tokens()
            self._util_cap_sum += self.alloc.used_count * self.block
        dt = None
        if self.clock is not None:
            dt = self.clock.time_scale
            self.clock.advance(n_steps * dt)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self._slot_pos[i] += n_steps
            take = min(n_steps, req.effective_max - len(req.out))
            req.out.extend(int(t) for t in block[i, :take])
            if dt is not None:
                t_end = self.clock.now
                req.token_times.extend(
                    t_end - (take - 1 - j) * dt for j in range(take))
            if len(req.out) >= req.effective_max:
                self._retire(i)
        if shadow:
            self._maybe_check_drift()
        return block


def _layer_groups(cache) -> list:
    """Every layer group's cache with a leading layer axis: the pattern
    positions' stacked leaves, and views of each remainder layer's."""
    return list(cache["blocks"].values()) + [
        map_leaves(lambda t: t[None], c)
        for c in cache.get("tail", {}).values()]


def serve(engine: Engine, requests: List[Request]) -> List[Request]:
    """Drive the engine until every request finishes (or fails admission);
    returns them in completion order."""
    pending = list(requests)
    while pending or engine.active:
        admitted = engine.admit_pending(pending)
        if pending and not engine.active and not admitted:
            engine.fail_request(
                pending.pop(0),
                "cannot be admitted into an idle engine (slots or KV block "
                "pool too small)")
            continue
        engine.decode_chunk()
        if engine.preempted:
            # preempted requests re-enter at the FRONT of the queue
            pending[:0] = engine.preempted
            engine.preempted.clear()
    return engine.finished


def serve_slo(engine: Engine, requests: List[Request], policy=None,
              controller=None) -> List[Request]:
    """Real-time SLO serve loop: requests ARRIVE at their ``arrive_at``
    virtual times, a ``launch.scheduler`` policy orders the queue and sheds
    hopeless work, preempted requests re-queue at the front, and an optional
    ``PressureController`` walks the EDAP frontier under load.

    Every submitted request leaves through ``engine.finished`` exactly once:
    completed, errored or shed.  The loop is duck-typed over the engine
    (``clock``, ``queue_depth``, ``active``, ``preempted``, ``finished``,
    ``admit_pending``, ``decode_chunk``, ``fail_request``), so model-free
    fakes can drive it in tests."""
    from repro_torch.launch.scheduler import FIFOPolicy
    from repro_torch.runtime.workload import VirtualClock

    if policy is None:
        policy = FIFOPolicy()
    if engine.clock is None:
        engine.clock = VirtualClock()
    clock = engine.clock
    arrivals = sorted(requests, key=lambda r: (
        r.arrive_at if r.arrive_at is not None else 0.0, r.rid))
    queue: List[Request] = []
    while arrivals or queue or engine.active:
        while arrivals and (arrivals[0].arrive_at is None
                            or arrivals[0].arrive_at <= clock.now):
            queue.append(arrivals.pop(0))
        if not queue and not engine.active:
            # idle gap: jump to the next arrival instead of spinning
            clock.advance(max(0.0, arrivals[0].arrive_at - clock.now))
            continue
        engine.queue_depth = len(queue)
        if controller is not None:
            controller.update()
        for r in policy.shed(queue, clock.now):
            engine.fail_request(
                r, f"shed by {policy.name} policy at t={clock.now:.1f} "
                   f"(TTFT deadline unmeetable)", kind="shed")
        policy.order(queue, clock.now)
        admitted = engine.admit_pending(queue)
        engine.queue_depth = len(queue)
        if queue and not engine.active and not admitted:
            engine.fail_request(
                queue.pop(0),
                "cannot be admitted into an idle engine (slots or KV block "
                "pool too small)")
            continue
        engine.decode_chunk()
        if engine.preempted:
            queue[:0] = engine.preempted
            engine.preempted.clear()
    engine.queue_depth = 0
    return engine.finished


def serve_workload(engine: Engine, wcfg, policy: str = "fifo",
                   ladder=None) -> Tuple[List[Request], dict]:
    """Draw the seeded workload ``wcfg`` (a ``runtime.workload``
    ``WorkloadConfig``), serve it through :func:`serve_slo` under the named
    scheduler policy - with a ``PressureController`` over ``ladder`` (a
    substrate ladder) when one is given - and return the finished requests
    and the SLO summary."""
    from repro_torch.launch.metering import slo_summary
    from repro_torch.launch.scheduler import PressureController, make_policy
    from repro_torch.runtime.workload import generate

    requests = generate(wcfg, engine.cfg.vocab_size)
    pol = make_policy(policy)
    controller = (PressureController(engine, ladder) if ladder is not None
                  else None)
    finished = serve_slo(engine, requests, policy=pol, controller=controller)
    summary = slo_summary(finished, elapsed=engine.clock.now,
                          policy=pol.name, prefix_hits=engine.prefix_hits,
                          cow_copies=engine.cow_copies)
    summary.update(
        preemptions=engine.preempt_count,
        shed=engine.shed_requests,
        pool_utilization=round(engine.pool_utilization(), 4),
        substrate_swaps=engine.substrate_swaps,
    )
    if controller is not None:
        summary.update(controller.counters())
    return finished, summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma list of prompt lengths cycled over the "
                         "requests; overrides --prompt-len")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8,
                    help="max decode steps per chunk (one host transfer)")
    ap.add_argument("--block", type=int, default=DEFAULT_BLOCK,
                    help="tokens per paged-KV block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="physical KV pool size in blocks (default: full "
                         "provisioning, slots * max_blocks + 1)")
    ap.add_argument("--alloc", default="lazy", choices=["lazy", "reserve"],
                    help="KV block allocation: lazy (allocate on block-"
                         "boundary crossing, preempt on pool exhaustion) or "
                         "reserve (worst case at admission)")
    ap.add_argument("--imc-mode", default=None,
                    choices=[None, "fakequant", "imc_analytic",
                             "imc_bitserial"])
    ap.add_argument("--imc-vwl", type=float, default=0.7)
    ap.add_argument("--imc-policy", default="dynamic",
                    choices=["dynamic", "frozen"],
                    help="'frozen' calibrates quantizer ranges on a seeded "
                         "reference batch and turns analog noise off, "
                         "making outputs batch-composition-invariant")
    ap.add_argument("--energy-report", action="store_true",
                    help="meter the served traffic and print J/token, "
                         "J/request and EDP/token at the min-energy QS/QR/CM "
                         "design points (512-row banks, --energy-snr-db "
                         "targets); sites are the FULL model's matmuls, so "
                         "smoke runs report deployment-scale energy")
    ap.add_argument("--energy-snr-db", default="14,26",
                    help="comma list of SNR_T targets for --energy-report")
    ap.add_argument("--workload", default="none",
                    choices=["none", "poisson", "bursty"],
                    help="SLO workload: seeded timed arrivals "
                         "(runtime.workload) driven through the serve_slo "
                         "loop under --slo-policy, instead of replaying "
                         "--prompt-lens")
    ap.add_argument("--workload-seed", type=int, default=0,
                    help="seed of every workload draw (arrivals, lengths, "
                         "classes)")
    ap.add_argument("--overload", type=float, default=2.0,
                    help="offered load as a multiple of the engine's "
                         "capacity (with --workload)")
    ap.add_argument("--slo-policy", default="fifo",
                    choices=["fifo", "sjf", "deadline"],
                    help="scheduler policy of the SLO loop: fifo, "
                         "shortest-prompt-first, or SLO-deadline admission "
                         "with load shedding")
    ap.add_argument("--degrade", action="store_true",
                    help="load-adaptive frontier degradation: under queue or "
                         "pool pressure, swap the substrate one step down "
                         "the EDAP frontier (lower B_ADC) and back up when "
                         "pressure clears (requires --imc-mode imc_analytic "
                         "--imc-policy frozen)")
    ap.add_argument("--decode-attn", default="kernel",
                    choices=["kernel", "gather"],
                    help="paged decode attention: the paged-attention kernel "
                         "(default) or the gather escape hatch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--recalibrate", action="store_true",
                    help="online calibration (requires --imc-policy frozen): "
                         "shadow-record a sample of live chunks, detect "
                         "range drift with the one-sided test, and hot-swap "
                         "a refreshed calibration between chunks")
    ap.add_argument("--drift-sample-every", type=int, default=2,
                    help="shadow-record every Nth decode chunk / prefill "
                         "group (with --recalibrate)")
    ap.add_argument("--drift-check-every", type=int, default=2,
                    help="run the drift detector every Nth shadow sample")
    ap.add_argument("--inject-drift", default=None, metavar="SCALE@REQS",
                    help="drift-injection demo: serve the first REQS "
                         "requests, then scale every mlp.wi weight by SCALE "
                         "and serve the rest; prints the drift report and "
                         "the post-swap SNR_T recovery table")
    ap.add_argument("--drift-pause-depth", type=int, default=None,
                    help="pause drift shadow sampling while the queue is "
                         "deeper than this")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="prefix-sharing paged KV: a radix index over token "
                         "prefixes at block granularity links cached blocks "
                         "into new requests' block tables (refcounted, "
                         "copy-on-write); admission prefills only the "
                         "uncached suffix.  Greedy tokens equal a cold run's "
                         "under frozen calibration")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="shared-system-prompt traffic: every prompt starts "
                         "with this many common tokens (drawn once per run) "
                         "followed by its own --prompt-len(s) tail; with "
                         "--workload the prefixes come from per-class seeded "
                         "pools instead")
    ap.add_argument("--prefix-dup", type=int, default=4,
                    help="with --workload and --shared-prefix-len: requests "
                         "per distinct shared prefix within each class")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters, prompts and noise")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="serve over a (data, model) mesh of ranks, e.g. "
                         "1x4: tensor-parallel weights and head-sharded "
                         "paged KV.  The CLI starts the ranks itself: one "
                         "per card over NCCL, or with --device cpu one "
                         "process per rank over gloo; rank 0 prints the "
                         "report.  Only R = 1 is served")
    return ap


def _mesh_rank(argv, size: int):
    """One rank of a ``--mesh`` run: ``main(argv)`` inside the group, with
    rank 0's output only and an equal share of the CPU's threads."""
    rank = mesh_lib.world()[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    try:
        if rank == 0:
            return main(argv)
        logging.getLogger().setLevel(logging.WARNING)
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv)
    finally:
        torch.set_num_threads(threads)


def main(argv=None) -> dict:
    """Serve a seeded synthetic workload; returns a report with the finished
    requests, the engine, the host-clock throughput and TTFT, and (where
    asked for) the SLO summary (``"slo"``), the meter and its
    ``EnergyReport``s (``"energy"``), the drift monitor (``"monitor"``),
    its per-site SNR_T rows (``"snr_rows"``), the parameters' bytes
    (``"weight_bytes"``) and, on the card, the peak device memory of the
    initialization above what was allocated before it
    (``"init_peak_bytes"``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    mesh = None
    if args.mesh:
        try:
            data, model = mesh_lib.parse_mesh_shape(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        if data != 1:
            ap.error(f"--mesh {args.mesh}: R > 1 (slots sharded over data "
                     "replicas) is not served yet; use 1xN")
        if not mesh_lib.world_running():
            # start the ranks: this process is rank 0
            cuda = resolve_device(args.device).type == "cuda"
            have = torch.cuda.device_count() if cuda else os.cpu_count()
            if model > have:
                ap.error(f"mesh {args.mesh} needs {model} devices; only "
                         f"{have} available")
            return mesh_lib.launch(model, "nccl" if cuda else "gloo",
                                   _mesh_rank, list(argv or sys.argv[1:]),
                                   model)
        mesh = mesh_lib.make_serve_mesh(data, model)
    base_pt = None
    if args.degrade:
        if not (args.imc_mode == "imc_analytic"
                and args.imc_policy == "frozen"):
            ap.error("--degrade requires --imc-mode imc_analytic "
                     "--imc-policy frozen (the frontier ladder re-freezes "
                     "each level against the live calibration)")
        from repro_torch.core.design import optimize

        base_pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", mesh.rank)  # one card per rank
        torch.cuda.set_device(device)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = cfg.replace(decode_attn=args.decode_attn)
    rng = None
    if args.imc_mode:
        from repro_torch.core.imc_linear import IMCConfig

        if base_pt is not None:
            # start at the committed frontier point: level 0 of the ladder
            sub = substrate_lib.substrate_for_design(base_pt)
        else:
            sub = substrate_lib.as_substrate(
                IMCConfig(mode=args.imc_mode, bx=7, bw=7, v_wl=args.imc_vwl))
        cfg = cfg.replace(imc=sub)
        rng = prng.derive_seed(args.seed, 7)
    lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len])
    if device.type == "cuda":
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    frozen = bool(args.imc_mode) and args.imc_policy == "frozen"
    if mesh is not None:
        # this rank's shard, drawn without the whole model
        params = sharding.init_params(cfg, mesh, seed=args.seed,
                                      device=device)
    else:
        params = init_params(cfg, seed=args.seed, device=device)
    weight_bytes = param_bytes(params)
    # the peak above what was allocated before: the weights plus init's
    # transients
    init_peak = (torch.cuda.max_memory_allocated(device) - base
                 if device.type == "cuda" else None)
    if init_peak is not None:
        log.info("initialized %s: %d weight bytes, peak device memory %d "
                 "bytes", cfg.name, weight_bytes, init_peak)
    if frozen:
        # frozen ranges from a seeded reference batch; the engine-wide noise
        # seed goes too (its draws are shaped by the batch).  Under a mesh
        # each rank records its shards and the group reduces the ranges
        rng = None
        ref = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, (2, max(lens)))
        group = (sharding.shard_group(cfg, mesh)
                 if mesh is not None and mesh.model > 1 else None)
        with parallel.use(group):
            cfg = substrate_lib.calibrate_model(cfg, params, [ref])
        log.info("froze substrate calibration on a %s reference batch "
                 "(%d sites)", ref.shape,
                 len(cfg.imc.calibration.site_names()))
    bucketable = not needs_exact_prefill(cfg)
    max_bucket = max(prefill_bucket(n + args.shared_prefix_len, bucketable,
                                    10**9) for n in lens)
    cache_len = max_bucket + args.gen + 8
    meter = None
    if args.energy_report:
        from repro_torch.launch.metering import DPMeter

        meter = DPMeter(configs.get(args.arch))
    monitor = None
    frozen0 = None
    if args.recalibrate:
        if not (args.imc_mode and args.imc_policy == "frozen"):
            ap.error("--recalibrate requires --imc-mode and "
                     "--imc-policy frozen")
        from repro_torch.runtime import drift as drift_lib

        monitor = drift_lib.DriftMonitor(drift_lib.DriftConfig(
            sample_every=args.drift_sample_every,
            check_every=args.drift_check_every))
        frozen0 = cfg.imc.calibration
    clock = None
    if args.workload != "none":
        from repro_torch.runtime.workload import VirtualClock

        clock = VirtualClock()
    engine = Engine(cfg, params, args.batch, cache_len, rng=rng,
                    max_chunk=args.chunk, block_size=args.block,
                    kv_blocks=args.kv_blocks, meter=meter,
                    alloc_policy=args.alloc, clock=clock,
                    drift_monitor=monitor,
                    drift_pause_depth=args.drift_pause_depth,
                    prefix_cache=args.prefix_cache, mesh=mesh)
    summary = None
    t0 = time.perf_counter()
    if args.workload != "none":
        from repro_torch.runtime import workload as workload_lib

        wcfg = workload_lib.make_overload_config(
            n_requests=args.requests, seed=args.workload_seed,
            overload=args.overload, slots=args.batch, max_new=args.gen,
            arrival=args.workload, prefix_len=args.shared_prefix_len,
            prefix_dup=args.prefix_dup)
        ladder = (substrate_lib.substrate_ladder(base_pt, steps=2)
                  if base_pt is not None else None)
        finished, summary = serve_workload(engine, wcfg, args.slo_policy,
                                           ladder)
    else:
        rnp = np.random.default_rng(args.seed)
        shared = (rnp.integers(0, cfg.vocab_size, args.shared_prefix_len)
                  if args.shared_prefix_len else None)
        requests = []
        for i in range(args.requests):
            tail = rnp.integers(0, cfg.vocab_size, lens[i % len(lens)])
            prompt = tail if shared is None else np.concatenate([shared,
                                                                 tail])
            requests.append(Request(rid=i, prompt=prompt, max_new=args.gen))
        if args.inject_drift:
            scale_s, _, after_s = args.inject_drift.partition("@")
            scale, after = float(scale_s), int(after_s or len(requests) // 2)
            serve(engine, requests[:after])
            # a weight-scale shift of every mlp.wi: it drifts w_max at mlp.wi
            # and the activation range feeding mlp.wo (an embedding-scale
            # shift would be normalized away before every site)
            engine.params = _scale_wi(engine.params, scale)
            log.info("injected mlp.wi weight-scale drift x%.2f after %d "
                     "requests", scale, after)
            serve(engine, requests[after:])
            finished = engine.finished
        else:
            finished = serve(engine, requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in finished)
    # under a virtual clock TTFT is in decode steps (the SLO summary's)
    ttfts = ([r.ttft for r in finished if r.ttft is not None]
             if engine.clock is None else [])
    report = {
        "finished": finished,
        "engine": engine,
        "seconds": dt,
        "tokens": total_tokens,
        "tok_s": total_tokens / dt if dt > 0 else float("nan"),
        "ttft_ms": 1e3 * float(np.mean(ttfts)) if ttfts else float("nan"),
        "slo": summary,
        "meter": meter,
        "energy": [],
        "monitor": monitor,
        "snr_rows": None,
        "weight_bytes": weight_bytes,
        "init_peak_bytes": init_peak,
    }
    log.info(
        "served %d requests on %s, %d tokens, %d decode chunks (%d steps), "
        "%d prefill calls (%d rows), %.1f tok/s, mean TTFT %.1f ms, "
        "%d host-transfer bytes, %d KV blocks in pool",
        len(finished), device, total_tokens, engine.decode_calls,
        engine.decode_steps, engine.prefill_calls, engine.prefill_rows,
        report["tok_s"], report["ttft_ms"], engine.host_transfer_bytes,
        engine.alloc.num_blocks)
    failed = [r.rid for r in finished if r.error is not None]
    if failed:
        log.warning("%d request(s) finished with an error: %s", len(failed),
                    failed)
    if args.prefix_cache:
        ps = engine.prefix_stats()
        print(f"prefix cache: hit_rate={ps['hit_rate']:.2f} "
              f"({ps['hits']}/{ps['lookups']} admissions), "
              f"prefill tokens skipped={ps['hit_tokens']}, "
              f"billed prefill tokens saved={ps['saved_billed_tokens']}, "
              f"cow_copies={ps['cow_copies']}, "
              f"evictions={ps['evictions']}, "
              f"cached_blocks={ps['cached_blocks']}")
    if monitor is not None:
        from repro_torch.runtime import drift as drift_lib

        c = monitor.counters()
        print(f"online calibration: {c['shadow_samples']} shadow samples / "
              f"{c['chunks_seen']} chunks, {c['drift_checks']} checks, "
              f"{c['drift_events']} drift events, "
              f"{c['calibration_swaps']} hot-swaps "
              f"({engine.swap_count} applied)")
        if monitor.last_report is not None:
            print("last drift report: " + monitor.last_report.summary_line())
        if monitor.last_observed is not None:
            rows = drift_lib.site_snr_table(
                frozen0, engine.calibration, monitor.last_observed,
                bx=engine.substrate.imc.bx)
            report["snr_rows"] = rows
            print("per-site SNR_T (stale frozen vs post-swap vs "
                  "fresh-frozen reference):")
            print(drift_lib.format_snr_table(rows))
    if summary is not None:
        print(f"serve_slo [{args.workload} x{args.overload:g} overload, "
              f"policy={summary['policy']}, alloc={args.alloc}]:")
        from repro_torch.launch.metering import format_slo_summary

        print(format_slo_summary(summary))
    if meter is not None:
        from repro_torch.core.design import optimize
        from repro_torch.launch.metering import (
            format_report,
            serve_energy_report,
        )

        # bill through the substrate each min-energy design point implies
        for snr_db in (float(x) for x in args.energy_snr_db.split(",")):
            for kind in ("qs", "qr", "cm"):
                pt = optimize(n=512, snr_t_target_db=snr_db, kinds=(kind,))
                if pt is None:
                    continue
                report["energy"].append(serve_energy_report(
                    meter, substrate=substrate_lib.substrate_for_design(pt),
                    generated_tokens=total_tokens, requests=len(finished)))
        print(f"serve-path energy (billed prefill tokens="
              f"{meter.prefill_billed_tokens} of which padding="
              f"{meter.prefill_pad_tokens}, decode tokens="
              f"{meter.decode_billed_tokens}):")
        print(format_report(report["energy"]))
        if meter.prefix_saved_billed_tokens:
            print(f"prefix-cache energy savings ("
                  f"{meter.prefix_saved_billed_tokens} billed prefill "
                  f"tokens avoided):")
            for r in report["energy"]:
                frac = r.saved_prefill_j / max(
                    r.total_j + r.saved_prefill_j, 1e-30)
                print(f"  {r.design.arch_kind:>4s} @ "
                      f"{r.design.snr_t_db:5.1f} dB: "
                      f"-{r.j_per_token_saved:.3e} J/token "
                      f"({100 * frac:.1f}% of the cold bill)")
    return report


def _scale_wi(p, scale: float):
    """``p`` with every ``wi`` weight multiplied by ``scale``."""
    if isinstance(p, dict):
        return {k: (v * scale if k == "wi" else _scale_wi(v, scale))
                for k, v in p.items()}
    return p


if __name__ == "__main__":
    main()
