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
                       inactive and overrun rows write to.
  batched prefill      the FIFO prefix of pending requests sharing one
                       power-of-two bucket is admitted as ONE (R, bucket)
                       prefill (R padded to a power of two), then ONE insert
                       writes each row's prompt K/V into its blocks and its
                       block-table row.
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

Greedy sampling.  Noise seeds are integers (``rng``); with a frozen
calibration and ``rng=None`` the batched engine equals sequential execution.
Metering, prefix caching, drift monitoring, fault retry, SLO workloads and
tensor-parallel meshes are not ported yet: their flags raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import substrate as substrate_lib
from repro_torch.kernels import prng
from repro_torch.models import (
    decode_step,
    init_paged_cache,
    init_params,
    prefill,
    resolve_device,
)

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
    error_kind: Optional[str] = None  # "admission"
    # true generation length (an EOS the engine cannot know at admission)
    stop_at: Optional[int] = None
    preemptions: int = 0

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

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
    tokens live on the device of ``params``.
    """

    def __init__(self, cfg, params, batch_slots: int, cache_len: int,
                 rng: Optional[int] = None, max_chunk: int = 8,
                 block_size: int = DEFAULT_BLOCK,
                 kv_blocks: Optional[int] = None,
                 alloc_policy: str = "lazy"):
        if any(k != "attn" for k in tuple(cfg.pattern) + tuple(cfg.tail_kinds)):
            raise NotImplementedError(
                f"pattern {cfg.pattern} is not ported yet (ROADMAP)")
        if alloc_policy not in ("lazy", "reserve"):
            raise ValueError(f"unknown alloc_policy {alloc_policy!r}")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.substrate = substrate_lib.as_substrate(cfg.imc)
        self.swap_count = 0
        self.batch_slots = batch_slots
        self.block = block_size
        self.max_blocks = -(-cache_len // block_size)
        self.cache_len = self.max_blocks * block_size
        self.max_chunk = max_chunk
        self.rng = rng
        self._key_count = 0
        self.bucketable = True  # attention-only patterns take padded prefill
        if kv_blocks is None:
            # full provisioning: admission never stalls on blocks
            kv_blocks = batch_slots * self.max_blocks + 1
        self.alloc = BlockAllocator(kv_blocks)
        self.alloc_policy = alloc_policy

        self.slots: List[Optional[Request]] = [None] * batch_slots
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_slots)]
        self._slot_pos: List[int] = [0] * batch_slots
        self._slot_seq: List[int] = [0] * batch_slots
        self._admit_seq = 0
        self.preempted: List[Request] = []
        cache = init_paged_cache(cfg, batch_slots, self.cache_len, kv_blocks,
                                 block_size, device=self.device)
        cache.pop("pos")
        self.cache = cache
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
        self.preempt_count = 0

    # -- bookkeeping ----------------------------------------------------------
    def _paged_layers(self):
        """The stacked {"pk","pv","bt"} dict of every paged pattern position."""
        return list(self.cache["blocks"].values())

    def _next_key(self) -> Optional[int]:
        if self.rng is None:
            return None
        self._key_count += 1
        return prng.derive_seed(self.rng, self._key_count)

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
        return -(-self._total_positions(req) // self.block)

    def _blocks_needed(self, req: Request) -> int:
        """Blocks allocated at admission: the prompt insert's coverage (lazy)
        or the worst case (reserve)."""
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
        """Retire an unadmitted request with a per-request error status."""
        req.done = True
        req.error = error
        req.error_kind = kind
        self.finished.append(req)
        self.failed_requests += 1
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
            bucket = self._bucket(pending[0])
            group: List[Request] = []
            reserved = 0
            for r in pending:
                if len(group) >= len(free_slots) or self._bucket(r) != bucket:
                    break
                if not self._fits(r):
                    break
                need = self._blocks_needed(r)
                if reserved + need > self.alloc.free_count:
                    break
                group.append(r)
                reserved += need
            if not group:
                break  # head-of-line request waits for blocks to free
            self._admit_group(group, free_slots[: len(group)], bucket)
            del pending[: len(group)]
            admitted.extend(group)
        return admitted

    @torch.inference_mode()
    def _admit_group(self, group: List[Request], slot_ids: List[int],
                     bucket: int):
        now = time.perf_counter()
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
            blocks = self.alloc.alloc(self._blocks_needed(req))
            if blocks is None:
                raise RuntimeError("admission reserved blocks it cannot get")
            self._slot_blocks[slot_ids[r]] = blocks
            bt_rows[r, : len(blocks)] = blocks
        dev = self.device
        logits, cache1 = prefill(
            self.params, self.cfg, torch.as_tensor(toks, device=dev),
            cache_len=bucket, rng=self._next_key(),
            true_len=torch.as_tensor(true_len, device=dev))
        tok0 = torch.argmax(logits[:, -1], dim=-1)
        self._insert(cache1, slot_ids, bt_rows, tok0[:r_real],
                     true_len[:r_real])
        self.prefill_calls += 1
        self.prefill_rows += r_real
        tok0_host = tok0.cpu().numpy()  # one sync per GROUP
        t_first = time.perf_counter()
        for r, req in enumerate(group):
            sid = slot_ids[r]
            self.slots[sid] = req
            self._slot_pos[sid] = int(true_len[r])
            self._slot_seq[sid] = self._admit_seq
            self._admit_seq += 1
            req.out.append(int(tok0_host[r]))
            if req.t_first is None:  # a resumed request keeps its real TTFT
                req.t_first = t_first
            if len(req.out) >= req.effective_max:
                self._retire(sid)

    def _insert(self, cache1, slot_ids, bt_rows, tok0, true_len):
        """Write a prefill group into the engine cache: each row's prompt K/V
        into its allocated blocks (logical block j -> bt_rows[r, j]; blocks
        past the allocation go to garbage block 0), its block-table row into
        every layer's table, and its first token and position."""
        bs = self.block
        dev = self.device
        slots = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        rows = torch.as_tensor(bt_rows, device=dev)
        r = len(slot_ids)
        for key, eng in self.cache["blocks"].items():
            pref = cache1["blocks"][key]
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

    def _retire(self, i: int):
        req = self.slots[i]
        req.done = True
        self.slots[i] = None
        self._slot_pos[i] = 0
        self.finished.append(req)
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
        if self.alloc_policy != "lazy":
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
            got = self.alloc.alloc(deficit)
            while got is None:
                victim = self._pick_victim(i)
                if victim is None:
                    self._preempt(i)
                    break
                self._preempt(victim)
                got = self.alloc.alloc(deficit)
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

    # -- online calibration ----------------------------------------------------
    def swap_calibration(self, calibration: substrate_lib.Calibration):
        """Install a refreshed frozen calibration between chunks.  It must
        carry the frozen calibration's site names."""
        cur = self.substrate.calibration
        if self.substrate.policy != "frozen" or cur is None:
            raise ValueError(
                "swap_calibration requires a frozen-policy substrate")
        if calibration.site_names() != cur.site_names():
            raise ValueError(
                "refreshed calibration must preserve the frozen site names: "
                f"{calibration.site_names()} != {cur.site_names()}")
        self.substrate = self.substrate.frozen(calibration)
        self.cfg = self.cfg.replace(imc=self.substrate)
        self.swap_count += 1

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
            logits, _ = decode_step(self.params, self.cfg, tok,
                                    dict(self.cache, pos=pos), rng=k,
                                    active=active)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            toks.append(tok)
        self.last_token, self.pos = tok, pos
        return torch.stack(toks, dim=1).to(torch.int32)

    def decode_chunk(self, n_steps: Optional[int] = None) -> np.ndarray:
        """Run ``n_steps`` decode steps; returns the (slots, T) token block,
        the chunk's single device-to-host transfer."""
        if n_steps is None:
            n_steps = self.next_chunk()
        if n_steps <= 0:
            return np.zeros((self.batch_slots, 0), np.int32)
        self._ensure_blocks(n_steps)  # may preempt
        if self.active == 0:
            return np.zeros((self.batch_slots, 0), np.int32)
        active = torch.as_tensor([s is not None for s in self.slots],
                                 device=self.device)
        block = self._run_chunk(n_steps, active, self._next_key())
        block = block.cpu().numpy()  # the one host transfer per chunk
        self.decode_calls += 1
        self.decode_steps += n_steps
        self.host_transfer_bytes += block.nbytes
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self._slot_pos[i] += n_steps
            take = min(n_steps, req.effective_max - len(req.out))
            req.out.extend(int(t) for t in block[i, :take])
            if len(req.out) >= req.effective_max:
                self._retire(i)
        return block


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


class _Waits(argparse.Action):
    """A reference flag whose feature is not ported yet."""

    def __init__(self, option_strings, dest, **kw):
        kw.setdefault("nargs", "?")
        super().__init__(option_strings, dest, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to PyTorch yet "
                     "(see ROADMAP: metering, prefix cache, drift, faults, "
                     "SLO workloads and meshes come in later slices)")


_WAITING_FLAGS = (
    "--energy-report", "--energy-snr-db", "--recalibrate",
    "--drift-sample-every", "--drift-check-every", "--inject-drift",
    "--workload", "--workload-seed", "--overload", "--slo-policy", "--alloc",
    "--degrade", "--drift-pause-depth", "--prefix-cache",
    "--shared-prefix-len", "--prefix-dup", "--mesh",
)


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
    ap.add_argument("--imc-mode", default=None,
                    choices=[None, "fakequant", "imc_analytic",
                             "imc_bitserial"])
    ap.add_argument("--imc-vwl", type=float, default=0.7)
    ap.add_argument("--imc-policy", default="dynamic",
                    choices=["dynamic", "frozen"],
                    help="'frozen' calibrates quantizer ranges on a seeded "
                         "reference batch and turns analog noise off, "
                         "making outputs batch-composition-invariant")
    ap.add_argument("--decode-attn", default="kernel",
                    choices=["kernel", "gather"],
                    help="paged decode attention: the paged-attention kernel "
                         "(default) or the gather escape hatch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters, prompts and noise")
    for flag in _WAITING_FLAGS:
        ap.add_argument(flag, action=_Waits, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> dict:
    """Serve a seeded synthetic workload; returns a report with the finished
    requests, the engine and the host-clock throughput and TTFT."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = cfg.replace(decode_attn=args.decode_attn)
    rng = None
    if args.imc_mode:
        from repro_torch.core.imc_linear import IMCConfig

        cfg = cfg.replace(imc=substrate_lib.as_substrate(
            IMCConfig(mode=args.imc_mode, bx=7, bw=7, v_wl=args.imc_vwl)))
        rng = prng.derive_seed(args.seed, 7)
    lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len])
    params = init_params(cfg, seed=args.seed, device=device)
    if args.imc_mode and args.imc_policy == "frozen":
        # frozen ranges from a seeded reference batch; the engine-wide noise
        # seed goes too (its draws are shaped by the batch)
        rng = None
        ref = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, (2, max(lens)))
        cfg = substrate_lib.calibrate_model(cfg, params, [ref])
        log.info("froze substrate calibration on a %s reference batch "
                 "(%d sites)", ref.shape,
                 len(cfg.imc.calibration.site_names()))
    max_bucket = max(prefill_bucket(n, True, 10**9) for n in lens)
    cache_len = max_bucket + args.gen + 8
    engine = Engine(cfg, params, args.batch, cache_len, rng=rng,
                    max_chunk=args.chunk, block_size=args.block,
                    kv_blocks=args.kv_blocks)
    rnp = np.random.default_rng(args.seed)
    requests = [Request(rid=i, max_new=args.gen,
                        prompt=rnp.integers(0, cfg.vocab_size,
                                            lens[i % len(lens)]))
                for i in range(args.requests)]
    t0 = time.perf_counter()
    finished = serve(engine, requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in finished)
    ttfts = [r.ttft for r in finished if r.ttft is not None]
    report = {
        "finished": finished,
        "engine": engine,
        "seconds": dt,
        "tokens": total_tokens,
        "tok_s": total_tokens / dt if dt > 0 else float("nan"),
        "ttft_ms": 1e3 * float(np.mean(ttfts)) if ttfts else float("nan"),
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
    return report


if __name__ == "__main__":
    main()
