"""Deterministic, shardable data pipeline: a numpy-only copy of the
reference's ``repro/data/pipeline.py`` (``DataConfig``, ``SyntheticLM``,
``MemmapCorpus``, ``make_source``, ``host_slice``, ``Prefetcher``), so the
port's batches are bit-identical to the reference's.

Two sources:
  * SyntheticLM - counter-based Philox token streams over (seed, step):
    deterministic under restart and under re-sharding, since the global
    batch for a step is a pure function of (seed, step), independent of the
    number of hosts that materialize slices of it.
  * MemmapCorpus - packed uint16/uint32 token files read by memmap with
    deterministic window sampling (the same (seed, step) -> same windows).

Both produce per-step global batches as numpy arrays; `host_slice` cuts one
host's share, and moving a batch to the device is left to the caller
(launch/train.py).  A double-buffered prefetch thread hides host-side
generation latency.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 50257
    seq_len: int = 1024
    global_batch: int = 8
    corpus_path: Optional[str] = None  # None -> synthetic


class SyntheticLM:
    """Counter-based synthetic LM stream: batch(step) is pure in (seed, step).

    Generates Zipf-ish token draws with a per-sequence Markov flavour so the
    loss actually decreases during example training runs.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[0, 0, 0, step])
        )
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # Zipf-ish marginal via exponential rank transform
        u = rng.random((b, s))
        ranks = np.floor((v ** u - 1) / (v - 1) * v).astype(np.int64) % v
        # Markov flavour: every other token repeats its predecessor's bucket
        rep = rng.random((b, s)) < 0.3
        shifted = np.roll(ranks, 1, axis=1)
        toks = np.where(rep, (shifted + 1) % v, ranks)
        return {"tokens": toks.astype(np.int32)}


class MemmapCorpus:
    """Packed token file (uint16 when vocab < 65536 else uint32)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        dtype = np.uint16 if cfg.vocab_size < 65536 else np.uint32
        self.data = np.memmap(cfg.corpus_path, dtype=dtype, mode="r")
        self.n_windows = max(len(self.data) - cfg.seq_len - 1, 1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed + 1, counter=[0, 0, 0, step])
        )
        starts = rng.integers(0, self.n_windows, size=(cfg.global_batch,))
        toks = np.stack(
            [self.data[s : s + cfg.seq_len] for s in starts]
        ).astype(np.int32)
        return {"tokens": toks}


def make_source(cfg: DataConfig):
    return MemmapCorpus(cfg) if cfg.corpus_path else SyntheticLM(cfg)


def host_slice(batch: Dict[str, np.ndarray], process_index: int, process_count: int):
    """Deterministic per-host slice of a global batch (batch dim 0)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        per = n // process_count
        out[k] = v[process_index * per : (process_index + 1) * per]
    return out


class Prefetcher:
    """Double-buffered background prefetch; restart-safe via explicit step."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
