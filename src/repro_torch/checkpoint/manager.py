"""Atomic, manifest-verified, async-capable checkpoints: the port of the
reference's ``repro/checkpoint/manager.py`` (``save``, ``AsyncSaver``,
``latest_step``, ``restore``, ``cleanup``), in its on-disk layout:

  ckpt_dir/
    step_00000100.tmp/       (written first)
      manifest.json          - step, extra, and per leaf path: file, shape,
                               dtype, digest (sha256 of the first MiB)
      arr_00000.npy ...      - one file per leaf, in sorted-path order
    step_00000100/           (os.replace on completion - a crash never
                              leaves a half-valid checkpoint visible)

Leaf paths are the reference's ``keystr`` form (``['params']['blocks']...``,
``repro_torch.tree``), so a tree of float and integer arrays written by
either package restores in the other.  numpy has no bfloat16: a bfloat16
leaf is stored as its raw 16-bit words (a uint16 ``.npy``) under the dtype
``"bfloat16"``, and its digest hashes those words, as the reference's does.
Restore is device-agnostic: leaves are loaded on the host and placed where
the ``like`` tree's leaves live.  Corrupt or partial checkpoints are
detected by the manifest and skipped by ``latest_step``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

BF16 = "bfloat16"


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host numpy copy, the manifest dtype) of a tensor or array; a
    bfloat16 tensor gives its raw words as uint16.  The copy owns its
    memory: later in-place changes of the leaf do not reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).to("cpu", copy=True).numpy()
            return words.view(np.uint16), BF16
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)  # a copy
    return arr, str(arr.dtype)


def _digest(arr: np.ndarray, dtype: str) -> str:
    h = hashlib.sha256()
    # the first MiB of the array's bytes (the reference's digest), read
    # without copying the whole array
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    h.update(raw[: 1 << 20].tobytes())
    h.update(str(arr.shape).encode())
    h.update(dtype.encode())
    return h.hexdigest()[:16]


class _HostLeaf:
    """A leaf already copied to the host, with its manifest dtype."""

    __slots__ = ("arr", "dtype")

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr, self.dtype = arr, dtype


def _host_leaf(leaf) -> _HostLeaf:
    return leaf if isinstance(leaf, _HostLeaf) else _HostLeaf(*_to_host(leaf))


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = dict(tree_lib.flatten_with_path(tree))
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (path, leaf) in enumerate(sorted(leaves.items())):
        host = _host_leaf(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), host.arr)
        manifest["leaves"][path] = {
            "file": fname,
            "shape": list(host.arr.shape),
            "dtype": host.dtype,
            "digest": _digest(host.arr, host.dtype),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncSaver:
    """Background saves.  Every leaf is copied to host memory on the
    caller's thread before the writer thread starts, so the values saved
    are those of the call even when the caller goes on to change the
    tensors in place (the optimizer's next step); only the file IO runs in
    the worker."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, step: int, tree, extra=None):
        host_tree = tree_lib.map_leaves(_host_leaf, tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(ckpt_dir, step, host_tree, extra),
            daemon=True)
        self._thread.start()

    def _write(self, ckpt_dir, step, host_tree, extra):
        try:
            save(ckpt_dir, step, host_tree, extra)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def wait(self):
        """Join the writer; a failed write raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *valid* checkpoint step (validates manifest presence + files)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        d = os.path.join(ckpt_dir, name)
        if not os.path.isfile(os.path.join(d, "manifest.json")):
            continue
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                man = json.load(f)
            ok = all(
                os.path.isfile(os.path.join(d, meta["file"]))
                for meta in man["leaves"].values()
            )
            if ok:
                steps.append(int(name.split("_")[1]))
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    """The saved array as a tensor of ``like``'s dtype on its device."""
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(
    ckpt_dir: str,
    step: int,
    like,
    verify: bool = True,
) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors: each
    restored leaf takes its ``like`` leaf's dtype and device).  Returns
    (tree, extra)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    out = []
    for key, leaf in tree_lib.flatten_with_path(like):
        meta = man["leaves"][key]
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and _digest(arr, meta["dtype"]) != meta["digest"]:
            raise IOError(f"checkpoint digest mismatch at {key}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise IOError(
                f"shape mismatch at {key}: ckpt {arr.shape} vs model {leaf.shape}"
            )
        out.append(_tensor(arr, meta["dtype"], leaf))
    return tree_lib.unflatten(like, out), man.get("extra", {})


def cleanup(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest `keep` valid checkpoints (+ stray tmp dirs)."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
