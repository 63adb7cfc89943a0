"""Checkpointing: atomic, sharded, async-capable (port of
``repro/train/checkpoint.py``).

The reference's on-disk layout, one directory per step:

    <dir>/step_00000100/
        meta.json            — step and each leaf's index, name, shard,
                               dtype and shape
        shard_<k>.npz        — flat arrays, chunked into ~512MB files

Leaves are indexed and named in JAX's flatten order (``repro_torch.tree``:
dict keys sorted, names as ``keystr`` gives them), and bfloat16 is stored
as its uint16 view, as the reference stores it (without ``ml_dtypes``),
so a checkpoint written by either package restores in the other.  (The
reference's per-host leaf filter waits for the multi-card slice.)  Writes go to ``step_X.tmp`` and are published by
``os.rename``; ``AsyncCheckpointer`` copies the tensors to the host
synchronously and writes on a thread.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tr

_MAX_SHARD_BYTES = 512 * 2**20

def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Synchronous atomic checkpoint save. Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    meta: Dict[str, Any] = {"step": step, "leaves": []}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if shard:
            np.savez(os.path.join(tmp, f"shard_{shard_idx:05d}.npz"), **shard)
            shard_idx += 1
            shard = {}
            shard_bytes = 0

    for i, (path, leaf) in enumerate(tr.leaves_with_path(tree)):
        arr, dtype_name = tr.to_numpy(leaf)
        meta["leaves"].append({"i": i, "name": tr.keystr(path),
                               "shard": shard_idx, "dtype": dtype_name,
                               "shape": list(arr.shape)})
        shard[f"leaf_{i:06d}"] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _MAX_SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic publish
    return final


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk on a daemon thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save_async(self, ckpt_dir: str, step: int, tree) -> None:
        self.wait()
        # a copy: training updates the parameters in place
        host_tree = tr.tree_map(
            lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(ckpt_dir, step, host_tree)
            except BaseException as e:  # noqa: BLE001  (re-raised by wait)
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_template):
    """Restore into the structure of ``tree_template`` (nested dicts of
    tensors), each leaf on its template leaf's device.  Returns (tree,
    step)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    by_idx = {leaf["i"]: leaf for leaf in meta["leaves"]}
    shards: Dict[int, Any] = {}
    counter = itertools.count()

    def load(leaf):
        i = next(counter)
        info = by_idx.get(i)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {i}")
        sid = info["shard"]
        if sid not in shards:
            shards[sid] = np.load(os.path.join(final, f"shard_{sid:05d}.npz"))
        return _from_savable(shards[sid][f"leaf_{i:06d}"],
                             info["dtype"]).to(leaf.device)

    try:
        restored = tr.tree_map(load, tree_template)
    finally:
        for npz in shards.values():
            npz.close()
    return restored, meta["step"]


def prune_old(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(m.group(1)) for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
