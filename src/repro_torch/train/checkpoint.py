"""Checkpointing: atomic, sharded, async-capable, elastic-restorable (port
of ``repro/train/checkpoint.py``).

The reference's on-disk layout, one directory per step:

    <dir>/step_00000100/
        meta.json            — step and each leaf's index, name, shard,
                               dtype and shape
        shard_<k>.npz        — flat arrays, chunked into ~512MB files

Leaves are indexed and named in JAX's flatten order (``repro_torch.tree``:
dict keys sorted, names as ``keystr`` gives them), and bfloat16 is stored
as its uint16 view, as the reference stores it (without ``ml_dtypes``),
so a checkpoint written by either package restores in the other.  Writes
go to ``step_X.tmp`` and are published by ``os.rename``.

``save(..., local_leaf_filter=)`` writes only the leaves whose flat index
passes the filter, as the reference does.  A tree whose leaves are
DTensors on a live process group (the sharded train state,
``train_step.shard_train_state``) is saved whole by the group, every rank
calling ``save`` with its own chunks: each leaf is written once, by its
owner rank (``owners``: bytes balanced greedily over the ranks, the
port's ``local_leaf_filter`` on a group), which receives the other ranks'
chunks as CPU tensors (c10d's point-to-point ops: gloo's functional
collectives fail on CUDA tensors); no other rank sends or writes anything
of it.  Rank ``r`` writes its ``k``-th file as shard ``k·world + r``
(the reference's reader takes any shard id from ``meta.json``).  Rank 0
writes ``meta.json`` with every leaf and publishes with the one rename,
after every rank's writes are done (``latest_step`` never sees a step
that a rank has not finished); a rank whose write failed leaves no
published step.

``AsyncCheckpointer.save_async`` takes its snapshot at the call (host
copies; on a group, the gather to the owners) and writes on a thread.
Every collective runs on the calling thread: on a group, the publish
(the ranks' verdicts, then rank 0's rename) waits for the next
``save_async`` or ``wait``, so the write overlaps the next step.

``restore(..., shardings=)`` is the elastic path: each leaf is read whole
on every rank and placed by a ``sharding.partition.NamedSharding`` with
``partition.place`` (each rank keeps its own chunk, no collective), so a
checkpoint saved on a (2, 2) mesh restores onto (1, 2), or onto one
device with ``shardings=None``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tr

_MAX_SHARD_BYTES = 512 * 2**20


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _step_dirs(ckpt_dir: str, step: int) -> Tuple[str, str]:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    return final, final + ".tmp"


def _fresh(tmp: str) -> None:
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)


def _publish(tmp: str, final: str, meta: Dict[str, Any]) -> None:
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic publish


def _leaf_info(i: int, name: str, shard: int, dtype_name: str,
               shape) -> Dict[str, Any]:
    return {"i": i, "name": name, "shard": shard, "dtype": dtype_name,
            "shape": list(shape)}


def owners(nbytes: List[int], world: int) -> List[int]:
    """The rank that writes each leaf of a group save: leaves by bytes,
    largest first (ties by index), each to the rank with the fewest bytes
    so far (ties to the lowest rank)."""
    load = [0] * world
    out = [0] * len(nbytes)
    for i in sorted(range(len(nbytes)), key=lambda i: (-nbytes[i], i)):
        r = min(range(world), key=lambda r: (load[r], r))
        out[i] = r
        load[r] += nbytes[i]
    return out


def _shard_ids(nbytes: List[int], owner: List[int], world: int) -> List[int]:
    """Each leaf's shard id: its owner's files filled in flat order, a new
    file once one reaches ``_MAX_SHARD_BYTES`` (the reference's rule),
    rank r's k-th file being shard k·world + r."""
    k, filled = [0] * world, [0] * world
    out = []
    for i, r in enumerate(owner):
        out.append(k[r] * world + r)
        filled[r] += nbytes[i]
        if filled[r] >= _MAX_SHARD_BYTES:
            k[r], filled[r] = k[r] + 1, 0
    return out


def _regions(x) -> List[Tuple[tuple, tuple, List[int]]]:
    """The distinct chunks of the DTensor ``x`` over its mesh: (shape,
    offset, the ranks that hold it), empty chunks left out."""
    dm = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        raise ValueError("a DTensor with a Partial placement holds no "
                         "value to save: reduce it first")
    from repro_torch.sharding import partition as pt
    grid = dm.mesh
    seen: Dict[Tuple[tuple, tuple], List[int]] = {}
    for coord in itertools.product(*(range(n) for n in grid.shape)):
        shape, off = pt.local_shard(x.shape, dm, x.placements, coord)
        if all(shape):
            seen.setdefault((shape, off), []).append(int(grid[coord]))
    return [(shape, off, ranks) for (shape, off), ranks in seen.items()]


def _gather_to(x, owner: int, rank: int, tag: int) -> Optional[torch.Tensor]:
    """The DTensor ``x`` whole on the CPU of rank ``owner`` (None on the
    others): each chunk comes from the owner itself where it holds it,
    else from the lowest rank that does, by c10d's send and receive of a
    CPU copy."""
    import torch.distributed as dist
    local = x.to_local().detach()
    if rank == owner:
        out = torch.empty(x.shape, dtype=x.dtype)
        pending = []
        for shape, off, ranks in _regions(x):
            view = out[tuple(slice(o, o + n) for n, o in zip(shape, off))]
            if owner in ranks:
                view.copy_(local)
            else:
                buf = torch.empty(shape, dtype=x.dtype)
                pending.append((dist.irecv(buf, src=min(ranks), tag=tag),
                                view, buf))
        for req, view, buf in pending:
            req.wait()
            view.copy_(buf)
        return out
    for shape, off, ranks in _regions(x):
        if owner not in ranks and min(ranks) == rank:
            dist.isend(local.to("cpu").contiguous(), dst=owner,
                       tag=tag).wait()
    return None


def _nbytes(leaves) -> List[int]:
    return [leaf.numel() * leaf.element_size() for leaf in leaves]


def gather_to_owners(leaves, owner: Optional[List[int]] = None
                     ) -> Dict[int, torch.Tensor]:
    """On a process group, every rank calling it with its own chunks of the
    same leaves (DTensors on the whole group, or ordinary tensors that
    every rank holds whole): the leaves that this rank owns (``owner``, by
    default ``owners`` of their bytes), by flat index, each whole on the
    CPU (a copy)."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    if owner is None:
        owner = owners(_nbytes(leaves), world)
    mine = {}
    for i, leaf in enumerate(leaves):
        if tr.is_dtensor(leaf):
            if leaf.device_mesh.size() != world:
                raise ValueError(
                    f"leaf {i}: its mesh has {leaf.device_mesh.size()} "
                    f"ranks, the process group {world}: a group save needs "
                    f"every DTensor on the whole group")
            whole = _gather_to(leaf, owner[i], rank, tag=i)
        elif owner[i] == rank:
            whole = leaf.detach().to("cpu", copy=True)
        else:
            continue
        if owner[i] == rank:
            mine[i] = whole
    return mine


@dataclasses.dataclass
class SaveStats:
    """One save's seconds and bytes on this rank: the snapshot (the copies
    to the host and, on a group, the gather to the owners), the write, the
    publish (on a group: the wait for every rank's verdict and rank 0's
    rename), the bytes this rank wrote."""
    step: int
    snapshot_s: float = 0.0
    write_s: float = 0.0
    publish_s: float = 0.0
    bytes_written: int = 0


@dataclasses.dataclass
class _Save:
    """A snapshot on its way to disk: this rank's files (shard id → leaf
    key → array), the leaves' list for ``meta.json``, the directories."""
    final: str
    tmp: str
    meta: Dict[str, Any]
    files: Dict[int, Dict[str, np.ndarray]]
    group: bool
    stats: SaveStats


def _snapshot(ckpt_dir: str, step: int, tree,
              local_leaf_filter: Optional[Callable[[int], bool]] = None,
              copy: bool = False) -> _Save:
    """The arrays to write, on the host; ``copy``: host copies of
    ordinary leaves (a save on a thread; a gathered leaf is a copy
    already).  On a group (a DTensor leaf) each leaf goes to its owner,
    and rank 0 empties ``step_X.tmp`` before any rank writes there."""
    t0 = time.perf_counter()
    named = [(tr.keystr(path), leaf)
             for path, leaf in tr.leaves_with_path(tree)]
    final, tmp = _step_dirs(ckpt_dir, step)
    stats = SaveStats(step)
    meta: Dict[str, Any] = {"step": step, "leaves": []}
    files: Dict[int, Dict[str, np.ndarray]] = {}
    if not any(tr.is_dtensor(leaf) for _, leaf in named):
        shard_idx, shard_bytes = 0, 0
        for i, (name, leaf) in enumerate(named):
            if local_leaf_filter is not None and not local_leaf_filter(i):
                continue
            if copy:
                leaf = leaf.detach().to("cpu", copy=True)
            arr, dtype_name = tr.to_numpy(leaf, name)
            meta["leaves"].append(_leaf_info(i, name, shard_idx, dtype_name,
                                             arr.shape))
            files.setdefault(shard_idx, {})[f"leaf_{i:06d}"] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= _MAX_SHARD_BYTES:
                shard_idx, shard_bytes = shard_idx + 1, 0
        stats.snapshot_s = time.perf_counter() - t0
        return _Save(final, tmp, meta, files, False, stats)

    import torch.distributed as dist
    if local_leaf_filter is not None:
        raise ValueError("a save of DTensor leaves picks each leaf's writer "
                         "itself (checkpoint.owners); pass no "
                         "local_leaf_filter")
    world, rank = dist.get_world_size(), dist.get_rank()
    leaves = [leaf for _, leaf in named]
    owner = owners(_nbytes(leaves), world)
    shard = _shard_ids(_nbytes(leaves), owner, world)
    if rank == 0:
        _fresh(tmp)
    dist.barrier()
    mine = gather_to_owners(leaves, owner)
    for i, (name, leaf) in enumerate(named):
        meta["leaves"].append(_leaf_info(i, name, shard[i],
                                         tr.dtype_name(leaf.dtype),
                                         leaf.shape))
        if i in mine:
            files.setdefault(shard[i], {})[f"leaf_{i:06d}"] = \
                tr.to_numpy(mine[i], name)[0]
    stats.snapshot_s = time.perf_counter() - t0
    return _Save(final, tmp, meta, files, True, stats)


def _write(save_: _Save) -> None:
    """This rank's files into ``step_X.tmp`` (no collective)."""
    t0 = time.perf_counter()
    if not save_.group:
        _fresh(save_.tmp)
    for sid, arrays in sorted(save_.files.items()):
        np.savez(os.path.join(save_.tmp, f"shard_{sid:05d}.npz"), **arrays)
        save_.stats.bytes_written += sum(a.nbytes for a in arrays.values())
    save_.stats.write_s = time.perf_counter() - t0


def _finish(save_: _Save, error: Optional[BaseException]) -> None:
    """Publish the step, or raise.  Alone: the rename, unless the write
    failed.  On a group (a collective, every rank): every rank's verdict,
    then rank 0's rename only if every write succeeded; each rank raises
    its own error, or one naming the ranks whose write failed."""
    t0 = time.perf_counter()
    if not save_.group:
        if error is not None:
            raise error
        _publish(save_.tmp, save_.final, save_.meta)
        save_.stats.publish_s = time.perf_counter() - t0
        return
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    verdicts = [torch.zeros(1, dtype=torch.int32) for _ in range(world)]
    dist.all_gather(verdicts, torch.tensor([int(error is not None)],
                                           dtype=torch.int32))
    failed = [r for r, v in enumerate(verdicts) if int(v)]
    published = torch.zeros(1, dtype=torch.int32)
    if rank == 0:
        if failed:
            shutil.rmtree(save_.tmp, ignore_errors=True)
        else:
            try:
                _publish(save_.tmp, save_.final, save_.meta)
                published[0] = 1
            except OSError as exc:
                error = exc
    dist.broadcast(published, src=0)
    save_.stats.publish_s = time.perf_counter() - t0
    if error is not None:
        raise error
    if not int(published):
        raise RuntimeError(
            f"step {save_.meta['step']} not published: the write failed on "
            f"rank(s) {failed or [0]}")


def save(ckpt_dir: str, step: int, tree,
         local_leaf_filter: Optional[Callable[[int], bool]] = None) -> str:
    """Synchronous atomic checkpoint save. Returns the final directory.
    On a group (DTensor leaves) every rank calls it; it returns once the
    step is published."""
    pending = _snapshot(ckpt_dir, step, tree, local_leaf_filter)
    error = None
    try:
        _write(pending)
    except Exception as exc:  # noqa: BLE001  (raised by _finish)
        error = exc
    _finish(pending, error)
    return pending.final


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk on a daemon thread.
    ``history`` keeps each finished save's ``SaveStats``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[_Save] = None
        self.last_error: Optional[BaseException] = None
        self.history: List[SaveStats] = []

    def wait(self):
        """Wait for the save in flight; publish it (on a group, with
        every rank: call it on all of them) or raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        pending, self._pending = self._pending, None
        err, self.last_error = self.last_error, None
        if pending is not None and pending.group:
            _finish(pending, err)
        elif err is not None:
            raise err
        if pending is not None:
            self.history.append(pending.stats)

    def save_async(self, ckpt_dir: str, step: int, tree) -> None:
        self.wait()
        # a copy: training updates the parameters in place
        pending = _snapshot(ckpt_dir, step, tree, copy=True)

        def work():
            try:
                _write(pending)
                if not pending.group:
                    _finish(pending, None)
            except BaseException as e:  # noqa: BLE001  (re-raised by wait)
                self.last_error = e

        self._pending = pending
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


def restore(ckpt_dir: str, step: int, tree_template, shardings=None):
    """Restore into the structure of ``tree_template`` (nested dicts of
    tensors), each leaf on its template leaf's device.  Returns (tree,
    step).

    ``shardings``: optional tree of ``sharding.partition.NamedSharding``
    of the template's structure (a ``None`` leaf keeps its leaf whole):
    the *elastic* restore onto a mesh other than the one that saved.  Each
    leaf is read whole and placed (``partition.place``, no collective) on
    its sharding's mesh over the live process group."""
    final, _ = _step_dirs(ckpt_dir, step)
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    by_idx = {leaf["i"]: leaf for leaf in meta["leaves"]}
    shards: Dict[int, Any] = {}
    counter = itertools.count()

    def load(leaf, sharding=None):
        i = next(counter)
        info = by_idx.get(i)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {i}")
        sid = info["shard"]
        if sid not in shards:
            shards[sid] = np.load(os.path.join(final, f"shard_{sid:05d}.npz"))
        x = _from_savable(shards[sid][f"leaf_{i:06d}"],
                          info["dtype"]).to(leaf.device)
        if sharding is None:
            return x
        from repro_torch.sharding import partition as pt
        dm = sharding.mesh.device_mesh_on(leaf.device.type)
        return pt.place(x, dm, sharding.placements())

    try:
        if shardings is None:
            restored = tr.tree_map(load, tree_template)
        else:
            restored = tr.tree_map(load, tree_template, shardings)
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
