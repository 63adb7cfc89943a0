"""Run a function on P local ranks of a fresh process group.

``run_ranks(fn, world, *args)`` starts ``world`` processes (the
``forkserver`` start method: each is forked from a server process that
started once, by ``spawn``, and imported torch and DTensor, so a rank
starts in well under a second where a spawned one spends seconds
importing; the server initialises no device), each of which joins a process group through a ``file://``
rendezvous in a private temporary directory (so concurrent runs never
collide), calls ``fn(rank, world, *args)``, and sends back its return
value, which must pickle (numpy arrays and plain Python values; move
tensors to the CPU first).  The group is ``gloo``: it runs on CPU tensors
and on CUDA tensors, several ranks on one card included (NCCL refuses
two ranks on one card).  ``fn`` must be importable by the child: a
module-level function of an importable module, or of a script whose
entry point sits under ``if __name__ == "__main__"``.

Each rank takes an equal share of the host's cores for PyTorch's CPU
threads.  A rank that raises, dies, or outlives ``timeout`` fails the run:
every rank is stopped and the first failure is raised with its traceback.
``stop_servers()`` stops the fork server (and multiprocessing's resource
tracker) before the caller exits.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List


# imported once by the fork server (a no-op once it has started)
_PRELOAD = ["torch", "torch.distributed.tensor"]


def _entry(rank: int, world: int, init_method: str, timeout: float, fn: Callable, args: tuple, out) -> None:
    import torch
    import torch.distributed as dist
    # the ranks share the host's cores: threads spinning in P processes at
    # once would stall them all
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    out.put((rank, True, result))


def run_ranks(fn: Callable, world: int, *args,
              timeout: float = 300.0) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process as one rank of a ``world``-rank group."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    results = ctx.Queue()
    done = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_entry, daemon=True, args=(
            r, world, init, timeout, fn, args, results))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(world)) - set(done))} "
                            f"did not finish within {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                done[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10 if len(done) == world else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(world)]


def stop_servers() -> None:
    """Stop the fork server and the resource tracker that ``run_ranks``
    started.  Each ends by itself once this process has exited; a caller
    that must leave no process behind when it returns stops them here.
    A later ``run_ranks`` starts them again."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
