"""Decode over a ``("data", "model")`` mesh of 4 gloo CPU ranks (the serve
step over DTensors: parameters by ``param_pspecs``, the decode state by
``decode_state_pspecs`` through ``train_step.shard_decode_state``), against
single-device decode, on the CPU; and the dry-run's trace against the real
sharded train step.

Each architecture's ranks run in a spawn of their own at its smoke
config: batch 4, 8 positions on (2, 2) and on (1, 4), where the model axis
shards the caches' sequence (the KV heads do not divide 4) and the
hybrid's stacked Mamba2 states on their layer and batch axes.  Every
position's logits within 1e-5 of one device's (f32 sums in another
order; 4e-7 seen, against logits of order 1), and for qwen3-0.6b and
zamba2 greedy generation (``launch.generate``, 4 + 4 tokens) over (2, 2)
the same tokens, every step's logits (recorded around
``train_step.decode_step``) as close.

The parent tree failed zamba2 at (2, 2) from position 1 and at (1, 4)
from position 2 (logits 0.3–0.7 apart), and every architecture with a
sequence-sharded cache at (1, 4) from position 2: a recurrent state's
write into a copy of a sharded stack (``t[idx].copy_``), and a cache row
written at a clamped position by devices that do not hold it.

The dry-run's fidelity: its (2, 2) train trace of qwen3-0.6b at the
``cells`` shape (batch 8 × 32) against the real step on 4 ranks at the
same shape: the walker's matrix-product flops within 2 % of
``FlopCounterMode`` on rank 0 (equal, seen), and the collectives by kind
equal to ``CommDebugMode``'s, but for the dry-run's all-to-all (an
all-gather and a chunk on a CPU mesh) and the real step's host read of
its partial-sum metrics (one all-reduce a partial axis).
"""
import collections
import gzip
import json

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import hlo_parse as hp

import torch_sharded_workers as W

WORLD = 4
MESHES = [(2, 2), (1, 4)]
ATOL = 1e-5


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_single_device(arch):
    ranks = run_ranks(W.decode_rank, WORLD, arch, MESHES, timeout=300)
    for out in ranks:
        assert out["scale"] > 0.1
        for dims in MESHES:
            errs = out["meshes"][dims]
            assert len(errs) == W.DECODE_S
            assert max(errs) <= ATOL, (dims, errs)
        if arch in W.GENERATE_ARCHS:
            assert out["generate_equal"]
            n_want, n_got, diff = out["generate_logits"]
            assert n_want == n_got == W.DECODE_S - 1
            assert diff <= ATOL


def test_bf16_decode_rounds_again_only_on_the_model_axis():
    """qwen3-0.6b's decode with bf16 parameters: the data axis alone
    (4, 1) gives one device's logits (f32 sums in another order); where
    the model axis splits a contraction, (2, 2) and (1, 4), each device's
    partial product is rounded to bf16 before the sum over the axis, so
    the logits leave one device's, and stay within twice one device's own
    bf16 error of the f32 decode (the truth), the bound that
    ``chip_smoke.py`` phase 15 (c) holds at full width."""
    out = run_ranks(W.bf16_decode_rank, WORLD, "qwen3-0.6b",
                    [(4, 1), (2, 2), (1, 4)], timeout=300)[0]
    own = out["one"]
    assert own > 1e-3                      # bf16's error, seen 5.4e-3
    to_truth, to_one = out["meshes"][(4, 1)]
    assert to_one <= ATOL
    for dims in MESHES:
        to_truth, to_one = out["meshes"][dims]
        assert to_one > 10 * ATOL, dims
        assert to_truth <= 2 * own, (dims, to_truth, own)


FAITH_ARCH, FAITH_B, FAITH_S = "qwen3-0.6b", 8, 32


def _kind(op: str) -> str:
    """``_c10d_functional.all_reduce.default`` -> ``all_reduce``."""
    return op.split(".")[1]


def test_dryrun_trace_against_the_real_step(tmp_path):
    cfg = smoke_config(ARCHS[FAITH_ARCH])
    shape = ShapeConfig("train_smoke", FAITH_S, FAITH_B, "train")
    rec = dr.run_cell(FAITH_ARCH, shape.name, False, False, verbose=False,
                      cfg=cfg, shape=shape,
                      mesh=mesh_lib.make_mesh((2, 2), ("data", "model")),
                      outdir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert not dist.is_initialized()
    with gzip.open(tmp_path / f"{FAITH_ARCH}_{shape.name}_mesh2x2"
                   f".graphs.json.gz", "rt") as f:
        graphs = json.load(f)["graphs"]
    traced = collections.Counter(
        _kind(n["op"]) for g in graphs for n in g["nodes"]
        if hp.is_collective(n["op"]))
    real = run_ranks(W.faithful_rank, WORLD, FAITH_ARCH, FAITH_B, FAITH_S,
                     (2, 2), timeout=300)[0]
    assert hp.matmul_flops(graphs) == pytest.approx(real["flops"], rel=0.02)
    counted = collections.Counter(
        {_kind(op): n for op, n in real["comm"].items()})
    # on a CPU mesh the all-to-all is an all-gather and a chunk
    traced["all_gather_into_tensor"] += traced.pop("shard_dim_alltoall", 0)
    counted["all_reduce"] -= real["metric_reduces"]
    assert real["metric_reduces"] > 0
    assert +traced == +counted, (traced, counted)
