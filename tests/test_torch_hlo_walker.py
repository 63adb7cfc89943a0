"""The port's roofline walker and report (``repro_torch.roofline.hlo_parse``,
``repro_torch.roofline.analysis``) against the JAX package's, on the CPU.

The reference walks optimized HLO text; the port walks the aten ops that
``launch/dryrun.py``'s ``Recorder`` records.  The same functions go
through both: the reference test's seven ``tanh(c @ w)`` layers, and
single collectives over a group of 2 among 8 ranks (a fake process group
here, torn down after each test; replica groups ``[4,2]<=[8]`` in the
reference's HLO).  The reports: ``model_flops_for`` on all 40 cells, and
``finish`` / ``format_row`` on fixed inputs with the reference's
constants put into the port's ``hw`` (the formulas), then with the
port's own (the H100's figures).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.configs.registry import all_cells as jall_cells
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_parse as jhp
from repro.roofline import hw as jhw

from repro_torch.configs.registry import ARCHS
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis, hlo_parse as hp, hw


def _record(fn, *shapes):
    """The cost of ``fn`` on fake tensors of ``shapes`` (f32)."""
    rec = dr.Recorder()
    with rec:
        args = [torch.empty(s) for s in shapes]
        rec.start("forward")
        fn(*args)
        rec.stop()
    return rec.graphs


@contextlib.contextmanager
def _fake_group(world=8, ranks=(0, 1)):
    """A fake world of ``world`` ranks and the group ``ranks`` in it,
    destroyed afterwards."""
    with dr.fake_world(mesh_lib.make_mesh((world,), ("x",))):
        yield dist.new_group(list(ranks))


# --------------------------------------------------------------------- flops
def test_loop_flops_match_reference_walker():
    """Seven tanh(c @ w) layers at 64: within the reference test's band
    (0.9-1.3 × 2·64³·7) and within 2 % of the reference's walker on the
    compiled scan (both count the products 2·m·n·k and every other op one
    flop an element; the scan's counter and the reference's fused tanh
    differ by a few thousand flops)."""
    def jf(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, ws)
        return y.sum()

    compiled = jax.jit(jf).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32),
                                 jax.ShapeDtypeStruct((7, 64, 64), jnp.float32)
                                 ).compile()
    ref = jhp.entry_cost(compiled.as_text(), 1)

    def tf(x, ws):
        for w in torch.unbind(ws, 0):
            x = torch.tanh(x @ w)
        return x.sum()

    got = hp.entry_cost(_record(tf, (64, 64), (7, 64, 64)), 1)
    expected = 2 * 64 * 64 * 64 * 7
    assert expected * 0.9 < got.flops < expected * 1.3
    assert got.flops == pytest.approx(ref.flops, rel=0.02)
    assert hp.matmul_flops(_record(tf, (64, 64), (7, 64, 64))) == expected


# --------------------------------------------------------------- collectives
_REF_HLO = """\
HloModule jit_f, entry_computation_layout={{(f32[128,128])->f32[]}}

ENTRY %main.1 (p0: f32[128,128]) -> f32[128,128] {{
  %p0 = f32[128,128]{{1,0}} parameter(0)
  ROOT %c = {out}{{1,0}} {op}(%p0), replica_groups=[4,2]<=[8]{attrs}
}}
"""


def _ref_collective(op, out, attrs=""):
    return jhp.entry_cost(_REF_HLO.format(op=op, out=out, attrs=attrs), 8)


def test_all_reduce_matches_reference_sample():
    """f32[128,128] all-reduced over a group of 2 among 8 ranks: the
    reference test's SAMPLE (its all-reduce) and the port's recorded
    ``_c10d_functional.all_reduce``."""
    from tests.test_roofline import SAMPLE
    ref = jhp.entry_cost(SAMPLE, 8)
    with _fake_group() as g:
        got = hp.entry_cost(_record(
            lambda x: funcol.all_reduce(x, "sum", g), (128, 128)), 8)
    assert got.coll_bytes["all-reduce"] == ref.coll_bytes["all-reduce"]
    assert got.coll_wire_bytes == ref.coll_wire_bytes == 128 * 128 * 4


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-to-all"])
def test_collectives_follow_reference_ring_rule(kind):
    """All-gather (output 2× the input), reduce-scatter (half) and
    all-to-all of f32[128,128] over a group of 2 among 8: the buffer's
    bytes, the wire bytes (n − 1)/n of them and the local read and write,
    as the reference charges the same HLO collective."""
    calls = {
        "all-gather": (lambda g: lambda x: funcol.all_gather_tensor(
            x, 0, g), "f32[256,128]", ", dimensions={0}"),
        "reduce-scatter": (lambda g: lambda x: funcol.reduce_scatter_tensor(
            x, "sum", 0, g), "f32[64,128]", ", dimensions={0}"),
        "all-to-all": (lambda g: lambda x: funcol.all_to_all_single(
            x, None, None, g), "f32[128,128]", ", dimensions={0}"),
    }
    make, out, attrs = calls[kind]
    ref = _ref_collective(kind, out, attrs)
    with _fake_group() as g:
        got = hp.entry_cost(_record(make(g), (128, 128)), 8)
    assert got.coll_bytes == ref.coll_bytes
    assert got.coll_wire_bytes == ref.coll_wire_bytes
    assert got.hbm_bytes == ref.hbm_bytes      # the local read and write


def test_redistribute_is_charged_as_the_cards_all_to_all():
    """A Shard(0) → Shard(1) redistribute on a CPU mesh of 2: DTensor's
    CPU fallback is an all-gather and a chunk; inside the dry-run's aid it
    is the all-to-all that NCCL sends, charged (n − 1)/n of its bytes."""
    from torch.distributed.tensor import DTensor, Shard

    def run(aid):
        with dr.fake_world(mesh_lib.make_mesh((2,), ("model",))) as dm:
            rec = dr.Recorder()
            with rec:
                x = DTensor.from_local(torch.empty(64, 128), dm, [Shard(0)],
                                       run_check=False)
                with aid():
                    rec.start("forward")
                    x.redistribute(dm, [Shard(1)])
                    rec.stop()
        return hp.entry_cost(rec.graphs, 2)

    card = run(dr._alltoall_as_on_the_card)
    cpu = run(contextlib.nullcontext)
    assert card.coll_bytes == {"all-to-all": 64 * 128 * 4}
    assert card.coll_wire_bytes == 64 * 128 * 4 / 2
    assert set(cpu.coll_bytes) == {"all-gather"}


def test_dtype_bytes_equal_reference():
    """Every torch dtype with an HLO name has the reference's size, and
    every HLO type of the reference that torch has is covered."""
    for dt, name in hp._HLO_NAME.items():
        assert hp._DTYPE_BYTES[name] == jhp._DTYPE_BYTES[name] == dt.itemsize
        assert hp.dtype_bytes(str(dt).split(".")[-1]) == dt.itemsize
    covered = set(hp._HLO_NAME.values())
    assert set(jhp._DTYPE_BYTES) - covered == {"token", "opaque"}


# ------------------------------------------------------------------ analysis
def test_model_flops_match_reference_on_all_cells():
    cells = list(jall_cells())
    assert len(cells) == 40
    for jcfg, jshape, _, _ in cells:
        got = analysis.model_flops_for(ARCHS[jcfg.name],
                                       SHAPES_BY_NAME[jshape.name])
        assert got == janalysis.model_flops_for(jcfg, jshape)


_FIXED = dict(arch="a", shape="train_4k", mesh="pod256", chips=256,
              device_flops=3.1e15, device_hbm_bytes=2.2e12,
              device_coll_bytes=4.4e10, coll_breakdown={"all-gather": 1.0},
              model_flops=5.0e17, arg_bytes_per_device=3.0e10,
              temp_bytes_per_device=2.5e10)


def test_finish_and_format_row_are_the_reference_formulas(monkeypatch):
    """With the reference's constants in the port's ``hw`` the report and
    its row equal the reference's field for field."""
    for name, value in (("PEAK_FLOPS_BF16", jhw.PEAK_FLOPS_BF16),
                        ("HBM_BW", jhw.HBM_BW),
                        ("HBM_PER_CHIP", jhw.HBM_PER_CHIP),
                        ("LINK_BW", jhw.ICI_LINK_BW),
                        ("LINKS", jhw.ICI_LINKS)):
        monkeypatch.setattr(hw, name, value)
    ref = janalysis.RooflineReport(**_FIXED).finish()
    got = analysis.RooflineReport(**_FIXED).finish()
    assert got.to_json() == ref.to_json()
    assert analysis.format_row(got) == janalysis.format_row(ref)
    assert got.roofline_fraction() == ref.roofline_fraction()


def test_finish_with_the_h100_figures():
    rep = analysis.RooflineReport(**_FIXED).finish()
    assert rep.compute_s == _FIXED["device_flops"] / 989.4e12
    assert rep.memory_s == _FIXED["device_hbm_bytes"] / 3.35e12
    assert rep.collective_s == _FIXED["device_coll_bytes"] / (25e9 * 18)
    assert rep.bottleneck == "compute"
    assert rep.step_time_s == rep.compute_s
    assert rep.useful_ratio == _FIXED["model_flops"] / (3.1e15 * 256)
    assert rep.fits_hbm is True
    fields = [f.name for f in dataclasses.fields(analysis.RooflineReport)]
    assert fields == [f.name for f in
                      dataclasses.fields(janalysis.RooflineReport)]
    assert analysis.format_row(rep).startswith("| a | train_4k | pod256 | ")
