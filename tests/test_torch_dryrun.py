"""The port's dry-run (``repro_torch.launch.dryrun``) at qwen3-0.6b's
smoke config on fake meshes of 1 and 2×2 devices, against the JAX
package's own dry-run on a one-device mesh, on the CPU.

``run_cell`` brings up a fake process group of the mesh's size and tears
it down; the tests check that none is left behind.  The (1, 1) train
cell's walker flops are held within 10 % of the reference's
``analyze_compiled`` of its ``lower_train_cell`` at the same config and
batch: both count the products 2·m·n·k, but the reference counts XLA's
fused elementwise ops (one flop an element of each fusion's ops, its
scan's loop counters) and the port eager torch's unfused ones (each cast,
each view-free op), so the elementwise share differs by a few percent.
The (2, 2) products of one device lie between a quarter of the (1, 1)
total and the total: sharding divides the work, and gathering before a
product never adds to it.
"""
import gzip
import json

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.launch import dryrun as jdryrun
from repro.roofline import analysis as janalysis
from repro.sharding import partition as jpt
from repro.train import train_step as jts

from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import hlo_parse as hp

B, S = 8, 32
KINDS = ("train", "prefill", "decode")


def _cell(tmp_path, name, kind, dims, batch=B, seq=S):
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    cfg = smoke_config(ARCHS[name])
    shape = ShapeConfig(f"{kind}_smoke", seq, batch, kind)
    rec = dr.run_cell(name, shape.name, False, False, verbose=False,
                      cfg=cfg, shape=shape,
                      mesh=mesh_lib.make_mesh(dims, axes),
                      outdir=str(tmp_path))
    assert not dist.is_initialized()
    return rec


def _graphs(tmp_path, rec):
    path = tmp_path / f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.graphs.json.gz"
    with gzip.open(path, "rt") as f:
        return json.load(f)["graphs"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    return tmp, {(kind, dims): _cell(tmp, "qwen3-0.6b", kind, dims)
                 for kind in KINDS for dims in ((1, 1), (2, 2))}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_qwen3_cells_ok(cells, kind, dims):
    rec = cells[1][(kind, dims)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == dims[0] * dims[1]
    assert rec["device_flops"] > 0 and rec["device_hbm_bytes"] > 0
    assert rec["arg_bytes_per_device"] > 0
    assert rec["temp_bytes_per_device"] > 0
    assert "temp_bytes_per_device" in rec["memory_analysis"]
    if dims == (2, 2):
        assert rec["device_coll_bytes"] > 0 and rec["coll_breakdown"]
    else:
        assert rec["device_coll_bytes"] == 0


def test_train_flops_near_reference_dryrun(cells):
    """The (1, 1) train cell against the reference's compiled step on a
    one-device mesh, in this process."""
    jcfg = jsmoke_config(JARCHS["qwen3-0.6b"])
    jshape = JShapeConfig("train_smoke", S, B, "train")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ctx = jts.sharding_ctx_for(mesh, jcfg)
    with mesh, jpt.activate(ctx):
        compiled = jdryrun.lower_train_cell(jcfg, jshape, mesh, ctx)
    ref = janalysis.analyze_compiled(compiled, jcfg, jshape, "mesh1x1", 1)
    got = cells[1][("train", (1, 1))]
    assert got["model_flops"] == ref.model_flops
    assert got["device_flops"] == pytest.approx(ref.device_flops, rel=0.10)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_products_divide_the_work(cells, kind):
    tmp, recs = cells
    one = hp.matmul_flops(_graphs(tmp, recs[(kind, (1, 1))]))
    four = hp.matmul_flops(_graphs(tmp, recs[(kind, (2, 2))]))
    assert one / 4 <= four <= one


def test_reanalyze_recomputes_the_record(cells, monkeypatch):
    """``--reanalyze`` re-walks an archived cell to the same device
    numbers, without a new trace."""
    tmp, _ = cells
    cfg = smoke_config(ARCHS["qwen3-0.6b"])
    shape = ShapeConfig("train_4k", S, B, "train")     # a registry name
    rec = dr.run_cell("qwen3-0.6b", "train_4k", False, False, verbose=False,
                      cfg=cfg, shape=shape,
                      mesh=mesh_lib.make_mesh((1, 1), ("data", "model")),
                      outdir=str(tmp))
    monkeypatch.setattr(dr, "OUTDIR", str(tmp))
    monkeypatch.setattr(dr, "lower_train_cell", None)        # no trace
    dr.main(["--reanalyze"])
    with open(tmp / f"{cfg.name}_train_4k_mesh1x1.json") as f:
        again = json.load(f)
    for key in ("device_flops", "device_hbm_bytes", "device_coll_bytes",
                "arg_bytes_per_device", "temp_bytes_per_device"):
        assert again[key] == rec[key]
    assert again["status"] == "ok"


def test_table_rows(cells, monkeypatch, capsys):
    """``--table``: a row for each cell of ``all_cells`` on each mesh, "not
    reached" where no record is."""
    tmp, _ = cells
    monkeypatch.setattr(dr, "OUTDIR", str(tmp))
    assert dr.main(["--table"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 2 + 80
    assert all(r.endswith("not reached | |") for r in rows[2:])


def test_skip_and_also(tmp_path):
    """long_500k on a full-attention arch is a skip record; ``--also``
    names a mesh and a batch × sequence of the shape's kind."""
    rec = dr.run_cell("qwen3-0.6b", "long_500k", False, False,
                      verbose=False, outdir=str(tmp_path))
    assert rec["status"] == "skip" and "SKIP" in rec["reason"]
    mesh, shape = dr._also("1x1:4x128", "qwen3-0.6b",
                           dr.SHAPES_BY_NAME["train_4k"])
    assert tuple(mesh.shape.values()) == (1, 1)
    assert (shape.global_batch, shape.seq_len, shape.kind) == (4, 128,
                                                               "train")
    assert dr.mesh_name_of(mesh_lib.make_production_mesh()) == "pod256"
    assert dr.mesh_name_of(mesh_lib.make_production_mesh(
        multi_pod=True)) == "pod512"
