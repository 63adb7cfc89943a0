"""The port's dry-run of every family but the dense one, at the smoke
configs on a fake 2×2 mesh (train cells; the prefill and decode cells are
in ``test_torch_dryrun_pods.py``), on the CPU.

A cell gives ``"status": "ok"``, or the ``fail`` that ``ROADMAP.md``
queue 3 lists for its arch, naming the op that DTensor could not
propagate.
"""
import os

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_lib

OTHER_FAMILIES = sorted(n for n, c in ARCHS.items() if c.family != "dense")
ROADMAP = os.path.join(os.path.dirname(__file__), os.pardir, "ROADMAP.md")


def smoke_cell(tmp_path, name, kind, dims=(2, 2)):
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    shape = ShapeConfig(f"{kind}_smoke", 32, 8, kind)
    rec = dr.run_cell(name, shape.name, False, False, verbose=False,
                      cfg=smoke_config(ARCHS[name]), shape=shape,
                      mesh=mesh_lib.make_mesh(dims, axes),
                      outdir=str(tmp_path))
    assert not dist.is_initialized()
    return rec


def ok_or_listed(rec):
    if rec["status"] == "ok":
        assert rec["device_flops"] > 0 and rec["device_coll_bytes"] > 0
        return
    assert rec["status"] == "fail" and rec["op"], rec
    with open(ROADMAP) as f:
        roadmap = f.read()
    assert f"{rec['arch']}" in roadmap and rec["op"] in roadmap, rec


def test_every_family_is_covered():
    assert {ARCHS[n].family for n in OTHER_FAMILIES} == {
        "moe", "ssm", "hybrid", "encdec", "vlm"}


@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_family_train_cell(tmp_path, name):
    ok_or_listed(smoke_cell(tmp_path, name, "train"))
