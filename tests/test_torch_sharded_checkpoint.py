"""Checkpoints of sharded state and the elastic restore
(``train/checkpoint.py``'s ``save(local_leaf_filter=)``, its group save of
DTensor leaves and ``restore(shardings=)``; ``Trainer(mesh=)``;
``launch/train.py --mesh``), on the CPU, against the reference where it
has the function.

The ranks (gloo, one torch thread each) run the rank functions of
``tests/torch_checkpoint_workers.py``: qwen3-0.6b's smoke config (f32),
batch 4 × 16, 4 steps, a checkpoint every 2.  Spawns: 4 ranks twice (the
(2, 2) runs, the launcher), 2 ranks once.

Tolerances: what a checkpoint holds is compared bit for bit.  A run
resumed on the mesh that saved is the uninterrupted run's bits.  A run
resumed on another mesh (or one device) sums its products in another
order: its losses are held to the uninterrupted (2, 2) run's within
``tests/test_torch_sharded_train.py``'s 1e-6 relative.
"""
import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt

from repro_torch import tree as tr
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import train as train_cli
from repro_torch.train import checkpoint as ckpt

import torch_checkpoint_workers as W

TIMEOUT = 300
LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                  "b": rng.standard_normal(7).astype(np.float32)},
            "c": rng.integers(0, 9, (2, 2)).astype(np.int32),
            "d": rng.standard_normal((4, 4)).astype(ml_dtypes.bfloat16)}


def _files(d):
    """meta.json and every array of every shard file of a step dir."""
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    arrays = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as npz:
                arrays.update({(name, k): npz[k] for k in npz.files})
    return meta, arrays


@pytest.mark.parametrize("keep", [None, (0, 2), (1, 3)])
def test_leaf_filter_writes_what_the_reference_writes(tmp_path, keep):
    tree = _mixed_tree()
    ttree = tr.tree_map(tr.from_numpy, tree)
    filt = None if keep is None else (lambda i: i in keep)
    jckpt.save(str(tmp_path / "ref"), 3, tree, local_leaf_filter=filt)
    ckpt.save(str(tmp_path / "port"), 3, ttree, local_leaf_filter=filt)
    rmeta, rarr = _files(str(tmp_path / "ref" / "step_00000003"))
    pmeta, parr = _files(str(tmp_path / "port" / "step_00000003"))
    assert pmeta == rmeta
    assert set(parr) == set(rarr)
    for k in rarr:
        assert parr[k].dtype == rarr[k].dtype
        np.testing.assert_array_equal(parr[k], rarr[k])
    if keep is not None:
        assert [leaf["i"] for leaf in pmeta["leaves"]] == list(keep)


def test_owners_balance_bytes():
    assert ckpt.owners([10, 40, 30, 20], 2) == [0, 0, 1, 1]
    assert ckpt.owners([5, 5, 5], 4) == [0, 1, 2]
    sizes = [int(s) for s in np.random.default_rng(1).integers(1, 1000, 50)]
    load = [0] * 4
    for s, r in zip(sizes, ckpt.owners(sizes, 4)):
        load[r] += s
    assert max(load) - min(load) <= max(sizes)


def test_mesh_for_plan_follows_the_planner():
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import fault_tolerance as ft
    planner = ft.ElasticPlanner(model_parallel=2, chips_per_host=1,
                                global_batch=4)
    meshes = [mesh_lib.mesh_for_plan(planner.plan(n)) for n in (4, 3)]
    assert [(m.axis_names, tuple(m.shape.values())) for m in meshes] == [
        (("data", "model"), (2, 2)), (("data", "model"), (1, 2))]


def test_elastic_restore_resharding_single_process(tmp_path):
    """The reference's test without a sharding target here: restored
    whole, onto the template's device (its twin onto a mesh runs in
    ``elastic``)."""
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    ckpt.save(str(tmp_path / "ck"), 5, tree)
    restored, step = ckpt.restore(str(tmp_path / "ck"), 5, tree,
                                  shardings={"w": None})
    assert step == 5
    assert torch.equal(restored["w"], tree["w"])


# ---------------------------------------------------------------- (2, 2)

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


@pytest.fixture(scope="module")
def mesh_runs(root):
    return run_ranks(W.mesh_rank, 4, root, timeout=TIMEOUT)


def _equal_trees(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resume_on_the_same_mesh_is_bit_equal(mesh_runs):
    for out in mesh_runs:
        assert out["losses"] == out["whole_losses"]
        _equal_trees(out["resumed"], out["whole"])
        # every rank gathered the same state
        _equal_trees(out["whole"], mesh_runs[0]["whole"])


def test_reference_reads_the_dtensor_checkpoint(mesh_runs, root, tmp_path):
    """The reference's restore reads the (2, 2) checkpoint into the arrays
    of the gathered state; its meta has the names, dtypes and shapes of
    the reference's own save of that gathered tree."""
    saved = mesh_runs[0]["saved"]
    template = tr.unflatten([(_path(k), v) for k, v in saved.items()])
    template.setdefault("err", {})
    got, step = jckpt.restore(os.path.join(root, "at"), W.AT, template)
    assert step == W.AT
    import jax
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(got)}
    _equal_trees(flat, saved)
    jckpt.save(str(tmp_path / "ref"), W.AT, template)
    rmeta, _ = _files(str(tmp_path / "ref" / f"step_{W.AT:08d}"))
    pmeta, arrays = _files(os.path.join(root, "at", f"step_{W.AT:08d}"))

    def described(meta):
        return [(leaf["i"], leaf["name"], leaf["dtype"], leaf["shape"])
                for leaf in meta["leaves"]]
    assert described(pmeta) == described(rmeta)
    # each leaf written once, by one of the four ranks' shard files
    assert len(arrays) == len(pmeta["leaves"])
    assert {leaf["shard"] % 4 for leaf in pmeta["leaves"]} == {0, 1, 2, 3}


def _path(keystr):
    return tuple(part.strip("'") for part in keystr[1:-1].split("]["))


def test_save_async_snapshots_at_the_call(mesh_runs):
    for out in mesh_runs:
        assert out["async_step"] == 7
        # the state changed in place after the call; the checkpoint holds
        # the state at the call
        _equal_trees(out["async"], out["whole"])
        (stats,) = out["async_stats"]
        assert stats["write_s"] >= W.WRITE_DELAY_S
    assert sum(o["async_stats"][0]["bytes_written"] for o in mesh_runs) == \
        sum(v.nbytes for v in mesh_runs[0]["whole"].values())


@pytest.mark.parametrize("how", ["sync", "async"])
def test_a_failed_rank_publishes_no_step(mesh_runs, how):
    for rank, out in enumerate(mesh_runs):
        error, latest, listing = out["failed"][how]
        assert latest is None and listing == [], (rank, listing)
        if rank == 1:
            assert error.startswith("OSError: disk lost"), error
        else:
            assert "not published" in error and "[1]" in error, error


# ------------------------------------------------------------- elastic

@pytest.fixture(scope="module")
def ref_dir(mesh_runs, root):
    """The reference's own save of the gathered (2, 2) state at ``AT``."""
    d = os.path.join(root, "reference")
    template = tr.unflatten([(_path(k), v)
                             for k, v in mesh_runs[0]["saved"].items()])
    jckpt.save(d, W.AT, template)
    return d


@pytest.fixture(scope="module")
def elastic(mesh_runs, root, ref_dir):
    return run_ranks(W.elastic_rank, 2, root, ref_dir, (1, 2),
                     timeout=TIMEOUT)


def _close_losses(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (got, want)


def test_elastic_restore_onto_a_smaller_mesh(mesh_runs, elastic):
    saved, whole = mesh_runs[0]["saved"], mesh_runs[0]["whole_losses"]
    for out in elastic:
        assert out["start"] == W.AT
        _equal_trees(out["restored"], saved)
        # placed by (1, 2)'s specs: the weights split over the model axis
        assert any("Shard" in p for p in out["placements"].values())
        assert out["to_numpy"].startswith("leaf ['params']"), out["to_numpy"]
        assert "DTensor" in out["to_numpy"]
        _close_losses(out["losses"], whole[W.AT:])
        assert out["losses"] == elastic[0]["losses"]


def test_port_restores_the_reference_checkpoint_onto_a_mesh(mesh_runs,
                                                            elastic):
    for out in elastic:
        step, got = out["from_reference"]
        assert step == W.AT
        _equal_trees(got, mesh_runs[0]["saved"])


def test_elastic_restore_resharding(elastic):
    """Twin of ``tests/test_extras.py::test_elastic_restore_resharding``:
    saved once, restored under a sharding target on a (1, 2) mesh."""
    want = np.arange(32, dtype=np.float32).reshape(4, 8)
    for rank, out in enumerate(elastic):
        step, placements, local, full = out["twin"]
        assert step == 5
        assert placements == "(Replicate(), Shard(dim=1))"
        np.testing.assert_array_equal(local, want[:, 4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(full, want)


def test_elastic_restore_onto_one_device(mesh_runs, root):
    d = os.path.join(root, "one_device")
    shutil.copytree(os.path.join(root, "at"), d)
    t = W.trainer(W.TOTAL, d)
    params, opt, err, start = t.maybe_restore(*t.init_state())
    assert start == W.AT
    _equal_trees(W.gathered(params, opt, err), mesh_runs[0]["saved"])
    _close_losses(t.fit()["losses"], mesh_runs[0]["whole_losses"][W.AT:])


# ------------------------------------------------------------ launcher

def test_launcher_runs_a_mesh():
    argv = ["--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    ranks = train_cli.main(argv + ["--mesh", "2,2"])
    one = train_cli.main(argv)
    assert len(ranks) == 4 and all(r == ranks[0] for r in ranks)
    _close_losses(ranks[0], one)


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.trainer(W.TOTAL, None, (2, 2), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--steps", "1", "--mesh", "2,2"])
