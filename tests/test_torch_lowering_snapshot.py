"""The port's lowering decisions against a golden file of its own, and
against the reference's golden snapshot where the two designs agree.

``repro_torch.kernels.lowering.lower()`` runs over the reference's decision
grid (``tests/test_lowering.py``'s ``_grid``: 409 cases of op × impl × dtype ×
gather × batch × shard × ragged n over its seven plans), with the impls
renamed (``pallas`` → ``cuda``, ``pallas_v1`` → ``cuda_v1``, ``xla`` →
``torch``; ``auto`` stays) and every operand on the card (``device="cuda"``).
The decisions are computed without a card: the tuner's backend tag, which
reads the card's name, is pinned, and the tuner's cache is empty.

  1. Golden — the records equal ``tests/data/torch_lowering_snapshot.json``
     case by case.  A dispatch change shows up as a diff of that file;
     regenerate with ``REGEN_TORCH_LOWERING_SNAPSHOT=1 pytest
     tests/test_torch_lowering_snapshot.py`` after reviewing it.
  2. The reference — each case's plan dict, ``pad_rows``, ``n_eff``,
     ``n_loc``, ``batch_loc`` and ``shard`` equal to the reference
     snapshot's record of the same case, and its ``pad_cols`` (always 0
     there) the port's design: the kernels mask the ragged column edge, so
     the port never pads columns.

Fields that differ by design and are held only to the port's own golden:

  * ``tn``, ``tn_source``, ``grid_cols``: the CUDA kernels' tiles and rules
    (the reference's Pallas tiles follow VMEM; ``v1_default`` and the
    narrow route's ``None`` have no counterpart);
  * ``impl``, ``downgrade``, ``version``, ``variant``, ``gather_fused``:
    the reference downgrades to its v1 kernel or to its jnp oracle where a
    stacked Φ or a gather's working set outgrows VMEM; the port's kernels
    read S from a CSR and fit at every case of the grid, so its one
    downgrade is the one both share: a v1 request with a gather
    materializes ``A[row_index]`` (no v1 kernel fuses the gather);
  * ``vmem_bytes`` (the reference's) against ``smem_bytes``, ``groups``,
    ``row_splits`` and ``route`` (the port's): each package's launch
    geometry;
  * ``device`` (the port's only) and ``impl_requested`` (renamed).
"""
import json
import os

import pytest

from repro_torch.core.blockperm import make_plan
from repro_torch.distributed import plan_for_mesh
from repro_torch.kernels import lowering, tune

DATA = os.path.join(os.path.dirname(__file__), "data")
SNAPSHOT = os.path.join(DATA, "torch_lowering_snapshot.json")
REFERENCE = os.path.join(DATA, "lowering_snapshot.json")

# the reference's impl names -> the port's
IMPL = {"auto": "auto", "pallas": "cuda", "pallas_v1": "cuda_v1",
        "xla": "torch"}
# the card's name in the tuner's backend tag while the grid is lowered
CARD = "NVIDIA H100 80GB HBM3"
SHARED = ("pad_rows", "n_eff", "n_loc", "batch_loc", "shard")


def _plans():
    """The reference test's seven plans, built by the port."""
    return {
        "pinned": make_plan(256, 64, kappa=2, s=2, block_rows=8, seed=4),
        "big": make_plan(65_536, 1024, kappa=4, s=2, block_rows=256),
        "mesh": plan_for_mesh(4096, 1024, 4, kappa=2),
        "mesh_shrink": plan_for_mesh(65_536, 1024, 8, kappa=4),
        "mesh_big": plan_for_mesh(262_144, 1024, 8, kappa=2),
        "count": make_plan(256, 64, s=1, block_rows=8, seed=4,
                           family="countsketch"),
        "graph": make_plan(256, 64, s=4, block_rows=8, seed=4,
                           family="graph"),
    }


def _reference_cases():
    with open(REFERENCE) as f:
        return json.load(f)


def _port_spec(ref_spec):
    spec = dict(ref_spec, device="cuda")
    spec["impl"] = IMPL[ref_spec["impl"]]
    return spec


@pytest.fixture(scope="module")
def lowered():
    """(reference record, port record) for every case of the grid."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tune, "_cuda_name", lambda: CARD)
    tune.clear_cache()
    lowering.clear_lowering_cache()
    plans = _plans()
    out = []
    try:
        for ref in _reference_cases():
            spec = _port_spec(ref["spec"])
            lw = lowering.lower(plans[ref["plan"]],
                                lowering.LaunchSpec(**spec))
            out.append((ref, {"plan": ref["plan"], "spec": spec,
                              "lowering": lw.to_json()}))
    finally:
        lowering.clear_lowering_cache()
        mp.undo()
    return out


def test_lowering_snapshot_matches_golden(lowered):
    got = json.loads(json.dumps([g for _, g in lowered], sort_keys=True))
    if os.environ.get("REGEN_TORCH_LOWERING_SNAPSHOT"):
        with open(SNAPSHOT, "w") as f:
            json.dump(got, f, indent=1, sort_keys=True)
        pytest.skip("snapshot regenerated: review the diff and commit")
    with open(SNAPSHOT) as f:
        want = json.load(f)
    assert len(got) == len(want) == 409, (
        f"grid size changed: {len(got)} cases against {len(want)}; "
        f"regenerate with REGEN_TORCH_LOWERING_SNAPSHOT=1")
    want_by_key = {(w["plan"], json.dumps(w["spec"], sort_keys=True)): w
                   for w in want}
    for g in got:
        key = (g["plan"], json.dumps(g["spec"], sort_keys=True))
        assert key in want_by_key, f"new grid case {key} not in the golden"
        assert g["lowering"] == want_by_key[key]["lowering"], (
            f"dispatch changed for {key}:\n"
            f"  was: {want_by_key[key]['lowering']}\n"
            f"  now: {g['lowering']}\n"
            f"If intended, regenerate with REGEN_TORCH_LOWERING_SNAPSHOT=1.")


def test_shared_fields_match_reference_snapshot(lowered):
    assert len(lowered) == 409
    for ref, got in lowered:
        want, lw = ref["lowering"], got["lowering"]
        case = (ref["plan"], ref["spec"])
        assert lw["plan"] == want["plan"], case
        for field in SHARED:
            assert lw[field] == want[field], (field, case)
        assert want["pad_cols"] == 0, case
        assert lw["op"] == want["op"] and lw["n"] == want["n"], case
        assert lw["batch"] == want["batch"], case
        assert lw["devices"] == want["devices"], case
        assert lw["gather"] == want["gather"], case
        assert lw["dtype"] == want["dtype"], case
        assert lw["impl_requested"] == IMPL[want["impl_requested"]], case
        assert lw["device"] == "cuda", case
