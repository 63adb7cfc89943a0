"""``examples/torch_least_squares.py`` against ``examples/least_squares.py``
on the CPU.

The reference is loaded from ``examples/least_squares.py`` as it stands and
run beside the twin's ``main(["--device", "cpu"])``; the solve lines are
compared label by label, their numbers parsed from the lines.

Both sides run at d = 1 024 through each module's ``make_problem`` (the
reference's ``main()`` at its own d = 4 096 costs 16.5 s on the CPU).

Tolerances: every iteration count within 1 of the reference's, the
multisketch restarts equal, every relres within its tolerance on both sides
(1e-5; the direct preset 1e-2), the example's own asserts holding on both.
The counts are not held equal: a solve stops inside a restarted LSQR chunk
where the fp32 recurrence estimate crosses ``tol``, and that estimate's
rounding follows the reduction order (the twin alone moves by one between 1
and 4 torch threads; at d = 4 096 the bf16 line's first chunk stops at 35 in
the twin and runs all 50 in the reference, with exact residuals of 1.44e-5
and 1.39e-5 after it).

At d = 4 096 the bf16 line takes 36 iterations in the twin and 51 in the
reference; ``test_least_squares_bf16_gap_is_the_recurrence`` holds that the
gap is the fp32 recurrence's and not the sketch's: SA and R within 1e-5 of
the reference's (relative to their largest entry), each side's count the
same with the other side's R, and both recurrence estimates flattening
within 25 % of tol, on either side of it.
"""
import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_examples_common import load_example, one_thread, run

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

LS_LINE = re.compile(r"^(.*?):\s+(\d+) iters, relres ([0-9.e+-]+)"
                     r"(?:, restarts (\d+))?")
LS_LABELS = ["unpreconditioned LSQR", "precond kappa=4  float32",
             "precond kappa=4 bfloat16", "precond kappa=1  float32",
             "preset     default", "preset        fast",
             "preset      direct", "preset multisketch"]


def parse_ls(lines):
    """(label, iterations, relres, restarts or None) of each solve line."""
    out = []
    for ln in lines:
        m = LS_LINE.match(ln)
        if m:
            out.append((m.group(1).strip(), int(m.group(2)),
                        float(m.group(3)), m.group(4)))
    return out


def test_least_squares_matches_reference(capsys, monkeypatch):
    ref = load_example("least_squares")
    twin = load_example("torch_least_squares")
    for mod in (ref, twin):
        monkeypatch.setattr(mod, "make_problem",
                            functools.partial(mod.make_problem, d=1024))
    want, _ = run(capsys, ref.main)
    got, _ = run(capsys, twin.main, ["--device", "cpu"])

    assert got[0] == want[0] == ("problem: A (1024, 64), cond 1e4, "
                                 "consistent rhs; tol 1e-5")
    assert got[-1] == want[-1] == "ok"
    rows_w, rows_g = parse_ls(want), parse_ls(got)
    assert [r[0] for r in rows_w] == [r[0] for r in rows_g] == LS_LABELS
    for (label, it_w, res_w, rs_w), (_, it_g, res_g, rs_g) in zip(rows_w,
                                                                 rows_g):
        assert abs(it_g - it_w) <= 1, (label, it_g, it_w)
        assert rs_g == rs_w, (label, rs_g, rs_w)
        tol = {LS_LABELS[0]: math.inf, LS_LABELS[6]: 1e-2}.get(label, 1e-5)
        assert res_g <= tol and res_w <= tol, (label, res_g, res_w)
    assert rows_g[-1][3] is not None          # multisketch's restarts


def test_least_squares_bf16_gap_is_the_recurrence():
    """The example's bf16 line at its own d = 4 096 (κ = 4, tol 1e-5), the
    reference's and the twin's pieces crossed.  SA and R of the two sides
    agree within 1e-5 of their largest entry (the same bf16 stream, fp32
    sums and QR in another order).  Each side's LSQR takes as many
    iterations with the other side's R as with its own, so R does not set
    the count.  One 50-iteration chunk of each side's fp32 recurrence,
    from x = 0 with tol 0, ends with its estimate of the relative residual
    within 25 % of tol: whether the first chunk stops early (the twin, 36)
    or runs all 50 (the reference, 51) is which side of tol the fp32
    estimate flattens on.  It prints what it compares (``-s``)."""
    from repro.core.blockperm import make_plan as ref_plan
    from repro.kernels import ops as ref_ops
    from repro.solvers import sketch_precondition as ref_sp
    from repro_torch.core.blockperm import make_plan as twin_plan
    from repro_torch.kernels import ops as twin_ops
    from repro_torch.solvers import sketch_precondition as twin_sp

    twin = load_example("torch_least_squares")
    A_np, b_np = twin.make_problem()
    assert A_np.shape == (4096, 64)
    d, n = A_np.shape
    k, tol = ref_sp.default_sketch_rows(n), 1e-5
    A_j, b_j = jnp.asarray(A_np), jnp.asarray(b_np)
    A_t, b_t = torch.from_numpy(A_np), torch.from_numpy(b_np)
    SA_j, R_j = ref_ops.sketch_qr(
        ref_plan(d, k, kappa=4, s=2, seed=0, dtype="bfloat16"), A_j)
    SA_t, R_t = twin_ops.sketch_qr(
        twin_plan(d, k, kappa=4, s=2, seed=0, dtype="bfloat16"), A_t)
    for what, mine, theirs in (("SA", SA_t, SA_j), ("R", R_t, R_j)):
        theirs = np.asarray(theirs)
        err = np.abs(mine.numpy() - theirs).max()
        print(f"{what}: max abs difference {err:.3e}, largest entry "
              f"{np.abs(theirs).max():.3e}")
        assert err <= 1e-5 * np.abs(theirs).max()

    iters = {}
    for side, R in (("reference R", np.asarray(R_j)),
                    ("twin R", R_t.numpy())):
        iters["reference", side] = ref_sp.lsqr(
            A_j, b_j, R=jnp.asarray(R), tol=tol, max_iters=200).iterations
        iters["twin", side] = twin_sp.lsqr(
            A_t, b_t, R=torch.tensor(R), tol=tol,
            max_iters=200).iterations
    print(f"iterations (solver, R): {iters}")
    assert iters["reference", "reference R"] == iters["reference", "twin R"]
    assert iters["twin", "reference R"] == iters["twin", "twin R"]

    _, _, est_j = ref_sp._lsqr_jit(A_j, b_j, R_j, None, tol=0.0,
                                   max_iters=50, has_R=True)
    mv, rmv, unprec = twin_sp._right_precond_ops(A_t, R_t)
    _, _, est_t = twin_sp._lsqr_recurrence(mv, rmv, unprec, None, b_t, None,
                                           n, tol=0.0, max_iters=50)
    print(f"estimate after 50 iterations: reference {float(est_j):.3e}, "
          f"twin {float(est_t):.3e} (tol {tol:g})")
    for est in (float(est_j), float(est_t)):
        assert 0.8 * tol <= est <= 1.25 * tol, (float(est_j), float(est_t))
