"""``examples/torch_quickstart.py`` against ``examples/quickstart.py`` on the
CPU, and every example twin's refusal to run without a card.

The reference is loaded from ``examples/quickstart.py`` as it stands and run
beside the twin's ``main(["--device", "cpu"])``.  The lines are compared
label by label; the Gram relative errors, which the lines round to four
places, are the twin's ``main``'s return and, on the reference's side, a
recorder around ``coherence.gram_rel_error``.

Tolerances: ``plan.describe()`` and the shapes equal; every Gram relative
error (the plan's and the four families') within 1e-4 relative of the
reference's: blockperm, srht and blockrow build the reference's S bit for
bit, and dense_gaussian, whose S the twin draws from a ``torch.Generator``,
is carried across from the reference (``from_reference``, through the twin's
``make_sketch``).  The twin's own dense_gaussian draw is held only to a
finite error below 1.  The twin prints each family's bound on the card
(positive, labelled with ``roofline/hw.py``'s SKU) where the reference
prints a time modeled for its own accelerator.

No card, no fallback: each of the five twins' default ``--device cuda``
raises without a card instead of running on the CPU.  And each twin loads
with the top-level names ``jax`` and ``repro`` blocked.
"""
import math
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_examples_common import (ROOT, TWINS, carry_dense, load_example,
                                   one_thread, record, rel, run)
from repro_torch.core import variants as tvariants

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

FAMILIES = ["blockperm", "dense_gaussian", "srht", "blockrow"]


def test_quickstart_matches_reference(capsys, monkeypatch):
    ref, twin = load_example("quickstart"), load_example("torch_quickstart")
    carry_dense(monkeypatch, ref, twin)
    ref_errs = record(monkeypatch, ref.coherence, "gram_rel_error")
    want, _ = run(capsys, ref.main)
    got, errs = run(capsys, twin.main, ["--device", "cpu"])

    assert len(got) == len(want) == 8
    assert got[0] == want[0]                         # plan.describe()
    assert got[1] == want[1] == "Y = SA: (1024, 256)"
    assert got[2].split(":")[0] == want[2].split(":")[0] == "Gram rel-error"
    assert got[3] == want[3] == "SᵀY: (8192, 256)"
    assert [ln.split()[0] for ln in want[4:]] == FAMILIES
    assert [ln.split()[0] for ln in got[4:]] == FAMILIES
    for ln in got[4:]:
        m = re.search(r"gram_rel=[0-9.]+ bound_us=([0-9.]+) \((.*)\)$", ln)
        assert m and float(m.group(1)) > 0, ln
        assert m.group(2) == twin.hw.SKU
    # the plan's error, then the four families'
    assert len(ref_errs) == 5 and list(errs) == ["plan"] + FAMILIES
    for label, a, b in zip(errs, errs.values(), ref_errs):
        assert rel(a, b) <= 1e-4, (label, a, b)

    # the twin's own dense Gaussian draw
    d, n, k = 8192, 256, 1024
    A = np.random.default_rng(0).normal(size=(d, n)).astype(np.float32)
    own = tvariants.make_sketch("dense_gaussian", d, k, seed=1)
    err = twin.coherence.gram_rel_error(
        A, own.apply(torch.from_numpy(A)).numpy())
    assert math.isfinite(err) and err < 1.0


@pytest.mark.parametrize("name", TWINS)
def test_twin_needs_a_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = load_example(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.main([])


def test_twins_import_neither_jax_nor_reference():
    script = textwrap.dedent(f"""
        import importlib.util, sys
        BLOCKED = ("jax", "jaxlib", "repro")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path[:0] = [{os.path.join(ROOT, "src")!r}, {ROOT!r}]
        for name in {TWINS!r}:
            spec = importlib.util.spec_from_file_location(
                name, {ROOT!r} + "/examples/" + name + ".py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
