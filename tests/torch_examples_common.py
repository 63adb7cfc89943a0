"""Helpers of the example-twin tests (``tests/test_torch_examples_*.py``):
load an example from ``examples/`` as it stands (``chip_smoke.py``'s
loader, which phase 17 runs the twins with), record what a reference's
function returns, capture a ``main``'s lines and return, and carry the
reference's dense Gaussian S across to a twin."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from chip_smoke import load_example  # noqa: E402,F401
from repro_torch.core import variants as tvariants  # noqa: E402

TWINS = ("torch_quickstart", "torch_least_squares", "torch_randnla_tasks",
         "torch_grass_attribution", "torch_train_lm")


def record(monkeypatch, owner, name, stub=None):
    """Wrap ``owner.name`` so each call's return value (``stub``'s, when
    given, instead of a call of the original) is appended to the list
    returned, beside its arguments in ``.calls``."""
    fn = getattr(owner, name)
    seen = Recorded()

    def spy(*args, **kwargs):
        out = (stub or fn)(*args, **kwargs)
        seen.append(out)
        seen.calls.append((args, kwargs))
        return out
    monkeypatch.setattr(owner, name, spy)
    return seen


class Recorded(list):
    def __init__(self):
        super().__init__()
        self.calls = []


def run(capsys, fn, *args):
    """The lines ``fn(*args)`` prints, and what it returns."""
    capsys.readouterr()
    out = fn(*args)
    return capsys.readouterr().out.splitlines(), out


def carry_dense(monkeypatch, ref, twin):
    """The reference's sketches recorded as it makes them; the twin's
    ``make_sketch`` handing out the reference's dense Gaussian S
    (``from_reference``), the other families its own."""
    made = {}
    ref_make = ref.make_sketch

    def ref_spy(fam, *args, **kwargs):
        sk = ref_make(fam, *args, **kwargs)
        made.setdefault(fam, sk)
        return sk

    def twin_make(fam, d, k, seed=0, **kw):
        if fam == "dense_gaussian":
            return tvariants.DenseGaussianSketch.from_reference(
                np.asarray(made[fam]._S), seed=seed)
        return tvariants.make_sketch(fam, d, k, seed=seed, **kw)
    monkeypatch.setattr(ref, "make_sketch", ref_spy)
    monkeypatch.setattr(twin, "make_sketch", twin_make)


def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture
def one_thread():
    """One torch thread: the twins' sums in one order on every host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
