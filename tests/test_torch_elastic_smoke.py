"""``chip_smoke.py`` phase 16 on the CPU at the smoke config: the
supervisor restarting the Trainer from a (2, 2) mesh of gloo ranks onto
(1, 2) from its checkpoint of DTensor state, and compressed from (2, 1)
onto (1, 1).  The phase's own checks hold here as on the card (the report,
the restored state bit-equal to the saved one, the losses within 2⁻⁸ of
one device's and equal across ranks); those of the card alone (launches,
no plain version, the time budget) are skipped on the CPU by the phase
itself."""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def test_phase_16_on_the_cpu(capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = cs.phase_elastic(cs.load_runtime(), "cpu", True)
    finally:
        torch.set_num_threads(threads)
    assert set(launches) == set(cs.NARROW_KERNELS)
    out = capsys.readouterr().out
    assert "(a) steps_done 4, restarts 1, meshes [(2, 2), (1, 2)]" in out
    assert "(b) steps_done 4, restarts 1, meshes [(2, 1), (1, 1)]" in out
