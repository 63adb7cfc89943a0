"""The port's dry-run on a fake 2×2×2 mesh (pod, data, model) at
qwen3-0.6b's smoke config, and the import of the dry-run modules bringing
up no process group, on the CPU."""
import os
import subprocess
import sys

import pytest

from test_torch_dryrun_families import smoke_cell

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_qwen3_on_two_pods(tmp_path, kind):
    rec = smoke_cell(tmp_path, "qwen3-0.6b", kind, dims=(2, 2, 2))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 8 and rec["device_coll_bytes"] > 0


def test_import_brings_up_no_process_group():
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.roofline import analysis, hlo_parse\n"
            "assert not dist.is_initialized()\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.stdout.strip() == "clean", out.stderr
