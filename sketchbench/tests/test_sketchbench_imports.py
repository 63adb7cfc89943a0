"""No run loads JAX or the JAX package ``repro`` (top-level names compared
whole, so ``repro_torch`` passes); nothing of the harness reads
``benchmarks/`` or ``chip_smoke.py``; the command fails with no card, and
in a directory that holds only the benchmark."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sketchbench import harness

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.kernels", object())
    assert harness.forbidden_modules() == ["repro.kernels"]


def test_harness_sources_import_nothing_banned():
    for path in (ROOT / "sketchbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not BANNED & set(tops), (path, tops)
        assert "chip_smoke" not in path.read_text()


def test_a_cpu_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from sketchbench import harness\n"
        "for w, over in [('paper_lsq.sketch', dict(d=2048, n=16, k=512)),\n"
        "                ('paper_lsq.solve', dict(d=2048, n=16)),\n"
        "                ('grass_mlp.cache', dict(train_examples=256))]:\n"
        "    harness.execute(w, 5, 0.1, False, device='cpu',\n"
        "                    config_overrides=over,\n"
        "                    traffic_overrides=dict(pool=1, batch=256,\n"
        "                                           chunk=128))\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_command_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "sketchbench/run.py"), "--workload",
         "paper_lsq.sketch", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_bare_benchmark_directory_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sketchbench", tmp_path / "sketchbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "sketchbench/run.py", "--workload",
         "paper_lsq.sketch", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=_env(), cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


_PATCHED_RUN = """
import json, sys, torch
root, src, stub = sys.argv[1:4]
sys.path[:0] = [root, src, stub]
torch.cuda.is_available = lambda: True     # skip the look for a card
torch.cuda.device_count = lambda: 1
from sketchbench import harness
sys.path.insert(0, root + "/sketchbench")
import run
execute = harness.execute
harness.execute = lambda *a, **k: execute(
    *a, **dict(k, device="cpu", config_overrides=dict(d=2048, n=16, k=512),
               traffic_overrides=dict(pool=1)))
sys.exit(run.main(["--workload", "paper_lsq.sketch", "--seed",
                   str(2**31 + 21), "--seconds", "0.2", "--trace", "0"]))
"""


@pytest.mark.parametrize("reader, rc", [("clean", 0), ("imports_repro", 3)])
def test_a_module_loaded_after_the_window_withholds_the_result(
        tmp_path, reader, rc):
    """A metric reader runs after the window and the check; a reader that
    loads a module named ``repro`` leaves the run without a result."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "sketchbench", root / "sketchbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    stub = tmp_path / "stub"
    (stub / "repro").mkdir(parents=True)
    (stub / "repro" / "__init__.py").write_text("")
    if reader == "imports_repro":
        gbps = root / "sketchbench" / "metrics" / "sketch_gbps.py"
        gbps.write_text("import repro  # noqa: F401\n" + gbps.read_text())
    out = subprocess.run(
        [sys.executable, "-c", _PATCHED_RUN, str(root), str(ROOT / "src"),
         str(stub)], capture_output=True, text=True, env=_env(),
        cwd=tmp_path, timeout=600)
    assert out.returncode == rc, out.stderr[-2000:]
    if rc:
        assert out.stdout.strip() == ""
        assert "repro" in out.stderr.splitlines()[-1]
    else:
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] and "sketch_gbps" in result["metrics"]
