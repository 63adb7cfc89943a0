"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and BENCHMARK.json entries, with no file of the harness
edited; and the harness reads BENCHMARK.json as the contract shapes it."""
import json
import re
import shutil
from pathlib import Path

from sketchbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy_checkout(tmp: Path) -> Path:
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "sketchbench", root / "sketchbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    return root


def test_new_cell_config_traffic_and_metric_from_files_alone(tmp_path):
    root = _copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "sketchbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "sketchbench/configs/paper_lsq.json")
                     .read_text())
    cfg.update(name="tiny_lsq", d=2048, n=32, k=512)
    (root / "sketchbench/configs/tiny_lsq.json").write_text(json.dumps(cfg))
    (root / "sketchbench/traffic/sketch_burst.json").write_text(json.dumps(
        {"entry": "sketch_apply", "pool": 3,
         "sync_every": 5, "sample": 1}))
    (root / "sketchbench/metrics/calls_per_s.tiny.py").write_text(
        "def read(run):\n"
        "    return len(run.ops) / run.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_lsq", "source": "a test",
                             "file": "sketchbench/configs/tiny_lsq.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_lsq.burst", "config": "tiny_lsq",
                               "traffic": "sketch_burst", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_per_s.tiny", "unit": "calls/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "wrappers", "moves": "sketch_gbps",
                               "workloads": ["tiny_lsq.burst"]})
    for m in bench["end_to_end"]:
        if m["name"] == "sketch_gbps":
            m["workloads"].append("tiny_lsq.burst")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = harness.execute("tiny_lsq.burst", 12, 0.2, False, device="cpu",
                            root=root)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"sketch_gbps", "setup_s"}
    traced = harness.execute("tiny_lsq.burst", 12, 0.2, True, device="cpu",
                             root=root)
    assert traced["correct"]
    assert traced["metrics"]["calls_per_s.tiny"]["value"] > 0
    assert traced["attempted"] % 5 == 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [*e2e, *cells, *(m["name"] for m in bench["per_layer"]),
             *(c["name"] for c in bench["configs"])]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "sketchbench/metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("sketchbench/")
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "sketchbench/traffic" / f"{w['traffic']}.json"
                ).is_file()
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
