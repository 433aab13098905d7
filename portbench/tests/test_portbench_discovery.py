"""Files are found by name: a configuration, a traffic mix and metrics
dropped into a copy of the harness's folders are taken without editing a
file that is there; every name BENCHMARK.json uses has its file."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness

import pb_tiny

BENCH = json.loads(harness.BENCHMARK.read_text())


def test_every_name_in_the_benchmark_has_its_file():
    for c in BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (harness.ROOT.parent / c["file"]).exists()
    for w in BENCH["workloads"]:
        t = harness.load_json("traffic", w["traffic"])
        assert t["engine"] == harness.load_json("configs", w["config"])["engine"]
        assert (harness.ROOT / "limits" / f"{w['name']}.json").exists()
        assert (harness.ROOT / "engines" / f"{t['engine']}.py").exists()
    for m in BENCH["end_to_end"]:
        assert callable(harness.load_module("end_to_end", m["name"]).read)
    for m in BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e, layers = harness.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layers
        assert all(m["moves"] in names for m in layers)


def test_dropped_in_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(pb_tiny.FARM, name="tiny_farm_new")
    (root / "configs" / "tiny_farm_new.json").write_text(json.dumps(cfg))
    t = dict(pb_tiny.traffic("dev8"), name="dev1_new", periods_per_call=1)
    (root / "traffic" / "dev1_new.json").write_text(json.dumps(t))
    (root / "metrics" / "calls_traced.new.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    (root / "end_to_end" / "calls_done.py").write_text(
        "def read(w):\n    return float(w.calls)\n")
    monkeypatch.setattr(harness, "ROOT", root)
    bench = {"workloads": [{"name": "tiny.new", "config": "tiny_farm_new",
                            "traffic": "dev1_new", "chips": 1}],
             "end_to_end": [{"name": "calls_done", "unit": "calls", "workloads": ["tiny.new"]},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "calls_traced.new", "unit": "calls",
                            "workloads": ["tiny.new"]}]}
    e2e, layers = harness.cell_metrics(bench, "tiny.new")
    config = harness.load_json("configs", "tiny_farm_new")
    traffic = harness.load_json("traffic", "dev1_new")
    quiet = {"log": lambda *a, **k: None}
    r = harness.run(config, traffic, 5, 0.2, False, "cpu", e2e, layers, {"out_err": 1e-5}, **quiet)
    assert r["correct"] and r["metrics"]["calls_done"]["value"] == r["attempted"] > 0
    assert set(r["metrics"]) == {"calls_done", "setup_s"}
    r = harness.run(config, traffic, 5, 0.2, True, "cpu", e2e, layers, {"out_err": 1e-5}, **quiet)
    assert r["metrics"]["calls_traced.new"]["value"] == r["attempted"]


def test_run_without_a_card_prints_no_result(tmp_path):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "farm60.dev8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.BENCHMARK, tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "farm60.dev8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and not out.stdout.strip()
