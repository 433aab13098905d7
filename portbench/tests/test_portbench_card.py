"""One short run of each cell on the card, through the benchmark's command.
Marked ``cuda``: skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = json.loads(harness.BENCHMARK.read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "987654321987", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
    assert set(r["metrics"]) == {m["name"] for m in harness.cell_metrics(BENCH, cell)[0]}
