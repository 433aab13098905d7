"""Tiny cells for the harness's CPU tests: the real traffic files with a
two-period call and a small configuration of each engine (block 16, 3000
taps: tail block 256, all three stages present)."""

import copy
import json

from portbench import harness

# cells whose files the harness keeps but BENCHMARK.json does not list (too
# noisy across hosts to hold to a bound; PERF.md, Open questions): cell ->
# traffic
UNLISTED = {"hall10.render": "render"}

FARM = {"name": "tiny_farm", "engine": "reverb_farm", "sample_rate": 48000, "voices": 8,
        "block_size": 16, "ir_seconds": 3000 / 48000, "ir_scale": 0.02,
        "tail_dtype": "float32", "tail_block": 256, "tail_segments": 16}
HALL = {"name": "tiny_hall", "engine": "two_stage", "sample_rate": 48000, "voices": 1,
        "block_size": 16, "ir_seconds": 3000 / 48000, "ir_scale": 0.02, "tail_block": 256,
        "tail_segments": 10}


def traffic_of(cell: str) -> str:
    """The traffic name of ``cell``, listed in BENCHMARK.json or kept apart."""
    bench = json.loads(harness.BENCHMARK.read_text())
    if cell in UNLISTED and all(w["name"] != cell for w in bench["workloads"]):
        return UNLISTED[cell]
    return harness.workload(bench, cell)["traffic"]


def traffic(name: str) -> dict:
    t = copy.deepcopy(harness.load_json("traffic", name))
    if t["engine"] == "reverb_farm":
        t["periods_per_call"] = 2
        if t.get("updates_per_call"):
            t["updates_per_call"] = 2
    else:
        t["periods_per_call"] = 64
        t["trace_host"] = True
    t["trace_seconds"] = 0.3
    return t


def config(engine: str) -> dict:
    return copy.deepcopy(FARM if engine == "reverb_farm" else HALL)


def run(name: str, limits: dict, seconds: float = 0.3, seed: int = 2**31 + 11, **kw) -> dict:
    """A run of traffic ``name`` on its tiny configuration, on the CPU, held
    to ``limits`` (``{compared name: limit}``)."""
    t = traffic(name)
    return harness.run(config(t["engine"]), t, seed, seconds, False, "cpu", [], [],
                       limits, log=lambda *a, **k: None, **kw)
