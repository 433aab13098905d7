"""The bf16-tail farm's benchmark cell, ``farm60bf16.dev2``, held to its own
limit on a tiny farm on the CPU through the benchmark's harness
(``portbench.harness.run``): block 16, 3000 taps (tail block 256), 8 voices,
bf16 tail storage, the cells' traffic at two-period calls.

* the program reads ``correct`` under the cell's ``out_err`` limit;
* its control, the same farm with the tail table rounded to float8 e4m3
  once built (``control_farm_fp8.fp8_table``), reads not ``correct``;
* with ``morph8``'s traffic (an ``update_voices`` before every call) and a
  ``reset`` of a farm that had streamed other audio first, the program
  still reads ``correct`` under that limit and ``morph8``'s transient bound;
  that run keeps every call of a 0.1 s window for the check, so the first
  calls, which the other audio would reach through a ``reset`` that left
  it, are compared.

The readings at the cell's own size are the card's (``PERF.md``).
"""

import copy

import pytest
import torch

from control_farm_fp8 import fp8_table
from fft_convolution_tpu_torch import ReverbFarm
from portbench import harness

CELL = "farm60bf16.dev2"
FARM = {"name": "tiny_farm_bf16", "engine": "reverb_farm", "sample_rate": 48000, "voices": 8,
        "block_size": 16, "ir_seconds": 3000 / 48000, "ir_scale": 0.02,
        "tail_dtype": "bfloat16", "tail_block": 256, "tail_segments": 16}
SEEDS = (2**31 + 1, 2**33 + 7, 12345)
# traffic, fp8-rounded table, reset before the first call, correct
CASES = {"program": ("dev2", False, False, True),
         "fp8_control": ("dev2", True, False, False),
         "morph_and_reset": ("morph8", False, True, True)}


def _traffic(name: str, keep_all: bool) -> dict:
    """The cell's traffic file at two-period calls and two updates a call;
    ``keep_all``: every call of a short window kept for the check."""
    t = copy.deepcopy(harness.load_json("traffic", name))
    if keep_all:
        t["check_calls"] = 1000
    t["periods_per_call"] = 2
    if t.get("updates_per_call"):
        t["updates_per_call"] = 2
    t["trace_seconds"] = 0.3
    return t


def _reset_after_other_audio(monkeypatch):
    """Each farm streams a call of other audio right after it is built and
    is then ``reset``: the run starts from the reset state, which the
    reference takes as silence before the first call."""
    init = ReverbFarm.__init__

    def built(self, *args, **kwargs):
        init(self, *args, **kwargs)
        g = torch.Generator().manual_seed(7)
        self.process(torch.randn((2 * self.period, self.voices, self.block_size), generator=g))
        self.reset()

    monkeypatch.setattr(ReverbFarm, "__init__", built)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", CASES)
def test_bf16_farm_against_the_cells_limit(monkeypatch, case, seed):
    traffic, fp8, reset, correct = CASES[case]
    limits = harness.limits_for(CELL)
    if traffic == "morph8":
        limits["transient_peak"] = harness.limits_for("farm60.morph8")["transient_peak"]
    if reset:
        _reset_after_other_audio(monkeypatch)

    def run():
        return harness.run(copy.deepcopy(FARM), _traffic(traffic, reset), seed,
                           0.1 if reset else 0.3, False, "cpu", [], [], limits,
                           log=lambda *a, **k: None)

    if fp8:
        with fp8_table():
            r = run()
    else:
        r = run()
    compared = r["compared"]
    assert r["correct"] == correct, compared
    assert set(compared) == set(limits), compared
    if not correct:  # the control is caught by out_err itself, by a margin
        assert compared["out_err"]["value"] > 2 * compared["out_err"]["limit"], compared
