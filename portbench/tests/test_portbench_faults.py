"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size (``pb_tiny``), with the cell's own limit, the
program unbroken or broken in one way:

* a call that leaves the state unchanged (the farm); a ``reset`` that does
  nothing, so a track starts from the last one's state (the render);
* half of the batch left out: the outputs of half the voices, or the second
  half of a track, zero;
* an answer altered where it is produced: one output sample moved, or
  made NaN; in the morphing mix also inside the transient after an update,
  where the exact comparison does not reach and the transient's bound has
  to catch it.

No cell runs across chips, so no exchange between chips can be left out.
"""

import pytest
import torch

from fft_convolution_tpu_torch import ReverbFarm, TwoStageFFTConvolver
from portbench import harness

import pb_tiny

FARM_CELLS = ("farm60.dev8", "farm60.dev2", "farm60.morph8")


def _limits(cell: str) -> dict:
    return harness.limits_for(cell)


def _traffic(cell: str) -> str:
    return pb_tiny.traffic_of(cell)


def _farm_fault(kind):
    process = ReverbFarm.process

    def broken(self, blocks):
        if kind == "state":
            saved = self.state
            self.state = saved.clone()
            y = process(self, blocks)
            self.state = saved
            return y
        y = process(self, blocks)
        if kind == "half":
            y[:, y.shape[1] // 2:] = 0.0
        elif kind == "nan":
            y[0, 3, 5] = float("nan")
        else:
            y[0, 3, 5] += 1.0
        return y

    return broken


def _render_fault(kind):
    process = TwoStageFFTConvolver.process

    def broken(self, x):
        y = process(self, x)
        if kind == "half":
            y[y.shape[0] // 2:] = 0.0
        elif kind == "nan":
            y[1000] = float("nan")
        else:
            y[1000] += 1.0
        return y

    return broken


@pytest.mark.parametrize("cell", FARM_CELLS + ("hall10.render",))
def test_unbroken_program_is_correct(cell):
    r = pb_tiny.run(_traffic(cell), _limits(cell))
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("kind", ["state", "half", "altered", "nan"])
@pytest.mark.parametrize("cell", FARM_CELLS)
def test_broken_farm_is_not_correct(monkeypatch, cell, kind):
    monkeypatch.setattr(ReverbFarm, "process", _farm_fault(kind))
    r = pb_tiny.run(_traffic(cell), _limits(cell))
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("kind", ["state", "half", "altered", "nan"])
def test_broken_render_is_not_correct(monkeypatch, kind):
    if kind == "state":
        monkeypatch.setattr(TwoStageFFTConvolver, "reset", lambda self: None)
    else:
        monkeypatch.setattr(TwoStageFFTConvolver, "process", _render_fault(kind))
    r = pb_tiny.run(_traffic("hall10.render"), _limits("hall10.render"))
    assert not r["correct"], r["compared"]


def test_morph_update_left_out_is_not_correct(monkeypatch):
    monkeypatch.setattr(ReverbFarm, "update_voices", lambda self, idx, irs: None)
    r = pb_tiny.run(_traffic("farm60.morph8"), _limits("farm60.morph8"))
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("kind", ["nan", "click"])
def test_fault_in_the_switch_is_not_correct(monkeypatch, kind):
    update, process = ReverbFarm.update_voices, ReverbFarm.process

    def updated(self, idx, irs):
        self.switched = int(idx[0])
        return update(self, idx, irs)

    def broken(self, blocks):
        y = process(self, blocks)
        v = getattr(self, "switched", None)
        if v is not None:  # block 1 of the call right after the update
            y[1, v, 3] = float("nan") if kind == "nan" else y[1, v, 3] + 10 * y.abs().max()
        return y

    monkeypatch.setattr(ReverbFarm, "update_voices", updated)
    monkeypatch.setattr(ReverbFarm, "process", broken)
    limits = _limits("farm60.morph8")
    r = pb_tiny.run(_traffic("farm60.morph8"), limits)
    assert not r["correct"], r["compared"]
    # the exact comparison does not reach the transient: its bound caught it
    assert r["compared"]["out_err"]["value"] <= limits["out_err"], r["compared"]


def test_a_missing_limit_is_not_correct():
    r = pb_tiny.run("dev8", {})
    assert not r["correct"]
    assert torch.isfinite(torch.tensor(r["compared"]["out_err"]["value"]))
