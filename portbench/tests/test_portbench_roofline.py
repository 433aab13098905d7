"""The frozen yardstick reproduces the counts it was frozen with."""

import json
from pathlib import Path

import pytest

from portbench import shapes
from portbench.metrics import roofline as rl

ROOT = Path(__file__).resolve().parents[1]


def _config(name):
    return shapes.two_stage(json.loads((ROOT / "configs" / f"{name}.json").read_text()))


def _us(cost):
    return rl.bound(cost, rl.H100_SXM)["bound_us"]


def test_pinned_farm_counts():
    cfg = _config("farm60_f32_1024v")
    assert (cfg.head.seg_count, cfg.tail.seg_count, cfg.period) == (256, 88, 256)
    # B6 at config 5, 128 voices, 8 periods; B5 at T = 8 and 128 voices
    assert _us(rl.farm_heads_cost(cfg, 128, 8 * 256)) == pytest.approx(147.07, abs=0.005)
    assert _us(rl.farm_tail_step_cost(cfg, 128, 8)) == pytest.approx(2013.3, abs=0.05)
    assert rl.bound(rl.farm_tail_step_cost(cfg, 128, 8), rl.H100_SXM)["bound_by"] == "bytes"


def test_farm_cost_is_heads_plus_tail_and_linear_in_voices():
    cfg = _config("farm60_f32_1024v")
    none = rl.farm_cost(cfg, 0, 2048)  # the tail's twiddles, read once a call
    one, many = rl.farm_cost(cfg, 128, 2048), rl.farm_cost(cfg, 1024, 2048)
    assert many.bytes - none.bytes == pytest.approx(8 * (one.bytes - none.bytes), rel=1e-9)
    assert rl.farm_cost(cfg, 1024, 2048).bytes > rl.farm_tail_step_cost(cfg, 1024, 8).bytes


def test_render_bound():
    cfg = _config("hall10_b128")
    assert (cfg.head.seg_count, cfg.tail.seg_count, cfg.period) == (64, 57, 64)
    assert _us(rl.two_stage_stream_cost(cfg, 65536)) == pytest.approx(72.31, abs=0.01)
    assert _us(rl.two_stage_stream_cost(cfg, 3968)) == pytest.approx(4.776, abs=0.001)


def test_peaks_refuse_a_cpu_device():
    with pytest.raises(ValueError):
        rl.peaks("cpu")
