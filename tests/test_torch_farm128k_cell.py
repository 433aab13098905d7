"""The room-reverb farm's benchmark cell, ``farm128k.dev8``, held to its own
limit on a cut farm on the CPU through the benchmark's harness
(``portbench.harness.run``): block 8, 16,000 taps at 44.1 kHz, which gives
tail block 512, n = 64 head segments and 30 big-tail segments padded to
32, the cell's own segment counts; 8 voices; the cell's traffic ``dev8``
(8-period calls) with a short trace.

* the program reads ``correct`` under the cell's ``out_err`` limit;
* its control, the farm's own bf16 tail (``portbench.control``'s control
  for an f32 farm), reads not ``correct``, by a margin;
* the layout the configuration states (``portbench.shapes.two_stage``) is
  the one ``farm2_init`` builds for responses of the configuration's own
  length at its block.

The readings at the cell's own size are the card's (``PERF.md``).
"""

import copy

import pytest
import torch

from fft_convolution_tpu_torch.parallel import farm2
from portbench import harness, shapes

CELL = "farm128k.dev8"
CONFIG = "farm128k_b64_16384v"
FARM = {"name": "tiny_farm128k", "engine": "reverb_farm", "sample_rate": 44100, "voices": 8,
        "block_size": 8, "ir_seconds": 16000 / 44100, "ir_scale": 0.02,
        "tail_dtype": "float32", "tail_block": 512, "tail_segments": 32}
SEEDS = (2**31 + 1, 2**33 + 7, 12345)


def _traffic() -> dict:
    t = copy.deepcopy(harness.load_json("traffic", "dev8"))
    t["trace_seconds"] = 0.3
    return t


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("control", [False, True], ids=["program", "bf16_control"])
def test_cut_farm_against_the_cells_limit(control, seed):
    limits = harness.limits_for(CELL)
    r = harness.run(copy.deepcopy(FARM), _traffic(), seed, 0.3, False, "cpu", [], [], limits,
                    control=control, log=lambda *a, **k: None)
    compared = r["compared"]
    assert set(compared) == set(limits) == {"out_err"}, compared
    assert r["correct"] != control, compared
    if control:  # the control is caught by out_err itself, by a margin
        assert compared["out_err"]["value"] > 3 * compared["out_err"]["limit"], compared


def test_cut_farm_keeps_the_cells_segment_counts():
    cut, real = shapes.two_stage(FARM), shapes.two_stage(harness.load_json("configs", CONFIG))
    assert cut.period == real.period == 64
    assert cut.tail.seg_count == real.tail.seg_count == 32


def test_stated_layout_is_what_farm2_init_builds():
    config = harness.load_json("configs", CONFIG)
    taps = shapes.ir_len(config)
    assert taps == 128_000
    irs = torch.randn((2, taps), generator=torch.Generator().manual_seed(5)) * 0.002
    cfg, _ = farm2.farm2_init(irs, config["block_size"], taps, device="cpu")
    shapes.check_program(config, cfg)  # raises where the program builds another layout
    assert (cfg.tail_block, cfg.period, cfg.head.seg_count, cfg.tail.seg_count) == (
        4096, 64, 64, 32)
