"""The control, one precision below the configuration's float32, comes
out not correct under each cell's limit; the program comes out correct.
At a tiny size on the CPU: the chip's readings at the cells' own sizes are
in PERF.md, and ``python -m portbench.control`` makes them."""

import pytest

from portbench import harness

import pb_tiny

CELLS = ("farm60.dev8", "farm60.dev2", "farm60.morph8", "hall10.render")


def _traffic(cell):
    return pb_tiny.traffic_of(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_and_the_program_passes(cell):
    limits = harness.limits_for(cell)
    for seed in (2**31 + 1, 2**33 + 7, 12345):
        ctl = pb_tiny.run(_traffic(cell), limits, seed=seed, control=True)
        prog = pb_tiny.run(_traffic(cell), limits, seed=seed)
        assert not ctl["correct"] and prog["correct"], (ctl["compared"], prog["compared"])
        assert ctl["compared"]["out_err"]["value"] > 3 * prog["compared"]["out_err"]["value"]
