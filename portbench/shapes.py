"""The shapes the yardstick costs, read from a configuration file.

:mod:`portbench.metrics.roofline` reads config attributes
(``head_block``, ``tail_block``, ``period``, ``head``/``tail0``/``tail``
with ``seg_count`` and ``block_size``).  These come from the
configuration's stated layout, not from the program; the engines check
that the program built the same one (:func:`check_program`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Stage:
    seg_count: int
    block_size: int


@dataclasses.dataclass(frozen=True)
class TwoStage:
    head_block: int
    tail_block: int
    head: Stage
    tail0: Stage | None
    tail: Stage | None

    @property
    def period(self) -> int:
        return self.tail_block // self.head_block


def ir_len(config: dict) -> int:
    """Taps of each response: ``ir_seconds`` at ``sample_rate``."""
    return int(round(config["ir_seconds"] * config["sample_rate"]))


def two_stage(config: dict) -> TwoStage:
    """The two-stage layout a configuration states: head and tail0 of
    ``tail_block / block_size`` segments at the head block, the big tail of
    ``tail_segments`` segments at the tail block."""
    b, tb = config["block_size"], config["tail_block"]
    taps = ir_len(config)
    n = tb // b
    tail0 = Stage(n, b) if taps > tb else None
    tail = Stage(config["tail_segments"], tb) if taps > 2 * tb else None
    return TwoStage(b, tb, Stage(n, b), tail0, tail)


def check_program(config: dict, cfg) -> None:
    """Raise ``RuntimeError`` where the program's two-stage config ``cfg``
    departs from the layout the configuration states."""
    want = two_stage(config)

    def seg(stage):
        return None if stage is None else (stage.seg_count, stage.block_size)

    got = (cfg.head_block, cfg.tail_block, seg(cfg.head), seg(cfg.tail0), seg(cfg.tail))
    stated = (want.head_block, want.tail_block, seg(want.head), seg(want.tail0),
              seg(want.tail))
    if got != stated:
        raise RuntimeError(f"the program built (head block, tail block, head, tail0, tail) = "
                           f"{got}; the configuration {config['name']} states {stated}")
