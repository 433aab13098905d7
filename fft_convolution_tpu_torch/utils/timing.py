"""Timing harness — counterpart of ``fft_convolution_tpu/utils/timing.py``.

The reference's only measurement apparatus is ``std::time::Instant`` around
the block loop (``examples/compare_partitioned.rs:28-53``).  Here are the
real-time metrics the audio world cares about: per-block latency
percentiles and the real-time factor xRT = (block / sample_rate) / t_block.
Work on the card is asynchronous, so every timed region ends in
:func:`block_until_ready`, where the JAX package has
``jax.block_until_ready``; a per-block latency is the host clock around a
synchronised call, which is what a host callback sees.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch


def block_until_ready(out=None):
    """Wait until the card has finished all work queued on it (nothing to
    wait for where CUDA was never used); returns ``out``."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


@dataclasses.dataclass
class BlockTiming:
    wall_s: float          # total wall time for the run
    n_blocks: int
    block_size: int
    sample_rate: float
    per_block_s: Sequence[float] | None = None  # per-call latencies, if measured

    @property
    def xrt(self) -> float:
        """Real-time factor: how many real-time streams one run sustains."""
        audio_s = self.n_blocks * self.block_size / self.sample_rate
        return audio_s / self.wall_s

    def percentile_ms(self, q: float) -> float:
        if self.per_block_s is None:
            raise ValueError("no per-block latencies were measured")
        return float(np.percentile(np.asarray(self.per_block_s), q) * 1e3)


def time_stream(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` after ``warmup`` calls; each call
    is waited for, so the card's time is counted in full."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def time_per_block(step: Callable, state, blocks, warmup: int = 8) -> list[float]:
    """Latency in seconds of each single-block call ``step(state, block) ->
    (state, y)`` over ``blocks`` (the real-time serving path), after
    ``warmup`` calls on the first blocks.  A step that updates the state in
    place advances it during the warm-up too."""
    for i in range(min(warmup, len(blocks))):
        _, y = step(state, blocks[i])
        block_until_ready(y)
    times = []
    for i in range(len(blocks)):
        t0 = time.perf_counter()
        state, y = step(state, blocks[i])
        block_until_ready(y)
        times.append(time.perf_counter() - t0)
    return times
