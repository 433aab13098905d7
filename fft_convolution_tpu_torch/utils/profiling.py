"""Tracing and observability — counterpart of
``fft_convolution_tpu/utils/profiling.py``.

The reference's only instrumentation is wall-clock ``Instant`` timing in the
example (``examples/compare_partitioned.rs:28,36-53``).  Here:

* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace of the region (open it in Perfetto or ``chrome://tracing``);
* :func:`annotate` — the port's one span primitive: a named span
  (``torch.profiler.record_function``) that shows up inside the trace, nested
  under the span open around it, and costs one flag check when no profiler
  runs;
* :class:`LatencyRecorder` — streaming per-block latency percentiles for
  real-time serving dashboards (p50/p95/p99 + xRT).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region (host activity, and the card's kernels
    where CUDA is available) and write it to ``logdir/trace.json`` as a
    Chrome trace.  Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


_NO_SPAN = contextlib.nullcontext()  # reusable: it holds no state


def annotate(name: str):
    """A named span, ``with annotate("fftconv.farm.process"): ...``.  Under
    ``torch.profiler`` it is ``record_function(name)``: a host event on the
    profiler's clock, the same clock as the card's kernels, so a kernel is
    put down to the span around its launch.  With no profiler running it
    creates no ``RecordFunction`` and returns one shared null context, after
    one flag check, so spans may sit on the hot path."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@dataclass
class LatencyRecorder:
    """Accumulates per-block wall latencies; reports serving percentiles."""

    block_size: int
    sample_rate: float
    samples_s: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples_s.append(time.perf_counter() - t0)

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.samples_s), q) * 1e3)

    def report(self) -> dict:
        block_s = self.block_size / self.sample_rate
        arr = np.asarray(self.samples_s)
        return {
            "n_blocks": len(arr),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "xrt_median": block_s / float(np.median(arr)),
            "deadline_misses": int(np.sum(arr > block_s)),
        }
