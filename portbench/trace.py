"""The traced window: ``torch.profiler`` over the window, reduced to device
operations, the harness's spans, the device's busy time and its idle gaps.

Each device operation (a kernel, a memcpy or a memset) is tied to the
host call that launched it by the profiler's correlation id, and so to the
innermost ``portbench.*`` span around that launch: the per-layer readers
sum device time by span and by kernel name.  The trace goes through a
temporary file in ``TMPDIR``, deleted once read.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


@dataclasses.dataclass
class Op:
    name: str
    cat: str      # kernel, gpu_memcpy or gpu_memset
    start: float  # microseconds on the trace's clock
    dur: float
    span: str     # the innermost portbench.* span around its launch, or ""


@dataclasses.dataclass
class Trace:
    ops: list[Op]        # device operations inside the window
    spans: dict          # span name -> list of (start, dur), microseconds
    window_s: float
    busy_s: float
    device_ops: list     # [[name, seconds], ...], the ten largest by total time
    idle_gaps: list      # [[host event, seconds], ...], the ten longest

    def device_s(self, span=None, kernels_only: bool = False, match=None) -> float:
        """Device seconds of the ops launched inside ``span`` (a name or a
        tuple of names; any span: None), kernels only if asked, whose names
        pass ``match``.  A trace of the device alone has no spans, and a
        span filter on it raises."""
        return sum(o.dur for o in self._pick(span, kernels_only, match)) / 1e6

    def count(self, span=None, kernels_only: bool = True, match=None) -> int:
        return sum(1 for _ in self._pick(span, kernels_only, match))

    def _pick(self, span, kernels_only, match):
        if isinstance(span, str):
            span = (span,)
        if span is not None and not self.spans:
            raise ValueError(f"a span filter {span} on a trace with no spans (a trace of "
                             "the device alone)")
        for o in self.ops:
            if span is not None and o.span not in span:
                continue
            if kernels_only and o.cat != "kernel":
                continue
            if match is not None and not match(o.name):
                continue
            yield o


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(events: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """The innermost of ``events`` (nested intervals sorted by start) that
    holds time ``t``: of those that hold it, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(events[max(0, i - 256):i]):
        if e >= t:
            return name
    return ""


def reduce(events: list[dict], window_s: float | None = None) -> Trace:
    """A :class:`Trace` from a chrome trace's ``traceEvents``.  Without host
    events (a trace of the device alone) there are no spans: the window is
    the device operations' extent and lasts ``window_s``, the host clock's
    length of it, and every operation's span is ``""``."""
    launch_ts: dict[int, float] = {}
    spans: dict[str, list] = {}
    host: list[tuple[float, float, str]] = []
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in HOST_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch_ts[corr] = ts
            host.append((ts, ts + dur, ev["name"]))
            if cat == "user_annotation" and ev["name"].startswith("portbench."):
                spans.setdefault(ev["name"], []).append((ts, dur))
    if WINDOW in spans:
        w0, wdur = spans[WINDOW][0]
        w1 = w0 + wdur
    elif window_s is not None and device:
        w0 = min(float(ev["ts"]) for ev in device)
        w1 = max(float(ev["ts"]) + float(ev.get("dur", 0.0)) for ev in device)
        wdur = max(window_s * 1e6, w1 - w0)
    else:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    inner = sorted((s, s + d, name) for name, lst in spans.items() if name != WINDOW
                   for s, d in lst)
    inner_starts = [s for s, _, _ in inner]
    ops = []
    for ev in device:
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if s + d <= w0 or s >= w1:
            continue
        launched = launch_ts.get((ev.get("args") or {}).get("correlation"))
        span = "" if launched is None else _innermost(inner, inner_starts, launched)
        ops.append(Op(ev["name"], ev["cat"], max(s, w0), min(s + d, w1) - max(s, w0), span))
    busy = _merge([(o.start, o.start + o.dur) for o in ops])
    busy_s = sum(e - s for s, e in busy) / 1e6
    totals: dict[str, float] = {}
    for o in ops:
        totals[o.name] = totals.get(o.name, 0.0) + o.dur / 1e6
    device_ops = sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:10]
    host.sort()
    host_starts = [s for s, _, _ in host]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_innermost(host, host_starts, (s + e) / 2) or "host: no event", (e - s) / 1e6]
            for s, e in gaps[:10]]
    return Trace(ops, spans, wdur / 1e6, busy_s, device_ops, idle)


def read(prof, window_s: float | None = None) -> Trace:
    """:func:`reduce` of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events, window_s)
