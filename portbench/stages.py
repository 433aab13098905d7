"""The program's own spans in a traced window, and the farm call split by them.

The port opens ``fftconv.*`` spans inside its calls
(``fft_convolution_tpu_torch.utils.profiling.annotate``): the reverb farm's
``fftconv.farm.process``, ``.tail_fwd``, ``.tail_inv``, ``.suppress``,
``.update`` and ``.update.table``.  :func:`reduce` puts each device
operation of the window down to the innermost of them around its launch
(by the profiler's correlation id, as :mod:`portbench.trace` does for the
harness's ``portbench.*`` spans), keeps the window's idle intervals, and
each ``cudaMalloc`` with the span it was made in.  :func:`split` gives the
farm call by stage:

- ``tail_fwd_ms``, ``tail_inv_ms``, ``suppress_ms``, ``update_table_ms``:
  device ms a call of the operations launched in that stage;
- ``process_idle_ms``, ``update_idle_ms``: ms a call of the card's idle
  intervals while the host was inside ``fftconv.farm.process`` /
  ``fftconv.farm.update`` (the intersection of the intervals);
- ``cuda_mallocs_per_call``: ``cudaMalloc`` calls a call made inside an
  ``fftconv.farm.*`` span;
- ``idle_ms_by_span``: the card's idle ms a call by the innermost span
  (the program's or the harness's) the host was in, ``""`` for none: the
  whole idle time put down to what the host was doing;
- ``idle_ms_by_host_event``: inside the farm's spans, the idle ms a call by
  ``"<innermost program span> > <innermost host event>"`` (an aten op, a
  runtime call such as ``cudaStreamSynchronize`` or ``cudaMalloc``), the
  ten largest;
- ``glue_rest_ms``: device ms a call launched by the process span itself
  (in none of its children) that is neither B5 nor B6, so that the stages
  and the rest add up to ``farm_glue_ms``;
- the sums to check that by: ``process_ms`` / ``update_ms`` (device ms a
  call launched inside ``fftconv.farm.process`` / ``.update``, children
  included) beside ``portbench_process_ms`` / ``portbench_update_ms`` (the
  same under the harness's spans), and ``farm_glue_ms`` beside
  ``stages_glue_ms``.

A number is None where its span is not in the trace (a program without the
span), and 0 where the span ran and launched nothing.  "A call" is a call
of the traced window, as for the harness's readers.  The harness's readers
see only :class:`portbench.trace.Trace`, which keeps no ``fftconv.*`` span,
so no metric of ``BENCHMARK.json`` reads these numbers; this module prints
them:

    python -m portbench.stages --workload <cell> --seed <n> [--seconds <s>]

runs the cell's traced run on the card (the harness's window and check;
``--seconds`` defaults to the traffic's ``trace_seconds``) and prints one
JSON line: ``correct``, the per-layer ``metrics`` of the run and ``stages``,
the split above.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import sys
import tempfile

import torch

from . import harness, trace
from .metrics import is_b5, is_b6

PREFIX = "fftconv."
FARM = "fftconv.farm."
PROCESS = "fftconv.farm.process"
UPDATE = "fftconv.farm.update"
# split's device ms a call of one stage: name -> span
STAGE_MS = {"tail_fwd_ms": "fftconv.farm.tail_fwd", "tail_inv_ms": "fftconv.farm.tail_inv",
            "suppress_ms": "fftconv.farm.suppress",
            "update_table_ms": "fftconv.farm.update.table"}


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float   # microseconds on the trace's clock, clipped to the window
    dur: float
    launch: float  # the host time of its launch, or None where none was recorded
    stage: str     # the innermost fftconv.* span around its launch, or ""
    span: str      # the innermost portbench.* span around its launch, or ""


@dataclasses.dataclass
class Stages:
    spans: dict    # fftconv.* name -> [(start, end)], microseconds
    ops: list      # DeviceOp of the window
    gaps: list     # the window's idle intervals [(start, end)], microseconds
    mallocs: list  # cudaMalloc calls in the window: [(start, dur, stage)]
    host: list     # host events of the window [(start, end, name)]

    def device_ms(self, stage: str, match=None) -> float:
        """Device ms of the ops whose innermost span is ``stage``."""
        return sum(o.dur for o in self.ops
                   if o.stage == stage and (match is None or match(o.name))) / 1e3

    def device_ms_within(self, name: str) -> float:
        """Device ms of the ops launched inside any span ``name``, its
        children included."""
        within = _merge(self.spans.get(name, []))
        return sum(o.dur for o in self.ops
                   if o.launch is not None and _holds(within, o.launch)) / 1e3

    def idle_ms(self, name: str) -> float:
        """Ms of the window's idle intervals that fall inside spans ``name``."""
        return _overlap(self.gaps, _merge(self.spans.get(name, []))) / 1e3

    def farm_mallocs(self) -> int:
        return sum(1 for _, _, stage in self.mallocs if stage.startswith(FARM))

    def idle_by(self, spans_only: bool) -> dict[str, float]:
        """The idle intervals' microseconds by what the host was in: the
        innermost ``fftconv.*`` or ``portbench.*`` span (``spans_only``), or,
        inside the farm's spans only, ``"<program span> > <host event>"``."""
        spans = _Index([ev for ev in self.host
                        if ev[2].startswith((PREFIX, "portbench.")) and ev[2] != trace.WINDOW])
        program = _Index([ev for ev in self.host if ev[2].startswith(PREFIX)])
        events = spans if spans_only else _Index(self.host)
        out: dict[str, float] = {}
        for g0, g1 in self.gaps:
            held, stages = events.over(g0, g1), program.over(g0, g1)
            cuts = sorted({g0, g1} | {t for s, e, _ in held for t in (s, e) if g0 < t < g1})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                name = _inner(held, mid)
                if not spans_only:
                    stage = _inner(stages, mid)
                    if not stage.startswith(FARM):
                        continue
                    name = f"{stage} > {name}"
                out[name] = out.get(name, 0.0) + (b - a)
        return out


class _Index:
    """Host events ``(start, end, name)`` sorted by start, for the ones that
    overlap an interval."""

    def __init__(self, events):
        self.events = sorted(events)
        self.starts = [s for s, _, _ in self.events]
        self.longest = max((e - s for s, e, _ in self.events), default=0.0)

    def over(self, t0: float, t1: float) -> list:
        lo = bisect.bisect_left(self.starts, t0 - self.longest)
        hi = bisect.bisect_left(self.starts, t1)
        return [ev for ev in self.events[lo:hi] if ev[1] > t0]


def _inner(events: list, t: float) -> str:
    """The innermost of nested ``events`` (sorted by start) that holds
    ``t``: of those that hold it, the one that started last; ``""`` if
    none."""
    return next((n for s, e, n in reversed(events) if s <= t <= e), "")


def _merge(intervals) -> list[tuple[float, float]]:
    return trace._merge(list(intervals))


def _holds(merged: list[tuple[float, float]], t: float) -> bool:
    return any(s <= t <= e for s, e in merged)


def _overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(events: list[dict]) -> Stages:
    """:class:`Stages` from a chrome trace's ``traceEvents`` of a window
    with host events (the ``portbench.window`` span)."""
    launch_ts: dict[int, float] = {}
    program: list[tuple[float, float, str]] = []
    ours: list[tuple[float, float, str]] = []  # the harness's portbench.* spans
    window = None
    device, mallocs, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
        name = ev.get("name", "")
        if cat in trace.HOST_CATS:
            host.append((ts, ts + dur, name))
        if cat in trace.DEVICE_CATS:
            device.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
            if name == "cudaMalloc":
                mallocs.append((ts, dur))
        elif cat == "user_annotation":
            if name == trace.WINDOW:
                window = (ts, ts + dur)
            elif name.startswith(PREFIX):
                program.append((ts, ts + dur, name))
            elif name.startswith("portbench."):
                ours.append((ts, ts + dur, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {trace.WINDOW} span")
    w0, w1 = window
    program.sort()
    ours.sort()
    p_starts = [s for s, _, _ in program]
    o_starts = [s for s, _, _ in ours]
    ops = []
    for ev in device:
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if s + d <= w0 or s >= w1:
            continue
        launched = launch_ts.get((ev.get("args") or {}).get("correlation"))
        stage = span = ""
        if launched is not None:
            stage = trace._innermost(program, p_starts, launched)
            span = trace._innermost(ours, o_starts, launched)
        ops.append(DeviceOp(ev["name"], max(s, w0), min(s + d, w1) - max(s, w0), launched,
                            stage, span))
    busy = _merge((o.start, o.start + o.dur) for o in ops)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans: dict[str, list] = {}
    for s, e, name in program:
        if e > w0 and s < w1:
            spans.setdefault(name, []).append((s, e))
    in_window = [(s, d, trace._innermost(program, p_starts, s)) for s, d in mallocs
                 if w0 <= s < w1]
    host = [(s, e, n) for s, e, n in host if e > w0 and s < w1]
    return Stages(spans, ops, gaps, in_window, host)


def split(st: Stages, calls: int) -> dict:
    """The farm call by stage, a call of ``calls`` (the module docstring)."""
    def per_call(present: bool, ms: float):
        return ms / calls if present else None

    out = {k: per_call(span in st.spans, st.device_ms(span)) for k, span in STAGE_MS.items()}
    farm = any(name.startswith(FARM) for name in st.spans)
    out.update(
        process_idle_ms=per_call(PROCESS in st.spans, st.idle_ms(PROCESS)),
        update_idle_ms=per_call(UPDATE in st.spans, st.idle_ms(UPDATE)),
        cuda_mallocs_per_call=per_call(farm, float(st.farm_mallocs())),
        glue_rest_ms=per_call(PROCESS in st.spans, st.device_ms(
            PROCESS, match=lambda n: not (is_b5(n) or is_b6(n)))),
        process_ms=per_call(PROCESS in st.spans, st.device_ms_within(PROCESS)),
        update_ms=per_call(UPDATE in st.spans, st.device_ms_within(UPDATE)))
    for k, span in (("portbench_process_ms", "portbench.process"),
                    ("portbench_update_ms", "portbench.update")):
        ops = [o for o in st.ops if o.span == span]
        out[k] = per_call(bool(ops), sum(o.dur for o in ops) / 1e3)
    glue = [o for o in st.ops if o.span == "portbench.process"
            and not (is_b5(o.name) or is_b6(o.name))]
    out["farm_glue_ms"] = per_call(bool(glue), sum(o.dur for o in glue) / 1e3)
    parts = [out[k] for k in ("tail_fwd_ms", "tail_inv_ms", "suppress_ms", "glue_rest_ms")]
    out["stages_glue_ms"] = (sum(x for x in parts if x is not None)
                             if out["glue_rest_ms"] is not None else None)
    by_span = st.idle_by(spans_only=True)
    out["idle_ms_by_span"] = {k: v / 1e3 / calls for k, v in
                              sorted(by_span.items(), key=lambda kv: -kv[1])}
    by_event = sorted(st.idle_by(spans_only=False).items(), key=lambda kv: -kv[1])[:10]
    out["idle_ms_by_host_event"] = {k: v / 1e3 / calls for k, v in by_event}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the farm call split by the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = json.loads(harness.BENCHMARK.read_text())
    wl = harness.workload(bench, args.workload)
    config = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    _, layers = harness.cell_metrics(bench, args.workload)
    seen = {}
    read = trace.read

    def keep(prof, window_s=None):
        seen["events"] = _events(prof)
        return trace.reduce(seen["events"], window_s)

    trace.read = keep
    try:
        result = harness.run(config, traffic, args.seed,
                             args.seconds or traffic["trace_seconds"], True, "cuda:0", [],
                             layers, harness.limits_for(args.workload))
    finally:
        trace.read = read
    st = reduce(seen["events"])
    calls = sum(1 for e in seen["events"] if e.get("ph") == "X"
                and e.get("cat") == "user_annotation" and e.get("name") == "portbench.call")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"], "calls": calls,
                      "metrics": result["metrics"], "device": result["device"],
                      "stages": split(st, calls)}), flush=True)
    return 0


def _events(prof) -> list[dict]:
    """The ``traceEvents`` of a finished ``torch.profiler.profile``, through
    a temporary file as :func:`portbench.trace.read` takes them."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_stages_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


if __name__ == "__main__":
    raise SystemExit(main())
