"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, and the result line.

Files are found by name under this package: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``engines/<engine>.py``,
``end_to_end/<metric>.py``, ``metrics/<metric>.py`` and
``limits/<workload>.json``.  A reader module (names may hold dots) is
loaded from its file and has ``read(ctx)``, which returns a number, or None
where it finds nothing to read.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd.profiler import record_function

from . import generator, shapes, trace

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "fft_convolution_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module in ``<kind>/<name>.py``, loaded from its file."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What the measured window saw, for the end-to-end readers."""

    voices: int
    audio_s_per_call: float
    calls: int               # calls completed in the window
    window_s: float          # from the window's start to its last output ready
    latencies_s: list[float]  # each call: its start to its output ready
    enqueue_s: list[float]    # each call: its start to the return of the host call
    setup_s: float


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window and the cell."""

    trace: trace.Trace
    calls: int
    config: dict
    traffic: dict
    shapes: shapes.TwoStage
    blocks_per_call: int
    voices: int
    peaks: object            # metrics.roofline.Peaks, or None off the card
    enqueue_s: list[float]


class _Ready:
    """A point on the device's stream the host can wait on (on the CPU the
    work is done when the call returns)."""

    def __init__(self, device: torch.device):
        self._ev = None
        if device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record()

    def wait(self) -> None:
        if self._ev is not None:
            self._ev.synchronize()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(engine, first: int, seconds: float, keep: generator.Reservoir,
            slots: list) -> tuple[Window, dict, int]:
    """Calls from ``first`` on for ``seconds``, at most ``engine.in_flight``
    in flight; the host waits on the oldest before the next.  Each call the
    reservoir takes is copied into its slot after its output is ready.
    Returns the window, the kept outputs ``{call: tensor}`` (the last call's
    included) and the index after the last call."""
    dev = engine.device
    pending = collections.deque()
    lat, enq = [], []
    kept_at: dict[int, int] = {}
    last = None
    g = first
    with record_function(trace.WINDOW):
        w0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            with record_function("portbench.call"):
                out = engine.call(g)
            enq.append(time.perf_counter() - t0)
            pending.append((g, t0, _Ready(dev), out))
            g += 1
            while len(pending) >= engine.in_flight or (pending and
                                                       time.perf_counter() - w0 >= seconds):
                gi, ti, ready, y = pending.popleft()
                ready.wait()
                t_ready = time.perf_counter()
                lat.append(t_ready - ti)
                last = (gi, y, t_ready)
                slot = keep.offer()
                if slot is not None:
                    with record_function("portbench.keep"):
                        slots[slot].copy_(y)
                    kept_at[slot] = gi
            if not pending and time.perf_counter() - w0 >= seconds:
                break
        _sync(dev)
    gi, y, t_end = last
    kept = {kept_at[s]: slots[s] for s in kept_at}
    kept[gi] = y
    win = Window(engine.voices, engine.audio_s_per_call, len(lat), t_end - w0, lat, enq, 0.0)
    return win, kept, g


def power_limit() -> str:
    """``name, power.limit`` of the card by nvidia-smi, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else \
        f"not read (nvidia-smi exit {out.returncode})"


def run(config: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
        end_to_end: list[dict], per_layer: list[dict], limits: dict,
        t_start: float | None = None, control: bool = False, log=print) -> dict:
    """One run: set-up, the window, the check, the result's fields.
    ``end_to_end`` / ``per_layer``: the ``BENCHMARK.json`` entries of the
    metrics this cell reports; ``limits``: ``{compared name: limit}``;
    ``t_start``: the host clock when the process began its set-up."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if config["engine"] != traffic["engine"]:
        raise ValueError(f"traffic for {traffic['engine']!r} on a {config['engine']!r} "
                         "configuration")
    engine = load_module("engines", config["engine"]).Engine(config, traffic, seed, device,
                                                             control=control)
    n_keep = traffic["check_calls"]
    keep = generator.Reservoir(n_keep, seed)
    # set-up: the warm-up calls, as many in flight as the window keeps, and
    # the slots of the kept calls
    held = collections.deque()
    for g in range(traffic["warmup_calls"]):
        held.append(engine.call(g))
        if len(held) > engine.in_flight:
            held.popleft()
    slots = [torch.empty_like(held[-1]) for _ in range(n_keep)]
    _sync(device)
    held.clear()
    first = traffic["warmup_calls"]
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        # host events cost the host some microseconds each: a mix whose host
        # work paces the card is traced on the device alone
        acts = ([ProfilerActivity.CPU] if traffic.get("trace_host", True) else []) + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        seconds = min(seconds, traffic["trace_seconds"])
        with profile(activities=acts) as prof:
            win, kept, end = measure(engine, first, seconds, keep, slots)
    else:
        win, kept, end = measure(engine, first, seconds, keep, slots)
    win.setup_s = setup_s
    lat_ms = sorted(x * 1e3 for x in win.latencies_s)
    med = statistics.median(lat_ms)
    log(f"window: {win.calls} calls in {win.window_s!r} s; call ms median {med!r}, max "
        f"{lat_ms[-1]!r}, {sum(x > 1.25 * med for x in lat_ms)} calls over 1.25x the median; "
        f"set-up {setup_s!r} s", file=sys.stderr)
    attempted = end - first
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    breakdown = {}
    metrics = {}
    if prof is not None:
        tr = trace.read(prof, win.window_s)
        del prof
        from .metrics import roofline

        try:
            pk = roofline.peaks(device)
        except ValueError:
            pk = None
        ctx = Context(tr, win.calls, config, traffic, shapes.two_stage(config), engine.t,
                      engine.voices, pk, win.enqueue_s)
        for m in per_layer:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s,
                        power_limit=power_limit() if device.type == "cuda" else "cpu")
        breakdown = {"breakdown": {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}}
        log(f"traced window: {win.calls} calls in {tr.window_s!r} s, device busy "
            f"{tr.busy_s!r} s; card and power limit: {dev_info['power_limit']}",
            file=sys.stderr)
    else:
        for m in end_to_end:
            metrics[m["name"]] = {"value": load_module("end_to_end", m["name"]).read(win),
                                  "unit": m["unit"]}
    # the check: after the window, the peak read and the program's state freed
    engine.free()
    del slots
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = engine.check(kept)
    log(f"check of {len(kept)} kept calls {sorted(kept)} took "
        f"{time.perf_counter() - t_check!r} s", file=sys.stderr)
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values())
    for k, c in compared.items():
        log(f"compared {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return {"correct": correct, "attempted": attempted, "failed": attempted - win.calls,
            "metrics": metrics, "device": dev_info, **breakdown, "compared": compared}


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")


def cell_metrics(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics cell ``name`` reports."""
    def mine(ms):
        return [m for m in ms if "workloads" not in m or name in m["workloads"]]

    return mine(bench["end_to_end"]), mine(bench["per_layer"])


def limits_for(name: str) -> dict:
    """``{compared name: limit}`` of cell ``name`` (``limits/<name>.json``)."""
    path = ROOT / "limits" / f"{name}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}
