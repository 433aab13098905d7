"""The port's checkpoint, timing and profiling utilities on the CPU (ports
the checkpoint and latency-recorder tests of tests/test_extensions.py), and
the reverb farm's ``fftconv.farm.*`` spans under ``torch.profiler``.

A checkpoint round trip is exact: the engine restored from the file goes on
bit for bit as the one that was saved, for every snapshot form of the port
(dataclass states, tuples, dicts, the crossfader's NamedTuple, bf16
storage)."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from fft_convolution_tpu_torch import (CrossfadeConvolver, CudaCrossfadeConvolver,
                                       CudaFFTConvolver, CudaStreamingConvolver,
                                       CudaTwoStageConvolver, FFTConvolver, ReverbFarm,
                                       TwoStageFFTConvolver)
from fft_convolution_tpu_torch.ops import cuda_engine
from fft_convolution_tpu_torch.utils import checkpoint, profiling
from fft_convolution_tpu_torch.utils.profiling import TRACE_FILE, LatencyRecorder, annotate, trace
from fft_convolution_tpu_torch.utils.timing import BlockTiming, time_per_block, time_stream

B, IR_LEN = 64, 9000


def _irs(seed, v=1, n=IR_LEN):
    return np.random.default_rng(seed).standard_normal((v, n)).astype(np.float32) * 0.05


def _blocks(seed, n, shape=(B,)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]


def _mid_fade():
    ir_a, ir_b = _irs(1, 2)
    conv = CudaCrossfadeConvolver(ir_a, B, IR_LEN, crossfade_samples=4 * B, device="cpu")
    for xb in _blocks(2, 8):
        conv.process(xb)
    conv.update(ir_b)
    for xb in _blocks(3, 2):
        conv.process(xb)
    assert conv.is_crossfading()
    return conv


# name: (fresh engine, engine advanced mid-stream, blocks of one call)
ENGINES = {
    "FFTConvolver": (lambda: FFTConvolver(_irs(0)[0], B, IR_LEN, device="cpu"), None, 1),
    "TwoStageFFTConvolver": (lambda: TwoStageFFTConvolver(_irs(0)[0], B, IR_LEN,
                                                          device="cpu"), None, 1),
    "CudaFFTConvolver bf16": (lambda: CudaFFTConvolver(_irs(0)[0], B, IR_LEN, device="cpu",
                                                       storage="bf16_packed"), None, 1),
    "CudaTwoStageConvolver": (lambda: CudaTwoStageConvolver(_irs(0)[0], B, IR_LEN,
                                                            device="cpu"), None, 1),
    "CudaCrossfadeConvolver mid-fade": (
        lambda: CudaCrossfadeConvolver(_irs(1, 2)[0], B, IR_LEN, crossfade_samples=4 * B,
                                       device="cpu"), _mid_fade, 1),
    "CrossfadeConvolver": (lambda: CrossfadeConvolver(
        FFTConvolver(_irs(0)[0], B, IR_LEN, device="cpu"), IR_LEN, B, 256), None, 1),
    "CudaStreamingConvolver": (lambda: CudaStreamingConvolver(_irs(0)[0], B, IR_LEN,
                                                              device="cpu"), None, 4),
    "ReverbFarm": (lambda: ReverbFarm(_irs(4, 3), B, IR_LEN, device="cpu"), None, None),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_checkpoint_roundtrip(tmp_path, name):
    fresh, advanced, per_call = ENGINES[name]
    conv = (advanced or fresh)()
    if per_call is None:  # the farm: whole tail periods of [T, V, B]
        shape = (conv.period, conv.voices, B)
        calls_before, calls_after = _blocks(5, 2, shape), _blocks(6, 2, shape)
    else:
        calls_before = [x.reshape(-1) for x in _blocks(5, 24, (per_call, B))]
        calls_after = [x.reshape(-1) for x in _blocks(6, 24, (per_call, B))]
    if advanced is None:
        for x in calls_before:
            conv.process(x)

    path = str(tmp_path / "engine.npz")
    checkpoint.save(path, conv.snapshot())
    y1 = torch.cat([conv.process(x) for x in calls_after])

    other = fresh()
    other.restore(checkpoint.load(path, other.snapshot()))
    y2 = torch.cat([other.process(x) for x in calls_after])
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())


def test_checkpoint_shape_mismatch(tmp_path):
    c = FFTConvolver(np.ones(100, np.float32), 64, 100, device="cpu")
    path = str(tmp_path / "e.npz")
    checkpoint.save(path, c.snapshot())
    other = FFTConvolver(np.ones(100, np.float32), 128, 100, device="cpu")
    with pytest.raises(ValueError):
        checkpoint.load(path, other.snapshot())


def test_checkpoint_dtype_mismatch(tmp_path):
    """A bf16 state does not load into a float32 engine's template."""
    ir = _irs(7)[0]
    path = str(tmp_path / "e.npz")
    checkpoint.save(path, CudaFFTConvolver(ir, B, IR_LEN, device="cpu",
                                           storage="bf16_packed").snapshot())
    with pytest.raises(ValueError, match="torch.bfloat16"):
        checkpoint.load(path, CudaFFTConvolver(ir, B, IR_LEN, device="cpu").snapshot())


def test_checkpoint_leaf_forms(tmp_path):
    """bf16 is stored as its 16-bit view with the dtype recorded; host
    scalars come back as Python scalars, the crossfader's float32 ramp as a
    numpy float32; the kernel's arrival counter is never saved."""
    conv = _mid_fade()
    path = str(tmp_path / "xf.npz")
    checkpoint.save(path, conv.snapshot())
    consts, state, cf, stored, pending = checkpoint.load(path, conv.snapshot())
    assert type(state.current) is int and type(pending) is bool
    assert type(cf.approaching) is bool and type(cf.counter) is int
    assert type(cf.mix_value) is np.float32 and cf == conv.cf_state
    assert consts.ir_b.dtype == torch.complex64 and torch.equal(consts.ir_b, conv.consts.ir_b)

    packed = CudaFFTConvolver(_irs(8)[0], B, IR_LEN, device="cpu", storage="bf16_packed")
    for xb in _blocks(9, 3):
        packed.process(xb)
    snap = packed.snapshot()
    snap.ticket = torch.zeros(1, dtype=torch.int32)
    checkpoint.save(path, snap)
    with np.load(path) as data:
        kinds = list(data["kinds"])
        assert kinds == ["torch.bfloat16", "torch.float32", "int"]
        assert data["leaf_0"].dtype == np.int16
    back = checkpoint.load(path, packed.snapshot())
    assert isinstance(back, cuda_engine.FDLState) and back.ticket is None
    assert back.segments.dtype == torch.bfloat16 and torch.equal(back.segments, snap.segments)
    assert type(back.current) is int and back.current == snap.current


# ---- timing and profiling ------------------------------------------------------------

def test_latency_recorder():
    rec = LatencyRecorder(block_size=128, sample_rate=48000.0)
    for _ in range(10):
        with rec.measure():
            pass
    rep = rec.report()
    assert rep["n_blocks"] == 10
    assert rep["p99_ms"] >= rep["p50_ms"] >= 0
    assert rep["xrt_median"] > 0
    assert rep["deadline_misses"] == 0


def test_timing_cpu_path():
    """time_stream and time_per_block on CPU engines: wall seconds of calls
    that ran to their end; BlockTiming's xRT and percentiles."""
    conv = FFTConvolver(_irs(10)[0], B, IR_LEN, device="cpu")
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(B * 16).astype(np.float32))
    assert time_stream(conv.process, x, warmup=1, iters=3) > 0

    fast = CudaFFTConvolver(_irs(10)[0], B, IR_LEN, device="cpu")
    steps = []

    def step(state, block):
        steps.append(state.current)
        return state, cuda_engine.block_step(fast.consts, state, block)

    blocks = torch.stack(_blocks(12, 12))
    times = time_per_block(step, fast.state, blocks, warmup=2)
    assert len(times) == 12 and min(times) > 0 and len(steps) == 14
    timing = BlockTiming(wall_s=sum(times), n_blocks=12, block_size=B, sample_rate=48000.0,
                         per_block_s=times)
    assert timing.xrt == pytest.approx(12 * B / 48000.0 / sum(times))
    assert timing.percentile_ms(100) == pytest.approx(max(times) * 1e3)
    with pytest.raises(ValueError):
        BlockTiming(1.0, 1, B, 48000.0).percentile_ms(50)


def test_profiling_trace(tmp_path):
    """trace() writes a Chrome trace of the region with the annotated span."""
    conv = FFTConvolver(_irs(13)[0], B, IR_LEN, device="cpu")
    x = torch.zeros(B * 8)
    with trace(str(tmp_path)):
        with annotate("reverb_block"):
            conv.process(x)
    path = tmp_path / TRACE_FILE
    assert os.path.exists(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "reverb_block" for e in events)


# ---- the farm's spans ----------------------------------------------------------------

FARM_SPANS = ("fftconv.farm.process", "fftconv.farm.tail_fwd", "fftconv.farm.tail_inv",
              "fftconv.farm.suppress", "fftconv.farm.update", "fftconv.farm.update.table")


def test_annotate_without_a_profiler_is_one_null_context(monkeypatch):
    """With no profiler running, ``annotate`` makes no ``RecordFunction``: it
    hands back the same null context every time; under one it is
    ``record_function``."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    spans = [profiling.annotate(name) for name in FARM_SPANS]
    assert all(s is spans[0] for s in spans) and isinstance(spans[0], contextlib.nullcontext)
    assert made == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("fftconv.farm.process"), real)
    assert made == ["fftconv.farm.process"]
    assert profiling.annotate("fftconv.farm.process") is spans[0]


def _farm_spans(tmp_path, calls):
    """Run ``calls`` (each a function of the farm) on a tiny CPU farm built
    inside a ``torch.profiler`` window; the ``fftconv.*`` spans as ``(start,
    end, name)`` sorted by start, and each call's ``(start, end)``."""
    from torch.profiler import ProfilerActivity, profile

    irs = _irs(21, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        farm = ReverbFarm(irs, B, IR_LEN, device="cpu")
        marks = []
        for i, call in enumerate(calls):
            with torch.profiler.record_function(f"test.call{i}"):
                call(farm)
    path = tmp_path / "farm_trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e["name"].startswith("fftconv."))
    for i in range(len(calls)):
        (mark,) = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == f"test.call{i}"]
        marks.append(mark)
    return spans, marks


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


def test_farm_spans_nest_under_their_calls(tmp_path):
    """The six spans of the farm: each ``process`` holds one
    ``fftconv.farm.process`` with the tail's forward stage (its rows and
    their rDFT) and its inverse inside; ``update_voices`` and ``update`` hold
    ``fftconv.farm.update`` with the table's stage inside; construction opens
    none; the suppress pass opens its span only in the call after an
    update, inside that call's process span."""
    rng = np.random.default_rng(22)
    x = [torch.from_numpy(rng.standard_normal((32, 3, B)).astype(np.float32)) for _ in range(4)]
    new = _irs(23, 3)
    calls = [lambda f: f.process(x[0]),
             lambda f: f.update_voices([1], new[1:2]),
             lambda f: f.process(x[1]),
             lambda f: f.process(x[2]),
             lambda f: f.update(new),
             lambda f: f.process(x[3])]
    spans, marks = _farm_spans(tmp_path, calls)
    assert {name for _, _, name in spans} == set(FARM_SPANS)
    assert all(any(_inside(s, m) for m in marks) for s in spans)  # none from construction
    for i, m in enumerate(marks):
        mine = [s for s in spans if _inside(s, m)]
        names = sorted(name for _, _, name in mine)
        if i in (1, 4):
            assert names == ["fftconv.farm.update", "fftconv.farm.update.table"], i
            outer = next(s for s in mine if s[2] == "fftconv.farm.update")
        else:
            want = ["fftconv.farm.process", "fftconv.farm.tail_fwd", "fftconv.farm.tail_inv"]
            if i in (2, 5):  # the first call after an update
                want.insert(1, "fftconv.farm.suppress")
            assert names == want, i
            outer = next(s for s in mine if s[2] == "fftconv.farm.process")
        assert all(_inside(s, outer) for s in mine)


def test_farm_output_is_the_same_traced_or_not(monkeypatch):
    """The spans change nothing the farm computes: the same calls with and
    without a profiler give the same bits, and without one no
    ``RecordFunction`` is made."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(24)
    x = [torch.from_numpy(rng.standard_normal((32, 3, B)).astype(np.float32)) for _ in range(3)]
    new = _irs(25, 1)

    def run(farm):
        ys = [farm.process(x[0])]
        farm.update_voices([2], new)
        return ys + [farm.process(xi) for xi in x[1:]]

    with profile(activities=[ProfilerActivity.CPU]):
        traced = run(ReverbFarm(_irs(21, 3), B, IR_LEN, device="cpu"))
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    plain = run(ReverbFarm(_irs(21, 3), B, IR_LEN, device="cpu"))
    assert made == []
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)
