"""The port's host runtime on the CPU (ports tests/test_runtime.py): the
native build, ring and block assembler (native and ``force_python``), the
WAV codec, the numpy boundary ``HostEngine``, ``StreamingConvolver`` and the
real-time dispatcher over the port's CPU engines, held against the JAX
package's ``FFTConvolver.process`` on the same seeded input and bit for bit
against the port's own engines fed the same calls.  Also the import
boundary: no module of the port imports JAX or the JAX package."""

import ctypes
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fft_convolution_tpu import FFTConvolver as JaxFFTConvolver
from fft_convolution_tpu_torch import (CrossfadeConvolver, CudaCrossfadeConvolver,
                                       CudaFFTConvolver, CudaStreamingConvolver,
                                       CudaTwoStageConvolver, FFTConvolver, ReverbFarm,
                                       TwoStageFFTConvolver, runtime)
from fft_convolution_tpu_torch.examples import serve_morph
from fft_convolution_tpu_torch.runtime.chunker import BlockAssembler, RingBuffer
from fft_convolution_tpu_torch.runtime.dispatcher import RealTimeDispatcher
from fft_convolution_tpu_torch.runtime.host import HostEngine
from fft_convolution_tpu_torch.runtime.stream import StreamingConvolver
from fft_convolution_tpu_torch.utils.audio import load_wav, save_wav

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Against the JAX package over a stream of a few thousand samples: the
# reference's 1000-block stream tolerance (SURVEY §4).
ATOL = 1e-5
# A block of 64 with a 9000-tap IR: the two-stage forms have a tail stage
# (tail block 1024, period 16), so 48 blocks cross three period ends.
B, IR_LEN, N_BLOCKS = 64, 9000, 48


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---- the native library -------------------------------------------------------

def test_native_builds():
    lib = runtime.load()
    path = runtime.library_path()
    assert path.exists() and path.parent == runtime.BUILD_DIR
    assert path.name.startswith("libhost_runtime_") and path.suffix == ".so"
    assert runtime.build() == path  # built once, then loaded as it is
    assert lib.rb_capacity(lib.rb_create(100)) == 128


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError with g++'s output
    and leaves no file behind: there is no switch to Python."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
        runtime.build(bad)
    assert "error" in str(err.value)
    assert list((tmp_path / "build").iterdir()) == []


def test_native_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        runtime.build()


@pytest.mark.parametrize("force_python", [False, True])
def test_ring_buffer(force_python):
    rb = RingBuffer(100, force_python=force_python)
    assert rb.capacity == 128
    assert (rb._lib is None) == force_python
    rng = np.random.default_rng(0)
    data = rng.standard_normal(300).astype(np.float32)
    out = []
    pos = 0
    while pos < 300 or rb.readable():
        if pos < 300:
            pos += rb.write(data[pos:pos + 37])
        out.append(rb.read(23))
    np.testing.assert_array_equal(np.concatenate(out), data)


@pytest.mark.parametrize("force_python", [False, True])
def test_block_assembler(force_python):
    ba = BlockAssembler(64, force_python=force_python)
    assert (ba._lib is None) == force_python
    rng = np.random.default_rng(1)
    data = rng.standard_normal(1000).astype(np.float32)
    blocks = []
    pos = 0
    for size in [1, 63, 64, 100, 7, 500, 265]:
        blocks.append(ba.push(data[pos:pos + size]))
        pos += size
    assert pos == 1000
    got = np.concatenate([b.reshape(-1) for b in blocks])
    n_full = (1000 // 64) * 64
    np.testing.assert_array_equal(got, data[:n_full])
    assert ba.fill == 1000 - n_full
    # partial peek returns the remainder zero-padded
    peek = ba.peek()
    np.testing.assert_array_equal(peek[:ba.fill], data[n_full:])
    np.testing.assert_array_equal(peek[ba.fill:], 0)
    ba.reset()
    assert ba.fill == 0
    np.testing.assert_array_equal(ba.peek(), 0)


def test_native_and_python_chunkers_agree():
    """The same pushes through both backends give the same blocks."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal(3000).astype(np.float32)
    sizes = rng.integers(0, 300, 40)
    outs = []
    for force_python in (False, True):
        ba, pos, got = BlockAssembler(128, force_python=force_python), 0, []
        for s in sizes:
            got.append(ba.push(data[pos:pos + s]))
            pos += s
        outs.append((np.concatenate(got), ba.fill, ba.peek()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_native_wav_roundtrip(tmp_path):
    lib = runtime.load()
    rng = np.random.default_rng(2)
    samples = (rng.standard_normal(4096) * 0.3).clip(-1, 1).astype(np.float32)
    path = str(tmp_path / "t.wav").encode()
    assert lib.wav_write_mono16(path, _f32p(samples), len(samples), 48000) == 0
    sr = ctypes.c_uint32(0)
    n = lib.wav_read_mono16(path, None, 0, ctypes.byref(sr))
    assert n == 4096 and sr.value == 48000
    out = np.empty(4096, np.float32)
    assert lib.wav_read_mono16(path, _f32p(out), 4096, ctypes.byref(sr)) == 4096
    np.testing.assert_allclose(out, samples, atol=1.0 / 32767)
    back, rate = load_wav(path.decode())  # the stdlib reader reads the native file
    assert rate == 48000
    np.testing.assert_array_equal(back, out)


def test_native_wav_matches_python_writer(tmp_path):
    """Native and stdlib writers produce byte-identical files."""
    lib = runtime.load()
    rng = np.random.default_rng(3)
    samples = (rng.standard_normal(1000) * 0.5).clip(-1, 1).astype(np.float32)
    p1, p2 = str(tmp_path / "native.wav"), str(tmp_path / "python.wav")
    lib.wav_write_mono16(p1.encode(), _f32p(samples), len(samples), 44100)
    save_wav(p2, samples, 44100)
    assert pathlib.Path(p1).read_bytes() == pathlib.Path(p2).read_bytes()


# ---- the numpy boundary ---------------------------------------------------------

def _ir(seed, n=IR_LEN, scale=0.05):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * scale


def test_host_engine_boundary():
    """numpy in, numpy out the caller owns; one staging set per shape;
    wrapping twice is harmless; extensions pass through where they exist."""
    ir = _ir(10)
    engine = FFTConvolver(ir, B, IR_LEN, device="cpu")
    twin = engine.clone()
    host = HostEngine(HostEngine(engine))
    assert host.engine is engine and host.cfg is engine.cfg
    x = np.random.default_rng(11).standard_normal((8, B)).astype(np.float32)
    ys = [host.process(xb) for xb in x]
    assert all(type(y) is np.ndarray and y.dtype == np.float32 for y in ys)
    assert not np.shares_memory(ys[0], ys[1])
    assert len(host._staging) == 1
    ys[0][:] = 7.0  # the caller's array: the next call is unaffected
    want = torch.stack([twin.process(torch.from_numpy(xb)) for xb in x]).numpy()
    np.testing.assert_array_equal(np.stack(ys[1:]), want[1:])
    assert not hasattr(host, "update_extension") and not hasattr(host, "is_crossfading")
    two = HostEngine(TwoStageFFTConvolver(ir, B, IR_LEN, device="cpu"))
    assert callable(two.update_extension)
    xf = HostEngine(CudaCrossfadeConvolver(ir, B, IR_LEN, 4 * B, device="cpu"))
    assert xf.is_crossfading() is False and callable(xf.reset_extension)
    other = host.clone()
    assert other.engine is not engine
    np.testing.assert_array_equal(other.process(x[0]), host.process(x[0]))


# ---- StreamingConvolver -----------------------------------------------------------

# ragged pushes, and aligned ones that reach the batched path (fill 0)
PUSHES = [441, 71, 1024, 441, 300, 128, 256, 41, 1394]


@pytest.mark.parametrize("kind", ["uniform", "two_stage", "crossfade"])
def test_streaming_convolver_matches_engine(kind):
    rng = np.random.default_rng(4)
    ir = rng.standard_normal(IR_LEN).astype(np.float32) * 0.05
    x = rng.standard_normal(sum(PUSHES)).astype(np.float32)
    y_ref = np.asarray(JaxFFTConvolver(ir, B, IR_LEN).process(x))

    def make():
        if kind == "uniform":
            return FFTConvolver(ir, B, IR_LEN, device="cpu")
        if kind == "two_stage":
            return TwoStageFFTConvolver(ir, B, IR_LEN, device="cpu")
        return CrossfadeConvolver(FFTConvolver(ir, B, IR_LEN, device="cpu"), IR_LEN, B, 256)

    s, direct = StreamingConvolver(make()), make()
    pieces, want, pos = [], [], 0
    for size in PUSHES:
        pieces.append(s.push(x[pos:pos + size]))
        want.append(direct.process(torch.from_numpy(x[pos:pos + size])).numpy())
        assert pieces[-1].shape == (size,) and type(pieces[-1]) is np.ndarray
        pos += size
    y = np.concatenate(pieces)
    np.testing.assert_allclose(y, y_ref, atol=ATOL)
    np.testing.assert_array_equal(y, np.concatenate(want))


@pytest.mark.parametrize("make", [
    lambda ir: CudaFFTConvolver(ir, B, IR_LEN, device="cpu"),
    lambda ir: CudaFFTConvolver(ir, B, IR_LEN, device="cpu", storage="bf16_packed"),
    lambda ir: CudaTwoStageConvolver(ir, B, IR_LEN, device="cpu"),
    lambda ir: CudaCrossfadeConvolver(ir, B, IR_LEN, 4 * B, device="cpu"),
    lambda ir: CudaStreamingConvolver(ir, B, IR_LEN, device="cpu"),
    lambda ir: HostEngine(CudaFFTConvolver(ir, B, IR_LEN, device="cpu")),
    lambda ir: CrossfadeConvolver(CudaFFTConvolver(ir, B, IR_LEN, device="cpu"), IR_LEN, B,
                                  256),
    lambda ir: ReverbFarm(np.stack([ir, ir]), B, IR_LEN, device="cpu"),
], ids=["B1", "B1p", "B2", "B3", "B4", "host-B1", "crossfade-B1", "farm"])
def test_streaming_convolver_refuses_per_block_engines(make):
    """A per-block engine raises at construction, not in the middle of a
    stream."""
    with pytest.raises(ValueError, match="any input length"):
        StreamingConvolver(make(_ir(12)))


# ---- RealTimeDispatcher -----------------------------------------------------------

DISPATCHED = {
    "FFTConvolver": lambda ir: FFTConvolver(ir, B, IR_LEN, device="cpu"),
    "B1": lambda ir: CudaFFTConvolver(ir, B, IR_LEN, device="cpu"),
    "B2": lambda ir: CudaTwoStageConvolver(ir, B, IR_LEN, device="cpu"),
    "B3": lambda ir: CudaCrossfadeConvolver(ir, B, IR_LEN, 4 * B, device="cpu"),
}


def _push_all(d, x, size=441):
    pos = 0
    while pos < len(x):
        pos += d.push(x[pos:pos + size])


@pytest.mark.parametrize("name", list(DISPATCHED))
def test_realtime_dispatcher_pipeline(name):
    """Producer -> lock-free ring -> dispatcher thread -> ring -> consumer
    reproduces the engine's own block loop exactly and the JAX package's
    FFTConvolver within ATOL (whole blocks only)."""
    rng = np.random.default_rng(70)
    ir = rng.standard_normal(IR_LEN).astype(np.float32) * 0.05
    x = rng.standard_normal(B * N_BLOCKS).astype(np.float32)
    y_ref = np.asarray(JaxFFTConvolver(ir, B, IR_LEN).process(x))

    engine, twin = DISPATCHED[name](ir), DISPATCHED[name](ir)
    with RealTimeDispatcher(engine, capacity_blocks=64) as d:
        _push_all(d, x)
        d.drain()
        got = d.pull(len(x))
    assert d.blocks_processed == N_BLOCKS
    assert d.underruns == 0 and d.update_applied_at is None
    np.testing.assert_allclose(got, y_ref, atol=ATOL)
    loop = torch.cat([twin.process(torch.from_numpy(xb)) for xb in x.reshape(-1, B)])
    np.testing.assert_array_equal(got, loop.numpy())


def test_dispatcher_drain_waits_for_slow_engine():
    """drain() waits for a block that is mid-``engine.process`` even when
    the input ring already looks empty: an engine whose block takes longer
    than the poll interval made the old counter-settled-across-one-poll
    heuristic return early and pull() replace the final block with zeros."""
    rng = np.random.default_rng(71)
    ir = rng.standard_normal(500).astype(np.float32) * 0.1
    x = rng.standard_normal(128 * 4).astype(np.float32)
    y_ref = np.asarray(JaxFFTConvolver(ir, 128, len(ir)).process(x))

    class SlowEngine:
        def __init__(self, inner):
            self.inner, self.cfg, self.device = inner, inner.cfg, inner.device

        def process(self, block):
            time.sleep(0.03)
            return self.inner.process(block)

    engine = SlowEngine(FFTConvolver(ir, 128, len(ir), device="cpu"))
    with RealTimeDispatcher(engine, capacity_blocks=32) as d:
        _push_all(d, x)
        d.drain()
        assert d.blocks_processed == 4
        got = d.pull(len(x))
    assert d.underruns == 0
    np.testing.assert_allclose(got, y_ref, atol=ATOL)


def test_dispatcher_update_lands_between_blocks():
    """RealTimeDispatcher.update over kernel B3's wrapper: the morph lands at
    ``update_applied_at``, before it the output is ir_a's float64
    convolution and after the hold and the fade ir_b's (ATOL), the whole
    output equals the wrapper's own block loop with the update made before
    that block, and only the dispatcher thread touched the engine."""
    rng = np.random.default_rng(72)
    ir_a = rng.standard_normal(2048).astype(np.float32) * 0.05
    ir_b = rng.standard_normal(2048).astype(np.float32) * 0.05
    x = rng.standard_normal(128 * 96).astype(np.float32) * 0.3
    inner = CudaCrossfadeConvolver(ir_a, 128, 2048, crossfade_samples=512, device="cpu")
    twin = inner.clone()

    class Recording:
        def __init__(self, eng):
            self.eng, self.cfg, self.device, self.threads = eng, eng.cfg, eng.device, set()

        def process(self, block):
            self.threads.add(threading.get_ident())
            return self.eng.process(block)

        def update(self, response):
            self.threads.add(threading.get_ident())
            self.eng.update(response)

    engine = Recording(inner)
    y, d = serve_morph.serve(engine, x, ir_b, morph_at=len(x) // 3)
    k = d.update_applied_at
    assert len(y) == len(x) and d.blocks_processed == 96 and 0 < k < 96
    assert len(engine.threads) == 1 and threading.get_ident() not in engine.threads
    res = serve_morph.check(y, x, ir_a, ir_b, k, 128, inner.cf_cfg.hold_samples,
                            inner.cf_cfg.fading_samples)
    assert res["pre_err"] <= ATOL and res["post_err"] <= ATOL
    loop = []
    for t, xb in enumerate(x.reshape(-1, 128)):
        if t == k:
            twin.update(ir_b)
        loop.append(twin.process(torch.from_numpy(xb)))
    np.testing.assert_array_equal(y, torch.cat(loop).numpy())


def test_paced_callback_delays_the_stream():
    """The wall-clock callback of ``serve_paced`` over kernel B3's wrapper,
    with 24 blocks of output latency (64 ms at 48 kHz, far more than a CPU
    block takes): no underrun, the latency is silence, and after it comes
    the wrapper's own block loop with the morph before block
    ``update_applied_at``, bit-equal."""
    rng = np.random.default_rng(74)
    ir_a = rng.standard_normal(2048).astype(np.float32) * 0.05
    ir_b = rng.standard_normal(2048).astype(np.float32) * 0.05
    x = rng.standard_normal(128 * 96).astype(np.float32) * 0.3
    engine = CudaCrossfadeConvolver(ir_a, 128, 2048, crossfade_samples=512, device="cpu")
    twin = engine.clone()
    latency = 24 * 128
    y, d = serve_morph.serve_paced(engine, x, ir_b, morph_at=len(x) // 3, latency=latency)
    k = d.update_applied_at
    assert len(y) == len(x) and d.blocks_processed == 96 and d.samples_pushed == len(x)
    assert d.underruns == 0 and 0 < k < 96
    assert not y[:latency].any()
    loop = []
    for t, xb in enumerate(x.reshape(-1, 128)):
        if t == k:
            twin.update(ir_b)
        loop.append(twin.process(torch.from_numpy(xb)))
    np.testing.assert_array_equal(y[latency:], torch.cat(loop).numpy()[:len(x) - latency])


def test_paced_callback_counts_underruns():
    """An engine slower than real time (50 ms a 2.67 ms block) behind the
    wall-clock callback: output that is not ready when due is silence and
    counted as an underrun; the stream still ends whole."""
    ir = np.random.default_rng(75).standard_normal(500).astype(np.float32) * 0.1

    class SlowEngine:
        def __init__(self, inner):
            self.inner, self.cfg, self.device = inner, inner.cfg, inner.device

        def process(self, block):
            time.sleep(0.05)
            return self.inner.process(block)

    x = np.ones(128 * 8, np.float32)
    y, d = serve_morph.serve_paced(SlowEngine(FFTConvolver(ir, 128, 500, device="cpu")), x)
    assert len(y) == len(x) and d.blocks_processed == 8
    assert d.underruns >= 1 and not y[:441 + 128].any()


def test_dispatcher_updates_under_contention():
    """Updates posted from the callback thread while blocks stream, with the
    interpreter switching threads as often as it can: none lands inside a
    block, the pending slot ends empty and the last update is the one in
    effect."""
    rng = np.random.default_rng(73)
    irs = rng.standard_normal((20, 500)).astype(np.float32) * 0.1
    x = rng.standard_normal(128 * 64).astype(np.float32)
    engine = FFTConvolver(irs[0], 128, 500, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with RealTimeDispatcher(engine, capacity_blocks=16) as d:
            pos, posted = 0, 0
            while pos < len(x):
                pos += d.push(x[pos:pos + 441])
                if posted < len(irs) and pos >= (posted + 1) * 300:
                    d.update(irs[posted])
                    posted += 1
                d.pull(d.available())
            assert posted == len(irs)
            _push_all(d, np.zeros(128 * 4, np.float32))  # blocks after the last update
            d.drain(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert d.blocks_processed == 68 and d._pending is None
    fresh = FFTConvolver(irs[-1], 128, 500, device="cpu")
    assert torch.equal(engine.state.segments_ir, fresh.state.segments_ir)


def test_dispatcher_reports_a_failed_engine():
    class Broken:
        cfg, device = FFTConvolver(np.ones(8, np.float32), 64, 8, device="cpu").cfg, "cpu"

        def process(self, block):
            raise ValueError("broken engine")

    with pytest.raises(RuntimeError, match="dispatcher thread failed"):
        with RealTimeDispatcher(Broken()) as d:
            _push_all(d, np.zeros(256, np.float32))
            d.drain(timeout=10)


# ---- the import boundary ----------------------------------------------------------

def test_port_imports_nothing_of_jax():
    """Every module of the port, runtime, utils and examples included,
    imports without JAX or the JAX package (a fresh interpreter: the
    repository's conftest imports JAX)."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import fft_convolution_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'fft_convolution_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'fft_convolution_tpu.')))\n"
        "assert {'fft_convolution_tpu_torch.runtime.dispatcher',\n"
        "        'fft_convolution_tpu_torch.utils.checkpoint',\n"
        "        'fft_convolution_tpu_torch.examples.serve_morph'} <= set(names), names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
