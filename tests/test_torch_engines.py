"""The PyTorch port's sequential engines and wrappers (uniform and two-stage)
against the JAX package's, on the same numpy-seeded inputs."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_convolution_tpu as J
import fft_convolution_tpu_torch as T
from fft_convolution_tpu.models import two_stage as jtwo
from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.models import two_stage as ttwo
from fft_convolution_tpu_torch.models import uniform as tuni

# Both packages compute the same float32 convolution with differently
# rounded DFTs (a float32 basis matmul against pocketfft); over these short
# streams of unit-variance input the outputs agree to a few 1e-6.  1e-5 is
# the reference's own 1000-block stream tolerance (src/tests.rs:126).
ATOL = 1e-5
CHUNK = 441  # an odd host-buffer size that crosses block edges


def _chunks(conv, x, to_np):
    return np.concatenate([to_np(conv.process(x[i:i + CHUNK]))
                           for i in range(0, len(x), CHUNK)])


def _t(y):
    return y.numpy()


def _j(y):
    return np.asarray(y)


def test_uniform_block_step_from_jax_state():
    """One engine step from the same mid-stream state (carried by interop)."""
    rng = np.random.default_rng(50)
    b = 64
    ir = (rng.standard_normal(b * 6) * 0.1).astype(np.float32)
    jcfg, js = juni.init(ir, b, len(ir))
    step = jax.jit(functools.partial(juni.process_block, jcfg))
    for _ in range(9):  # past one ring wrap
        js, _ = step(js, jnp.asarray(
            rng.standard_normal(b).astype(np.float32)))
    tcfg = tuni.make_config(b, len(ir))
    ts = interop.uniform_state(js)
    for t in range(4):
        x = rng.standard_normal(b).astype(np.float32)
        js, yj = step(js, jnp.asarray(x))
        yt = tuni.process_block(tcfg, ts, torch.from_numpy(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, err_msg=f"block {t}")
        assert ts.current == int(js.current)


def test_fft_convolver_matches_jax():
    rng = np.random.default_rng(51)
    b = 128
    ir = (rng.standard_normal(1000) * 0.1).astype(np.float32)
    ir2 = (rng.standard_normal(300) * 0.1).astype(np.float32)
    x = rng.standard_normal(20 * b).astype(np.float32)
    jc, tc = J.FFTConvolver(ir, b, 1200), T.FFTConvolver(ir, b, 1200, device="cpu")
    assert isinstance(tc, T.Convolution)
    half = len(x) // 2
    np.testing.assert_allclose(_chunks(tc, x[:half], _t), _chunks(jc, x[:half], _j), atol=ATOL)
    # mid-stream update to a shorter IR: history kept, overlap dropped,
    # ring re-indexed modulo the new active count
    jc.update(ir2)
    tc.update(ir2)
    assert tc.state.active_segs == int(jc.state.active_segs) == 3
    np.testing.assert_allclose(_chunks(tc, x[half:], _t), _chunks(jc, x[half:], _j), atol=ATOL)
    # block-aligned call after the chunked ones (the block loop)
    tc.reset()
    jc.reset()
    np.testing.assert_allclose(tc.process(x[:4 * b]).numpy(), np.asarray(jc.process(x[:4 * b])),
                               atol=ATOL)
    assert tc.process(np.zeros(0, np.float32)).shape == (0,)


def test_fft_convolver_reset_snapshot_clone():
    rng = np.random.default_rng(52)
    b = 64
    ir = (rng.standard_normal(500) * 0.1).astype(np.float32)
    x = rng.standard_normal(12 * b).astype(np.float32)
    conv = T.FFTConvolver(ir, b, len(ir), device="cpu")
    y1 = _chunks(conv, x, _t)
    conv.reset()
    np.testing.assert_array_equal(_chunks(conv, x, _t), y1)  # bit-equal replay

    conv.reset()
    conv.process(x[:300])
    snap = conv.snapshot()
    twin = conv.clone()
    a = conv.process(x[300:700]).numpy()
    twin.process(x[::-1].copy())  # drive the twin elsewhere
    conv.restore(snap)
    np.testing.assert_array_equal(conv.process(x[300:700]).numpy(), a)
    conv.restore(snap)  # a snapshot restores more than once
    np.testing.assert_array_equal(conv.process(x[300:700]).numpy(), a)


def test_fft_convolver_errors_match_jax():
    ir = np.ones(100, np.float32)
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.FFTConvolver(ir, 64, 99, **kw)
        conv = mod.FFTConvolver(ir, 64, 100, **kw)
        with pytest.raises(ValueError):
            conv.update(np.ones(101, np.float32))
    # block size rounds up to a power of two, as in the reference
    assert (vars(T.FFTConvolver(ir, 100, 100, device="cpu").cfg)
            == vars(J.FFTConvolver(ir, 100, 100).cfg))


@pytest.mark.parametrize("head,total", [(64, 100), (64, 20000), (128, 480000), (256, 4096)])
def test_tail_block_size_matches_jax(head, total):
    assert ttwo.compute_tail_block_size(head, total) == jtwo.compute_tail_block_size(head, total)


def test_two_stage_block_step_from_jax_state():
    rng = np.random.default_rng(53)
    b = 32
    ir = (rng.standard_normal(3000) * 0.05).astype(np.float32)
    jcfg, js = jtwo.init(ir, b, len(ir))
    assert jcfg.tail is not None
    step = jax.jit(functools.partial(jtwo.process_block, jcfg))
    for _ in range(40):  # past one tail period (period = 512 / 32 = 16)
        js, _ = step(js, jnp.asarray(
            rng.standard_normal(b).astype(np.float32)))
    tcfg, _ = ttwo.init(ir, b, len(ir))
    ts = interop.two_stage_state(js)
    for t in range(2 * jcfg.period):
        x = rng.standard_normal(b).astype(np.float32)
        js, yj = step(js, jnp.asarray(x))
        yt = ttwo.process_block(tcfg, ts, torch.from_numpy(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, err_msg=f"block {t}")


def test_two_stage_convolver_matches_jax():
    rng = np.random.default_rng(54)
    b = 64
    ir = (rng.standard_normal(9000) * 0.05).astype(np.float32)
    ir2 = (rng.standard_normal(5000) * 0.05).astype(np.float32)
    x = rng.standard_normal(70 * b).astype(np.float32)
    jc = J.TwoStageFFTConvolver(ir, b, len(ir))
    tc = T.TwoStageFFTConvolver(ir, b, len(ir), device="cpu")
    assert tc.cfg.tail is not None and tc.cfg.period == jc.cfg.period
    half = 40 * b
    np.testing.assert_allclose(_chunks(tc, x[:half], _t), _chunks(jc, x[:half], _j), atol=ATOL)
    jc.update_extension(ir2)
    tc.update_extension(ir2)
    np.testing.assert_allclose(_chunks(tc, x[half:], _t), _chunks(jc, x[half:], _j), atol=ATOL)
    # aligned multi-block call (the JAX package streams it; the port loops)
    tc.reset()
    jc.reset()
    np.testing.assert_allclose(tc.process(x[:40 * b]).numpy(), np.asarray(jc.process(x[:40 * b])),
                               atol=ATOL)


def test_two_stage_reset_snapshot_clone():
    rng = np.random.default_rng(55)
    b = 32
    ir = (rng.standard_normal(2000) * 0.05).astype(np.float32)
    x = rng.standard_normal(40 * b).astype(np.float32)
    conv = T.TwoStageFFTConvolver(ir, b, len(ir), device="cpu")
    y1 = _chunks(conv, x, _t)
    conv.reset()
    np.testing.assert_array_equal(_chunks(conv, x, _t), y1)  # bit-equal replay

    conv.reset()
    conv.process(x[:500])
    snap = conv.snapshot()
    twin = conv.clone()
    a = conv.process(x[500:1100]).numpy()
    twin.process(x[::-1].copy())
    conv.restore(snap)
    np.testing.assert_array_equal(conv.process(x[500:1100]).numpy(), a)


def test_two_stage_errors_match_jax():
    ir = np.ones(3000, np.float32)
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.TwoStageFFTConvolver(ir, 48, len(ir), **kw)   # not a power of two
        with pytest.raises(ValueError):
            mod.TwoStageFFTConvolver(ir, 64, 100, **kw)       # IR longer than max
        conv = mod.TwoStageFFTConvolver(ir, 64, len(ir), **kw)
        with pytest.raises(NotImplementedError):
            conv.update(ir)
        with pytest.raises(ValueError):
            conv.update_extension(np.ones(3001, np.float32))


@pytest.mark.parametrize("which", ["uniform", "two_stage"])
def test_port_engines_match_recorded_golden(which):
    """The reference example's workload (as tests/test_golden.py regenerates
    it: 128k-tap IR, block 64, 1000 blocks) through the port's engines in
    one aligned call, at the golden's 1e-5."""
    from fft_convolution_tpu_torch.ops.fft import generate_sinusoid

    ir = generate_sinusoid(128_000, 1000.0, 44100, 0.1)
    x = generate_sinusoid(64 * 1000, 1300.0, 44100, 0.1)
    y = np.load(pathlib.Path(__file__).parent / "golden" / "compare_partitioned.npz")["y"]
    cls = T.FFTConvolver if which == "uniform" else T.TwoStageFFTConvolver
    got = cls(ir, 64, len(ir), device="cpu").process(x).numpy()
    err = float(np.max(np.abs(got - y)))
    assert err <= 1e-5, f"{which} vs recorded golden: {err}"
