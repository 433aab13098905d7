"""The reference crate's own test suite, run on the PyTorch port — the
counterparts of ``tests/test_uniform.py`` and ``tests/test_two_stage.py``
(which hold the JAX package to the same contracts).

Reference tests reproduced:
* ``test_fft_convolver_passthrough``           (``src/fft_convolver.rs:309-321``)
* ``test_fft_twostage_convolver_passthrough``  (``src/fft_convolver.rs:528-540``)
* ``fft_convolver_update_is_reset``            (``src/tests.rs:18-59``)
* ``block_size_equal``                         (``src/tests.rs:119-146``)
* ``twostage_equal``                           (``src/tests.rs:148-175``)
* ``reset_fftconvolver`` / ``reset_twostagefftconvolver`` (``src/tests.rs:177-257``)
Tolerances are the reference's own: 1e-6 on a single block, 1e-5 over a
1000-block stream (``src/tests.rs:58,126``).
"""

import numpy as np
import pytest
import torch

from fft_convolution_tpu_torch import FFTConvolver, TwoStageFFTConvolver
from fft_convolution_tpu_torch.ops import Fft, complex_size, copy_and_pad
from fft_convolution_tpu_torch.ops.fft import generate_sinusoid

SAMPLE_RATE = 44100.0
ENGINES = {"uniform": FFTConvolver, "two_stage": TwoStageFFTConvolver}


def _np(y: torch.Tensor) -> np.ndarray:
    return y.numpy()


def _direct(x, ir, n):
    return np.convolve(x.astype(np.float64), ir.astype(np.float64))[:n]


@pytest.mark.parametrize("engine", ENGINES)
def test_passthrough(engine):
    """δ-impulse IR ⇒ identity, tol 1e-6."""
    response = np.zeros(1024, np.float32)
    response[0] = 1.0
    conv = ENGINES[engine](response, 1024, len(response))
    np.testing.assert_allclose(_np(conv.process(np.ones(1024, np.float32))), 1.0, atol=1e-6)


@pytest.mark.parametrize("engine,ir_len,n,seed", [
    ("uniform", 300, 1024, 0), ("two_stage", 5000, 64 * 40, 5),
    ("two_stage", 100, 512, 7),  # shorter than the tail block: no tail stages
])
def test_golden_direct_convolution(engine, ir_len, n, seed):
    rng = np.random.default_rng(seed)
    ir = rng.standard_normal(ir_len).astype(np.float32) * 0.05
    x = rng.standard_normal(n).astype(np.float32)
    y = _np(ENGINES[engine](ir, 64, len(ir)).process(x))
    np.testing.assert_allclose(y, _direct(x, ir, n), atol=1e-5)


def test_update_is_reset():
    """``update(new_ir)`` mid-stream matches a fresh convolver of the new IR
    for single-segment IRs."""
    block = 512
    a = generate_sinusoid(block, 1000.0, SAMPLE_RATE, 1.0)
    b = generate_sinusoid(block, 2000.0, SAMPLE_RATE, 0.7)
    conv_a, conv_b, conv_u = (FFTConvolver(r, block, block) for r in (a, b, a))
    x = generate_sinusoid(16 * block, 1300.0, SAMPLE_RATE, 1.0)
    for i in range(16):
        if i == 8:
            conv_u.update(b)
        chunk = x[i * block:(i + 1) * block]
        out_u = _np(conv_u.process(chunk))
        want = conv_a if i < 8 else conv_b
        np.testing.assert_allclose(_np(want.process(chunk)), out_u, atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_block_size_equal(engine):
    """Uniform: block 64 == block 128 on a 128-tap IR; two-stage: block 64
    == uniform block 32 on a 12,000-tap IR; 1000 blocks each."""
    if engine == "uniform":
        block, ir = 128, generate_sinusoid(128, 1000.0, SAMPLE_RATE, 0.1)
        a, b = FFTConvolver(ir, block // 2, len(ir)), FFTConvolver(ir, block, len(ir))
    else:
        block, ir = 64, generate_sinusoid(12000, 1000.0, SAMPLE_RATE, 0.1)
        a, b = FFTConvolver(ir, block // 2, len(ir)), TwoStageFFTConvolver(ir, block, len(ir))
    x = generate_sinusoid(1000 * block, 1300.0, SAMPLE_RATE, 0.1)
    np.testing.assert_allclose(_np(a.process(x)), _np(b.process(x)), atol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_reset_repeatable(engine):
    response = generate_sinusoid(12000, 1000.0, SAMPLE_RATE, 0.1)
    conv = ENGINES[engine](response, 64, len(response))
    x = generate_sinusoid(1000 * 64, 1300.0, SAMPLE_RATE, 0.1)
    out_a = _np(conv.process(x))
    conv.reset()
    np.testing.assert_allclose(out_a, _np(conv.process(x)), atol=1e-5)


@pytest.mark.parametrize("engine,block,sizes", [
    ("uniform", 128, [1, 7, 128, 13, 200, 64, 500, 300, 835]),
    ("two_stage", 64, [1, 63, 64, 30, 34, 17, 47] + [64] * 28),
])
def test_subblock_chunking_matches_block_aligned(engine, block, sizes):
    rng = np.random.default_rng(6)
    ir = rng.standard_normal(4000).astype(np.float32) * 0.05
    n = sum(sizes)
    x = rng.standard_normal(n).astype(np.float32)
    y_ref = _np(ENGINES[engine](ir, block, len(ir)).process(x))
    odd = ENGINES[engine](ir, block, len(ir))
    pos, pieces = 0, []
    for s in sizes:
        pieces.append(_np(odd.process(x[pos:pos + s])))
        pos += s
    np.testing.assert_allclose(np.concatenate(pieces), y_ref, atol=1e-5)


def test_update_shrinks_active_segments():
    rng = np.random.default_rng(2)
    ir_long = rng.standard_normal(512).astype(np.float32) * 0.1
    ir_short = rng.standard_normal(100).astype(np.float32) * 0.1
    x = rng.standard_normal(1024).astype(np.float32)
    c = FFTConvolver(ir_long, 64, 512)
    c.update(ir_short)
    np.testing.assert_allclose(_np(c.process(x)), _direct(x, ir_short, 1024), atol=1e-5)


def test_update_midstream_keeps_history_analytic_golden():
    """Mid-stream multi-segment update: the input ring is kept (past input
    convolves with the NEW IR) while the one-block overlap is cleared, so
    the first post-update block misses the spill of every (input block,
    segment) pair (``src/fft_convolver.rs:174-213``)."""
    rng = np.random.default_rng(17)
    B, maxr = 128, 768
    ir = rng.standard_normal(512).astype(np.float32) * 0.05
    ir2 = rng.standard_normal(520).astype(np.float32) * 0.05
    n_pre = n_post = 8 * B
    x = rng.standard_normal(n_pre + n_post).astype(np.float32)
    eng = FFTConvolver(ir, B, maxr)
    eng.process(x[:n_pre])
    eng.update(np.pad(ir2, (0, maxr - ir2.size)))   # active stays 6
    y = _np(eng.process(x[n_pre:]))
    g = np.convolve(x.astype(np.float64), ir2.astype(np.float64))[n_pre:n_pre + n_post]
    spill = np.zeros(B - 1)
    for i in range(maxr // B):
        seg = np.zeros(B)
        seg[: max(0, min(B, ir2.size - i * B))] = ir2[i * B:(i + 1) * B]
        lo = n_pre - B - i * B
        spill += np.convolve(x[lo:lo + B].astype(np.float64), seg)[B:]
    g[: B - 1] -= spill
    np.testing.assert_allclose(y, g, atol=1e-5)


def test_block_size_rounded_to_power_of_two():
    rng = np.random.default_rng(3)
    ir = rng.standard_normal(256).astype(np.float32) * 0.1
    x = rng.standard_normal(512).astype(np.float32)
    np.testing.assert_allclose(_np(FFTConvolver(ir, 100, 256).process(x)),
                               _np(FFTConvolver(ir, 128, 256).process(x)), atol=1e-6)


def test_contract_violations_raise():
    with pytest.raises(ValueError):
        FFTConvolver(np.ones(100, np.float32), 64, 50)
    conv = FFTConvolver(np.ones(100, np.float32), 64, 100)
    with pytest.raises(ValueError):
        conv.update(np.ones(101, np.float32))
    with pytest.raises(NotImplementedError):
        TwoStageFFTConvolver(np.ones(64, np.float32), 64, 64).update(np.ones(64, np.float32))


def test_fft_plan_wrapper_surface():
    """L0 public surface: Fft init/forward/inverse round trip
    (``src/fft_convolver.rs:29-50``) and the helpers."""
    assert complex_size(256) == 129
    rng = np.random.default_rng(80)
    for n in (256, 100):
        x = rng.standard_normal(n).astype(np.float32)
        spec = Fft(n).forward(x)
        assert spec.shape == (complex_size(n),)
        np.testing.assert_allclose(spec.numpy(), np.fft.rfft(x.astype(np.float64)), atol=1e-4)
        np.testing.assert_allclose(Fft(n).inverse(spec).numpy(), x, atol=1e-5)
    padded = copy_and_pad(torch.from_numpy(x[:60]), 100).numpy()
    np.testing.assert_array_equal(padded[:60], x[:60])
    np.testing.assert_array_equal(padded[60:], 0)
    with pytest.raises(ValueError):
        Fft(101)  # odd (PARITY.md divergence 4)
