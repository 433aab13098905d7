"""Randomized sweeps of the port's engines against the ``np.convolve``
golden — the port of ``tests/test_fuzz.py``, case for case: the same seeds,
IR lengths, block sizes, call-size patterns and mid-stream updates, and
the same tolerances (2e-5 against the golden, 1e-6 for the update mirror,
1e-5 for the crossfade's settled output).  The random call sizes cross the
batched stream (block-aligned calls), the block loop and the sub-block
chunker, so these guard the routing between them."""

import numpy as np
import pytest

from fft_convolution_tpu_torch import CrossfadeConvolver, FFTConvolver, TwoStageFFTConvolver


def _golden(x, ir):
    return np.convolve(x.astype(np.float64), ir.astype(np.float64))[: len(x)]


def _np(y):
    return y.numpy()


@pytest.mark.parametrize("seed", range(6))
def test_uniform_fuzz(seed):
    rng = np.random.default_rng(100 + seed)
    block = int(2 ** rng.integers(4, 10))            # 16..512
    ir_len = int(rng.integers(1, block * 20))
    n = int(rng.integers(1, block * 30))
    ir = (rng.standard_normal(ir_len) * 0.1).astype(np.float32)
    x = (rng.standard_normal(n) * 0.5).astype(np.float32)

    c = FFTConvolver(ir, block, ir_len, device="cpu")
    pieces, pos = [], 0
    while pos < n:
        step = int(rng.integers(1, block * 3))
        pieces.append(_np(c.process(x[pos : pos + step])))
        pos += step
    got = np.concatenate(pieces)[:n]
    np.testing.assert_allclose(got, _golden(x, ir), atol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_two_stage_fuzz(seed):
    rng = np.random.default_rng(200 + seed)
    block = int(2 ** rng.integers(4, 8))             # 16..128
    ir_len = int(rng.integers(block, block * 100))
    n_blocks = int(rng.integers(4, 80))
    ir = (rng.standard_normal(ir_len) * 0.05).astype(np.float32)
    x = (rng.standard_normal(n_blocks * block) * 0.5).astype(np.float32)

    c = TwoStageFFTConvolver(ir, block, ir_len, device="cpu")
    got = _np(c.process(x))
    np.testing.assert_allclose(got, _golden(x, ir), atol=2e-5)


@pytest.mark.parametrize("seed", range(3))
def test_uniform_update_fuzz(seed):
    """Random mid-stream IR swaps: output after each update must match the
    reference update semantics (kept input history + new IR, zeroed OLA
    tail) — checked via a mirrored pair of engines."""
    rng = np.random.default_rng(300 + seed)
    block = int(2 ** rng.integers(5, 8))
    max_len = block * int(rng.integers(2, 8))
    n_events = 6
    x_all = (rng.standard_normal(block * 40) * 0.5).astype(np.float32)

    c = FFTConvolver((rng.standard_normal(max_len) * 0.1).astype(np.float32),
                     block, max_len, device="cpu")
    mirror = c.clone()
    pos = 0
    for _ in range(n_events):
        new_ir = (rng.standard_normal(int(rng.integers(1, max_len + 1))) * 0.1
                  ).astype(np.float32)
        c.update(new_ir)
        mirror.update(new_ir)
        step = block * int(rng.integers(1, 5))
        ya = _np(c.process(x_all[pos : pos + step]))
        yb = _np(mirror.process(x_all[pos : pos + step]))
        np.testing.assert_allclose(ya, yb, atol=1e-6)
        pos += step


@pytest.mark.parametrize("seed", range(2))
def test_crossfade_fuzz(seed):
    """Random update cadence through the crossfade wrapper stays bounded and
    converges to the latest IR's steady state."""
    rng = np.random.default_rng(400 + seed)
    block = 128
    max_len = 512
    ir0 = (rng.standard_normal(max_len) * 0.1).astype(np.float32)
    cc = CrossfadeConvolver(FFTConvolver(ir0, block, max_len, device="cpu"),
                            max_len, block, 256)
    last_ir = ir0
    x = (rng.standard_normal(block * 64) * 0.5).astype(np.float32)
    for i in range(32):
        if rng.random() < 0.3:
            last_ir = (rng.standard_normal(max_len) * 0.1).astype(np.float32)
            cc.update(last_ir)
        cc.process(x[i * block : (i + 1) * block])
    # settle: no more updates; fades + pending swaps drain within
    # hold + fade (< 6 blocks), then output equals a fresh engine's
    for i in range(32, 56):
        y = cc.process(x[i * block : (i + 1) * block])
    ref = FFTConvolver(last_ir, block, max_len, device="cpu")
    ref.process(x[: 56 * block])
    y_ref = _np(ref.process(x[56 * block : 57 * block]))
    y = _np(cc.process(x[56 * block : 57 * block]))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
