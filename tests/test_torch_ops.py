"""The PyTorch port's L0 ops against the JAX package on the same inputs.

Inputs come from numpy seeds and go to both packages; spectra are compared
after moving the JAX package's packed halfcomplex layout to complex64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_convolution_tpu.models import uniform as juniform
from fft_convolution_tpu.ops import fft as jfft
from fft_convolution_tpu.ops import spectral as jspectral
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.ops import fft as tfft
from fft_convolution_tpu_torch.ops import spectral as tspectral

# Two float32 DFTs of the same block (the JAX package's float32 basis matmul
# at HIGHEST precision and pocketfft) differ by float32 rounding that grows
# with the transform length, a few 1e-6 of the spectrum's largest magnitude
# at 256 points; 1e-5 of that magnitude still catches any wrong bin, sign or
# normalisation.
SPEC_RTOL = 1e-5


def _c(packed) -> torch.Tensor:
    return tfft.packed_to_complex(torch.from_numpy(np.array(packed)))


def _assert_spec_close(got: torch.Tensor, want: torch.Tensor, msg="") -> None:
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= SPEC_RTOL * scale, f"{msg} err {err} at scale {scale}"


@pytest.mark.parametrize("n", [0, 1, 2, 3, 64, 100, 128, 129, 4097])
def test_size_helpers_match_jax(n):
    assert tfft.next_power_of_two(n) == jfft.next_power_of_two(n)
    assert tfft.complex_size(n) == jfft.complex_size(n)


def test_copy_and_pad_and_sinusoid_match_jax():
    rng = np.random.default_rng(40)
    src = rng.standard_normal((3, 70)).astype(np.float32)
    got = tfft.copy_and_pad(torch.from_numpy(src), 128).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfft.copy_and_pad(src, 128)))
    with pytest.raises(ValueError):
        tfft.copy_and_pad(torch.from_numpy(src), 69)
    np.testing.assert_array_equal(tfft.generate_sinusoid(1000, 1000.0, 44100, 0.1),
                                  jfft.generate_sinusoid(1000, 1000.0, 44100, 0.1))


@pytest.mark.parametrize("b", [1, 8, 64, 128])
def test_packed_complex_round_trip(b):
    """packed -> complex -> packed is exact, and the Nyquist bin (im[0]) lands
    in bin B; the converters hold at <= 1e-6 (they only move values)."""
    rng = np.random.default_rng(41 + b)
    packed = torch.from_numpy(rng.standard_normal((5, 2, b)).astype(np.float32))
    spec = tfft.packed_to_complex(packed)
    assert spec.shape == (5, b + 1) and spec.dtype == torch.complex64
    np.testing.assert_array_equal(spec.real[:, b].numpy(), packed[:, 1, 0].numpy())
    assert float(spec.imag[:, 0].abs().max()) == 0.0
    assert float(spec.imag[:, b].abs().max()) == 0.0
    back = tfft.complex_to_packed(spec)
    assert float((back - packed).abs().max()) <= 1e-6
    # and from a real signal's spectrum (zero imaginary DC/Nyquist) back again
    x = torch.from_numpy(rng.standard_normal((4, 2 * b)).astype(np.float32))
    s = torch.fft.rfft(x)
    assert float((tfft.packed_to_complex(tfft.complex_to_packed(s)) - s).abs().max()) <= 1e-6


@pytest.mark.parametrize("b,segs", [(64, 3), (128, 5)])
def test_ir_to_spectra_matches_jax(b, segs):
    rng = np.random.default_rng(42)
    ir = (rng.standard_normal(b * segs) * 0.1).astype(np.float32)
    want = _c(jfft.ir_to_spectra(jnp.asarray(ir), b, segs))
    got = tfft.ir_to_spectra(torch.from_numpy(ir), b, segs)
    assert got.shape == (segs, b + 1)
    _assert_spec_close(got, want)


def test_fft_class_matches_jax():
    rng = np.random.default_rng(43)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    jf, tf = jfft.Fft(256), tfft.Fft(256)
    spec = tf.forward(x)
    _assert_spec_close(spec, _c(jf.forward(x)))
    # 1/n on the inverse: the round trip is the identity in both packages
    np.testing.assert_allclose(tf.inverse(spec).numpy(), x, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jf.inverse(jf.forward(x))), x, atol=1e-6)
    for bad in (3, 1):
        with pytest.raises(ValueError):
            jfft.Fft(bad)
        with pytest.raises(ValueError):
            tfft.Fft(bad)


def test_fdl_mac_after_shrinking_update():
    """After an update to a shorter IR the ring index runs modulo the new
    active count, with the kept history and `current` possibly past it."""
    rng = np.random.default_rng(44)
    b, n = 32, 7
    ir = (rng.standard_normal(b * n) * 0.1).astype(np.float32)
    cfg, js = juniform.init(ir, b, len(ir))
    for _ in range(3):  # current: 0 -> 6 -> 5 -> 4
        js, _ = juniform.process_block(cfg, js, jnp.asarray(
            rng.standard_normal(b).astype(np.float32)))
    short = np.zeros(b * n, np.float32)
    short[: 2 * b + 5] = (rng.standard_normal(2 * b + 5) * 0.1).astype(np.float32)
    js = juniform.update(cfg, js, jnp.asarray(short), jnp.asarray(2 * b + 5, jnp.int32))
    assert int(js.active_segs) == 3 and int(js.current) == 4  # current past active
    ts = interop.uniform_state(js)
    for _ in range(4):  # walk the ring through its wrap at active - 1
        cur, act = int(js.current), int(js.active_segs)
        want = _c(jspectral.fdl_mac(js.segments, js.segments_ir, js.current, js.active_segs))
        got = tspectral.fdl_mac(ts.segments, ts.segments_ir, cur, act)
        _assert_spec_close(got, want, f"current {cur}")
        js, _ = juniform.process_block(cfg, js, jnp.asarray(
            rng.standard_normal(b).astype(np.float32)))
        ts = interop.uniform_state(js)
    assert tspectral.fdl_mac(ts.segments, ts.segments_ir, 0, 1).abs().max() == 0


def test_causal_conv_multi_matches_per_kernel_calls():
    """``causal_conv_multi`` (one forward transform, the products stacked
    under one inverse) equals per-kernel ``causal_conv_time`` calls, with
    raw kernels and with precomputed meta-spectra, and the JAX package's
    ``causal_conv_multi`` on the same spectra (``tests/test_meta_dft.py:109``)."""
    rng = np.random.default_rng(93)
    b, n, t = 128, 16, 48
    m = 128  # >= t + 2n - 1, a power of two
    ext = torch.fft.rfft(torch.from_numpy(
        rng.standard_normal((n + t, 2 * b)).astype(np.float32) * 0.3))
    kerns = [torch.fft.rfft(torch.from_numpy(rng.standard_normal((rows, 2 * b))
                                             .astype(np.float32))) for rows in (2 * n, n)]
    windows = [(n, t), (0, n + t)]
    multi = tfft.causal_conv_multi(ext, kerns, windows, m=m)
    for kern, (r0, cnt), got in zip(kerns, windows, multi):
        assert got.shape == (cnt, b + 1)
        want = tfft.causal_conv_time(ext, kern, cnt, m=m, row0=r0)
        _assert_spec_close(got, want, f"window {(r0, cnt)}")
    hats = [tfft.causal_conv_khat(k, m) for k in kerns]
    for a, c in zip(multi, tfft.causal_conv_multi(ext, [None, None], windows, m=m,
                                                   kern_hats=hats)):
        assert torch.equal(a, c)
    jmulti = jfft.causal_conv_multi(jnp.asarray(tfft.complex_to_packed(ext).numpy()),
                                    [jnp.asarray(tfft.complex_to_packed(k).numpy())
                                     for k in kerns], windows, m=m)
    for got, want in zip(multi, jmulti):
        _assert_spec_close(got, _c(want), "vs JAX")
    with pytest.raises(ValueError, match="meta-bins"):
        tfft.causal_conv_multi(ext, [None], [(0, 4)], m=2 * m, kern_hats=hats[:1])
