"""The float64 reference against a direct convolution, at tiny sizes."""

import numpy as np
import torch

from portbench.reference.conv import conv_tail, conv_tail_bf16


def _direct(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    return np.stack([np.convolve(a, b)[: a.size] for a, b in zip(x, h)])


def test_conv_tail_matches_direct_convolution():
    rng = np.random.default_rng(3)
    x, h = rng.standard_normal((3, 700)), rng.standard_normal((3, 129))
    want = _direct(x, h)
    got = conv_tail(torch.from_numpy(x), torch.from_numpy(h), 700).numpy()
    assert got.dtype == np.float64
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_conv_tail_of_a_window_needs_only_the_taps_before_it():
    rng = np.random.default_rng(4)
    x, h = rng.standard_normal((2, 1000)), rng.standard_normal((2, 200))
    want = _direct(x, h)[:, 800:]
    # the 199 samples before the wanted outputs, and the outputs' own span
    got = conv_tail(torch.from_numpy(x[:, 601:]), torch.from_numpy(h), 200).numpy()
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_conv_tail_of_float32_inputs_is_float64():
    x = torch.randn(1, 300)
    h = torch.randn(1, 50)
    want = _direct(x.double().numpy(), h.double().numpy())
    got = conv_tail(x, h, 300).numpy()
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_bf16_reference_is_one_precision_down():
    rng = np.random.default_rng(5)
    x, h = rng.standard_normal((1, 4096)), rng.standard_normal((1, 512)) * 0.05
    want = _direct(x, h)
    got = conv_tail_bf16(torch.from_numpy(x).float(), torch.from_numpy(h).float(), 4096).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert 1e-4 < err < 3e-2  # bfloat16's 8 significant bits, not float32's 24
