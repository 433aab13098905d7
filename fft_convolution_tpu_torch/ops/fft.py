"""Real-DFT contract helpers on ``torch.fft`` — counterpart of the contract
part of ``fft_convolution_tpu/ops/fft.py`` (the reference's L0 layer,
``src/fft_convolver.rs:8-84``).

Spectra are ``complex64`` tensors of ``B + 1`` bins from ``torch.fft.rfft``
of the ``2B``-point zero-padded block.  Normalisation matches the
reference: unnormalised forward, ``1/n`` on the inverse.

The JAX package stores spectra in a packed halfcomplex layout
``[..., 2, B]`` (``re[0]`` is DC, ``im[0]`` holds the real Nyquist bin)
because its TPU backend has no complex dtype.  :func:`packed_to_complex`
and :func:`complex_to_packed` convert between the two layouts for the
tests and for :mod:`..interop`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def complex_size(size: int) -> int:
    """Number of rFFT bins for a real transform of length ``size``
    (``complex_size``, ``src/fft_convolver.rs:52-54``)."""
    return size // 2 + 1


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (n=0 -> 1), matching Rust's
    ``usize::next_power_of_two`` (``src/fft_convolver.rs:115,525``)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def copy_and_pad(src: torch.Tensor, total: int) -> torch.Tensor:
    """Copy ``src`` and zero-fill its last axis to length ``total``
    (``copy_and_pad``, ``src/fft_convolver.rs:56-60``)."""
    if src.shape[-1] > total:
        raise ValueError(f"src longer ({src.shape[-1]}) than pad target {total}")
    return torch.nn.functional.pad(src, (0, total - src.shape[-1]))


def ir_to_spectra(ir_padded: torch.Tensor, block_size: int,
                  seg_count: int) -> torch.Tensor:
    """Partition an IR into ``seg_count`` blocks and transform each,
    zero-padded to ``2 * block_size`` (``src/fft_convolver.rs:131-142``).
    Returns ``complex64 [seg_count, block_size + 1]``."""
    segs = ir_padded.to(torch.float32).reshape(seg_count, block_size)
    return torch.fft.rfft(segs, n=2 * block_size)


def generate_sinusoid(num_samples: int, freq: float, sample_rate: float,
                      gain: float) -> np.ndarray:
    """Test-signal generator mirroring ``examples/util/mod.rs:7-19`` /
    ``src/tests.rs:9-16`` (computed in float64, cast to float32)."""
    i = np.arange(num_samples, dtype=np.float64)
    return (gain * np.sin(2.0 * np.pi * freq * i / sample_rate)).astype(np.float32)


def packed_to_complex(packed: torch.Tensor) -> torch.Tensor:
    """JAX halfcomplex ``[..., 2, B]`` (``im[0]`` = Nyquist) ->
    ``complex64 [..., B + 1]``."""
    re, im = packed[..., 0, :], packed[..., 1, :]
    zero = torch.zeros_like(re[..., :1])
    re_full = torch.cat([re, im[..., :1]], dim=-1)          # bin B <- im[0]
    im_full = torch.cat([zero, im[..., 1:], zero], dim=-1)  # DC, Nyquist real
    return torch.complex(re_full, im_full)


def complex_to_packed(spec: torch.Tensor) -> torch.Tensor:
    """``complex64 [..., B + 1]`` -> JAX halfcomplex ``[..., 2, B]``.  The
    imaginary parts of the DC and Nyquist bins are dropped (zero for the
    spectrum of a real signal)."""
    re = spec.real[..., :-1]
    im = torch.cat([spec.real[..., -1:], spec.imag[..., 1:-1]], dim=-1)
    return torch.stack([re, im], dim=-2)


@functools.lru_cache(maxsize=None)
def _twiddle_host(fft_size: int) -> np.ndarray:
    """``[fft_size, 2]`` float32 table of ``(cos, sin)(2 pi m / fft_size)``,
    computed in float64 as the JAX package builds its DFT bases
    (``fft_convolution_tpu/ops/fft.py:104-130``)."""
    ang = 2.0 * np.pi * np.arange(fft_size, dtype=np.float64) / fft_size
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def twiddles(fft_size: int, device) -> torch.Tensor:
    """The DFT twiddle table the hand-written kernels read (one row per
    exponent ``m``, indexed by ``(k * n) mod fft_size``)."""
    return torch.from_numpy(_twiddle_host(fft_size)).to(device)


class Fft:
    """Plan-style wrapper over ``torch.fft`` — the public surface of the
    reference's ``Fft`` struct (``src/fft_convolver.rs:29-50``):
    ``init``/``forward``/``inverse`` with a ``1/len``-normalised inverse.

    Lengths must be even and >= 2, as in the JAX package (PARITY.md
    divergence 4); its power-of-two rule above 1024 existed only for the
    TPU's four-step matmul DFT and is not carried."""

    def __init__(self, length: int = 0):
        self.length = 0
        self.init(length)

    def init(self, length: int) -> None:
        if length and (length < 2 or length % 2):
            raise ValueError("transform length must be even and >= 2")
        self.length = length

    def forward(self, x) -> torch.Tensor:
        """Unnormalised forward transform -> ``complex64 [..., length//2 + 1]``."""
        x = torch.as_tensor(x, dtype=torch.float32)
        return torch.fft.rfft(x, n=self.length)

    def inverse(self, spec) -> torch.Tensor:
        """Inverse transform with ``1/len`` normalisation -> ``[..., length]``."""
        spec = torch.as_tensor(spec, dtype=torch.complex64)
        return torch.fft.irfft(spec, n=self.length)
