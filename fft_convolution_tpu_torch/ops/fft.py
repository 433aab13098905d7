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


def rdft_block(x: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Forward real DFT of each block (last axis) zero-padded to
    ``fft_size``; leading axes batch.  Counterpart of ``rdft_block``
    (``fft_convolution_tpu/ops/fft.py:655``): ``complex64 [...,
    fft_size // 2 + 1]``."""
    if x.shape[-1] > fft_size:
        raise ValueError(f"input length {x.shape[-1]} exceeds fft_size {fft_size}")
    return torch.fft.rfft(x.to(torch.float32), n=fft_size)


def irdft_block(spec: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Inverse real DFT with ``1/n`` normalisation, leading axes batched —
    counterpart of ``irdft_block`` and ``irdft_pair``
    (``fft_convolution_tpu/ops/fft.py:688,697``; the pair form exists there
    only for a planes-outer layout, which complex bins do not have)."""
    return torch.fft.irfft(spec, n=fft_size)


def causal_conv_khat(kern: torch.Tensor, m: int) -> torch.Tensor:
    """The input-independent half of :func:`causal_conv_time`: the kernel
    table's DFT along the block axis (dim -2), zero-padded to ``m``
    meta-bins — counterpart of ``causal_conv_khat``
    (``fft_convolution_tpu/ops/fft.py:424``).  ``kern`` is ``complex64
    [..., N, B+1]``; returns ``complex64 [..., m, B+1]``, stored bins-major
    (the transpose of a contiguous ``[..., B+1, m]``, the layout
    :func:`causal_conv_time` multiplies in).  Precompute it once per (table,
    m) and pass it as ``kern_hat=``."""
    return torch.fft.fft(kern.mT, n=m, dim=-1).mT


def causal_conv_time(ext: torch.Tensor, kern: torch.Tensor, t_out: int,
                     kern_hat: torch.Tensor | None = None, m: int | None = None,
                     row0: int | None = None) -> torch.Tensor:
    """``out[t] = sum_i kern[i] * ext[row0 + t - i]``: the frequency-delay
    line's MAC over a whole stream as one circular convolution along the
    block axis, by a complex DFT of length ``m`` (overlap-save at the meta
    level) — counterpart of ``causal_conv_time``
    (``fft_convolution_tpu/ops/fft.py:441``).

    ``ext``: ``complex64 [..., Lt, B+1]`` (block history, then the new
    blocks); ``kern``: ``complex64 [..., N, B+1]``.  Each bin is one complex
    sequence along the block axis, so the product of the two meta-spectra
    is the whole spectral product; the JAX package's lane-0 (DC/Nyquist)
    correction exists only for its packed halfcomplex layout and has no
    counterpart here.

    ``kern_hat``: :func:`causal_conv_khat` of ``kern`` at this ``m``.
    ``m``: meta-DFT size, a power of two ``>= Lt`` (default the smallest);
    callers whose rows would read wrapped indices size it so the reads land
    in the zero pad.  ``row0``: first output row (default ``N - 1``, the
    full-history position).  Returns ``complex64 [..., t_out, B+1]``, a
    view of bins-major storage.

    The block-axis transforms run bins-major (``[..., B+1, m]``, the
    transform axis contiguous): cuFFT along a strided dim -2 took 2-2.7x
    the time of the same rows laid out along dim -1 (``chip_smoke.py``
    phase 15).  The zero pad to ``m`` writes the transposed copy.
    """
    lt, n = ext.shape[-2], kern.shape[-2]
    if m is None:
        m = next_power_of_two(lt)
    elif m < lt or m & (m - 1):
        raise ValueError(f"m={m} must be a power of two >= len(ext)={lt}")
    khat = causal_conv_khat(kern, m) if kern_hat is None else kern_hat
    if khat.shape[-2] != m:
        raise ValueError(f"kern_hat was built for m={khat.shape[-2]} meta-bins "
                         f"but this call needs m={m}")
    r0 = n - 1 if row0 is None else row0
    out = torch.fft.ifft(torch.fft.fft(ext.mT, n=m, dim=-1) * khat.mT, dim=-1)
    return out[..., r0:r0 + t_out].mT


def causal_conv_multi(ext: torch.Tensor, kerns: list, windows: list[tuple[int, int]],
                      m: int | None = None, kern_hats: list | None = None) -> list:
    """Several :func:`causal_conv_time` convolutions against one shared
    ``ext``: one forward DFT of ``ext`` along the block axis, each kernel's
    meta-spectrum multiplied in, one inverse over the stacked products —
    counterpart of ``causal_conv_multi``
    (``fft_convolution_tpu/ops/fft.py:550``).

    ``kerns``: raw kernel tables ``complex64 [..., N_i, B+1]``;
    ``kern_hats``: optional list of the same length whose non-None entries
    (:func:`causal_conv_khat` at this ``m``) replace their kernel's DFT
    (that kernel may then be None).  ``windows``: one ``(row0, count)``
    output window a kernel, ``row0`` as in :func:`causal_conv_time`; the
    caller sizes ``m`` so that every window's reads before row 0 land in the
    zero pad.  The inverse keeps the union of the windows, and each result
    is a bins-major view sliced from it: ``complex64 [..., count_i, B+1]``,
    equal to ``causal_conv_time(ext, kerns[i], count_i, m=m, row0=row0_i)``."""
    if len(kerns) != len(windows) or not kerns:
        raise ValueError(f"{len(kerns)} kernels for {len(windows)} windows")
    hats = kern_hats if kern_hats is not None else [None] * len(kerns)
    lt = ext.shape[-2]
    if m is None:
        m = next_power_of_two(lt)
    elif m < lt or m & (m - 1):
        raise ValueError(f"m={m} must be a power of two >= len(ext)={lt}")
    ehat = torch.fft.fft(ext.mT, n=m, dim=-1)                   # [..., B+1, m]
    prods = []
    for kern, khat in zip(kerns, hats):
        if khat is None:
            khat = causal_conv_khat(kern, m)
        elif khat.shape[-2] != m:
            raise ValueError(f"kern_hat was built for m={khat.shape[-2]} meta-bins "
                             f"but this call needs m={m}")
        prods.append(ehat * khat.mT)
    lo = min(r0 for r0, _ in windows)
    hi = max(r0 + cnt for r0, cnt in windows)
    out = torch.fft.ifft(torch.stack(prods), dim=-1)[..., lo:hi]
    return [out[i, ..., r0 - lo:r0 - lo + cnt].mT for i, (r0, cnt) in enumerate(windows)]


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


_TWIDDLES: dict = {}


def cached_twiddles(fft_size: int, device: torch.device) -> torch.Tensor:
    """:func:`twiddles`, kept on the device: one copy per size and device,
    for the farm's kernels, which take no constants object."""
    key = (fft_size, device)
    if key not in _TWIDDLES:
        _TWIDDLES[key] = twiddles(fft_size, device)
    return _TWIDDLES[key]


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
