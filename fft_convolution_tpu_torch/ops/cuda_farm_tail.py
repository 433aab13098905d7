"""Kernel B7: the reverb farm's big-tail transforms, hand-written in CUDA C++
for Hopper (``csrc/b7_farm_tail.cu``).  It replaces no TPU kernel: the JAX
package runs these transforms as jnp around its Pallas B5
(``fft_convolution_tpu/parallel/farm2.py:666``, ``_tail_corr_phased_fused``).

Around kernel B5 a farm call of ``q`` tail periods makes two launches:

* :func:`tail_forward`: ``blocks [T, V, B]`` (``T = q p`` head blocks, ``p =
  tb / B`` a period) to ``specs [q, V, tb+1]`` complex64, the rDFT of each
  tail row (the ``p`` head blocks of a voice in one period) zero-padded to
  ``2 tb``: what :func:`..ops.cuda_farm_mac.phased_step` takes.
* :func:`tail_inverse`: ``convs [q, V, tb+1]`` (B5's output) to ``y [q, V,
  tb]`` float32: each row's irDFT of length ``2 tb`` (``1/2tb``; the
  imaginary parts of the DC and Nyquist bins not read, as
  ``torch.fft.irfft``), its first half plus the carry, which starts as
  ``overlap [V, tb]`` and becomes the row's second half; the last row's
  second half is written to ``overlap`` in place.

Each launches the kernel for CUDA tensors and takes the plain PyTorch
version (:func:`tail_forward_plain`, :func:`tail_inverse_plain`) only for
CPU tensors; it never falls back.  ``.launches`` counts the launches of
each.  The plain versions run on any device.

Limits of the kernel (:func:`tail_plan`): a power-of-two tail block of
:data:`MIN_TB` to :data:`MAX_TB` samples and a power-of-two head block of
at least 2 samples; :func:`..parallel.farm2.farm2_init` checks the tail
block when it builds a farm on the card.
"""

from __future__ import annotations

import torch

from .. import _build
from .cuda_engine import require
from .fft import cached_twiddles, irdft_block, rdft_block

MIN_TB, MAX_TB = 64, 131072  # the tail blocks the kernel is built for
MAX_POINTS = 16384           # complex points of one CTA's FFT


def tail_plan(tb: int) -> tuple[int, int]:
    """``(M, R)`` for tail block ``tb``: a row's ``tb``-point complex FFT of
    sample pairs runs on a cluster of ``R = max(2, tb / MAX_POINTS)`` CTAs of
    ``M = tb / R`` points each.  Raises ``ValueError`` for a tail block the
    kernel cannot run."""
    if tb < 1 or tb & (tb - 1):
        raise ValueError(f"B7 takes a power-of-two tail block, got {tb}")
    if not MIN_TB <= tb <= MAX_TB:
        raise ValueError(f"B7 takes tail blocks of {MIN_TB} to {MAX_TB} samples, got {tb}")
    r = max(2, tb // MAX_POINTS)
    return tb // r, r


def _rows(blocks: torch.Tensor, tb: int) -> tuple[int, int, int]:
    """``(q, V, B)`` of ``blocks [T, V, B]`` cut into tail rows of ``tb``."""
    if blocks.ndim != 3:
        raise ValueError(f"blocks must be [T, V, B], got {tuple(blocks.shape)}")
    t, v, b = blocks.shape
    if b < 2 or b & (b - 1) or b > tb:
        raise ValueError(f"B7 takes a power-of-two head block of 2 to {tb} samples, got {b}")
    p = tb // b
    if t < p or t % p:
        raise ValueError(f"T={t} must be a positive multiple of the period {p}")
    return t // p, v, b


def tail_forward_plain(blocks: torch.Tensor, tb: int) -> torch.Tensor:
    """The plain version of :func:`tail_forward`, on any device: the rows
    gathered into ``[q, V, tb]``, then their rDFT."""
    q, v, b = _rows(blocks, tb)
    rows = blocks.reshape(q, tb // b, v, b).transpose(1, 2).reshape(q, v, tb)
    return rdft_block(rows, 2 * tb).contiguous()


def tail_inverse_plain(convs: torch.Tensor, overlap: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`tail_inverse`, on any device: the irDFT of
    every row, then the overlap-add and the carry."""
    tb = overlap.shape[-1]
    outs = irdft_block(convs, 2 * tb)                                   # [q, V, 2tb]
    y = outs[:, :, :tb] + torch.cat([overlap[None], outs[:-1, :, tb:]])
    overlap.copy_(outs[-1, :, tb:])
    return y


def tail_forward(blocks: torch.Tensor, tb: int) -> torch.Tensor:
    """The forward launch (module docstring); CPU tensors take
    :func:`tail_forward_plain`.  Returns ``specs [q, V, tb+1]``."""
    if blocks.device.type == "cpu":
        return tail_forward_plain(blocks, tb)
    tail_plan(tb)
    q, v, b = _rows(blocks, tb)
    dev = blocks.device
    require(blocks, "blocks", (q * tb // b, v, b), torch.float32, dev)
    specs = torch.empty((q, v, tb + 1), dtype=torch.complex64, device=dev)
    err = _build.kernel("fdl_b7_tail_fwd")(
        blocks.data_ptr(), cached_twiddles(2 * tb, dev).data_ptr(), specs.data_ptr(), v, b, tb,
        q, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fdl_b7_tail_fwd")
    tail_forward.launches += 1
    return specs


def tail_inverse(convs: torch.Tensor, overlap: torch.Tensor) -> torch.Tensor:
    """The inverse launch (module docstring); CPU tensors take
    :func:`tail_inverse_plain`.  Returns ``y [q, V, tb]``; ``overlap`` is
    updated in place."""
    if convs.device.type == "cpu":
        return tail_inverse_plain(convs, overlap)
    if convs.ndim != 3 or overlap.ndim != 2:
        raise ValueError(f"want convs [q, V, tb+1] and overlap [V, tb], got "
                         f"{tuple(convs.shape)} and {tuple(overlap.shape)}")
    (q, v), tb = convs.shape[:2], overlap.shape[1]
    tail_plan(tb)
    dev = convs.device
    if q < 1:
        raise ValueError("convs has no rows")
    require(convs, "convs", (q, v, tb + 1), torch.complex64, dev)
    require(overlap, "overlap", (v, tb), torch.float32, dev)
    y = torch.empty((q, v, tb), device=dev)
    err = _build.kernel("fdl_b7_tail_inv")(
        convs.data_ptr(), cached_twiddles(2 * tb, dev).data_ptr(), y.data_ptr(),
        overlap.data_ptr(), v, tb, q, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fdl_b7_tail_inv")
    tail_inverse.launches += 1
    return y


tail_forward.launches = 0
tail_inverse.launches = 0
