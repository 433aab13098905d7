"""Spectral multiply-accumulate over the frequency-delay line — counterpart
of ``fft_convolution_tpu/ops/spectral.py`` (the reference's
``complex_multiply_accumulate`` looped over partitions,
``src/fft_convolver.rs:62-74,244-261``)."""

from __future__ import annotations

import torch


def fdl_mac(segments: torch.Tensor, segments_ir: torch.Tensor,
            current: int, active: int) -> torch.Tensor:
    """``pre_multiplied`` reduction over partitions ``1..active-1``:
    ``sum_i segments_ir[i] * segments[(current + i) % active]``
    (``src/fft_convolver.rs:244-255``).

    The partition axis is dim -2 (``[..., N, B + 1]``); leading axes batch
    (a farm's voices).  The ring index is taken modulo ``active``, not
    ``seg_count``: after an ``update`` to a shorter IR the kept history is
    re-indexed modulo the new active count, as in the reference.  Returns
    ``complex64 [..., B + 1]``.
    """
    if active <= 1:
        return torch.zeros_like(segments[..., 0, :])
    idx = (current + torch.arange(1, active, device=segments.device)) % active
    return (segments_ir[..., 1:active, :] * segments[..., idx, :]).sum(dim=-2)
