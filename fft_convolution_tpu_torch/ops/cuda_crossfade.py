"""Kernel B3: the A/B crossfade block step, hand-written in CUDA C++ for
Hopper (``csrc/b3_crossfade_step.cu``) — counterpart of
``fft_convolution_tpu/ops/pallas_crossfade.py`` (``_kernel`` via
``block_step``).

The crossfade convolver's two engines see the same input, so they share one
input-spectra ring.  One step: one forward DFT, two rolled-IR MACs over the
shared ring (tables A and B), two inverse DFTs and overlap-adds, and the
per-sample crossfade mix of the two outputs under the crossfader's state at
the block start (:func:`..models.crossfade.mix_samples`), folded into the
kernel's finishing block.  Precondition, as on the TPU: a full shared
ring (both tables at the ring's segment count).

:func:`block_step` launches the kernel for CUDA tensors and takes the plain
PyTorch version :func:`block_step_plain` only for CPU tensors; it never falls
back.  ``block_step.launches`` counts steps launched (one CUDA launch
each).  The state is updated in place, and carries the kernel's arrival
counter and partial sums (``ticket``, ``partial``, see
:func:`.cuda_engine.step_scratch`); the crossfader state is returned.  The
serving wrapper checks its operands with :func:`check_operands` where it
sets them and launches through :func:`block_step_prepared` (as
:mod:`.cuda_engine`'s B1).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..models import crossfade
from .cuda_engine import (check_block, check_scratch, require, rolled_mac, step_scratch,
                          step_split, tensor_device)
from .fft import twiddles


@dataclasses.dataclass
class XfadeConsts:
    ir_a: torch.Tensor   # complex64 [N, B+1] engine A's IR partition spectra
    ir_b: torch.Tensor   # complex64 [N, B+1] engine B's
    tw: torch.Tensor     # f32 [2B, 2] twiddle table the kernel reads


@dataclasses.dataclass
class XfadeState:
    segments: torch.Tensor   # complex64 [N, B+1] shared input-spectra ring
    overlap_a: torch.Tensor  # f32 [B]
    overlap_b: torch.Tensor  # f32 [B]
    current: int             # ring head
    ticket: torch.Tensor | None = None   # int32 [1] arrival counter, made at the first launch
    partial: torch.Tensor | None = None  # complex64 partial sums, likewise (step_scratch)

    def clone(self) -> "XfadeState":
        return XfadeState(self.segments.clone(), self.overlap_a.clone(),
                          self.overlap_b.clone(), self.current)


def build_consts(ir_a: torch.Tensor, ir_b: torch.Tensor) -> XfadeConsts:
    """Kernel tables from two ``complex64 [N, B+1]`` partition spectra of the
    same shape (the shared-ring precondition); copies."""
    if ir_a.shape != ir_b.shape:
        raise ValueError(f"tables differ in shape: {tuple(ir_a.shape)} vs {tuple(ir_b.shape)}")
    return XfadeConsts(ir_a=ir_a.clone(), ir_b=ir_b.clone(),
                       tw=twiddles(2 * (ir_a.shape[1] - 1), ir_a.device))


def zero_state(n: int, b: int, device) -> XfadeState:
    return XfadeState(torch.zeros((n, b + 1), dtype=torch.complex64, device=device),
                      torch.zeros(b, device=device), torch.zeros(b, device=device), 0)


def block_step_plain(consts: XfadeConsts, state: XfadeState,
                     cf_cfg: crossfade.CrossfaderConfig, cf: crossfade.CrossfaderState,
                     x: torch.Tensor) -> tuple[crossfade.CrossfaderState, torch.Tensor]:
    """The plain PyTorch version of the step, on any device."""
    n, nb = state.segments.shape
    b = nb - 1
    cur = state.current
    state.segments[cur] = torch.fft.rfft(x, n=2 * b)
    out_a = torch.fft.irfft(rolled_mac(state.segments, consts.ir_a, cur), n=2 * b)
    out_b = torch.fft.irfft(rolled_mac(state.segments, consts.ir_b, cur), n=2 * b)
    ya = out_a[:b] + state.overlap_a
    yb = out_b[:b] + state.overlap_b
    state.overlap_a.copy_(out_a[b:])
    state.overlap_b.copy_(out_b[b:])
    state.current = cur - 1 if cur > 0 else n - 1
    return crossfade.mix_block(cf_cfg, cf, ya, yb)


def check_operands(consts: XfadeConsts, state: XfadeState, device) -> None:
    """Raise unless both tables, twiddles, ring, overlaps, ``current`` and
    the scratch where made are what kernel B3 reads on ``device``."""
    device = tensor_device(device)
    n, nb = state.segments.shape
    b = nb - 1
    check_block(b)
    require(state.segments, "segments", (n, nb), torch.complex64, device)
    require(consts.ir_a, "ir_a", (n, nb), torch.complex64, device)
    require(consts.ir_b, "ir_b", (n, nb), torch.complex64, device)
    require(consts.tw, "tw", (2 * b, 2), torch.float32, device)
    require(state.overlap_a, "overlap_a", (b,), torch.float32, device)
    require(state.overlap_b, "overlap_b", (b,), torch.float32, device)
    if not 0 <= state.current < n:
        raise ValueError(f"current {state.current} outside the ring of {n}")
    check_scratch(state, 2, device)


def _launch(consts: XfadeConsts, state: XfadeState, cf_cfg: crossfade.CrossfaderConfig,
            cf: crossfade.CrossfaderState, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel B3 over checked operands and decrement ``current``;
    checks the host int ``current`` only."""
    if x.device.type != "cuda":
        raise ValueError(f"block_step: no kernel for device {x.device}")
    n, nb = state.segments.shape
    b, cur = nb - 1, state.current
    if not 0 <= cur < n:
        raise ValueError(f"current {cur} outside the ring of {n}")
    ticket, partial = step_scratch(state, 2, x.device)
    rows, grid = step_split(n)
    y = torch.empty(b, device=x.device)
    err = _build.kernel("fdl_b3_step")(
        x.data_ptr(), state.segments.data_ptr(), consts.ir_a.data_ptr(),
        consts.ir_b.data_ptr(), consts.tw.data_ptr(), partial.data_ptr(),
        ticket.data_ptr(), y.data_ptr(), state.overlap_a.data_ptr(),
        state.overlap_b.data_ptr(),
        n, b, cur, rows, grid, int(cf.approaching),
        int(cf.target == crossfade.TARGET_B), cf.counter, cf_cfg.fading_samples,
        cf_cfg.mixer_id, float(cf.mix_value), float(cf.step),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fdl_b3_step")
    state.current = cur - 1 if cur > 0 else n - 1
    return y


def block_step(consts: XfadeConsts, state: XfadeState,
               cf_cfg: crossfade.CrossfaderConfig, cf: crossfade.CrossfaderState,
               x: torch.Tensor) -> tuple[crossfade.CrossfaderState, torch.Tensor]:
    """One fused A/B step and mix; returns ``(cf', y)`` with ``y`` ``[B]``.
    CUDA tensors launch kernel B3, CPU tensors take :func:`block_step_plain`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, cf_cfg, cf, x)
    if x.device.type != "cuda":
        raise ValueError(f"block_step: no kernel for device {x.device}")
    require(x, "x", (state.segments.shape[1] - 1,), torch.float32, x.device)
    check_operands(consts, state, x.device)
    y = _launch(consts, state, cf_cfg, cf, x)
    block_step.launches += 1
    return crossfade.advance(cf_cfg, cf, y.shape[0]), y


def block_step_prepared(consts: XfadeConsts, state: XfadeState,
                        cf_cfg: crossfade.CrossfaderConfig, cf: crossfade.CrossfaderState,
                        x: torch.Tensor) -> tuple[crossfade.CrossfaderState, torch.Tensor]:
    """:func:`block_step` over tables and state that passed
    :func:`check_operands` where they were set, and an ``x`` the caller
    made (``serving._block``); checks only ``current``."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, cf_cfg, cf, x)
    y = _launch(consts, state, cf_cfg, cf, x)
    block_step.launches += 1
    return crossfade.advance(cf_cfg, cf, y.shape[0]), y


block_step.launches = 0
