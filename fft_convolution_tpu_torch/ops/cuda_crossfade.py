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
counter (``ticket``, see :func:`.cuda_engine.step_ticket`); the crossfader
state is returned.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..models import crossfade
from .cuda_engine import check_block, require, rolled_mac, step_split, step_ticket
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
    ticket: torch.Tensor | None = None  # int32 [1] arrival counter, made at the first launch

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


def block_step(consts: XfadeConsts, state: XfadeState,
               cf_cfg: crossfade.CrossfaderConfig, cf: crossfade.CrossfaderState,
               x: torch.Tensor) -> tuple[crossfade.CrossfaderState, torch.Tensor]:
    """One fused A/B step and mix; returns ``(cf', y)`` with ``y`` ``[B]``.
    CUDA tensors launch kernel B3, CPU tensors take :func:`block_step_plain`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, cf_cfg, cf, x)
    if x.device.type != "cuda":
        raise ValueError(f"block_step: no kernel for device {x.device}")
    n, nb = state.segments.shape
    b = nb - 1
    check_block(b)
    dev = x.device
    require(x, "x", (b,), torch.float32, dev)
    require(state.segments, "segments", (n, nb), torch.complex64, dev)
    require(consts.ir_a, "ir_a", (n, nb), torch.complex64, dev)
    require(consts.ir_b, "ir_b", (n, nb), torch.complex64, dev)
    require(consts.tw, "tw", (2 * b, 2), torch.float32, dev)
    require(state.overlap_a, "overlap_a", (b,), torch.float32, dev)
    require(state.overlap_b, "overlap_b", (b,), torch.float32, dev)
    if not 0 <= state.current < n:
        raise ValueError(f"current {state.current} outside the ring of {n}")
    ticket = step_ticket(state, dev)
    rows, grid = step_split(n)
    partial = torch.empty((2, 1 + grid, nb), dtype=torch.complex64, device=dev)
    y = torch.empty(b, device=dev)
    err = _build.library().fdl_b3_step(
        x.data_ptr(), state.segments.data_ptr(), consts.ir_a.data_ptr(),
        consts.ir_b.data_ptr(), consts.tw.data_ptr(), partial.data_ptr(),
        ticket.data_ptr(), y.data_ptr(), state.overlap_a.data_ptr(),
        state.overlap_b.data_ptr(),
        n, b, state.current, rows, grid, int(cf.approaching),
        int(cf.target == crossfade.TARGET_B), cf.counter, cf_cfg.fading_samples,
        cf_cfg.mixer_id, float(cf.mix_value), float(cf.step),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fdl_b3_step")
    block_step.launches += 1
    state.current = state.current - 1 if state.current > 0 else n - 1
    return crossfade.advance(cf_cfg, cf, b), y


block_step.launches = 0
