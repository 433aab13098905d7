"""Kernel B2: the fused head + tail0 block step, hand-written in CUDA C++ for
Hopper (``csrc/b2_two_stage_step.cu``) — counterpart of
``fft_convolution_tpu/ops/pallas_two_stage.py`` (``_kernel`` via
``block_step``).

The two-stage engine's head and tail0 run at the same block size over the
same input, so they share one input-spectra ring.  One step: one forward
DFT, two rolled-IR MACs over the shared ring, two inverse DFTs, the head
overlap-add plus both precalculated tails at the period row (a finished
``y``), tail0's overlap-add written into row ``row`` of ``tail_output0``,
and ``x`` written into row ``row`` of ``tail_input``.  The big tail and the
period-end buffer swaps stay outside (``serving.CudaTwoStageConvolver``).

Preconditions, as on the TPU: a full shared ring (``active == seg_count``
on both stages, true from init) and a tail0 table padded with zero rows to
the ring's row count.

:func:`block_step` launches the kernel for CUDA tensors and takes the plain
PyTorch version :func:`block_step_plain` only for CPU tensors; it never falls
back.  ``block_step.launches`` counts steps launched (two CUDA launches
each).  State and period buffers are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .cuda_engine import check_block, require, rolled_mac, split_rows
from .fft import twiddles

BUFFERS = ("tail_output0", "precalc0", "tail_output", "precalc", "tail_input")


@dataclasses.dataclass
class FusedConsts:
    h_ir: torch.Tensor   # complex64 [n, B+1] head IR partition spectra
    t_ir: torch.Tensor   # complex64 [n, B+1] tail0 spectra, zero rows past its own count
    tw: torch.Tensor     # f32 [2B, 2] twiddle table the kernel reads


@dataclasses.dataclass
class FusedState:
    segments: torch.Tensor      # complex64 [n, B+1] shared input-spectra ring
    head_overlap: torch.Tensor  # f32 [B]
    t0_overlap: torch.Tensor    # f32 [B]
    current: int                # ring head

    def clone(self) -> "FusedState":
        return FusedState(self.segments.clone(), self.head_overlap.clone(),
                          self.t0_overlap.clone(), self.current)


def build_consts(head_ir: torch.Tensor, tail0_ir: torch.Tensor) -> FusedConsts:
    """Kernel tables from the head and tail0 partition spectra
    ``complex64 [*, B+1]``; tail0 is padded with zero rows to the head's
    count (zero rows contribute nothing, like ``active < seg_count``)."""
    n, nb = head_ir.shape
    t_ir = torch.zeros_like(head_ir)
    t_ir[:tail0_ir.shape[0]] = tail0_ir
    return FusedConsts(h_ir=head_ir.clone(), t_ir=t_ir,
                       tw=twiddles(2 * (nb - 1), head_ir.device))


def zero_state(n: int, b: int, device) -> FusedState:
    return FusedState(torch.zeros((n, b + 1), dtype=torch.complex64, device=device),
                      torch.zeros(b, device=device), torch.zeros(b, device=device), 0)


def block_step_plain(consts: FusedConsts, state: FusedState, bufs: dict, row: int,
                     x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the step, on any device."""
    n, nb = state.segments.shape
    b = nb - 1
    cur = state.current
    state.segments[cur] = torch.fft.rfft(x, n=2 * b)
    h = torch.fft.irfft(rolled_mac(state.segments, consts.h_ir, cur), n=2 * b)
    t = torch.fft.irfft(rolled_mac(state.segments, consts.t_ir, cur), n=2 * b)
    y = h[:b] + state.head_overlap + bufs["precalc0"][row] + bufs["precalc"][row]
    state.head_overlap.copy_(h[b:])
    bufs["tail_output0"][row] = t[:b] + state.t0_overlap
    state.t0_overlap.copy_(t[b:])
    bufs["tail_input"][row] = x
    state.current = cur - 1 if cur > 0 else n - 1
    return y


def block_step(consts: FusedConsts, state: FusedState, bufs: dict, row: int,
               x: torch.Tensor) -> torch.Tensor:
    """One fused head+tail0 step at period row ``row``; returns the finished
    ``y`` ``[B]``.  ``bufs`` holds the period buffers ``[period, B]`` named
    in :data:`BUFFERS`.  CUDA tensors launch kernel B2, CPU tensors take
    :func:`block_step_plain`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, bufs, row, x)
    if x.device.type != "cuda":
        raise ValueError(f"block_step: no kernel for device {x.device}")
    n, nb = state.segments.shape
    b = nb - 1
    check_block(b)
    dev = x.device
    p = bufs["precalc"].shape[0]
    require(x, "x", (b,), torch.float32, dev)
    require(state.segments, "segments", (n, nb), torch.complex64, dev)
    require(consts.h_ir, "h_ir", (n, nb), torch.complex64, dev)
    require(consts.t_ir, "t_ir", (n, nb), torch.complex64, dev)
    require(consts.tw, "tw", (2 * b, 2), torch.float32, dev)
    require(state.head_overlap, "head_overlap", (b,), torch.float32, dev)
    require(state.t0_overlap, "t0_overlap", (b,), torch.float32, dev)
    for k in BUFFERS:
        require(bufs[k], k, (p, b), torch.float32, dev)
    if not 0 <= state.current < n:
        raise ValueError(f"current {state.current} outside the ring of {n}")
    if not 0 <= row < p:
        raise ValueError(f"row {row} outside the period of {p}")
    rows, grid = split_rows(n)
    partial = torch.empty((2, grid, nb), dtype=torch.complex64, device=dev)
    y = torch.empty(b, device=dev)
    err = _build.library().fdl_b2_step(
        x.data_ptr(), state.segments.data_ptr(), consts.h_ir.data_ptr(),
        consts.t_ir.data_ptr(), consts.tw.data_ptr(), partial.data_ptr(),
        y.data_ptr(), state.head_overlap.data_ptr(), state.t0_overlap.data_ptr(),
        bufs["tail_output0"][row].data_ptr(), bufs["tail_input"][row].data_ptr(),
        bufs["precalc0"][row].data_ptr(), bufs["precalc"][row].data_ptr(),
        n, b, state.current, rows, grid, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fdl_b2_step")
    block_step.launches += 1
    state.current = state.current - 1 if state.current > 0 else n - 1
    return y


block_step.launches = 0
