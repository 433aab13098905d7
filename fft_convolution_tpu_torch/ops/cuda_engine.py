"""Kernel B1: the uniform fused block step, hand-written in CUDA C++ for
Hopper (``csrc/b1_uniform_step.cu``) — counterpart of
``fft_convolution_tpu/ops/pallas_engine.py`` (``_kernel`` via ``block_step``).

One step per audio block: the forward real DFT of the new block, its write
into ring row ``current``, the frequency-delay-line MAC of the ring against
the IR table rolled by ``current``, the inverse DFT, the overlap-add, and
``current`` decremented.  Precondition, as on the TPU: a full ring
(``active_segs == seg_count``), so every row pairs with one table row.

:func:`block_step` launches the kernel for CUDA tensors and takes the plain
PyTorch version :func:`block_step_plain` only for CPU tensors; it never falls
back.  ``block_step.launches`` counts kernel launches (one per step, made of
two CUDA launches: the split MAC and the reduction with the inverse DFT).
The state is updated in place: the kernel writes the ring row and the
overlap where they lie.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _build
from ..models.uniform import UniformConfig, UniformState
from .fft import twiddles

# The kernels keep the twiddle table and a 2B-sample block in shared memory
# and run a direct O(B^2) DFT; 2048 keeps both well inside one SM.
MAX_BLOCK = 2048


@dataclasses.dataclass
class FDLConsts:
    """Per-IR tables (rebuilt on ``update``)."""

    ir: torch.Tensor   # complex64 [N, B+1] IR partition spectra
    tw: torch.Tensor   # f32 [2B, 2] twiddle table the kernel reads


@dataclasses.dataclass
class FDLState:
    segments: torch.Tensor  # complex64 [N, B+1] input-spectra ring
    overlap: torch.Tensor   # f32 [B]
    current: int            # ring head

    def clone(self) -> "FDLState":
        return FDLState(self.segments.clone(), self.overlap.clone(), self.current)


def from_uniform(cfg: UniformConfig, state: UniformState) -> tuple[FDLConsts, FDLState]:
    """Kernel operands from a uniform engine's IR table and state (copies)."""
    consts = FDLConsts(ir=state.segments_ir.clone(),
                       tw=twiddles(cfg.fft_size, state.segments.device))
    return consts, FDLState(state.segments.clone(), state.overlap.clone(), state.current)


def to_uniform(fstate: FDLState, template: UniformState) -> UniformState:
    """Back to the engine state, for the sequential paths.  Their
    ``pre_multiplied`` is recomputed at the next block start."""
    out = template.clone()
    out.segments = fstate.segments.clone()
    out.overlap = fstate.overlap.clone()
    out.current = fstate.current
    return out


def split_rows(n: int) -> tuple[int, int]:
    """``(rows, grid)``: ring rows per thread block of the split MAC and the
    number of blocks — about one block per SM of an H100 (132), at least
    four rows each so the reduction stays short."""
    rows = max(4, math.ceil(n / 132))
    return rows, math.ceil(n / rows)


def require(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel reading raw pointers relies on."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def check_block(b: int) -> None:
    if b < 1 or b & (b - 1) or b > MAX_BLOCK:
        raise ValueError(f"kernel block size must be a power of two <= {MAX_BLOCK}, got {b}")


def rolled_mac(segments: torch.Tensor, ir: torch.Tensor, cur: int) -> torch.Tensor:
    """``sum_j segments[j] * ir[(j - cur) mod n]``, as two contiguous slices
    (no gather)."""
    n = segments.shape[0]
    return ((segments[cur:] * ir[:n - cur]).sum(dim=0)
            + (segments[:cur] * ir[n - cur:]).sum(dim=0))


def block_step_plain(consts: FDLConsts, state: FDLState, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the step, on any device."""
    n, nb = state.segments.shape
    b = nb - 1
    cur = state.current
    state.segments[cur] = torch.fft.rfft(x, n=2 * b)
    out = torch.fft.irfft(rolled_mac(state.segments, consts.ir, cur), n=2 * b)
    y = out[:b] + state.overlap
    state.overlap.copy_(out[b:])
    state.current = cur - 1 if cur > 0 else n - 1
    return y


def block_step(consts: FDLConsts, state: FDLState, x: torch.Tensor) -> torch.Tensor:
    """One fused block step; returns ``y`` ``[B]``.  CUDA tensors launch
    kernel B1, CPU tensors take :func:`block_step_plain`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, x)
    if x.device.type != "cuda":
        raise ValueError(f"block_step: no kernel for device {x.device}")
    n, nb = state.segments.shape
    b = nb - 1
    check_block(b)
    dev = x.device
    require(x, "x", (b,), torch.float32, dev)
    require(state.segments, "segments", (n, nb), torch.complex64, dev)
    require(consts.ir, "ir", (n, nb), torch.complex64, dev)
    require(consts.tw, "tw", (2 * b, 2), torch.float32, dev)
    require(state.overlap, "overlap", (b,), torch.float32, dev)
    if not 0 <= state.current < n:
        raise ValueError(f"current {state.current} outside the ring of {n}")
    rows, grid = split_rows(n)
    partial = torch.empty((grid, nb), dtype=torch.complex64, device=dev)
    y = torch.empty(b, device=dev)
    err = _build.library().fdl_b1_step(
        x.data_ptr(), state.segments.data_ptr(), consts.ir.data_ptr(),
        consts.tw.data_ptr(), partial.data_ptr(), y.data_ptr(),
        state.overlap.data_ptr(), n, b, state.current, rows, grid,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fdl_b1_step")
    block_step.launches += 1
    state.current = state.current - 1 if state.current > 0 else n - 1
    return y


block_step.launches = 0
