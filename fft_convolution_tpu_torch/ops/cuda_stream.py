"""Kernel B4: long-IR uniform streaming, T blocks per call, hand-written in
CUDA C++ for Hopper (``csrc/b4_stream.cu``) — counterpart of
``fft_convolution_tpu/ops/pallas_stream.py`` (``_kernel`` via ``stream``),
f32 and packed forms.

The state keeps the JAX package's layout, so carried state maps row for
row (:mod:`..interop`): a CHRONOLOGICAL ring (block ``t`` of a call is
written at slot ``(w + t) mod N``; an incrementing head, where the
reference's ``current`` decrements), the reversed IR table
``irrev[u] = ir[N-1-u]``, the overlap, and ``w`` as a host int.  ``N`` is
padded to a multiple of the chunk (:func:`padded_seg_count`) with zero-IR
rows, equivalent to a reference convolver with a padded
``max_response_length`` (``src/fft_convolver.rs:111-118``).

With the extended buffer ``ext`` = the N-1 newest old ring rows (oldest
first) followed by the T new spectra, output block ``t`` is
``irfft(sum_u irrev[u] * ext[u + t])`` plus the previous block's spill.

:func:`stream` (f32 table, complex64) and :func:`stream_packed` (bf16
table ``[N, B+1, 2]``, half the table bytes; the ring stays complex64)
launch the kernel for CUDA tensors and take the plain PyTorch version
:func:`stream_plain` only for CPU tensors; they never fall back.  Each
counts its calls in ``.launches`` (four CUDA launches per call).  The state
is updated in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _build
from .cuda_engine import as_c64, check_block, require
from .fft import twiddles

TILE = 16  # audio blocks per MAC tile (kTile in csrc/b4_stream.cu)


@dataclasses.dataclass
class StreamConsts:
    irrev: torch.Tensor  # complex64 [N, B+1], or bf16 [N, B+1, 2]: irrev[u] = ir[N-1-u]
    tw: torch.Tensor     # f32 [2B, 2] twiddle table the kernel reads


@dataclasses.dataclass
class StreamState:
    ring: torch.Tensor     # complex64 [N, B+1] chronological input spectra
    overlap: torch.Tensor  # f32 [B]
    w: int                 # next write slot

    def clone(self) -> "StreamState":
        return StreamState(self.ring.clone(), self.overlap.clone(), self.w)


def padded_seg_count(seg_count: int, chunk: int) -> int:
    """``seg_count`` rounded up to a multiple of ``chunk``."""
    return -(-seg_count // chunk) * chunk


def build_consts(ir_spectra: torch.Tensor, packed: bool = False) -> StreamConsts:
    """From ``complex64 [N, B+1]`` partition spectra (N already padded):
    the partition axis reversed, in bf16 pairs when ``packed``."""
    rev = ir_spectra.flip(0)
    irrev = torch.view_as_real(rev).to(torch.bfloat16) if packed else rev.contiguous()
    return StreamConsts(irrev=irrev, tw=twiddles(2 * (ir_spectra.shape[1] - 1),
                                                 ir_spectra.device))


def zero_state(n: int, b: int, device) -> StreamState:
    return StreamState(torch.zeros((n, b + 1), dtype=torch.complex64, device=device),
                       torch.zeros(b, device=device), 0)


def stream_plain(consts: StreamConsts, state: StreamState,
                 blocks: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: ``blocks [T, B]`` ->
    ``y [T, B]``."""
    n, nb = state.ring.shape
    b, t_len = nb - 1, blocks.shape[0]
    irrev = as_c64(consts.irrev)
    spec = torch.fft.rfft(blocks, n=2 * b)
    old = state.ring.roll(-(state.w + 1), dims=0)[:n - 1]
    ext = torch.cat([old, spec])
    conv = torch.stack([(irrev * ext[t:t + n]).sum(dim=0) for t in range(t_len)])
    out = torch.fft.irfft(conv, n=2 * b)
    tails = out[:, b:]
    y = out[:, :b] + torch.cat([state.overlap[None], tails[:-1]])
    state.overlap.copy_(tails[-1])
    first = max(0, t_len - n)  # only the last n blocks stay in the ring
    slots = (state.w + torch.arange(first, t_len, device=spec.device)) % n
    state.ring[slots] = spec[first:]
    state.w = (state.w + t_len) % n
    return y


def split_stream(n: int, t_len: int) -> tuple[int, int]:
    """``(rows, splits)``: table rows per thread block of the MAC and the
    number of splits, so that tiles x splits is about four blocks per SM of
    an H100 (132), with at least 32 rows each to amortise a tile's window
    fill."""
    tiles = math.ceil(t_len / TILE)
    splits = max(1, min(math.ceil(n / 32), math.ceil(4 * 132 / tiles)))
    rows = math.ceil(n / splits)
    return rows, math.ceil(n / rows)


def _launch(name: str, dtype: torch.dtype, consts: StreamConsts, state: StreamState,
            blocks: torch.Tensor) -> torch.Tensor:
    if blocks.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {blocks.device}")
    n, nb = state.ring.shape
    b, t_len = nb - 1, blocks.shape[0]
    check_block(b)
    dev = blocks.device
    if t_len < 1:
        raise ValueError("stream: no blocks")
    require(blocks, "blocks", (t_len, b), torch.float32, dev)
    require(state.ring, "ring", (n, nb), torch.complex64, dev)
    require(consts.irrev, "irrev", (n, nb) if dtype == torch.complex64 else (n, nb, 2),
            dtype, dev)
    require(consts.tw, "tw", (2 * b, 2), torch.float32, dev)
    require(state.overlap, "overlap", (b,), torch.float32, dev)
    if not 0 <= state.w < n:
        raise ValueError(f"w {state.w} outside the ring of {n}")
    rows, splits = split_stream(n, t_len)
    spec = torch.empty((t_len, nb), dtype=torch.complex64, device=dev)
    partial = torch.empty((splits, t_len, nb), dtype=torch.complex64, device=dev)
    tails = torch.empty((t_len, b), device=dev)
    y = torch.empty((t_len, b), device=dev)
    err = getattr(_build.library(), name)(
        blocks.data_ptr(), spec.data_ptr(), state.ring.data_ptr(),
        consts.irrev.data_ptr(), consts.tw.data_ptr(), partial.data_ptr(),
        tails.data_ptr(), y.data_ptr(), state.overlap.data_ptr(),
        n, b, t_len, state.w, rows, splits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    state.w = (state.w + t_len) % n
    return y


def stream(consts: StreamConsts, state: StreamState, blocks: torch.Tensor) -> torch.Tensor:
    """``blocks [T, B]`` through the f32-table kernel; returns ``y [T, B]``.
    CUDA tensors launch kernel B4, CPU tensors take :func:`stream_plain`."""
    if blocks.device.type == "cpu":
        return stream_plain(consts, state, blocks)
    y = _launch("fdl_b4_stream", torch.complex64, consts, state, blocks)
    stream.launches += 1
    return y


def stream_packed(consts: StreamConsts, state: StreamState,
                  blocks: torch.Tensor) -> torch.Tensor:
    """As :func:`stream` over a bf16 table (kernel B4, packed form)."""
    if blocks.device.type == "cpu":
        return stream_plain(consts, state, blocks)
    y = _launch("fdl_b4p_stream", torch.bfloat16, consts, state, blocks)
    stream_packed.launches += 1
    return y


stream.launches = 0
stream_packed.launches = 0
