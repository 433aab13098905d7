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
counts its calls in ``.launches``; a call is three CUDA launches (forward
FFTs, the MAC, the finish), the MAC shaped by :func:`stream_plan`.  The
state is updated in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _build
from .cuda_engine import as_c64, check_block, require
from .fft import twiddles

# The MAC's shape (csrc/b4_stream.cu) and the H100's limits that size it.
TILE = 16              # audio blocks a MAC thread, and table rows a stage (kTile)
STAGES = 4             # asynchronous-copy stages in flight (kStages)
MAX_GROUPS = 4         # t-groups of TILE audio blocks a MAC thread block
MAC_MAX_THREADS = 256  # kMacMaxThreads, with __launch_bounds__ at 128 registers a thread
MAC_SM_WARPS = 16      # warps an SM holds at 128 registers: 4 sub-partitions x 4
MAX_SMEM = 232448      # dynamic shared memory a thread block may opt into (227 KB)
SM_SMEM = 233472       # shared memory of an SM (228 KB), 1 KB of it reserved a block
SMS = 132


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


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The MAC's launch: a grid of ``(splits, t_tiles, bin_tiles)`` thread
    blocks.  Block ``(s, i, z)`` sums table rows ``[s rows, (s+1) rows)``
    (the last split cut at N) for audio blocks ``[i span, (i+1) span)`` and
    bins ``[z kb, (z+1) kb)``, one thread a (t-group of TILE blocks, bin)."""

    kb: int          # bins a thread block
    bin_tiles: int
    groups: int      # t-groups a thread block
    t_tiles: int
    ring_rows: int   # ext rows a block keeps in shared memory (a power of two)
    rows: int        # table rows a split, a multiple of TILE
    splits: int
    threads: int     # threads a block: kb x groups rounded up to whole warps
    smem: int        # bytes of dynamic shared memory a block asks for

    @property
    def span(self) -> int:
        """Audio blocks a thread block covers."""
        return TILE * self.groups


def stream_plan(n: int, b: int, t_len: int, item: int) -> StreamPlan:
    """The MAC's launch plan for an ``n``-row table of ``b + 1`` bins stored
    ``item`` bytes a bin (8: complex64, 4: bf16 pairs) and ``t_len`` audio
    blocks.

    Up to MAX_GROUPS t-groups share a block, so each table row and ext row
    is copied once for all of them; the ext ring holds the window of
    ``span - 1`` rows and STAGES stages of TILE rows.  The bins are tiled so
    that a block keeps within MAC_MAX_THREADS threads and MAX_SMEM bytes.
    The splits then give about as many blocks as can be resident on the
    card's SMS at once (MAC_SM_WARPS warps an SM), each of the fewest stages
    of TILE table rows that does it."""
    nb = b + 1
    tgroups = math.ceil(t_len / TILE)
    t_tiles = math.ceil(tgroups / MAX_GROUPS)
    groups = math.ceil(tgroups / t_tiles)
    span = TILE * groups
    ring_rows = 1 << (span - 1 + STAGES * TILE - 1).bit_length()
    per_bin = ring_rows * 8 + STAGES * TILE * item
    bin_tiles = math.ceil(nb / min(MAC_MAX_THREADS // groups, MAX_SMEM // per_bin))
    kb = math.ceil(nb / bin_tiles)
    threads = 32 * math.ceil(kb * groups / 32)
    smem = kb * per_bin
    resident = max(1, min(SM_SMEM // (smem + 1024), MAC_SM_WARPS // (threads // 32)))
    target = max(1, SMS * resident // (bin_tiles * t_tiles))
    rows = TILE * math.ceil(math.ceil(n / TILE) / target)
    return StreamPlan(kb=kb, bin_tiles=bin_tiles, groups=groups, t_tiles=t_tiles,
                      ring_rows=ring_rows, rows=rows, splits=math.ceil(n / rows),
                      threads=threads, smem=smem)


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
    plan = stream_plan(n, b, t_len, 8 if dtype == torch.complex64 else 4)
    # the spectra [T, B+1], the partials [T, splits, B+1], the carried overlap
    scratch = torch.empty(t_len * (1 + plan.splits) * nb + (b + 1) // 2,
                          dtype=torch.complex64, device=dev)
    y = torch.empty((t_len, b), device=dev)
    err = _build.kernel(name)(
        blocks.data_ptr(), state.ring.data_ptr(), consts.irrev.data_ptr(),
        consts.tw.data_ptr(), scratch.data_ptr(), y.data_ptr(), state.overlap.data_ptr(),
        n, b, t_len, state.w, plan.kb, plan.groups, plan.ring_rows, plan.rows, plan.splits,
        torch.cuda.current_stream(dev).cuda_stream)
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
