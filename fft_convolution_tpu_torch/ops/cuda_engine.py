"""Kernel B1: the uniform fused block step, hand-written in CUDA C++ for
Hopper (``csrc/b1_uniform_step.cu``) — counterpart of
``fft_convolution_tpu/ops/pallas_engine.py`` (``_kernel`` via ``block_step``).

One step per audio block: the forward real FFT of the new block, its write
into ring row ``current``, the frequency-delay-line MAC of the ring against
the IR table rolled by ``current``, the inverse FFT, the overlap-add, and
``current`` decremented.  Precondition, as on the TPU: a full ring
(``active_segs == seg_count``), so every row pairs with one table row.

:func:`block_step` launches the kernel for CUDA tensors and takes the plain
PyTorch version :func:`block_step_plain` only for CPU tensors; it never falls
back.  ``block_step.launches`` counts steps launched (one CUDA launch each,
over ``csrc/fdl_step.cuh`` at one table).  The state is updated in place:
the kernel writes the ring row and the overlap where they lie; the state
also carries the kernel's arrival counter and partial-sum scratch
(``ticket``, ``partial``, see :func:`step_scratch`).

:func:`block_step` checks every operand on every call, for direct callers.
A serving wrapper owns its table and state, so it checks them with
:func:`check_operands` where it sets them (construction, ``update``,
``restore``) and launches through :func:`block_step_prepared`, which
checks only the host int ``current``; its input comes through
``serving._block``.  Both count in ``block_step.launches``.

Kernel B1p (:func:`block_step_packed`, ``fdl_b1p_step`` in the same source)
is the step over bf16 storage — counterpart of ``pallas_engine.py``'s
``_kernel_packed`` via ``block_step_packed``.  Ring and table are
``torch.bfloat16 [N, B+1, 2]`` (native bf16 pairs; the JAX package's
uint32 words are a TPU layout fix), rounded to nearest even on store; the
current block's term stays float32 on the ring side.  It counts its own
launches in ``block_step_packed.launches`` (:func:`block_step_packed_prepared`
too); :func:`block_step_plain` serves both storages.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import _build
from ..models.uniform import UniformConfig, UniformState
from .fft import twiddles

# The kernels keep the twiddle table and their transforms' buffers in shared
# memory (B1-B3: FFTs, up to 164 KB at 2048 of the SM's 227 KB); 2048 keeps
# them inside one SM.
MAX_BLOCK = 2048


STORAGES = ("float32", "bf16_packed")


def to_bf16(spec: torch.Tensor) -> torch.Tensor:
    """complex64 ``[..., B+1]`` -> bf16 pairs ``[..., B+1, 2]``, rounded to
    nearest even (as the JAX package's ``pack_c32``)."""
    return torch.view_as_real(spec).to(torch.bfloat16)


def as_c64(t: torch.Tensor) -> torch.Tensor:
    """complex64 view of a spectrum table in either storage (bf16 widens
    exactly)."""
    return t if t.is_complex() else torch.view_as_complex(t.float())


def store(spec: torch.Tensor, storage: str) -> torch.Tensor:
    """A complex64 spectrum table in ``storage`` (a copy)."""
    if storage not in STORAGES:
        raise ValueError(f"storage must be one of {STORAGES}, got {storage!r}")
    return spec.clone() if storage == "float32" else to_bf16(spec)


@dataclasses.dataclass
class FDLConsts:
    """Per-IR tables (rebuilt on ``update``)."""

    ir: torch.Tensor   # complex64 [N, B+1] IR partition spectra, or bf16 [N, B+1, 2]
    tw: torch.Tensor   # f32 [2B, 2] twiddle table the kernel reads


@dataclasses.dataclass
class FDLState:
    segments: torch.Tensor  # input-spectra ring, in the table's storage
    overlap: torch.Tensor   # f32 [B]
    current: int            # ring head
    ticket: torch.Tensor | None = None   # int32 [1] arrival counter, made at the first launch
    partial: torch.Tensor | None = None  # complex64 partial sums, likewise (step_scratch)

    def clone(self) -> "FDLState":
        return FDLState(self.segments.clone(), self.overlap.clone(), self.current)


def from_uniform(cfg: UniformConfig, state: UniformState,
                 storage: str = "float32") -> tuple[FDLConsts, FDLState]:
    """Kernel operands from a uniform engine's IR table and state (copies),
    with ring and table in ``storage``."""
    consts = FDLConsts(ir=store(state.segments_ir, storage),
                       tw=twiddles(cfg.fft_size, state.segments.device))
    return consts, FDLState(store(state.segments, storage), state.overlap.clone(),
                            state.current)


def to_uniform(fstate: FDLState, template: UniformState) -> UniformState:
    """Back to the engine state, for the sequential paths.  Their
    ``pre_multiplied`` is recomputed at the next block start."""
    out = template.clone()
    out.segments = as_c64(fstate.segments).clone()
    out.overlap = fstate.overlap.clone()
    out.current = fstate.current
    return out


@functools.cache
def step_split(n: int) -> tuple[int, int]:
    """``(rows, grid)`` of the one-launch kernels B1-B3: the ``n - 1``
    ring rows other than ``current`` in ``grid`` MAC blocks of ``rows`` rows,
    beside the block that computes the fresh spectrum — about one block per
    SM of an H100 (132) in all, at least 8 rows each.  ``grid`` is 0 for a
    one-row ring."""
    rows = max(8, math.ceil((n - 1) / 131))
    return rows, math.ceil((n - 1) / rows)


def step_ticket(state, device: torch.device) -> torch.Tensor:
    """The arrival counter of a one-launch kernel (B1-B3), kept in
    ``state.ticket``: one 32-bit integer on the card, 0 between steps (the
    last thread block of a step wraps it back).  A state gets a zeroed one at
    its first launch; fresh states (init, ``reset``) and clones (``restore``)
    start without one, so two states never share a counter."""
    if state.ticket is None:
        state.ticket = torch.zeros(1, dtype=torch.int32, device=device)
    return state.ticket


def step_scratch(state, heads: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ticket, partial)`` of a one-launch kernel (B1-B3) over ``heads``
    tables, kept in the state: the arrival counter (:func:`step_ticket`)
    and the partial sums ``complex64 [heads, 1 + grid, B+1]`` that the
    step's thread blocks write and the last to arrive adds up, within one
    launch.  Both are made at the state's first launch and never shared:
    fresh states and clones start without them."""
    if state.partial is None:
        n, nb = state.segments.shape[:2]
        state.partial = torch.empty((heads, 1 + step_split(n)[1], nb), dtype=torch.complex64,
                                    device=device)
    return step_ticket(state, device), state.partial


def check_scratch(state, heads: int, device: torch.device) -> None:
    """Raise unless the state's counter and partial sums, where made, are
    the ones :func:`step_scratch` makes."""
    n, nb = state.segments.shape[:2]
    if state.ticket is not None:
        require(state.ticket, "ticket", (1,), torch.int32, device)
    if state.partial is not None:
        require(state.partial, "partial", (heads, 1 + step_split(n)[1], nb), torch.complex64,
                device)


def tensor_device(device) -> torch.device:
    """``device`` as its tensors report it: a bare ``"cuda"`` names the
    current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
    """The plain PyTorch version of the step (B1 and B1p), on any device."""
    n, nb = state.segments.shape[:2]
    b = nb - 1
    cur = state.current
    spec = torch.fft.rfft(x, n=2 * b)
    segments = as_c64(state.segments)  # the ring itself, or a widened copy of it
    segments[cur] = spec  # unrounded: the current block's term stays f32
    out = torch.fft.irfft(rolled_mac(segments, as_c64(consts.ir), cur), n=2 * b)
    if not state.segments.is_complex():
        state.segments[cur] = to_bf16(spec)
    y = out[:b] + state.overlap
    state.overlap.copy_(out[b:])
    state.current = cur - 1 if cur > 0 else n - 1
    return y


def check_operands(consts: FDLConsts, state: FDLState, dtype: torch.dtype,
                   device) -> None:
    """Raise unless table, twiddles, ring, overlap, ``current`` and the
    scratch where made are what kernel B1 (``dtype`` complex64) or B1p
    (bfloat16) reads on ``device``."""
    device = tensor_device(device)
    n, nb = state.segments.shape[:2]
    b = nb - 1
    check_block(b)
    shape = (n, nb) if dtype == torch.complex64 else (n, nb, 2)
    require(state.segments, "segments", shape, dtype, device)
    require(consts.ir, "ir", shape, dtype, device)
    require(consts.tw, "tw", (2 * b, 2), torch.float32, device)
    require(state.overlap, "overlap", (b,), torch.float32, device)
    if not 0 <= state.current < n:
        raise ValueError(f"current {state.current} outside the ring of {n}")
    check_scratch(state, 1, device)


def _launch(name: str, consts: FDLConsts, state: FDLState, x: torch.Tensor) -> torch.Tensor:
    """Launch ``name`` over checked operands and decrement ``current``;
    checks the host int ``current`` only."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    n, nb = state.segments.shape[:2]
    cur = state.current
    if not 0 <= cur < n:
        raise ValueError(f"current {cur} outside the ring of {n}")
    ticket, partial = step_scratch(state, 1, x.device)
    rows, grid = step_split(n)
    y = torch.empty(nb - 1, device=x.device)
    err = _build.kernel(name)(
        x.data_ptr(), state.segments.data_ptr(), consts.ir.data_ptr(),
        consts.tw.data_ptr(), partial.data_ptr(), ticket.data_ptr(), y.data_ptr(),
        state.overlap.data_ptr(), n, nb - 1, cur, rows, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    state.current = cur - 1 if cur > 0 else n - 1
    return y


def _checked(name: str, dtype: torch.dtype, consts: FDLConsts, state: FDLState,
             x: torch.Tensor) -> torch.Tensor:
    """Check every operand, then :func:`_launch`."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    require(x, "x", (state.segments.shape[1] - 1,), torch.float32, x.device)
    check_operands(consts, state, dtype, x.device)
    return _launch(name, consts, state, x)


def block_step(consts: FDLConsts, state: FDLState, x: torch.Tensor) -> torch.Tensor:
    """One fused block step over complex64 storage; returns ``y`` ``[B]``.
    CUDA tensors launch kernel B1, CPU tensors take :func:`block_step_plain`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, x)
    y = _checked("fdl_b1_step", torch.complex64, consts, state, x)
    block_step.launches += 1
    return y


def block_step_prepared(consts: FDLConsts, state: FDLState, x: torch.Tensor) -> torch.Tensor:
    """:func:`block_step` over a table and state that passed
    :func:`check_operands` where they were set, and an ``x`` the caller
    made (``serving._block``); checks only ``current``."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, x)
    y = _launch("fdl_b1_step", consts, state, x)
    block_step.launches += 1
    return y


def block_step_packed(consts: FDLConsts, state: FDLState, x: torch.Tensor) -> torch.Tensor:
    """One fused block step over bf16 storage; returns ``y`` ``[B]``.  CUDA
    tensors launch kernel B1p, CPU tensors take :func:`block_step_plain`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, x)
    y = _checked("fdl_b1p_step", torch.bfloat16, consts, state, x)
    block_step_packed.launches += 1
    return y


def block_step_packed_prepared(consts: FDLConsts, state: FDLState,
                               x: torch.Tensor) -> torch.Tensor:
    """:func:`block_step_packed` as :func:`block_step_prepared` is
    :func:`block_step`."""
    if x.device.type == "cpu":
        return block_step_plain(consts, state, x)
    y = _launch("fdl_b1p_step", consts, state, x)
    block_step_packed.launches += 1
    return y


block_step.launches = 0
block_step_packed.launches = 0
