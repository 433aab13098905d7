"""Uniform partitioned FFT convolution (frequency-delay line, overlap-add) —
counterpart of ``fft_convolution_tpu/models/uniform.py`` and of the
reference ``FFTConvolver`` (``src/fft_convolver.rs:86-307``).

The engine is a set of plain functions over a :class:`UniformState`.  Unlike
the JAX package's immutable pytrees, the state is updated IN PLACE (the ring
row write, the overlap, the scalar counters) so a step moves no more than
the bytes it must; callers that need a value copy use
:meth:`UniformState.clone`.  The scalars (``current``, ``input_fill``,
``active_segs``) are host ints: they follow from the call sequence alone,
so keeping them on the host costs no device round trip.

Semantics follow the reference exactly:

* ``init`` pads the IR to ``max_response_length`` so trailing all-zero
  segments ARE active until the first ``update`` (``:111-118``), and it runs
  through the same code as ``update``;
* ``block_size`` rounds up to a power of two (``:115``), FFT size is
  ``2 * block_size`` (``:116``);
* the ring head ``current`` DECREMENTS and wraps to ``active_segs - 1``
  (``:287-291``); ring reads are ``(current + i) % active_segs`` (``:248``);
* ``update`` keeps the input history but zeroes ``overlap`` and
  ``pre_multiplied`` (``:174-213``);
* sub-block calls re-run the forward FFT of the partly filled input buffer
  so output has zero added latency (``:222-294``);
* ``active_segs == 0`` outputs zeros and leaves the state untouched
  (``:216-219``).

:func:`process_block` and :func:`process_stream` take leading batch axes
(``segments`` ``[..., N, B+1]``, blocks ``[..., B]``), so a farm's voices
share them (:mod:`..parallel.farm`).

Block-aligned streams (:func:`process_stream`) run the frequency-delay
line's MAC over all T blocks at once: it is a causal convolution along the
block axis (``conv[t] = sum_i ir[i] * X[t - i]``), computed by
:func:`..ops.fft.causal_conv_time` on ``torch.fft`` over the chronological
history from the ring followed by the new spectra (:func:`_stream_conv`).
The CHRONO convention (:func:`stream_conv_chrono`) keeps that history
chronological between calls, so a stream of aligned calls (the two-stage
wrapper's big tail) skips the ring's gather and rebuild.  The JAX
package's other stream cores (ring scans, correlation windows) are not
ported: the sequential :func:`process_block` loop is the reference
semantics where the conv core does not apply.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.fft import (causal_conv_khat, causal_conv_time, copy_and_pad, ir_to_spectra,
                       irdft_block, next_power_of_two, rdft_block)
from ..ops.spectral import fdl_mac


@dataclasses.dataclass(frozen=True)
class UniformConfig:
    block_size: int   # power of two (reference rounds up, :115)
    seg_count: int    # ceil(ir_len / block_size)               (:117)
    ir_len: int       # max_response_length                      (:111-113)

    @property
    def fft_size(self) -> int:
        return 2 * self.block_size

    @property
    def bins(self) -> int:
        return self.block_size + 1


@dataclasses.dataclass
class UniformState:
    """The struct fields of ``FFTConvolver`` (``src/fft_convolver.rs:86-102``)."""

    segments: torch.Tensor        # complex64 [seg_count, B+1] input-spectra ring
    segments_ir: torch.Tensor     # complex64 [seg_count, B+1] IR partition spectra
    overlap: torch.Tensor         # f32 [B] overlap-add tail
    input_buffer: torch.Tensor    # f32 [B] sub-block accumulation
    pre_multiplied: torch.Tensor  # complex64 [B+1] spectral accumulator
    current: int                  # ring head
    input_fill: int               # valid samples in input_buffer
    active_segs: int              # active partition count

    def clone(self) -> "UniformState":
        """Value copy: the engine functions mutate tensors in place."""
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).clone()
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})


def make_config(block_size: int, max_response_length: int) -> UniformConfig:
    block = next_power_of_two(block_size)
    ir_len = max_response_length
    seg_count = max(1, math.ceil(ir_len / block)) if ir_len > 0 else 1
    return UniformConfig(block_size=block, seg_count=seg_count, ir_len=ir_len)


def zero_state(cfg: UniformConfig, device) -> UniformState:
    """All-zero state for ``cfg`` (``segments_ir`` included, active = 0)."""
    spec = (cfg.seg_count, cfg.bins)
    return UniformState(
        segments=torch.zeros(spec, dtype=torch.complex64, device=device),
        segments_ir=torch.zeros(spec, dtype=torch.complex64, device=device),
        overlap=torch.zeros(cfg.block_size, device=device),
        input_buffer=torch.zeros(cfg.block_size, device=device),
        pre_multiplied=torch.zeros(cfg.bins, dtype=torch.complex64, device=device),
        current=0, input_fill=0, active_segs=0,
    )


def init(response, block_size: int, max_response_length: int,
         device="cpu") -> tuple[UniformConfig, UniformState]:
    """``Convolution::init`` (``src/fft_convolver.rs:105-172``), built as
    :func:`update` applied to a zero state so init-time and update-time IR
    spectra come from the same code.  Raises ``ValueError`` where the
    reference panics (``:106-110``)."""
    response = torch.as_tensor(response, dtype=torch.float32, device=device)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    cfg = make_config(block_size, max_response_length)
    padded = copy_and_pad(response, cfg.seg_count * cfg.block_size)
    # active = ceil(ir_len / B): trailing zero segments are live (:117-118)
    state = zero_state(cfg, device)
    update(cfg, state, padded, cfg.ir_len)
    return cfg, state


def empty(block_size: int, device="cpu") -> tuple[UniformConfig, UniformState]:
    """``FFTConvolver::default()``: an engine with ``active_segs == 0`` that
    outputs zeros (absent two-stage tail stages, ``src/fft_convolver.rs:367,383``)."""
    cfg = make_config(block_size, 0)
    _, state = init(torch.zeros(0), block_size, block_size, device)
    state.active_segs = 0
    return cfg, state


def update(cfg: UniformConfig, state: UniformState, response_padded: torch.Tensor,
           new_len: int) -> None:
    """RT-safe IR swap (``src/fft_convolver.rs:174-213``), in place.

    ``response_padded`` is the new IR zero-padded to ``seg_count *
    block_size``; ``new_len`` is its true length.  Keeps the input history
    (``segments``, ``current``, ``input_buffer``, ``input_fill``) and zeroes
    the overlap and the accumulator (``:185-188``)."""
    state.segments_ir = ir_to_spectra(response_padded, cfg.block_size, cfg.seg_count)
    state.overlap.zero_()
    state.pre_multiplied.zero_()
    state.active_segs = -(-new_len // cfg.block_size)


def reset(state: UniformState) -> None:
    """``Convolution::reset`` (``src/fft_convolver.rs:296-307``): clears the
    input side, keeps ``segments_ir`` and ``active_segs``."""
    state.segments.zero_()
    state.overlap.zero_()
    state.input_buffer.zero_()
    state.pre_multiplied.zero_()
    state.current = 0
    state.input_fill = 0


def _engine_step(cfg: UniformConfig, state: UniformState, buffer_spec: torch.Tensor,
                 recompute_pre: bool) -> torch.Tensor:
    """Write the block spectrum into the ring, form ``conv = pre_multiplied
    + spec * ir[0]`` and inverse-transform (``src/fft_convolver.rs:234-267``).
    Returns the full ``2B`` inverse buffer."""
    state.segments[..., state.current, :] = buffer_spec
    if recompute_pre:
        state.pre_multiplied = fdl_mac(state.segments, state.segments_ir,
                                       state.current, state.active_segs)
    conv = state.pre_multiplied + buffer_spec * state.segments_ir[..., 0, :]
    return torch.fft.irfft(conv, n=cfg.fft_size)


def _advance_ring(cfg: UniformConfig, state: UniformState,
                  fft_buffer: torch.Tensor) -> None:
    """Block completion (``src/fft_convolver.rs:278-292``): clear the input
    buffer, save the new overlap, decrement the ring head."""
    state.input_buffer.zero_()
    state.input_fill = 0
    state.overlap = fft_buffer[..., cfg.block_size:].clone()
    state.current = state.current - 1 if state.current > 0 else state.active_segs - 1


def process_block(cfg: UniformConfig, state: UniformState,
                  x: torch.Tensor) -> torch.Tensor:
    """Process exactly one full block (the ``input_buffer_was_empty`` pass of
    ``src/fft_convolver.rs:215-295``).  ``x [..., block_size]``; leading
    axes are voices of one lockstep state.  Returns ``y`` of ``x``'s shape."""
    if state.active_segs == 0:
        return torch.zeros_like(x)
    spec = torch.fft.rfft(x, n=cfg.fft_size)
    fft_buffer = _engine_step(cfg, state, spec, True)
    y = fft_buffer[..., : cfg.block_size] + state.overlap
    _advance_ring(cfg, state, fft_buffer)
    return y


def process_block_at(cfg: UniformConfig, state: UniformState, head: torch.Tensor,
                     x: torch.Tensor, out: torch.Tensor) -> None:
    """:func:`process_block` with the ring head read from, and advanced in,
    ``head`` (int64 ``[1]`` on the state's device) in place of the host int
    ``state.current``, and ``y`` written into ``out``.  No host value enters
    the step and every tensor it updates is written in place, so a CUDA graph
    captured once replays it at any ring position
    (``serving.CudaTwoStageConvolver``'s big tail).  The same operations as
    :func:`process_block`, so the same bits.  The caller keeps
    ``state.current`` in step with ``head``; ``active_segs`` must be nonzero
    and ``input_buffer`` empty (a full-block stream)."""
    active = state.active_segs
    spec = torch.fft.rfft(x, n=cfg.fft_size)
    state.segments.index_copy_(0, head, spec[None])
    rows = (head + torch.arange(1, active, device=head.device)) % active
    state.pre_multiplied.copy_((state.segments_ir[1:active] * state.segments[rows]).sum(dim=-2))
    fft_buffer = torch.fft.irfft(state.pre_multiplied + spec * state.segments_ir[0],
                                 n=cfg.fft_size)
    torch.add(fft_buffer[:cfg.block_size], state.overlap, out=out)
    state.overlap.copy_(fft_buffer[cfg.block_size:])
    head.sub_(1).remainder_(active)


def meta_size(seg_count: int, t: int) -> int:
    """Block-axis DFT length of a ``t``-block stream: the smallest power of
    two that holds the ``seg_count - 1`` history rows and the ``t`` new
    ones."""
    return next_power_of_two(seg_count - 1 + t)


def _table(cfg: UniformConfig, state: UniformState) -> torch.Tensor:
    """The IR table with partitions ``>= active_segs`` zeroed: the stream
    kernel of an engine shrunk by :func:`update`."""
    if state.active_segs == cfg.seg_count:
        return state.segments_ir
    live = torch.arange(cfg.seg_count, device=state.segments_ir.device) < state.active_segs
    return state.segments_ir * live[:, None]


def stream_khat(cfg: UniformConfig, state: UniformState, t: int) -> torch.Tensor:
    """The stream MAC's kernel meta-spectra for ``t``-block calls of
    :func:`process_stream` (``stream_khat``,
    ``fft_convolution_tpu/models/uniform.py:356``): the block-axis DFT of the
    activity-masked table at :func:`meta_size`.  Input-independent between
    IR updates; valid for every ``t`` with the same meta size
    (:func:`..ops.fft.causal_conv_time` refuses another)."""
    return causal_conv_khat(_table(cfg, state), meta_size(cfg.seg_count, t))


def ring_from_ext(ext: torch.Tensor, end: int, n: int,
                  current: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A full ring rebuilt from a chronological spectra sequence ``ext``
    (block axis dim -2) whose newest block is row ``end - 1``, for the ring
    head ``current`` after those blocks (``rebuild_roll``,
    ``fft_convolution_tpu/models/uniform.py:463``).  Slot ``(current + d) %
    n`` holds the block of delay ``d`` (``d = n`` in the head slot).
    Returns ``(segments, by_delay)``; ``by_delay[..., d - 1, :]`` is the
    block of delay ``d``."""
    by_delay = ext[..., end - n:end, :].flip(-2)
    return by_delay.roll(current + 1, dims=-2), by_delay


def ring_window(segments: torch.Tensor, current: int) -> torch.Tensor:
    """The ``n`` blocks of a full ring (``active == n``) before the next
    write, oldest first: delays ``n .. 1``, the ring read backwards from
    the head slot ``current``.  Rows ``1:`` are the history a stream's
    causal convolution needs."""
    return segments.roll(-(current + 1), dims=-2).flip(-2)


def _stream_conv(cfg: UniformConfig, state: UniformState, specs: torch.Tensor,
                 kern_hat: torch.Tensor | None = None) -> torch.Tensor:
    """The MAC of ``t`` blocks' spectra ``specs [..., T, B+1]`` as one causal
    convolution along the block axis (``_stream_conv``,
    ``fft_convolution_tpu/models/uniform.py:378``); updates ``segments``,
    ``current`` and ``pre_multiplied`` in place and returns ``conv [..., T,
    B+1]``.  Precondition: ``current < active_segs`` (the caller checks).
    ``_stream_conv.calls`` counts the calls.

    History: the ``n - 1`` ring rows before the new blocks, oldest first.
    With a full ring (``active == n``) they are every slot but the head's,
    read backwards from ``current + 1``; a shrunk ring gathers them modulo
    ``active`` (rows of delay ``>= active`` meet zeroed partitions).  The
    ring is rebuilt from the same sequence; a full ring takes
    ``pre = conv[T-1] - X[T-1] * ir[0]`` (the identity that defines it,
    ``src/fft_convolver.rs:256-261``), a shrunk one the masked MAC at the
    head before the last decrement."""
    _stream_conv.calls += 1
    n, t = cfg.seg_count, specs.shape[-2]
    active, cur = state.active_segs, state.current
    seg = state.segments
    if n == 1:
        ext = specs
    else:
        if active == n:
            hist = ring_window(seg, cur)[..., 1:, :]
        else:
            k = torch.arange(n - 1, device=seg.device)
            hist = seg[..., (cur + n - 1 - k) % active, :]
        ext = torch.cat([hist, specs], dim=-2)
    kern = state.segments_ir if kern_hat is not None else _table(cfg, state)
    convs = causal_conv_time(ext, kern, t, kern_hat=kern_hat, m=meta_size(n, t))
    cur_f = (cur - t) % active
    if active == n:
        state.segments = ring_from_ext(ext, n - 1 + t, n, cur_f)[0]
        state.pre_multiplied = convs[..., -1, :] - specs[..., -1, :] * state.segments_ir[..., 0, :]
    else:
        s = torch.arange(n, device=seg.device)
        d = (s - cur_f) % active
        rows = (n - 1 + t) - torch.where(d == 0, active, d)
        live = (s < active)[:, None]
        state.segments = torch.where(live, ext[..., rows, :], seg)
        state.pre_multiplied = fdl_mac(state.segments, state.segments_ir,
                                       (cur_f + 1) % active, active)
    state.current = cur_f
    return convs


_stream_conv.calls = 0


def stream_conv(cfg: UniformConfig, state: UniformState, blocks: torch.Tensor,
                kern_hat: torch.Tensor | None = None) -> torch.Tensor:
    """``blocks [..., T, B] -> y [..., T, B]`` through the conv core with no
    gate (``stream_conv_unguarded``,
    ``fft_convolution_tpu/models/uniform.py:714``): the forward transforms
    of all T blocks, :func:`_stream_conv`, the inverse transforms and a
    vectorised overlap-add seeded by ``overlap``.  Precondition: ``current <
    active_segs``."""
    b = cfg.block_size
    specs = rdft_block(blocks, cfg.fft_size)
    outs = irdft_block(_stream_conv(cfg, state, specs, kern_hat), cfg.fft_size)
    y = outs[..., :b] + torch.cat([state.overlap[..., None, :], outs[..., :-1, b:]], dim=-2)
    state.overlap = outs[..., -1, b:].contiguous()
    return y


# CHRONO: the history of block-aligned streams kept chronological
# (``fft_convolution_tpu/models/uniform.py:792-967``).  A stream needs only
# the last N - 1 spectra oldest first, so the ring's history gather on the
# way in and its rebuild on the way out become one write of the T new
# spectra into ``hist`` (``complex64 [h_cap, B+1]``, one tensor: the JAX
# package's plane split is a TPU layout rule).  ``pos`` (a host int) rows
# are occupied; rows ``>= pos`` are zero and ``pos >= N - 1`` (conversion
# and compaction establish both), so the m-row window starting N - 1 rows
# before the new spectra is the ring path's history, new spectra and zero
# pad.  While a stream is in CHRONO its ``segments`` is a one-row
# placeholder, so a ring consumer that forgot to convert fails on a shape.


def chrono_capacity(cfg: UniformConfig, t_hint: int = 0) -> int:
    """Default ``hist`` rows: slack for compaction to amortise over many
    calls, and at least a ``t_hint``-block call's window
    (``chrono_capacity``, ``fft_convolution_tpu/models/uniform.py:824``)."""
    n = cfg.seg_count
    return next_power_of_two(max(4 * n, n - 1 + t_hint, 8))


def chrono_fits(cfg: UniformConfig, h_cap: int, pos: int, t: int) -> bool:
    """Whether a ``t``-block call fits ``h_cap`` rows at ``pos`` without
    compaction (``chrono_fits``,
    ``fft_convolution_tpu/models/uniform.py:832``)."""
    n = cfg.seg_count
    return pos + t <= h_cap and pos - (n - 1) + meta_size(n, t) <= h_cap


def ring_to_chrono(cfg: UniformConfig, state: UniformState,
                   h_cap: int) -> tuple[torch.Tensor, int]:
    """Full clean ring -> CHRONO (``ring_to_chrono``,
    ``fft_convolution_tpu/models/uniform.py:840``): returns ``(hist, pos)``
    with the ring's last ``N - 1`` spectra oldest first at rows ``[0, N-1)``
    and ``pos = N - 1``; ``state.segments`` becomes a ``[1, B+1]``
    placeholder and ``current`` 0.  Precondition (the caller's):
    ``active_segs == seg_count``."""
    n = cfg.seg_count
    hist = state.segments.new_zeros((h_cap, cfg.bins))
    if n > 1:
        hist[:n - 1] = ring_window(state.segments, state.current)[1:]
    state.segments = state.segments.new_zeros((1, cfg.bins))
    state.current = 0
    return hist, n - 1


def chrono_to_ring(cfg: UniformConfig, state: UniformState, hist: torch.Tensor,
                   pos: int) -> None:
    """CHRONO -> ring, in place (``chrono_to_ring``,
    ``fft_convolution_tpu/models/uniform.py:868``): ``current = N - 1``,
    slot ``d - 1`` holds the block of delay ``d``, and the head slot, which
    the ring's next step overwrites unread, is zero."""
    n = cfg.seg_count
    ring = hist.new_zeros((n, cfg.bins))
    ring[:n - 1] = hist[pos - (n - 1):pos].flip(0)
    state.segments = ring
    state.current = n - 1


def chrono_compact(cfg: UniformConfig, hist: torch.Tensor, pos: int) -> int:
    """Move the live ``N - 1``-row window to the start of ``hist`` and zero
    the rows after it, in place (``chrono_compact``,
    ``fft_convolution_tpu/models/uniform.py:892``); returns the new ``pos``,
    ``N - 1``.  The caller calls it when :func:`chrono_fits` says no."""
    n = cfg.seg_count
    if n > 1:
        hist[:n - 1] = hist[pos - (n - 1):pos].clone()
    hist[n - 1:pos] = 0  # rows >= pos are zero already
    return n - 1


def stream_conv_chrono(cfg: UniformConfig, state: UniformState, hist: torch.Tensor,
                       pos: int, blocks: torch.Tensor,
                       kern_hat: torch.Tensor | None = None) -> torch.Tensor:
    """``blocks [T, B] -> y [T, B]`` through the conv core on the CHRONO
    history (``stream_conv_chrono_unguarded``,
    ``fft_convolution_tpu/models/uniform.py:912``): the T new spectra
    written in place at rows ``[pos, pos + T)`` of ``hist``, the causal
    convolution over the m-row window from ``pos - (N - 1)``, the inverse
    transforms and the overlap-add.  ``pre_multiplied`` follows the
    sequential identity, as in :func:`_stream_conv`.  The caller's host
    ``pos`` advances by T; it owns compaction (:func:`chrono_fits`) and
    the full-ring precondition.  ``stream_conv_chrono.calls`` counts the
    calls."""
    stream_conv_chrono.calls += 1
    b, n = cfg.block_size, cfg.seg_count
    t = blocks.shape[-2]
    m = meta_size(n, t)
    if not chrono_fits(cfg, hist.shape[-2], pos, t):
        raise ValueError(f"a {t}-block call at pos {pos} (window m={m}) overruns the "
                         f"{hist.shape[-2]}-row history; compact it first")
    specs = rdft_block(blocks, cfg.fft_size)
    hist[pos:pos + t] = specs
    start = pos - (n - 1)
    kern = state.segments_ir if kern_hat is not None else _table(cfg, state)
    convs = causal_conv_time(hist[start:start + m], kern, t, kern_hat=kern_hat, m=m)
    state.pre_multiplied = convs[-1] - specs[-1] * state.segments_ir[0]
    outs = irdft_block(convs, cfg.fft_size)
    y = outs[:, :b] + torch.cat([state.overlap[None], outs[:-1, b:]])
    state.overlap = outs[-1, b:].contiguous()
    return y


stream_conv_chrono.calls = 0


def process_stream(cfg: UniformConfig, state: UniformState, blocks: torch.Tensor,
                   kern_hat: torch.Tensor | None = None) -> torch.Tensor:
    """Batched streaming over ``blocks [..., T, B]`` (``process_stream``,
    ``fft_convolution_tpu/models/uniform.py:1054``); the state advances in
    place and ``y [..., T, B]`` is returned.

    The JAX package's gate: the conv core (:func:`stream_conv`) when the
    ring is clean (``current < active_segs``) and either the blocks are
    small and the stream long (``block_size <= 2048 and T >= 8``) or the
    caller brings the kernel meta-spectra (``kern_hat``, :func:`stream_khat`
    for this ``T``).  Otherwise the sequential :func:`process_block` loop,
    the exact semantics of the reference's ring (its scan counterpart is
    ``_stream_ring_scan``).  ``active_segs == 0`` returns zeros and leaves
    the state alone.  The scalars are host ints, so the gate costs no device
    round trip."""
    if state.active_segs == 0:
        return blocks.new_zeros(blocks.shape)
    t = blocks.shape[-2]
    use_conv = (cfg.block_size <= 2048 and t >= 8) or kern_hat is not None
    if use_conv and state.current < state.active_segs:
        return stream_conv(cfg, state, blocks, kern_hat)
    return torch.stack([process_block(cfg, state, blocks[..., i, :]) for i in range(t)],
                       dim=-2)


def process_partial(cfg: UniformConfig, state: UniformState, chunk: torch.Tensor,
                    length: int) -> torch.Tensor:
    """One iteration of the reference sub-block loop
    (``src/fft_convolver.rs:222-294``).  ``chunk`` holds ``length`` valid
    samples, with ``input_fill + length <= block_size``.  Returns the full
    ``block_size`` output lane; the caller slices
    ``[input_fill : input_fill + length]`` out of it."""
    b = cfg.block_size
    if state.active_segs == 0:
        return torch.zeros(b, device=chunk.device)
    offset = state.input_fill
    state.input_buffer[offset:offset + length] = chunk[:length]
    spec = torch.fft.rfft(state.input_buffer, n=cfg.fft_size)
    fft_buffer = _engine_step(cfg, state, spec, offset == 0)
    y_full = fft_buffer[:b] + state.overlap
    state.input_fill = offset + length
    if state.input_fill == b:
        _advance_ring(cfg, state, fft_buffer)
    return y_full
