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
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.fft import copy_and_pad, ir_to_spectra, next_power_of_two
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
    state.segments[state.current] = buffer_spec
    if recompute_pre:
        state.pre_multiplied = fdl_mac(state.segments, state.segments_ir,
                                       state.current, state.active_segs)
    conv = state.pre_multiplied + buffer_spec * state.segments_ir[0]
    return torch.fft.irfft(conv, n=cfg.fft_size)


def _advance_ring(cfg: UniformConfig, state: UniformState,
                  fft_buffer: torch.Tensor) -> None:
    """Block completion (``src/fft_convolver.rs:278-292``): clear the input
    buffer, save the new overlap, decrement the ring head."""
    state.input_buffer.zero_()
    state.input_fill = 0
    state.overlap = fft_buffer[cfg.block_size:].clone()
    state.current = state.current - 1 if state.current > 0 else state.active_segs - 1


def process_block(cfg: UniformConfig, state: UniformState,
                  x: torch.Tensor) -> torch.Tensor:
    """Process exactly one full block (the ``input_buffer_was_empty`` pass of
    ``src/fft_convolver.rs:215-295``).  Returns ``y`` ``[block_size]``."""
    if state.active_segs == 0:
        return torch.zeros(cfg.block_size, device=x.device)
    spec = torch.fft.rfft(x, n=cfg.fft_size)
    fft_buffer = _engine_step(cfg, state, spec, True)
    y = fft_buffer[: cfg.block_size] + state.overlap
    _advance_ring(cfg, state, fft_buffer)
    return y


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
