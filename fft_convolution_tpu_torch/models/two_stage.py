"""Two-stage (non-uniform partition) FFT convolution — counterpart of
``fft_convolution_tpu/models/two_stage.py`` and of the reference
``TwoStageFFTConvolver`` (``src/fft_convolver.rs:323-526``).

A small-block head gives low latency while two large-block tail stages give
efficiency; the tail outputs are precomputed one period ahead in double
buffers.  IR split (``:352-384``), with ``T = tail_block``:

* head:  ``ir[0 .. min(max_len, T)]``          at ``head_block``
* tail0: ``ir[T .. T + min(max_len - T, T)]``  at ``head_block``
* tail:  ``ir[2T ..]``                         at ``tail_block``

Absent stages are empty (zero-output) engines.  As in :mod:`.uniform`, the
functions update the state in place; :meth:`TwoStageState.clone` copies it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.fft import copy_and_pad, next_power_of_two
from . import uniform

# FFT cost constant k relative to a multiply-add, as suggested by García and
# used verbatim by the reference (``src/fft_convolver.rs:514-516``).
FFT_K = 1.5


def compute_tail_block_size(head_len: int, response_len: int) -> int:
    """García's optimal two-stage partition ("Optimal Filter Partition for
    Efficient Convolution with Short Input/Output Delay") — float32 math
    matching ``src/fft_convolver.rs:520-526`` exactly."""
    kn = np.float32(FFT_K * head_len) / np.float32(2.0 * np.log(2.0))
    b = -kn + np.float32(np.sqrt(np.float32(kn * kn)
                                 + np.float32(response_len) * np.float32(head_len)))
    b = max(float(b), float(head_len))
    return next_power_of_two(int(b))


@dataclasses.dataclass(frozen=True)
class TwoStageConfig:
    head_block: int
    tail_block: int
    head: uniform.UniformConfig
    tail0: Optional[uniform.UniformConfig]   # None when max_len <= tail_block
    tail: Optional[uniform.UniformConfig]    # None when max_len <= 2*tail_block

    @property
    def period(self) -> int:
        """Head blocks per tail period."""
        return self.tail_block // self.head_block


_BUFFERS = ("tail_output0", "tail_precalc0", "tail_output", "tail_precalc",
            "tail_input")


@dataclasses.dataclass
class TwoStageState:
    """``TwoStageFFTConvolver`` struct fields (``src/fft_convolver.rs:324-337``)."""

    head: uniform.UniformState
    tail0: uniform.UniformState
    tail: uniform.UniformState
    tail_output0: torch.Tensor    # f32 [tail_block]
    tail_precalc0: torch.Tensor   # f32 [tail_block]
    tail_output: torch.Tensor     # f32 [tail_block]
    tail_precalc: torch.Tensor    # f32 [tail_block]
    tail_input: torch.Tensor      # f32 [tail_block]
    tail_fill: int
    precalc_pos: int

    def clone(self) -> "TwoStageState":
        return dataclasses.replace(
            self, head=self.head.clone(), tail0=self.tail0.clone(),
            tail=self.tail.clone(),
            **{k: getattr(self, k).clone() for k in _BUFFERS})


def init(response, block_size: int, max_response_length: int,
         device="cpu") -> tuple[TwoStageConfig, TwoStageState]:
    """``Convolution::init`` (``src/fft_convolver.rs:340-406``)."""
    response = torch.as_tensor(response, dtype=torch.float32, device=device)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    head_block = block_size
    tail_block = compute_tail_block_size(block_size, max_response_length)
    padded = copy_and_pad(response, max_response_length)

    head_ir_len = min(max_response_length, tail_block)
    head_cfg, head_state = uniform.init(padded[:head_ir_len], head_block,
                                        head_ir_len, device)
    tail0_cfg = tail_cfg = None
    if max_response_length > tail_block:
        t0_len = min(max_response_length - tail_block, tail_block)
        tail0_cfg, tail0_state = uniform.init(
            padded[tail_block:tail_block + t0_len], head_block, t0_len, device)
    else:
        _, tail0_state = uniform.empty(head_block, device)
    if max_response_length > 2 * tail_block:
        t_len = max_response_length - 2 * tail_block
        tail_cfg, tail_state = uniform.init(padded[2 * tail_block:], tail_block,
                                            t_len, device)
    else:
        _, tail_state = uniform.empty(tail_block, device)

    cfg = TwoStageConfig(head_block=head_block, tail_block=tail_block,
                         head=head_cfg, tail0=tail0_cfg, tail=tail_cfg)
    state = TwoStageState(
        head=head_state, tail0=tail0_state, tail=tail_state,
        **{k: torch.zeros(tail_block, device=device) for k in _BUFFERS},
        tail_fill=0, precalc_pos=0,
    )
    return cfg, state


def update(cfg: TwoStageConfig, state: TwoStageState, response_padded: torch.Tensor,
           new_len: int) -> None:
    """EXTENSION — the reference leaves ``update`` as ``todo!()``
    (``src/fft_convolver.rs:408-410``).  Each stage re-derives its IR slice
    as at init and takes the uniform engine's RT-safe swap; input history
    and the period schedule are kept, and the precalculated tail buffers
    are zeroed.  ``response_padded`` is zero-padded to the init
    ``max_response_length``."""
    tb = cfg.tail_block
    stages = ((cfg.head, state.head, 0), (cfg.tail0, state.tail0, tb),
              (cfg.tail, state.tail, 2 * tb))
    for scfg, sstate, lo in stages:
        if scfg is None:
            continue
        cap = scfg.ir_len
        uniform.update(
            scfg, sstate,
            copy_and_pad(response_padded[lo:lo + cap], scfg.seg_count * scfg.block_size),
            min(max(new_len - lo, 0), cap),
        )
    for k in ("tail_output0", "tail_precalc0", "tail_output", "tail_precalc"):
        getattr(state, k).zero_()


def reset(cfg: TwoStageConfig, state: TwoStageState) -> None:
    """``Convolution::reset`` (``src/fft_convolver.rs:497-511``)."""
    del cfg
    for s in (state.head, state.tail0, state.tail):
        uniform.reset(s)
    for k in _BUFFERS:
        getattr(state, k).zero_()
    state.tail_fill = 0
    state.precalc_pos = 0


def _period_end(cfg: TwoStageConfig, state: TwoStageState) -> None:
    """The double swap and the big-tail step at the end of a period
    (``src/fft_convolver.rs:473-491``)."""
    if cfg.tail0 is not None:
        state.tail_precalc0, state.tail_output0 = state.tail_output0, state.tail_precalc0
    if cfg.tail is not None:
        new_out = uniform.process_block(cfg.tail, state.tail, state.tail_input)
        state.tail_precalc, state.tail_output = state.tail_output, new_out


def process_block(cfg: TwoStageConfig, state: TwoStageState,
                  x: torch.Tensor) -> torch.Tensor:
    """Process one full head block (``src/fft_convolver.rs:412-495``): sum
    both precalculated tails at ``precalc_pos`` (``:439-456``), append to the
    period input (``:459-461``), advance tail0 by one head block
    (``:464-476``), and at period end swap both precalc buffers and run the
    big tail over the full period (``:479-491``)."""
    b = cfg.head_block
    y = uniform.process_block(cfg.head, state.head, x)
    pos, fill = state.precalc_pos, state.tail_fill
    y = y + state.tail_precalc0[pos:pos + b]
    y = y + state.tail_precalc[pos:pos + b]
    state.tail_input[fill:fill + b] = x
    if cfg.tail0 is not None:
        state.tail_output0[fill:fill + b] = uniform.process_block(cfg.tail0, state.tail0, x)
    fill += b
    if fill == cfg.tail_block:
        _period_end(cfg, state)
        fill = 0
    state.tail_fill = state.precalc_pos = fill
    return y


def process_partial(cfg: TwoStageConfig, state: TwoStageState, chunk: torch.Tensor,
                    length: int) -> torch.Tensor:
    """One iteration of the reference sub-block loop
    (``src/fft_convolver.rs:427-494``) for a chunk that does not cross a
    head-block boundary.  Returns the full head-block output lane; the
    caller slices ``[fill % head : fill % head + length]``.  Uses the
    reference invariant ``precalc_pos == tail_fill`` (``:456,461,488-491``)."""
    b = cfg.head_block
    fill = state.tail_fill
    base = fill - fill % b
    y_full = uniform.process_partial(cfg.head, state.head, chunk, length)
    y_full = y_full + state.tail_precalc0[base:base + b]
    y_full = y_full + state.tail_precalc[base:base + b]
    state.tail_input[fill:fill + length] = chunk[:length]
    fill += length
    if fill % b == 0 and cfg.tail0 is not None:
        state.tail_output0[fill - b:fill] = uniform.process_block(
            cfg.tail0, state.tail0, state.tail_input[fill - b:fill])
    if fill == cfg.tail_block:
        _period_end(cfg, state)
        fill = 0
    state.tail_fill = state.precalc_pos = fill
    return y_full
