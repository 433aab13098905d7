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

Period-aligned streams (:func:`process_stream_aligned`) run the three
stages as batched streams whose outputs sum with fixed period delays: head
and tail0 through one fused front end (one transform, one ring rebuild,
the combined ``2n``-segment kernel) where their rings allow it, the big
tail through the ring's conv core or, for the wrapper, through the
chronological CHRONO history (:func:`tail_to_chrono`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.fft import (causal_conv_khat, causal_conv_multi, copy_and_pad, irdft_block,
                       next_power_of_two, rdft_block)
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
           new_len: int, tail_update: Callable = uniform.update) -> None:
    """EXTENSION — the reference leaves ``update`` as ``todo!()``
    (``src/fft_convolver.rs:408-410``).  Each stage re-derives its IR slice
    as at init and takes the uniform engine's RT-safe swap; input history
    and the period schedule are kept, and the precalculated tail buffers
    are zeroed.  ``response_padded`` is zero-padded to the init
    ``max_response_length``.  ``tail_update`` swaps the big tail's IR (the
    sharded tail's is :func:`..parallel.partition.update`)."""
    tb = cfg.tail_block
    stages = ((cfg.head, state.head, 0), (cfg.tail0, state.tail0, tb),
              (cfg.tail, state.tail, 2 * tb))
    for (scfg, sstate, lo), stage_update in zip(stages, (uniform.update,) * 2 + (tail_update,)):
        if scfg is None:
            continue
        cap = scfg.ir_len
        stage_update(
            scfg, sstate,
            copy_and_pad(response_padded[lo:lo + cap], scfg.seg_count * scfg.block_size),
            min(max(new_len - lo, 0), cap),
        )
    for k in ("tail_output0", "tail_precalc0", "tail_output", "tail_precalc"):
        getattr(state, k).zero_()


def reset(cfg: TwoStageConfig, state: TwoStageState,
          tail_reset: Callable = uniform.reset) -> None:
    """``Convolution::reset`` (``src/fft_convolver.rs:497-511``).
    ``tail_reset`` clears the big tail (the sharded tail's is
    :func:`..parallel.partition.reset`)."""
    del cfg
    uniform.reset(state.head)
    uniform.reset(state.tail0)
    tail_reset(state.tail)
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


# Big-tail routing (``TAIL_CONV_RATIO``, ``fft_convolution_tpu/models/
# two_stage.py:617-637``): the sequential ring reads the whole ring per
# block (bytes ~ q * N), the conv core's block-axis transforms cost ~m rows
# each whatever q is; the JAX package measured the conv core ahead from
# q * N >= 5 m.  The port keeps its rule until an H100 profile asks for
# another.
TAIL_CONV_RATIO = 5


def tail_uses_conv_core(cfg: TwoStageConfig, t: int) -> bool:
    """Whether a ``t``-head-block aligned call runs its big tail through the
    conv core (``tail_uses_conv_core``,
    ``fft_convolution_tpu/models/two_stage.py:629``)."""
    if cfg.tail is None:
        return False
    q = t // cfg.period
    n = cfg.tail.seg_count
    return q * n >= TAIL_CONV_RATIO * uniform.meta_size(n, q)


def small_stream_khats(cfg: TwoStageConfig, state: TwoStageState, t: int) -> dict:
    """The separate head and tail0 streams' kernel meta-spectra for
    ``t``-block calls: ``head`` and ``t0`` (:func:`.uniform.stream_khat`;
    ``t0`` None without a tail0 stage)."""
    return {"head": uniform.stream_khat(cfg.head, state.head, t),
            "t0": (uniform.stream_khat(cfg.tail0, state.tail0, t)
                   if cfg.tail0 is not None else None)}


def stream_khats(cfg: TwoStageConfig, state: TwoStageState, t: int,
                 want_tail: bool | None = None) -> dict:
    """The stages' kernel meta-spectra for ``t``-block aligned calls
    (``stream_khats``, ``fft_convolution_tpu/models/two_stage.py:640``):
    :func:`small_stream_khats`; ``tail`` when :func:`tail_uses_conv_core`
    sends the big tail to the conv core, or as ``want_tail`` says (the
    CHRONO tail serves every call length through the conv core, so its
    callers pass True); and where the stage configs fuse, ``comb`` (the
    combined kernel's, :func:`combined_head_kernel`) with ``t0f`` (tail0's
    table at the same meta size, the MULTI form) or ``small`` and ``rec``
    (the SEPARATE side passes' sizes), per :func:`fused_uses_multi`.
    Input-independent between IR updates; pass to
    :func:`process_stream_aligned` as ``khats=``."""
    out = small_stream_khats(cfg, state, t)
    use_tail = (tail_uses_conv_core(cfg, t) if want_tail is None
                else want_tail and cfg.tail is not None)
    if use_tail:
        out["tail"] = uniform.stream_khat(cfg.tail, state.tail, t // cfg.period)
    if cfg.tail0 is not None and cfg.head == cfg.tail0:
        n, t0_ir = cfg.head.seg_count, state.tail0.segments_ir
        m_comb = next_power_of_two(t + 2 * n - 1)
        out["comb"] = causal_conv_khat(combined_head_kernel(state.head, state.tail0), m_comb)
        if fused_uses_multi(cfg, t):
            out["t0f"] = causal_conv_khat(t0_ir, m_comb)
        else:
            out["small"] = causal_conv_khat(t0_ir, 2 * n)
            out["rec"] = causal_conv_khat(t0_ir, next_power_of_two(n - 1 + _rec_rows(cfg, t)))
    return out


def combined_head_kernel(st_h: uniform.UniformState,
                         st_t0: uniform.UniformState) -> torch.Tensor:
    """The combined head+tail0 table ``[..., 2n, B+1]``: segment ``n + j``
    is tail0's segment ``j``, applied ``n`` blocks (one period) later
    (``_combined_head_kernel``,
    ``fft_convolution_tpu/parallel/farm2.py:837``).  The single-voice fused
    front end and the farm's heads share it."""
    return torch.cat([st_h.segments_ir, st_t0.segments_ir], dim=-2)


# The fused front end's two forms of its side passes (the first-period
# subtract and the exit-state rows), ``FUSED_MULTI_MAX_ROWS``
# (``fft_convolution_tpu/models/two_stage.py:417-434``): MULTI, rows of one
# tail0-table convolution against the shared ext, one forward transform and
# one inverse for the whole front end, but a tail0 product across all n + T
# rows; SEPARATE, two small convolutions whose sizes do not grow with T.
# The JAX package's crossover, kept until an H100 measurement asks for
# another (``chip_smoke.py`` phase 15 prints both at the flagship).
FUSED_MULTI_MAX_ROWS = 2048


def fused_uses_multi(cfg: TwoStageConfig, t: int) -> bool:
    """Whether a ``t``-block fused call takes the MULTI form
    (``fused_uses_multi``, ``fft_convolution_tpu/models/two_stage.py:437``)."""
    return t + cfg.head.seg_count <= FUSED_MULTI_MAX_ROWS


def _rec_rows(cfg: TwoStageConfig, t: int) -> int:
    """tail0's raw rows the fused exit state is rebuilt from: the last
    ``min(q, 2)`` periods and one block before them."""
    return min(t // cfg.period, 2) * cfg.period + 1


def _fused_small_streams(cfg: TwoStageConfig, state: TwoStageState, blocks: torch.Tensor,
                         khats: dict) -> torch.Tensor:
    """``head(x) + delay_1_period(tail0(x))`` for ``blocks [..., T, B]``
    through one forward transform, one ring rebuild and the combined
    ``2n``-segment kernel (``_fused_small_streams``,
    ``fft_convolution_tpu/models/two_stage.py:444``); updates both stages,
    ``tail_precalc0`` and ``tail_output0`` in place and returns ``y``.
    ``_fused_small_streams.calls`` counts the calls.

    With one config the two rings are equal, and the period equals the
    segment count, so tail0's one-period delay is a shift of its kernel by
    ``n`` segments.  The ring gives the ``n``-block history; the combined
    kernel's reads before it land in the zero pad (``m`` >= ``T + 2n - 1``).
    Two side passes keep the sequential schedule's contract: the first
    period's tail0 part comes from ``tail_precalc0``, so the delayed terms
    the combined kernel forms from the history (rows ``[0, p)`` of tail0's
    convolution) are subtracted, and tail0's overlap joins at row ``p``;
    the exit state (tail0's overlap, its last two periods' output, the head
    overlap without the delayed part) comes from rows ``[T + n - nrec, T +
    n)`` of tail0's convolution.  MULTI takes both from one tail0
    convolution over the shared transform, SEPARATE from two small ones
    (:func:`fused_uses_multi`).

    Precondition (:func:`process_stream_aligned`'s host-int guard): both
    rings full (``active_segs == n``) with one ``current < n``."""
    _fused_small_streams.calls += 1
    hcfg, st_h, st_t0 = cfg.head, state.head, state.tail0
    b, n, p = hcfg.block_size, hcfg.seg_count, cfg.period
    t = blocks.shape[-2]
    q = t // p
    lead = blocks.shape[:-2]
    kh = khats or {}
    specs = rdft_block(blocks, hcfg.fft_size)                     # [..., T, B+1]
    window = uniform.ring_window(st_h.segments, st_h.current)    # blocks -n..-1
    ext = torch.cat([window, specs], dim=-2)                      # [..., n + T, B+1]
    m_comb = next_power_of_two(t + 2 * n - 1)
    nrec = _rec_rows(cfg, t)
    t0_ir = st_t0.segments_ir
    comb = combined_head_kernel(st_h, st_t0) if kh.get("comb") is None else None
    if fused_uses_multi(cfg, t):
        conv, t0full = causal_conv_multi(ext, [comb, t0_ir], [(n, t), (0, n + t)], m=m_comb,
                                         kern_hats=[kh.get("comb"), kh.get("t0f")])
        w = t0full[..., :p, :]
        conv0 = t0full[..., t + n - nrec:, :]
    else:
        (conv,) = causal_conv_multi(ext, [comb], [(n, t)], m=m_comb,
                                    kern_hats=[kh.get("comb")])
        # tail0 over the history window alone, rows [0, p): reads before it
        # wrap into the 2n-row pad
        (w,) = causal_conv_multi(window, [t0_ir], [(0, p)], m=2 * n,
                                 kern_hats=[kh.get("small")])
        (conv0,) = causal_conv_multi(ext[..., t - nrec + 1:, :], [t0_ir], [(n - 1, nrec)],
                                     m=next_power_of_two(n - 1 + nrec),
                                     kern_hats=[kh.get("rec")])
    conv[..., :p, :] -= w
    raw = irdft_block(torch.cat([conv, conv0], dim=-2), hcfg.fft_size)  # [..., T + nrec, 2B]
    outs, raw0 = raw[..., :t, :], raw[..., t:, :]
    y = outs[..., :b] + torch.cat([st_h.overlap[..., None, :], outs[..., :-1, b:]], dim=-2)
    # the first period's tail0 part is the carried tail_precalc0; row p's
    # overlap from the first period is head-only after the subtract, so
    # tail0's own overlap joins there
    y[..., :p, :] += state.tail_precalc0.reshape(*lead, p, b)
    if t > p:
        y[..., p, :] += st_t0.overlap
    out0 = raw0[..., 1:, :b] + raw0[..., :-1, b:]                  # tail0's blocks [T-nrec+1, T)
    if q <= 2:
        # block 0's seam is tail0's carried overlap, not block -1's raw tail
        # rebuilt from the history: they differ after an update, which
        # zeroes the overlap (the JAX package's form takes the raw tail)
        out0[..., 0, :] = raw0[..., 1, :b] + st_t0.overlap
    output0 = out0[..., :p, :].reshape(*lead, p * b) if q >= 2 else state.tail_precalc0
    state.tail_precalc0, state.tail_output0 = out0[..., -p:, :].reshape(*lead, p * b), output0
    # the shared ring, the head overlap without tail0's delayed part
    # (raw0's row -(p + 1) is tail0's raw block T - 1 - p), tail0's overlap
    cur = (st_h.current - t) % n
    segments, byd = uniform.ring_from_ext(ext, n + t, n, cur)
    for st in (st_h, st_t0):
        st.pre_multiplied = (st.segments_ir[..., 1:, :] * byd[..., 1:, :]).sum(dim=-2)
        st.current = cur
    st_h.overlap = outs[..., -1, b:] - raw0[..., -(p + 1), b:] if t > p \
        else outs[..., -1, b:].contiguous()
    st_t0.overlap = raw0[..., -1, b:].contiguous()
    st_h.segments, st_t0.segments = segments, segments.clone()
    return y


_fused_small_streams.calls = 0


def tail_to_chrono(cfg: TwoStageConfig, state: TwoStageState,
                   h_cap: int) -> tuple[torch.Tensor, int]:
    """The big tail's ring into the CHRONO history, in place
    (``tail_to_chrono``, ``fft_convolution_tpu/models/two_stage.py:690``):
    returns ``(hist, pos)`` (:func:`.uniform.ring_to_chrono`).
    Precondition: the tail ring is full."""
    return uniform.ring_to_chrono(cfg.tail, state.tail, h_cap)


def tail_from_chrono(cfg: TwoStageConfig, state: TwoStageState,
                     tail_chrono: tuple[torch.Tensor, int]) -> None:
    """The big tail's ring rebuilt from ``(hist, pos)``, in place
    (``tail_from_chrono``, ``fft_convolution_tpu/models/two_stage.py:702``):
    every ring consumer takes the result."""
    uniform.chrono_to_ring(cfg.tail, state.tail, *tail_chrono)


def tail_chrono_compact(cfg: TwoStageConfig, tail_chrono: tuple[torch.Tensor, int]) -> int:
    """:func:`.uniform.chrono_compact` of the big tail's history
    (``tail_chrono_compact``, ``fft_convolution_tpu/models/two_stage.py:715``);
    returns the new ``pos``."""
    return uniform.chrono_compact(cfg.tail, *tail_chrono)


def process_stream_aligned(cfg: TwoStageConfig, state: TwoStageState,
                           blocks: torch.Tensor, khats: dict | None = None,
                           big_stream: Callable | None = None, fuse_small: bool = True,
                           tail_chrono: tuple[torch.Tensor, int] | None = None
                           ) -> torch.Tensor:
    """Period-aligned batched streaming (``process_stream_aligned``,
    ``fft_convolution_tpu/models/two_stage.py:726``): ``blocks [..., T, B]
    -> y [..., T, B]`` with ``T`` a multiple of the period and ``tail_fill
    == 0`` (the caller checks); leading axes are voices of one lockstep
    state.

    The double-buffered tails of the sequential schedule
    (``src/fft_convolver.rs:439-456,473-486``) make the stages independent
    streams:

        y = head(x) + delay_1_period(tail0(x)) + delay_2_periods(tail(x))

    Head and tail0 (at the head block, over the same blocks) take the fused
    front end (:func:`_fused_small_streams`) when ``fuse_small``, their
    configs are one, and a guard on host ints holds: both rings full and
    clean with one ``current`` (the reference's shortcut omits the
    ``current`` check, ROADMAP C1).  Otherwise each takes
    :func:`.uniform.process_stream` with its ``khats`` entry.  The big tail
    runs at the tail block over period-sized superblocks: through
    :func:`.uniform.stream_conv_chrono` on ``tail_chrono = (hist, pos)``
    when given (``state.tail`` in the CHRONO convention, the call fitting
    the history; the caller advances ``pos`` by ``T / period`` and owns
    compaction), else through ``big_stream(tail_cfg, tail_state, rows [q,
    tail_block]) -> [q, tail_block]`` (the sharded tail of
    :mod:`..parallel.two_stage_sp`), else :func:`.uniform.process_stream`.
    The exit state holds the sequential schedule's buffers exactly, so the
    aligned and block paths interleave freely."""
    b, tb, p = cfg.head_block, cfg.tail_block, cfg.period
    t = blocks.shape[-2]
    q = t // p
    if q * p != t or q == 0:
        raise ValueError(f"T={t} must be a positive multiple of the period {p}")
    lead = blocks.shape[:-2]
    kh = khats or {}
    n = cfg.head.seg_count
    sh, s0 = state.head, state.tail0
    if (fuse_small and cfg.tail0 is not None and cfg.head == cfg.tail0
            and sh.active_segs == n and s0.active_segs == n
            and sh.current < n and sh.current == s0.current):
        y = _fused_small_streams(cfg, state, blocks, kh)
        yq = y.view(*lead, q, tb)
    else:
        y = uniform.process_stream(cfg.head, sh, blocks, kh.get("head"))
        yq = y.view(*lead, q, tb)
        if cfg.tail0 is not None:
            out0 = uniform.process_stream(cfg.tail0, s0, blocks,
                                          kh.get("t0")).view(*lead, q, tb)
            yq[..., 0, :] += state.tail_precalc0
            yq[..., 1:, :] += out0[..., :-1, :]
            output0 = out0[..., -2, :].clone() if q >= 2 else state.tail_precalc0
            state.tail_precalc0, state.tail_output0 = out0[..., -1, :].clone(), output0
    if cfg.tail is not None:
        rows = blocks.reshape(*lead, q, tb)
        if tail_chrono is not None:
            out_t = uniform.stream_conv_chrono(cfg.tail, state.tail, *tail_chrono, rows,
                                               kh.get("tail"))
        elif big_stream is not None:
            out_t = big_stream(cfg.tail, state.tail, rows)
        else:
            out_t = uniform.process_stream(cfg.tail, state.tail, rows, kh.get("tail"))
        yq[..., 0, :] += state.tail_precalc
        if q >= 2:
            yq[..., 1, :] += state.tail_output
        yq[..., 2:, :] += out_t[..., :-2, :]
        precalc = out_t[..., -2, :].clone() if q >= 2 else state.tail_output
        state.tail_precalc, state.tail_output = precalc, out_t[..., -1, :].clone()
    state.tail_input = blocks[..., t - p:, :].reshape(*lead, tb).clone()
    state.tail_fill = state.precalc_pos = 0
    return y
