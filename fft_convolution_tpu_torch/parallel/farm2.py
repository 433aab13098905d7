"""Two-stage reverb farm: V voices with distinct long IRs on one device —
counterpart of ``fft_convolution_tpu/parallel/farm2.py`` (single device).

The stream is the aligned two-stage decomposition
``y = head(x) + delay_1(tail0(x)) + delay_2(tail(x))`` in whole tail periods:

* **head + tail0** (block ``B``): voice-stacked uniform stages
  (:mod:`.farm`) that share the head's ring.  With the big tail present the
  period is exactly the head's segment count ``n``, so tail0's one-period
  delay is a shift of ``n`` segments, and one combined ``2n``-segment
  kernel (:func:`..models.two_stage.combined_head_kernel`) gives ``head +
  delay_1(tail0)`` in one causal convolution along the block axis: on the
  card kernel B6 (:mod:`..ops.cuda_farm_heads`: the forward transforms, one
  thread block a (voice, bin) column, the inverse transforms and the delay
  line), on the CPU its plain version over ``torch.fft``.  The ``n - 1``
  input spectra before the ring are the state's own ``hist`` field.
* **big tail** (block ``tb``): a fused ring and table of ``[N, V, tb+1]``
  bins (bf16 pairs with ``tail_dtype=torch.bfloat16``) stepped by kernel B5
  (:mod:`..ops.cuda_farm_mac`) with a phase scalar ``q``: the ring rows stay
  where they are and the table window moves, so a call reads the ring and
  the table once and writes T ring rows.  The tail's forward and inverse
  transforms run on ``torch.fft`` around the kernel, as the JAX package runs
  them around its Pallas kernel.

The tail's segment count is padded to a multiple of 8 (live-but-silent zero
segments, ``src/fft_convolver.rs:111-118``), so the phase modulus and the
per-call ceiling equal the JAX package's and :func:`..interop.farm_state`
maps its states row for row.  State tensors are updated in place; the
lockstep scalars are host ints.  Updates keep every ring full at stage
capacity (``PARITY.md`` divergence 5).

The short-IR farm (``max_response_length <= 2 x tail block``, no big tail:
``cfg.tail is None``) keeps a voice-stacked
:class:`~..models.two_stage.TwoStageState` and streams through
:func:`..models.two_stage.process_stream_aligned` over the voice axis, each
small stage on the uniform conv core (``farm2_stream``'s ``cfg.tail is
None`` branch, ``fft_convolution_tpu/parallel/farm2.py:1071-1079``).

Across ranks: the voice axis is split over the mesh's ``"dp"`` dimension.
A rank's slab, :func:`voice_slab` of its ``mesh.voice_range`` (the JAX
package's ``farm2_shard``), holds the head-side stages, the big tail's
fused ``[N, V/w, tb+1]`` ring and table and the period buffers of its
voices; the lockstep scalars (``q``, ``current``) are the same on every
rank.  Each rank streams its slab through :func:`farm2_stream`
(``farm2_stream_sharded``; kernel B5 on ``V/w`` voices for a farm on the
card, the aligned path for a short-IR farm); the audio path has no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import two_stage, uniform
from ..models.two_stage import (TwoStageConfig, TwoStageState, combined_head_kernel,
                                compute_tail_block_size)
from ..ops import cuda_farm_heads, cuda_farm_mac
from ..ops.cuda_engine import to_bf16
from ..ops.fft import causal_conv_khat, irdft_block, next_power_of_two, rdft_block
from . import farm

TAIL_DTYPES = (torch.float32, torch.bfloat16)
_SUB = 8  # tail segments are padded to a multiple of this (see the module note)
_CHUNK = 8  # voices per tail-table build: bounds its transient


@dataclasses.dataclass
class TailState:
    """The big tail, voices fused on the lane axis."""

    ring: torch.Tensor     # phased input spectra [N, V, tb+1]: c64, or bf16 [.., 2]
    table: torch.Tensor    # IR partition spectra, same shape and dtype
    overlap: torch.Tensor  # f32 [V, tb]
    pre: torch.Tensor      # c64 [V, tb+1]: conv[T-1] minus the newest block's term
    q: int                 # phase, in [0, N)

    def clone(self) -> "TailState":
        return TailState(self.ring.clone(), self.table.clone(), self.overlap.clone(),
                         self.pre.clone(), self.q)


@dataclasses.dataclass
class Farm2State:
    head: uniform.UniformState   # voice-stacked; its ring feeds head and tail0
    tail0: uniform.UniformState  # voice-stacked; only its table is read
    tail: TailState
    hist: torch.Tensor           # c64 [V, n-1, B+1]: blocks -(2n-1)..-(n+1)
    tail_output: torch.Tensor    # f32 [V, tb]: pending big-tail outputs
    tail_precalc: torch.Tensor   # f32 [V, tb]
    suppress: torch.Tensor       # host bool [V]: updated right before this call

    def clone(self) -> "Farm2State":
        return Farm2State(self.head.clone(), self.tail0.clone(), self.tail.clone(),
                          self.hist.clone(), self.tail_output.clone(),
                          self.tail_precalc.clone(), self.suppress.clone())


def _tail_segments(block_size: int, max_response_length: int) -> tuple[int, int]:
    """``(tb, N)``: the tail block and the big tail's padded segment count."""
    tb = compute_tail_block_size(block_size, max_response_length)
    n_t = -(-max(max_response_length - 2 * tb, 0) // tb)
    return tb, -(-n_t // _SUB) * _SUB


def farm2_bytes_per_voice(block: int, ir_len: int, t_blocks: int,
                          tail_item: int = 8) -> int:
    """Device bytes per voice from the port's shapes: the capacity model
    behind :func:`farm2_init`'s guard (``farm2_bytes_per_voice``,
    ``fft_convolution_tpu/parallel/farm2.py:178``).

    State: head and tail0 stages (ring and table ``complex64 [n, B+1]``
    each, buffers), ``hist``, the big tail's ring and single table
    (``N x (tb+1)`` bins of ``tail_item`` bytes: 8 complex64, 4 bf16), its
    pre and overlap, the two pending period buffers.  No meta-spectra:
    kernel B6 transforms the raw tables.  Transients of a ``t_blocks`` call
    of ``q`` tail blocks, the larger of its two phases: the big tail (run
    first) holds its inverse transform's operands, the B5 sums, cuFFT's copy
    of them and cuFFT's workspace (``3q x (tb+1)`` complex64: the workspace
    taken as one more operand, as measured) and the samples (``q x 2tb``
    f32); the head path (B6) its bins-major spectra and convolution (``2T x
    (B+1)`` complex64), the output ``y`` (``T x B`` f32; the caller's input
    is not counted) and the tail rows it adds (``q x tb`` f32).  B5 keeps no
    ring-sized temporary and B6 no ``m``-sized one.  On the card the model
    is within 2 % of the measured peak (the state held plus
    ``torch.cuda.max_memory_allocated`` over an 8-period call and over a
    4096-block call, the guard's own length, of 128 voices of 60 s IRs at
    block 128, f32 and bf16 tails: ``chip_smoke.py`` phase 13, which gates
    it); it does not count the caching allocator's rounding.

    The short-IR farm (no big tail) streams through the block-axis conv
    core: its state holds the cached meta-spectra ``[m, B+1]``, ``m =
    npo2(2n - 1 + t_blocks)``, and a call four transients of that size."""
    tb, n_t = _tail_segments(block, ir_len)
    n = tb // block
    bins, tbins = block + 1, tb + 1

    def stage(rows: int, width: int, nb: int, item: int = 8) -> int:
        return 2 * rows * nb * item + 2 * width * 4 + nb * 8

    q = -(-t_blocks * block // tb)
    state = (2 * stage(n, block, bins) + stage(n_t, tb, tbins, tail_item)
             + (n - 1) * bins * 8 + 2 * tb * 4)
    if n_t == 0:
        m = next_power_of_two(2 * n - 1 + t_blocks)
        return state + 5 * m * bins * 8 + q * (2 * tbins * 8 + 2 * tb * 4)
    tail = q * (3 * tbins * 8 + 2 * tb * 4)
    heads = 2 * t_blocks * bins * 8 + t_blocks * block * 4 + q * tb * 4
    return state + max(tail, heads)


def _stage_slice(irs: torch.Tensor, lo: int, cap: int, total: int) -> torch.Tensor:
    """``irs[:, lo:lo + cap]`` zero-padded to ``total`` samples."""
    sl = irs[:, lo:lo + cap]
    return torch.nn.functional.pad(sl, (0, total - sl.shape[1]))


def _write_tail_table(cfg: TwoStageConfig, table: torch.Tensor, irs: torch.Tensor,
                      voices: torch.Tensor) -> None:
    """Table columns of ``voices`` from ``irs [K, L]`` (full-capacity
    slices), in chunks of voices so the transient stays one chunk's
    spectra."""
    tcfg, tb = cfg.tail, cfg.tail_block
    total = tcfg.seg_count * tb
    for c0 in range(0, irs.shape[0], _CHUNK):
        piece = _stage_slice(irs[c0:c0 + _CHUNK], 2 * tb, tcfg.ir_len, total)
        spec = farm.stage_spectra(tcfg, piece).transpose(0, 1)  # [N, c, tb+1]
        table[:, voices[c0:c0 + _CHUNK]] = spec if table.is_complex() else to_bf16(spec)


def farm2_init(irs, block_size: int, max_response_length: int,
               tail_dtype: torch.dtype = torch.float32, hbm_budget_bytes="auto",
               device=None) -> tuple[TwoStageConfig, Farm2State | TwoStageState]:
    """V two-stage voices from ``irs [V, ir_len]`` (``farm2_init``,
    ``fft_convolution_tpu/parallel/farm2.py:231``) on ``device`` (default:
    where ``irs`` is).  ``tail_dtype=torch.bfloat16`` stores the big tail's
    ring and table as bf16 pairs (half the bytes kernel B5 reads; arithmetic
    stays float32).  A short-IR farm (no big tail) gets a voice-stacked
    :class:`TwoStageState`.

    ``hbm_budget_bytes``: the eager capacity guard.  A farm whose estimate
    (:func:`farm2_bytes_per_voice` x V, at the largest call the farm takes)
    exceeds the budget raises ``ValueError`` at construction instead of
    running out of memory later.  ``"auto"`` is the CUDA device's free
    memory, and no check on the CPU; a number pins it; None disables it.

    On the card a farm with a big tail runs its head path on kernel B6,
    which takes ``4 <= block_size <= 2048`` and at most 1024 head segments
    (``tail_block / block_size``; :func:`..ops.cuda_farm_heads.heads_plan`):
    other shapes raise ``ValueError`` here.
    """
    irs = torch.as_tensor(irs, dtype=torch.float32, device=device)
    if irs.ndim != 2:
        raise ValueError("irs must be [voices, ir_len]")
    v = irs.shape[0]
    if max_response_length < irs.shape[1]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    if block_size < 1 or block_size & (block_size - 1):
        raise ValueError(f"block_size must be a power of two, got {block_size}")
    if tail_dtype not in TAIL_DTYPES:
        raise ValueError(f"tail_dtype must be one of {TAIL_DTYPES}, got {tail_dtype}")
    tb, n_t = _tail_segments(block_size, max_response_length)
    if n_t and irs.is_cuda:
        cuda_farm_heads.heads_plan(tb // block_size, block_size, tb // block_size)
    if hbm_budget_bytes == "auto":
        hbm_budget_bytes = farm.device_budget(irs.device)
    if hbm_budget_bytes is not None:
        tail_item = 4 if tail_dtype == torch.bfloat16 else 8
        # the short-IR farm takes calls of any length: its estimate is at one
        # period
        per_voice = farm2_bytes_per_voice(
            block_size, max_response_length,
            max_blocks_per_call(tb // block_size, n_t) if n_t else tb // block_size,
            tail_item)
        est = v * per_voice
        if est > hbm_budget_bytes:
            fit = max(1, int(hbm_budget_bytes // per_voice))
            raise ValueError(
                f"farm of {v} voices x {max_response_length} samples needs "
                f"~{est / 1e9:.2f} GB (~{per_voice / 1e6:.1f} MB/voice incl. stream "
                f"transients) > the {hbm_budget_bytes / 1e9:.2f} GB device budget — "
                f"~{fit} voices fit this budget"
                + ("" if tail_item == 4 else
                   "; tail_dtype=torch.bfloat16 halves the tail ring and table")
                + ". Pass hbm_budget_bytes=<bytes>/None to retune/disable this "
                "check (farm2_bytes_per_voice is the model).")
    dev = irs.device
    if n_t == 0:
        return _short_init(irs, block_size, max_response_length, tb)
    head_cfg, head = farm.farm_init(_stage_slice(irs, 0, tb, tb), block_size, tb)
    tail0_cfg, tail0 = farm.farm_init(_stage_slice(irs, tb, tb, tb), block_size, tb)
    tail_cfg = uniform.make_config(tb, n_t * tb)
    cfg = TwoStageConfig(head_block=block_size, tail_block=tb, head=head_cfg,
                         tail0=tail0_cfg, tail=tail_cfg)
    shape = (n_t, v, tb + 1)
    if tail_dtype == torch.bfloat16:
        table = torch.zeros(shape + (2,), dtype=torch.bfloat16, device=dev)
    else:
        table = torch.zeros(shape, dtype=torch.complex64, device=dev)
    _write_tail_table(cfg, table, irs, torch.arange(v, device=dev))
    tail = TailState(ring=torch.zeros_like(table), table=table,
                     overlap=torch.zeros((v, tb), device=dev),
                     pre=torch.zeros((v, tb + 1), dtype=torch.complex64, device=dev), q=0)
    n = head_cfg.seg_count
    state = Farm2State(
        head=head, tail0=tail0, tail=tail,
        hist=torch.zeros((v, n - 1, block_size + 1), dtype=torch.complex64, device=dev),
        tail_output=torch.zeros((v, tb), device=dev),
        tail_precalc=torch.zeros((v, tb), device=dev),
        suppress=torch.zeros(v, dtype=torch.bool),
    )
    return cfg, state


def _short_init(irs: torch.Tensor, block_size: int, max_response_length: int,
                tb: int) -> tuple[TwoStageConfig, TwoStageState]:
    """The short-IR farm: head and (where the IR exceeds one tail block)
    tail0 voice-stacked from their slices of ``irs``, an empty big tail, and
    the period buffers ``[V, tb]`` (the stages as
    :func:`..models.two_stage.init` splits them)."""
    v, dev = irs.shape[0], irs.device
    head_len = min(max_response_length, tb)
    head_cfg, head = farm.farm_init(_stage_slice(irs, 0, head_len, head_len), block_size,
                                    head_len)
    tail0_cfg = None
    if max_response_length > tb:
        t0_len = max_response_length - tb
        tail0_cfg, tail0 = farm.farm_init(_stage_slice(irs, tb, t0_len, t0_len), block_size,
                                          t0_len)
    else:
        _, tail0 = uniform.empty(block_size, dev)
    _, tail = uniform.empty(tb, dev)
    cfg = TwoStageConfig(head_block=block_size, tail_block=tb, head=head_cfg,
                         tail0=tail0_cfg, tail=None)
    state = TwoStageState(head=head, tail0=tail0, tail=tail,
                          **{k: torch.zeros((v, tb), device=dev)
                             for k in two_stage._BUFFERS},
                          tail_fill=0, precalc_pos=0)
    return cfg, state


def _small_stages(cfg: TwoStageConfig, state):
    """``(config, voice-stacked state, first IR sample)`` of the head and,
    where it exists, tail0."""
    yield cfg.head, state.head, 0
    if cfg.tail0 is not None:
        yield cfg.tail0, state.tail0, cfg.tail_block


_PENDING = ("tail_output0", "tail_precalc0", "tail_output", "tail_precalc")


def max_blocks_per_call(period: int, tail_segments: int) -> int:
    """The per-call ceiling in head blocks: ``min(N, 16)`` whole periods
    (the phased core's bound, ``fft_convolution_tpu/api_farm.py:163-171``)."""
    return min(tail_segments, cuda_farm_mac.MAX_BLOCKS) * period


def farm2_update(cfg: TwoStageConfig, state: Farm2State, new_irs) -> None:
    """Batched RT-safe IR swap for the whole farm, in place
    (``farm2_update``, ``fft_convolution_tpu/parallel/farm2.py:356``):
    every stage takes its slice of ``new_irs [V, L]`` zero-padded to full
    stage capacity, so every ring stays full and each history block keeps
    its true delay (outputs match per-voice engines updated with the
    response zero-padded to capacity, ``PARITY.md`` divergence 5).  Input
    history and phase are kept; pending tail outputs and ``hist`` are
    zeroed, and every voice's next call suppresses its first period's tail0
    contribution (the short-IR farm zeroes its four pending period buffers
    instead).  Call at a period boundary."""
    new_irs = torch.as_tensor(new_irs, dtype=torch.float32,
                              device=state.head.segments.device)
    for scfg, stage, lo in _small_stages(cfg, state):
        farm.farm_update(scfg, stage,
                         _stage_slice(new_irs, lo, scfg.ir_len,
                                      scfg.seg_count * scfg.block_size), scfg.ir_len)
    if cfg.tail is None:
        for k in _PENDING:
            getattr(state, k).zero_()
        return
    _write_tail_table(cfg, state.tail.table, new_irs,
                      torch.arange(new_irs.shape[0], device=new_irs.device))
    state.tail.overlap.zero_()
    state.tail.pre.zero_()
    for buf in (state.hist, state.tail_output, state.tail_precalc):
        buf.zero_()
    state.suppress.fill_(True)


def farm2_update_voices(cfg: TwoStageConfig, state: Farm2State, voice_idx,
                        new_irs) -> None:
    """:func:`farm2_update` for a subset of voices, in place
    (``farm2_update_voices``, ``fft_convolution_tpu/parallel/farm2.py:491``):
    only the touched voices' stage tables, tail table columns, pending rows
    and suppress flags are written; every ring and the phase are untouched,
    so the other voices continue bit-identically.  ``voice_idx``: ``[K]``
    distinct indices (the caller checks); ``new_irs``: ``[K, L]``."""
    dev = state.head.segments.device
    idx = torch.as_tensor(voice_idx, dtype=torch.long, device=dev).reshape(-1)
    new_irs = torch.as_tensor(new_irs, dtype=torch.float32, device=dev)
    for scfg, stage, lo in _small_stages(cfg, state):
        padded = _stage_slice(new_irs, lo, scfg.ir_len, scfg.seg_count * scfg.block_size)
        stage.segments_ir[idx] = farm.stage_spectra(scfg, padded)
        stage.overlap[idx] = 0.0
        stage.pre_multiplied[idx] = 0.0
    if cfg.tail is None:
        for k in _PENDING:
            getattr(state, k)[idx] = 0.0
        return
    _write_tail_table(cfg, state.tail.table, new_irs, idx)
    for buf in (state.tail.pre, state.tail.overlap, state.hist, state.tail_output,
                state.tail_precalc):
        buf[idx] = 0.0
    state.suppress[idx.cpu()] = True


def _tail_corr_phased_fused(cfg: uniform.UniformConfig, tail: TailState,
                            blocks_rows: torch.Tensor, step: Callable) -> torch.Tensor:
    """The big tail for ``blocks_rows [T, V, tb]`` (one tail block per
    period): forward rDFT, the phased step ``step`` (kernel B5 or its plain
    version), inverse rDFT and overlap-add — ``_tail_corr_phased_fused``
    (``fft_convolution_tpu/parallel/farm2.py:666``).  Returns ``[T, V, tb]``."""
    tb, n = cfg.block_size, cfg.seg_count
    t = blocks_rows.shape[0]
    if t > min(n, cuda_farm_mac.MAX_BLOCKS):
        raise ValueError(f"the phased core takes at most min(N={n}, "
                         f"{cuda_farm_mac.MAX_BLOCKS}) blocks per call, got {t}")
    specs = rdft_block(blocks_rows, cfg.fft_size).contiguous()  # [T, V, tb+1]
    del blocks_rows  # each transient goes as soon as it is dead: the farm's peak
    convs, tail.pre = step(tail.ring, tail.table, specs, tail.q)
    del specs
    outs = irdft_block(convs, cfg.fft_size)                # [T, V, 2tb]
    del convs
    y = outs[:, :, :tb] + torch.cat([tail.overlap[None], outs[:-1, :, tb:]])
    tail.overlap = outs[-1, :, tb:].contiguous()
    tail.q = (tail.q + t) % n
    return y


def farm2_head_khat(cfg: TwoStageConfig, state: Farm2State, t: int) -> torch.Tensor:
    """The combined head kernel's meta-spectra for ``t``-block calls
    (``farm2_head_khat``, ``fft_convolution_tpu/parallel/farm2.py:855``):
    input-independent between IR updates; valid for any call length with
    the same ``npo2(2n - 1 + t)``.  Only the plain head path
    (``heads_step_plain``) takes it; kernel B6 transforms the raw tables."""
    m = next_power_of_two(2 * cfg.head.seg_count - 1 + t)
    return causal_conv_khat(combined_head_kernel(state.head, state.tail0), m)


def farm2_head_khat_voices(cfg: TwoStageConfig, state: Farm2State, t: int,
                           voice_idx) -> torch.Tensor:
    """The ``[K]``-voice rows of :func:`farm2_head_khat`
    (``fft_convolution_tpu/parallel/farm2.py:872``)."""
    idx = torch.as_tensor(voice_idx, dtype=torch.long, device=state.hist.device)
    m = next_power_of_two(2 * cfg.head.seg_count - 1 + t)
    kern = torch.cat([state.head.segments_ir[idx], state.tail0.segments_ir[idx]], dim=1)
    return causal_conv_khat(kern, m)


def farm2_stream(cfg: TwoStageConfig, state: Farm2State | TwoStageState,
                 blocks: torch.Tensor, step: Callable = cuda_farm_mac.phased_step,
                 head_khat: dict | None = None,
                 heads: Callable = cuda_farm_heads.heads_step) -> torch.Tensor:
    """Stream ``blocks [T, V, B] -> [T, V, B]`` (``farm2_stream``,
    ``fft_convolution_tpu/parallel/farm2.py:1040``), ``T`` a multiple of
    the period; the state advances in place.  ``step`` is the big tail's
    phased step (:func:`..ops.cuda_farm_mac.phased_step`,
    ``phased_step_packed`` for bf16 storage, or ``phased_step_plain``);
    ``heads`` the head path (:func:`..ops.cuda_farm_heads.heads_step`,
    kernel B6, or ``heads_step_plain``, with :func:`farm2_head_khat` bound
    by ``functools.partial`` for the cached meta-spectra).  The big tail
    runs first, so the head path adds the delay line as it writes ``y``.
    ``head_khat``: the short-IR farm's
    :func:`..models.two_stage.small_stream_khats` of the voice-stacked state
    for this ``T``, which sends both small stages to the uniform conv core
    (their rings are full and clean: every update is at full capacity).
    The short-IR farm streams its small stages apart, as the JAX farm does
    with its own small-stream core
    (``fft_convolution_tpu/parallel/farm2.py:1075``), so the fused front
    end never runs here."""
    b, tb, p = cfg.head_block, cfg.tail_block, cfg.period
    t, v = blocks.shape[:2]
    q = t // p
    if q * p != t or q == 0:
        raise ValueError(f"T={t} must be a positive multiple of the period {p}")
    if cfg.tail is None:
        return two_stage.process_stream_aligned(cfg, state, blocks.transpose(0, 1), head_khat,
                                                fuse_small=False).transpose(0, 1).contiguous()
    if head_khat is not None:
        raise ValueError("head_khat is the short-IR farm's; bind farm2_head_khat into "
                         "heads=functools.partial(heads_step_plain, khat=...)")
    out_t = _tail_corr_phased_fused(
        cfg.tail, state.tail, blocks.reshape(q, p, v, b).transpose(1, 2).reshape(q, v, tb), step)
    # the two-period delay line: the pending precalc into period 0, the
    # pending output into period 1, this call's early big-tail outputs after
    y = heads(state.head, state.tail0, blocks, state.hist, state.suppress,
              delay=(state.tail_precalc, state.tail_output, out_t))
    state.tail_precalc = out_t[-2].clone() if q >= 2 else state.tail_output
    state.tail_output = out_t[-1].clone()
    state.suppress.fill_(False)
    return y


def voice_slab(state: Farm2State | TwoStageState, voices: range) -> Farm2State | TwoStageState:
    """A copy of ``voices`` of a farm2 state: the voice-stacked stages, the
    big tail's columns of ``voices`` and the voices' period buffers; the
    lockstep scalars as they are.  A short-IR farm's absent stages (not
    voice-stacked) are shared as they are."""
    sl = slice(voices.start, voices.stop)

    def cut(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t[(slice(None),) * dim + (sl,)].clone(memory_format=torch.contiguous_format)

    if isinstance(state, TwoStageState):
        def stage(st):  # stacked stages have a voice axis before [N, B+1]
            return farm.voice_slab(st, voices) if st.segments.ndim == 3 else st

        return dataclasses.replace(state, head=stage(state.head), tail0=stage(state.tail0),
                                   **{k: cut(getattr(state, k)) for k in two_stage._BUFFERS})
    t = state.tail
    return Farm2State(
        head=farm.voice_slab(state.head, voices), tail0=farm.voice_slab(state.tail0, voices),
        tail=TailState(ring=cut(t.ring, 1), table=cut(t.table, 1), overlap=cut(t.overlap),
                       pre=cut(t.pre), q=t.q),
        hist=cut(state.hist), tail_output=cut(state.tail_output),
        tail_precalc=cut(state.tail_precalc), suppress=cut(state.suppress))
