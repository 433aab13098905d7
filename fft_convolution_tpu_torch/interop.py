"""State carrier from the JAX package to this one.

Turns the JAX package's engine and kernel states — ``UniformState``,
``TwoStageState``, the big tail's CHRONO history pair (both ways),
``CrossfaderState``, and the Pallas kernels'
``PallasFDLState`` / ``PallasFDLConsts`` (and their packed forms),
``FusedHeadState`` / ``FusedHeadConsts``, ``XfadeState`` / ``XfadeConsts``,
``StreamState`` / ``StreamConsts`` / ``StreamConstsPacked``, the reverb
farm's ``parallel.farm2`` state and the
segment-sharded ``ShardedFDLState`` (one rank's part) — into this
package's states on a given device, so both packages can run on from the
same mid-stream state.  Fields are read through ``numpy.asarray``, so any
object with those attribute names works; JAX itself is not imported.
Spectra move from the packed halfcomplex layout ``[..., 2, B]`` (Nyquist
in ``im[0]``) to ``complex64 [..., B + 1]``; the TPU's bf16 words
(``uint32``, ``re`` in the high half) become bf16 pairs ``[..., B + 1, 2]``
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.crossfade import CrossfaderState
from .models.two_stage import TwoStageState
from .models.uniform import UniformState
from .ops.cuda_crossfade import XfadeConsts, XfadeState
from .ops.cuda_engine import FDLConsts, FDLState, to_bf16
from .ops.cuda_stream import StreamConsts, StreamState
from .ops.cuda_two_stage import FusedConsts, FusedState
from .ops.fft import complex_to_packed, packed_to_complex, twiddles
from .parallel.farm2 import Farm2State, TailState
from .parallel.partition import ShardedFDLState


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _spectra(packed, device) -> torch.Tensor:
    return packed_to_complex(_f32(packed, device))


def _planes(re, im, device) -> torch.Tensor:
    """Separate ``[N, B]`` re/im kernel planes -> ``complex64 [N, B + 1]``."""
    return _spectra(np.stack([np.asarray(re), np.asarray(im)], axis=-2), device)


def _words(w, device) -> torch.Tensor:
    """Packed bf16 words ``uint32 [N, B]`` -> bf16 pairs ``[N, B + 1, 2]``:
    ``re = w & 0xFFFF0000`` and ``im = w << 16``, each read as float32, are
    the exact widened bf16 values, so the narrowing back is exact."""
    w = np.asarray(w, dtype=np.uint32)
    re = (w & np.uint32(0xFFFF0000)).view(np.float32)
    im = (w << np.uint32(16)).view(np.float32)
    return to_bf16(_planes(re, im, device))


def _int(a) -> int:
    return int(np.asarray(a).reshape(-1)[0])


def uniform_state(js, device="cpu") -> UniformState:
    """A JAX ``models.uniform.UniformState`` as this package's state."""
    return UniformState(
        segments=_spectra(js.segments, device),
        segments_ir=_spectra(js.segments_ir, device),
        overlap=_f32(js.overlap, device),
        input_buffer=_f32(js.input_buffer, device),
        pre_multiplied=_spectra(js.pre_multiplied, device),
        current=_int(js.current), input_fill=_int(js.input_fill),
        active_segs=_int(js.active_segs),
    )


def two_stage_state(js, device="cpu") -> TwoStageState:
    """A JAX ``models.two_stage.TwoStageState`` as this package's state."""
    return TwoStageState(
        head=uniform_state(js.head, device), tail0=uniform_state(js.tail0, device),
        tail=uniform_state(js.tail, device),
        tail_output0=_f32(js.tail_output0, device),
        tail_precalc0=_f32(js.tail_precalc0, device),
        tail_output=_f32(js.tail_output, device),
        tail_precalc=_f32(js.tail_precalc, device),
        tail_input=_f32(js.tail_input, device),
        tail_fill=_int(js.tail_fill), precalc_pos=_int(js.precalc_pos),
    )


def chrono(jchrono, device="cpu") -> tuple[torch.Tensor, int]:
    """A JAX CHRONO pair ``((hist_re, hist_im), pos)`` (planes ``[h_cap,
    B]``, Nyquist in ``im[0]``) as this package's ``(hist, pos)``:
    ``complex64 [h_cap, B + 1]`` and a host int."""
    (re, im), pos = jchrono
    return _planes(re, im, device), _int(pos)


def chrono_to_jax(hist: torch.Tensor, pos: int) -> tuple[tuple[np.ndarray, np.ndarray], int]:
    """This package's ``(hist, pos)`` as the JAX pair's numpy planes (the
    inverse of :func:`chrono`; the DC and Nyquist bins' imaginary parts,
    zero for real blocks, are dropped)."""
    packed = complex_to_packed(hist.detach().cpu()).numpy()
    return (np.ascontiguousarray(packed[:, 0]), np.ascontiguousarray(packed[:, 1])), pos


def fdl(jconsts, jstate, device="cpu") -> tuple[FDLConsts, FDLState]:
    """Kernel B1 operands from ``pallas_engine.PallasFDLConsts`` and
    ``PallasFDLState``.  The doubled TPU table ``ir2`` keeps one copy."""
    n = np.asarray(jstate.seg_re).shape[0]
    ir = _planes(np.asarray(jconsts.ir2_re)[:n], np.asarray(jconsts.ir2_im)[:n], device)
    b = ir.shape[1] - 1
    return (FDLConsts(ir=ir, tw=twiddles(2 * b, device)),
            FDLState(segments=_planes(jstate.seg_re, jstate.seg_im, device),
                     overlap=_f32(jstate.overlap, device).reshape(-1),
                     current=_int(jstate.current)))


def fused_head(jconsts, jstate, device="cpu") -> tuple[FusedConsts, FusedState]:
    """Kernel B2 operands from ``pallas_two_stage.FusedHeadConsts`` and
    ``FusedHeadState``."""
    n = np.asarray(jstate.seg_re).shape[0]
    h_ir = _planes(np.asarray(jconsts.h_ir2_re)[:n], np.asarray(jconsts.h_ir2_im)[:n],
                   device)
    t_ir = _planes(np.asarray(jconsts.t_ir2_re)[:n], np.asarray(jconsts.t_ir2_im)[:n],
                   device)
    b = h_ir.shape[1] - 1
    return (FusedConsts(h_ir=h_ir, t_ir=t_ir, tw=twiddles(2 * b, device)),
            FusedState(segments=_planes(jstate.seg_re, jstate.seg_im, device),
                       head_overlap=_f32(jstate.head_overlap, device).reshape(-1),
                       t0_overlap=_f32(jstate.t0_overlap, device).reshape(-1),
                       current=_int(jstate.current)))


def fdl_packed(jconsts, jstate, device="cpu") -> tuple[FDLConsts, FDLState]:
    """Kernel B1p operands from ``pallas_engine.PallasFDLConstsPacked`` and
    ``PallasFDLStatePacked`` (one copy of the doubled table)."""
    n = np.asarray(jstate.seg_w).shape[0]
    ir = _words(np.asarray(jconsts.ir2_w)[:n], device)
    b = ir.shape[1] - 1
    return (FDLConsts(ir=ir, tw=twiddles(2 * b, device)),
            FDLState(segments=_words(jstate.seg_w, device),
                     overlap=_f32(jstate.overlap, device).reshape(-1),
                     current=_int(jstate.current)))


def xfade(jconsts, jstate, device="cpu") -> tuple[XfadeConsts, XfadeState]:
    """Kernel B3 operands from ``pallas_crossfade.XfadeConsts`` and
    ``XfadeState`` (one copy of each doubled table)."""
    n = np.asarray(jstate.seg_re).shape[0]
    ir_a = _planes(np.asarray(jconsts.a2_re)[:n], np.asarray(jconsts.a2_im)[:n], device)
    ir_b = _planes(np.asarray(jconsts.b2_re)[:n], np.asarray(jconsts.b2_im)[:n], device)
    b = ir_a.shape[1] - 1
    return (XfadeConsts(ir_a=ir_a, ir_b=ir_b, tw=twiddles(2 * b, device)),
            XfadeState(segments=_planes(jstate.seg_re, jstate.seg_im, device),
                       overlap_a=_f32(jstate.overlap_a, device).reshape(-1),
                       overlap_b=_f32(jstate.overlap_b, device).reshape(-1),
                       current=_int(jstate.current)))


def crossfader_state(js) -> CrossfaderState:
    """A JAX ``models.crossfade.CrossfaderState`` as host scalars."""
    return CrossfaderState(target=_int(js.target), approaching=bool(_int(js.approaching)),
                           counter=_int(js.counter),
                           mix_value=np.float32(np.asarray(js.mix_value)),
                           step=np.float32(np.asarray(js.step)))


def _fused_spectra(a, n_rows: int, v: int, device) -> torch.Tensor:
    """A planes-outer fused tail leaf ``[2, R, V*B]`` (f32) or ``[R, V*B]``
    (packed bf16 words) -> its first ``n_rows`` rows as ``complex64
    [n_rows, V, B+1]`` or bf16 pairs ``[n_rows, V, B+1, 2]``."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return _words(a[:n_rows].reshape(n_rows, v, -1), device)
    planes = a[:, :n_rows].reshape(2, n_rows, v, -1)
    return _spectra(np.moveaxis(planes, 0, 2), device)


def farm_state(jcfg, jstate, device="cpu") -> Farm2State:
    """A JAX ``parallel.farm2`` state (with its ``TwoStageConfig``) as this
    package's :class:`~.parallel.farm2.Farm2State`: the voice-stacked head
    and tail0 stages as they are; the planes-outer fused tail ring and the
    first ``N`` rows of the doubled table as ``[N, V, B+1]`` bins (packed
    words as exact bf16 pairs); the head history from the two period-buffer
    planes it is kept in there; ``precalc_pos == 1`` as the suppress flags.
    A rank's slab of it is :func:`~.parallel.farm2.voice_slab`."""
    tail = jstate.tail
    v, b, p = np.asarray(jstate.tail_output).shape[0], jcfg.head_block, jcfg.period
    n, n_t = jcfg.head.seg_count, jcfg.tail.seg_count
    hist = np.stack([np.asarray(jstate.tail_precalc0).reshape(v, p, b)[:, :n - 1],
                     np.asarray(jstate.tail_output0).reshape(v, p, b)[:, :n - 1]], axis=2)
    pre = np.asarray(tail.pre_multiplied).reshape(2, v, -1).transpose(1, 0, 2)
    return Farm2State(
        head=uniform_state(jstate.head, device), tail0=uniform_state(jstate.tail0, device),
        tail=TailState(ring=_fused_spectra(tail.segments, n_t, v, device),
                       table=_fused_spectra(tail.segments_ir, n_t, v, device),
                       overlap=_f32(tail.overlap, device),
                       pre=_spectra(pre, device), q=_int(tail.current)),
        hist=_spectra(hist, device),
        tail_output=_f32(jstate.tail_output, device),
        tail_precalc=_f32(jstate.tail_precalc, device),
        suppress=torch.from_numpy(np.asarray(jstate.precalc_pos) == 1),
    )


def sharded_fdl(jcfg, jstate, rank: int, sp: int, device="cpu") -> ShardedFDLState:
    """Rank ``rank``'s part, of ``sp`` along ``"sp"``, of a JAX
    ``parallel.partition.ShardedFDLState`` (global arrays): its rows of the
    ring, one copy of the doubled IR table, the replicated overlap and
    scalars."""
    rows = jcfg.seg_count // sp
    seg = np.asarray(jstate.segments)[rank * rows:(rank + 1) * rows]
    return ShardedFDLState(
        segments=_spectra(seg, device),
        segments_ir=_spectra(np.asarray(jstate.segments_ir)[:jcfg.seg_count], device),
        overlap=_f32(jstate.overlap, device),
        current=_int(jstate.current), active_segs=_int(jstate.active_segs),
    )


def stream(jconsts, jstate, device="cpu") -> tuple[StreamConsts, StreamState]:
    """Kernel B4 operands from ``pallas_stream.StreamConsts`` (f32 table) or
    ``StreamConstsPacked`` (bf16 words) and ``StreamState``: the reversed
    table and the chronological ring map row for row."""
    if hasattr(jconsts, "irrev_w"):
        irrev = _words(jconsts.irrev_w, device)
    else:
        irrev = _planes(jconsts.irrev_re, jconsts.irrev_im, device)
    b = irrev.shape[1] - 1
    return (StreamConsts(irrev=irrev, tw=twiddles(2 * b, device)),
            StreamState(ring=_planes(jstate.ring_re, jstate.ring_im, device),
                        overlap=_f32(jstate.overlap, device).reshape(-1),
                        w=_int(jstate.w)))
