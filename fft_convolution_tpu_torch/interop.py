"""State carrier from the JAX package to this one.

Turns the JAX package's engine and kernel states — ``UniformState``,
``TwoStageState``, and the Pallas kernels' ``PallasFDLState`` /
``PallasFDLConsts`` and ``FusedHeadState`` / ``FusedHeadConsts`` — into this
package's states on a given device, so both packages can run on from the
same mid-stream state.  Fields are read through ``numpy.asarray``, so any
object with those attribute names works; JAX itself is not imported.
Spectra move from the packed halfcomplex layout ``[..., 2, B]`` (Nyquist
in ``im[0]``) to ``complex64 [..., B + 1]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.two_stage import TwoStageState
from .models.uniform import UniformState
from .ops.cuda_engine import FDLConsts, FDLState
from .ops.cuda_two_stage import FusedConsts, FusedState
from .ops.fft import packed_to_complex, twiddles


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _spectra(packed, device) -> torch.Tensor:
    return packed_to_complex(_f32(packed, device))


def _planes(re, im, device) -> torch.Tensor:
    """Separate ``[N, B]`` re/im kernel planes -> ``complex64 [N, B + 1]``."""
    return _spectra(np.stack([np.asarray(re), np.asarray(im)], axis=-2), device)


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
