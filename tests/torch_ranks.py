"""Rank bodies of the port's multi-device tests (``test_torch_parallel.py``,
``test_torch_farm.py``), run by ``parallel.mesh.run_ranks`` on the CPU.

A spawned rank imports the module that holds its function, so this module
imports ``torch`` and the port and never JAX.  :func:`run_jobs` runs a dict
of jobs on every rank in the same order (each builds its own mesh, which is
a collective call) and returns each job's outputs and exit state as numpy
arrays and plain values.
"""

from __future__ import annotations

import numpy as np
import torch

from fft_convolution_tpu_torch import CrossfadeConvolver, ReverbFarm
from fft_convolution_tpu_torch.ops import cuda_farm_mac
from fft_convolution_tpu_torch.parallel import farm, farm2
from fft_convolution_tpu_torch.parallel.mesh import make_mesh, voice_range
from fft_convolution_tpu_torch.parallel.partition import ShardedFDLState, ShardedFFTConvolver
from fft_convolution_tpu_torch.parallel.two_stage_sp import ShardedTwoStageConvolver


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _mesh(world: int, shape=None, names=("sp",)):
    return make_mesh(shape or (world,), names, "cpu")


def run_jobs(rank: int, world: int, jobs: dict) -> dict:
    """``{name: (function name, keyword arguments)}`` -> ``{name: result}``."""
    return {name: globals()[fn](rank, world, **kw) for name, (fn, kw) in jobs.items()}


# ---- the segment-sharded engines -------------------------------------------------

def _engine(kind: str, mesh, args):
    if kind == "sp":
        return ShardedFFTConvolver(*args, mesh=mesh)
    if kind == "ts":
        return ShardedTwoStageConvolver(*args, mesh=mesh)
    if kind == "xf_sp":  # CrossfadeConvolver(ShardedFFTConvolver(ir, b, cap), cap, b, fade)
        ir, b, cap, fade = args
        return CrossfadeConvolver(ShardedFFTConvolver(ir, b, cap, mesh=mesh), cap, b, fade)
    raise ValueError(kind)


def _sp_state(st: ShardedFDLState) -> dict:
    return {"segments": _np(st.segments), "segments_ir": _np(st.segments_ir),
            "overlap": _np(st.overlap), "current": st.current, "active": st.active_segs}


def _state(e) -> dict:
    if isinstance(e, ShardedFFTConvolver):
        return _sp_state(e.state)
    if isinstance(e, ShardedTwoStageConvolver):
        st = e.state
        return {"tail": _sp_state(st.tail), "head_current": st.head.current,
                "head_segments": _np(st.head.segments),
                **{k: _np(getattr(st, k)) for k in ("tail_output", "tail_precalc",
                                                     "tail_output0", "tail_precalc0")}}
    return {}


def script(rank: int, world: int, engines: list, ops: list, shape=None, names=("sp",),
           start: list | None = None) -> dict:
    """Build ``engines`` (``(name, kind, args)``) on one mesh and run
    ``ops``: ``(engine, method, *args)``.  ``process`` records its output;
    ``clone`` makes the engine named by its argument; ``snapshot`` and
    ``restore`` use one slot; ``raises`` calls the method named by its
    first argument and records the exception's type name (None if none);
    ``raises_new`` does that for a constructor.  ``start``: per-rank states
    the engine ``a`` is restored to before the ops."""
    mesh = _mesh(world, shape, names)
    eng = {name: _engine(kind, mesh, args) for name, kind, args in engines}
    if start is not None:
        eng["a"].restore(start[rank])
    ys, raised, saved = [], [], None
    for name, op, *args in ops:
        if op == "raises_new":
            try:
                _engine(args[0], mesh, args[1])
                raised.append(None)
            except (ValueError, NotImplementedError) as exc:
                raised.append(type(exc).__name__)
            continue
        e = eng[name]
        if op == "process":
            ys.append(_np(e.process(*args)))
        elif op == "clone":
            eng[args[0]] = e.clone()
        elif op == "snapshot":
            saved = e.snapshot()
        elif op == "restore":
            e.restore(saved)
        elif op == "raises":
            try:
                getattr(e, args[0])(*args[1:])
                raised.append(None)
            except (ValueError, NotImplementedError) as exc:
                raised.append(type(exc).__name__)
        else:
            getattr(e, op)(*args)
    cfg = getattr(eng["a"], "cfg", None)
    return {"y": ys, "raised": raised, "state": _state(eng["a"]),
            "tail_block": getattr(cfg, "tail_block", None),
            "seg_count": getattr(getattr(cfg, "tail", cfg), "seg_count", None)}


# ---- the voice-sharded farms ---------------------------------------------------------

def farm_uniform(rank: int, world: int, irs, x, b: int, cap: int) -> dict:
    """``farm_init`` of every voice, the rank's ``voice_slab``, then
    ``farm_stream`` of the slab on the rank's voices."""
    mesh = _mesh(world, names=("dp",))
    cfg, state = farm.farm_init(torch.from_numpy(irs), b, cap)
    lv = voice_range(mesh, irs.shape[0])
    slab = farm.voice_slab(state, lv)
    y = farm.farm_stream(cfg, slab, torch.from_numpy(x[:, lv.start:lv.stop]))
    return {"voices": (lv.start, lv.stop), "y": _np(y), "segments": _np(slab.segments),
            "current": slab.current}


def _farm2_state(st) -> dict:
    t = st.tail
    return {"q": t.q, "head_current": st.head.current, "ring": _np(cuda_farm_mac.as_c64(t.ring)),
            "hist": _np(st.hist), "tail_output": _np(st.tail_output),
            "tail_precalc": _np(st.tail_precalc), "overlap": _np(t.overlap)}


def farm2_calls(rank: int, world: int, irs, b: int, cap: int, xs: list, bf16: bool = False,
                starts: list | None = None) -> dict:
    """``farm2_init`` of every voice, the rank's ``voice_slab``, then
    ``farm2_stream`` of the slab over each call of ``xs`` (the rank's
    voices), through the plain B5 step.  ``starts[call]``: per-rank slabs
    carried over from the JAX package (``interop.farm_state`` cut by
    ``farm2.voice_slab``) that the call starts from."""
    mesh = _mesh(world, names=("dp",))
    dtype = torch.bfloat16 if bf16 else torch.float32
    cfg, state = farm2.farm2_init(irs, b, cap, tail_dtype=dtype)
    lv = voice_range(mesh, irs.shape[0])
    slab = farm2.voice_slab(state, lv)
    ys = []
    for call, x in enumerate(xs):
        if starts is not None:
            slab = starts[call][rank]
        ys.append(_np(farm2.farm2_stream(cfg, slab, torch.from_numpy(x[:, lv.start:lv.stop]))))
    return {"voices": (lv.start, lv.stop), "y": ys, "state": _farm2_state(slab)}


def reverb_farm(rank: int, world: int, irs, b: int, cap: int, ops: list) -> dict:
    """``ReverbFarm(mesh=...)`` over ``ops``: ``("process", x)`` with the
    full ``[T, V, B]`` input (the rank passes its own voices),
    ``("update_voice", voice, ir)``, ``("update", irs)``, and
    ``("raises_new", irs)`` (a construction that must raise; records the
    exception's type name and message)."""
    mesh = _mesh(world, names=("dp",))
    f = ReverbFarm(irs, b, cap, mesh=mesh, device="cpu")
    lv = f.local_voices
    ys, raised = [], []
    for op, *args in ops:
        if op == "process":
            ys.append(_np(f.process(args[0][:, lv.start:lv.stop])))
        elif op == "raises_new":
            try:
                ReverbFarm(args[0], b, cap, mesh=mesh, device="cpu")
                raised.append(None)
            except ValueError as exc:
                raised.append(str(exc))
        else:
            getattr(f, op)(*args)
    return {"voices": (lv.start, lv.stop), "y": ys, "raised": raised,
            "state": _farm2_state(f.state)}
