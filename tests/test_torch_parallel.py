"""The port's multi-device forms on the CPU: spawned gloo ranks (2 and 4,
and one 2-D ``(dp, sp)`` mesh of 4) run the port with the plain kernels
(``tests/torch_ranks.py``, which imports no JAX); the pytest process holds
their outputs and exit states against the JAX package's sharded engines on
a mesh of the first ``w`` of the conftest's 8 CPU devices and against its
single-device engines, at the JAX tests' tolerances.

Ports the sharded-form tests of ``tests/test_parallel.py`` (:36, :55, :74,
:92, :181, :415, :439, :461, :485, :499, :521, :575, :607, :733) and
``tests/test_graft_entry.py:16`` (the dry run, as the port's example at 4
ranks).  Every job of one world size runs in one spawn (the ``ranks``
fixture), so the file spawns a few times, not once a test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from fft_convolution_tpu import CrossfadeConvolver as JCrossfade
from fft_convolution_tpu import FFTConvolver as JFFTConvolver
from fft_convolution_tpu import TwoStageFFTConvolver as JTwoStage
from fft_convolution_tpu.parallel import farm as jfarm
from fft_convolution_tpu.parallel import farm2 as jfarm2
from fft_convolution_tpu.parallel import partition as jpartition
from fft_convolution_tpu.parallel import two_stage_sp as jtwo_stage_sp
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.examples import dryrun_multichip, giant_ir_multichip
from fft_convolution_tpu_torch.ops.fft import packed_to_complex
from fft_convolution_tpu_torch.parallel import farm2 as tfarm2
from fft_convolution_tpu_torch.parallel.mesh import run_ranks

B = 64
ATOL = 1e-5      # the JAX tests' sharded-vs-single tolerance
REPEAT = 1e-6    # their tolerance for a repeat of the same engine (reset, clone)
# exit-state spectra: float32 rounding of two DFTs (cuFFT-style FFT against
# the JAX package's matmul DFT) at the spectra's own scale
SPEC_REL = 1e-5


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, err_msg=msg)


def _close_scaled(got, want, rel, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale, msg


def _jmesh(w):
    return jpartition.make_mesh(jax.devices()[:w])


def _jspectra(a) -> np.ndarray:
    return packed_to_complex(torch.from_numpy(np.array(a, np.float32))).numpy()


# ---- inputs, the JAX tests' seeds and shapes ------------------------------------

def _fdl():            # :55, 16 segments, > 2 ring periods
    rng = np.random.default_rng(12)
    return _f32(rng, B * 16, scale=0.1), _f32(rng, 40, B)


def _padding():        # :74, 6 segments
    rng = np.random.default_rng(13)
    return _f32(rng, B * 5 + 17, scale=0.1), _f32(rng, 16, B)


def _two_d():          # :92
    rng = np.random.default_rng(21)
    ir, x = _f32(rng, B * 8, scale=0.1), _f32(rng, 24, B)
    return ir, x, _f32(rng, B * 3, scale=0.1)


def _update():         # :415, 16 -> 5 segments with current = 3
    rng = np.random.default_rng(16)
    return _f32(rng, B * 16, scale=0.1), _f32(rng, B * 5, scale=0.1), _f32(rng, 48, B)


def _transient():      # :439, 16 -> 2 segments with current = 14
    rng = np.random.default_rng(17)
    return _f32(rng, B * 16, scale=0.1), _f32(rng, B * 2, scale=0.1), _f32(rng, 40, B)


def _padded_update():  # :461, 6 segments (8 on 4 ranks)
    rng = np.random.default_rng(18)
    return _f32(rng, B * 5 + 17, scale=0.1), _f32(rng, B * 3, scale=0.1), _f32(rng, 32, B)


def _reset():          # :485
    rng = np.random.default_rng(19)
    return _f32(rng, B * 16, scale=0.1), _f32(rng, 16, B)


def _two_stage():      # :499, tail block 512, period 8
    rng = np.random.default_rng(22)
    ir = _f32(rng, 4096, scale=0.05)
    return ir, _f32(rng, 4 * 512)


def _two_stage_ops():  # :521
    rng = np.random.default_rng(23)
    return _f32(rng, 4096, scale=0.05), _f32(rng, 2000, scale=0.05), _f32(rng, 4 * 512)


def _crossfade():      # :575
    rng = np.random.default_rng(24)
    return _f32(rng, B * 8, scale=0.1), _f32(rng, B * 8, scale=0.1), _f32(rng, 24, B)


def _clone():          # :607
    rng = np.random.default_rng(20)
    ir, x = _f32(rng, B * 8, scale=0.1), _f32(rng, 8, B)
    return ir, x, _f32(rng, B, scale=0.1)


def _farm():           # :36, uniform farm of 8 voices
    rng = np.random.default_rng(11)
    return _f32(rng, 8, 256, scale=0.1), _f32(rng, 12, 8, B)


FARM2_LEN = 9000       # tail block 1024, period 16, 8 tail segments


def _farm2():          # :181, 8 voices, two calls of two periods
    rng = np.random.default_rng(26)
    return _f32(rng, 8, FARM2_LEN, scale=0.05), _f32(rng, 32, 8, B)


def _farm2_packed():   # :733, bf16 tail storage
    rng = np.random.default_rng(44)
    irs = _f32(rng, 8, FARM2_LEN, scale=0.05)
    return irs, _f32(rng, 64, 8, B)


# ---- the JAX references that the ranks' starting states come from ----------------

def _j_fdl_prefix(w):
    """The JAX sharded FDL of :func:`_fdl` after its first 20 blocks."""
    ir, x = _fdl()
    jsh = jpartition.ShardedFFTConvolver(ir, B, len(ir), mesh=_jmesh(w))
    jsh.process(x[:20].reshape(-1))
    return jsh


@functools.lru_cache(maxsize=None)
def _j_farm2_packed_states():
    """The JAX bf16 farm's state before each call of :func:`_farm2_packed`
    (jnp core) and its outputs."""
    irs, x = _farm2_packed()
    jcfg, jst = jfarm2.farm2_init(irs, B, FARM2_LEN, tail_dtype=jnp.bfloat16)
    run = jax.jit(functools.partial(jfarm2.farm2_stream, jcfg, tail_mac="jnp"))
    states, ys = [], []
    for xc in (x[:32], x[32:]):
        states.append(jst)
        jst, y = run(jst, jnp.asarray(xc))
        ys.append(np.asarray(y))
    return jcfg, states, ys


def _jobs(w: int) -> dict:
    """Every job a ``w``-rank spawn runs (``torch_ranks.run_jobs``)."""
    sp = ("a", "sp")
    ir, x = _fdl()
    jsh = _j_fdl_prefix(w)
    jobs = {
        "fdl": ("script", dict(engines=[(*sp, (ir, B, len(ir)))],
                               ops=[("a", "process", x.reshape(-1))])),
        "fdl_carried": ("script", dict(
            engines=[(*sp, (ir, B, len(ir)))], ops=[("a", "process", x[20:].reshape(-1))],
            start=[interop.sharded_fdl(jsh.cfg, jsh.state, r, w) for r in range(w)])),
    }
    irs, x = _farm()
    jobs["farm"] = ("farm_uniform", dict(irs=irs, x=x, b=B, cap=256))
    irs, x = _farm2()
    jobs["farm2"] = ("farm2_calls", dict(irs=irs, b=B, cap=FARM2_LEN, xs=[x, x]))
    if w == 4:  # 6 segments pad to 8
        ir, x = _padding()
        jobs["padding"] = ("script", dict(engines=[(*sp, (ir, B, len(ir)))],
                                          ops=[("a", "process", x.reshape(-1))]))
        ir_a, ir_b, x = _padded_update()
        jobs["padded_update"] = ("script", dict(engines=[(*sp, (ir_a, B, len(ir_a)))], ops=[
            ("a", "process", x[:11].reshape(-1)), ("a", "update", ir_b),
            ("a", "process", x[11:].reshape(-1)),
            ("a", "raises", "update", np.zeros(len(ir_a) + 1, np.float32))]))
        ir, x, ir_b = _two_d()
        jobs["two_d"] = ("script", dict(
            engines=[(*sp, (ir, B, len(ir)))], shape=(2, 2), names=("dp", "sp"),
            ops=[("a", "process", x.reshape(-1)), ("a", "update", ir_b),
                 ("a", "process", x.reshape(-1))]))
        return jobs
    for name, (ir_a, ir_b, x), cut in (("update", _update(), 13),
                                       ("transient", _transient(), 2)):
        jobs[name] = ("script", dict(engines=[(*sp, (ir_a, B, len(ir_a)))], ops=[
            ("a", "process", x[:cut].reshape(-1)), ("a", "update", ir_b),
            ("a", "process", x[cut:].reshape(-1))]))
    ir, x = _reset()
    jobs["reset"] = ("script", dict(engines=[(*sp, (ir, B, len(ir)))], ops=[
        ("a", "process", x.reshape(-1)), ("a", "reset"), ("a", "process", x.reshape(-1))]))
    ir, x = _two_stage()
    jobs["two_stage"] = ("script", dict(engines=[("a", "ts", (ir, B, len(ir)))], ops=[
        ("a", "process", x[:1024]), ("a", "process", x[1024:])]))
    ir_a, ir_b, x = _two_stage_ops()
    tb = 512
    jobs["two_stage_ops"] = ("script", dict(
        engines=[("a", "ts", (ir_a, B, len(ir_a))), ("b", "ts", (ir_a, B, len(ir_a)))],
        ops=[("a", "raises", "update", ir_b),
             ("a", "process", x[:2 * tb]), ("a", "snapshot"),
             ("a", "update_extension", ir_b), ("a", "process", x[2 * tb:]),
             ("a", "restore"), ("a", "clone", "twin"),
             ("twin", "update_extension", ir_b), ("twin", "process", x[2 * tb:]),
             ("a", "process", x[2 * tb:]),
             ("b", "process", x), ("b", "reset"), ("b", "process", x),
             (None, "raises_new", "ts", (ir_b, B, 600)),
             ("a", "raises", "process", np.zeros(tb + B, np.float32))]))
    ir_a, ir_b, x = _crossfade()
    xf = ("xf_sp", (ir_a, B, len(ir_a), 128))
    jobs["crossfade"] = ("script", dict(
        engines=[("a", *xf), ("none", *xf)],
        ops=[("a", "process", x[:8].reshape(-1)), ("a", "update", ir_b),
             ("a", "process", x[8:].reshape(-1)),
             ("none", "process", x[:8].reshape(-1)), ("none", "process", x[8:].reshape(-1))]))
    ir, x, new = _clone()
    jobs["clone"] = ("script", dict(
        engines=[(*sp, (ir, B, len(ir))), ("ref", "sp", (ir, B, len(ir)))],
        ops=[("a", "process", x[:4].reshape(-1)), ("a", "clone", "twin"),
             ("twin", "update", new), ("twin", "process", x[4:].reshape(-1)),
             ("ref", "process", x[:4].reshape(-1)),
             ("a", "process", x[4:].reshape(-1)), ("ref", "process", x[4:].reshape(-1))]))
    irs, x = _farm2_packed()
    jcfg, jstates, _ = _j_farm2_packed_states()
    starts = [[tfarm2.voice_slab(interop.farm_state(jcfg, js),
                                 range(r * 8 // w, (r + 1) * 8 // w))
               for r in range(w)] for js in jstates]
    jobs["farm2_packed"] = ("farm2_calls", dict(irs=irs, b=B, cap=FARM2_LEN,
                                                xs=[x[:32], x[32:]], bf16=True, starts=starts))
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """``ranks(w)``: every rank's results of the ``w``-rank spawn, run once."""
    runs = {}

    def get(w):
        if w not in runs:
            runs[w] = run_ranks(torch_ranks.run_jobs, w, _jobs(w), device="cpu", timeout=300)
        return runs[w]

    return get


def _sp_states_close(results, name, jcfg, jstate, sp, msg=""):
    """Each rank's exit state against its part of the JAX sharded state
    (``interop.sharded_fdl``); rank r holds rows of "sp" index r % sp."""
    for rank, res in enumerate(results):
        got = res[name]["state"]
        got = got.get("tail", got)
        want = interop.sharded_fdl(jcfg, jstate, rank % sp, sp)
        assert (got["current"], got["active"]) == (want.current, want.active_segs), msg
        _close_scaled(got["segments"], want.segments.numpy(), SPEC_REL, f"{msg} ring, rank {rank}")
        _close_scaled(got["segments_ir"], want.segments_ir.numpy(), SPEC_REL, f"{msg} IR table")
        _close(got["overlap"], want.overlap.numpy(), ATOL, f"{msg} overlap, rank {rank}")


def _outputs(results, name):
    return [np.concatenate(r[name]["y"]) for r in results]


# ---- the segment-sharded FDL --------------------------------------------------------

@pytest.mark.parametrize("w", [2, 4])
def test_segment_sharded_fdl_matches_uniform(ranks, w):
    """:55 — the sharded FDL (local MAC + one all-reduce a block) against the
    JAX sharded engine on w devices and the single-device engine, through
    full ring wraps; exit states row for row; and from the JAX sharded
    state carried over mid-stream (``interop.sharded_fdl``)."""
    results = ranks(w)
    ir, x = _fdl()
    jsh = jpartition.ShardedFFTConvolver(ir, B, len(ir), mesh=_jmesh(w))
    want = np.asarray(jsh.process(x.reshape(-1)))
    ref = np.asarray(JFFTConvolver(ir, B, len(ir)).process(x.reshape(-1)))
    for y in _outputs(results, "fdl"):
        _close(y, want, ATOL, "vs the JAX sharded engine")
        _close(y, ref, ATOL, "vs the JAX single-device engine")
    _sp_states_close(results, "fdl", jsh.cfg, jsh.state, w, "exit")
    jpre = _j_fdl_prefix(w)
    want2 = np.asarray(jpre.process(x[20:].reshape(-1)))
    for y in _outputs(results, "fdl_carried"):
        _close(y, want2, ATOL, "from the carried JAX state")
    _sp_states_close(results, "fdl_carried", jpre.cfg, jpre.state, w, "carried exit")


def test_segment_sharded_padding(ranks):
    """:74 — a segment count that does not divide by the mesh (6 on 4
    ranks) pads; the output is unchanged."""
    w = 4
    results = ranks(w)
    ir, x = _padding()
    jsh = jpartition.ShardedFFTConvolver(ir, B, len(ir), mesh=_jmesh(w))
    assert jsh.cfg.seg_count % w == 0
    want = np.asarray(jsh.process(x.reshape(-1)))
    ref = np.asarray(JFFTConvolver(ir, B, len(ir)).process(x.reshape(-1)))
    for y in _outputs(results, "padding"):
        _close(y, want, ATOL)
        _close(y, ref, ATOL)
    _sp_states_close(results, "padding", jsh.cfg, jsh.state, w)


def test_segment_sharded_fdl_on_2d_mesh(ranks):
    """:92 — on a 2-D (dp, sp) mesh of 4 ranks the line is sharded over "sp"
    (2) and replicated over "dp": the slab is sized by "sp", not the world;
    then the update path under the same mesh."""
    results = ranks(4)
    ir, x, ir_b = _two_d()
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    jsh = jpartition.ShardedFFTConvolver(ir, B, len(ir), mesh=jmesh)
    assert jsh.cfg.seg_count % 2 == 0
    y1 = np.asarray(jsh.process(x.reshape(-1)))
    jsh.update(ir_b)
    y2 = np.asarray(jsh.process(x.reshape(-1)))
    c = JFFTConvolver(ir, B, len(ir))
    r1 = np.asarray(c.process(x.reshape(-1)))
    c.update(ir_b)
    r2 = np.asarray(c.process(x.reshape(-1)))
    for res in results:
        assert res["two_d"]["state"]["segments"].shape[0] == jsh.cfg.seg_count // 2
        _close(res["two_d"]["y"][0], y1, ATOL)
        _close(res["two_d"]["y"][0], r1, ATOL)
        _close(res["two_d"]["y"][1], y2, ATOL)
        _close(res["two_d"]["y"][1], r2, ATOL)
    _sp_states_close(results, "two_d", jsh.cfg, jsh.state, 2, "2-D exit")


@pytest.mark.parametrize("case", ["update", "transient"])
def test_sharded_update_matches_uniform_mid_stream(ranks, case):
    """:415 and :439 — update() mid-stream, 16 -> 5 segments at current 3
    and 16 -> 2 at current 14 (writes land in dead slots until the head
    falls below the active count: the masked-gather path)."""
    results = ranks(2)
    ir_a, ir_b, x = _update() if case == "update" else _transient()
    cut = 13 if case == "update" else 2
    jsh = jpartition.ShardedFFTConvolver(ir_a, B, len(ir_a), mesh=_jmesh(2))
    c = JFFTConvolver(ir_a, B, len(ir_a))
    want, ref = [], []
    for lo, hi in ((0, cut), (cut, len(x))):
        if lo:
            jsh.update(ir_b)
            c.update(ir_b)
        want.append(np.asarray(jsh.process(x[lo:hi].reshape(-1))))
        ref.append(np.asarray(c.process(x[lo:hi].reshape(-1))))
    for res in results:
        for got, w_, r_ in zip(res[case]["y"], want, ref):
            _close(got, w_, ATOL)
            _close(got, r_, ATOL)
    _sp_states_close(results, case, jsh.cfg, jsh.state, 2)


def test_sharded_update_padded_seg_count(ranks):
    """:461 — seg_count padding (6 -> 8 rows on 4 ranks): the sharded engine
    equals a reference convolver with max_response_length padded to the
    mesh multiple, through an update; a longer update raises."""
    w = 4
    results = ranks(w)
    ir_a, ir_b, x = _padded_update()
    jsh = jpartition.ShardedFFTConvolver(ir_a, B, len(ir_a), mesh=_jmesh(w))
    n = jsh.cfg.seg_count
    assert n == 8
    c = JFFTConvolver(ir_a, B, n * B)
    r1 = np.asarray(c.process(x[:11].reshape(-1)))
    jy1 = np.asarray(jsh.process(x[:11].reshape(-1)))
    c.update(ir_b)
    jsh.update(ir_b)
    r2 = np.asarray(c.process(x[11:].reshape(-1)))
    jy2 = np.asarray(jsh.process(x[11:].reshape(-1)))
    for res in results:
        got = res["padded_update"]
        assert got["state"]["segments"].shape[0] * w == n
        _close(got["y"][0], r1, ATOL)
        _close(got["y"][1], r2, ATOL)
        _close(got["y"][0], jy1, ATOL)
        _close(got["y"][1], jy2, ATOL)
        assert got["raised"] == ["ValueError"]
    _sp_states_close(results, "padded_update", jsh.cfg, jsh.state, w)


def test_sharded_reset_repeatable(ranks):
    """:485 — reset() clears the input state and keeps the IR."""
    ir, x = _reset()
    ref = np.asarray(JFFTConvolver(ir, B, len(ir)).process(x.reshape(-1)))
    for res in ranks(2):
        y1, y2 = res["reset"]["y"]
        _close(y1, y2, REPEAT)
        _close(y1, ref, ATOL)


def test_sharded_clone_independent(ranks):
    """:607 — a clone's update and stream leave the original untouched."""
    ir, x, _ = _clone()
    c = JFFTConvolver(ir, B, len(ir))
    c.process(x[:4].reshape(-1))
    ref = np.asarray(c.process(x[4:].reshape(-1)))
    for res in ranks(2):
        _, _, _, y_orig, y_ref = res["clone"]["y"]
        _close(y_orig, y_ref, REPEAT)
        _close(y_orig, ref, ATOL)


def test_crossfade_wraps_sharded_engine(ranks):
    """:575 — the generic CrossfadeConvolver over the sharded engine needs
    nothing beyond its clone, device and cfg: live IR switching on an IR
    that spans the mesh, against the JAX wrapper over the single-device
    engine, and the fade really moved."""
    ir_a, ir_b, x = _crossfade()
    cf = JCrossfade(JFFTConvolver(ir_a, B, len(ir_a)), len(ir_a), B, 128)
    r1 = np.asarray(cf.process(x[:8].reshape(-1)))
    cf.update(ir_b)
    r2 = np.asarray(cf.process(x[8:].reshape(-1)))
    for res in ranks(2):
        y1, y2, _, y_none = res["crossfade"]["y"]
        _close(y1, r1, ATOL)
        _close(y2, r2, ATOL)
        assert np.max(np.abs(y2 - y_none)) > 1e-3


# ---- the sharded two-stage engine ------------------------------------------------------

def test_sharded_two_stage_matches_single_device(ranks):
    """:499 — head and tail0 replicated, the main tail sp-sharded (one
    all-reduce a period), across two calls: against the JAX sharded
    engine and the single-device engine; exit states too."""
    ir, x = _two_stage()
    jsh = jtwo_stage_sp.ShardedTwoStageConvolver(ir, B, len(ir), mesh=_jmesh(2))
    assert jsh.cfg.tail_block == 512 and jsh.cfg.period == 8
    want = np.concatenate([np.asarray(jsh.process(x[:1024])), np.asarray(jsh.process(x[1024:]))])
    ref = np.asarray(JTwoStage(ir, B, len(ir)).process(x))
    results = ranks(2)
    for res in results:
        got = res["two_stage"]
        assert got["tail_block"] == 512
        y = np.concatenate(got["y"])
        _close(y, want, ATOL)
        _close(y, ref, ATOL)
        st = got["state"]
        assert st["head_current"] == int(jsh.state.head.current)
        for k in ("tail_output", "tail_precalc", "tail_output0", "tail_precalc0"):
            _close(st[k], np.asarray(getattr(jsh.state, k)), ATOL, k)
        _close_scaled(st["head_segments"], _jspectra(jsh.state.head.segments), SPEC_REL)
    _sp_states_close(results, "two_stage", jsh.cfg.tail, jsh.state.tail, 2, "big tail")


def test_sharded_two_stage_update_reset_clone(ranks):
    """:521 — update raises like the reference's todo!(); update_extension,
    snapshot/restore and clone independence against the single-device
    extension; reset repeatability; a too-short IR and misaligned input
    raise."""
    ir_a, ir_b, x = _two_stage_ops()
    tb = 512
    ref = JTwoStage(ir_a, B, len(ir_a))
    r0 = np.asarray(ref.process(x[:2 * tb]))
    ref.update_extension(ir_b)
    r_updated = np.asarray(ref.process(x[2 * tb:]))
    ref2 = JTwoStage(ir_a, B, len(ir_a))
    ref2.process(x[:2 * tb])
    r_old = np.asarray(ref2.process(x[2 * tb:]))
    for res in ranks(2):
        got = res["two_stage_ops"]
        y0, y_upd, y_twin, y_restored, y1, y2 = got["y"]
        _close(y0, r0, ATOL)
        _close(y_upd, r_updated, ATOL)
        _close(y_twin, r_updated, ATOL)
        _close(y_restored, r_old, ATOL)
        _close(y1, y2, REPEAT)
        assert got["raised"] == ["NotImplementedError", "ValueError", "ValueError"]


# ---- the voice-sharded farms -----------------------------------------------------------

def _by_voice(results, name, key="y"):
    """Each rank's voice slab placed in the whole farm's voice axis."""
    def put(ys):
        return np.concatenate(ys, axis=1)
    per_rank = [r[name][key] for r in results]
    assert [r[name]["voices"] for r in results] == sorted(r[name]["voices"] for r in results)
    if isinstance(per_rank[0], list):
        return [put([p[i] for p in per_rank]) for i in range(len(per_rank[0]))]
    return put(per_rank)


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_farm_matches_unsharded(ranks, w):
    """:36 — each rank streams its voice slab (``voice_slab`` of its
    ``voice_range``, the JAX ``shard_farm``) through ``farm_stream`` (no
    collective); against the JAX sharded and unsharded farms; the
    ring slabs against the JAX state's rows."""
    results = ranks(w)
    irs, x = _farm()
    jcfg, jst = jfarm.farm_init(jnp.asarray(irs), B, 256)
    jst2, want = jax.jit(functools.partial(jfarm.farm_stream, jcfg))(jst, jnp.asarray(x))
    mesh = jfarm.make_farm_mesh(jax.devices()[:w])
    _, want_sh = jfarm.sharded_farm_stream(jcfg, mesh)(jfarm.shard_farm(mesh, jst),
                                                      jnp.asarray(x))
    y = _by_voice(results, "farm")
    _close(y, want, ATOL)
    _close(y, want_sh, ATOL)
    ring = _jspectra(jst2.segments)
    for res in results:
        lo, hi = res["farm"]["voices"]
        _close_scaled(res["farm"]["segments"], ring[lo:hi], SPEC_REL)
        assert res["farm"]["current"] == int(jst2.current[0])


def _farm2_states_close(results, name, jcfg, jst):
    """Each rank's farm2 slab against the JAX state's voices (interop)."""
    for res in results:
        got = res[name]["state"]
        want = tfarm2.voice_slab(interop.farm_state(jcfg, jst), range(*res[name]["voices"]))
        assert (got["q"], got["head_current"]) == (want.tail.q, want.head.current)
        for k in ("hist", "tail_output", "tail_precalc"):
            _close_scaled(got[k], getattr(want, k).numpy(), SPEC_REL, k)
        _close_scaled(got["overlap"], want.tail.overlap.numpy(), SPEC_REL, "tail overlap")
        _close_scaled(got["ring"], want.tail.ring.numpy(), SPEC_REL, "tail ring")


@pytest.mark.parametrize("w", [2, 4])
def test_farm2_sharded_matches_unsharded(ranks, w):
    """:181 — the rank's ``farm2.voice_slab`` (head-side stages by voice, the
    fused tail's columns by voice, lockstep scalars replicated; the JAX
    ``farm2_shard``) streamed by ``farm2_stream`` over two calls: against
    the JAX farm unsharded and under shard_map on w devices; exit slabs
    against the JAX state's voices."""
    irs, x = _farm2()
    jcfg, jst = jfarm2.farm2_init(irs, B, FARM2_LEN)
    assert jcfg.tail is not None
    run = jax.jit(functools.partial(jfarm2.farm2_stream, jcfg, tail_mac="jnp"))
    jmesh = jfarm.make_farm_mesh(jax.devices()[:w])
    run_sh = jax.jit(functools.partial(jfarm2.farm2_stream_sharded, jmesh, jcfg,
                                       tail_mac="jnp"))
    sst = jfarm2.farm2_shard(jmesh, jst)
    results = ranks(w)
    got = _by_voice(results, "farm2")
    for call in range(2):
        jst, want = run(jst, jnp.asarray(x))
        sst, want_sh = run_sh(sst, jnp.asarray(x))
        _close(got[call], want, ATOL, f"call {call}")
        _close(got[call], want_sh, ATOL, f"call {call}, shard_map")
    _farm2_states_close(results, "farm2", jcfg, jst)


def test_farm2_stream_sharded_packed(ranks):
    """:733 — bf16 tail storage sharded by voice, each call from the JAX
    bf16 farm's state carried over to each rank's slab
    (``interop.farm_state`` cut by ``voice_slab``: the packed words map
    exactly to bf16 pairs): outputs at the f32 tolerance."""
    _, _, ys = _j_farm2_packed_states()
    got = _by_voice(ranks(2), "farm2_packed")
    for call, (g, want) in enumerate(zip(got, ys)):
        _close(g, want, ATOL, f"call {call}")


# ---- the examples ------------------------------------------------------------------------

def test_dryrun_multichip_4():
    """``tests/test_graft_entry.py:16`` — the dry run's checks on a (2, 2)
    mesh and a 4-rank "dp" mesh, each sharded form against the
    single-device engine."""
    worst = dryrun_multichip.dryrun_multichip(4, device="cpu")
    assert set(worst) == {"dp farm step", "sp step", "sp update", "sp two-stage", "dp farm2",
                          "dp farm2 update_voices", "dp farm2 bf16"}
    assert max(worst.values()) <= ATOL


def test_giant_ir_multichip_example(capsys):
    """The giant-IR example on 2 ranks: the sharded two-stage engine
    against the single-device one, and each rank holding half the ring."""
    out = giant_ir_multichip.main(["--ranks", "2", "--ir-seconds", "0.25", "--device", "cpu"])
    assert out["err"] <= ATOL
    r0, r1 = out["ranks"]
    assert r0["tail_ring"] == r1["tail_ring"] == r0["tail_table"] // 2
    assert "max_abs_diff vs single-device engine" in capsys.readouterr().out


MESH_ENTRY_POINTS = {
    "run_ranks": lambda: run_ranks(torch_ranks.run_jobs, 2, {}),
    "dryrun_multichip": lambda: dryrun_multichip.dryrun_multichip(2),
    "giant_ir_multichip": lambda: giant_ir_multichip.main(["--ranks", "2", "--ir-seconds",
                                                          "0.25"]),
}


@pytest.mark.parametrize("name", sorted(MESH_ENTRY_POINTS))
def test_mesh_entry_point_defaults_to_the_card(name):
    """``run_ranks`` and the two examples run their ranks on the card unless
    the caller asks for the CPU: without a card the default raises before
    any rank starts (the tests above pass ``device="cpu"``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        MESH_ENTRY_POINTS[name]()
