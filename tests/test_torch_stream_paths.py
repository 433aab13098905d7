"""The port's batched streams against the JAX package's and against the
port's own sequential block loop, on the same numpy-seeded inputs — the
port of ``tests/test_stream_paths.py`` for the stream cores the port keeps:
the ring's conv core (``models/uniform._stream_conv``, a causal
convolution along the block axis on ``torch.fft``), the fused head+tail0
front end (``models/two_stage._fused_small_streams``) and the CHRONO big
tail (``models/uniform.stream_conv_chrono``; its own tests are in
``test_torch_chrono.py``).

Outputs are held to 1e-5 abs and exit states (ring, head, accumulator,
overlap, period buffers) to 1e-4, as the JAX tests hold theirs; every test
also counts the calls of each core, so a silent fall into another path
fails.

Left out, with what they test: ``:113`` and ``:148`` (the correlation
cores), ``:348`` (the eight-core decision tree), ``:395`` (``irdft_pair``,
which exists for a planes-outer layout) and ``:462`` (``assume_clean_small``,
the trace-time elision of the fused front end's guard; the port's guard is
host ints and costs nothing, and the elision's missing ``current`` check is
ROADMAP C1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_convolution_tpu as J
import fft_convolution_tpu_torch as T
from fft_convolution_tpu.models import two_stage as jtwo
from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu.ops.fft import generate_sinusoid
from fft_convolution_tpu.parallel import farm as jfarm
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.models import two_stage as ttwo
from fft_convolution_tpu_torch.models import uniform as tuni
from fft_convolution_tpu_torch.parallel import farm as tfarm

OUT_TOL = 1e-5
STATE_TOL = 1e-4


def _x(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=msg)


def _uni_state_close(got: tuni.UniformState, want: tuni.UniformState, atol=STATE_TOL,
                     msg=""):
    for f in ("segments", "pre_multiplied", "overlap", "input_buffer"):
        _close(getattr(got, f), getattr(want, f), atol, f"{msg} {f}")
    for f in ("current", "input_fill", "active_segs"):
        assert getattr(got, f) == getattr(want, f), f"{msg} {f}"


def _two_state_close(got: ttwo.TwoStageState, want: ttwo.TwoStageState, atol=STATE_TOL,
                     msg=""):
    for stage in ("head", "tail0", "tail"):
        _uni_state_close(getattr(got, stage), getattr(want, stage), atol, f"{msg} {stage}")
    for f in ttwo._BUFFERS:
        _close(getattr(got, f), getattr(want, f), atol, f"{msg} {f}")
    assert (got.tail_fill, got.precalc_pos) == (want.tail_fill, want.precalc_pos)


def _two_state_equivalent(got: ttwo.TwoStageState, want: ttwo.TwoStageState,
                          atol=STATE_TOL, msg=""):
    """:func:`_two_state_close` with the big tail's ring compared by delay:
    a CHRONO round trip leaves the same history under another ring head."""
    for stage in ("head", "tail0"):
        _uni_state_close(getattr(got, stage), getattr(want, stage), atol, f"{msg} {stage}")
    for f in ("pre_multiplied", "overlap", "input_buffer"):
        _close(getattr(got.tail, f), getattr(want.tail, f), atol, f"{msg} tail {f}")
    _close(tuni.ring_window(got.tail.segments, got.tail.current)[1:],
           tuni.ring_window(want.tail.segments, want.tail.current)[1:], atol, f"{msg} tail ring")
    for f in ttwo._BUFFERS:
        _close(getattr(got, f), getattr(want, f), atol, f"{msg} {f}")
    assert (got.tail_fill, got.precalc_pos) == (want.tail_fill, want.precalc_pos)


def _uni_blocks(cfg, state, x):
    """The port's sequential path: one process_block per block."""
    return torch.stack([tuni.process_block(cfg, state, xb) for xb in x])


def _two_blocks(cfg, state, x):
    return torch.stack([ttwo.process_block(cfg, state, xb) for xb in x])


def _conv_calls(fn):
    """``fn()`` and the number of conv-core calls it made."""
    before = tuni._stream_conv.calls
    out = fn()
    return out, tuni._stream_conv.calls - before


_CORES = (tuni._stream_conv, ttwo._fused_small_streams, tuni.stream_conv_chrono)


def _core_calls(fn):
    """``fn()`` and its calls of each stream core: ``(ring conv core, fused
    head+tail0 front end, CHRONO tail)``."""
    before = [c.calls for c in _CORES]
    out = fn()
    return out, tuple(c.calls - b for c, b in zip(_CORES, before))


def _thresh_q(cfg):
    return next(q for q in range(1, 129) if ttwo.tail_uses_conv_core(cfg, q * cfg.period))


def test_uniform_batched_stream_matches_scan():
    rng = np.random.default_rng(20)
    ir = rng.standard_normal(3000).astype(np.float32) * 0.1
    jcfg, js = juni.init(ir, 64, len(ir))
    x = rng.standard_normal((101, 64)).astype(np.float32)
    js_fast, y_fast = jax.jit(functools.partial(juni.process_stream, jcfg))(js, jnp.asarray(x))

    cfg = tuni.make_config(64, len(ir))
    st, st_seq = interop.uniform_state(js), interop.uniform_state(js)
    y, calls = _conv_calls(lambda: tuni.process_stream(cfg, st, _x(x)))
    assert calls == 1
    y_seq = _uni_blocks(cfg, st_seq, _x(x))
    # From a zero state the output is the direct convolution.  At this
    # output's scale (~23) two float32 implementations need not agree to
    # OUT_TOL: JAX's own output misses float64 by ~1.1e-5 here.  So the port
    # is held to float64 at OUT_TOL, and to JAX at OUT_TOL plus JAX's own
    # error against float64 (what the triangle inequality allows two
    # implementations that each meet their bound).
    ref64 = np.convolve(x.reshape(-1).astype(np.float64),
                        ir.astype(np.float64))[:x.size].reshape(x.shape)
    jax_err64 = float(np.abs(np.asarray(y_fast, np.float64) - ref64).max())
    _close(y, ref64, OUT_TOL, "vs float64")
    _close(y, y_fast, OUT_TOL + jax_err64, "vs JAX")
    _close(y, y_seq, OUT_TOL, "vs the block loop")
    _uni_state_close(st, interop.uniform_state(js_fast), msg="vs JAX")
    _uni_state_close(st, st_seq, msg="vs the block loop")


def test_uniform_batched_stream_state_handoff():
    """stream -> block loop -> stream interleaving equals the JAX scan and
    the port's own pure block loop, exit state included."""
    rng = np.random.default_rng(21)
    ir = rng.standard_normal(1000).astype(np.float32) * 0.1
    jcfg, js = juni.init(ir, 64, len(ir))
    x = rng.standard_normal((60, 64)).astype(np.float32)
    js_ref, y_ref = jax.jit(functools.partial(juni.process_stream_scan, jcfg))(
        js, jnp.asarray(x))

    cfg = tuni.make_config(64, len(ir))
    st, st_seq = interop.uniform_state(js), interop.uniform_state(js)
    ys = []
    before = tuni._stream_conv.calls
    for fast, lo, hi in [(True, 0, 20), (False, 20, 41), (True, 41, 60)]:
        run = tuni.process_stream if fast else _uni_blocks
        ys.append(run(cfg, st, _x(x[lo:hi])))
    assert tuni._stream_conv.calls - before == 2
    y = torch.cat(ys)
    _close(y, y_ref, OUT_TOL, "vs the JAX scan")
    _close(y, _uni_blocks(cfg, st_seq, _x(x)), OUT_TOL, "vs the block loop")
    _uni_state_close(st, interop.uniform_state(js_ref), msg="vs JAX")
    _uni_state_close(st, st_seq, msg="vs the block loop")


def test_two_stage_aligned_matches_scan():
    rng = np.random.default_rng(22)
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    jcfg, js = jtwo.init(ir, 64, len(ir))
    p = jcfg.period
    q = 5
    x = rng.standard_normal((q * p, 64)).astype(np.float32)
    js_fast, y_fast = jax.jit(functools.partial(jtwo.process_stream_aligned, jcfg))(
        js, jnp.asarray(x))

    cfg, _ = ttwo.init(ir, 64, len(ir))
    st, st_seq = interop.two_stage_state(js), interop.two_stage_state(js)
    y, calls = _core_calls(lambda: ttwo.process_stream_aligned(cfg, st, _x(x)))
    assert calls == (0, 1, 0)  # head and tail0 fused; the q = 5 big tail is sequential
    y_seq = _two_blocks(cfg, st_seq, _x(x))
    _close(y, y_fast, OUT_TOL, "vs JAX")
    _close(y, y_seq, OUT_TOL, "vs the block loop")
    _two_state_close(st, interop.two_stage_state(js_fast), msg="vs JAX")
    _two_state_close(st, st_seq, msg="vs the block loop")


def test_two_stage_aligned_single_period_and_handoff():
    """q = 1 twice, then the block loop over a ragged three blocks; against
    the JAX scan and the port's pure block loop."""
    rng = np.random.default_rng(23)
    ir = rng.standard_normal(9000).astype(np.float32) * 0.05
    jcfg, js = jtwo.init(ir, 64, len(ir))
    p = jcfg.period
    x = rng.standard_normal((2 * p + 3, 64)).astype(np.float32)
    js_ref, y_ref = jax.jit(functools.partial(jtwo.process_stream, jcfg))(js, jnp.asarray(x))

    cfg, _ = ttwo.init(ir, 64, len(ir))
    st, st_seq = interop.two_stage_state(js), interop.two_stage_state(js)
    khats = ttwo.stream_khats(cfg, st, p)
    ys, calls = _core_calls(lambda: [ttwo.process_stream_aligned(cfg, st, _x(x[:p]), khats),
                                     ttwo.process_stream_aligned(cfg, st, _x(x[p:2 * p]), khats),
                                     _two_blocks(cfg, st, _x(x[2 * p:]))])
    assert calls == (0, 2, 0)  # head and tail0 fused a call
    y = torch.cat(ys)
    _close(y, y_ref, OUT_TOL, "vs the JAX scan")
    _close(y, _two_blocks(cfg, st_seq, _x(x)), OUT_TOL, "vs the block loop")
    _two_state_close(st, interop.two_stage_state(js_ref), msg="vs JAX")
    _two_state_close(st, st_seq, msg="vs the block loop")


def test_two_stage_wrapper_uses_aligned_path():
    """End to end through the public API with a period-multiple input,
    against the uniform engine (the reference's own equivalence,
    tests.rs:148-175) and the JAX wrapper."""
    block = 64
    response = generate_sinusoid(12000, 1000.0, 44100.0, 0.1)
    a = T.FFTConvolver(response, block // 2, len(response), device="cpu")
    b = T.TwoStageFFTConvolver(response, block, len(response), device="cpu")
    n = b.cfg.tail_block * 4
    x = generate_sinusoid(n, 1300.0, 44100.0, 0.1)
    y_a, calls_a = _conv_calls(lambda: a.process(x))
    y_b, calls_b = _core_calls(lambda: b.process(x))  # n % tail_block == 0: aligned
    assert (calls_a, calls_b) == (1, (0, 1, 1))
    _close(y_b, y_a, OUT_TOL)
    _close(y_b, J.TwoStageFFTConvolver(response, block, len(response)).process(x), OUT_TOL,
           "vs the JAX wrapper")


def test_stream_khat_exact_and_coherent():
    """The cached kernel meta-spectra give the same stream as the inline
    ones, for a shrunk engine too (masked table), and the wrappers' caches
    are cleared by update()/update_extension()."""
    rng = np.random.default_rng(50)
    b = 64
    ir = rng.standard_normal(2000).astype(np.float32) * 0.1
    t = 32
    x = rng.standard_normal((t, b)).astype(np.float32)

    # core level, a shrunk-active engine
    jcfg, js = juni.init(ir, b, len(ir))
    short = rng.standard_normal(900).astype(np.float32) * 0.1
    padded = np.zeros(jcfg.seg_count * b, np.float32)
    padded[:900] = short
    js = juni.update(jcfg, js, jnp.asarray(padded), jnp.asarray(900, jnp.int32))
    kh = jax.jit(functools.partial(juni.stream_khat, jcfg), static_argnums=(1,))(js, t)
    _, yj = jax.jit(functools.partial(juni.process_stream, jcfg))(js, jnp.asarray(x),
                                                                  kern_hat=kh)
    cfg = tuni.make_config(b, len(ir))
    s1, s2 = interop.uniform_state(js), interop.uniform_state(js)
    assert s1.active_segs < cfg.seg_count
    y1, calls1 = _conv_calls(lambda: tuni.process_stream(cfg, s1, _x(x)))
    y2, calls2 = _conv_calls(
        lambda: tuni.process_stream(cfg, s2, _x(x), tuni.stream_khat(cfg, s2, t)))
    assert calls1 == calls2 == 1
    assert torch.equal(y1, y2) and torch.equal(s1.segments, s2.segments)
    _close(y2, yj, OUT_TOL, "vs JAX")

    # two-stage aligned core with and without khats
    ir_l = rng.standard_normal(60000).astype(np.float32) * 0.02
    tcfg, tst = ttwo.init(ir_l, b, len(ir_l))
    tt = 2 * tcfg.period
    xs = rng.standard_normal((tt, b)).astype(np.float32)
    khs = ttwo.stream_khats(tcfg, tst, tt)
    ya = ttwo.process_stream_aligned(tcfg, tst.clone(), _x(xs))
    yb = ttwo.process_stream_aligned(tcfg, tst.clone(), _x(xs), khats=khs)
    _close(ya, yb, 2e-6)

    # wrapper cache coherence across update()
    c = T.FFTConvolver(ir, b, len(ir), device="cpu")
    c.process(x.reshape(-1))
    assert c._khat_cache
    c.update(short)
    assert not c._khat_cache
    y_upd = c.process(x.reshape(-1))
    c_ref = T.FFTConvolver(ir, b, len(ir), device="cpu")
    c_ref.process(x.reshape(-1))
    c_ref.update(short)
    # the same stream one block a call (the block loop, no khat) on a twin
    _close(y_upd, torch.cat([c_ref.process(x.reshape(-1)[i:i + b])
                             for i in range(0, t * b, b)]), OUT_TOL)

    e = T.TwoStageFFTConvolver(ir_l, b, len(ir_l), device="cpu")
    e.process(xs.reshape(-1))
    assert e._khat_cache
    e.update_extension(rng.standard_normal(50000).astype(np.float32) * 0.02)
    assert not e._khat_cache


def test_uniform_big_block_khat_routes_conv_core():
    """A kernel meta-spectrum flips a huge-block stream (block > 2048, the
    two-stage big tail's regime) from the block loop to the conv core;
    outputs and state match the block loop and the JAX conv core."""
    rng = np.random.default_rng(63)
    block = 4096
    ir = rng.standard_normal(150000).astype(np.float32) * 0.02
    jcfg, js = juni.init(ir, block, len(ir))
    t = 12
    x = rng.standard_normal((t, block)).astype(np.float32)
    kh = jax.jit(functools.partial(juni.stream_khat, jcfg), static_argnums=(1,))(js, t)
    js_conv, yj = jax.jit(functools.partial(juni.process_stream, jcfg))(
        js, jnp.asarray(x), kern_hat=kh)

    cfg = tuni.make_config(block, len(ir))
    s_scan, s_conv = interop.uniform_state(js), interop.uniform_state(js)
    y_scan, calls_scan = _conv_calls(lambda: tuni.process_stream(cfg, s_scan, _x(x)))
    y_conv, calls_conv = _conv_calls(
        lambda: tuni.process_stream(cfg, s_conv, _x(x), tuni.stream_khat(cfg, s_conv, t)))
    assert (calls_scan, calls_conv) == (0, 1)
    scale = max(float(y_scan.abs().max()), 1.0)
    _close(y_conv, y_scan, 1e-5 * scale)
    _close(y_conv, yj, 1e-5 * scale, "vs JAX")
    for want, msg in ((s_scan, "vs the block loop"), (interop.uniform_state(js_conv), "vs JAX")):
        for f in ("segments", "pre_multiplied", "overlap"):
            ref = getattr(want, f)
            _close(getattr(s_conv, f), ref, 1e-5 * max(float(ref.abs().max()), 1.0),
                   f"{msg} {f}")
        assert s_conv.current == want.current


def test_two_stage_tail_khat_conv_core_matches():
    """Aligned calls long enough for the big tail's conv core
    (``tail_uses_conv_core``) match the khat-free aligned path (big tail in
    the block loop) across two chained calls: the second exposes the first
    call's tail output (two periods late) and the tail ring the conv core
    left behind."""
    rng = np.random.default_rng(64)
    ir = rng.standard_normal(150000).astype(np.float32) * 0.02
    cfg, state = ttwo.init(ir, 64, len(ir))
    assert cfg.tail is not None and cfg.tail.block_size > 2048
    t = _thresh_q(cfg) * cfg.period
    khs = ttwo.stream_khats(cfg, state, t)
    assert "tail" in khs
    x1 = _x(rng.standard_normal((t, 64)))
    x2 = _x(rng.standard_normal((t, 64)))
    sa, sb = state.clone(), state.clone()
    (ya1, ya2), calls = _core_calls(
        lambda: [ttwo.process_stream_aligned(cfg, sa, x, khats=khs) for x in (x1, x2)])
    assert calls == (2, 2, 0)  # a call: head and tail0 fused, the big tail on the ring core
    yb1 = ttwo.process_stream_aligned(cfg, sb, x1)
    yb2 = ttwo.process_stream_aligned(cfg, sb, x2)
    scale = max(float(yb2.abs().max()), 1.0)
    _close(ya1, yb1, 1e-5 * scale)
    _close(ya2, yb2, 1e-5 * scale)
    # every state leaf at 1e-5 of its own scale, as the JAX test holds them
    leaves = [(f"{s} {f}", getattr(getattr(sa, s), f), getattr(getattr(sb, s), f))
              for s in ("head", "tail0", "tail")
              for f in ("segments", "pre_multiplied", "overlap", "input_buffer")]
    leaves += [(f, getattr(sa, f), getattr(sb, f)) for f in ttwo._BUFFERS]
    for name, got, ref in leaves:
        tol = 1e-5 * max(float(ref.abs().max()) if ref.numel() else 1.0, 1.0)
        _close(got, ref, tol, name)
    for s in ("head", "tail0", "tail"):
        assert getattr(sa, s).current == getattr(sb, s).current, s
    assert (sa.tail_fill, sa.precalc_pos) == (sb.tail_fill, sb.precalc_pos)


def test_two_stage_wrapper_long_call_conv_tail():
    """One process() call long enough to send the big tail to the conv core
    matches the uniform engine end to end; the wrapper's cache holds the
    tail's meta-spectra for that length (the CHRONO tail: the wrapper takes
    it whenever the call fits its history)."""
    rng = np.random.default_rng(65)
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    b = T.TwoStageFFTConvolver(ir, 64, len(ir), device="cpu")
    q = _thresh_q(b.cfg)
    n = q * b.cfg.tail_block
    x = rng.standard_normal(n).astype(np.float32) * 0.3
    a = T.FFTConvolver(ir, 32, len(ir), device="cpu")
    y_a = a.process(x)
    y_b, calls = _core_calls(lambda: b.process(x))
    assert calls == (0, 1, 1)
    assert "tail" in b._khat_cache[(q * b.cfg.period, True)]
    _close(y_b, y_a, 1e-5 * max(float(y_a.abs().max()), 1.0))


# ---- beyond the JAX test file --------------------------------------------------------

def test_two_stage_shrink_then_full_update_aligned_output():
    """ROADMAP C1: ``update_extension`` to a shorter IR, blocks in between
    (the head and tail0 rings then decrement modulo different active
    counts), a full-length update, then an aligned call.  The port's
    aligned output matches its own block loop and the JAX package's
    sequential ``_process_chunked``, the ground truth in this regime."""
    rng = np.random.default_rng(66)
    b = 64
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    ours = T.TwoStageFFTConvolver(ir, b, len(ir), device="cpu")
    theirs = J.TwoStageFFTConvolver(ir, b, len(ir))
    p, tb = ours.cfg.period, ours.cfg.tail_block
    short = ir[: tb // 2 + 3 * b + 5]
    x1 = rng.standard_normal(tb + 3 * b).astype(np.float32)
    x2 = rng.standard_normal(tb - 3 * b).astype(np.float32)
    x3 = rng.standard_normal(3 * tb).astype(np.float32)
    for c in (ours, theirs):
        c.update_extension(short)
        c.process(x1)
        c.process(x2)
        c.update_extension(ir)
    assert ours.state.tail_fill == 0
    assert ours.state.head.current != ours.state.tail0.current
    seq = ours.clone()
    y, calls = _core_calls(lambda: ours.process(x3))
    # the currents differ, so the fused front end's guard fails: head and
    # tail0 run apart on the ring core; the full tail ring takes CHRONO
    assert calls == (2, 0, 1)
    _close(y, seq._process_blocks(_x(x3)), OUT_TOL, "vs the block loop")
    _close(y, theirs._process_chunked(x3), OUT_TOL, "vs the JAX sequential path")
    assert x3.size // b == 3 * p


def test_fft_convolver_khat_cache_coherence():
    """update() and restore() clear the cache; a clone updated after
    cloning serves its own meta-spectra, not the other's; a cached
    meta-spectrum of another size is never served."""
    rng = np.random.default_rng(67)
    b = 64
    ir = rng.standard_normal(1500).astype(np.float32) * 0.1
    ir2 = rng.standard_normal(1500).astype(np.float32) * 0.1
    c = T.FFTConvolver(ir, b, len(ir), device="cpu")
    x = rng.standard_normal(40 * b).astype(np.float32)
    c.process(x[:16 * b])
    snap = c.snapshot()
    (m,) = c._khat_cache
    assert m == tuni.meta_size(c.cfg.seg_count, 16)

    twin = c.clone()
    assert twin._khat_cache == c._khat_cache and twin._khat_cache is not c._khat_cache
    twin.update(ir2)
    assert not twin._khat_cache and c._khat_cache
    ref = T.FFTConvolver(ir, b, len(ir), device="cpu")
    ref.process(x[:16 * b])
    ref.update(ir2)
    _close(twin.process(x[16 * b:32 * b]), torch.cat(
        [ref.process(x[i:i + b]) for i in range(16 * b, 32 * b, b)]), OUT_TOL,
        "clone updated after cloning")
    # the original keeps its own table's meta-spectrum
    _close(c.process(x[16 * b:32 * b]),
           torch.from_numpy(np.convolve(x[:32 * b].astype(np.float64),
                                        ir.astype(np.float64))[16 * b:32 * b]), 2e-5)

    # a call of another meta size builds its own entry
    t_other = 3 * c.cfg.seg_count
    assert tuni.meta_size(c.cfg.seg_count, t_other) != m
    c.restore(snap)
    assert not c._khat_cache
    c.process(x[16 * b:32 * b])
    c.process(np.zeros(t_other * b, np.float32))
    assert sorted(c._khat_cache) == sorted({m, tuni.meta_size(c.cfg.seg_count, t_other)})
    with pytest.raises(ValueError, match="meta-bins"):
        tuni.process_stream(c.cfg, c.state, torch.zeros(t_other, b), c._khat_cache[m])


def test_two_stage_khat_cache_coherence():
    """update_extension() and restore() clear the two-stage cache (keyed by
    the call length); a clone updated after cloning does not serve the
    other's meta-spectra."""
    rng = np.random.default_rng(68)
    b = 64
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    ir2 = rng.standard_normal(9000).astype(np.float32) * 0.05
    c = T.TwoStageFFTConvolver(ir, b, len(ir), device="cpu")
    tb = c.cfg.tail_block
    x = rng.standard_normal(6 * tb).astype(np.float32)
    c.process(x[:2 * tb])
    assert list(c._khat_cache) == [(2 * c.cfg.period, True)]
    snap = c.snapshot()
    twin = c.clone()
    twin.update_extension(ir2)
    assert not twin._khat_cache and c._khat_cache
    ref = c.clone()
    ref.update_extension(ir2)
    _close(twin.process(x[2 * tb:4 * tb]), ref._process_blocks(_x(x[2 * tb:4 * tb])), OUT_TOL)
    _close(c.process(x[2 * tb:4 * tb]),
           torch.from_numpy(np.convolve(x[:4 * tb].astype(np.float64),
                                        ir.astype(np.float64))[2 * tb:4 * tb]), 2e-5)
    c.restore(snap)
    assert not c._khat_cache


def test_crossfade_fused_stream_matches_jax():
    """Aligned calls on two uniform engines take both engines' batched
    streams and one mix (two conv-core calls a call), mid-fade, against the
    JAX fused stream; unaligned calls take the engines' own paths."""
    rng = np.random.default_rng(69)
    b, n_ir = 64, 1000
    ir_a = rng.standard_normal(n_ir).astype(np.float32) * 0.1
    ir_b = rng.standard_normal(n_ir).astype(np.float32) * 0.1
    ours = T.CrossfadeConvolver(T.FFTConvolver(ir_a, b, n_ir, device="cpu"), n_ir, b, 3000)
    theirs = J.CrossfadeConvolver(J.FFTConvolver(ir_a, b, n_ir), n_ir, b, 3000)
    x = rng.standard_normal(60 * b + 37).astype(np.float32)
    for c in (ours, theirs):
        c.update(ir_b)
    assert ours._can_fuse(20 * b) and not ours._can_fuse(20 * b + 1)
    y1, calls = _conv_calls(lambda: ours.process(x[:20 * b]))
    assert calls == 2 and ours.is_crossfading()
    _close(y1, theirs.process(x[:20 * b]), OUT_TOL, "fused call")
    _close(ours.process(x[20 * b:20 * b + 37]), theirs.process(x[20 * b:20 * b + 37]), OUT_TOL,
           "unaligned call")
    assert not ours._can_fuse(b)  # the engines are mid-block now
    _close(ours.process(x[20 * b + 37:]), theirs.process(x[20 * b + 37:]), OUT_TOL, "rest")


@pytest.mark.parametrize("shrunk", [False, True])
def test_farm_stream_matches_jax(shrunk):
    """The uniform farm's stream: clean lockstep rings take the conv core
    over the voice axis (with ``farm_khat``), a shrunk farm the per-block
    loop; both against the JAX ``farm_stream`` and per-voice engines."""
    rng = np.random.default_rng(70)
    v, b, n_ir, t = 3, 64, 700, 11
    irs = rng.standard_normal((v, n_ir)).astype(np.float32) * 0.1
    jcfg, js = jfarm.farm_init(jnp.asarray(irs), b, n_ir)
    cfg, st = tfarm.farm_init(torch.from_numpy(irs), b, n_ir)
    x = rng.standard_normal((2, t, v, b)).astype(np.float32)
    engines = [T.FFTConvolver(irs[i], b, n_ir, device="cpu") for i in range(v)]
    if shrunk:
        new = rng.standard_normal((v, 300)).astype(np.float32) * 0.1
        pad = np.zeros((v, cfg.seg_count * b), np.float32)
        pad[:, :300] = new
        js = jfarm.farm_update(jcfg, js, jnp.asarray(pad), jnp.full((v,), 300, jnp.int32))
        tfarm.farm_update(cfg, st, torch.from_numpy(pad), 300)
        for e, r in zip(engines, new):
            e.update(r)
    for call in range(2):
        kh = None if shrunk else tfarm.farm_khat(cfg, st, t)
        js, yj = jfarm.farm_stream(jcfg, js, jnp.asarray(x[call]))
        y, calls = _conv_calls(lambda: tfarm.farm_stream(cfg, st, _x(x[call]), kern_hat=kh))
        assert calls == (0 if shrunk else 1)
        _close(y, yj, OUT_TOL, f"call {call} vs JAX")
        for i, e in enumerate(engines):
            _close(y[:, i].reshape(-1), e.process(x[call][:, i].reshape(-1)), OUT_TOL,
                   f"call {call} voice {i}")


# ---- the fused head+tail0 front end ------------------------------------------------

def test_fused_separate_form_matches_multi_and_scan(monkeypatch):
    """The fused front end's two side-pass forms (MULTI, one shared
    transform; SEPARATE, two small convolutions; ``fused_uses_multi`` routes
    on T) agree with each other and with the JAX package's sequential scan
    over two chained calls, exit state included (``tests/test_stream_paths.
    py:414``)."""
    rng = np.random.default_rng(51)
    b = 64
    ir_l = rng.standard_normal(60000).astype(np.float32) * 0.02
    jcfg, js = jtwo.init(ir_l, b, len(ir_l))
    cfg, _ = ttwo.init(ir_l, b, len(ir_l))
    tt = 3 * cfg.period
    xs = rng.standard_normal((tt, b)).astype(np.float32) * 0.3
    x2 = rng.standard_normal((tt, b)).astype(np.float32) * 0.3
    assert ttwo.fused_uses_multi(cfg, tt)

    def run(max_rows):
        monkeypatch.setattr(ttwo, "FUSED_MULTI_MAX_ROWS", max_rows)
        st = interop.two_stage_state(js)
        khs = ttwo.stream_khats(cfg, st, tt)
        assert ("t0f" in khs, "rec" in khs) == ((True, False) if max_rows else (False, True))
        ys, calls = _core_calls(
            lambda: [ttwo.process_stream_aligned(cfg, st, _x(x), khs) for x in (xs, x2)])
        assert calls == (0, 2, 0)  # the q = 3 big tail runs the block loop
        return ys, st

    multi, st_multi = run(1 << 30)
    sep, st_sep = run(0)
    for a, c in zip(multi, sep):
        _close(c, a, 2e-6)
    scan = jax.jit(functools.partial(jtwo.process_stream, jcfg))
    js1, yr1 = scan(js, jnp.asarray(xs))
    js2, yr2 = scan(js1, jnp.asarray(x2))
    scale = max(float(jnp.abs(yr1).max()), 1.0)
    for ys, st, form in ((multi, st_multi, "MULTI"), (sep, st_sep, "SEPARATE")):
        _close(ys[0], yr1, OUT_TOL * scale, f"{form} call 1 vs the JAX scan")
        _close(ys[1], yr2, OUT_TOL * scale, f"{form} call 2 vs the JAX scan")
        _two_state_close(st, interop.two_stage_state(js2), msg=f"{form} vs the JAX scan")


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("form", ["multi", "separate"])
def test_fused_front_end_exit_state_matches_jax(monkeypatch, form, q):
    """The port's fused front end against the JAX package's
    ``two_stage._fused_small_streams`` called directly, in one form each,
    from a mid-stream state whose ring head is not 0: output, both stages'
    exit states (ring, ``current``, accumulators, overlaps) and tail0's
    period buffers."""
    rng = np.random.default_rng(71)
    b = 64
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    jcfg, js = jtwo.init(ir, b, len(ir))
    p = jcfg.period
    js, _ = jax.jit(functools.partial(jtwo.process_stream, jcfg))(
        js, jnp.asarray(rng.standard_normal((2 * p + 5, b)).astype(np.float32)))
    max_rows = 1 << 30 if form == "multi" else 0
    monkeypatch.setattr(jtwo, "FUSED_MULTI_MAX_ROWS", max_rows)
    monkeypatch.setattr(ttwo, "FUSED_MULTI_MAX_ROWS", max_rows)
    x = rng.standard_normal((q * p, b)).astype(np.float32)
    jh, jt0, yj, jprecalc0, joutput0 = jax.jit(
        functools.partial(jtwo._fused_small_streams, jcfg))(
        js.head, js.tail0, jnp.asarray(x), js.tail_precalc0, None)

    cfg, _ = ttwo.init(ir, b, len(ir))
    st = interop.two_stage_state(js)
    assert st.head.current == st.tail0.current != 0
    khats = ttwo.stream_khats(cfg, st, q * p)
    y, calls = _core_calls(lambda: ttwo._fused_small_streams(cfg, st, _x(x), khats))
    assert calls == (0, 1, 0)
    _close(y, yj, OUT_TOL, "y")
    _uni_state_close(st.head, interop.uniform_state(jh), msg="head")
    _uni_state_close(st.tail0, interop.uniform_state(jt0), msg="tail0")
    _close(st.tail_precalc0, jprecalc0, STATE_TOL, "tail_precalc0")
    _close(st.tail_output0, joutput0, STATE_TOL, "tail_output0")


def test_wrapper_fused_guard_lifecycle():
    """The fused front end's host-int guard over the wrapper's life
    (``tests/test_stream_paths.py:506``): fused from init; apart after a
    shrinking update; still apart after a full update that leaves the two
    rings' heads unequal (ROADMAP C1); fused again once the heads agree
    (after ``reset``, or a shrink and full update with no call between).
    Every aligned call matches the same call replayed through the port's
    sub-block path from a snapshot and the JAX package's sequential path."""
    rng = np.random.default_rng(32)
    b = 64
    ir = (rng.standard_normal(12000) * 0.01).astype(np.float32)
    ours = T.TwoStageFFTConvolver(ir, b, len(ir), device="cpu")
    theirs = J.TwoStageFFTConvolver(ir, b, len(ir))
    tb = ours.cfg.tail_block
    short = ir[: tb // 2 + 3 * b + 5]  # head active 12 of 16 segments, tail0 none

    def aligned(fused: int, what: str):
        x = rng.standard_normal(2 * tb).astype(np.float32)
        snap = ours.snapshot()
        y, calls = _core_calls(lambda: ours.process(x))
        assert calls[1] == fused, what
        after = ours.snapshot()
        ours.restore(snap)
        _close(y, ours._process_chunked(_x(x)), OUT_TOL, f"{what}: vs the sub-block path")
        _two_state_equivalent(ours.state, after[0], msg=f"{what}: exit state")
        _close(y, theirs._process_chunked(x), OUT_TOL, f"{what}: vs the JAX sequential path")

    aligned(1, "from init")
    for c in (ours, theirs):
        c.update_extension(short)
    aligned(0, "shrunk")
    for c in (ours, theirs):
        c.update_extension(ir)
    assert ours.state.head.current != ours.state.tail0.current
    aligned(0, "full update, heads unequal")
    for c in (ours, theirs):
        c.reset()
    aligned(1, "after reset")
    for c in (ours, theirs):
        c.update_extension(short)
        c.update_extension(ir)
    assert ours.state.head.current == ours.state.tail0.current
    aligned(1, "shrink and full update with no call between")


def test_fused_after_update_single_period_calls():
    """``update_extension`` zeroes tail0's overlap; the fused front end's
    exit state takes that carried overlap as block 0's seam, so one-period
    aligned calls right after an update, and the call after them, match the
    sub-block path and the JAX package's sequential path.  (The JAX
    package's fused form rebuilds that seam from the history, and its next
    period's first block then differs; ROADMAP C3.)"""
    rng = np.random.default_rng(5)
    b = 64
    ir = (rng.standard_normal(12000) * 0.05).astype(np.float32)
    ir2 = (rng.standard_normal(12000) * 0.05).astype(np.float32)
    ours = T.TwoStageFFTConvolver(ir, b, len(ir), device="cpu")
    theirs = J.TwoStageFFTConvolver(ir, b, len(ir))
    tb = ours.cfg.tail_block
    x0 = rng.standard_normal(2 * tb).astype(np.float32)
    x = rng.standard_normal(3 * tb).astype(np.float32)
    for c in (ours, theirs):
        c.process(x0)
        c.update_extension(ir2)
    snap = ours.snapshot()
    y, calls = _core_calls(lambda: torch.cat([ours.process(x[i * tb:(i + 1) * tb])
                                              for i in range(3)]))
    assert calls[1] == 3
    ours.restore(snap)
    _close(y, ours._process_chunked(_x(x)), OUT_TOL, "vs the sub-block path")
    _close(y, theirs._process_chunked(x), OUT_TOL, "vs the JAX sequential path")
