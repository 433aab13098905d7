"""The port's CHRONO big-tail history against the JAX package's on the same
numpy-seeded inputs — the port of ``tests/test_chrono.py``.

The history of block-aligned streams is kept chronological
(``models/uniform.stream_conv_chrono``), one ``complex64 [h_cap, B+1]``
tensor with a host-int ``pos`` in place of the JAX package's plane pair.
Outputs are held to 1e-5 and exit states to 1e-4: the ``(hist, pos)`` pair
against the JAX pair (through :func:`fft_convolution_tpu_torch.interop.
chrono`), the ring rebuilt from it against the JAX package's, and the
outputs also against the port's ring paths.  The wrapper tests count the
calls of each stream core.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal
import torch

import fft_convolution_tpu as J
import fft_convolution_tpu_torch as T
from fft_convolution_tpu.models import two_stage as jtwo
from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.models import two_stage as ttwo
from fft_convolution_tpu_torch.models import uniform as tuni

OUT_TOL = 1e-5
STATE_TOL = 1e-4
_CORES = (tuni._stream_conv, ttwo._fused_small_streams, tuni.stream_conv_chrono)


def _x(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=msg)


def _core_calls(fn):
    """``fn()`` and its calls of ``(ring conv core, fused front end, CHRONO)``."""
    before = [c.calls for c in _CORES]
    out = fn()
    return out, tuple(c.calls - b for c, b in zip(_CORES, before))


def _state_close(got, want, msg=""):
    """A state leaf to 1e-4 of the larger of 1 and its magnitude (the big
    tail's accumulator reaches ~1e2)."""
    scale = max(1.0, float(np.abs(np.asarray(want)).max()) if np.asarray(want).size else 1.0)
    _close(got, want, STATE_TOL * scale, msg)


def _uni_close(got: tuni.UniformState, want: tuni.UniformState, msg=""):
    for f in ("segments", "pre_multiplied", "overlap", "input_buffer"):
        _state_close(getattr(got, f), getattr(want, f), f"{msg} {f}")
    for f in ("current", "input_fill", "active_segs"):
        assert getattr(got, f) == getattr(want, f), f"{msg} {f}"


def _two_close(got: ttwo.TwoStageState, want: ttwo.TwoStageState, msg=""):
    for stage in ("head", "tail0", "tail"):
        _uni_close(getattr(got, stage), getattr(want, stage), f"{msg} {stage}")
    for f in ttwo._BUFFERS:
        _state_close(getattr(got, f), getattr(want, f), f"{msg} {f}")
    assert (got.tail_fill, got.precalc_pos) == (want.tail_fill, want.precalc_pos)


def _chrono_close(got: tuple, jpair, msg=""):
    hist, pos = interop.chrono(jpair)
    assert got[1] == pos, f"{msg} pos {got[1]} != {pos}"
    _state_close(got[0], hist, f"{msg} hist")


def _golden(sig, ir):
    return scipy.signal.fftconvolve(sig.astype(np.float64), ir.astype(np.float64))[:len(sig)]


def _jax_chrono_run(cfg, state, chunks, h_cap, kern_hat_for=None):
    """The JAX test's helper (``tests/test_chrono.py:23``), stopping before
    the conversion back: ``(state, (hist, pos), y, pos after each call)``."""
    state, hist, pos = juni.ring_to_chrono(cfg, state, h_cap)
    pos_host, seen, ys = cfg.seg_count - 1, [], []
    for blocks in chunks:
        t = blocks.shape[0]
        if not juni.chrono_fits(cfg, h_cap, pos_host, t):
            hist, pos = juni.chrono_compact(cfg, hist, pos)
            pos_host = cfg.seg_count - 1
        kh = kern_hat_for(t) if kern_hat_for is not None else None
        state, hist, pos, y = juni.stream_conv_chrono_unguarded(
            cfg, state, hist, pos, jnp.asarray(blocks), kern_hat=kh)
        pos_host += t
        seen.append(pos_host)
        ys.append(np.asarray(y))
    return state, (hist, pos), np.concatenate(ys), seen


def _chrono_run(cfg, state, chunks, h_cap, kern_hat_for=None):
    """The same helper on the port, in place: ``((hist, pos), y, pos after
    each call)``; the state stays in the CHRONO convention."""
    hist, pos = tuni.ring_to_chrono(cfg, state, h_cap)
    seen, ys = [], []
    before = tuni.stream_conv_chrono.calls
    for blocks in chunks:
        t = blocks.shape[0]
        if not tuni.chrono_fits(cfg, h_cap, pos, t):
            pos = tuni.chrono_compact(cfg, hist, pos)
        kh = kern_hat_for(t) if kern_hat_for is not None else None
        ys.append(tuni.stream_conv_chrono(cfg, state, hist, pos, _x(blocks), kh))
        pos += t
        seen.append(pos)
    assert tuni.stream_conv_chrono.calls - before == len(chunks)
    return (hist, pos), torch.cat(ys), seen


def test_chrono_core_matches_ring_stream():
    """Multi-call CHRONO streaming equals the port's ring stream and the JAX
    CHRONO core, ``(hist, pos)`` included; the ring rebuilt from it equals
    the JAX package's and continues on the block loop as the JAX scan does
    (``tests/test_chrono.py:44``)."""
    rng = np.random.default_rng(50)
    ir = rng.standard_normal(3000).astype(np.float32) * 0.1
    jcfg, js0 = juni.init(ir, 64, len(ir))
    cfg = tuni.make_config(64, len(ir))
    lens = [8, 3, 17, 1, 12]
    chunks = [rng.standard_normal((t, 64)).astype(np.float32) for t in lens]
    h_cap = tuni.chrono_capacity(cfg, max(lens))
    assert h_cap == juni.chrono_capacity(jcfg, max(lens))

    s_ring = interop.uniform_state(js0)
    y_ring = torch.cat([tuni.process_stream(cfg, s_ring, _x(c)) for c in chunks])
    js_chr, jpair, y_jax, _ = _jax_chrono_run(jcfg, js0, chunks, h_cap)
    s_chr = interop.uniform_state(js0)
    pair, y_chr, _ = _chrono_run(cfg, s_chr, chunks, h_cap)
    assert s_chr.segments.shape == (1, cfg.bins)  # the placeholder while in CHRONO
    _close(y_chr, y_ring, OUT_TOL, "vs the ring stream")
    _close(y_chr, y_jax, OUT_TOL, "vs the JAX CHRONO core")
    _chrono_close(pair, jpair)

    tuni.chrono_to_ring(cfg, s_chr, *pair)
    _uni_close(s_chr, interop.uniform_state(juni.chrono_to_ring(jcfg, js_chr, *jpair)),
               "rebuilt ring vs JAX")
    _uni_close(s_chr, interop.uniform_state(juni.chrono_to_ring(
        jcfg, js_chr, *interop.chrono_to_jax(*pair))), "the port's pair rebuilt by JAX")
    tail = rng.standard_normal((cfg.seg_count + 3, 64)).astype(np.float32)
    _, y_cont = jax.jit(functools.partial(juni.process_stream_scan, jcfg))(
        jax.jit(functools.partial(juni.process_stream, jcfg))(js0, jnp.asarray(
            np.concatenate(chunks)))[0], jnp.asarray(tail))
    _close(torch.stack([tuni.process_block(cfg, s_chr, _x(xb)) for xb in tail]), y_cont,
           OUT_TOL, "continued on the block loop vs the JAX scan")


def test_chrono_compaction_is_transparent():
    """A buffer barely larger than one call compacts on the same calls as
    the JAX package's, and the outputs do not change
    (``tests/test_chrono.py:76``)."""
    rng = np.random.default_rng(51)
    ir = rng.standard_normal(1500).astype(np.float32) * 0.1
    jcfg, js0 = juni.init(ir, 64, len(ir))
    cfg = tuni.make_config(64, len(ir))
    n, t = cfg.seg_count, 6
    chunks = [rng.standard_normal((t, 64)).astype(np.float32) for _ in range(10)]
    s_ring = interop.uniform_state(js0)
    y_ring = torch.cat([tuni.process_stream(cfg, s_ring, _x(c)) for c in chunks])

    h_tight = tuni.next_power_of_two(max(n - 1 + t, 2 * (n - 1)))
    assert h_tight < tuni.chrono_capacity(cfg, t)  # genuinely tight
    _, jpair, y_jax, jseen = _jax_chrono_run(jcfg, js0, chunks, h_tight)
    pair, y_chr, seen = _chrono_run(cfg, interop.uniform_state(js0), chunks, h_tight)
    assert seen == jseen and min(seen) == n - 1 + t  # compacted, on the JAX calls
    _close(y_chr, y_ring, OUT_TOL, "vs the ring stream")
    _close(y_chr, y_jax, OUT_TOL, "vs the JAX CHRONO core")
    _chrono_close(pair, jpair)


def test_chrono_core_khat_served():
    """A precomputed ``stream_khat`` serves the CHRONO core bit-identically
    to its in-call kernel (``tests/test_chrono.py:100``)."""
    rng = np.random.default_rng(52)
    ir = rng.standard_normal(2000).astype(np.float32) * 0.1
    jcfg, js0 = juni.init(ir, 64, len(ir))
    cfg = tuni.make_config(64, len(ir))
    t = 9
    chunks = [rng.standard_normal((t, 64)).astype(np.float32) for _ in range(3)]
    h_cap = tuni.chrono_capacity(cfg, t)
    s_plain, s_khat = interop.uniform_state(js0), interop.uniform_state(js0)
    kh = tuni.stream_khat(cfg, s_khat, t)
    pair_p, y_plain, _ = _chrono_run(cfg, s_plain, chunks, h_cap)
    pair_k, y_khat, _ = _chrono_run(cfg, s_khat, chunks, h_cap, kern_hat_for=lambda _: kh)
    assert torch.equal(y_khat, y_plain) and torch.equal(pair_k[0], pair_p[0])
    _, _, y_jax, _ = _jax_chrono_run(jcfg, js0, chunks, h_cap)
    _close(y_khat, y_jax, OUT_TOL, "vs the JAX CHRONO core")


def test_two_stage_chrono_aligned_matches_scan():
    """The aligned path with a CHRONO big tail equals the JAX sequential
    scan and the JAX aligned CHRONO path over four calls, ``(hist, pos)``
    and exit state included; ``tail_from_chrono`` hands back a state the
    block loop continues as the JAX scan does (``tests/test_chrono.py:117``)."""
    rng = np.random.default_rng(53)
    ir = rng.standard_normal(60000).astype(np.float32) * 0.02
    jcfg, js0 = jtwo.init(ir, 64, len(ir))
    cfg, _ = ttwo.init(ir, 64, len(ir))
    assert cfg.tail is not None and cfg.tail.seg_count > 1
    p = cfg.period
    qs = [2, 1, 4, 3]
    chunks = [rng.standard_normal((q * p, 64)).astype(np.float32) for q in qs]
    scan = jax.jit(functools.partial(jtwo.process_stream, jcfg))
    s_ref, y_ref = js0, []
    for c in chunks:
        s_ref, y = scan(s_ref, jnp.asarray(c))
        y_ref.append(np.asarray(y))

    h_cap = tuni.chrono_capacity(cfg.tail, max(qs))
    js, jchrono = jax.jit(functools.partial(jtwo.tail_to_chrono, jcfg, h_cap=h_cap))(js0)
    khats_fn = jax.jit(functools.partial(jtwo.stream_khats, jcfg), static_argnums=(1, 2))
    run = jax.jit(functools.partial(jtwo.process_stream_aligned, jcfg))
    st = interop.two_stage_state(js0)
    hist, pos = ttwo.tail_to_chrono(cfg, st, h_cap)
    for i, c in enumerate(chunks):
        js, jchrono, yj = run(js, jnp.asarray(c), khats=khats_fn(js, c.shape[0], True),
                              tail_chrono=jchrono)
        y, calls = _core_calls(lambda: ttwo.process_stream_aligned(
            cfg, st, _x(c), ttwo.stream_khats(cfg, st, c.shape[0], want_tail=True),
            tail_chrono=(hist, pos)))
        pos += qs[i]
        assert calls == (0, 1, 1)
        _close(y, y_ref[i], OUT_TOL, f"call {i} vs the JAX scan")
        _close(y, yj, OUT_TOL, f"call {i} vs the JAX CHRONO path")
        _chrono_close((hist, pos), jchrono, f"call {i}")

    ttwo.tail_from_chrono(cfg, st, (hist, pos))
    _two_close(st, interop.two_stage_state(
        jax.jit(functools.partial(jtwo.tail_from_chrono, jcfg))(js, jchrono)), "rebuilt")
    tail = rng.standard_normal((p + 5, 64)).astype(np.float32)
    _, y_cont = scan(s_ref, jnp.asarray(tail))
    _close(torch.stack([ttwo.process_block(cfg, st, _x(xb)) for xb in tail]), y_cont,
           OUT_TOL, "continued on the block loop vs the JAX scan")


def test_wrapper_chrono_routing_and_interleaving():
    """The wrapper enters CHRONO on aligned calls and leaves it for ragged
    pieces; the interleaved stream equals the JAX wrapper's and a float64
    convolution (``tests/test_chrono.py:163``)."""
    rng = np.random.default_rng(54)
    ir = rng.standard_normal(50000).astype(np.float32) * 0.02
    sig = rng.standard_normal(400000).astype(np.float32) * 0.3
    ours = T.TwoStageFFTConvolver(ir, 64, len(ir), device="cpu")
    theirs = J.TwoStageFFTConvolver(ir, 64, len(ir))
    tb = ours.cfg.tail_block
    cuts = [2 * tb, 5 * tb, 5 * tb + 777, len(sig)]
    # aligned, aligned, a ragged piece (sub-block path), the rest (sub-block)
    want_calls = [(0, 1, 1), (0, 1, 1), (0, 0, 0), (0, 0, 0)]
    out, lo = [], 0
    for hi, want in zip(cuts, want_calls):
        y, calls = _core_calls(lambda: ours.process(sig[lo:hi]))
        assert calls == want, (lo, hi)
        _close(y, theirs.process(sig[lo:hi]), OUT_TOL, f"samples [{lo}, {hi}) vs JAX")
        if lo == 0:
            assert ours._tail_chrono is not None
            _chrono_close((ours._tail_chrono, ours._tail_pos), theirs._tail_chrono)
        out.append(y.numpy())
        lo = hi
    assert ours._tail_chrono is None  # the ragged piece converted back
    g = _golden(sig, ir)
    assert np.abs(np.concatenate(out) - g).max() / np.abs(g).max() < 1e-5


def test_wrapper_chrono_many_calls_compaction():
    """Aligned calls across the history's capacity several times: the port
    compacts on the JAX wrapper's calls, and its output and ``(hist, pos)``
    equal the JAX wrapper's (``tests/test_chrono.py:190``)."""
    rng = np.random.default_rng(55)
    ir = rng.standard_normal(30000).astype(np.float32) * 0.02
    ours = T.TwoStageFFTConvolver(ir, 64, len(ir), device="cpu")
    theirs = J.TwoStageFFTConvolver(ir, 64, len(ir))
    tb = ours.cfg.tail_block
    n_t = ours.cfg.tail.seg_count
    h_cap = ours._chrono_h_cap
    assert h_cap == theirs._chrono_h_cap
    q = 4
    calls = (h_cap - (n_t - 1)) // q + 3  # crosses the capacity at least once
    sig = rng.standard_normal(calls * q * tb).astype(np.float32) * 0.3
    out, compactions = [], 0
    for i in range(calls):
        xi = sig[i * q * tb:(i + 1) * q * tb]
        y, counts = _core_calls(lambda: ours.process(xi))
        assert counts == (0, 1, 1)
        _close(y, theirs.process(xi), OUT_TOL, f"call {i} vs JAX")
        assert ours._tail_pos == theirs._tail_pos <= h_cap
        compactions += ours._tail_pos == n_t - 1 + q
        out.append(y.numpy())
    assert compactions >= 2  # entry, then at least one compaction
    _chrono_close((ours._tail_chrono, ours._tail_pos), theirs._tail_chrono)
    g = _golden(sig, ir)
    assert np.abs(np.concatenate(out) - g).max() / np.abs(g).max() < 1e-5


def test_wrapper_chrono_update_reset_snapshot_clone():
    """The lifecycle operations convert the big tail back to its ring: a
    full-length ``update_extension`` re-enters CHRONO, a shorter one keeps
    the ring paths (the reference's shrink semantics); ``snapshot``,
    ``restore``, ``clone`` and ``reset`` behave across the boundary.  Every
    output and snapshot state against the JAX wrapper's
    (``tests/test_chrono.py:212``)."""
    rng = np.random.default_rng(56)
    cap = 40000
    ir = rng.standard_normal(cap).astype(np.float32) * 0.02
    ir2 = rng.standard_normal(cap).astype(np.float32) * 0.02
    ours = T.TwoStageFFTConvolver(ir, 64, cap, device="cpu")
    theirs = J.TwoStageFFTConvolver(ir, 64, cap)
    tb = ours.cfg.tail_block
    sig = rng.standard_normal(6 * tb).astype(np.float32) * 0.3

    def both(fn, what):
        y, y_jax = fn(ours), fn(theirs)
        if y is not None:
            _close(y, y_jax, OUT_TOL, what)
        return y

    both(lambda c: c.process(sig[:2 * tb]), "first call")
    assert ours._tail_chrono is not None
    _chrono_close((ours._tail_chrono, ours._tail_pos), theirs._tail_chrono, "mid-CHRONO")
    snap, jsnap = ours.snapshot(), theirs.snapshot()  # the ring convention
    assert ours._tail_chrono is None and ours.state.tail.segments.shape[0] > 1
    _two_close(snap[0], interop.two_stage_state(jsnap[0]), "snapshot")

    both(lambda c: c.process(sig[2 * tb:4 * tb]), "CHRONO again")
    ours.restore(snap)
    theirs.restore(jsnap)
    assert ours._tail_chrono is None
    y_a = both(lambda c: c.process(sig[2 * tb:4 * tb]), "after restore")

    ours.restore(snap)
    other = ours.clone()
    _close(other.process(sig[2 * tb:4 * tb]), y_a, 1e-6, "clone")

    # a full-length update: CHRONO afterwards
    ours.restore(snap)
    theirs.restore(jsnap)
    both(lambda c: c.update_extension(ir2), "")
    assert ours._tail_full
    both(lambda c: c.process(sig[2 * tb:4 * tb]), "after a full update")
    assert ours._tail_chrono is not None

    # a shorter update shrinks the tail's active count: the ring from then on
    short = ir2[:cap - 2 * tb]
    both(lambda c: c.update_extension(short), "")
    assert not ours._tail_full
    _, calls = _core_calls(lambda: both(lambda c: c.process(sig[4 * tb:6 * tb]),
                                        "after a shrinking update"))
    assert ours._tail_chrono is None and calls[2] == 0

    both(lambda c: c.reset(), "")
    y_r = both(lambda c: c.process(sig[:2 * tb]), "after reset")
    fresh = T.TwoStageFFTConvolver(short, 64, cap, device="cpu")
    _close(fresh.process(sig[:2 * tb]), y_r, OUT_TOL, "after reset vs a fresh engine")


def test_wrapper_chrono_vs_forced_ring_outputs():
    """The same stream through the wrapper with CHRONO and with it forced
    off (``_chrono_h_cap = 0``) agrees, and each equals the JAX wrapper in
    the same mode (``tests/test_chrono.py:262``)."""
    rng = np.random.default_rng(57)
    ir = rng.standard_normal(45000).astype(np.float32) * 0.02
    a = T.TwoStageFFTConvolver(ir, 64, len(ir), device="cpu")
    b = T.TwoStageFFTConvolver(ir, 64, len(ir), device="cpu")
    ja, jb = J.TwoStageFFTConvolver(ir, 64, len(ir)), J.TwoStageFFTConvolver(ir, 64, len(ir))
    b._chrono_h_cap = jb._chrono_h_cap = 0  # force the ring paths
    tb = a.cfg.tail_block
    sig = rng.standard_normal(7 * tb).astype(np.float32) * 0.3
    for lo, hi in [(0, 2 * tb), (2 * tb, 3 * tb), (3 * tb, 7 * tb)]:
        ya, calls_a = _core_calls(lambda: a.process(sig[lo:hi]))
        yb, calls_b = _core_calls(lambda: b.process(sig[lo:hi]))
        assert calls_a[2] == 1 and calls_b[2] == 0
        _close(ya, ja.process(sig[lo:hi]), OUT_TOL, "CHRONO vs JAX")
        _close(yb, jb.process(sig[lo:hi]), OUT_TOL, "ring vs JAX")
        _close(ya, yb, OUT_TOL, "CHRONO vs ring")
    assert a._tail_chrono is not None and b._tail_chrono is None
