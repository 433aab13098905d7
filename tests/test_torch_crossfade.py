"""The port's crossfade slice on the CPU: ``models.crossfade``, the generic
``CrossfadeConvolver``, the plain version of kernel B3 and
``CudaCrossfadeConvolver``, held against the JAX package (its crossfader,
its generic wrapper and its Pallas A/B kernel and wrapper in interpret mode)
on the same numpy-seeded inputs.  Ports ``tests/test_crossfade.py`` and
``tests/test_pallas_crossfade.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_convolution_tpu import CrossfadeConvolver as JCrossfadeConvolver
from fft_convolution_tpu import FFTConvolver as JFFTConvolver
from fft_convolution_tpu.models import crossfade as jcf
from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu.ops import pallas_crossfade
from fft_convolution_tpu.serving import PallasCrossfadeConvolver
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.api import FFTConvolver
from fft_convolution_tpu_torch.api_crossfade import CrossfadeConvolver
from fft_convolution_tpu_torch.api_two_stage import TwoStageFFTConvolver
from fft_convolution_tpu_torch.models import crossfade
from fft_convolution_tpu_torch.ops import cuda_crossfade
from fft_convolution_tpu_torch.ops.fft import generate_sinusoid
from fft_convolution_tpu_torch.serving import CudaCrossfadeConvolver, CudaFFTConvolver

SAMPLE_RATE = 44100.0
# The crossfader alone: the same float32 ramp, cos/sin of two libraries;
# the reference's own mixer contract is 1e-6 (src/crossfade_convolver.rs:281-316).
MIX_ATOL = 1e-6
# Convolver against convolver: the JAX package's engine-vs-engine 1e-5
# (its basis-matmul DFTs against pocketfft), and its serving-wrapper 2e-5.
ENGINE_ATOL = 1e-5
SLICE_ATOL = 2e-5


def _scaled(got, want, atol, msg=""):
    """``atol`` at outputs of magnitude up to 1, relative above: float32
    rounding grows with the magnitude (the sinusoid tests reach ~100)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _mk(rng, n):
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


# ---- models.crossfade ------------------------------------------------------

def test_crossfader_state_machine():
    """Hold phase, ramp, exact endpoint snap, both directions
    (``src/crossfade_convolver.rs:281-316``), sample by sample, with the
    port's state equal to the JAX package's after every sample."""
    hold = fading = 4
    cfg = crossfade.CrossfaderConfig(fading_samples=fading, hold_samples=hold)
    jcfg = jcf.CrossfaderConfig(fading_samples=fading, hold_samples=hold)
    st, jst = crossfade.new_state(cfg), jcf.new_state(jcfg)
    sample_a, sample_b = 1.0, 10.0
    for target in (crossfade.TARGET_B, crossfade.TARGET_A):
        start = sample_b if target == crossfade.TARGET_A else sample_a
        end = sample_a if target == crossfade.TARGET_A else sample_b
        st, jst = crossfade.fade_into(cfg, st, target), jcf.fade_into(jcfg, jst, target)
        for i in range(hold + fading):
            st, y = crossfade.mix_block(cfg, st, torch.full((1,), sample_a),
                                        torch.full((1,), sample_b))
            jst, jy = jcf.mix_block(jcfg, jst, np.full(1, sample_a, np.float32),
                                    np.full(1, sample_b, np.float32))
            v = float(y[0])
            assert abs(v - float(jy[0])) <= MIX_ATOL
            assert st == interop.crossfader_state(jst)
            if i < hold:
                assert st.approaching and v == start
            elif i < hold + fading - 1:
                assert st.approaching and v not in (start, end)
            else:
                assert v == end and not st.approaching


def test_crossfader_blockwise_equals_samplewise():
    """The closed form matches per-sample stepping across block boundaries
    (mid-hold and mid-ramp splits), and the JAX package block for block."""
    cfg = crossfade.CrossfaderConfig(fading_samples=512, hold_samples=300)
    jcfg = jcf.CrossfaderConfig(fading_samples=512, hold_samples=300)
    rng = np.random.default_rng(9)
    a = rng.standard_normal(2048).astype(np.float32)
    b = rng.standard_normal(2048).astype(np.float32)

    st1 = crossfade.fade_into(cfg, crossfade.new_state(cfg), crossfade.TARGET_B)
    ys = []
    for i in range(2048):
        st1, y = crossfade.mix_block(cfg, st1, _t(a[i:i + 1]), _t(b[i:i + 1]))
        ys.append(float(y[0]))

    st2 = crossfade.fade_into(cfg, crossfade.new_state(cfg), crossfade.TARGET_B)
    jst = jcf.fade_into(jcfg, jcf.new_state(jcfg), jcf.TARGET_B)
    pieces, pos = [], 0
    for size in (7, 250, 100, 470, 64, 512, 645):
        st2, y = crossfade.mix_block(cfg, st2, _t(a[pos:pos + size]), _t(b[pos:pos + size]))
        jst, jy = jcf.mix_block(jcfg, jst, a[pos:pos + size], b[pos:pos + size])
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MIX_ATOL)
        assert st2 == interop.crossfader_state(jst)
        pieces.append(y.numpy())
        pos += size
    np.testing.assert_allclose(np.concatenate(pieces), np.asarray(ys, np.float32),
                               atol=MIX_ATOL)
    assert st1 == st2


@pytest.mark.parametrize("mixer,v,expected", [
    ("linear", 0.25, 1.0 * 0.75 + 10.0 * 0.25),
    ("sqrt", 0.25, np.sqrt(0.75) + 10.0 * np.sqrt(0.25)),
    ("cosine", 0.5, np.cos(np.pi / 4) + 10.0 * np.sin(np.pi / 4)),
    ("raised_cosine", 0.5, 0.5 + 10.0 * 0.5),
])
def test_alternative_mixers(mixer, v, expected):
    """Linear / sqrt / cosine mixers (dead code upstream, ``:130-158``)
    give the documented gains, as the JAX package's do."""
    cfg = crossfade.CrossfaderConfig(4, 0, mixer=mixer)
    st = crossfade.new_state(cfg)._replace(approaching=True, counter=0,
                                           mix_value=np.float32(v - 0.25))
    _, y = crossfade.mix_block(cfg, st, torch.ones(1), torch.full((1,), 10.0))
    jcfg = jcf.CrossfaderConfig(4, 0, mixer=mixer)
    jst = jcf.new_state(jcfg)._replace(approaching=np.asarray(True),
                                      counter=np.asarray(0, np.int32),
                                      mix_value=np.asarray(v - 0.25, np.float32))
    _, jy = jcf.mix_block(jcfg, jst, np.ones(1, np.float32), np.full(1, 10.0, np.float32))
    np.testing.assert_allclose(float(y[0]), expected, atol=MIX_ATOL)
    np.testing.assert_allclose(float(y[0]), float(jy[0]), atol=MIX_ATOL)


def test_zero_fade_length_clamps_to_instant_switch():
    """fading_samples == 0 (a zero-length response) clamps to a 1-sample
    fade; an unknown mixer is refused."""
    cfg = crossfade.CrossfaderConfig(fading_samples=0, hold_samples=0)
    assert cfg.fading_samples == 1
    assert np.isfinite(crossfade.new_state(cfg).step)
    with pytest.raises(ValueError, match="mixer"):
        crossfade.CrossfaderConfig(4, 0, mixer="exp")


# ---- api_crossfade.CrossfadeConvolver ---------------------------------------

def test_passthrough():
    """(``src/crossfade_convolver.rs:107-124``)"""
    response = np.zeros(1024, np.float32)
    response[0] = 1.0
    convolver = CrossfadeConvolver(FFTConvolver(response, 1024, 1024, device="cpu"),
                                   1024, 1024, 1024)
    np.testing.assert_allclose(convolver.process(np.ones(1024, np.float32)).numpy(), 1.0,
                               atol=1e-6)


def test_crossfade_convolver():
    """Old IR before the update; 50/50 mix at the crossover sample; new IR
    after the fade (``src/tests.rs:61-117``); and the JAX package's
    generic wrapper block for block."""
    block_size = 512
    response_a = generate_sinusoid(block_size, 1000.0, SAMPLE_RATE, 1.0)
    response_b = generate_sinusoid(block_size, 2000.0, SAMPLE_RATE, 0.7)
    convolver_a = FFTConvolver(response_a, block_size, len(response_a), device="cpu")
    convolver_b = FFTConvolver(response_b, block_size, len(response_b), device="cpu")
    cc = CrossfadeConvolver(convolver_a.clone(), block_size, block_size, block_size)
    jcc = JCrossfadeConvolver(JFFTConvolver(response_a, block_size, len(response_a)),
                              block_size, block_size, block_size)
    x = generate_sinusoid(16 * block_size, 1300.0, SAMPLE_RATE, 1.0)
    update_index = 8
    for i in range(16):
        if i == update_index:
            cc.update(response_b)
            jcc.update(response_b)
        chunk = x[i * block_size:(i + 1) * block_size]
        out_cc = cc.process(chunk).numpy()
        _scaled(out_cc, jcc.process(chunk), ENGINE_ATOL, f"block {i}")
        out_a = convolver_a.process(chunk).numpy()
        if i >= update_index:
            out_b = convolver_b.process(chunk).numpy()
        if i <= update_index:
            np.testing.assert_allclose(out_a, out_cc, atol=1e-6)
        elif i == update_index + 1:
            c = block_size // 2 - 1
            assert abs(out_cc[c] - (out_a[c] * 0.5 + out_b[c] * 0.5)) < 1e-6
        else:
            np.testing.assert_allclose(out_b, out_cc, atol=1e-6)


def test_pending_response_slot():
    """An update during a fade waits for its end; later updates overwrite
    the single pending slot (``src/crossfade_convolver.rs:51-64``)."""
    b = 128
    ra, rb, rc = (np.zeros(b, np.float32) for _ in range(3))
    ra[0], rb[0], rc[0] = 1.0, 0.5, 0.25
    cc = CrossfadeConvolver(FFTConvolver(ra, b, b, device="cpu"), b, b, b)
    jcc = JCrossfadeConvolver(JFFTConvolver(ra, b, b), b, b, b)
    x = np.ones(b, np.float32)
    for conv in (cc, jcc):
        conv.update(rb)              # starts the fade A -> B
        assert conv.is_crossfading()
        conv.update(rc)              # mid-fade: pending slot
        assert conv.response_pending
    for _ in range(2):               # hold + ramp span 2 blocks
        np.testing.assert_allclose(cc.process(x).numpy(), jcc.process(x), atol=1e-6)
    assert not cc.is_crossfading()
    for _ in range(5):               # the pending swap applies at block top
        y = cc.process(x).numpy()
        np.testing.assert_allclose(y, jcc.process(x), atol=1e-6)
    np.testing.assert_allclose(y, 0.25, atol=1e-6)
    cc.update(rb)  # starts a fade
    with pytest.raises(ValueError):
        cc.update(np.ones(b + 1, np.float32))  # mid-fade, longer than the stored capacity


def test_reset_unimplemented_and_extension():
    """Surface parity (``src/crossfade_convolver.rs:80-82``); the extension
    returns to a power-on state."""
    rng = np.random.default_rng(52)
    ir = _mk(rng, 256)
    x = rng.standard_normal(64 * 4).astype(np.float32)
    cc = CrossfadeConvolver(FFTConvolver(ir, 64, 256, device="cpu"), 256, 64, 128)
    with pytest.raises(NotImplementedError):
        cc.reset()
    y1 = cc.process(x)
    cc.update(_mk(rng, 256))
    cc.update(_mk(rng, 256))
    cc.reset_extension()
    assert not cc.is_crossfading() and not cc.response_pending
    cc.convolver_b.update(ir)  # both engines on the init IR again
    np.testing.assert_array_equal(cc.process(x).numpy(), y1.numpy())


def test_ragged_sizes_match_aligned():
    """Ragged process() sizes agree with block-aligned calls, and with the
    JAX package's fused aligned path."""
    rng = np.random.default_rng(50)
    ir = _mk(rng, 400)
    x = rng.standard_normal(128 * 12).astype(np.float32)

    def make():
        return CrossfadeConvolver(FFTConvolver(ir, 128, 400, device="cpu"), 400, 128, 300)

    jcc = JCrossfadeConvolver(JFFTConvolver(ir, 128, 400), 400, 128, 300)
    aligned = make()
    y_aligned = [aligned.process(x[i * 256:(i + 1) * 256]).numpy() for i in range(6)]
    y_jax = [jcc.process(x[i * 256:(i + 1) * 256]) for i in range(6)]
    np.testing.assert_allclose(np.concatenate(y_aligned), np.concatenate(y_jax),
                               atol=ENGINE_ATOL)
    ragged = make()
    sizes = [100, 156, 256, 200, 56, 256, 128, 128, 256]
    pieces, pos = [], 0
    for s in sizes:
        pieces.append(ragged.process(x[pos:pos + s]).numpy())
        pos += s
    np.testing.assert_allclose(np.concatenate(pieces), np.concatenate(y_aligned),
                               atol=ENGINE_ATOL)


def test_two_stage_inner_engine():
    """Generic over the engine (``CrossfadeConvolver<T>``): a two-stage
    inner processes, and update surfaces the inner NotImplementedError as
    the generic would hit the upstream todo!()."""
    response = np.zeros(1024, np.float32)
    response[0] = 1.0
    cc = CrossfadeConvolver(TwoStageFFTConvolver(response, 128, 1024, device="cpu"), 1024, 128, 256)
    np.testing.assert_allclose(cc.process(np.ones(128, np.float32)).numpy(), 1.0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        cc.update(response)


def test_clone_independent():
    """clone() is a value copy (the reference derives Clone)."""
    rng = np.random.default_rng(51)
    ir = _mk(rng, 256)
    x = rng.standard_normal(64 * 4).astype(np.float32)
    cc = CrossfadeConvolver(FFTConvolver(ir, 64, 256, device="cpu"), 256, 64, 128)
    cc.process(x[:128])
    twin = cc.clone()
    y1 = cc.process(x[128:])
    twin.update(_mk(rng, 100))
    y_twin = twin.process(x[128:])
    cc2 = CrossfadeConvolver(FFTConvolver(ir, 64, 256, device="cpu"), 256, 64, 128)
    cc2.process(x[:128])
    np.testing.assert_array_equal(y1.numpy(), cc2.process(x[128:]).numpy())
    assert (y_twin - y1).abs().max() > 0


def test_init_quirk_and_serving_engines():
    """``init`` takes the fade length and the stored capacity from the
    response's length (``src/crossfade_convolver.rs:46-49``); the generic
    wrapper over two CudaFFTConvolver serving engines gives what
    CudaCrossfadeConvolver gives, update and pending slot included."""
    rng = np.random.default_rng(54)
    b = 64
    ir, ir2, ir3 = (_mk(rng, b * 4) for _ in range(3))
    cc = CrossfadeConvolver.init(functools.partial(CudaFFTConvolver, device="cpu"), ir[:b * 3],
                                 b, b * 4)
    assert cc.cf_cfg.fading_samples == b * 3 and cc.stored_response.shape[0] == b * 3
    assert cc.cf_cfg.hold_samples == b
    gen = CrossfadeConvolver(CudaFFTConvolver(ir, b, len(ir), device="cpu"), len(ir), b, 2 * b)
    fused = CudaCrossfadeConvolver(ir, b, len(ir), crossfade_samples=2 * b, device="cpu")
    x = rng.standard_normal(b * 16).astype(np.float32)
    for t in range(16):
        if t in (3, 4):  # the second lands mid-fade: pending
            gen.update(ir2 if t == 3 else ir3)
            fused.update(ir2 if t == 3 else ir3)
        blk = x[t * b:(t + 1) * b]
        np.testing.assert_allclose(fused.process(blk).numpy(), gen.process(blk).numpy(),
                                   atol=ENGINE_ATOL, err_msg=f"block {t}")
    assert not fused.is_crossfading() and fused.cf_state.target == crossfade.TARGET_A


# ---- kernel B3 and CudaCrossfadeConvolver -----------------------------------

def test_b3_plain_matches_pallas_from_carried_state():
    """Kernel B3's plain version from a state the Pallas A/B kernel reached
    mid-stream (interpret mode), with the crossfader carried too: each
    mixed block equals the JAX kernel's ya/yb mixed by the JAX crossfader."""
    rng = np.random.default_rng(55)
    b = 64
    ir_a, ir_b = _mk(rng, b * 6), _mk(rng, b * 6)
    cfg, sa = juni.init(ir_a, b, len(ir_a))
    _, sb = juni.init(ir_b, b, len(ir_b))
    jconsts, jp = pallas_crossfade.from_uniform(cfg, sa, sb)
    jconsts = jconsts._replace(b2_re=jnp.concatenate([sb.segments_ir[:, 0]] * 2),
                               b2_im=jnp.concatenate([sb.segments_ir[:, 1]] * 2))
    for _ in range(4):  # mid-stream: current = 2
        jp, _, _ = pallas_crossfade.block_step(
            cfg, jconsts, jp, jnp.asarray(rng.standard_normal(b).astype(np.float32)),
            interpret=True)
    jcfg = jcf.CrossfaderConfig(fading_samples=3 * b, hold_samples=b // 2, mixer="cosine")
    jst = jcf.fade_into(jcfg, jcf.new_state(jcfg), jcf.TARGET_B)
    consts, st = interop.xfade(jconsts, jp)
    cf_cfg = crossfade.CrossfaderConfig(3 * b, b // 2, mixer="cosine")
    cf = interop.crossfader_state(jst)
    assert st.current == int(jp.current[0]) == 2
    for t in range(9):  # through the ring's wrap and the whole fade
        x = rng.standard_normal(b).astype(np.float32)
        jp, ya, yb = pallas_crossfade.block_step(cfg, jconsts, jp, jnp.asarray(x),
                                                 interpret=True)
        jst, jy = jcf.mix_block(jcfg, jst, ya, yb)
        cf, y = cuda_crossfade.block_step(consts, st, cf_cfg, cf, _t(x))  # CPU: plain
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ENGINE_ATOL,
                                   err_msg=f"block {t}")
        assert cf == interop.crossfader_state(jst)
        assert st.current == int(jp.current[0])
    assert not cf.approaching
    np.testing.assert_allclose(st.overlap_b.numpy(), np.asarray(jp.overlap_b)[0],
                               atol=ENGINE_ATOL)


def test_crossfade_serving_matches_pallas():
    """CudaCrossfadeConvolver on the CPU against PallasCrossfadeConvolver in
    interpret mode, block by block: steady state, a live update (hold and
    ramp across block boundaries), a mid-fade pending update and the
    steady state after it (as tests/test_pallas_crossfade.py holds the JAX
    wrapper against the generic one)."""
    rng = np.random.default_rng(51)
    b = 128
    max_len = b * 6
    fade = 3 * b
    ir1 = np.pad(_mk(rng, b * 4), (0, max_len - b * 4))
    ir2 = np.pad(_mk(rng, b * 3), (0, max_len - b * 3))
    ir3 = _mk(rng, b * 5)  # shorter than max_len: padded by the wrappers
    x = rng.standard_normal(b * 24).astype(np.float32)
    ref = PallasCrossfadeConvolver(ir1, b, max_len, crossfade_samples=fade, interpret=True)
    conv = CudaCrossfadeConvolver(ir1, b, max_len, crossfade_samples=fade, device="cpu")

    def run(lo, hi, tag):
        for t in range(lo, hi):
            blk = x[t * b:(t + 1) * b]
            np.testing.assert_allclose(conv.process(blk).numpy(), ref.process(blk),
                                       atol=SLICE_ATOL, err_msg=f"{tag} block {t}")

    run(0, 5, "steady A")
    conv.update(ir2)
    ref.update(ir2)
    assert conv.is_crossfading() and ref.is_crossfading()
    run(5, 8, "fading")
    conv.update(ir3)
    ref.update(ir3)
    assert conv.response_pending and ref.response_pending
    run(8, 20, "pending swap + second fade")
    assert not conv.is_crossfading() and not ref.is_crossfading()
    assert conv.cf_state == interop.crossfader_state(ref.cf_state)
    run(20, 24, "steady C")


def test_crossfade_serving_contracts():
    rng = np.random.default_rng(52)
    b = 128
    ir = _mk(rng, b * 3)
    p = CudaCrossfadeConvolver(ir, b, len(ir), crossfade_samples=b, device="cpu")
    with pytest.raises(ValueError):
        p.process(np.zeros(b - 1, np.float32))
    with pytest.raises(ValueError):
        p.update(np.ones(len(ir) + 1, np.float32))
    with pytest.raises(NotImplementedError):
        p.reset()  # todo!() upstream (src/crossfade_convolver.rs:80-82)
    with pytest.raises(ValueError):
        # past the kernel's largest block
        CudaCrossfadeConvolver(ir, 4096, len(ir), crossfade_samples=b, device="cpu")
    # the TPU's VMEM ceiling is not carried: a 30 s IR builds
    big = CudaCrossfadeConvolver(np.ones(10, np.float32), 128, 48000 * 30,
                                 crossfade_samples=128, device="cpu")
    assert big.cfg.seg_count == 11250

    # clone independence + snapshot/restore repeatability
    x = rng.standard_normal(b * 6).astype(np.float32)
    for t in range(2):
        p.process(x[t * b:(t + 1) * b])
    twin = p.clone()
    snap = p.snapshot()
    twin.update(_mk(rng, b * 2))
    twin.process(x[2 * b:3 * b])
    y1 = p.process(x[2 * b:3 * b])
    p.restore(snap)
    np.testing.assert_array_equal(p.process(x[2 * b:3 * b]).numpy(), y1.numpy())
    assert not p.is_crossfading() and twin.is_crossfading()

    p.reset_extension()
    assert not p.is_crossfading()
    ya = [p.process(x[t * b:(t + 1) * b]) for t in range(3)]
    p.reset_extension()
    yb = [p.process(x[t * b:(t + 1) * b]) for t in range(3)]
    np.testing.assert_array_equal(torch.cat(ya).numpy(), torch.cat(yb).numpy())


def test_crossfade_hold_then_ramp_sample_exact():
    """During the hold the mixed output is engine A's, sample for sample;
    the next block ramps; after the fade the output is engine B's (silent)
    — ``src/crossfade_convolver.rs:242-278`` over the fused step."""
    rng = np.random.default_rng(53)
    b = 128
    ir1 = _mk(rng, b * 2)
    ir2 = np.zeros(b * 2, np.float32)  # B silent: any leak of B shows
    x = rng.standard_normal(b * 6).astype(np.float32)
    p = CudaCrossfadeConvolver(ir1, b, len(ir1), crossfade_samples=2 * b, device="cpu")
    q = CudaCrossfadeConvolver(ir1, b, len(ir1), crossfade_samples=2 * b, device="cpu")
    ref = PallasCrossfadeConvolver(ir1, b, len(ir1), crossfade_samples=2 * b, interpret=True)
    y_plain = [q.process(x[t * b:(t + 1) * b]).numpy() for t in range(6)]
    p.process(x[:b])
    ref.process(x[:b])
    p.update(ir2)
    ref.update(ir2)
    y_hold = p.process(x[b:2 * b]).numpy()
    np.testing.assert_array_equal(y_hold, y_plain[1])  # hold == block_size: pure A
    np.testing.assert_allclose(y_hold, ref.process(x[b:2 * b]), atol=SLICE_ATOL)
    y_ramp = p.process(x[2 * b:3 * b]).numpy()
    assert np.abs(y_ramp - y_plain[2]).max() > 1e-4
    np.testing.assert_allclose(y_ramp, ref.process(x[2 * b:3 * b]), atol=SLICE_ATOL)
    for t in range(3, 6):
        y = p.process(x[t * b:(t + 1) * b]).numpy()
    assert not p.is_crossfading()
    np.testing.assert_allclose(y, np.zeros(b), atol=1e-5)
