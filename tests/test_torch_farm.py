"""The port's reverb farm on the CPU: the plain versions of kernels B5
(``phased_step_plain``) and B6 (``heads_step_plain``, and B6's launch
plan and the farm's memory model from the shapes), the block-axis causal
convolution, the voice-stacked
uniform stages, ``farm2`` and ``ReverbFarm``, held against the JAX package
(its Pallas kernel in interpret mode and its jnp core) on the same
numpy-seeded inputs, from init and from states carried by ``interop``.
Sizes are the JAX farm tests': block 64 and 9000-sample IRs, so tail block
1024, period 16 and 8 tail segments.  Ports ``tests/test_api_farm.py``,
its three mesh tests on a ``"dp"`` mesh of 2 gloo ranks (one spawn for the
three, the rank bodies in ``tests/torch_ranks.py``, which imports no JAX):
each rank's voice slab against the JAX farm's rows."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from fft_convolution_tpu import ReverbFarm as JaxReverbFarm
from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu.ops import fft as jfft
from fft_convolution_tpu.ops.packing import pack_c32_planes
from fft_convolution_tpu.ops.pallas_farm_mac import phased_step as jphased_step
from fft_convolution_tpu.parallel import farm as jfarm
from fft_convolution_tpu.parallel import farm2 as jfarm2
from fft_convolution_tpu_torch import ReverbFarm, interop
from fft_convolution_tpu_torch.api_two_stage import TwoStageFFTConvolver
from fft_convolution_tpu_torch.models import uniform
from fft_convolution_tpu_torch.ops import cuda_farm_heads, cuda_farm_mac
from fft_convolution_tpu_torch.ops import fft as tfft
from fft_convolution_tpu_torch.ops.fft import packed_to_complex
from fft_convolution_tpu_torch.parallel import farm, farm2
from fft_convolution_tpu_torch.parallel.mesh import run_ranks

V, B, IR_LEN = 3, 64, 9000
# The JAX farm's own stream tolerance (tests/test_parallel.py:215-249):
# outputs to 1e-5; pre, a sum of spectra, at f32-roundoff relative 1e-4.
ATOL = 1e-5
PRE_RTOL = 1e-4
# One step of bf16 (8 significant bits): where the port and the JAX package
# round the same float32 spectrum from two DFTs, a value a hair from a
# rounding tie may land one step apart.
BF16_STEP = 2.0 ** -7

plain = cuda_farm_mac.phased_step_plain


def _irs(rng, v=V, n=IR_LEN, scale=0.05):
    return (rng.standard_normal((v, n)) * scale).astype(np.float32)


def _fused(a, v):
    """JAX planes-outer ``[R, 2, V*B]`` rows -> complex64 ``[R, V, B+1]``."""
    a = np.asarray(a)
    return packed_to_complex(torch.from_numpy(
        np.ascontiguousarray(a.reshape(a.shape[0], 2, v, -1).transpose(0, 2, 1, 3))))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, err_msg=msg)


def _scaled(got, want, rel, msg=""):
    want = torch.as_tensor(want)
    scale = float(want.abs().max())
    err = float((torch.as_tensor(got) - want).abs().max())
    assert err <= rel * scale, f"{msg}: {err} > {rel} x {scale}"


# ---- kernel B5's plain version ------------------------------------------------

def _step_operands(rng, n, v, tb, t_len, packed):
    """JAX phased-step operands (ring, doubled table, specs; f32 planes or
    packed words) and the port's (complex64 or bf16 pairs)."""
    vb = v * tb
    u = (rng.standard_normal((2, n, vb)) * 0.1).astype(np.float32)
    k = (rng.standard_normal((2, n, vb)) * 0.1).astype(np.float32)
    ext2 = k[:, np.arange(2 * n + 16) % n]
    specs = (rng.standard_normal((t_len, 2, vb)) * 0.1).astype(np.float32)
    if packed:
        ju, jk = pack_c32_planes(jnp.asarray(u)), pack_c32_planes(jnp.asarray(ext2))
    else:
        ju, jk = jnp.asarray(u), jnp.asarray(ext2)
    ring = interop._fused_spectra(np.asarray(ju), n, v, "cpu")
    table = interop._fused_spectra(np.asarray(jk), n, v, "cpu")
    return (ju, jk, jnp.asarray(specs)), (ring, table, _fused(specs, v))


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("packed", [False, True], ids=["f32", "bf16"])
def test_phased_step_plain_matches_pallas_interpret(variant, packed):
    """phased_step_plain against the Pallas kernel (interpret mode) for
    every phase residue class and T in (1, 2, 8): both read the same stored
    values (packed words map exactly to bf16 pairs), so the sums agree to
    float32 rounding in another order."""
    rng = np.random.default_rng(60)
    n, v, tb = 16, 2, 128
    for t_len in (1, 2, 8):
        (ju, jk, jspecs), (ring0, table, specs) = _step_operands(rng, n, v, tb, t_len,
                                                                 packed)
        call = jax.jit(functools.partial(jphased_step, b_voice=tb, interpret=True,
                                         variant=variant))
        for q in (0, 1, 7, 8, 13, n - 1):
            convs, pre = call(ju, jk, jspecs, jnp.asarray(q, jnp.int32))
            ring = ring0.clone()
            got_c, got_p = plain(ring, table, specs, q)
            want_c = _fused(convs, v)
            want_p = _fused(np.asarray(pre)[None], v)[0]
            scale = float(want_c.abs().max())
            _close(got_c, want_c, 2e-6 * scale, f"convs T={t_len} q={q}")
            _close(got_p, want_p, 2e-6 * scale, f"pre T={t_len} q={q}")
            rows = [(n - q - s) % n for s in range(t_len)]
            stored = cuda_farm_mac.to_bf16(specs) if packed else specs
            assert torch.equal(ring[rows], stored)
            untouched = [r for r in range(n) if r not in rows]
            assert torch.equal(ring[untouched], ring0[untouched])


@pytest.mark.parametrize("t_len", [1, 5, 16])
@pytest.mark.parametrize("packed", [False, True], ids=["f32", "bf16"])
def test_tail_core_matches_jnp_core(t_len, packed):
    """The port's big-tail core (rDFT, plain B5 step, inverse, overlap) against
    the JAX jnp core up to its ceiling of 16 blocks, at a nonzero phase:
    outputs, pre, overlap, phase and the written ring rows."""
    rng = np.random.default_rng(61 + t_len)
    n, v, tb, q = 16, 3, 64, 11
    tcfg = juni.make_config(tb, n * tb)
    (ju, jk, _), (ring, table, _) = _step_operands(rng, n, v, tb, 1, packed)
    overlap = (rng.standard_normal((v, tb)) * 0.1).astype(np.float32)
    jstate = juni.UniformState(
        segments=ju, segments_ir=jk, overlap=jnp.asarray(overlap),
        input_buffer=jnp.zeros((v, tb)), pre_multiplied=jnp.zeros((2, v * tb)),
        current=jnp.asarray(q, jnp.int32), input_fill=jnp.asarray(0, jnp.int32),
        active_segs=jnp.asarray(n, jnp.int32))
    rows = rng.standard_normal((t_len, v, tb)).astype(np.float32)
    jst, jy = jfarm2._tail_corr_phased_fused(tcfg, jstate, jnp.asarray(rows), mac="jnp")
    tail = farm2.TailState(ring=ring, table=table, overlap=torch.from_numpy(overlap),
                           pre=torch.zeros((v, tb + 1), dtype=torch.complex64), q=q)
    y = farm2._tail_corr_phased_fused(farm.uniform.make_config(tb, n * tb), tail,
                                      torch.from_numpy(rows), plain)
    _close(y, jy, ATOL * max(1.0, float(np.abs(np.asarray(jy)).max())), "y")
    _close(tail.overlap, jst.overlap, 1e-5, "overlap")
    assert tail.q == int(jst.current) == (q + t_len) % n
    want_pre = _fused(np.asarray(jst.pre_multiplied)[None], v)[0]
    np.testing.assert_allclose(tail.pre.numpy(), want_pre.numpy(), rtol=PRE_RTOL,
                               atol=PRE_RTOL * float(want_pre.abs().max()))
    want_ring = interop._fused_spectra(np.asarray(jst.segments), n, v, "cpu")
    got, want = cuda_farm_mac.as_c64(tail.ring), cuda_farm_mac.as_c64(want_ring)
    step = BF16_STEP if packed else 1e-6
    assert float((got - want).abs().max()) <= step * float(want.abs().max())


def test_phased_step_wrappers_take_plain_on_cpu():
    """On a CPU tensor the wrappers take the plain version and count no
    launch; T = N = 1 (a one-segment ring) works."""
    rng = np.random.default_rng(62)
    before = (cuda_farm_mac.phased_step.launches, cuda_farm_mac.phased_step_packed.launches)
    ring = torch.zeros((1, 2, 5), dtype=torch.complex64)
    table = torch.from_numpy(rng.standard_normal((1, 2, 5)).astype(np.complex64))
    specs = torch.from_numpy(rng.standard_normal((1, 2, 5)).astype(np.complex64))
    convs, pre = cuda_farm_mac.phased_step(ring, table, specs, 0)
    # conv[0] = 0 * K[0] + (spec - 0) * K[0]; pre = conv - spec * K[0] = 0
    _close(convs[0], specs[0] * table[0], 1e-6)
    _close(pre, torch.zeros_like(pre), 1e-6)
    assert torch.equal(ring[0], specs[0])
    cuda_farm_mac.phased_step_packed(cuda_farm_mac.to_bf16(ring), cuda_farm_mac.to_bf16(table),
                                     specs, 0)
    assert (cuda_farm_mac.phased_step.launches,
            cuda_farm_mac.phased_step_packed.launches) == before


# ---- block-axis causal convolution and the batched transforms ----------------

@pytest.mark.parametrize("m,row0", [(None, None), (64, None), (None, 3)],
                         ids=["default", "m", "row0"])
def test_causal_conv_time_matches_jax(m, row0):
    rng = np.random.default_rng(63)
    v, lt, n, b, t_out = 2, 21, 6, 16, 9
    ext = (rng.standard_normal((v, lt, 2, b)) * 0.3).astype(np.float32)
    kern = (rng.standard_normal((v, n, 2, b)) * 0.3).astype(np.float32)
    ext[:, :2] = 0.0  # zero history rows, as the suppress pass builds them
    want = jfft.causal_conv_time(jnp.asarray(ext), jnp.asarray(kern), t_out, m=m, row0=row0)
    te, tk = packed_to_complex(torch.from_numpy(ext)), packed_to_complex(torch.from_numpy(kern))
    got = tfft.causal_conv_time(te, tk, t_out, m=m, row0=row0)
    mm = m or tfft.next_power_of_two(lt)
    got_kh = tfft.causal_conv_time(te, tk, t_out, kern_hat=tfft.causal_conv_khat(tk, mm),
                                   m=m, row0=row0)
    want_c = packed_to_complex(torch.from_numpy(np.asarray(want)))
    scale = float(want_c.abs().max())
    _close(got, want_c, 2e-6 * scale)
    assert torch.equal(got, got_kh)
    with pytest.raises(ValueError, match="meta-bins"):
        tfft.causal_conv_time(te, tk, t_out, kern_hat=tfft.causal_conv_khat(tk, 2 * mm))
    with pytest.raises(ValueError, match="power of two"):
        tfft.causal_conv_time(te, tk, t_out, m=lt + 1)


def test_causal_conv_khat_matches_jax():
    """Bins 1..B-1 are the JAX lanes; JAX's lane 0 carries the DC and the
    Nyquist sequences as one complex sequence, DC + i Nyquist."""
    rng = np.random.default_rng(64)
    kern = (rng.standard_normal((3, 7, 2, 16)) * 0.3).astype(np.float32)
    kre, kim = jfft.causal_conv_khat(jnp.asarray(kern), 32)
    want = np.asarray(kre) + 1j * np.asarray(kim)
    got = tfft.causal_conv_khat(packed_to_complex(torch.from_numpy(kern)), 32).numpy()
    scale = np.abs(want).max()
    _close(got[..., 1:-1], want[..., 1:], 2e-6 * scale)
    _close(got[..., 0] + 1j * got[..., -1], want[..., 0], 2e-6 * scale)


def test_rdft_irdft_block_match_jax():
    rng = np.random.default_rng(65)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    spec = tfft.rdft_block(torch.from_numpy(x), 128)
    want = packed_to_complex(torch.from_numpy(np.asarray(jfft.rdft_block(jnp.asarray(x), 128))))
    _close(spec, want, 2e-5)
    packed = np.asarray(jfft.rdft_block(jnp.asarray(x), 128))
    back = jfft.irdft_pair(jnp.asarray(packed[..., 0, :]), jnp.asarray(packed[..., 1, :]), 128)
    _close(tfft.irdft_block(spec, 128), back, 1e-5)
    _close(tfft.irdft_block(spec, 128), jfft.irdft_block(jnp.asarray(packed), 128), 1e-5)
    with pytest.raises(ValueError):
        tfft.rdft_block(torch.zeros(129), 128)


# ---- voice-stacked uniform stages ----------------------------------------------

def test_farm_stages_match_jax():
    """farm_init / farm_step / farm_update against the JAX package's vmapped
    stages, through an update mid-stream and the ring's wrap."""
    rng = np.random.default_rng(66)
    irs = _irs(rng, 3, 700, 0.1)
    jcfg, jst = jfarm.farm_init(irs, 64, 1000)
    cfg, st = farm.farm_init(irs, 64, 1000)
    assert (cfg.seg_count, st.active_segs) == (jcfg.seg_count, 16)
    step = jax.jit(functools.partial(jfarm.farm_step, jcfg))
    new = _irs(rng, 3, 1000, 0.1)
    for t in range(40):
        if t == 20:
            jst = jfarm.farm_update(jcfg, jst, jnp.pad(jnp.asarray(new), ((0, 0), (0, 24))),
                                    jnp.full((3,), 1000, jnp.int32))
            farm.farm_update(cfg, st, torch.nn.functional.pad(torch.from_numpy(new), (0, 24)),
                             1000)
        x = rng.standard_normal((3, 64)).astype(np.float32)
        jst, yj = step(jst, jnp.asarray(x))
        _close(farm.farm_step(cfg, st, torch.from_numpy(x)), yj, ATOL, f"block {t}")
        assert st.current == int(jst.current[0])
    _close(st.segments, packed_to_complex(torch.from_numpy(np.asarray(jst.segments))), 1e-5)


def test_farm_bytes_per_voice_from_shapes():
    cfg = farm.uniform.make_config(128, 10_000)
    per_voice = farm.farm_bytes_per_voice(128, 10_000)
    assert per_voice == 3 * cfg.seg_count * 129 * 8 + 2 * 128 * 4 + 129 * 8
    assert farm.device_budget(torch.device("cpu")) is None


# ---- farm2 against the JAX package ------------------------------------------------

def _jrun(jcfg, mac):
    return jax.jit(functools.partial(jfarm2.farm2_stream, jcfg, tail_mac=mac))


def _states_close(st, jcfg, jst, msg):
    """The port's farm state against the JAX state carried over."""
    want = interop.farm_state(jcfg, jst)
    for name in ("hist", "tail_output", "tail_precalc"):
        _close(getattr(st, name), getattr(want, name), 2e-4, f"{msg}: {name}")
    _close(st.head.segments, want.head.segments, 2e-4, f"{msg}: head ring")
    assert st.head.current == want.head.current == st.tail0.current
    assert st.tail.q == want.tail.q
    _close(st.tail.ring, want.tail.ring, 2e-3, f"{msg}: tail ring")
    np.testing.assert_allclose(st.tail.pre.numpy(), want.tail.pre.numpy(), rtol=PRE_RTOL,
                               atol=PRE_RTOL * float(want.tail.pre.abs().max()),
                               err_msg=f"{msg}: pre")
    assert torch.equal(st.suppress, want.suppress)


@pytest.mark.parametrize("mac", ["jnp", "pallas_interpret"])
def test_farm2_stream_matches_jax(mac):
    """farm2_stream over calls of 2, 1, 4 and 3 periods (the phase walks
    every residue), from init and then from the JAX state carried over by
    interop, against the JAX farm with its jnp core or its Pallas kernel."""
    rng = np.random.default_rng(67)
    irs = _irs(rng, 4)
    jcfg, jst = jfarm2.farm2_init(irs, B, IR_LEN)
    cfg, st = farm2.farm2_init(irs, B, IR_LEN)
    assert (cfg.tail_block, cfg.period, cfg.head.seg_count, cfg.tail.seg_count) == \
        (jcfg.tail_block, jcfg.period, 16, jcfg.tail.seg_count) == (1024, 16, 16, 8)
    run = _jrun(jcfg, mac)
    p = cfg.period
    carried = None
    for call, periods in enumerate([2, 1, 4, 3, 2, 1]):
        x = rng.standard_normal((periods * p, 4, B)).astype(np.float32)
        jst, yj = run(jst, jnp.asarray(x))
        _close(farm2.farm2_stream(cfg, st, torch.from_numpy(x), plain), yj, ATOL,
               f"call {call} ({periods} periods)")
        _states_close(st, jcfg, jst, f"call {call}")
        if carried is not None:
            _close(farm2.farm2_stream(cfg, carried, torch.from_numpy(x), plain), yj, ATOL,
                   f"carried, call {call}")
        if call == 2:
            carried = interop.farm_state(jcfg, jst)


@pytest.mark.parametrize("mac", ["jnp", "pallas_interpret"])
def test_farm2_bf16_matches_jax_packed(mac):
    """bf16 storage against the JAX package's packed words, each call from
    the JAX state carried over (the words map exactly to bf16 pairs): outputs
    to the f32 tolerance, the rows written to within one bf16 step."""
    rng = np.random.default_rng(68)
    irs = _irs(rng, 2)
    jcfg, jst = jfarm2.farm2_init(irs, B, IR_LEN, tail_dtype=jnp.bfloat16)
    cfg, st0 = farm2.farm2_init(irs, B, IR_LEN, tail_dtype=torch.bfloat16)
    assert st0.tail.table.dtype == torch.bfloat16
    got = cuda_farm_mac.as_c64(st0.tail.table)
    want = cuda_farm_mac.as_c64(interop.farm_state(jcfg, jst).tail.table)
    assert float((got - want).abs().max()) <= BF16_STEP * float(want.abs().max())
    run = _jrun(jcfg, mac)
    for call, periods in enumerate([2, 3, 2]):
        st = interop.farm_state(jcfg, jst)
        x = rng.standard_normal((periods * cfg.period, 2, B)).astype(np.float32)
        jst, yj = run(jst, jnp.asarray(x))
        y = farm2.farm2_stream(cfg, st, torch.from_numpy(x), plain)
        _close(y, yj, ATOL, f"call {call}")
        got = cuda_farm_mac.as_c64(st.tail.ring)
        want = cuda_farm_mac.as_c64(interop.farm_state(jcfg, jst).tail.ring)
        assert float((got - want).abs().max()) <= BF16_STEP * float(want.abs().max())


def test_farm2_bf16_close_to_f32():
    """The bf16 farm tracks the f32 farm within bf16's ~3 digits (the JAX
    package's tests/test_parallel.py:294 bound, 2e-2 of the output scale)."""
    rng = np.random.default_rng(69)
    irs = _irs(rng, 2)
    cfg, sf = farm2.farm2_init(irs, B, IR_LEN)
    _, sb = farm2.farm2_init(irs, B, IR_LEN, tail_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((8 * cfg.period, 2, B)).astype(np.float32))
    yf = torch.cat([farm2.farm2_stream(cfg, sf, xc, plain) for xc in x.split(32)])
    yb = torch.cat([farm2.farm2_stream(cfg, sb, xc, plain) for xc in x.split(32)])
    _scaled(yb, yf, 2e-2, "bf16 vs f32")
    # the first two periods carry no big-tail contribution: identical heads
    _close(yb[:2 * cfg.period], yf[:2 * cfg.period], 0.0)


@pytest.mark.parametrize("subset", [None, [2, 0]], ids=["all", "subset"])
def test_farm2_updates_match_jax(subset):
    """farm2_update (all voices) and farm2_update_voices (a subset) against
    the JAX package: the state after the update and the stream after it."""
    rng = np.random.default_rng(70)
    irs, new = _irs(rng, 3), _irs(rng, 3, 6000)
    jcfg, jst = jfarm2.farm2_init(irs, B, IR_LEN)
    cfg, st = farm2.farm2_init(irs, B, IR_LEN)
    run = _jrun(jcfg, "jnp")
    p = cfg.period
    x = rng.standard_normal((5 * p, 3, B)).astype(np.float32)
    jst, _ = run(jst, jnp.asarray(x[:2 * p]))
    farm2.farm2_stream(cfg, st, torch.from_numpy(x[:2 * p]), plain)
    if subset is None:
        jst = jfarm2.farm2_update(jcfg, jst, jnp.asarray(new))
        farm2.farm2_update(cfg, st, new)
    else:
        jst = jfarm2.farm2_update_voices(jcfg, jst, jnp.asarray(subset), jnp.asarray(new[subset]))
        farm2.farm2_update_voices(cfg, st, subset, new[subset])
    want = interop.farm_state(jcfg, jst)
    _close(st.tail.table, want.tail.table, 2e-4, "tail table")
    _close(st.head.segments_ir, want.head.segments_ir, 2e-5, "head table")
    _close(st.tail0.segments_ir, want.tail0.segments_ir, 2e-5, "tail0 table")
    _states_close(st, jcfg, jst, "after the update")
    for call, (lo, hi) in enumerate([(2 * p, 3 * p), (3 * p, 5 * p)]):
        jst, yj = run(jst, jnp.asarray(x[lo:hi]))
        _close(farm2.farm2_stream(cfg, st, torch.from_numpy(x[lo:hi]), plain), yj, ATOL,
               f"call {call} after the update")


def test_farm2_bf16_update_table_matches_jax_words():
    """The rebuilt bf16 table against the JAX package's packed rebuild, to one
    bf16 step (the two round spectra from two DFTs)."""
    rng = np.random.default_rng(71)
    irs, new = _irs(rng, 2), _irs(rng, 2, 7000)
    jcfg, jst = jfarm2.farm2_init(irs, B, IR_LEN, tail_dtype=jnp.bfloat16)
    cfg, st = farm2.farm2_init(irs, B, IR_LEN, tail_dtype=torch.bfloat16)
    jst = jfarm2.farm2_update(jcfg, jst, jnp.asarray(new))
    farm2.farm2_update(cfg, st, new)
    got = cuda_farm_mac.as_c64(st.tail.table)
    want = cuda_farm_mac.as_c64(interop.farm_state(jcfg, jst).tail.table)
    assert float((got - want).abs().max()) <= BF16_STEP * float(want.abs().max())


def test_farm2_capacity_guard_explicit_budgets():
    """The guard's model comes from the port's shapes and raises at
    construction with the estimate and the fitting voice count."""
    rng = np.random.default_rng(72)
    irs = _irs(rng, 4)
    per_voice = farm2.farm2_bytes_per_voice(B, IR_LEN, t_blocks=8 * 16)
    bf16 = farm2.farm2_bytes_per_voice(B, IR_LEN, t_blocks=8 * 16, tail_item=4)
    # the tail ring and table: 8 segments x 1025 bins x 2 arrays
    assert per_voice - bf16 == 2 * 8 * 1025 * 4
    with pytest.raises(ValueError, match="GB"):
        farm2.farm2_init(irs, B, IR_LEN, hbm_budget_bytes=2 * per_voice)
    with pytest.raises(ValueError, match="2 voices fit"):
        farm2.farm2_init(irs, B, IR_LEN, hbm_budget_bytes=2 * per_voice)
    with pytest.raises(ValueError, match="voices fit"):
        farm2.farm2_init(irs, B, IR_LEN, tail_dtype=torch.bfloat16,
                         hbm_budget_bytes=3 * bf16)
    farm2.farm2_init(irs, B, IR_LEN, hbm_budget_bytes=4 * per_voice)
    farm2.farm2_init(irs, B, IR_LEN, tail_dtype=torch.bfloat16, hbm_budget_bytes=4 * bf16)
    farm2.farm2_init(irs, B, IR_LEN, hbm_budget_bytes=None)


# ---- kernel B6's plain version: the head path ------------------------------------

def _jax_hist(jst, jcfg):
    """The JAX farm's head history ``[V, n-1, 2, B]`` from the period-buffer
    planes it keeps it in (as ``farm2_stream`` reads it)."""
    v, b, p, n = jst.tail_output.shape[0], jcfg.head_block, jcfg.period, jcfg.head.seg_count
    return jnp.stack([jst.tail_precalc0.reshape(v, p, b)[:, :n - 1],
                      jst.tail_output0.reshape(v, p, b)[:, :n - 1]], axis=2)


@pytest.mark.parametrize("suppress", [False, True], ids=["no-suppress", "suppress"])
@pytest.mark.parametrize("periods", [1, 2, 4])
def test_heads_step_plain_matches_jax(periods, suppress):
    """heads_step_plain against the JAX package's _heads_fused (with its
    _heads_state_out) on one state carried over by interop, the ring head
    turned to 5 in both: the output, the rebuilt ring, hist, current,
    overlap and both pre_multiplied.  With suppress, voices 0 and 2 were
    updated right before the call (farm2_update_voices), so their first
    period takes the suppress pass."""
    rng = np.random.default_rng(80 + periods)
    irs = _irs(rng, 3)
    jcfg, jst = jfarm2.farm2_init(irs, B, IR_LEN)
    p = jcfg.period
    jst, _ = _jrun(jcfg, "jnp")(jst, jnp.asarray(
        rng.standard_normal((3 * p, 3, B)).astype(np.float32)))
    if suppress:
        jst = jfarm2.farm2_update_voices(jcfg, jst, jnp.asarray([0, 2]),
                                         jnp.asarray(_irs(rng, 2, 7000)))
    head = jnp.full((3,), 5, jnp.int32)
    jst = jst._replace(head=jst.head._replace(current=head),
                       tail0=jst.tail0._replace(current=head))
    st = interop.farm_state(jcfg, jst)
    assert bool(st.suppress.any()) == suppress and st.head.current == 5
    x = rng.standard_normal((periods * p, 3, B)).astype(np.float32)
    jh, jt0, jy, jhist = jfarm2._heads_fused(jcfg, jst.head, jst.tail0,
                                             jnp.swapaxes(jnp.asarray(x), 0, 1),
                                             _jax_hist(jst, jcfg), jst.precalc_pos)
    y = cuda_farm_heads.heads_step_plain(st.head, st.tail0, torch.from_numpy(x), st.hist,
                                         st.suppress)
    _close(y, np.swapaxes(np.asarray(jy), 0, 1), ATOL, "y")
    want_h, want_t0 = interop.uniform_state(jh), interop.uniform_state(jt0)
    _close(st.head.segments, want_h.segments, 2e-4, "head ring")
    _close(st.hist, packed_to_complex(torch.from_numpy(np.asarray(jhist))), 2e-4, "hist")
    _close(st.head.overlap, want_h.overlap, ATOL, "head overlap")
    assert st.head.current == st.tail0.current == want_h.current == want_t0.current
    for got, want in ((st.head.pre_multiplied, want_h.pre_multiplied),
                      (st.tail0.pre_multiplied, want_t0.pre_multiplied)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=PRE_RTOL,
                                   atol=PRE_RTOL * float(want.abs().max()))


def test_heads_step_on_cpu_is_the_plain_version():
    """heads_step takes the plain version for CPU tensors (no launch counted),
    with the delay line added: the same output and exit state as
    heads_step_plain; the plain version with the table's meta-spectra bound
    (as a caller of farm2_stream binds them) matches the call without khat
    to float32 rounding, and farm2_stream refuses head_khat for a big-tail
    farm."""
    rng = np.random.default_rng(86)
    cfg, st = farm2.farm2_init(_irs(rng, 2), B, IR_LEN)
    p = cfg.period
    farm2.farm2_stream(cfg, st, torch.from_numpy(
        rng.standard_normal((2 * p, 2, B)).astype(np.float32)), plain)
    x = torch.from_numpy(rng.standard_normal((3 * p, 2, B)).astype(np.float32))
    delay = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for shape in ((2, p * B), (2, p * B), (3, 2, p * B)))
    before = cuda_farm_heads.heads_step.launches
    twin, other, bare = st.clone(), st.clone(), st.clone()
    y = cuda_farm_heads.heads_step(st.head, st.tail0, x, st.hist, st.suppress, delay)
    want = cuda_farm_heads.heads_step_plain(twin.head, twin.tail0, x, twin.hist,
                                            twin.suppress, delay)
    assert cuda_farm_heads.heads_step.launches == before
    assert torch.equal(y, want) and torch.equal(st.hist, twin.hist)
    assert torch.equal(st.head.segments, twin.head.segments)
    khat = farm2.farm2_head_khat(cfg, other, 3 * p)
    with_khat = functools.partial(cuda_farm_heads.heads_step_plain, khat=khat)
    y_k = with_khat(other.head, other.tail0, x, other.hist, other.suppress, delay)
    _close(y_k, want, ATOL, "with khat")
    with pytest.raises(ValueError, match="short-IR farm"):
        farm2.farm2_stream(cfg, bare.clone(), x, plain, head_khat=khat)
    # the delay line: period 0 takes the precalc, 1 the output, 2 tail row 0
    y_bare = cuda_farm_heads.heads_step_plain(bare.head, bare.tail0, x, bare.hist,
                                              bare.suppress)
    added = (y - y_bare).view(3, p, 2, B)
    for period, want_d in enumerate((delay[0], delay[1], delay[2][0])):
        _close(added[period], want_d.view(2, p, B).transpose(0, 1), ATOL, f"period {period}")


def test_farm2_head_khat_voices_are_rows_of_the_whole():
    """farm2_head_khat_voices (the plain head path's per-voice meta-spectra)
    equals the rows of farm2_head_khat for those voices."""
    rng = np.random.default_rng(88)
    cfg, st = farm2.farm2_init(_irs(rng, 4), B, IR_LEN)
    t = 3 * cfg.period
    whole = farm2.farm2_head_khat(cfg, st, t)
    _close(farm2.farm2_head_khat_voices(cfg, st, t, [3, 1]), whole[[3, 1]],
           1e-6 * float(whole.abs().max()))


@pytest.mark.parametrize("n,b,t,plan", [
    (16, 64, 16, (256, 224, 1, 16, 16)),
    (16, 64, 128, (256, 224, 1, 16, 16)),
    (256, 128, 2048, (1024, 512, 4, 16, 16)),
    (256, 128, 4096, (1024, 512, 8, 16, 16)),
    (128, 1024, 512, (1024, 768, 1, 13, 12)),
    (64, 512, 1024, (256, 128, 8, 16, 16)),
    (1, 2048, 16, (256, 254, 1, 6, 5)),
    (1024, 16, 2048, (4096, 2048, 1, 16, 16)),
])
def test_heads_plan_from_shapes(n, b, t, plan):
    """B6's launch plan, a pure function of (n, B, T): the column transform
    M, the least of 256, 1024 and 4096 that holds 4n, with S = M - 2n conv
    rows a segment, and the tiles of the forward and finishing thread blocks
    (teams of B/16 threads, 1024 threads and at most 16 blocks a thread
    block, at most 15 teams of more than a warp, and what shared memory
    holds: 13 teams at B = 1024, 6 at 2048; the finish inverts one block
    more)."""
    got = cuda_farm_heads.heads_plan(n, b, t)
    assert (got.meta, got.step, got.segments, got.fwd_tile, got.fin_tile) == plan
    assert cuda_farm_heads.column_smem(got.meta, n) <= cuda_farm_heads.MAX_SMEM


def test_heads_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="multiple of the period"):
        cuda_farm_heads.heads_plan(16, 64, 24)
    with pytest.raises(ValueError, match="at most 1024 head segments"):
        cuda_farm_heads.heads_plan(2048, 16, 2048)
    with pytest.raises(ValueError, match="power of two"):
        cuda_farm_heads.heads_plan(16, 4096, 16)
    with pytest.raises(ValueError, match="at least 4 samples"):
        cuda_farm_heads.heads_plan(16, 2, 16)


def test_farm2_bytes_per_voice_from_shapes():
    """The capacity model from the port's shapes (block 64, 9000 taps: tail
    block 1024, n = 16, N = 8): the state, no head meta-spectra, plus the
    larger of the big tail's and the head path's transients; the short-IR
    farm keeps the conv core's meta-spectra and transients."""
    cfg, _ = farm2.farm2_init(_irs(np.random.default_rng(87), 1), B, IR_LEN)
    n, n_t, tb, nb, tnb = 16, 8, 1024, 65, 1025
    assert (cfg.head.seg_count, cfg.tail.seg_count, cfg.tail_block) == (n, n_t, tb)

    def stage(rows, width, bins, item=8):
        return 2 * rows * bins * item + 2 * width * 4 + bins * 8

    for item in (8, 4):
        state = (2 * stage(n, B, nb) + stage(n_t, tb, tnb, item) + (n - 1) * nb * 8
                 + 2 * tb * 4)
        for t in (16, 32, 128):
            q = t // 16
            tail = q * (3 * tnb * 8 + 2 * tb * 4)
            heads = 2 * t * nb * 8 + t * B * 4 + q * tb * 4
            assert farm2.farm2_bytes_per_voice(B, IR_LEN, t, item) == state + max(tail, heads)
    # the short-IR farm (256 taps at block 64: tail block 128, n = 2, no big
    # tail), an 8-block call: m = npo2(2n - 1 + 8) = 16, four tail blocks
    assert farm2._tail_segments(B, 256) == (128, 0)
    short = (2 * stage(2, B, nb) + stage(0, 128, 129) + nb * 8 + 2 * 128 * 4
             + 5 * 16 * nb * 8 + 4 * (2 * 129 * 8 + 2 * 128 * 4))
    assert farm2.farm2_bytes_per_voice(B, 256, 8) == short
    # config 5's shape at its largest call: 1024 voices fit 80 GB in f32
    assert 1024 * farm2.farm2_bytes_per_voice(128, 60 * 48000, 4096) < 80e9


# ---- ReverbFarm (ports tests/test_api_farm.py) ---------------------------------------

def _farm(v=V, b=B, ir_len=IR_LEN, seed=30, **kw):
    rng = np.random.default_rng(seed)
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    return ReverbFarm(irs, b, ir_len, device="cpu", **kw), irs, rng


def _engine(ir, cap=IR_LEN):
    return TwoStageFFTConvolver(ir, B, cap, device="cpu")


def _voice(y, voice):
    return np.asarray(y)[:, voice].reshape(-1)


def test_reverb_farm_matches_per_voice_engines():
    farm_, irs, rng = _farm()
    t = 2 * farm_.period
    x = rng.standard_normal((2 * t, V, B)).astype(np.float32)
    new_irs = rng.standard_normal((V, 5000)).astype(np.float32) * 0.05
    y1 = farm_.process(x[:t])
    assert isinstance(y1, torch.Tensor) and y1.device == farm_.device
    farm_.update(new_irs)
    y2 = farm_.process(x[t:])
    for voice in range(V):
        e = _engine(irs[voice])
        r1 = e.process(x[:t, voice].reshape(-1))
        e.update_extension(new_irs[voice])
        r2 = e.process(x[t:, voice].reshape(-1))
        _close(np.concatenate([_voice(y1, voice), _voice(y2, voice)]),
               np.concatenate([r1, r2]), ATOL, f"voice {voice}")


def test_reverb_farm_matches_jax_reverb_farm():
    """The same schedule of calls, updates and a reset through the port's
    farm and the JAX package's, call by call."""
    rng = np.random.default_rng(73)
    irs = _irs(rng, 4)
    ours, theirs = ReverbFarm(irs, B, IR_LEN, device="cpu"), JaxReverbFarm(irs, B, IR_LEN)
    p = ours.period
    for step, periods in enumerate([2, 1, 2, 2, 1, 2]):
        if step == 2:
            new = _irs(rng, 4, 8000)
            ours.update(new)
            theirs.update(new)
        if step == 3:
            new = _irs(rng, 2, 3000)
            ours.update_voices([3, 1], new)
            theirs.update_voices([3, 1], new)
        if step == 4:
            ours.reset()
            theirs.reset()
        x = rng.standard_normal((periods * p, 4, B)).astype(np.float32)
        _close(ours.process(x), theirs.process(x), ATOL, f"step {step}")


def test_reverb_farm_reset_repeatable():
    farm_, irs, rng = _farm(seed=31)
    x = rng.standard_normal((farm_.period, V, B)).astype(np.float32)
    y1 = farm_.process(x)
    farm_.reset()
    assert torch.equal(farm_.process(x), y1)


def test_reverb_farm_clone_independent():
    farm_, irs, rng = _farm(seed=32)
    x = rng.standard_normal((farm_.period, V, B)).astype(np.float32)
    twin = farm_.clone()
    y_a = farm_.process(x)
    # the twin was cloned before processing: same input gives same output
    assert torch.equal(twin.process(x), y_a)
    snap = farm_.snapshot()
    y_next = farm_.process(x)
    farm_.restore(snap)
    assert torch.equal(farm_.process(x), y_next)
    # an update on the clone leaves the original's tables and cache alone
    twin.update(np.zeros((V, 100), np.float32))
    assert torch.equal(farm_.clone().process(x), farm_.process(x))


def test_reverb_farm_contracts():
    farm_, irs, rng = _farm(seed=33)
    with pytest.raises(ValueError):
        farm_.process(np.zeros((farm_.period - 1, V, B), np.float32))
    with pytest.raises(ValueError):
        farm_.process(np.zeros((farm_.period, V + 1, B), np.float32))
    with pytest.raises(ValueError):
        farm_.update(np.zeros((V, irs.shape[1] + 1), np.float32))
    with pytest.raises(ValueError):
        ReverbFarm(np.zeros(100, np.float32), 64, 100, device="cpu")  # 1-D irs
    with pytest.raises(ValueError, match="tail_mac"):
        ReverbFarm(irs, 64, IR_LEN, tail_mac="jnp", device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        ReverbFarm(irs, 48, IR_LEN, device="cpu")


def test_reverb_farm_capacity_guard():
    """An oversized farm raises an actionable ValueError at construction
    naming the estimated footprint."""
    rng = np.random.default_rng(40)
    irs = rng.standard_normal((4, 9000)).astype(np.float32) * 0.05
    per_voice = farm2.farm2_bytes_per_voice(64, 9000, t_blocks=8 * 16)
    assert per_voice > 0
    with pytest.raises(ValueError, match="GB"):
        ReverbFarm(irs, 64, 9000, hbm_budget_bytes=2 * per_voice, device="cpu")
    with pytest.raises(ValueError, match="voices fit"):
        farm2.farm2_init(irs, 64, 9000, hbm_budget_bytes=2 * per_voice)
    farm_ = ReverbFarm(irs, 64, 9000, hbm_budget_bytes=16 * per_voice, device="cpu")
    assert farm_.voices == 4
    ReverbFarm(irs, 64, 9000, hbm_budget_bytes=None, device="cpu")


def test_reverb_farm_per_call_ceiling():
    """T beyond min(N, 16) periods is a clean ValueError; exactly at the
    ceiling still works."""
    farm_, irs, rng = _farm(seed=36)
    assert farm_.max_blocks_per_call == min(farm_.cfg.tail.seg_count, 16) * farm_.period
    with pytest.raises(ValueError, match="per-call ceiling"):
        farm_.process(np.zeros((farm_.max_blocks_per_call + farm_.period, V, B), np.float32))
    x = rng.standard_normal((farm_.max_blocks_per_call, V, B)).astype(np.float32)
    y = farm_.process(x)
    assert y.shape == x.shape


# ---- ReverbFarm(mesh=...): the voices split over a "dp" mesh of MESH_RANKS ranks -----

MESH_RANKS = 2


def _mesh_inputs():
    """Per test: (irs, ops for ``torch_ranks.reverb_farm``), the JAX tests'
    seeds with the voice counts scaled from their 8 devices to the ranks."""
    w = MESH_RANKS
    period = 16
    rng = np.random.default_rng(43)     # :125, V = mesh size
    irs = _irs(rng, w)
    pallas = (irs, [("raises_new", irs[:w - 1])]
              + [("process", rng.standard_normal((period, w, B)).astype(np.float32))
                 for _ in range(2)])
    rng = np.random.default_rng(34)     # :148, V = 2 x mesh size
    irs = _irs(rng, 2 * w)
    on_mesh = (irs, [("process", rng.standard_normal((period, 2 * w, B)).astype(np.float32))])
    rng = np.random.default_rng(51)     # :335, V = mesh size
    irs = _irs(rng, w)
    x = rng.standard_normal((4 * period, w, B)).astype(np.float32)
    new_ir = rng.standard_normal(6000).astype(np.float32) * 0.05
    update = (irs, [("process", x[:2 * period]), ("update_voice", 1, new_ir),
                    ("process", x[2 * period:])])
    return {"mesh_pallas_shard_map": pallas, "on_mesh": on_mesh, "update_voice_on_mesh": update}


@pytest.fixture(scope="module")
def mesh_farms():
    """Every rank's results of the three mesh tests' jobs, one spawn."""
    jobs = {name: ("reverb_farm", dict(irs=irs, b=B, cap=IR_LEN, ops=ops))
            for name, (irs, ops) in _mesh_inputs().items()}
    return run_ranks(torch_ranks.run_jobs, MESH_RANKS, jobs, device="cpu", timeout=300)


def _mesh_farm_matches_jax(results, name):
    """Each rank's slabs against the unsharded JAX farm (jnp core) on the
    same ops, and its voices the rank's own ``local_voices``."""
    irs, ops = _mesh_inputs()[name]
    ref = JaxReverbFarm(irs, B, IR_LEN, tail_mac="jnp")
    want = []
    for op, *args in ops:
        if op == "process":
            want.append(np.asarray(ref.process(args[0])))
        elif op != "raises_new":
            getattr(ref, op)(*args)
    per_rank = irs.shape[0] // MESH_RANKS
    for rank, res in enumerate(results):
        got = res[name]
        lo, hi = got["voices"]
        assert (lo, hi) == (rank * per_rank, (rank + 1) * per_rank)
        for call, (y, w) in enumerate(zip(got["y"], want)):
            _close(y, w[:, lo:hi], ATOL, f"rank {rank}, call {call}")
    return results


def test_reverb_farm_mesh_pallas_shard_map(mesh_farms):
    """:125 — each rank steps kernel B5 (its plain version here) on its own
    voices and matches the single-device jnp farm; a voice count that does
    not divide by the mesh raises."""
    for res in _mesh_farm_matches_jax(mesh_farms, "mesh_pallas_shard_map"):
        (msg,) = res["mesh_pallas_shard_map"]["raised"]
        assert msg is not None and "divide" in msg


def test_reverb_farm_on_mesh(mesh_farms):
    """:148 — two voices a rank."""
    _mesh_farm_matches_jax(mesh_farms, "on_mesh")


def test_reverb_farm_update_voice_on_mesh(mesh_farms):
    """:335 — a per-voice update by global index on the sharded farm: only
    its owner applies it, and every rank matches the single-device farm."""
    _mesh_farm_matches_jax(mesh_farms, "update_voice_on_mesh")


def test_reverb_farm_varying_call_lengths():
    """The head path's history carry holds across calls of different lengths
    (T = p, 2p, p), including right after an update."""
    farm_, irs, rng = _farm(seed=37)
    p = farm_.period
    x = rng.standard_normal((4 * p, V, B)).astype(np.float32)
    new_irs = rng.standard_normal((V, 7000)).astype(np.float32) * 0.05
    ys = [farm_.process(x[:p]), farm_.process(x[p:3 * p])]
    farm_.update(new_irs)
    ys.append(farm_.process(x[3 * p:]))
    y = torch.cat(ys)
    for voice in range(V):
        e = _engine(irs[voice])
        r1 = e.process(x[:3 * p, voice].reshape(-1))
        e.update_extension(new_irs[voice])
        r2 = e.process(x[3 * p:, voice].reshape(-1))
        _close(_voice(y, voice), np.concatenate([r1, r2]), ATOL, f"voice {voice}")


def test_reverb_farm_update_voice_matches_engines():
    """The touched voice behaves like an engine given update_extension of the
    response zero-padded to capacity; untouched voices are bit-identical to
    a farm that never updated."""
    farm_, irs, rng = _farm(seed=44)
    p = farm_.period
    t = 2 * p
    x = rng.standard_normal((3 * t, V, B)).astype(np.float32)
    new_ir = rng.standard_normal(6000).astype(np.float32) * 0.05
    twin = farm_.clone()
    y1 = farm_.process(x[:t])  # fills the khat cache
    twin.process(x[:t])
    farm_.update_voice(1, new_ir)
    y2, y3 = farm_.process(x[t:2 * t]), farm_.process(x[2 * t:])
    z2, z3 = twin.process(x[t:2 * t]), twin.process(x[2 * t:])
    keep = [0, 2]
    assert torch.equal(y2[:, keep], z2[:, keep]) and torch.equal(y3[:, keep], z3[:, keep])
    for voice in range(V):
        e = _engine(irs[voice])
        r1 = e.process(x[:t, voice].reshape(-1))
        if voice == 1:
            e.update_extension(np.pad(new_ir, (0, IR_LEN - len(new_ir))))
        r23 = e.process(x[t:, voice].reshape(-1))
        _close(np.concatenate([_voice(y1, voice), _voice(y2, voice), _voice(y3, voice)]),
               np.concatenate([r1, r23]), ATOL, f"voice {voice}")


def test_reverb_farm_update_voices_subset_and_contracts():
    farm_, irs, rng = _farm(v=4, seed=45)
    p = farm_.period
    t = 2 * p
    x = rng.standard_normal((2 * t, 4, B)).astype(np.float32)
    new_irs = rng.standard_normal((4, 7000)).astype(np.float32) * 0.05
    # all-voices subset update == batched full update
    a, bfarm = farm_.clone(), farm_.clone()
    a.process(x[:t])
    bfarm.process(x[:t])
    a.update_voices(np.arange(4), new_irs)
    bfarm.update(new_irs)
    _close(a.process(x[t:]), bfarm.process(x[t:]), 1e-6)
    # subset {0, 3}, given out of order
    c = farm_.clone()
    c.process(x[:t])
    c.update_voices([3, 0], new_irs[[3, 0]])
    y = c.process(x[t:])
    for voice in range(4):
        e = _engine(irs[voice])
        e.process(x[:t, voice].reshape(-1))
        if voice in (0, 3):
            e.update_extension(new_irs[voice])
        _close(_voice(y, voice), e.process(x[t:, voice].reshape(-1)), ATOL, f"voice {voice}")
    with pytest.raises(ValueError, match="distinct"):
        farm_.update_voices([1, 1], new_irs[:2])
    with pytest.raises(ValueError, match="range"):
        farm_.update_voices([4], new_irs[:1])
    with pytest.raises(ValueError, match="capacity"):
        farm_.update_voice(0, np.zeros(irs.shape[1] + 1, np.float32))
    with pytest.raises(ValueError, match="expected"):
        farm_.update_voices([0, 1], new_irs[:1])


def test_reverb_farm_update_voice_short_ir_farm():
    """Per-voice update on the short-IR farm (no big tail stage; ports
    tests/test_api_farm.py:296-315): each voice matches its own two-stage
    engine, and the whole farm the JAX package's, call by call; both calls
    stream through the conv core (head and tail0)."""
    rng = np.random.default_rng(46)
    v, b = 3, 64
    irs = rng.standard_normal((v, 120)).astype(np.float32) * 0.05
    farm_ = ReverbFarm(irs, b, irs.shape[1], device="cpu")
    theirs = JaxReverbFarm(irs, b, irs.shape[1])
    assert farm_.cfg.tail is None and farm_.max_blocks_per_call is None
    p = farm_.period
    t = 2 * p
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)
    new_ir = rng.standard_normal(100).astype(np.float32) * 0.05
    calls = uniform._stream_conv.calls
    _close(farm_.process(x[:t]), theirs.process(x[:t]), ATOL, "first call")
    assert uniform._stream_conv.calls - calls == 2
    farm_.update_voice(2, new_ir)
    theirs.update_voice(2, new_ir)
    y = farm_.process(x[t:])
    _close(y, theirs.process(x[t:]), ATOL, "after update_voice")
    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1], device="cpu")
        e.process(x[:t, voice].reshape(-1))
        if voice == 2:
            e.update_extension(new_ir)
        _close(_voice(y, voice), e.process(x[t:, voice].reshape(-1)), ATOL, f"voice {voice}")


def test_reverb_farm_head_dft_precision_names():
    """The JAX package's precision names are accepted (every transform here
    is float32 torch.fft, so the output is the same); bogus names raise."""
    farm_, irs, rng = _farm(seed=47)
    fast = ReverbFarm(irs, 64, IR_LEN, dft_precision="bf16", tail_dft_precision="high",
                      tail_dtype=torch.bfloat16, device="cpu")
    x = rng.standard_normal((2 * farm_.period, V, B)).astype(np.float32)
    _scaled(fast.process(x), farm_.process(x), 2e-2, "bf16 tail vs f32")
    with pytest.raises(ValueError, match="dft_precision"):
        ReverbFarm(irs, 64, IR_LEN, dft_precision="bogus", device="cpu")
    with pytest.raises(ValueError, match="tail_dft_precision"):
        ReverbFarm(irs, 64, IR_LEN, tail_dft_precision="bogus", device="cpu")


def test_reverb_farm_update_voices_packed_storage():
    """bf16 storage: the per-voice column write equals the batched rebuild
    bit for bit, and untouched voices stay bit-identical."""
    rng = np.random.default_rng(49)
    irs = _irs(rng, 4)
    farm_ = ReverbFarm(irs, B, IR_LEN, tail_dtype=torch.bfloat16, device="cpu")
    assert farm_.state.tail.table.dtype == torch.bfloat16
    t = 2 * farm_.period
    x = rng.standard_normal((2 * t, 4, B)).astype(np.float32)
    new_irs = rng.standard_normal((4, 7000)).astype(np.float32) * 0.05
    a, bfarm = farm_.clone(), farm_.clone()
    a.process(x[:t])
    bfarm.process(x[:t])
    a.update_voices(np.arange(4), new_irs)
    bfarm.update(new_irs)
    assert torch.equal(a.state.tail.table, bfarm.state.tail.table)
    _close(a.process(x[t:]), bfarm.process(x[t:]), 1e-6)
    c, twin = farm_.clone(), farm_.clone()
    c.process(x[:t])
    twin.process(x[:t])
    c.update_voices([2, 0], new_irs[[2, 0]])
    d = farm_.clone()
    d.process(x[:t])
    d.update(np.where(np.isin(np.arange(4), [0, 2])[:, None], new_irs, irs[:, :7000]))
    assert torch.equal(c.state.tail.table[:, [0, 2]], d.state.tail.table[:, [0, 2]])
    keep = [1, 3]
    assert torch.equal(c.process(x[t:])[:, keep], twin.process(x[t:])[:, keep])


def test_reverb_farm_random_update_schedule():
    """Random interleaving of streams, subset updates, full updates and
    resets against per-voice engines given the responses zero-padded to
    capacity (PARITY.md divergence 5)."""
    farm_, irs, rng = _farm(v=4, seed=48)
    p, cap = farm_.period, irs.shape[1]
    engines = [_engine(irs[i]) for i in range(4)]
    for step in range(10):
        action = rng.integers(0, 4)
        if action == 0 and step > 0:
            k = int(rng.integers(1, 5))
            idx = rng.permutation(4)[:k]
            new = (rng.standard_normal((k, int(rng.integers(100, cap + 1)))) * 0.05
                   ).astype(np.float32)
            farm_.update_voices(idx, new)
            for j, voice in enumerate(idx):
                engines[voice].update_extension(np.pad(new[j], (0, cap - new.shape[1])))
        elif action == 1 and step > 0:
            new = (rng.standard_normal((4, cap)) * 0.05).astype(np.float32)
            farm_.update(new)
            for voice in range(4):
                engines[voice].update_extension(new[voice])
        elif action == 2 and step > 3:
            farm_.reset()
            for e in engines:
                e.reset()
        x = rng.standard_normal((int(rng.integers(1, 3)) * p, 4, B)).astype(np.float32)
        y = farm_.process(x)
        for voice in range(4):
            r = engines[voice].process(x[:, voice].reshape(-1))
            _close(_voice(y, voice), r, 2e-5 * max(np.abs(r).max(), 1.0),
                   f"step {step} voice {voice}")


def test_reverb_farm_long_call():
    """An 8-period call (the ceiling here) exercises the delay line's third
    slot branch: this call's early big-tail outputs land in its own output."""
    farm_, irs, rng = _farm(seed=41)
    x = rng.standard_normal((8 * farm_.period, V, B)).astype(np.float32)
    y = farm_.process(x)
    for voice in range(V):
        _close(_voice(y, voice), _engine(irs[voice]).process(x[:, voice].reshape(-1)), ATOL,
               f"voice {voice}")


def test_reverb_farm_khat_cache_patched_per_voice():
    """The big-tail farm caches no head meta-spectra (its head path, kernel
    B6 or the plain version, reads the raw tables every call), so
    update_voice has nothing to patch: afterwards the touched voice follows
    its new IR (against a farm built with it and streamed the same) and the
    untouched voices continue bit-identically to a clone that skipped the
    update."""
    farm_, irs, rng = _farm(seed=50)
    p = farm_.period
    xs = [rng.standard_normal((k * p, V, B)).astype(np.float32) for k in (1, 4, 2)]
    farm_.process(xs[0])
    farm_.process(xs[1])
    assert not farm_._khat_cache
    twin = farm_.clone()
    new = _irs(rng, 1, 4000)[0]
    farm_.update_voice(2, new)
    assert not farm_._khat_cache
    y, y_twin = farm_.process(xs[2]), twin.process(xs[2])
    assert torch.equal(y[:, :2], y_twin[:, :2])
    irs2 = irs.copy()
    irs2[2] = 0.0
    irs2[2, :len(new)] = new
    ref = ReverbFarm(irs, B, IR_LEN, device="cpu")
    ref.process(xs[0])
    ref.process(xs[1])
    ref.update(irs2)
    _close(y[:, 2], ref.process(xs[2])[:, 2], ATOL, "updated voice")