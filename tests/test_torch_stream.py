"""The port's long-IR streaming and bf16-storage slice on the CPU: the plain
versions of kernels B4 (f32 and bf16 table) and B1p, and the serving
wrappers ``CudaStreamingConvolver`` and ``CudaFFTConvolver(storage=
"bf16_packed")``, held against the JAX package's Pallas kernels and
wrappers in interpret mode (``chunk=8`` as in tests/test_pallas.py), from
init and from carried state, on the same numpy-seeded inputs.  Ports
``tests/test_pallas.py``'s streaming and packed-storage tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu.ops import pallas_engine, pallas_stream
from fft_convolution_tpu.ops.packing import pack_c32
from fft_convolution_tpu.serving import PallasFFTConvolver, PallasStreamingConvolver
from fft_convolution_tpu_torch import interop, serving
from fft_convolution_tpu_torch.api import FFTConvolver
from fft_convolution_tpu_torch.ops import cuda_engine, cuda_stream
from fft_convolution_tpu_torch.serving import CudaFFTConvolver, CudaStreamingConvolver

# f32 tables: the Pallas kernels' basis-matmul DFTs against pocketfft over
# many blocks; the JAX package holds its streaming wrapper to the same 2e-5
# (tests/test_pallas.py::test_pallas_streaming_convolver_matches_engine).
F32_ATOL = 2e-5
# bf16 storage: ~3 significant digits per stored term; the summed history
# lands around 1e-3 of the output scale, and the JAX package's tests and
# its on-chip gates hold packed storage to 5e-3 of it (bench.py:421-424).
BF16_REL = 5e-3


def _rel(got, want, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=BF16_REL,
                               err_msg=msg)


def _mk(rng, n):
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


def _blocks(rng, t, b):
    return rng.standard_normal((t, b)).astype(np.float32)


# ---- interop: the TPU's bf16 words ------------------------------------------

def test_words_unpack_exactly_to_round_to_nearest_even():
    """The JAX package's uint32 words decode to exactly the bf16 values the
    port stores with round-to-nearest-even (ties included)."""
    rng = np.random.default_rng(70)
    re = rng.standard_normal((5, 8)).astype(np.float32)
    im = rng.standard_normal((5, 8)).astype(np.float32)
    # exact ties between two bf16 values, both parities of the kept bit
    re[0, :4] = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x40018000],
                         np.uint32).view(np.float32)
    words = np.asarray(pack_c32(jnp.asarray(re), jnp.asarray(im)))
    got = interop._words(words, "cpu")
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    want = cuda_engine.to_bf16(interop._planes(re, im, "cpu"))
    assert got.dtype == torch.bfloat16 and got.shape == (5, 9, 2)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(cuda_engine.as_c64(got)[:, 1:8].real,
                       spec[:, 1:8].real.to(torch.bfloat16).float())


# ---- kernel B4 ----------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["f32", "bf16"])
def test_b4_plain_matches_pallas_from_carried_state(packed):
    """Kernel B4's plain version from a state the Pallas streaming kernel
    reached (interpret mode): calls of T = 13 (not a multiple of 8) and
    T = 30 (> N, the ring overwritten within the call).  Both sides read the
    same table values (bf16 words decode exactly), so the f32 tolerance
    holds for the bf16 table too."""
    rng = np.random.default_rng(71)
    b, chunk = 64, 8
    ir = _mk(rng, b * 21 - 37)
    n = pallas_stream.padded_seg_count(21, chunk)
    cfg, js = juni.init(ir, b, n * b)
    build = pallas_stream.build_consts_packed if packed else pallas_stream.build_consts
    jconsts = build(js.segments_ir, n, b)
    jst = pallas_stream.zero_state(n, b)
    jst, _ = pallas_stream.stream(cfg, jconsts, jst, jnp.asarray(_blocks(rng, 10, b)),
                                  chunk=chunk, interpret=True)
    consts, st = interop.stream(jconsts, jst)
    assert consts.irrev.dtype == (torch.bfloat16 if packed else torch.complex64)
    assert st.w == int(jst.w[0]) == 10
    for t_len in (13, 30):
        x = _blocks(rng, t_len, b)
        jst, jy = pallas_stream.stream(cfg, jconsts, jst, jnp.asarray(x), chunk=chunk,
                                       interpret=True)
        y = cuda_stream.stream(consts, st, torch.from_numpy(x))  # CPU: plain version
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL,
                                   err_msg=f"T={t_len}")
        assert st.w == int(jst.w[0])
        _, ring = interop.stream(jconsts, jst)
        np.testing.assert_allclose(st.ring.numpy(), ring.ring.numpy(), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(st.overlap.numpy(), np.asarray(jst.overlap)[0],
                                   atol=F32_ATOL)


@pytest.mark.parametrize("n,t_len,b", [(1, 1, 32), (1, 700, 2048), (24, 13, 64), (37, 1, 32),
                                       (37, 70, 64), (512, 64, 128), (600, 17, 256),
                                       (3750, 100, 128), (11264, 1, 128), (11264, 64, 128),
                                       (11264, 64, 32), (11264, 64, 2048), (4, 9, 2048)])
@pytest.mark.parametrize("item", [8, 4], ids=["f32", "bf16"])
def test_stream_plan_covers_every_row_block_and_bin(n, t_len, b, item):
    """Kernel B4's MAC launch plan: every table row in exactly one split,
    every audio block and bin in a tile, whole warps within the kernel's
    thread cap, an ext ring that holds the window and the stages in flight,
    and shared memory within the 227 KB a block may have."""
    plan = cuda_stream.stream_plan(n, b, t_len, item)
    rows = [u for s in range(plan.splits)
            for u in range(s * plan.rows, min((s + 1) * plan.rows, n))]
    assert rows == list(range(n)) and plan.rows % cuda_stream.TILE == 0
    for count, size, total in ((plan.t_tiles, plan.span, t_len),
                               (plan.bin_tiles, plan.kb, b + 1)):
        assert (count - 1) * size < total <= count * size
    assert plan.threads % 32 == 0 and plan.kb * plan.groups <= plan.threads
    assert plan.threads <= cuda_stream.MAC_MAX_THREADS
    assert plan.groups <= cuda_stream.MAX_GROUPS
    ring = plan.ring_rows
    assert ring & (ring - 1) == 0
    assert ring >= plan.span - 1 + cuda_stream.STAGES * cuda_stream.TILE
    want_smem = plan.kb * (ring * 8 + cuda_stream.STAGES * cuda_stream.TILE * item)
    assert plan.smem == want_smem <= 227 * 1024


def test_b4_plain_long_calls_match_direct_convolution():
    """One call longer than the ring, ragged call lengths, and T = 1, against
    a float64 direct convolution: the extended-buffer formulation and the
    chronological ring write."""
    rng = np.random.default_rng(72)
    b = 32
    ir = _mk(rng, b * 7)
    x = rng.standard_normal(b * 60).astype(np.float32)
    conv = CudaStreamingConvolver(ir, b, len(ir), chunk=4, device="cpu")
    assert conv.cfg.seg_count == 8
    y = torch.cat([conv.process(x[lo * b:hi * b])
                   for lo, hi in [(0, 1), (1, 21), (21, 34), (34, 35), (35, 60)]])
    want = np.convolve(x.astype(np.float64), ir.astype(np.float64))[:len(x)]
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5)
    assert conv.state.w == 60 % 8


def test_streaming_serving_matches_pallas():
    """CudaStreamingConvolver on the CPU against PallasStreamingConvolver in
    interpret mode across calls (ring persistence and wrap), a live update
    (ring kept, overlap zeroed) and reset repeatability; and against the
    port's FFTConvolver at the documented padded length (as
    tests/test_pallas.py holds the JAX one against its engine)."""
    rng = np.random.default_rng(40)
    b = 64
    ir = _mk(rng, b * 21 - 37)
    ir_b = _mk(rng, b * 10)
    x = rng.standard_normal(b * 56).astype(np.float32)
    ref = PallasStreamingConvolver(ir, b, len(ir), chunk=8, interpret=True)
    conv = CudaStreamingConvolver(ir, b, len(ir), chunk=8, device="cpu")
    n = conv.cfg.seg_count
    assert n == ref.cfg.seg_count == 24
    eng = FFTConvolver(ir, b, n * b, device="cpu")
    for lo, hi in [(0, 20), (20, 21), (21, 56)]:  # > 2 ring periods
        y = conv.process(x[lo * b:hi * b]).numpy()
        np.testing.assert_allclose(y, ref.process(x[lo * b:hi * b]), atol=F32_ATOL,
                                   err_msg=f"{lo}:{hi}")
        np.testing.assert_allclose(y, eng.process(x[lo * b:hi * b]).numpy(), atol=F32_ATOL)

    conv.update(ir_b)
    ref.update(ir_b)
    eng.update(np.pad(ir_b, (0, n * b - len(ir_b))))  # the same active count
    y = conv.process(x[:16 * b]).numpy()
    np.testing.assert_allclose(y, ref.process(x[:16 * b]), atol=F32_ATOL)
    np.testing.assert_allclose(y, eng.process(x[:16 * b]).numpy(), atol=F32_ATOL)

    conv.reset()
    y1 = conv.process(x[:8 * b])
    conv.reset()
    np.testing.assert_array_equal(conv.process(x[:8 * b]).numpy(), y1.numpy())


def test_streaming_packed_matches_f32():
    """storage="bf16_packed" on the streaming wrapper: within bf16 tolerance
    of the f32 wrapper and of PallasStreamingConvolver's packed form;
    update, reset, clone and multi-call contracts intact."""
    rng = np.random.default_rng(46)
    b = 64
    ir = _mk(rng, b * 21 - 37)
    ir_b = _mk(rng, b * 10)
    x = rng.standard_normal(b * 40).astype(np.float32)
    conv = CudaStreamingConvolver(ir, b, len(ir), chunk=8, storage="bf16_packed", device="cpu")
    f32 = CudaStreamingConvolver(ir, b, len(ir), chunk=8, device="cpu")
    ref = PallasStreamingConvolver(ir, b, len(ir), chunk=8, interpret=True,
                                   storage="bf16_packed")
    assert conv.consts.irrev.dtype == torch.bfloat16
    assert conv.state.ring.dtype == torch.complex64  # only the table is bf16
    for lo, hi in [(0, 20), (20, 40)]:
        y = conv.process(x[lo * b:hi * b]).numpy()
        _rel(y, f32.process(x[lo * b:hi * b]).numpy(), f"{lo}:{hi}")
        np.testing.assert_allclose(y, ref.process(x[lo * b:hi * b]), atol=F32_ATOL)

    for c in (conv, f32):
        c.update(ir_b)
    _rel(conv.process(x[:16 * b]).numpy(), f32.process(x[:16 * b]).numpy())

    conv.reset()
    y1 = conv.process(x[:8 * b])
    conv.reset()
    np.testing.assert_array_equal(conv.process(x[:8 * b]).numpy(), y1.numpy())
    twin = conv.clone()
    np.testing.assert_array_equal(twin.process(x[:8 * b]).numpy(),
                                  conv.process(x[:8 * b]).numpy())
    with pytest.raises(ValueError, match="storage"):
        CudaStreamingConvolver(ir, b, len(ir), storage="fp8", device="cpu")


def test_streaming_contracts():
    rng = np.random.default_rng(73)
    b = 64
    ir = _mk(rng, b * 5)
    x = rng.standard_normal(b * 12).astype(np.float32)
    conv = CudaStreamingConvolver(ir, b, len(ir), chunk=4, device="cpu")
    assert conv.cfg.seg_count == 8 and conv.chunk == 4
    with pytest.raises(ValueError, match="block-aligned"):
        conv.process(x[:b + 1])
    assert conv.process(x[:0]).shape == (0,)
    with pytest.raises(ValueError):
        conv.update(np.ones(len(ir) + 1, np.float32))  # past the declared maximum
    with pytest.raises(ValueError):
        CudaStreamingConvolver(ir, b, len(ir) - 1, device="cpu")
    # the TPU's VMEM limit is not carried: a 30 s IR's table builds
    assert CudaStreamingConvolver(np.ones(10, np.float32), 128, 48000 * 30,
                                  device="cpu").cfg.seg_count \
        == 11264
    conv.process(x[:5 * b])
    snap = conv.snapshot()
    twin = conv.clone()
    twin.update(_mk(rng, b * 2))
    twin.process(x[:7 * b])
    y1 = conv.process(x[5 * b:])
    conv.restore(snap)
    np.testing.assert_array_equal(conv.process(x[5 * b:]).numpy(), y1.numpy())


# ---- kernel B1p -----------------------------------------------------------------

def test_b1p_plain_matches_pallas_from_carried_state():
    """Kernel B1p's plain version from the bf16 state the packed Pallas step
    reached (interpret mode), through the ring's wrap.  New ring rows come
    from two libraries' DFTs and may round to neighbouring bf16 values."""
    rng = np.random.default_rng(74)
    b = 64
    ir = _mk(rng, b * 6)
    cfg, js = juni.init(ir, b, len(ir))
    jconsts, jp = pallas_engine.from_uniform_packed(cfg, js)
    for _ in range(3):
        jp, _ = pallas_engine.block_step_packed(cfg, jconsts, jp, jnp.asarray(
            rng.standard_normal(b).astype(np.float32)), interpret=True)
    consts, st = interop.fdl_packed(jconsts, jp)
    assert st.segments.dtype == consts.ir.dtype == torch.bfloat16
    assert st.current == int(jp.current[0]) == 3 and st.ticket is None
    for t in range(8):
        x = rng.standard_normal(b).astype(np.float32)
        jp, jy = pallas_engine.block_step_packed(cfg, jconsts, jp, jnp.asarray(x),
                                                 interpret=True)
        y = cuda_engine.block_step_packed(consts, st, torch.from_numpy(x))  # CPU: plain
        _rel(y.numpy(), jy, f"block {t}")
        assert st.current == int(jp.current[0])


def test_packed_serving_convolver():
    """CudaFFTConvolver(storage="bf16_packed"): within bf16 tolerance of the
    f32 engine and of PallasFFTConvolver's packed storage (interpret mode);
    update keeps the bf16 ring and zeroes the overlap; reset repeats
    bit-exactly (as tests/test_pallas.py holds the JAX one)."""
    rng = np.random.default_rng(44)
    b = 64
    ir = _mk(rng, b * 12)
    x = rng.standard_normal(b * 24).astype(np.float32)
    conv = CudaFFTConvolver(ir, b, len(ir), storage="bf16_packed", device="cpu")
    ref = PallasFFTConvolver(ir, b, len(ir), interpret=True, storage="bf16_packed")
    eng = FFTConvolver(ir, b, len(ir), device="cpu")
    assert conv.state.segments.dtype == torch.bfloat16
    y = torch.cat([conv.process(x[i * b:(i + 1) * b]) for i in range(16)]).numpy()
    y_ref = np.concatenate([ref.process(x[i * b:(i + 1) * b]) for i in range(16)])
    _rel(y, eng.process(x[:16 * b]).numpy())
    _rel(y, y_ref)

    ir_b = _mk(rng, b * 12)
    conv.update(ir_b)
    eng.update(ir_b)
    y2 = torch.cat([conv.process(x[i * b:(i + 1) * b]) for i in range(16, 24)]).numpy()
    _rel(y2, eng.process(x[16 * b:]).numpy())

    conv.reset()
    r1 = torch.cat([conv.process(x[i * b:(i + 1) * b]) for i in range(4)])
    conv.reset()
    r2 = torch.cat([conv.process(x[i * b:(i + 1) * b]) for i in range(4)])
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    twin = conv.clone()
    twin.update(ir)  # the twin's update leaves the original's table alone
    assert not torch.equal(twin.consts.ir, conv.consts.ir)


# ---- storage="auto" -----------------------------------------------------------

def test_storage_auto_rule():
    """``auto`` resolves by the port's one rule (serving.resolve_storage):
    bf16 for the device-bound streaming wrapper, float32 for the host-bound
    per-block wrapper; explicit storages pass through, others are refused.
    (The JAX package's rule, f32 wherever it fits VMEM and packed always
    for the streamer, is a TPU rule and is not carried.)"""
    rng = np.random.default_rng(80)
    ir = _mk(rng, 2 * 128)
    assert serving.resolve_storage("auto", streaming=True) == "bf16_packed"
    assert serving.resolve_storage("auto", streaming=False) == "float32"
    for s in ("float32", "bf16_packed"):
        for streaming in (False, True):
            assert serving.resolve_storage(s, streaming) == s
    uni = CudaFFTConvolver(ir, 128, len(ir), storage="auto", device="cpu")
    assert uni.storage == "float32" and uni.consts.ir.dtype == torch.complex64
    st = CudaStreamingConvolver(ir, 128, len(ir), storage="auto", device="cpu")
    assert st.storage == "bf16_packed" and st.consts.irrev.dtype == torch.bfloat16
    assert st._step is cuda_stream.stream_packed
    with pytest.raises(ValueError, match="storage"):
        serving.resolve_storage("f16", streaming=True)
