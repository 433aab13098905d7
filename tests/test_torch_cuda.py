"""Kernels B1, B1p, B2, B3 and B4 on the card against their plain PyTorch
versions.

These need an NVIDIA card with nvcc (``sm_90a``) and skip elsewhere.  The
repository's ``tests/conftest.py`` imports JAX; where JAX is not installed,
run them without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from fft_convolution_tpu_torch.models import crossfade, uniform
from fft_convolution_tpu_torch.ops import cuda_crossfade, cuda_engine, cuda_stream, cuda_two_stage
from fft_convolution_tpu_torch.serving import (CudaCrossfadeConvolver, CudaFFTConvolver,
                                               CudaStreamingConvolver, CudaTwoStageConvolver)

pytestmark = pytest.mark.cuda

# The kernels' direct float32 DFTs against cuFFT's: a few 1e-6 apart per
# block at outputs of magnitude ~1 (chip_smoke.py's flagship run), growing
# with the magnitude and the transform length.  1e-5 of the larger of 1 and
# the output's magnitude is the JAX package's kernel-vs-engine tolerance.
RTOL = 1e-5


def _close(got, want, what):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, f"{what}: {err} at scale {scale}"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _b1_operands(b, n, dev, seed):
    rng = np.random.default_rng(seed)
    ir = (rng.standard_normal(b * n) * 0.1).astype(np.float32)
    cfg, st = uniform.init(torch.from_numpy(ir).to(dev), b, len(ir), dev)
    return cuda_engine.from_uniform(cfg, st), rng


@pytest.mark.parametrize("b,n", [(64, 37), (128, 5), (32, 1), (128, 600), (2048, 3)])
def test_b1_kernel_matches_plain(dev, b, n):
    (consts, st), rng = _b1_operands(b, n, dev, 70 + n)
    plain = st.clone()
    for t in range(n + 3):  # through the ring's wrap
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        y = cuda_engine.block_step(consts, st, x)
        yp = cuda_engine.block_step_plain(consts, plain, x)
        torch.cuda.synchronize()
        _close(y, yp, f"block {t}")
        assert st.current == plain.current
    _close(st.segments, plain.segments, "ring")
    _close(st.overlap, plain.overlap, "overlap")


@pytest.mark.parametrize("b,n", [(64, 16), (128, 64), (2048, 2)])
def test_b2_kernel_matches_plain(dev, b, n):
    rng = np.random.default_rng(80 + n)
    h = torch.fft.rfft(torch.from_numpy((rng.standard_normal((n, b)) * 0.1)
                                        .astype(np.float32)), n=2 * b).to(dev)
    t0 = torch.fft.rfft(torch.from_numpy((rng.standard_normal((n, b)) * 0.1)
                                         .astype(np.float32)), n=2 * b).to(dev)
    consts = cuda_two_stage.build_consts(h, t0)
    st, plain = cuda_two_stage.zero_state(n, b, dev), cuda_two_stage.zero_state(n, b, dev)
    bufs = {k: torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32)).to(dev)
            for k in cuda_two_stage.BUFFERS}
    pbufs = {k: v.clone() for k, v in bufs.items()}
    for t in range(n + 3):
        row = t % n
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        y = cuda_two_stage.block_step(consts, st, bufs, row, x)
        yp = cuda_two_stage.block_step_plain(consts, plain, pbufs, row, x)
        torch.cuda.synchronize()
        _close(y, yp, f"block {t}")
        for k in cuda_two_stage.BUFFERS:
            _close(bufs[k], pbufs[k], k)


def test_kernels_replay_bit_exact(dev):
    """Fixed-order sums, no atomics: a replay after restore is bit-equal."""
    rng = np.random.default_rng(90)
    ir = (rng.standard_normal(9000) * 0.05).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((80, 64)).astype(np.float32)).to(dev)
    for conv in (CudaFFTConvolver(ir, 64, len(ir), device=dev),
                 CudaTwoStageConvolver(ir, 64, len(ir), device=dev)):
        for xb in x[:10]:
            conv.process(xb)
        snap = conv.snapshot()
        y1 = torch.stack([conv.process(xb) for xb in x[10:]])
        conv.restore(snap)
        y2 = torch.stack([conv.process(xb) for xb in x[10:]])
        assert torch.equal(y1, y2)
        conv.reset()
        y3 = torch.stack([conv.process(xb) for xb in x])
        conv.reset()
        assert torch.equal(y3, torch.stack([conv.process(xb) for xb in x]))


def test_serving_wrappers_on_card_match_cpu(dev):
    rng = np.random.default_rng(91)
    b = 64
    ir = (rng.standard_normal(9000) * 0.05).astype(np.float32)
    ir2 = (rng.standard_normal(4000) * 0.05).astype(np.float32)
    x = rng.standard_normal((80, b)).astype(np.float32)
    pairs = [(CudaTwoStageConvolver(ir, b, len(ir), device=dev),
              CudaTwoStageConvolver(ir, b, len(ir), device="cpu")),
             (CudaFFTConvolver(ir, b, len(ir), device=dev),
              CudaFFTConvolver(ir, b, len(ir), device="cpu"))]
    for gpu, cpu in pairs:
        for t in range(80):
            if t == 40 and isinstance(gpu, CudaFFTConvolver):
                gpu.update(ir2)
                cpu.update(ir2)
            y = gpu.process(x[t]).cpu()
            # 5 tail periods of 16 blocks: the big tail's longer transforms
            # widen the gap, held to the JAX package's slice tolerance
            np.testing.assert_allclose(y.numpy(), cpu.process(x[t]).numpy(), atol=2e-5,
                                       err_msg=f"{type(gpu).__name__} block {t}")


def test_kernel_rejects_bad_operands(dev):
    (consts, st), _ = _b1_operands(64, 4, dev, 92)
    with pytest.raises(ValueError):
        cuda_engine.block_step(consts, st, torch.zeros(64, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        cuda_engine.block_step(consts, st, torch.zeros(128, device=dev)[::2])
    with pytest.raises(ValueError):
        cuda_engine.block_step(consts, st, torch.zeros(32, device=dev))
    bad = cuda_engine.FDLConsts(ir=consts.ir.cpu(), tw=consts.tw)
    with pytest.raises(ValueError):
        cuda_engine.block_step(bad, st, torch.zeros(64, device=dev))


def _spectra(rng, n, b, dev, scale=0.1):
    taps = (rng.standard_normal((n, b)) * scale).astype(np.float32)
    return torch.fft.rfft(torch.from_numpy(taps), n=2 * b).to(dev)


@pytest.mark.parametrize("b,n", [(64, 37), (128, 5), (32, 1), (128, 600), (2048, 3)])
def test_b1p_kernel_matches_plain(dev, b, n):
    """B1p from the same bf16 state each step: the output to the f32
    tolerance, the ring row written to within one bf16 step (the two DFTs
    may round a bin to neighbouring bf16 values)."""
    rng = np.random.default_rng(100 + n)
    ir = (rng.standard_normal(b * n) * 0.1).astype(np.float32)
    cfg, ust = uniform.init(torch.from_numpy(ir).to(dev), b, len(ir), dev)
    consts, st = cuda_engine.from_uniform(cfg, ust, "bf16_packed")
    for t in range(n + 3):  # through the ring's wrap
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        plain = st.clone()
        cur = st.current
        y = cuda_engine.block_step_packed(consts, st, x)
        yp = cuda_engine.block_step_plain(consts, plain, x)
        torch.cuda.synchronize()
        _close(y, yp, f"block {t}")
        row, prow = cuda_engine.as_c64(st.segments[cur]), cuda_engine.as_c64(plain.segments[cur])
        assert float((row - prow).abs().max()) <= 2 ** -7 * float(prow.abs().max())
        assert st.current == plain.current
        _close(st.overlap, plain.overlap, "overlap")


@pytest.mark.parametrize("b,n,mixer", [(64, 16, "raised_cosine"), (128, 300, "sqrt"),
                                       (32, 1, "linear"), (2048, 2, "cosine")])
def test_b3_kernel_matches_plain(dev, b, n, mixer):
    """B3 through hold, ramp, snap and a mid-ramp reversal, every mixer."""
    rng = np.random.default_rng(110 + n)
    consts = cuda_crossfade.build_consts(_spectra(rng, n, b, dev), _spectra(rng, n, b, dev))
    st, plain = cuda_crossfade.zero_state(n, b, dev), cuda_crossfade.zero_state(n, b, dev)
    cfg = crossfade.CrossfaderConfig(fading_samples=3 * b + 5, hold_samples=b // 2 + 3,
                                     mixer=mixer)
    cf = cfp = crossfade.new_state(cfg)
    for t in range(n + 12):
        if t in (2, 5):  # a fade, then a reversal mid-ramp
            target = crossfade.TARGET_B if t == 2 else crossfade.TARGET_A
            cf = cfp = crossfade.fade_into(cfg, cf, target)
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        cf, y = cuda_crossfade.block_step(consts, st, cfg, cf, x)
        cfp, yp = cuda_crossfade.block_step_plain(consts, plain, cfg, cfp, x)
        torch.cuda.synchronize()
        _close(y, yp, f"block {t}")
        assert cf == cfp and st.current == plain.current
    _close(st.segments, plain.segments, "ring")
    _close(st.overlap_a, plain.overlap_a, "overlap_a")
    _close(st.overlap_b, plain.overlap_b, "overlap_b")


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,calls", [(64, 24, (13, 1, 37, 8)), (128, 512, (64, 64, 700)),
                                       (32, 1, (3, 5)), (2048, 4, (9, 2))])
def test_b4_kernel_matches_plain(dev, packed, b, n, calls):
    """B4 over call lengths that are not multiples of 8 or of the tile, that
    exceed the ring (T > N: old rows overwritten within the call), and
    through the ring's wrap; ring, w and overlap follow the plain version."""
    rng = np.random.default_rng(120 + n)
    consts = cuda_stream.build_consts(_spectra(rng, n, b, dev), packed)
    st, plain = cuda_stream.zero_state(n, b, dev), cuda_stream.zero_state(n, b, dev)
    step = cuda_stream.stream_packed if packed else cuda_stream.stream
    for t_len in calls:
        x = torch.from_numpy(rng.standard_normal((t_len, b)).astype(np.float32)).to(dev)
        y = step(consts, st, x)
        yp = cuda_stream.stream_plain(consts, plain, x)
        torch.cuda.synchronize()
        _close(y, yp, f"T={t_len}")
        assert st.w == plain.w
        _close(st.ring, plain.ring, "ring")
        _close(st.overlap, plain.overlap, "overlap")


def test_new_kernels_replay_bit_exact(dev):
    """Fixed-order sums, no atomics: replays after reset and restore are
    bit-equal for B1p, B3 and both B4 forms."""
    rng = np.random.default_rng(130)
    b = 64
    ir = (rng.standard_normal(6000) * 0.05).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((40, b)).astype(np.float32)).to(dev)
    xc = x.reshape(-1)
    convs = [CudaFFTConvolver(ir, b, len(ir), device=dev, storage="bf16_packed"),
             CudaCrossfadeConvolver(ir, b, len(ir), crossfade_samples=3 * b, device=dev)]
    for conv in convs:
        conv.process(x[0])
        conv.update(ir[::-1].copy())  # a fade for the crossfade convolver
        snap = conv.snapshot()
        y1 = torch.stack([conv.process(xb) for xb in x[1:]])
        conv.restore(snap)
        assert torch.equal(y1, torch.stack([conv.process(xb) for xb in x[1:]]))
    for storage in ("float32", "bf16_packed"):
        conv = CudaStreamingConvolver(ir, b, len(ir), chunk=16, device=dev, storage=storage)
        y1 = torch.cat([conv.process(xc[:b * 13]), conv.process(xc[b * 13:])])
        conv.reset()
        assert torch.equal(y1, torch.cat([conv.process(xc[:b * 13]),
                                          conv.process(xc[b * 13:])]))


def test_new_wrappers_on_card_match_cpu(dev):
    rng = np.random.default_rng(131)
    b = 64
    ir = (rng.standard_normal(3000) * 0.05).astype(np.float32)
    ir2 = (rng.standard_normal(2000) * 0.05).astype(np.float32)
    x = rng.standard_normal((40, b)).astype(np.float32)
    cases = [(CudaCrossfadeConvolver(ir, b, len(ir), 2 * b, device=dev),
              CudaCrossfadeConvolver(ir, b, len(ir), 2 * b, device="cpu"), 1),
             (CudaStreamingConvolver(ir, b, len(ir), chunk=8, device=dev),
              CudaStreamingConvolver(ir, b, len(ir), chunk=8, device="cpu"), 2)]
    for gpu, cpu, per_call in cases:
        for t in range(0, 40, per_call):
            if t == 20:
                gpu.update(ir2)
                cpu.update(ir2)
            xb = x[t:t + per_call].reshape(-1)
            np.testing.assert_allclose(gpu.process(xb).cpu().numpy(), cpu.process(xb).numpy(),
                                       atol=2e-5, err_msg=f"{type(gpu).__name__} block {t}")


def test_new_kernels_reject_bad_operands(dev):
    rng = np.random.default_rng(132)
    b, n = 64, 4
    cfg = crossfade.CrossfaderConfig(b, b)
    xc = cuda_crossfade.build_consts(_spectra(rng, n, b, dev), _spectra(rng, n, b, dev))
    xs = cuda_crossfade.zero_state(n, b, dev)
    with pytest.raises(ValueError):
        cuda_crossfade.block_step(xc, xs, cfg, crossfade.new_state(cfg),
                                  torch.zeros(b, dtype=torch.float64, device=dev))
    bad = cuda_crossfade.XfadeConsts(xc.ir_a, xc.ir_b[:2], xc.tw)
    with pytest.raises(ValueError):
        cuda_crossfade.block_step(bad, xs, cfg, crossfade.new_state(cfg),
                                  torch.zeros(b, device=dev))
    sc = cuda_stream.build_consts(_spectra(rng, n, b, dev), packed=False)
    ss = cuda_stream.zero_state(n, b, dev)
    with pytest.raises(ValueError):  # an f32 table given to the packed form
        cuda_stream.stream_packed(sc, ss, torch.zeros((3, b), device=dev))
    with pytest.raises(ValueError):  # not contiguous
        cuda_stream.stream(sc, ss, torch.zeros((b, 3), device=dev).t())
    with pytest.raises(ValueError):
        cuda_stream.stream(sc, ss, torch.zeros((0, b), device=dev))
    (consts, st), _ = _b1_operands(b, n, dev, 133)
    with pytest.raises(ValueError):  # complex64 storage given to B1p
        cuda_engine.block_step_packed(consts, st, torch.zeros(b, device=dev))
