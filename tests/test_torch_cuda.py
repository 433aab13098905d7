"""Kernels B1 and B2 on the card against their plain PyTorch versions.

These need an NVIDIA card with nvcc (``sm_90a``) and skip elsewhere.  The
repository's ``tests/conftest.py`` imports JAX; where JAX is not installed,
run them without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from fft_convolution_tpu_torch.models import uniform
from fft_convolution_tpu_torch.ops import cuda_engine, cuda_two_stage
from fft_convolution_tpu_torch.serving import CudaFFTConvolver, CudaTwoStageConvolver

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
