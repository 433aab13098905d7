"""The port's serving slice on the CPU: the plain versions of kernels B1 and B2
against the JAX package's Pallas kernels in interpret mode, from states
carried over by ``interop``, and the serving wrappers against the JAX
package's Pallas wrappers, on the same numpy-seeded inputs."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_convolution_tpu.models import two_stage as jtwo
from fft_convolution_tpu.models import uniform as juni
from fft_convolution_tpu.ops import pallas_engine, pallas_two_stage
from fft_convolution_tpu.serving import PallasFFTConvolver, PallasTwoStageConvolver
from fft_convolution_tpu_torch import interop
from fft_convolution_tpu_torch.models import uniform as tuni
from fft_convolution_tpu_torch.ops import cuda_engine, cuda_two_stage
from fft_convolution_tpu_torch.serving import CudaFFTConvolver, CudaTwoStageConvolver

# One block step: the Pallas kernel's float32 basis-matmul DFTs against
# pocketfft agree to a few 1e-7 on these unit-variance blocks; 1e-5 is the
# JAX package's own kernel-vs-engine tolerance (tests/test_pallas.py).
STEP_ATOL = 1e-5
# The two-stage serving slice over 80 blocks adds the big tail's 2x-longer
# transforms; the JAX package holds its own wrapper to the same 2e-5
# (tests/test_pallas.py::test_pallas_two_stage_serving).
SLICE_ATOL = 2e-5


def test_b1_plain_matches_pallas_from_carried_state():
    rng = np.random.default_rng(60)
    b = 64
    ir = (rng.standard_normal(b * 5) * 0.1).astype(np.float32)
    cfg, js = juni.init(ir, b, len(ir))
    jconsts, jp = pallas_engine.from_uniform(cfg, js)
    for _ in range(3):  # mid-stream: current = 2, ring partly written
        jp, _ = pallas_engine.block_step(cfg, jconsts, jp, jnp.asarray(
            rng.standard_normal(b).astype(np.float32)), interpret=True)
    consts, st = interop.fdl(jconsts, jp)
    assert st.current == int(jp.current[0]) == 2
    for t in range(8):  # through the ring's wrap
        x = rng.standard_normal(b).astype(np.float32)
        jp, yj = pallas_engine.block_step(cfg, jconsts, jp, jnp.asarray(x), interpret=True)
        y = cuda_engine.block_step(consts, st, torch.from_numpy(x))  # CPU: plain version
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=STEP_ATOL, err_msg=f"block {t}")
        assert st.current == int(jp.current[0])
    np.testing.assert_allclose(st.overlap.numpy(), np.asarray(jp.overlap)[0], atol=STEP_ATOL)
    # back to the engine state: both packages continue on the sequential path
    js = pallas_engine.to_uniform(cfg, jp, js)
    ts = cuda_engine.to_uniform(st, interop.uniform_state(js))
    assert ts.current == int(js.current)
    x = rng.standard_normal(b).astype(np.float32)
    _, yj = juni.process_block(cfg, js, jnp.asarray(x))
    y = tuni.process_block(tuni.make_config(b, len(ir)), ts, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=STEP_ATOL)


def test_b2_plain_matches_pallas_from_carried_state():
    rng = np.random.default_rng(61)
    b = 32
    ir = (rng.standard_normal(1800) * 0.05).astype(np.float32)
    cfg, js = jtwo.init(ir, b, len(ir))
    n, p = cfg.head.seg_count, cfg.period
    assert cfg.tail0.seg_count == n == p
    jconsts = pallas_two_stage.build_consts(js.head.segments_ir, js.tail0.segments_ir, b)
    jf = pallas_two_stage.FusedHeadState(
        seg_re=jnp.zeros((n, b)), seg_im=jnp.zeros((n, b)),
        head_overlap=jnp.zeros((1, b)), t0_overlap=jnp.zeros((1, b)),
        current=jnp.zeros((1,), jnp.int32))
    pre0 = (rng.standard_normal((p, b)) * 0.1).astype(np.float32)
    pre = (rng.standard_normal((p, b)) * 0.1).astype(np.float32)
    for r in range(5):
        jf, _, _ = pallas_two_stage.block_step(
            n, b, jconsts, jf, jnp.asarray(rng.standard_normal(b).astype(np.float32)),
            jnp.asarray(r, jnp.int32), jnp.asarray(pre0), jnp.asarray(pre), interpret=True)
    consts, st = interop.fused_head(jconsts, jf)
    bufs = {k: torch.zeros((p, b)) for k in cuda_two_stage.BUFFERS}
    bufs["precalc0"], bufs["precalc"] = torch.from_numpy(pre0), torch.from_numpy(pre)
    for r in range(5, 5 + n + 2):  # through the ring's wrap
        row = r % p
        x = rng.standard_normal(b).astype(np.float32)
        jf, yj, out0 = pallas_two_stage.block_step(
            n, b, jconsts, jf, jnp.asarray(x), jnp.asarray(row, jnp.int32),
            jnp.asarray(pre0), jnp.asarray(pre), interpret=True)
        y = cuda_two_stage.block_step(consts, st, bufs, row, torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=STEP_ATOL, err_msg=f"row {row}")
        np.testing.assert_allclose(bufs["tail_output0"][row].numpy(), np.asarray(out0),
                                   atol=STEP_ATOL)
        np.testing.assert_array_equal(bufs["tail_input"][row].numpy(), x)
        assert st.current == int(jf.current[0])


def test_two_stage_serving_slice_matches_pallas():
    """The whole slice: CudaTwoStageConvolver on the CPU against the JAX
    package's PallasTwoStageConvolver in interpret mode, block by block
    across several tail periods (as tests/test_pallas.py holds the JAX one)."""
    rng = np.random.default_rng(33)
    b = 64
    ir = rng.standard_normal(9000).astype(np.float32) * 0.05
    x = rng.standard_normal(b * 80).astype(np.float32)
    ref = PallasTwoStageConvolver(ir, b, len(ir), interpret=True)
    conv = CudaTwoStageConvolver(ir, b, len(ir), device="cpu")
    assert conv.cfg.tail is not None and conv.cfg.period == 16  # 80 blocks = 5 periods
    for t in range(80):
        blk = x[t * b:(t + 1) * b]
        np.testing.assert_allclose(conv.process(blk).numpy(), np.asarray(ref.process(blk)),
                                   atol=SLICE_ATOL, err_msg=f"block {t}")

    conv.reset()
    ys1 = [conv.process(x[t * b:(t + 1) * b]) for t in range(40)]
    conv.reset()
    ys2 = [conv.process(x[t * b:(t + 1) * b]) for t in range(40)]
    np.testing.assert_array_equal(torch.cat(ys1).numpy(), torch.cat(ys2).numpy())


def test_two_stage_serving_contracts():
    rng = np.random.default_rng(34)
    b = 64
    ir = rng.standard_normal(9000).astype(np.float32) * 0.05
    x = rng.standard_normal(b * 80).astype(np.float32)
    conv = CudaTwoStageConvolver(ir, b, len(ir))
    for t in range(30):
        conv.process(x[t * b:(t + 1) * b])
    snap = conv.snapshot()
    twin = conv.clone()
    for t in range(40):  # drive the twin across a period end with other input
        twin.process(x[(79 - t) * b:(80 - t) * b])
    ys = [conv.process(x[t * b:(t + 1) * b]) for t in range(30, 70)]
    conv.restore(snap)
    ys2 = [conv.process(x[t * b:(t + 1) * b]) for t in range(30, 70)]
    np.testing.assert_array_equal(torch.cat(ys).numpy(), torch.cat(ys2).numpy())

    with pytest.raises(NotImplementedError):
        conv.update(ir)
    with pytest.raises(ValueError):
        conv.process(x[:b - 1])
    with pytest.raises(ValueError):
        CudaTwoStageConvolver(np.ones(64, np.float32), 64, 64)  # no tail0: use the uniform one
    with pytest.raises(ValueError):
        CudaTwoStageConvolver(ir, 48, len(ir))                  # not a power of two
    with pytest.raises(ValueError):
        PallasTwoStageConvolver(np.ones(64, np.float32), 64, 64)


def test_uniform_serving_matches_pallas():
    """CudaFFTConvolver on the CPU against PallasFFTConvolver in interpret
    mode: process, update (full ring, overlap dropped), reset, snapshot,
    restore and clone (as tests/test_pallas.py holds the JAX one)."""
    rng = np.random.default_rng(32)
    b = 128
    ir = rng.standard_normal(b * 4).astype(np.float32) * 0.1
    ir2 = rng.standard_normal(b * 2).astype(np.float32) * 0.1
    x = rng.standard_normal(b * 8).astype(np.float32)
    ref = PallasFFTConvolver(ir, b, len(ir), interpret=True)
    conv = CudaFFTConvolver(ir, b, len(ir), device="cpu")
    for t in range(8):
        if t == 4:
            ref.update(ir2)
            conv.update(ir2)
        blk = x[t * b:(t + 1) * b]
        np.testing.assert_allclose(conv.process(blk).numpy(), np.asarray(ref.process(blk)),
                                   atol=STEP_ATOL, err_msg=f"block {t}")

    conv.reset()
    snap = conv.snapshot()
    twin = conv.clone()
    y1 = conv.process(x[:b])
    twin.update(ir)  # an update on the twin leaves the original's table alone
    twin.process(x[b:2 * b])
    conv.restore(snap)
    np.testing.assert_array_equal(conv.process(x[:b]).numpy(), y1.numpy())

    with pytest.raises(ValueError):
        conv.process(x[:b - 1])
    with pytest.raises(ValueError):
        conv.update(np.ones(len(ir) + 1, np.float32))
    with pytest.raises(NotImplementedError, match="B1p"):
        CudaFFTConvolver(ir, b, len(ir), storage="bf16_packed")


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent fallback."""
    consts = cuda_engine.FDLConsts(ir=torch.zeros((3, 9), dtype=torch.complex64, device="meta"),
                                   tw=torch.zeros((16, 2), device="meta"))
    st = cuda_engine.FDLState(torch.zeros((3, 9), dtype=torch.complex64, device="meta"),
                              torch.zeros(8, device="meta"), 0)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_engine.block_step(consts, st, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_two_stage.block_step(None, st, {}, 0, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError):
        cuda_engine.check_block(4096)
    with pytest.raises(ValueError):
        cuda_engine.require(torch.zeros(4, 2).t(), "x", (2, 4), torch.float32,
                            torch.device("cpu"))  # not contiguous


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    card, and also when it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path cannot run here")
    src = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(src.read_bytes())
    for script in (src, alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert proc.stdout == ""
