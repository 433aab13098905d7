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
    assert st.current == int(jp.current[0]) == 2 and st.ticket is None
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
    conv = CudaTwoStageConvolver(ir, b, len(ir), device="cpu")
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
        # no tail0: use the uniform one
        CudaTwoStageConvolver(np.ones(64, np.float32), 64, 64, device="cpu")
    with pytest.raises(ValueError):
        CudaTwoStageConvolver(ir, 48, len(ir), device="cpu")  # not a power of two
    with pytest.raises(ValueError):
        PallasTwoStageConvolver(np.ones(64, np.float32), 64, 64)


def _near(got, want, what):
    """Within SLICE_ATOL of the larger of 1 and ``want``'s magnitude."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SLICE_ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _state_matches_pallas(conv, ref, what):
    """``conv.snapshot()`` (the rotated buffers seen through their names)
    against the JAX wrapper's state: B2's ring and overlaps, the big tail's
    engine, the five period buffers and the row."""
    fstate, tail, bufs, row = conv.snapshot()
    assert row == ref.row, what
    _, jf = interop.fused_head(ref.consts, ref.fstate)
    for f in ("segments", "head_overlap", "t0_overlap"):
        _near(getattr(fstate, f), getattr(jf, f), f"{what}: {f}")
    assert fstate.current == jf.current, what
    jt = interop.uniform_state(ref.tail_state)
    for f in ("segments", "pre_multiplied", "overlap"):
        _near(getattr(tail, f), getattr(jt, f), f"{what}: tail {f}")
    assert (tail.current, tail.input_fill) == (jt.current, jt.input_fill), what
    for k in cuda_two_stage.BUFFERS:
        _near(bufs[k], ref.buffers[k], f"{what}: {k}")


def _snapshots_equal(a, b):
    """Two CudaTwoStageConvolver snapshots hold the same bits."""
    (fa, ta, ba, ra), (fb, tb, bb, rb) = a, b
    assert ra == rb and fa.current == fb.current and ta.current == tb.current
    for x, y in ([(getattr(fa, f), getattr(fb, f)) for f in ("segments", "head_overlap",
                                                              "t0_overlap")]
                 + [(getattr(ta, f), getattr(tb, f)) for f in ("segments", "pre_multiplied",
                                                               "overlap")]
                 + [(ba[k], bb[k]) for k in cuda_two_stage.BUFFERS]):
        assert torch.equal(x, y)


def _small_two_stage(seed):
    """Block 32, a 2500-tap IR: period 8, big tail of 8 segments at 256."""
    rng = np.random.default_rng(seed)
    ir = rng.standard_normal(2500).astype(np.float32) * 0.05
    return ir, rng.standard_normal((120, 32)).astype(np.float32)


def test_two_stage_rotation_matches_pallas_through_period_ends():
    """CudaTwoStageConvolver on the CPU (the big tail in line, period
    buffers rotating by a phase index) against PallasTwoStageConvolver in
    interpret mode over 10 periods, the big tail's ring wrapping: every
    output, and the whole state right after period ends and mid-period."""
    ir, x = _small_two_stage(36)
    ref = PallasTwoStageConvolver(ir, 32, len(ir), interpret=True)
    conv = CudaTwoStageConvolver(ir, 32, len(ir), device="cpu")
    p = conv.cfg.period
    assert (p, conv.cfg.tail_block, conv.cfg.tail.seg_count) == (8, 256, 8)
    for t in range(10 * p):
        np.testing.assert_allclose(conv.process(x[t]).numpy(), np.asarray(ref.process(x[t])),
                                   atol=SLICE_ATOL, err_msg=f"block {t}")
        if t in (p - 1, 3 * p - 1, 4 * p + 2, 9 * p - 1):  # three period ends, one mid-period
            _state_matches_pallas(conv, ref, f"after block {t}")
    assert (conv.tail_inline, conv.tail_replays) == (10, 0)
    assert conv.side_stream is None


@pytest.mark.parametrize("at", [11, 16], ids=["mid-period", "after-period-end"])
def test_two_stage_copies_at_period_edges_replay_bit_equal(at):
    """snapshot / restore / clone taken mid-period and on the block right
    after a period end (row 0: the big tail has just run), then three
    periods replayed: bit-equal to the run they were taken from."""
    ir, x = _small_two_stage(37)
    conv = CudaTwoStageConvolver(ir, 32, len(ir), device="cpu")
    p = conv.cfg.period
    for t in range(at):
        conv.process(x[t])
    assert conv.row == at % p
    snap = conv.snapshot()
    twin = conv.clone()
    assert twin.tail_inline == 0
    ys = torch.stack([conv.process(xb) for xb in x[at:at + 3 * p]])
    conv.restore(snap)
    assert conv.row == at % p
    _snapshots_equal(conv.snapshot(), snap)  # restore, then snapshot: the same state
    assert torch.equal(ys, torch.stack([conv.process(xb) for xb in x[at:at + 3 * p]]))
    assert torch.equal(ys, torch.stack([twin.process(xb) for xb in x[at:at + 3 * p]]))
    # the snapshot is a value copy: the runs after it left it as it was
    conv.restore(snap)
    assert torch.equal(ys[:p], torch.stack([conv.process(xb) for xb in x[at:at + p]]))


def test_two_stage_reset_after_period_end_matches_fresh():
    """reset on the block right after a period end (the big tail's output
    just written, its ring advanced): the next three periods are bit-equal
    to a fresh wrapper's, and the state to a fresh snapshot."""
    ir, x = _small_two_stage(38)
    conv = CudaTwoStageConvolver(ir, 32, len(ir), device="cpu")
    p = conv.cfg.period
    for t in range(2 * p):
        conv.process(x[t])
    assert conv.row == 0 and conv.tail_state.current != 0
    conv.reset()
    fresh = CudaTwoStageConvolver(ir, 32, len(ir), device="cpu")
    for got, want in zip(conv.snapshot()[2].values(), fresh.snapshot()[2].values()):
        assert torch.equal(got, want)
    assert conv.tail_state.current == fresh.tail_state.current == 0
    assert torch.equal(torch.stack([conv.process(xb) for xb in x[:3 * p]]),
                       torch.stack([fresh.process(xb) for xb in x[:3 * p]]))


def test_serving_restore_refuses_bad_state():
    """A snapshot whose tensors are not what the kernel (or the big tail)
    reads is refused at restore, and the wrapper keeps its state: it runs
    on bit-equal to a clone taken before."""
    ir, x = _small_two_stage(39)
    two = CudaTwoStageConvolver(ir, 32, len(ir), device="cpu")
    uni = CudaFFTConvolver(ir, 32, len(ir), device="cpu")
    for t in range(5):
        two.process(x[t])
        uni.process(x[t])
    fstate, tail, bufs, row = two.snapshot()
    short = tail.clone()
    short.segments = short.segments[:-1].clone()
    bad_two = [(fstate.clone(), tail, {**bufs, "precalc": bufs["precalc"].double()}, row),
               (fstate.clone(), short, bufs, row),
               (fstate.clone(), tail, bufs, two.cfg.period),
               (cuda_two_stage.FusedState(fstate.segments[:, :-1].clone(), fstate.head_overlap,
                                          fstate.t0_overlap, fstate.current), tail, bufs, row)]
    st = uni.snapshot()
    bad_uni = [cuda_engine.FDLState(st.segments.to(torch.complex128), st.overlap, st.current),
               cuda_engine.FDLState(st.segments, st.overlap, st.segments.shape[0])]
    for conv, bad in ((two, bad_two), (uni, bad_uni)):
        twin = conv.clone()
        for snap in bad:
            with pytest.raises(ValueError):
                conv.restore(snap)
        assert torch.equal(torch.stack([conv.process(xb) for xb in x[5:30]]),
                           torch.stack([twin.process(xb) for xb in x[5:30]]))


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
    with pytest.raises(ValueError, match="storage"):
        CudaFFTConvolver(ir, b, len(ir), storage="int8", device="cpu")


def test_uniform_serving_copies_start_without_a_ticket():
    """Kernels B1 and B1p keep an arrival counter in the state, made at its
    first launch; no two states share one: ``FDLState.clone``,
    ``CudaFFTConvolver.clone``, ``snapshot`` and ``restore`` hand out states
    without one, and ``reset`` keeps the state's own."""
    rng = np.random.default_rng(35)
    b = 64
    ir = rng.standard_normal(b * 3).astype(np.float32) * 0.1
    conv = CudaFFTConvolver(ir, b, len(ir), device="cpu")
    assert conv.state.ticket is None
    cpu = torch.device("cpu")
    ticket = cuda_engine.step_ticket(conv.state, cpu)  # as the first launch makes it
    assert ticket.dtype == torch.int32 and int(ticket) == 0
    assert cuda_engine.step_ticket(conv.state, cpu) is ticket
    copy = conv.state.clone()
    assert copy.ticket is None
    assert cuda_engine.step_ticket(copy, cpu).data_ptr() != ticket.data_ptr()
    twin = conv.clone()
    assert twin.state.ticket is None and conv.state.ticket is ticket
    snap = conv.snapshot()
    assert snap.ticket is None
    conv.reset()
    assert conv.state.ticket is ticket
    conv.restore(snap)
    assert conv.state.ticket is None and conv.state is not snap


@pytest.mark.parametrize("lo", range(1, 11265, 1024))
def test_step_split_covers_the_other_rows(lo):
    """``step_split(n)`` for every n from 1 to 11264 (the 30 s stream's
    ring), 1024 a case: MAC block g covers rows [(g-1) rows, g rows) of the
    n - 1 rows other than ``current``; together they cover all of them, the
    last is not empty, each has at least 8 rows, and with the block that
    computes the fresh spectrum there are at most 132 blocks (one an SM of
    an H100)."""
    for n in range(lo, min(lo + 1024, 11265)):
        rows, grid = cuda_engine.step_split(n)
        assert rows >= 8 and 1 + grid <= 132, n
        assert (grid - 1) * rows < n - 1 <= grid * rows, n


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
