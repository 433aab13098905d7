"""Kernels B1, B1p, B2, B3, B4, B5, B6 and B7 on the card against their plain
PyTorch versions; B1-B3 also for their arrival counters (one launch a
step); the mesh forms on two gloo ranks sharing the card; the flagship
batched two-stage call (fused front end, CHRONO tail) on the card.

These need an NVIDIA card with nvcc (``sm_90a``) and skip elsewhere.  The
repository's ``tests/conftest.py`` imports JAX; where JAX is not installed,
run them without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports nothing of JAX.
"""

import contextlib
import importlib.util
import pathlib
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fft_convolution_tpu_torch import ReverbFarm, _build
from fft_convolution_tpu_torch.models import crossfade, uniform
from fft_convolution_tpu_torch.ops import (cuda_crossfade, cuda_engine, cuda_farm_heads,
                                           cuda_farm_mac, cuda_farm_tail, cuda_stream,
                                           cuda_two_stage)
from fft_convolution_tpu_torch.parallel import farm2
from fft_convolution_tpu_torch.serving import (CudaCrossfadeConvolver, CudaFFTConvolver,
                                               CudaStreamingConvolver, CudaTwoStageConvolver)

pytestmark = pytest.mark.cuda

# The kernels' shared-memory float32 FFTs against cuFFT's: a few 1e-6 apart per
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


@contextlib.contextmanager
def _plain(module, *names):
    """The ``ops`` module's wrappers ``names`` swapped for their plain
    versions for the block: what a farm then runs."""
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(module, name, getattr(module, f"{name}_plain")))
        yield


def _b1_operands(b, n, dev, seed):
    rng = np.random.default_rng(seed)
    ir = (rng.standard_normal(b * n) * 0.1).astype(np.float32)
    cfg, st = uniform.init(torch.from_numpy(ir).to(dev), b, len(ir), dev)
    return cuda_engine.from_uniform(cfg, st), rng


@pytest.mark.parametrize("b,n", [(64, 37), (128, 5), (32, 1), (128, 600), (2048, 3),
                                 (128, 3750)])
def test_b1_kernel_matches_plain(dev, b, n):
    """B1 through n + 3 steps (the ring wraps; at n = 1 there is no MAC
    block; at the flagship n = 3750, 130 MAC blocks and one ticket a step):
    the output every step, the arrival counter back at 0 after each."""
    (consts, st), rng = _b1_operands(b, n, dev, 70 + n)
    plain = st.clone()
    for t in range(n + 3):  # through the ring's wrap
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        y = cuda_engine.block_step(consts, st, x)
        yp = cuda_engine.block_step_plain(consts, plain, x)
        torch.cuda.synchronize()
        _close(y, yp, f"block {t}")
        assert st.current == plain.current and int(st.ticket) == 0, f"block {t}"
    _close(st.segments, plain.segments, "ring")
    _close(st.overlap, plain.overlap, "overlap")


def _b2_operands(rng, b, n, dev):
    h = torch.fft.rfft(torch.from_numpy((rng.standard_normal((n, b)) * 0.1)
                                        .astype(np.float32)), n=2 * b).to(dev)
    t0 = torch.fft.rfft(torch.from_numpy((rng.standard_normal((n, b)) * 0.1)
                                         .astype(np.float32)), n=2 * b).to(dev)
    bufs = {k: torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32)).to(dev)
            for k in cuda_two_stage.BUFFERS}
    return cuda_two_stage.build_consts(h, t0), bufs


def _check_b2(st, plain, bufs, pbufs, y, yp, what):
    """Output, ring, both overlaps and the period buffers against the plain
    version; the arrival counter back at 0 after the step."""
    _close(y, yp, what)
    _close(st.segments, plain.segments, f"{what}: ring")
    _close(st.head_overlap, plain.head_overlap, f"{what}: head overlap")
    _close(st.t0_overlap, plain.t0_overlap, f"{what}: tail0 overlap")
    for k in cuda_two_stage.BUFFERS:
        _close(bufs[k], pbufs[k], f"{what}: {k}")
    assert st.current == plain.current and int(st.ticket) == 0, what


@pytest.mark.parametrize("b,n", [(64, 16), (128, 64), (2048, 2), (32, 1)])
def test_b2_kernel_matches_plain(dev, b, n):
    """B2 through 2n + 3 steps (the ring wraps twice; at n = 1 there is no
    MAC block, only the one that computes the fresh spectrum)."""
    rng = np.random.default_rng(80 + n)
    consts, bufs = _b2_operands(rng, b, n, dev)
    st, plain = cuda_two_stage.zero_state(n, b, dev), cuda_two_stage.zero_state(n, b, dev)
    pbufs = {k: v.clone() for k, v in bufs.items()}
    for t in range(2 * n + 3):
        row = t % n
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        y = cuda_two_stage.block_step(consts, st, bufs, row, x)
        yp = cuda_two_stage.block_step_plain(consts, plain, pbufs, row, x)
        torch.cuda.synchronize()
        _check_b2(st, plain, bufs, pbufs, y, yp, f"block {t}")


def test_kernels_replay_bit_exact(dev):
    """Fixed-order sums (B2 orders its partials by block whichever block
    finishes, through an integer ticket; no float atomics): a replay after
    restore is bit-equal."""
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


# ---- B2's big tail off the caller's stream: side stream, CUDA graphs ----------

def _chip_smoke():
    """``chip_smoke.py`` of this checkout, loaded by path (its race gate)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_card_tests", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _two_stage_inputs(seed):
    """Block 64, a 9000-tap IR: period 16, a big tail of 7 segments at 1024."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(9000) * 0.05).astype(np.float32),
            rng.standard_normal((240, 64)).astype(np.float32))


def test_two_stage_race_gate(dev):
    """``chip_smoke.race_gate`` at a small size, from a mid-period state:
    the wrapper as it runs and with its side stream held back 5 ms before
    each period end give outputs and an exit snapshot bit-equal to a twin
    synchronised after every block; one graph replay a period end, none in
    line; the holds slowed the held-back run, so they held."""
    cs = _chip_smoke()
    ir, x = _two_stage_inputs(170)
    conv = CudaTwoStageConvolver(ir, 64, len(ir), device=dev)
    for xb in x[:5]:
        conv.process(xb)
    p = conv.cfg.period
    race = cs.race_gate(conv, x[5:5 + (-conv.row) % p + 6 * p], hold_ms=5.0)
    for mode in cs.RACE_MODES:
        r = race[mode]
        assert r["outputs_bit_equal"] and r["snapshot_bit_equal"], mode
        assert r["replays"] == r["period_ends"] == 7 and r["inline"] == 0, mode
    held = race["side stream held back"]
    assert held["wall_s"] >= (held["period_ends"] - 1) * 5e-3


def test_two_stage_snapshot_after_period_end_matches_synchronised_twin(dev):
    """Card tensors, no synchronisation between blocks: a snapshot on the
    block right after a period end (the big tail just enqueued on the side
    stream) is bit-equal to that of a twin synchronised after every block,
    and so are the outputs."""
    cs = _chip_smoke()
    ir, x = _two_stage_inputs(171)
    xs = torch.from_numpy(x).to(dev)
    conv = CudaTwoStageConvolver(ir, 64, len(ir), device=dev)
    twin = CudaTwoStageConvolver(ir, 64, len(ir), device=dev)
    p = conv.cfg.period
    ys = [conv.process(xb) for xb in xs[:3 * p]]
    snap = conv.snapshot()
    yt = []
    for xb in xs[:3 * p]:
        yt.append(twin.process(xb))
        torch.cuda.synchronize()
    assert conv.row == 0 and conv.tail_replays == twin.tail_replays == 3
    assert conv.tail_inline == twin.tail_inline == 0
    assert torch.equal(torch.stack(ys), torch.stack(yt))
    assert cs.snapshots_equal(snap, twin.snapshot())


def test_two_stage_graphs_captured_again_after_restore_and_reset(dev):
    """restore and reset take fresh tensors and capture the big-tail graphs
    again over them; the replays after each are bit-equal to the run they
    repeat (after restore) and to a fresh wrapper (after reset)."""
    ir, x = _two_stage_inputs(172)
    xs = torch.from_numpy(x).to(dev)
    conv = CudaTwoStageConvolver(ir, 64, len(ir), device=dev)
    p = conv.cfg.period
    graphs = [conv._graphs]
    for xb in xs[:20]:
        conv.process(xb)
    snap = conv.snapshot()
    y1 = torch.stack([conv.process(xb) for xb in xs[20:20 + 3 * p]])
    conv.restore(snap)
    graphs.append(conv._graphs)
    assert torch.equal(y1, torch.stack([conv.process(xb) for xb in xs[20:20 + 3 * p]]))
    conv.reset()
    graphs.append(conv._graphs)
    fresh = CudaTwoStageConvolver(ir, 64, len(ir), device=dev)
    assert torch.equal(torch.stack([conv.process(xb) for xb in xs[:4 * p]]),
                       torch.stack([fresh.process(xb) for xb in xs[:4 * p]]))
    assert all(g is not None for g in graphs) and len({id(g) for g in graphs}) == 3
    assert conv.tail_inline == 0 and conv.tail_replays == 1 + 3 + 3 + 4


def test_serving_restore_refuses_bad_owned_tensors(dev):
    """A snapshot whose tensors are not what the kernel or the big tail reads
    (on the CPU, another dtype, another shape) is refused at restore, not at
    the next block, and the wrapper runs on bit-equal to a clone taken
    before: B2, B1 and B3."""
    ir, x = _two_stage_inputs(173)
    xs = torch.from_numpy(x).to(dev)
    two = CudaTwoStageConvolver(ir, 64, len(ir), device=dev)
    uni = CudaFFTConvolver(ir, 64, len(ir), device=dev)
    xf = CudaCrossfadeConvolver(ir, 64, len(ir), crossfade_samples=128, device=dev)
    for xb in xs[:5]:
        for conv in (two, uni, xf):
            conv.process(xb)
    fstate, tail, bufs, row = two.snapshot()
    short = tail.clone()
    short.segments = short.segments[:-1].clone()
    wide = tail.clone()
    wide.overlap = wide.overlap.double()
    bad_two = [(fstate.clone(), tail, {**bufs, "tail_input": bufs["tail_input"].cpu()}, row),
               (fstate.clone(), short, bufs, row), (fstate.clone(), wide, bufs, row),
               (cuda_two_stage.FusedState(fstate.segments.cpu(), fstate.head_overlap,
                                          fstate.t0_overlap, fstate.current), tail, bufs, row)]
    st = uni.snapshot()
    bad_uni = [cuda_engine.FDLState(st.segments.cpu(), st.overlap, st.current),
               cuda_engine.FDLState(st.segments, st.overlap[:-1].clone(), st.current)]
    consts, xst, cf, stored, pending = xf.snapshot()
    bad_xf = [(cuda_crossfade.XfadeConsts(consts.ir_a, consts.ir_b[:-1].clone(), consts.tw),
               xst, cf, stored, pending),
              (consts, xst, cf, stored.cpu(), pending)]
    for conv, bad in ((two, bad_two), (uni, bad_uni), (xf, bad_xf)):
        twin = conv.clone()
        for snap in bad:
            with pytest.raises(ValueError):
                conv.restore(snap)
        assert torch.equal(torch.stack([conv.process(xb) for xb in xs[5:40]]),
                           torch.stack([twin.process(xb) for xb in xs[5:40]])), type(conv)


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


@pytest.mark.parametrize("b,n", [(64, 37), (128, 5), (32, 1), (128, 600), (2048, 3),
                                 (128, 3750)])
def test_b1p_kernel_matches_plain(dev, b, n):
    """B1p from the same bf16 state each step: the output to the f32
    tolerance, the ring row written to within one bf16 step (the two
    transforms may round a bin to neighbouring bf16 values), the arrival
    counter back at 0."""
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
        assert st.current == plain.current and int(st.ticket) == 0, f"block {t}"
        _close(st.overlap, plain.overlap, "overlap")


@pytest.mark.parametrize("b,n,mixer", [(64, 16, "raised_cosine"), (128, 300, "sqrt"),
                                       (32, 1, "linear"), (2048, 2, "cosine"),
                                       (128, 3750, "raised_cosine")])
def test_b3_kernel_matches_plain(dev, b, n, mixer):
    """B3 through hold, ramp, snap and a mid-ramp reversal, every mixer, and
    the flagship 10 s ring (130 MAC blocks and one ticket a step), for at
    least 2n + 3 steps: ring and overlaps checked after every one."""
    rng = np.random.default_rng(110 + n)
    consts = cuda_crossfade.build_consts(_spectra(rng, n, b, dev), _spectra(rng, n, b, dev))
    st, plain = cuda_crossfade.zero_state(n, b, dev), cuda_crossfade.zero_state(n, b, dev)
    cfg = crossfade.CrossfaderConfig(fading_samples=3 * b + 5, hold_samples=b // 2 + 3,
                                     mixer=mixer)
    cf = cfp = crossfade.new_state(cfg)
    for t in range(max(2 * n + 3, 12)):
        if t in (2, 5):  # a fade, then a reversal mid-ramp
            target = crossfade.TARGET_B if t == 2 else crossfade.TARGET_A
            cf = cfp = crossfade.fade_into(cfg, cf, target)
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        cf, y = cuda_crossfade.block_step(consts, st, cfg, cf, x)
        cfp, yp = cuda_crossfade.block_step_plain(consts, plain, cfg, cfp, x)
        torch.cuda.synchronize()
        _check_b3(st, plain, y, yp, f"block {t}")
        assert cf == cfp


def _check_b3(st, plain, y, yp, what):
    _close(y, yp, what)
    _close(st.segments, plain.segments, f"{what}: ring")
    _close(st.overlap_a, plain.overlap_a, f"{what}: overlap_a")
    _close(st.overlap_b, plain.overlap_b, f"{what}: overlap_b")
    assert st.current == plain.current and int(st.ticket) == 0, what


def test_one_launch_kernels_interleave_with_their_own_counters(dev):
    """A B1 state, a B1p state, two B2 states and a B3 state stepped in turn
    on one stream, none synchronised between launches: each state keeps its
    own arrival counter, and each follows its plain version."""
    rng = np.random.default_rng(115)
    b1 = []  # (step, consts, state, plain state) for B1 and B1p
    for storage, step, n1 in (("float32", cuda_engine.block_step, 150),
                              ("bf16_packed", cuda_engine.block_step_packed, 70)):
        ir = (rng.standard_normal(64 * n1) * 0.1).astype(np.float32)
        ucfg, ust = uniform.init(torch.from_numpy(ir).to(dev), 64, len(ir), dev)
        consts, st = cuda_engine.from_uniform(ucfg, ust, storage)
        b1.append((step, consts, st, st.clone()))
    b2 = []
    for b, n in ((64, 40), (128, 17)):
        consts, bufs = _b2_operands(rng, b, n, dev)
        b2.append((consts, bufs, {k: v.clone() for k, v in bufs.items()},
                   cuda_two_stage.zero_state(n, b, dev), cuda_two_stage.zero_state(n, b, dev)))
    b, n = 64, 300
    xc = cuda_crossfade.build_consts(_spectra(rng, n, b, dev), _spectra(rng, n, b, dev))
    xs, xp = cuda_crossfade.zero_state(n, b, dev), cuda_crossfade.zero_state(n, b, dev)
    cfg = crossfade.CrossfaderConfig(fading_samples=2 * b, hold_samples=b)
    cf = cfp = crossfade.fade_into(cfg, crossfade.new_state(cfg), crossfade.TARGET_B)
    for t in range(2 * n + 3):
        outs = []
        for consts, bufs, pbufs, st, plain in b2:
            nb2 = st.segments.shape[0]
            x = torch.from_numpy(rng.standard_normal(st.head_overlap.shape[0])
                                 .astype(np.float32)).to(dev)
            outs.append((cuda_two_stage.block_step(consts, st, bufs, t % nb2, x),
                         cuda_two_stage.block_step_plain(consts, plain, pbufs, t % nb2, x)))
        x = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(dev)
        cf, y = cuda_crossfade.block_step(xc, xs, cfg, cf, x)
        cfp, yp = cuda_crossfade.block_step_plain(xc, xp, cfg, cfp, x)
        outs1 = []
        for step, consts, st, plain in b1:
            x1 = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dev)
            if not st.segments.is_complex():
                plain = st.clone()  # bf16: the plain step from the kernel's state
            outs1.append((step.__name__, st, plain, step(consts, st, x1),
                          cuda_engine.block_step_plain(consts, plain, x1)))
        torch.cuda.synchronize()
        for (consts, bufs, pbufs, st, plain), (y2, yp2) in zip(b2, outs):
            _check_b2(st, plain, bufs, pbufs, y2, yp2, f"B2 n={st.segments.shape[0]} block {t}")
        _check_b3(xs, xp, y, yp, f"B3 block {t}")
        for name, st, plain, y1, yp1 in outs1:
            _close(y1, yp1, f"{name} block {t}")
            assert st.current == plain.current and int(st.ticket) == 0, f"{name} block {t}"
    tickets = [st.ticket for _, _, st, _ in b1] + [st.ticket for *_, st, _ in b2] + [xs.ticket]
    assert len({tk.data_ptr() for tk in tickets}) == 5


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,calls", [(64, 24, (13, 1, 37, 8)), (128, 512, (64, 64, 700)),
                                       (32, 1, (3, 5)), (2048, 4, (9, 2)),
                                       (64, 37, (1, 13, 16, 37, 5, 70)),
                                       (32, 300, (100, 17, 64, 33, 200)),
                                       (2048, 40, (70, 3)), (128, 11264, (64, 64))])
def test_b4_kernel_matches_plain(dev, packed, b, n, calls):
    """B4 over call lengths that are not multiples of 8 or of the tile (and
    T = 1), that exceed the ring (T > N: old rows overwritten within the
    call), and through the ring's wrap, which falls inside a stage of 16
    rows as w moves; N not a multiple of a stage; B = 32 and 2048 (bin
    tiles); the flagship stream shape (N = 11264, T = 64).  Ring, w and
    overlap follow the plain version."""
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
    """Fixed-order sums (B3 orders its partials by block whichever block
    finishes, through an integer ticket; no float atomics): replays after
    reset and restore are bit-equal for B1p, B3 and both B4 forms."""
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


# ---- kernel B5: the reverb farm's big-tail phased step ------------------------

def _b5_operands(rng, n, v, tb, dev, packed):
    ring = torch.from_numpy((rng.standard_normal((n, v, tb + 1, 2)) * 0.1)
                            .astype(np.float32)).to(dev)
    table = torch.from_numpy((rng.standard_normal((n, v, tb + 1, 2)) * 0.1)
                             .astype(np.float32)).to(dev)
    if packed:
        return ring.to(torch.bfloat16), table.to(torch.bfloat16)
    return torch.view_as_complex(ring).contiguous(), torch.view_as_complex(table).contiguous()


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("v,tb,n,steps", [
    (3, 64, 16, ((0, 1), (15, 16), (7, 5), (13, 3), (15, 1))),
    (2, 1024, 8, ((7, 8), (3, 3), (0, 2))),
    (5, 128, 88, ((87, 16), (40, 8), (0, 7), (86, 13))),
    (1, 32, 1, ((0, 1),)),
])
def test_b5_kernel_matches_plain(dev, packed, v, tb, n, steps):
    """B5 against phased_step_plain for phases through q = N-1, T = 1, T = 16
    and T that are not multiples of 8, over several voice and bin counts:
    sums and pre to float32 rounding in another order, the ring written
    exactly (both round to nearest even)."""
    rng = np.random.default_rng(140 + n)
    ring, table = _b5_operands(rng, n, v, tb, dev, packed)
    step = cuda_farm_mac.phased_step
    for q, t_len in steps:
        specs = torch.from_numpy((rng.standard_normal((t_len, v, tb + 1)) * 0.1)
                                 .astype(np.complex64)).to(dev)
        plain = ring.clone()
        convs, pre = step(ring, table, specs, q)
        pc, pp = cuda_farm_mac.phased_step_plain(plain, table, specs, q)
        torch.cuda.synchronize()
        _close(convs, pc, f"convs q={q} T={t_len}")
        _close(pre, pp, f"pre q={q} T={t_len}")
        assert torch.equal(ring, plain), f"ring q={q} T={t_len}"


@pytest.mark.parametrize("packed,kernel", [(False, "fdl_b5_step"), (True, "fdl_b5p_step")],
                         ids=["f32", "bf16"])
def test_b5_form_follows_the_table(dev, packed, kernel):
    """phased_step launches B5's bf16 form for a bf16 table and its complex64
    form for a complex64 one, once, and matches phased_step_plain."""
    rng = np.random.default_rng(145)
    n, v, tb = 8, 3, 64
    ring, table = _b5_operands(rng, n, v, tb, dev, packed)
    specs = torch.from_numpy((rng.standard_normal((3, v, tb + 1)) * 0.1)
                             .astype(np.complex64)).to(dev)
    plain = ring.clone()
    before = cuda_farm_mac.phased_step.launches
    with mock.patch.object(_build, "kernel", wraps=_build.kernel) as lookup:
        convs, pre = cuda_farm_mac.phased_step(ring, table, specs, 5)
    assert [c.args[0] for c in lookup.call_args_list] == [kernel]
    assert cuda_farm_mac.phased_step.launches == before + 1
    pc, pp = cuda_farm_mac.phased_step_plain(plain, table, specs, 5)
    torch.cuda.synchronize()
    _close(convs, pc, "convs")
    _close(pre, pp, "pre")
    assert torch.equal(ring, plain)


@pytest.mark.parametrize("tail_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b5_farm_replays_bit_exact(dev, tail_dtype):
    """One thread per lane, sums in a fixed order, no atomics: a replay after
    reset, and after restore, is bit-equal."""
    rng = np.random.default_rng(150)
    irs = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32)
    farm = ReverbFarm(irs, 64, 9000, tail_dtype=tail_dtype, device=dev)
    p = farm.period
    x = torch.from_numpy(rng.standard_normal((10 * p, 3, 64)).astype(np.float32)).to(dev)
    calls = [x[:2 * p], x[2 * p:3 * p], x[3 * p:7 * p], x[7 * p:]]
    y1 = torch.cat([farm.process(c) for c in calls])
    farm.reset()
    assert torch.equal(y1, torch.cat([farm.process(c) for c in calls]))
    farm.reset()
    farm.process(calls[0])
    snap = farm.snapshot()
    y2 = torch.cat([farm.process(c) for c in calls[1:]])
    farm.restore(snap)
    assert torch.equal(y2, torch.cat([farm.process(c) for c in calls[1:]]))


def test_b5_rejects_bad_operands(dev):
    rng = np.random.default_rng(151)
    n, v, tb = 8, 2, 64
    ring, table = _b5_operands(rng, n, v, tb, dev, packed=False)
    specs = torch.zeros((2, v, tb + 1), dtype=torch.complex64, device=dev)
    step = cuda_farm_mac.phased_step
    with pytest.raises(ValueError):  # T > N
        step(ring, table, torch.zeros((9, v, tb + 1), dtype=torch.complex64, device=dev), 0)
    with pytest.raises(ValueError):  # phase outside the ring
        step(ring, table, specs, n)
    with pytest.raises(ValueError):  # specs not complex64
        step(ring, table, torch.zeros((2, v, tb + 1), device=dev), 0)
    with pytest.raises(ValueError):  # a table of another shape
        step(ring, table[:, :1].contiguous(), specs, 0)
    with pytest.raises(ValueError):  # not contiguous
        step(ring.transpose(1, 2).contiguous().transpose(1, 2), table, specs, 0)
    with pytest.raises(ValueError):  # a bf16 ring beside a complex64 table
        step(torch.view_as_real(ring).to(torch.bfloat16), table, specs, 0)
    with pytest.raises(ValueError):  # a float32 table
        step(ring, torch.view_as_real(table).contiguous(), specs, 0)
    with pytest.raises(ValueError):  # the ring on the CPU
        step(ring.cpu(), table, specs, 0)
    big_ring, big_table = _b5_operands(rng, 17, 1, 16, dev, packed=False)
    with pytest.raises(ValueError):  # T > 16
        step(big_ring, big_table, torch.zeros((17, 1, 17), dtype=torch.complex64,
                                              device=dev), 0)


@pytest.mark.parametrize("tail_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_reverb_farm_on_card_matches_cpu(dev, tail_dtype):
    """A small farm on the card (kernel B5, cuFFT) against the same farm on
    the CPU (plain step, pocketfft) through calls of 2, 1, 4 and 3 periods
    and a per-voice update.  bf16: a ring row the two DFTs round to
    neighbouring bf16 values carries into later calls, so the bound is the
    5e-3 of the output scale the on-card bf16 gates use."""
    rng = np.random.default_rng(152)
    irs = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32)
    gpu = ReverbFarm(irs, 64, 9000, tail_dtype=tail_dtype, device=dev)
    cpu = ReverbFarm(irs, 64, 9000, tail_dtype=tail_dtype, device="cpu")
    p = gpu.period
    launches = cuda_farm_mac.phased_step
    before = launches.launches
    for call, periods in enumerate((2, 1, 4, 3)):
        if call == 2:
            new = (rng.standard_normal((1, 5000)) * 0.05).astype(np.float32)
            gpu.update_voices([1], new)
            cpu.update_voices([1], new)
        x = rng.standard_normal((periods * p, 3, 64)).astype(np.float32)
        got, want = gpu.process(x).cpu(), cpu.process(x)
        scale = max(1.0, float(want.abs().max()))
        tol = 2e-5 if tail_dtype == torch.float32 else 5e-3
        assert float((got - want).abs().max()) <= tol * scale, f"call {call}"
    assert launches.launches == before + 4


def _farm_against_float64(dev, farm, irs, g, events, updated, limit):
    """Stream ``events`` through ``farm`` (a number: a call of that many
    periods; ``"update"``: ``update_voices`` of the voices ``updated`` to
    fresh responses; ``"reset"``) and hold each call to the float64
    reference (``portbench/reference/conv.py``) as the benchmark cells' check
    does: the widest gap over the reference's peak in the call, under
    ``limit``, an updated voice compared exactly from three tail periods
    after its update (``update_extension``'s transient).  Kernels B5, B6 and
    B7 launch once a call."""
    from portbench.reference.conv import conv_tail

    v, taps = irs.shape
    p, tb, b = farm.period, farm.tail_block, farm.block_size
    counters = (cuda_farm_mac.phased_step, cuda_farm_heads.heads_step,
                cuda_farm_tail.tail_forward, cuda_farm_tail.tail_inverse)
    dry = []                          # the blocks since the last reset
    since = torch.zeros(v, dtype=torch.long, device=dev)  # first exact sample
    for event in events:
        if event == "update":
            irs[updated] = torch.randn((len(updated), taps), generator=g, device=dev) * 0.002
            farm.update_voices(updated, irs[updated])
            since[updated] = len(dry) * b + 3 * tb
            continue
        if event == "reset":
            farm.reset()
            dry, since = [], torch.zeros_like(since)
            continue
        x = torch.randn((event * p, v, b), generator=g, device=dev)
        before = [c.launches for c in counters]
        y = farm.process(x)
        assert [c.launches for c in counters] == [n + 1 for n in before]
        s0 = len(dry) * b
        dry.extend(x)
        span = event * p * b
        stream = torch.stack(dry).permute(1, 0, 2).reshape(v, -1)
        ref = conv_tail(stream, irs, span)
        got = y.permute(1, 0, 2).reshape(v, span).double()
        pos = torch.arange(s0, s0 + span, device=dev)
        exact = pos[None, :] >= since[:, None]
        gap = float(torch.where(exact, (got - ref).abs(), 0.0).max())
        peak = float(torch.where(exact, ref.abs(), 0.0).max())
        assert torch.isfinite(got).all() and gap <= limit * peak, (event, gap / peak)


def test_bf16_farm_at_the_cells_shapes_matches_float64(dev):
    """A bf16-tail farm at the shapes of the benchmark cell ``farm60bf16.dev2``
    (block 128, 60 s responses: tail block 32768, 88 big-tail segments; 4
    voices) against the float64 reference under the cell's ``out_err``
    limit: calls of 2 and 1 periods, ``update_voices`` of one voice, then a
    ``reset`` (:func:`_farm_against_float64`)."""
    from portbench import harness

    v, b, taps = 4, 128, 2_880_000
    g = torch.Generator(device=dev).manual_seed(2101)
    irs = torch.randn((v, taps), generator=g, device=dev) * 0.002
    farm = ReverbFarm(irs, b, taps, tail_dtype=torch.bfloat16, device=dev)
    assert (farm.tail_block, farm.cfg.tail.seg_count) == (32768, 88)
    _farm_against_float64(dev, farm, irs, g, (2, 1, "update", 2, 2, "reset", 2, 1), [1],
                          harness.limits_for("farm60bf16.dev2")["out_err"])


@pytest.mark.parametrize("tail_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_room_farm_at_the_cells_shapes_matches_float64(dev, tail_dtype):
    """A farm at the shapes of the benchmark cell ``farm128k.dev8`` (block
    64, 128,000-tap responses at 44.1 kHz: tail block 4096, n = 64, 32
    big-tail segments; 8 voices) against the float64 reference under the
    cell's ``out_err`` limit (f32) or the bf16 cell's (bf16): 8-period
    calls, the cell's call, ``update_voices`` of two voices, then a
    ``reset`` (:func:`_farm_against_float64`)."""
    from portbench import harness

    cell = "farm128k.dev8" if tail_dtype == torch.float32 else "farm60bf16.dev2"
    v, b, taps = 8, 64, 128_000
    g = torch.Generator(device=dev).manual_seed(2501)
    irs = torch.randn((v, taps), generator=g, device=dev) * 0.002
    farm = ReverbFarm(irs, b, taps, tail_dtype=tail_dtype, device=dev)
    assert (farm.tail_block, farm.period, farm.cfg.tail.seg_count) == (4096, 64, 32)
    _farm_against_float64(dev, farm, irs, g, (8, "update", 8, 8, "reset", 8, 8), [2, 5],
                          harness.limits_for(cell)["out_err"])


# ---- kernel B6: the reverb farm's head path --------------------------------------

def _b6_state(rng, v, b, ir_len, dev):
    """A farm's head-side state on the card with a random history in the
    ring, hist and overlap (spectra of random real blocks: a C2R transform
    reads only the Hermitian part, so the imaginary parts of the DC and
    Nyquist bins must be those of a real signal), and the ring head off 0."""
    irs = torch.from_numpy((rng.standard_normal((v, ir_len)) * 0.05).astype(np.float32))
    cfg, st = farm2.farm2_init(irs.to(dev), b, ir_len)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    for t in (st.head.segments, st.hist):
        if t.numel():  # hist has no rows at n = 1
            t.copy_(torch.fft.rfft(torch.randn(t.shape[:-1] + (b,), generator=gen,
                                               device=dev), n=2 * b))
    st.head.overlap = torch.randn(st.head.overlap.shape, generator=gen, device=dev) * 0.1
    st.head.current = st.tail0.current = cfg.head.seg_count // 3
    return cfg, st


def _b6_call(st, x, delay, step):
    return step(st.head, st.tail0, x, st.hist, st.suppress, delay)


def _b6_exit(st):
    return (st.head.segments, st.hist, st.head.overlap, st.head.pre_multiplied,
            st.tail0.pre_multiplied)


@pytest.mark.parametrize("v,b,ir_len,periods", [
    (3, 64, 9000, (1, 2, 8)),          # n = 16, M = 256, teams of 4 threads
    (2, 128, 4 * 48000, (1, 3, 16)),   # n = 64, M = 256, 16 segments a column
    (2, 128, 60 * 48000, (1, 8)),      # the farm's shape: n = 256, M = 1024
    (1, 2048, 12288, (1, 16)),         # n = 2, teams of 128 on named barriers
    (2, 2048, 6000, (1, 8)),           # n = 1: no hist rows, no pre terms
    (2, 256, 100_000, (1, 5)),         # n = 32, teams of 16
    (2, 4, 2000, (1, 3)),              # n = 32, one thread a block transform (radix 4)
    (1, 16, 8_000_000, (1,)),          # n = 1024, M = 4096, three radix-16 stages
    (300, 128, 4 * 48000, (1, 2)),     # 38,700 columns: the persistent grid walks many tiles
    (1, 128, 60 * 48000, (1, 4)),      # 65 tiles of 2 columns, the last ragged: fewer than the grid
])
def test_b6_kernel_matches_plain(dev, v, b, ir_len, periods):
    """B6 against heads_step_plain over calls of several periods, the state
    carried, without and with the suppress pass (voice 0 flagged, then every
    voice, both through the gathered pass) and with the big tail's
    delay line: the output and every exit field, to float32 rounding in
    another order; current the same; the flagged voices counted."""
    rng = np.random.default_rng(170 + b)
    cfg, st = _b6_state(rng, v, b, ir_len, dev)
    n = cfg.head.seg_count
    plain = st.clone()
    before = cuda_farm_heads.heads_step.launches
    suppressed = cuda_farm_heads.heads_step.suppressed
    calls = flags = 0
    for flagged in ([], [0], list(range(v))):
        for k in periods:
            st.suppress.fill_(False)
            st.suppress[flagged] = True
            plain.suppress.copy_(st.suppress)
            x = torch.from_numpy(rng.standard_normal((k * n, v, b)).astype(np.float32)).to(dev)
            delay = tuple(torch.from_numpy((rng.standard_normal(shape) * 0.1)
                                           .astype(np.float32)).to(dev)
                          for shape in ((v, n * b), (v, n * b), (k, v, n * b)))
            y = _b6_call(st, x, delay, cuda_farm_heads.heads_step)
            yp = _b6_call(plain, x, delay, cuda_farm_heads.heads_step_plain)
            torch.cuda.synchronize()
            calls += 1
            flags += len(flagged)
            what = f"n={n} T={k * n} flagged={len(flagged)}"
            _close(y, yp, f"y {what}")
            for name, got, want in zip(("ring", "hist", "overlap", "pre head", "pre tail0"),
                                       _b6_exit(st), _b6_exit(plain)):
                assert got.shape == want.shape, f"{name} {what}"
                if want.numel():  # hist has no rows at n = 1
                    _close(got, want, f"{name} {what}")
            assert st.head.current == plain.head.current == st.tail0.current
    assert cuda_farm_heads.heads_step.launches == before + calls
    assert cuda_farm_heads.heads_step.suppressed == suppressed + flags


def test_b6_suppress_pass_makes_no_sync(dev):
    """The suppress pass reads its flags on the host and sends the flagged
    voices' indices by a pinned asynchronous copy, so a call with a subset
    of the voices flagged, or every voice, never waits on the card (after a
    first call that builds the kernel)."""
    rng = np.random.default_rng(182)
    cfg, st = _b6_state(rng, 4, 128, 4 * 48000, dev)
    n = cfg.head.seg_count
    x = torch.from_numpy(rng.standard_normal((n, 4, 128)).astype(np.float32)).to(dev)
    step = cuda_farm_heads.heads_step
    _b6_call(st, x, None, step)
    before = step.suppressed
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for flagged in ([1, 3], [0, 1, 2, 3]):
            st.suppress.fill_(False)
            st.suppress[flagged] = True
            _b6_call(st, x, None, step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step.suppressed == before + 6


@pytest.mark.parametrize("v,ir_len", [
    (4, 4 * 48000),    # n = 64, M = 256: 65 tiles of 8 columns, the last ragged
    (300, 4 * 48000),  # 4838 tiles: several rounds of the persistent grid
    (5, 60 * 48000),   # n = 256, M = 1024: 323 tiles of 2 columns, fewer than the grid
])
def test_b6_replays_bit_exact(dev, v, ir_len):
    """Fixed-order sums and no atomics: one call from one state twice gives
    bit-equal outputs and exit states (the dp mesh's slab gate relies on it),
    and a voice's result does not depend on the others (its slab alone, whose
    tiles fall on other columns and thread blocks).  The launch ran the
    plan's persistent grid over tiles of adjacent columns."""
    rng = np.random.default_rng(180)
    cfg, st = _b6_state(rng, v, 128, ir_len, dev)
    n = cfg.head.seg_count
    x = torch.from_numpy(rng.standard_normal((2 * n, v, 128)).astype(np.float32)).to(dev)
    st.suppress[1] = True
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    runs = []
    for _ in range(2):
        s = st.clone()
        runs.append((_b6_call(s, x, None, cuda_farm_heads.heads_step), *_b6_exit(s)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plan = cuda_farm_heads.heads_step.plan
    assert plan == cuda_farm_heads.heads_plan(n, 128, 2 * n, v, sms)
    assert plan.col_tiles == -(-v * 129 // plan.col_tile)
    assert plan.col_grid == min(plan.col_tiles, sms * plan.col_blocks)
    lo = v // 2
    slab = farm2.voice_slab(st, range(lo, v))
    y = _b6_call(slab, x[:, lo:].contiguous(), None, cuda_farm_heads.heads_step)
    assert cuda_farm_heads.heads_step.plan.col_tiles == -(-(v - lo) * 129 // plan.col_tile)
    assert torch.equal(y, runs[0][0][:, lo:])
    for got, whole in zip(_b6_exit(slab), runs[0][1:]):
        if whole.numel():
            assert torch.equal(got, whole[lo:])


def test_b6_rejects_bad_operands(dev):
    rng = np.random.default_rng(181)
    cfg, st = _b6_state(rng, 2, 64, 9000, dev)
    n = cfg.head.seg_count
    x = torch.zeros((n, 2, 64), device=dev)
    step = cuda_farm_heads.heads_step
    with pytest.raises(ValueError, match="multiple of the period"):
        step(st.head, st.tail0, torch.zeros((n + 1, 2, 64), device=dev), st.hist, st.suppress)
    with pytest.raises(ValueError, match="hist"):
        step(st.head, st.tail0, x, st.hist[:1], st.suppress)
    with pytest.raises(ValueError, match="delay"):
        step(st.head, st.tail0, x, st.hist, st.suppress,
             delay=(st.tail_output, st.tail_output, st.tail_output))
    st.head.segments = st.head.segments.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        step(st.head, st.tail0, x, st.hist, st.suppress)
    # a farm with a big tail checks B6's limits when it is built on the card
    with pytest.raises(ValueError, match="at least 4"):
        ReverbFarm(torch.zeros((1, 9000), device=dev), 2, 9000, device=dev)


# ---- kernel B7: the reverb farm's big-tail transforms ------------------------------

B7_TBS = [cuda_farm_tail.MIN_TB << i for i in range(12)]  # 64 .. 131072: all it takes
# float32 FFTs of up to 2^18 real points with another order of sums than
# cuFFT's: a few 1e-7 of the output's peak apart (the inverse's outputs carry
# one more rounding, the overlap-add); 1e-5 of the peak is the repository's
# kernel-vs-plain tolerance.
B7_RTOL = 1e-5


def _close_peak(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= B7_RTOL * scale, f"{what}: {err} at peak {scale}"


def _b7_inputs(rng, t, v, b, tb, dev):
    """``t`` tail rows of ``v`` voices as head blocks ``[t tb / b, v, b]``,
    and sums ``[t, v, tb+1]`` as B5 gives them from the spectra of real
    rows: random complex bins, real at DC and Nyquist (cuFFT's c2r, the
    plain version on the card, reads those imaginary parts at some lengths;
    B7 and ``torch.fft.irfft``'s contract do not, which
    :func:`test_b7_kernel_matches_plain` checks apart)."""
    x = torch.from_numpy(rng.standard_normal((t * tb // b, v, b)).astype(np.float32)).to(dev)
    c = rng.standard_normal((t, v, tb + 1, 2)).astype(np.float32)
    c[:, :, [0, -1], 1] = 0.0
    return x, torch.view_as_complex(torch.from_numpy(c)).to(dev)


@pytest.mark.parametrize("tb", B7_TBS)
def test_b7_kernel_matches_plain(dev, tb):
    """B7's two launches against their plain versions (gather and cuFFT's
    r2c; c2r, the overlap-add and the carry) at every tail block the kernel
    takes, over calls of T = 1, 2, 8 and 16 rows of 3 voices, the carry
    chained across the calls: the spectra, y and the carried overlap to
    1e-5 of each one's peak; and the inverse bit-equal whatever the
    imaginary parts of DC and Nyquist hold (C2R's contract: not read).  Head blocks of tb / 16 samples (16 a row),
    and whole rows (B = tb) on the last call."""
    rng = np.random.default_rng(190 + tb.bit_length())
    v = 3
    overlap = torch.from_numpy((rng.standard_normal((v, tb)) * 0.1).astype(np.float32)).to(dev)
    plain = overlap.clone()
    before = (cuda_farm_tail.tail_forward.launches, cuda_farm_tail.tail_inverse.launches)
    for t, b in ((1, tb // 16), (2, tb // 16), (8, tb // 16), (16, tb)):
        x, convs = _b7_inputs(rng, t, v, b, tb, dev)
        # the same sums with imaginary parts at DC and Nyquist, which B7 does not read
        noisy = convs.clone()
        torch.view_as_real(noisy)[:, :, [0, -1], 1] = torch.from_numpy(
            rng.standard_normal((t, v, 2)).astype(np.float32)).to(dev)
        ov_noisy = overlap.clone()
        specs = cuda_farm_tail.tail_forward(x, tb)
        want = cuda_farm_tail.tail_forward_plain(x, tb)
        y = cuda_farm_tail.tail_inverse(convs, overlap)
        yp = cuda_farm_tail.tail_inverse_plain(convs, plain)
        y_noisy = cuda_farm_tail.tail_inverse(noisy, ov_noisy)
        torch.cuda.synchronize()
        _close_peak(specs, want, f"specs tb={tb} T={t}")
        _close_peak(y, yp, f"y tb={tb} T={t}")
        _close_peak(overlap, plain, f"overlap tb={tb} T={t}")
        assert torch.equal(y_noisy, y) and torch.equal(ov_noisy, overlap), f"tb={tb} T={t}"
    assert (cuda_farm_tail.tail_forward.launches,
            cuda_farm_tail.tail_inverse.launches) == (before[0] + 4, before[1] + 8)


@pytest.mark.parametrize("tb", [1024, 32768, 131072])
def test_b7_replays_bit_exact(dev, tb):
    """Fixed-order sums and no atomics: a launch twice from the same inputs
    is bit-equal, and a voice's result does not depend on the others (its
    slab alone)."""
    rng = np.random.default_rng(200 + tb.bit_length())
    v, t, b = 5, 8, 128
    x, convs = _b7_inputs(rng, t, v, b, tb, dev)
    overlap = torch.from_numpy(rng.standard_normal((v, tb)).astype(np.float32)).to(dev)
    runs = []
    for _ in range(2):
        ov = overlap.clone()
        runs.append((cuda_farm_tail.tail_forward(x, tb), cuda_farm_tail.tail_inverse(convs, ov),
                     ov))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    ov = overlap[1:3].clone()
    assert torch.equal(cuda_farm_tail.tail_forward(x[:, 1:3].contiguous(), tb),
                       runs[0][0][:, 1:3])
    assert torch.equal(cuda_farm_tail.tail_inverse(convs[:, 1:3].contiguous(), ov),
                       runs[0][1][:, 1:3])
    assert torch.equal(ov, runs[0][2][1:3])


@pytest.mark.parametrize("tail_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b7_launches_once_a_farm_call(dev, tail_dtype):
    """A card farm launches each of B7's kernels once a call, whatever its
    length; a farm run with the transforms swapped for their plain versions
    launches none and gives the same output to B7's tolerance."""
    rng = np.random.default_rng(210)
    irs = (rng.standard_normal((3, 9000)) * 0.05).astype(np.float32)
    farm = ReverbFarm(irs, 64, 9000, tail_dtype=tail_dtype, device=dev)
    twin = ReverbFarm(irs, 64, 9000, tail_dtype=tail_dtype, device=dev)
    fwd, inv = cuda_farm_tail.tail_forward, cuda_farm_tail.tail_inverse
    for periods in (1, 4, 2):
        x = rng.standard_normal((periods * farm.period, 3, 64)).astype(np.float32)
        before = (fwd.launches, inv.launches)
        y = farm.process(x)
        assert (fwd.launches, inv.launches) == (before[0] + 1, before[1] + 1)
        with _plain(cuda_farm_tail, "tail_forward", "tail_inverse"):
            yp = twin.process(x)
        assert (fwd.launches, inv.launches) == (before[0] + 1, before[1] + 1)
        torch.cuda.synchronize()
        _close_peak(y, yp, f"farm call of {periods} periods")


def test_b7_rejects_bad_operands(dev):
    rng = np.random.default_rng(211)
    tb, v, b = 1024, 2, 64
    x, convs = _b7_inputs(rng, 2, v, b, tb, dev)
    overlap = torch.zeros((v, tb), device=dev)
    fwd, inv = cuda_farm_tail.tail_forward, cuda_farm_tail.tail_inverse
    with pytest.raises(ValueError, match="float64"):
        fwd(x.double(), tb)
    with pytest.raises(ValueError, match="multiple of the period"):
        fwd(x[:-1], tb)
    with pytest.raises(ValueError, match="not contiguous"):
        fwd(x.transpose(0, 1).contiguous().transpose(0, 1), tb)
    with pytest.raises(ValueError, match="64 to 131072"):
        fwd(torch.zeros((2, v, 16), device=dev), 32)
    with pytest.raises(ValueError, match="64 to 131072"):
        fwd(torch.zeros((1, v, 1 << 18), device=dev), 1 << 18)
    with pytest.raises(ValueError, match="power-of-two tail block"):
        fwd(x, 96)
    with pytest.raises(ValueError, match="head block"):
        fwd(torch.zeros((2 * tb, v, 1), device=dev), tb)
    with pytest.raises(ValueError, match="overlap"):  # the overlap on the CPU
        inv(convs, overlap.cpu())
    with pytest.raises(ValueError, match="convs"):  # bins for another tail block
        inv(convs[:, :, :-2].contiguous(), overlap)
    with pytest.raises(ValueError, match="convs"):  # not complex64
        inv(torch.view_as_real(convs).contiguous(), overlap)
    with pytest.raises(ValueError, match="convs"):  # not contiguous
        inv(convs.transpose(0, 1).contiguous().transpose(0, 1), overlap)
    with pytest.raises(ValueError, match="overlap"):  # another voice count
        inv(convs, torch.zeros((v + 1, tb), device=dev))
    # a farm whose tail block B7 does not take raises when it is built on the card
    with pytest.raises(ValueError, match="64 to 131072"):
        ReverbFarm(torch.zeros((1, 200), device=dev), 8, 200, device=dev)


# ---- the mesh: two gloo ranks sharing the card (parallel.mesh.run_ranks) -----------
# A spawned rank imports this module (torch only) to reach its function.

def _dp_farm_rank(rank, world, irs, x, bf16):
    from fft_convolution_tpu_torch.parallel.mesh import make_mesh

    farm = ReverbFarm(irs, 64, irs.shape[1], mesh=make_mesh((world,), ("dp",), "cuda"),
                      tail_dtype=torch.bfloat16 if bf16 else torch.float32)
    step = cuda_farm_mac.phased_step
    before = step.launches
    own = slice(farm.local_voices.start, farm.local_voices.stop)
    ys = [farm.process(xc[:, own]).cpu() for xc in x]
    return {"y": torch.cat(ys), "voices": (own.start, own.stop),
            "launches": step.launches - before}


@pytest.mark.parametrize("tail_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dp_farm_two_ranks_match_unsharded(dev, tail_dtype):
    """ReverbFarm(mesh=...) on two ranks of the card: each rank's voice slab
    against the unsharded farm's rows, and kernel B5 (B5p) launched once a
    call on each rank."""
    from fft_convolution_tpu_torch.parallel.mesh import run_ranks

    rng = np.random.default_rng(160)
    irs = (rng.standard_normal((4, 9000)) * 0.05).astype(np.float32)
    ref = ReverbFarm(irs, 64, 9000, tail_dtype=tail_dtype, device=dev)
    x = [rng.standard_normal((periods * ref.period, 4, 64)).astype(np.float32)
         for periods in (2, 1, 4)]
    want = torch.cat([ref.process(xc).cpu() for xc in x])
    ranks = run_ranks(_dp_farm_rank, 2, irs, x, tail_dtype == torch.bfloat16,
                      device="cuda", timeout=300)
    for rank, res in enumerate(ranks):
        lo, hi = res["voices"]
        assert (lo, hi) == (2 * rank, 2 * rank + 2)
        assert res["launches"] == len(x)
        _close(res["y"], want[:, lo:hi], f"rank {rank}")


def _sp_rank(rank, world, ir, short, x):
    from fft_convolution_tpu_torch.parallel.mesh import make_mesh
    from fft_convolution_tpu_torch.parallel.partition import ShardedFFTConvolver

    sh = ShardedFFTConvolver(ir, 128, len(ir), mesh=make_mesh((world,), ("sp",), "cuda"))
    y1 = sh.process(x[:40].reshape(-1))
    sh.update(short)
    return {"y": torch.cat([y1, sh.process(x[40:].reshape(-1))]).cpu(),
            "rows": sh.state.segments.shape[0]}


def test_sharded_fdl_two_ranks_match_fft_convolver(dev):
    """ShardedFFTConvolver on two ranks of the card (one all-reduce of a
    card tensor a block) against FFTConvolver, through the ring's wrap and
    an update to a shorter IR (the shrunk-ring transient)."""
    from fft_convolution_tpu_torch import FFTConvolver
    from fft_convolution_tpu_torch.parallel.mesh import run_ranks

    rng = np.random.default_rng(161)
    ir = (rng.standard_normal(128 * 24) * 0.1).astype(np.float32)
    short = (rng.standard_normal(128 * 5) * 0.1).astype(np.float32)
    x = rng.standard_normal((72, 128)).astype(np.float32)
    ref = FFTConvolver(ir, 128, len(ir), device=dev)
    y1 = ref.process(x[:40].reshape(-1))
    ref.update(short)
    want = torch.cat([y1, ref.process(x[40:].reshape(-1))]).cpu()
    for res in run_ranks(_sp_rank, 2, ir, short, x, device="cuda", timeout=300):
        assert res["rows"] == 12
        _close(res["y"], want, "sharded vs single-device")


def test_two_stage_flagship_aligned_fused_chrono_on_card(dev):
    """The flagship aligned call (block 128, a 10 s 48 kHz IR, T = 3968) on
    the card over five calls with the state carried: the fused front end
    (SEPARATE form) and the CHRONO big tail each once a call, the ring core
    never, the history compacted on the fourth call; against a float64
    convolution (1e-4, the on-card gate) and the same wrapper on the CPU."""
    from fft_convolution_tpu_torch import TwoStageFFTConvolver
    from fft_convolution_tpu_torch.models import two_stage

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(10 * 48000) * 0.01).astype(np.float32)
    x = rng.standard_normal((5, 3968 * 128)).astype(np.float32)
    card = TwoStageFFTConvolver(ir, 128, len(ir), device=dev)
    assert not two_stage.fused_uses_multi(card.cfg, 3968)
    cores = (uniform._stream_conv, two_stage._fused_small_streams, uniform.stream_conv_chrono)
    before, ys, pos = [c.calls for c in cores], [], []
    for xc in x:
        ys.append(card.process(torch.from_numpy(xc).to(dev)))
        pos.append(card._tail_pos)
    assert [c.calls - n for c, n in zip(cores, before)] == [0, 5, 5]
    assert pos == [118, 180, 242, 118, 180]
    y = torch.cat(ys)
    host = TwoStageFFTConvolver(ir, 128, len(ir), device="cpu")
    _close(y.cpu(), torch.cat([host.process(xc) for xc in x]), "card vs CPU")
    sig, h = torch.from_numpy(x.reshape(-1)).to(dev), torch.from_numpy(ir).to(dev)
    nfft = 1 << (sig.numel() + h.numel() - 2).bit_length()
    ref = torch.fft.irfft(torch.fft.rfft(sig.double(), nfft) * torch.fft.rfft(h.double(), nfft),
                          nfft)[:sig.numel()]
    assert float((y.double() - ref).abs().max()) <= 1e-4
