"""The port's H100 cost model, ``fft_convolution_tpu_torch/utils/roofline.py``:
the port of ``tests/test_uniform.py::test_roofline_accounting`` with bands
for the port's counts, hand-computed costs at small shapes for each cost
function, the invariance of a cost across the implementations of one
function, the bounds of kernels B1-B5 at the flagship and farm shapes
reproduced from the shapes alone, the card lookup, JAX's rate keys, the
share gate of ``chip_smoke.py`` and the module's import boundary.  No card:
the H100's peaks are the module's table entry.
"""

import importlib.util
import math
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from fft_convolution_tpu.utils import roofline as jroofline
from fft_convolution_tpu_torch import CrossfadeConvolver, FFTConvolver, TwoStageFFTConvolver
from fft_convolution_tpu_torch.models import two_stage, uniform
from fft_convolution_tpu_torch.models.two_stage import TwoStageConfig
from fft_convolution_tpu_torch.models.uniform import UniformConfig
from fft_convolution_tpu_torch.ops import cuda_engine, cuda_stream
from fft_convolution_tpu_torch.parallel import farm2
from fft_convolution_tpu_torch.serving import (CudaCrossfadeConvolver, CudaFFTConvolver,
                                               CudaStreamingConvolver, CudaTwoStageConvolver)
from fft_convolution_tpu_torch.utils import roofline as rl

ROOT = pathlib.Path(__file__).resolve().parent.parent
H100 = rl.H100_SXM
SR = 48000


def rfft(n: int) -> float:
    """A real FFT of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def cfft(m: int) -> float:
    """A complex FFT of m points: 5 m log2 m."""
    return 5.0 * m * math.log2(m) if m > 1 else 0.0


def flagship() -> TwoStageConfig:
    cfg, _ = two_stage.init(np.zeros(10, np.float32), 128, 10 * SR)
    return cfg


# ---- the port of test_uniform.py::test_roofline_accounting ----------------------

def test_roofline_accounting():
    """Positive counts; the block-axis form beats the per-block MAC on a
    long stream and not on one block; the flagship aligned call lands in a
    plausible band; utilization carries JAX's keys and the bound."""
    cfg = uniform.make_config(128, 10 * SR)
    n, nb = cfg.seg_count, cfg.bins
    per_block = lambda t: 8.0 * n * nb * t + 2 * t * rfft(256)  # noqa: E731
    assert rl.stream_conv_cost(cfg, 1).flops == per_block(1)
    assert rl.stream_conv_cost(cfg, 4096).flops < 0.2 * per_block(4096)

    tcfg, _ = two_stage.init(np.zeros(480000, np.float32), 128, 480000)
    c = rl.two_stage_stream_cost(tcfg, 2048)
    # the port's counts: ~8.3 MB and ~0.13 GFLOP (JAX's DFT-as-matmul
    # counts are 10-100x larger)
    assert 5e7 < c.flops < 5e8
    assert 5e6 < c.bytes < 5e7
    u = rl.utilization(c, 1e-3, H100)
    assert set(u) == {"mfu", "hbm_util", "gflops", "gbps", "bound_us", "bound_by", "share"}
    assert u["mfu"] > 0 and u["hbm_util"] > 0 and 0 < u["share"] < 1
    assert u["bound_by"] == "bytes"


# ---- hand-computed costs at small shapes ---------------------------------------------

def test_fft_cost_bound_and_utilization_by_hand():
    assert rl.fft_cost(32).flops == 2.5 * 32 * 5
    assert rl.fft_cost(16, count=3, real=False).flops == 3 * 5.0 * 16 * 4
    assert rl.fft_cost(1).flops == 0.0
    c = rl.Cost(flops=67e6, bytes=6.7e6, carried=1e6)  # 1 us of FLOPs, 2 us of bytes
    b = rl.bound(c, H100)
    assert b["bound_us"] == pytest.approx(2.0) and b["bound_by"] == "bytes"
    assert b["l2_resident"] is True
    b = rl.bound(rl.Cost(flops=670e6, bytes=6.7e6), H100)
    assert b["bound_us"] == pytest.approx(10.0) and b["bound_by"] == "operations"
    assert b["l2_resident"] is False  # nothing carried
    assert rl.bound(rl.Cost(bytes=1.0, carried=H100.l2_bytes + 1), H100)["l2_resident"] is False
    u = rl.utilization(c, 4e-6, H100)
    assert u["share"] == pytest.approx(0.5)
    assert u["gflops"] == pytest.approx(67e6 / 4e-6 / 1e9)
    assert u["mfu"] == pytest.approx(0.25) and u["hbm_util"] == pytest.approx(0.5)
    assert c + c == rl.Cost(134e6, 13.4e6, 2e6) and c.scaled(3) == rl.Cost(201e6, 20.1e6, 3e6)


def test_stream_conv_cost_by_hand():
    """b = 16, N = 5, T = 3: ring and table read, three rows written, the
    blocks and overlap in and out, the twiddles; the per-block MAC (fewer
    than the block-axis form at m = 8) and a forward and an inverse
    transform a block."""
    cfg = UniformConfig(block_size=16, seg_count=5, ir_len=80)
    nb = 17
    c = rl.stream_conv_cost(cfg, 3)
    assert c.bytes == 5 * nb * 8 * 2 + 3 * nb * 8 + (3 * 16 + 16) * 4 * 2 + 2 * 16 * 8
    direct, axis = 8 * 5 * nb * 3, nb * (2 * cfft(8) + 6 * 8)
    assert direct < axis
    assert c.flops == direct + 6 * rfft(32)
    assert c.carried == 5 * nb * 8 * 2 + 16 * 4
    # two voices: all but the twiddles twice; bf16 ring and table halve them
    assert rl.stream_conv_cost(cfg, 3, voices=2).bytes == 2 * (c.bytes - 256) + 256
    bf = rl.stream_conv_cost(cfg, 3, ring_item=4, table_item=4)
    assert c.bytes - bf.bytes == (5 * nb * 2 + 3 * nb) * 4
    # 64 segments over 64 blocks take the block-axis form: m = npo2(63 + 64)
    long = rl.stream_conv_cost(UniformConfig(block_size=16, seg_count=64, ir_len=1024), 64)
    assert nb * (2 * cfft(128) + 6 * 128) < 8 * 64 * nb * 64
    assert long.flops == nb * (2 * cfft(128) + 6 * 128) + 128 * rfft(32)


def test_crossfade_stream_cost_by_hand():
    """B3's step (T = 1) and the two-engine call: one history, two tables,
    two overlaps, one forward and two inverse transforms a block."""
    cfg = UniformConfig(block_size=16, seg_count=5, ir_len=80)
    nb = 17
    one = rl.crossfade_stream_cost(cfg, 1)
    assert one.bytes == (5 * nb + 2 * 5 * nb + nb) * 8 + 2 * 16 * 8 + 6 * 16 * 4
    assert one.flops == 8 * 2 * 5 * nb + 3 * rfft(32)
    t = 40  # 5 segments: the per-block MAC is the fewer even over 40 blocks
    c = rl.crossfade_stream_cost(cfg, t)
    assert c.flops == 8 * 2 * 5 * nb * t + 3 * t * rfft(32)
    assert c.bytes == (3 * 5 * nb + 5 * nb) * 8 + 256 + (2 * t * 16 + 4 * 16) * 4
    # 64 segments over 64 blocks: the block-axis form at m = npo2(63 + 64)
    c = rl.crossfade_stream_cost(UniformConfig(block_size=16, seg_count=64, ir_len=1024), 64)
    assert c.flops == nb * (3 * cfft(128) + 2 * 6 * 128) + 3 * 64 * rfft(32)


def small_two_stage(tail0: bool = True, tail: bool = True) -> TwoStageConfig:
    h = UniformConfig(block_size=16, seg_count=4, ir_len=64)
    return TwoStageConfig(head_block=16, tail_block=64, head=h, tail0=h if tail0 else None,
                          tail=UniformConfig(block_size=64, seg_count=3, ir_len=192)
                          if tail else None)


def test_two_stage_costs_by_hand():
    """Head block 16, period 4, head and tail0 4 segments, big tail 3
    segments at 64; B2's step and an aligned call of two periods."""
    cfg = small_two_stage()
    nb, tnb = 17, 65
    step = rl.two_stage_step_cost(cfg)
    # ring and two tables read, a row written, twiddles; 5 vectors in, 5 out
    assert step.bytes == (4 * nb * 3 + nb) * 8 + 2 * 16 * 8 + 10 * 16 * 4
    assert step.flops == 8 * 2 * 4 * nb + 3 * rfft(32)

    c = rl.two_stage_stream_cost(cfg, 8)
    heads_bytes = (4 + 8 + 4) * nb * 8 + (2 * 8 * 16 + 4 * 16) * 4
    heads_flops = 8 * rfft(32) + 8 * 8 * nb * 8 + 2 * 8 * rfft(32)  # per-block MAC wins
    assert heads_flops - 8 * rfft(32) < nb * (2 * cfft(16) + 6 * 16) + 8 * rfft(32)  # combined
    period = (4 * 16 + 4 * 16 + 8 * 16) * 4  # period input out; tail0 pending in, 2 periods out
    tail_bytes = (3 * tnb * 2 + 2 * tnb) * 8 + 2 * 64 * 4 + (2 * 64 + 2 * 64) * 4
    tail_flops = 8 * 3 * tnb * 2 + 4 * rfft(128)
    assert c.bytes == heads_bytes + period + tail_bytes + 2 * 16 * 8 + 2 * 64 * 8
    assert c.flops == heads_flops + 2 * 8 * 16 + tail_flops
    assert c.carried == (3 * 4 * nb + 2 * 3 * tnb) * 8 + (2 * 16 + 4 * 16 + 64 + 2 * 64) * 4
    with pytest.raises(ValueError, match="multiple of the period"):
        rl.two_stage_stream_cost(cfg, 6)
    # no big tail: head + tail0 and their buffers only; one sum a sample
    short = rl.two_stage_stream_cost(small_two_stage(tail=False), 8, voices=3)
    one = heads_bytes + period
    assert short.bytes == 3 * one + 2 * 16 * 8
    assert short.flops == 3 * (heads_flops + 8 * 16)


def test_farm_costs_by_hand():
    """B5's step, and a farm call: the heads read the farm's 2n - 1-row
    history (no tail0 period buffers), the big tail also writes ``pre``."""
    cfg = small_two_stage()
    nb, tnb = 17, 65
    step = rl.farm_tail_step_cost(cfg, 5, 2, tail_item=4)
    assert step.bytes == 5 * ((3 * 2 + 2) * tnb * 4 + (2 * 2 + 1) * tnb * 8)
    assert step.flops == 5 * 8 * 2 * 3 * tnb
    c = rl.farm_cost(cfg, 2, 8)
    heads = (7 + 8 + 7) * nb * 8 + (2 * 8 * 16 + 2 * 16) * 4
    tail = (3 * tnb * 2 + 2 * tnb + tnb) * 8 + 2 * 64 * 4 + (2 * 64 + 2 * 64) * 4
    assert c.bytes == 2 * (heads + tail) + 2 * 16 * 8 + 2 * 64 * 8
    heads_flops = 8 * rfft(32) + 8 * 8 * nb * 8 + 2 * 8 * rfft(32)
    assert c.flops == 2 * (heads_flops + 8 * 3 * tnb * 2 + 4 * rfft(128) + 2 * 8 * 16)
    # the short-IR farm is the aligned two-stage call over the voices
    short = small_two_stage(tail=False)
    assert rl.farm_cost(short, 3, 8) == rl.two_stage_stream_cost(short, 8, voices=3)


def test_farm_cost_is_heads_plus_tail():
    """farm_cost ties to kernel B6's farm_heads_cost plus the big tail's
    terms (its ring and table, pre, the pending period outputs, the stage
    outputs summed, the tail transform's twiddles), in both storages; the
    head term is the by-hand one of test_farm_costs_by_hand."""
    cfg = small_two_stage()
    nb = 17
    for voices, t, item in ((2, 8, rl.C64), (3, 24, rl.BF16_PAIR), (1, 4, rl.C64)):
        q, b, tb = t // cfg.period, cfg.head_block, cfg.tail_block
        tail = (rl._big_tail(cfg.tail, q, item) + rl.Cost(bytes=(tb + 1) * rl.C64)
                + rl._tail_buffers(tb, q) + rl.Cost(flops=2 * t * b))
        want = rl.farm_heads_cost(cfg, voices, t) + tail.scaled(voices) + rl._twiddles(tb)
        assert rl.farm_cost(cfg, voices, t, item) == want
    heads = rl.farm_heads_cost(cfg, 2, 8)
    assert heads.bytes == 2 * ((7 + 8 + 7) * nb * 8 + (2 * 8 * 16 + 2 * 16) * 4) + 2 * 16 * 8
    assert heads.flops == 2 * (8 * rfft(32) + 8 * 8 * nb * 8 + 2 * 8 * rfft(32))
    with pytest.raises(ValueError, match="multiple of the period"):
        rl.farm_heads_cost(cfg, 2, 6)
    # config 5's farm (n = 256, block 128, an 8-period call of 2048 blocks):
    # overlap-save at M = 1024 (4 segments of 513 rows) beats the one
    # 4096-point transform; 9.85 GFLOP for 128 voices, bound by operations
    tb, n_t = farm2._tail_segments(128, 60 * SR)
    h = uniform.make_config(128, tb)
    fcfg = TwoStageConfig(head_block=128, tail_block=tb, head=h, tail0=h,
                          tail=uniform.make_config(tb, n_t * tb))
    os_1024 = 129 * 4 * (2 * cfft(1024) + 6 * 1024)
    assert os_1024 < 129 * (2 * cfft(4096) + 6 * 4096)
    big = rl.farm_heads_cost(fcfg, 128, 2048)
    assert big.flops == 128 * (2 * 2048 * rfft(256) + os_1024)
    # 2n - 1 history rows and both tables read, 511 rows written; blocks and overlap
    assert big.bytes == 128 * ((511 + 512 + 511) * 129 * 8 + 2 * (2048 * 128 + 128) * 4) \
        + 2 * 128 * 8
    assert rl.bound(big, H100)["bound_by"] == "operations"
    assert us(big) == pytest.approx(147.07, rel=1e-4)


# ---- invariance: one function, one cost -----------------------------------------------

def test_b4_and_the_conv_core_share_one_cost():
    """B4's wrapper (its padded segment count) and the conv core built at
    that count compute one function: equal configs, equal outputs, one
    Cost; B4p differs only by its bf16 table."""
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(300) * 0.1).astype(np.float32)
    x = rng.standard_normal(8 * 16).astype(np.float32)
    st = CudaStreamingConvolver(ir, 16, len(ir), chunk=4, device="cpu")
    core = FFTConvolver(ir, 16, st.cfg.seg_count * 16, device="cpu")
    assert (st.cfg.seg_count, core.cfg.seg_count) == (20, 20)  # 19 segments, padded
    calls = uniform._stream_conv.calls
    y_core = core.process(x)
    assert uniform._stream_conv.calls == calls + 1
    np.testing.assert_allclose(st.process(x).numpy(), y_core.numpy(), atol=1e-5)
    assert rl.stream_conv_cost(st.cfg, 8) == rl.stream_conv_cost(core.cfg, 8)
    bf = rl.stream_conv_cost(st.cfg, 8, table_item=rl.BF16_PAIR)
    assert rl.stream_conv_cost(st.cfg, 8).bytes - bf.bytes == 20 * 17 * 4


def test_two_stage_forms_share_one_cost():
    """The aligned two-stage call in every form (fused MULTI, fused
    SEPARATE, separate streams; CHRONO or ring big tail) from one state:
    different stream cores run, the outputs agree, the config is the same
    object afterwards, so the call has one Cost; the wrapper in CHRONO and
    back on its ring gives the same Cost too."""
    rng = np.random.default_rng(1)
    ir = (rng.standard_normal(1200) * 0.05).astype(np.float32)
    eng = TwoStageFFTConvolver(ir, 16, len(ir), device="cpu")
    cfg = eng.cfg
    assert cfg.tail is not None and cfg.head == cfg.tail0
    t = 3 * cfg.period
    x = torch.from_numpy(rng.standard_normal((t, 16)).astype(np.float32))
    want = rl.two_stage_stream_cost(cfg, t)
    outs, cores = [], set()
    keep = two_stage.FUSED_MULTI_MAX_ROWS
    try:
        for fuse, chrono, rows in ((True, True, 1 << 30), (True, True, 0), (True, False, keep),
                                   (False, True, keep), (False, False, keep)):
            two_stage.FUSED_MULTI_MAX_ROWS = rows
            st = eng.state.clone()
            khats = two_stage.stream_khats(cfg, st, t, want_tail=True if chrono else None)
            tail = two_stage.tail_to_chrono(cfg, st, 64) if chrono else None
            before = (uniform._stream_conv.calls, two_stage._fused_small_streams.calls,
                      uniform.stream_conv_chrono.calls)
            outs.append(two_stage.process_stream_aligned(cfg, st, x, khats, fuse_small=fuse,
                                                         tail_chrono=tail))
            cores.add((uniform._stream_conv.calls - before[0],
                       two_stage._fused_small_streams.calls - before[1],
                       uniform.stream_conv_chrono.calls - before[2]))
            assert rl.two_stage_stream_cost(eng.cfg, t) == want
    finally:
        two_stage.FUSED_MULTI_MAX_ROWS = keep
    # the big tail's ring path at q = 3 is its block loop: a sixth form
    assert cores == {(0, 1, 1), (0, 1, 0), (2, 0, 1), (2, 0, 0)}
    for y in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0].numpy(), atol=1e-5)
    # the wrapper: aligned calls enter CHRONO, a block call leaves it
    eng.process(x.reshape(-1))
    assert eng._tail_chrono is not None
    assert rl.two_stage_stream_cost(eng.cfg, t) == want
    eng.process(x[0])
    assert eng._tail_chrono is None
    assert rl.two_stage_stream_cost(eng.cfg, t) == want


def test_kernel_and_plain_paths_share_one_cost():
    """A per-block wrapper costs the same whichever step it runs (its
    kernel or the plain version), and the same as the engine it serves:
    B1 is the one-block uniform stream, B3 the one-block crossfade."""
    ir = (np.random.default_rng(2).standard_normal(500) * 0.1).astype(np.float32)
    w = CudaFFTConvolver(ir, 16, len(ir), device="cpu")
    plain = w.clone()
    plain._step = cuda_engine.block_step_plain
    assert w._step is not plain._step
    assert rl.stream_conv_cost(w.cfg, 1) == rl.stream_conv_cost(plain.cfg, 1) \
        == rl.stream_conv_cost(FFTConvolver(ir, 16, len(ir), device="cpu").cfg, 1)
    xf = CudaCrossfadeConvolver(ir, 16, len(ir), crossfade_samples=64, device="cpu")
    cc = CrossfadeConvolver(FFTConvolver(ir, 16, len(ir), device="cpu"), len(ir), 16, 64)
    assert rl.crossfade_stream_cost(xf.cfg, 1) == rl.crossfade_stream_cost(cc.cfg, 1)
    two = CudaTwoStageConvolver(ir, 16, len(ir), device="cpu")
    assert two.cfg == TwoStageFFTConvolver(ir, 16, len(ir), device="cpu").cfg


# ---- the bounds at the flagship and farm shapes --------------------------------------

def old_step(n, b, tables, item, vin, vout):
    """The per-block kernels' accounting before the module
    (``chip_smoke.step_bound``): bytes and FLOPs."""
    nb = b + 1
    nbytes = ((1 + tables) * n * nb + nb) * item + 2 * b * 8 + (vin + vout) * b * 4
    return nbytes, 8 * tables * n * nb + (1 + tables) * rfft(2 * b)


def us(c) -> float:
    return rl.bound(c, H100)["bound_us"]


def test_kernel_bounds_reproduced_from_the_shapes():
    """B1, B1p, B2, B3 (flagship) and B5, B5p (the 128-voice farm of 60 s
    IRs) keep their bounds: the same bytes and FLOPs as before, byte-bound
    at 2.31, 1.16, 0.06, 3.47, 2013 and 1092 us.  B4 and B4p (30 s IR, 11264
    segments, 64-block calls) move from the direct MAC's FLOP bound (11.1
    us) to their byte terms, 6.98 and 5.25 us: the block-axis form needs
    0.31 GFLOP."""
    u = uniform.make_config(128, 10 * SR)
    cfg = flagship()
    assert (u.seg_count, cfg.tail_block, cfg.head.seg_count, cfg.tail.seg_count) \
        == (3750, 8192, 64, 57)
    cases = {"B1": (rl.stream_conv_cost(u, 1), old_step(3750, 128, 1, 8, 2, 2), 2.312),
             "B1p": (rl.stream_conv_cost(u, 1, ring_item=4, table_item=4),
                     old_step(3750, 128, 1, 4, 2, 2), 1.157),
             "B2": (rl.two_stage_step_cost(cfg), old_step(64, 128, 2, 8, 5, 5), 0.0616),
             "B3": (rl.crossfade_stream_cost(u, 1), old_step(3750, 128, 2, 8, 3, 3), 3.468)}
    for label, (c, (nbytes, flops), bound_us) in cases.items():
        assert (c.bytes, c.flops) == (nbytes, flops), label
        assert us(c) == pytest.approx(bound_us, rel=1e-3), label
        assert rl.bound(c, H100)["bound_by"] == "bytes"
        assert rl.bound(c, H100)["l2_resident"] is True

    tb, n_t = farm2._tail_segments(128, 60 * SR)
    assert (tb, n_t) == (32768, 88)
    h = uniform.make_config(128, tb)
    fcfg = TwoStageConfig(head_block=128, tail_block=tb, head=h, tail0=h,
                          tail=uniform.make_config(tb, n_t * tb))
    lanes = 128 * (tb + 1)
    for item, bound_us in ((8, 2013.3), (4, 1091.8)):
        c = rl.farm_tail_step_cost(fcfg, 128, 8, item)
        assert c.bytes == (2 * 88 + 8) * lanes * item + (2 * 8 + 1) * lanes * 8
        assert c.flops == 8 * 8 * 88 * lanes
        assert us(c) == pytest.approx(bound_us, rel=1e-4)
        assert rl.bound(c, H100)["l2_resident"] is False  # 5.9 GB / 3.0 GB stream from HBM

    n = cuda_stream.padded_seg_count(uniform.make_config(128, 30 * SR).seg_count, 512)
    assert n == 11264
    s30 = uniform.make_config(128, n * 128)
    old_bytes = n * 129 * 16 + 64 * 129 * 8 + 2 * 128 * 8 + 2 * 64 * 128 * 4 + 2 * 128 * 4
    old_flops = 8 * 64 * n * 129 + 2 * 64 * rfft(256)
    for item, bound_us in ((8, 6.980), (4, 5.245)):
        c = rl.stream_conv_cost(s30, 64, table_item=item)
        assert c.bytes == old_bytes - n * 129 * (8 - item)
        assert c.flops == 129 * (2 * cfft(16384) + 6 * 16384) + 128 * rfft(256)
        assert 0.30e9 < c.flops < 0.32e9 and c.flops < 0.5 * old_flops
        assert rl.bound(c, H100)["bound_by"] == "bytes"
        assert us(c) == pytest.approx(bound_us, rel=1e-3)
    assert old_flops / H100.fp32_flops_per_s * 1e6 == pytest.approx(11.1, rel=0.01)


def test_batched_bounds_at_the_benchmark_shapes():
    """The flagship aligned call (T = 3968) is ~16 MB of compulsory traffic,
    byte-bound near 4.8 us; the short call and the farm's big-tail step
    follow from the same model."""
    cfg = flagship()
    c = rl.two_stage_stream_cost(cfg, 3968)
    assert 15e6 < c.bytes < 17e6
    assert rl.bound(c, H100)["bound_by"] == "bytes"
    assert 4.5 < us(c) < 5.0
    assert us(rl.two_stage_stream_cost(cfg, 128)) < us(c)
    # B2's big-tail step at a period end: a one-block stream at 8192
    tail = rl.stream_conv_cost(cfg.tail, 1)
    assert tail.bytes == (2 * 57 + 1) * 8193 * 8 + 2 * 8192 * 8 + 4 * 8192 * 4
    assert 2.3 < us(tail) < 2.4


# ---- the card, JAX's rates, the gate, the import boundary ---------------------------

def test_peaks_come_from_the_card(monkeypatch):
    with pytest.raises(ValueError, match="cpu"):
        rl.peaks("cpu")
    with pytest.raises(ValueError, match="cpu"):
        rl.peaks(torch.device("cpu"))
    names = {}

    def props(dev):
        return types.SimpleNamespace(name=names["name"])

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    names["name"] = "NVIDIA A100-SXM4-80GB"
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        rl.peaks("cuda")
    names["name"] = "NVIDIA H100 80GB HBM3"
    assert rl.peaks(0) is rl.peaks("cuda:0") is H100
    assert (H100.hbm_bytes_per_s, H100.fp32_flops_per_s) == (3.35e12, 67e12)


@pytest.mark.parametrize("flops,nbytes,seconds", [(3.1e8, 2.3e7, 3.8e-5),
                                                  (2.4e10, 6.7e9, 2.7e-3), (1.0, 1.0, 1.0)])
def test_utilization_rates_match_jax(flops, nbytes, seconds):
    """``gflops`` and ``gbps`` do not depend on the peaks: the port's equal
    JAX's for the same counts and seconds."""
    ours = rl.utilization(rl.Cost(flops, nbytes), seconds, H100)
    theirs = jroofline.utilization(jroofline.Cost(flops, nbytes), seconds)
    assert ours["gflops"] == theirs["gflops"] and ours["gbps"] == theirs["gbps"]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_shares_gate_above_one(capsys):
    """``chip_smoke.shares`` takes its bound from this checkout's module
    (loaded by path) and fails a path whose measured time beats it."""
    cs = load_chip_smoke()
    mod = cs.roofline()
    assert mod is not rl and mod.__file__ == rl.__file__
    cfg = flagship()
    cost = mod.two_stage_step_cost(cfg)
    assert vars(cost) == vars(rl.two_stage_step_cost(cfg))
    crd = cs.Card(mod.H100_SXM, "NVIDIA H100 80GB HBM3, 700.00 W")
    bound_s = rl.bound(cost, H100)["bound_ms"] / 1e3
    ok = cs.shares("B2 step", cost, crd, device=10 * bound_s, event=20 * bound_s)
    assert ok["share_device"] == pytest.approx(0.1) and ok["share_event"] == pytest.approx(0.05)
    assert "700.00 W" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cs.shares("B2 step", cost, crd, device=0.5 * bound_s)
    assert "B2 step: share of the device time" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cs.shares("B2 step", cost, crd, device=0.0)


def test_roofline_imports_no_jax():
    """In a fresh interpreter (the repository's conftest imports JAX),
    importing the module loads nothing of JAX or the JAX package."""
    script = ("import sys\n"
              "import fft_convolution_tpu_torch.utils.roofline\n"
              "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
              "'fft_convolution_tpu') or m.startswith(('jax.', 'jaxlib.', "
              "'fft_convolution_tpu.')))\n"
              "print(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
