"""On-card smoke run of the PyTorch/CUDA port (``fft_convolution_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught).  Every path is
driven with every launch counter set to 0 just before it and read just
after; the flagship shape is block 128 and a 10 s 48 kHz IR.  Every bound
comes from the port's cost model, ``fft_convolution_tpu_torch/utils/
roofline.py`` (:func:`roofline` loads it by path; the card's peaks from
``roofline.peaks``, which fails on a card it does not know): the least
time the card could take for the work of the function a path computes,
whatever implements it.  Each share is that bound over a measured time,
printed with the card's name and power limit and gated <= 1 (a share above
1 means the count is wrong; :func:`shares`).

1. build the hand-written kernels (one nvcc per source, ``sm_90a``) and
   print the card;
2. ``CudaFFTConvolver`` (kernel B1) for 128 blocks and
   ``CudaTwoStageConvolver`` (kernel B2, big tail every 64 blocks) for 192
   blocks at the flagship shape; the big tail gated to three CUDA-graph
   replays on the wrapper's side stream and none in line;
3. the same wrappers through the kernels' plain PyTorch versions on the card,
   held to 1e-4 (max abs) against the kernel path and against a float64
   direct convolution;
4. both wrappers over the recorded golden (``tests/golden``), held to 1e-5;
5. per-block latency of B1 and B2, kernel path against plain path
   (recorded, not gated);
6. ``CudaCrossfadeConvolver`` (kernel B3) at the flagship shape for 192
   blocks: an update at block 64 with a 4-block fade and a second update
   mid-fade (the pending slot); against its plain path (1e-4), and against
   float64 convolutions with the first IR before the update and with the
   last IR once both fades have ended (1e-4);
7. ``CudaStreamingConvolver`` (kernel B4: three CUDA launches a call,
   forward FFTs, the MAC fed from shared memory by asynchronous copies, and
   the finish) with a 30 s IR (11264 segments after padding to the 512
   chunk) in calls of 64 blocks until the ring has wrapped: f32 table
   against its plain path and ``scipy.signal.fftconvolve`` in float64
   (1e-4); bf16 table against its plain path (1e-4) and the f32 path (5e-3
   of the output scale);
8. ``CudaFFTConvolver(storage="bf16_packed")`` (kernel B1p) at the flagship
   shape for 128 blocks, against its plain path (1e-4) and the f32 kernel
   path (5e-3 of the output scale);
9. latency of B3 and B1p per block and of B4 and B4p per 64-block call
   (and per block: a call over 64), kernel path against plain path
   (recorded, not gated);
10. ``ReverbFarm`` (kernels B5 and B6, f32 tail) at the JAX farm's benchmark shape:
    128 voices of random 60 s 48 kHz IRs (scale 0.002, seeded on the card),
    block 128 — tail block 32768, period 256, head and tail0 256 segments,
    big tail 88 segments (checked).  Calls of 8 periods until the tail phase
    has wrapped (11), then of 2, 1, 4 and 3 periods: one B5 and one B6
    launch per call, kernel path against the plain path (both kernels'
    plain versions) over all voices (1e-4), the head path's exit state
    against the plain path's (1e-4 a field), and two voices against
    ``scipy.signal.fftconvolve`` in float64 over the whole stream (1e-4);
11. at a period boundary ``update`` (new IRs for every voice), then
    ``update_voices`` on 3 voices, then 2 calls (B6's suppress pass on the
    first): kernel against plain path (1e-4, output and the head path's exit
    state), and the untouched voices bit-identical to a clone that skipped
    ``update_voices``;
12. the same farm with ``tail_dtype=torch.bfloat16`` (B5's bf16 form, B6)
    over the stream of phase 10: against its plain path (1e-4) and against
    the f32 farm (5e-3 of the output scale);
13. latency of 2- and 8-period farm calls, both storages, kernel path
    against plain path, with real-time voices (voices x audio seconds /
    wall seconds), and the time of the B5 step alone against its plain
    version (recorded, not gated); the step's share of its bound
    (``roofline.farm_tail_step_cost``) and each call's (``farm_cost``, the
    kernel path's best event median), gated.  Then the head path
    (:func:`farm_head_path`): B6 against ``heads_step_plain`` on one
    8-period call from a farm's state with the big tail's delay line, with
    no voice and with three voices suppressed: the output and every exit
    field (1e-4) and a replay from the same state bit-equal; the head path
    alone in turns (the plain version over cached meta-spectra, the
    parent's form, then B6), event ms and a ``torch.profiler`` window each
    (B6 gated to its three kernels once a call) and their shares of
    ``roofline.farm_heads_cost`` (gated); the 8-period farm call in the
    kernel form and in the parent's form (``farm2_stream`` with the plain
    head path over cached meta-spectra and B5), f32 and bf16 tails: events
    in turns, device microseconds split into B6, B5 and the rest, and the
    peak memory of one call (the state held plus
    ``torch.cuda.max_memory_allocated`` over the call) beside
    ``farm2_bytes_per_voice`` x 128, gated within 2 % for the kernel form;
    then one call of the most blocks a call takes (4096: the length
    ``farm2_init``'s guard prices), its peak gated within 2 % of the model
    at that length.  A ``{"farm_head_path": ...}`` line records it;
14. a ``torch.profiler`` window over 256 warm steps of each per-block kernel
    (B1, B1p, B2, B3) and 24 warm 64-block calls of B4 and B4p, each kernel
    wrapper called directly on its wrapper's operands: device microseconds
    per step (CUDA kernel events only), the same by CUDA kernel name (B4's
    forward, MAC and finish apart), and CUDA kernels per step, gated to 1
    for the one-launch kernels B1, B1p, B2 and B3 and to 3 (three kernels,
    once each) for B4 and B4p; each kernel's share of its bound in device
    time (``roofline.stream_conv_cost`` for B1, B1p, B4, B4p,
    ``two_stage_step_cost`` for B2, ``crossfade_stream_cost`` for B3;
    gated);
15. the batched streams (``torch.fft`` on the card; no hand-written kernel
    lies on them, so every launch counter must stay 0) at the JAX package's
    benchmark shapes, uncut: the flagship ``TwoStageFFTConvolver`` (block
    128, 10 s IR, T = 3968; and the same engine at two periods, T = 128),
    config 1 (``FFTConvolver``, 1 s IR, T = 1674), config 2 (the uniform
    farm, 2 voices, block 256, 5 s IRs, T = 1111), config 3
    (``TwoStageFFTConvolver``, 30 s IR, T = 32 periods = 4096), config 4
    (the crossfade morph on two 1 s IRs mid-fade, T = 650) and a short-IR
    ``ReverbFarm`` (128 voices of 512-tap IRs, T = 2046).  Each shape:
    aligned calls with the state carried (five at the flagship, whose CHRONO
    history compacts on the fourth, gated; two elsewhere), gated to each
    stream core's expected call count (:func:`core_calls`: the ring's conv
    core, the fused head+tail0 front end, the CHRONO big tail; a two-stage
    call runs the last two once each), held to 1e-4 against a float64
    ``torch.fft`` convolution on the card and against the same engine's
    block loop; xRT (audio seconds over the median CUDA-event seconds of a
    warm call, meta-spectra cached) of the batched call and of the block
    loop (timed over at most 640 blocks and scaled); the CUDA kernels and
    device microseconds of one call (``torch.profiler``); the call's bound
    (``roofline.two_stage_stream_cost``, ``stream_conv_cost``,
    ``crossfade_stream_cost``, ``farm_cost``) and its shares of the device
    microseconds and of the event ms (gated).  At each two-stage shape,
    printed only: the same call in each form of :data:`TWO_STAGE_FORMS`
    (fused front end and CHRONO tail on or off, and the fused side passes
    in the form ``fused_uses_multi`` does not pick), event ms, device
    microseconds and CUDA kernels each, from one state and input in one
    run, each with its two shares of the shape's one bound (gated).  Then
    the conv core at B4's shape (30 s IR padded to B4's 11264 segments, T
    = 64), printed, beside B4's device time from phase 14: both costed by
    ``stream_conv_cost`` (the two costs gated equal) and both shares gated;
    and cuFFT along dim -2 against the same rows laid out along dim -1.  A
    ``{"batched_streams": ...}`` line records it all;
16. the host runtime (``runtime/``, ``utils/``, ``examples/``): the native
    library built with g++; ``HostEngine`` (numpy blocks in and out) over
    B1, B2 and B3 for 512 blocks against the same wrapper fed card tensors
    (1e-6, and whether bit-equal); B2's race gate (:func:`race_gate`): three
    runs from the flagship wrapper's state over at least
    :data:`RACE_PERIODS` periods of numpy blocks through ``HostEngine``, as
    it runs, with its side stream held back :data:`RACE_HOLD_MS` before each
    period end, and synchronised after every block, gated bit-equal in
    outputs and exit snapshot, with one big-tail graph replay a period end
    and none in line (and the held-back run gated slower by the holds, so
    the hold held); the host-callback latency of B1, B1p, B2
    and B3 over 2000 warm numpy blocks, the copies and the sync included
    (median gated below the 2.667 ms block; p99 and max printed) beside the
    card-tensor latency of phases 5 and 9, B2's split into the blocks that
    end a period (the big tail is enqueued there) and the others, the
    B2 run gated to one graph replay a period end; the big-tail step's
    CUDA-event time alone, eager and as the wrapper's graph replay, and the
    eager step's share of its bound (``roofline.stream_conv_cost`` at the
    tail block, gated);
    ``StreamingConvolver`` over the
    flagship ``TwoStageFFTConvolver`` fed 441-sample pushes, then a push
    back to the block boundary and a block-aligned push of three periods
    (the batched route: the fused front end and the CHRONO tail must run
    once each), against a float64 convolution (1e-4); ``RealTimeDispatcher`` over B3 fed 441-sample
    pushes for 4000 blocks by the lockstep callback of ``serve_morph.serve``
    (it waits on the dispatcher, so it cannot underrun: its wall time is
    throughput) with a morph posted through ``RealTimeDispatcher.update`` a
    third of the way in, the windows before the morph and after the fade
    against float64 convolutions with the two IRs (1e-4); the same over
    1000 blocks by the wall-clock callback of ``serve_morph.serve_paced``
    (one 441-sample buffer in and out each 9.19 ms, one buffer and one
    block of output latency): underruns and lost input printed, not gated,
    and the windows gated only when no underrun shifted the output;
    checkpoints of a mid-stream B1p
    state and a mid-fade B3 state restored into fresh wrappers, 64 more
    blocks bit-equal to the originals; the ``serve_morph`` and
    ``reverb_farm`` examples (8 voices of 4 s IRs) as functions.  A
    ``{"host_runtime": ...}`` line records it;
17. the mesh (``parallel/``): two gloo ranks on ``cuda:0``
    (``parallel.mesh.run_ranks``; two processes sharing one card, so the
    times are the collectives' cost there, not a multi-card scaling), each
    counting every kernel wrapper's launches around each path.  ``sp`` per
    block: ``ShardedFFTConvolver`` at the flagship shape (3750 segments,
    1875 a rank) for 640 blocks, against ``FFTConvolver`` and a float64
    convolution (1e-4), then an ``update`` to a 2 s IR (the shrunk-ring
    transient) and 320 blocks against ``FFTConvolver`` with the same update;
    the wall ms a block and the all-reduce of one block's ``[B+1]``
    complex64 partial, a card tensor and a host tensor (median of 200).
    ``sp`` per period: ``ShardedTwoStageConvolver`` over phase 10's first
    60 s IR, 2 calls of 4 periods, against ``TwoStageFFTConvolver`` and
    float64 (1e-4).  ``dp``: ``ReverbFarm(mesh=...)`` over phase 10's 128
    IRs, 64 voices a rank, f32 and bf16 tails, 2 calls of 8 periods, each
    rank's slab against the unsharded farm's rows computed here (1e-5; bf16
    5e-3 of the scale) and gated bit-equal, B5 (B5p) and B6 launched exactly
    once a call on each rank and the sp paths launching nothing; each rank's
    call latency.  A ``{"mesh": ...}`` line records it.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches, error and times: the
kernel and plain paths' best CUDA-event medians (``ms``, ``plain_ms``), the
least time the card could take for the kernel's work from its shapes
(``bound_ms``, ``bound_us``, ``bound_by``, ``l2_resident``: the roofline
module's) and its ``share`` of the device time (B5: of the step alone;
``call_bound_us`` and ``call_share``: the 8-period call's),
``library_ms`` (null: no single PyTorch call computes a step), B5's and
B5p's ``dp_mesh`` (phase 17: ranks, launches a rank, error, call ms a
rank), B6's head path alone (phase 13: ``ms`` B6, ``plain_ms`` the plain
version over cached meta-spectra, its profile and share), and for B1-B4
the profile's ``device_us``, ``device_us_by_kernel`` and
``cuda_launches_per_step`` (1 for B1, B1p, B2 and B3, 3 for B4 and B4p,
gated).
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SR, BLOCK, IR_SECONDS = 48000, 128, 10
T_BLOCKS = 3968            # the JAX bench's flagship input length (bench.py:169)
N_UNIFORM, N_TWO_STAGE = 128, 192
PARITY_TOL = 1e-4          # the JAX bench's on-chip kernel gate (bench.py:421-424)
GOLDEN_TOL = 1e-5          # the reference's 1000-block stream tolerance
TIMED_BLOCKS, WARMUP_BLOCKS = 512, 64
PACKED_REL_TOL = 5e-3      # bf16 storage, of the output scale (bench.py:421-424)
XFADE_BLOCKS, XFADE_UPDATE, XFADE_FADE = 192, 64, 4 * BLOCK
STREAM_SECONDS, STREAM_CALL, STREAM_CALLS = 30, 64, 180  # 11520 blocks > 11264
STREAM_SEGS = 11264        # B4's ring: the 30 s IR's 11250 segments padded to the 512 chunk
STREAM_TIMED, STREAM_WARMUP = 32, 4                      # calls
# the JAX farm benchmark's shape (benchmarks/configs.py:271-333, config 5)
FARM_VOICES, FARM_SECONDS, FARM_SCALE = 128, 60, 0.002
FARM_PERIODS = [8] * 11 + [2, 1, 4, 3]  # 11 x 8 = 88: the tail phase wraps
FARM_SHAPES = (32768, 256, 256, 256, 88)  # tail block, period, head, tail0, tail
FARM_UPDATED = [3, 64, 127]
FARM_TIMED = {2: (2, 6), 8: (2, 4)}       # periods per call: (warm-up, timed) calls
HEAD_PERIODS = 8                          # B6 alone and the profiled farm calls (phase 13)
HEAD_WARMUP, HEAD_TIMED, HEAD_PROFILED = 2, 6, 4  # calls
MODEL_TOL = 0.02                          # farm2_bytes_per_voice against the measured peak
GUARD_SEED = 15                           # the input of the guard-shape farm call (phase 13)
PROFILE_STEPS, PROFILE_WARMUP = 256, 64   # per-block kernels (phase 14)
PROFILE_CALLS, PROFILE_CALL_WARMUP = 24, 4  # B4 calls
# phase 15: the JAX benchmarks' stream shapes (bench.py:163-178,
# benchmarks/configs.py:92-258) and the values they must resolve to
FLAGSHIP_PERIODS, CONFIG3_PERIODS = 62, 32  # 62 x 64 = T_BLOCKS
CONFIG3_SECONDS = 30
FLAGSHIP_SHAPES = (8192, 64, 64, 57)        # tail block, period, head, big tail
CONFIG3_SHAPES = (16384, 128, 128, 86)
CONFIG_SEGS_T = {1: (375, 1674), 2: (938, 1111), 4: (375, 650)}  # segments, T
SHORT_FARM = (128, 512, 2046)     # voices, IR taps (tail block 256: no big tail), T
BATCHED_CALLS = 2                 # parity calls a shape, state carried
FLAGSHIP_CALLS = 5                # the flagship's CHRONO history (256 rows) compacts on
FLAGSHIP_ROWS = [118, 180, 242, 118, 180]  # the 4th call: its rows after each call
SHORT_PERIODS = 2                 # the flagship engine at two periods a call, T = 128
# the aligned two-stage forms timed at each two-stage shape: (fused front end,
# CHRONO tail, the fused side passes in the form fused_uses_multi does not pick)
TWO_STAGE_FORMS = {"fused + CHRONO": (True, True, False),
                   "fused + CHRONO, other side-pass form": (True, True, True),
                   "fused alone, ring tail": (True, False, False),
                   "CHRONO alone, separate small streams": (False, True, False),
                   "separate small streams, ring tail": (False, False, False)}
BATCHED_WARMUP, BATCHED_TIMED, BATCHED_PROFILED = 2, 8, 3
LOOP_BLOCKS, LOOP_RUNS = 640, 3   # the block loop's timing window (10 flagship periods)
YARD_WARMUP, YARD_TIMED = 4, 20   # conv-core calls at B4's shape
# phase 16: the host runtime
HOST_PARITY_BLOCKS, HOST_PARITY_TOL = 512, 1e-6  # the adapter only moves data
HOST_LATENCY_BLOCKS, HOST_LATENCY_WARMUP = 2000, 64
BLOCK_MS = BLOCK / SR * 1e3       # 2.667 ms: a callback must return within its block
PUSH, HOST_STREAM_PUSHES = 441, 200               # 441-sample host buffers
DISPATCH_BLOCKS, PACED_BLOCKS = 4000, 1000
STREAM_ALIGNED_PERIODS = 3        # the block-aligned push, in the flagship's periods
CKPT_BLOCKS, CKPT_CONTINUE = 100, 64
TAIL_STEP_REPS = 20               # B2's big-tail step alone, timed
RACE_PERIODS, RACE_HOLD_MS = 6, 20.0  # B2's race gate: periods a run; the side stream held
#                                       back this long before each period end (> a block,
#                                       and > a period of back-to-back host callbacks)
EXAMPLE_VOICES, EXAMPLE_IR_SECONDS = 8, 4
# phase 17: the mesh, two ranks on one card
MESH_RANKS = 2
SP_BLOCKS, SP_UPDATE_BLOCKS, SP_UPDATE_SECONDS = 640, 320, 2  # then a 2 s IR: 750 segments
SP2_PERIODS, SP2_CALLS = 4, 2     # the sharded two-stage engine, 60 s IR
DP_PERIODS, DP_CALLS, DP_TIMED = 8, 2, 4
ALLREDUCE_REPS, ALLREDUCE_WARMUP = 200, 20
MESH_SEED = 17                    # the phase's inputs, drawn on the card
PROFILE_TRIES = 3                 # profiler windows tried while one records no CUDA kernel


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gate(name: str, err: float, tol: float) -> None:
    print(f"{name}: max abs err {err!r} (tol {tol})", flush=True)
    if not err <= tol:  # catches NaN too
        fail(f"{name}: {err!r} > {tol}")


def run_blocks(conv, xs: torch.Tensor) -> torch.Tensor:
    return torch.stack([conv.process(xb) for xb in xs])


def max_abs(a: torch.Tensor, b) -> float:
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return float((a.reshape(-1).double() - b.reshape(-1).double()).abs().max())


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference over the max abs of ``b``."""
    return max_abs(a, b) / float(b.abs().max())


class Counts:
    """Every kernel wrapper's launch counter, zeroed and read together."""

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def zero(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self) -> dict:
        return {k: fn.launches for k, fn in self.wrappers.items()}

    def drive(self, label: str, run, expect: dict):
        """Zero the counts, ``run()``, synchronise, read the counts; fail
        unless exactly the kernels in ``expect`` launched that often."""
        self.zero()
        out = run()
        torch.cuda.synchronize()
        got = self.read()
        print(f"{label} launches: {got}", flush=True)
        want = {k: expect.get(k, 0) for k in got}
        if got != want:
            fail(f"{label}: launch counts {got} != {want}")
        return out


def kernel_counts() -> Counts:
    """Every kernel wrapper of the port, B1 to B6."""
    from fft_convolution_tpu_torch.ops import (cuda_crossfade, cuda_engine, cuda_farm_heads,
                                               cuda_farm_mac, cuda_stream, cuda_two_stage)

    return Counts(B1=cuda_engine.block_step, B1p=cuda_engine.block_step_packed,
                  B2=cuda_two_stage.block_step, B3=cuda_crossfade.block_step,
                  B4=cuda_stream.stream, B4p=cuda_stream.stream_packed,
                  B5=cuda_farm_mac.phased_step, B5p=cuda_farm_mac.phased_step_packed,
                  B6=cuda_farm_heads.heads_step)


def core_calls(since: tuple | None = None) -> tuple:
    """The calls so far of the batched stream cores: the ring's conv core
    (``models.uniform._stream_conv``), the fused head+tail0 front end
    (``models.two_stage._fused_small_streams``) and the CHRONO big tail
    (``models.uniform.stream_conv_chrono``); given an earlier reading, the
    calls since it."""
    from fft_convolution_tpu_torch.models import two_stage, uniform

    now = (uniform._stream_conv.calls, two_stage._fused_small_streams.calls,
           uniform.stream_conv_chrono.calls)
    return now if since is None else tuple(a - b for a, b in zip(now, since))


@functools.cache
def roofline():
    """The port's cost model, this checkout's
    ``fft_convolution_tpu_torch/utils/roofline.py``, loaded by file path:
    it imports nothing of the port, so the engines of another checkout
    (``profile_steps.py`` / ``profile_batched.py --root``, whose parent may
    have no such module) are divided by this one yardstick."""
    path = ROOT / "fft_convolution_tpu_torch" / "utils" / "roofline.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Card:
    """The card every share is taken on: its roofline peaks and
    ``nvidia-smi``'s name and power limit, printed beside each share."""

    peaks: object  # roofline.Peaks
    smi: str


def card() -> Card:
    """Card 0's peaks (``roofline.peaks``: fails for a card it does not
    know) and its ``nvidia-smi --query-gpu=name,power.limit`` line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return Card(roofline().peaks(0), smi)


def shares(name: str, cost, crd: Card, **seconds) -> dict:
    """The bound of ``cost`` on the card (``roofline.bound``) and its share
    of each measured time in ``seconds`` (label: seconds), printed with the
    card's name and power limit.  A share above 1 means the count is wrong
    (no correct implementation beats the bound): fail, naming the path."""
    rl = roofline()
    out = rl.bound(cost, crd.peaks)
    for key, s in seconds.items():
        if not s > 0:
            fail(f"{name}: no {key} time to take a share of ({s!r})")
        out[f"share_{key}"] = rl.utilization(cost, s, crd.peaks)["share"]
    print(f"{name}: bound {out['bound_us']!r} us by {out['bound_by']} ({cost.bytes!r} bytes, "
          f"{cost.flops!r} FLOPs; L2-resident {out['l2_resident']}); share "
          + ", ".join(f"of {key} {out[f'share_{key}']!r}" for key in seconds)
          + f" ({crd.smi})", flush=True)
    for key in seconds:
        if not out[f"share_{key}"] <= 1.0:
            fail(f"{name}: share of the {key} time {out[f'share_{key}']!r} > 1: the "
                 "roofline count is wrong")
    return out


def profile_steps(step, steps: int, warmup: int) -> dict:
    """Device time per step: ``step(i)`` for ``warmup`` calls, then a
    ``torch.profiler`` window over ``steps`` calls.  Sums the CUDA kernel
    events only (not the host-side rows, which would count each kernel
    twice; not memory copies or sets).  A window that recorded no CUDA
    kernel (a profiler dropout) is taken again, up to
    :data:`PROFILE_TRIES` windows (``windows``: how many were taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        step(i)
    torch.cuda.synchronize()
    for windows in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(warmup, warmup + steps):
                step(i)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            break
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / steps
    return {"device_us": sum(by_name.values()),
            "cuda_launches_per_step": len(kernels) / steps, "names": sorted(by_name),
            "by_name": by_name, "windows": windows}


def latency(conv, xs: torch.Tensor, warmup: int = WARMUP_BLOCKS,
            timed_n: int = TIMED_BLOCKS) -> dict:
    """Per-call latency of ``conv.process`` on inputs already on the card.
    ``event_ms``: CUDA events around each call, no synchronisation in the
    loop (device time from the call's start to its last kernel, host launch
    gaps included).  ``enqueue_ms``: host clock around each of those calls
    (the host's work to issue one; where it exceeds the device's time a
    call, the host sets ``event_ms``).  ``sync_ms``: host clock around each
    call plus a synchronise (the real-time callback shape)."""
    for xb in xs[:warmup]:
        conv.process(xb)
    torch.cuda.synchronize()
    timed = xs[warmup:warmup + timed_n]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in timed]
    enqueue = []
    for (start, end), xb in zip(events, timed):
        t0 = time.perf_counter()
        start.record()
        conv.process(xb)
        end.record()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    ev = [s.elapsed_time(e) for s, e in events]
    sync = []
    for xb in timed:
        t0 = time.perf_counter()
        conv.process(xb)
        torch.cuda.synchronize()
        sync.append((time.perf_counter() - t0) * 1e3)
    return {"event_ms": statistics.median(ev), "event_max_ms": max(ev),
            "enqueue_ms": statistics.median(enqueue), "sync_ms": statistics.median(sync),
            "blocks": len(ev)}


def conv64(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """The first ``x.shape[-1]`` samples of each row of ``x`` convolved with
    ``ir`` (one row, or one a row of ``x``), in float64 with ``torch.fft``
    on ``x``'s device."""
    n = x.shape[-1]
    nfft = 1 << (n + ir.shape[-1] - 2).bit_length()
    spec = torch.fft.rfft(x.double(), nfft) * torch.fft.rfft(ir.double(), nfft)
    return torch.fft.irfft(spec, nfft)[..., :n]


def err64(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference, taken in float64."""
    return float((a.double() - b.double()).abs().max())


def event_ms(thunks) -> list[float]:
    """The CUDA-event span of each call in ``thunks``, issued back to back
    with no synchronise between them."""
    events = []
    for fn in thunks:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def batched_streams(dev, counts: Counts, ir30: np.ndarray, x30: torch.Tensor, crd: Card,
                    b4: tuple | None = None) -> dict:
    """Phase 15 (module docstring): every batched stream the port routes an
    aligned call to, at the JAX benchmarks' shapes, each call's time held
    to its roofline bound on the card ``crd`` (:func:`shares`).  ``b4``:
    B4's device microseconds a call and its ``roofline.Cost``, held beside
    the conv core at B4's shape against the one bound.  Returns a record a
    shape."""
    from fft_convolution_tpu_torch import (CrossfadeConvolver, FFTConvolver, ReverbFarm,
                                           TwoStageFFTConvolver)
    from fft_convolution_tpu_torch.models import crossfade, two_stage, uniform
    from fft_convolution_tpu_torch.ops.fft import next_power_of_two
    from fft_convolution_tpu_torch.parallel import farm

    rl = roofline()
    record = {}

    def randn(rng, shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def drive(name, x, batched, sequential, reference, per_call, audio_s, thunks, cost,
              pick=lambda y: y):
        """``x [calls, T, ...]``: the calls through ``batched`` (``per_call``
        calls of each stream core a call, :func:`core_calls`; no hand-written
        kernel) and through ``sequential`` on a twin (no stream core), both
        held against ``reference(x)``, a float64 convolution (``pick``
        selects the part of the output ``sequential`` computes).  Then the
        xRT of a warm call (``thunks(k)``: k warm calls, in turn) and of the
        block loop, one call's profile, and the call's share of the bound of
        ``cost`` (its ``roofline.Cost``) in device and in event time."""
        calls, t = x.shape[:2]
        n0 = core_calls()
        y = counts.drive(f"{name} batched", lambda: torch.stack([batched(xc) for xc in x]),
                         {})
        took = core_calls(n0)
        print(f"{name}: {calls} aligned calls of T={t} blocks; the ring conv core, the "
              f"fused front end and the CHRONO tail ran {took} times", flush=True)
        if took != tuple(k * calls for k in per_call):
            fail(f"{name}: the stream cores ran {took} times, not {per_call} a call")
        n0 = core_calls()
        y_seq = torch.stack([sequential(xc) for xc in x])
        if core_calls(n0) != (0, 0, 0):
            fail(f"{name}: the block loop reached a stream core")
        if not torch.isfinite(y).all():
            fail(f"{name}: non-finite output")
        scale = float(y.abs().max())
        print(f"{name}: output scale {scale!r}", flush=True)
        e64 = err64(y, reference(x))
        gate(f"{name}: batched vs float64 convolution", e64, PARITY_TOL)
        e_loop = err64(pick(y), y_seq)
        gate(f"{name}: batched vs the block loop", e_loop, PARITY_TOL)
        del y, y_seq
        th = thunks(BATCHED_WARMUP + BATCHED_TIMED + BATCHED_PROFILED)
        ms = statistics.median(event_ms(th[:BATCHED_WARMUP + BATCHED_TIMED])[BATCHED_WARMUP:])
        k = min(t, LOOP_BLOCKS)
        loop_ms = statistics.median(event_ms([lambda: sequential(x[0, :k])] * LOOP_RUNS)) * t / k
        prof = profile_steps(lambda i: th[BATCHED_WARMUP + BATCHED_TIMED + i](),
                             BATCHED_PROFILED, 0)
        rec = {"T": t, "audio_s": audio_s, "stream_core_calls": per_call, "scale": scale,
               "err_f64": e64, "err_loop": e_loop, "ms": ms, "xrt": audio_s / (ms / 1e3),
               "loop_ms": loop_ms, "xrt_loop": audio_s / (loop_ms / 1e3),
               "device_us": prof["device_us"],
               "cuda_kernels": prof["cuda_launches_per_step"], "device_us_by_kernel":
               dict(sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8])}
        record[name] = rec
        print(f"{name}: batched {ms!r} ms a call (CUDA-event median) -> xRT {rec['xrt']!r}; "
              f"block loop {loop_ms!r} ms a call ({k} blocks timed) -> xRT "
              f"{rec['xrt_loop']!r}; one call {prof['device_us']!r} device us in "
              f"{prof['cuda_launches_per_step']!r} CUDA kernels", flush=True)
        rec.update(shares(name, cost, crd, device=prof["device_us"] / 1e6, event=ms / 1e3))
        return rec

    def aligned_form(eng, x0, fuse, chrono, multi):
        """A thunk: aligned calls on ``x0 [T, B]`` from a copy of ``eng``'s
        state through ``process_stream_aligned`` with the fused front end on
        or off, the big tail on its CHRONO history (compacted as the wrapper
        does) or on its ring, and the fused side passes in the MULTI form,
        the SEPARATE one, or (None) as ``fused_uses_multi`` routes."""
        cfg, st, t = eng.cfg, eng.state.clone(), x0.shape[0]
        q, keep = t // cfg.period, two_stage.FUSED_MULTI_MAX_ROWS
        rows = keep if multi is None else (1 << 30 if multi else 0)
        two_stage.FUSED_MULTI_MAX_ROWS = rows
        khats = two_stage.stream_khats(cfg, st, t, want_tail=True if chrono else None)
        two_stage.FUSED_MULTI_MAX_ROWS = keep
        tail = list(two_stage.tail_to_chrono(cfg, st, eng._chrono_h_cap)) if chrono else None

        def call():
            two_stage.FUSED_MULTI_MAX_ROWS = rows
            if chrono and not uniform.chrono_fits(cfg.tail, tail[0].shape[0], tail[1], q):
                tail[1] = two_stage.tail_chrono_compact(cfg, tail)
            y = two_stage.process_stream_aligned(cfg, st, x0, khats, fuse_small=fuse,
                                                 tail_chrono=tuple(tail) if chrono else None)
            two_stage.FUSED_MULTI_MAX_ROWS = keep
            if chrono:
                tail[1] += q
            return y
        return call

    def two_stage_shape(name, seed, seconds, scale, periods, want, calls=BATCHED_CALLS,
                        positions=None):
        """An aligned ``TwoStageFFTConvolver`` shape: ``calls`` parity calls
        through :func:`drive` (the fused front end and the CHRONO tail once
        each a call; ``positions``: the CHRONO history's rows after each
        call, gated), then the forms of :data:`TWO_STAGE_FORMS` from the
        engine's initial state on the first call's input, each timed (event
        ms, device us, CUDA kernels) and held against the default form
        (printed, not gated)."""
        rng = np.random.default_rng(seed)
        ir = (rng.standard_normal(seconds * SR) * scale).astype(np.float32)
        eng = TwoStageFFTConvolver(ir, BLOCK, len(ir), device=dev)
        c = eng.cfg
        got = (c.tail_block, c.period, c.head.seg_count, c.tail.seg_count)
        if got != want:
            fail(f"{name}: (tail block, period, head, big tail) {got} != {want}")
        t = periods * c.period
        x = randn(rng, (calls, t, BLOCK))
        twin, pre, ir_d = eng.clone(), eng.clone(), torch.from_numpy(ir).to(dev)
        rows = []

        def batched(xc):
            y = eng.process(xc.reshape(-1)).view(xc.shape)
            rows.append(eng._tail_pos)
            return y

        cost = rl.two_stage_stream_cost(c, t)
        rec = drive(name, x, batched, lambda xc: run_blocks(twin, xc),
                    lambda xa: conv64(xa.reshape(-1), ir_d).view(xa.shape),
                    (0, 1, 1), t * BLOCK / SR,
                    lambda k: [lambda: eng.process(x[0].reshape(-1))] * k, cost)
        multi = two_stage.fused_uses_multi(c, t)
        print(f"{name}: fused side passes {'MULTI' if multi else 'SEPARATE'} (T + n = "
              f"{t + c.head.seg_count}, FUSED_MULTI_MAX_ROWS "
              f"{two_stage.FUSED_MULTI_MAX_ROWS}); CHRONO rows after each call {rows} of "
              f"{eng._chrono_h_cap}", flush=True)
        if positions is not None and rows != positions:
            fail(f"{name}: CHRONO rows {rows} != {positions}")
        rec.update(chrono_rows=rows, fused_form="MULTI" if multi else "SEPARATE", forms={})
        y_ref = None
        for label, (fuse, chrono, other) in TWO_STAGE_FORMS.items():
            call = aligned_form(pre, x[0], fuse, chrono, (not multi) if other else None)
            n0 = core_calls()
            y0 = call()
            took = core_calls(n0)
            y_ref = y0 if y_ref is None else y_ref
            th = [call] * (BATCHED_WARMUP + BATCHED_TIMED)
            ms = statistics.median(event_ms(th)[BATCHED_WARMUP:])
            prof = profile_steps(lambda i: call(), BATCHED_PROFILED, 0)
            form = {"ms": ms, "device_us": prof["device_us"],
                    "cuda_kernels": prof["cuda_launches_per_step"], "stream_core_calls": took,
                    "diff_vs_default": err64(y0, y_ref)}
            rec["forms"][label] = form
            print(f"{name} form {label}: {ms!r} ms a call (CUDA-event median), "
                  f"{form['device_us']!r} device us in {form['cuda_kernels']!r} CUDA "
                  f"kernels; stream cores {took}; first call vs the default form "
                  f"{form['diff_vs_default']!r}", flush=True)
            # every form computes one function: one cost, one bound
            form.update(shares(f"{name} form {label}", cost, crd,
                               device=prof["device_us"] / 1e6, event=ms / 1e3))

    def uniform_t(name, n, key):
        t = next_power_of_two(n + {1: 1023, 2: 511, 4: 255}[key]) - n + 1
        if (n, t) != CONFIG_SEGS_T[key]:
            fail(f"{name}: (segments, T) {(n, t)} != {CONFIG_SEGS_T[key]}")
        return t

    # flagship: bench.py:163-178 (its IR and first call are phase 1's); the
    # CHRONO history compacts on the fourth call
    two_stage_shape("flagship two-stage", 0, IR_SECONDS, 0.01, FLAGSHIP_PERIODS,
                    FLAGSHIP_SHAPES, FLAGSHIP_CALLS, FLAGSHIP_ROWS)
    # the same engine at two periods a call: the fused front end's MULTI form,
    # and a big tail the ring path sends to its block loop
    two_stage_shape("flagship two-stage, 2 periods", 0, IR_SECONDS, 0.01, SHORT_PERIODS,
                    FLAGSHIP_SHAPES)

    # config 1: benchmarks/configs.py:92-118
    rng = np.random.default_rng(0)
    ir1 = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    eng1 = FFTConvolver(ir1, BLOCK, SR, device=dev)
    t = uniform_t("config 1", eng1.cfg.seg_count, 1)
    x = randn(rng, (BATCHED_CALLS, t, BLOCK))
    twin1, ir1_d = eng1.clone(), torch.from_numpy(ir1).to(dev)
    drive("config 1 uniform", x, lambda xc: eng1.process(xc.reshape(-1)).view(xc.shape),
          lambda xc: run_blocks(twin1, xc),
          lambda xa: conv64(xa.reshape(-1), ir1_d).view(xa.shape),
          (1, 0, 0), t * BLOCK / SR, lambda k: [lambda: eng1.process(x[0].reshape(-1))] * k,
          rl.stream_conv_cost(eng1.cfg, t))

    # config 2: benchmarks/configs.py:121-146, the stereo farm at block 256
    rng = np.random.default_rng(1)
    irs2 = torch.from_numpy((rng.standard_normal((2, 5 * SR)) * 0.01).astype(np.float32)).to(dev)
    cfg2, st2 = farm.farm_init(irs2, 256, 5 * SR)
    t = uniform_t("config 2", cfg2.seg_count, 2)
    x = randn(rng, (BATCHED_CALLS, t, 2, 256))
    st2_seq, kh2 = st2.clone(), farm.farm_khat(cfg2, st2, t)

    def voices64(xa, irs):
        """float64 reference of ``xa [calls, T, V, B]``, voice v with ``irs[v]``."""
        v = xa.shape[2]
        y = conv64(xa.permute(2, 0, 1, 3).reshape(v, -1), irs)
        return y.view(v, *xa.shape[:2], xa.shape[3]).permute(1, 2, 0, 3)

    drive("config 2 uniform farm", x, lambda xc: farm.farm_stream(cfg2, st2, xc, kern_hat=kh2),
          lambda xc: torch.stack([farm.farm_step(cfg2, st2_seq, xt) for xt in xc]),
          lambda xa: voices64(xa, irs2), (1, 0, 0), t * 256 / SR,
          lambda k: [lambda: farm.farm_stream(cfg2, st2, x[0], kern_hat=kh2)] * k,
          rl.stream_conv_cost(cfg2, t, voices=x.shape[2]))

    # config 3: benchmarks/configs.py:149-198
    two_stage_shape("config 3 two-stage 30 s", 2, CONFIG3_SECONDS, 0.005, CONFIG3_PERIODS,
                    CONFIG3_SHAPES)

    # config 4: benchmarks/configs.py:201-258, mid-fade throughout
    rng = np.random.default_rng(3)
    ir_a = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    ir_b = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    cc = CrossfadeConvolver(FFTConvolver(ir_a, BLOCK, SR, device=dev), SR, BLOCK, 10 * SR)
    cc.update(ir_b)
    t = uniform_t("config 4", cc.convolver_a.cfg.seg_count, 4)
    x = randn(rng, (BATCHED_CALLS, t, BLOCK))
    if not cc.is_crossfading() or (BATCHED_CALLS + 1) * t * BLOCK >= 10 * SR:
        fail("config 4: the calls would not all be mid-fade")
    twin4, cf0 = cc.clone(), cc.cf_state
    ira_d, irb_d = torch.from_numpy(ir_a).to(dev), torch.from_numpy(ir_b).to(dev)

    def xfade_loop(xc):
        """Both engines' block loops, mixed once over the call as the batched
        path mixes: a mix a block steps the float32 ramp 650 times a call,
        and that drift (~1e-4 at this scale over two calls) is the mixer's
        granularity, not the stream's."""
        a = run_blocks(twin4.convolver_a, xc).reshape(-1)
        b = run_blocks(twin4.convolver_b, xc).reshape(-1)
        twin4.cf_state, y = crossfade.mix_block(twin4.cf_cfg, twin4.cf_state, a, b)
        return y.view(xc.shape)

    drive("config 4 crossfade", x, lambda xc: cc.process(xc.reshape(-1)).view(xc.shape),
          xfade_loop,
          lambda xa: crossfade.mix_samples(cc.cf_cfg, cf0, conv64(xa.reshape(-1), ira_d),
                                           conv64(xa.reshape(-1), irb_d)).view(xa.shape),
          (2, 0, 0), t * BLOCK / SR,
          # each timed call on its own clone of the engine mid-fade
          lambda k: [functools.partial(c.process, x[0].reshape(-1))
                     for c in [cc.clone() for _ in range(k)]],
          rl.crossfade_stream_cost(cc.cfg, t))

    # a short-IR ReverbFarm: no big tail, head and tail0 on the conv core
    v, taps, t = SHORT_FARM
    rng = np.random.default_rng(6)
    irs6 = torch.from_numpy((rng.standard_normal((v, taps)) * 0.05).astype(np.float32)).to(dev)
    fm = ReverbFarm(irs6, BLOCK, taps, device=dev)
    if fm.cfg.tail is not None or fm.cfg.tail0 is None or t % fm.period:
        fail(f"short-IR farm: tail block {fm.cfg.tail_block} gives a big tail, no tail0 "
             f"or a period that does not divide T={t}")
    x = randn(rng, (BATCHED_CALLS, t, v, BLOCK))
    checked = [0, v - 1]
    twins = [TwoStageFFTConvolver(irs6[i], BLOCK, taps, device=dev) for i in checked]
    drive(f"short-IR ReverbFarm ({v} voices x {taps} taps)", x, fm.process,
          lambda xc: torch.stack([run_blocks(e, xc[:, i]) for e, i in zip(twins, checked)],
                                 dim=1),
          lambda xa: voices64(xa, irs6), (2, 0, 0), t * BLOCK / SR,
          lambda k: [lambda: fm.process(x[0])] * k, rl.farm_cost(fm.cfg, v, t),
          pick=lambda y: y[:, :, checked])

    # B4 yardstick: the conv core at B4's shape (its padded segment count),
    # the same function as B4's call, so one cost and one bound for both
    yard = FFTConvolver(ir30, BLOCK, STREAM_SEGS * BLOCK, device=dev)
    t = x30.shape[1] // BLOCK
    y0 = yard.process(x30[0])
    yard_err = err64(y0, conv64(x30[0], torch.from_numpy(ir30).to(dev)))
    n0 = core_calls()
    ms = statistics.median(event_ms([functools.partial(yard.process, x30[1 + i])
                                     for i in range(YARD_WARMUP + YARD_TIMED)])[YARD_WARMUP:])
    prof = profile_steps(lambda i: yard.process(x30[i % x30.shape[0]]), BATCHED_PROFILED, 0)
    if core_calls(n0) != (YARD_WARMUP + YARD_TIMED + BATCHED_PROFILED * prof["windows"], 0, 0):
        fail("B4 yardstick: a call missed the conv core")
    m = uniform.meta_size(yard.cfg.seg_count, t)
    b4_us, b4_cost = b4 if b4 is not None else (None, None)
    record["B4 yardstick"] = {"N": yard.cfg.seg_count, "T": t, "m": m, "ms": ms,
                              "device_us": prof["device_us"],
                              "cuda_kernels": prof["cuda_launches_per_step"],
                              "err_f64": yard_err, "b4_device_us": b4_us,
                              "device_us_by_kernel": prof["by_name"]}
    print(f"B4 yardstick: the conv core at N={yard.cfg.seg_count}, T={t} (m={m}): "
          f"{prof['device_us']!r} device us in {prof['cuda_launches_per_step']!r} CUDA "
          f"kernels, {ms!r} ms a call (CUDA-event median); B4 {b4_us!r} device us "
          f"(phase 14, None when not run); first call vs float64 {yard_err!r}", flush=True)
    cost = rl.stream_conv_cost(yard.cfg, t)
    if b4_cost is not None and b4_cost != cost:
        fail(f"B4 yardstick: B4 is costed {b4_cost}, the conv core at its shape {cost}")
    record["B4 yardstick"].update(shares("B4 yardstick", cost, crd,
                                         device=prof["device_us"] / 1e6, event=ms / 1e3))
    if b4_us is not None:
        record["B4 yardstick"]["b4_share_device"] = shares(
            "B4 beside its yardstick", cost, crd, device=b4_us / 1e6)["share_device"]

    # cuFFT along the block axis: strided (dim -2) against contiguous rows
    for rows in (4096, 16384):
        ext = torch.randn((rows, BLOCK + 1), dtype=torch.complex64, device=dev)
        ext_t = ext.mT.contiguous()
        us = [profile_steps(fn, 20, 4)["device_us"]
              for fn in (lambda i: torch.fft.fft(ext, dim=-2),
                         lambda i: torch.fft.fft(ext_t, dim=-1))]
        record[f"cufft {rows}x{BLOCK + 1}"] = {"dim_-2_us": us[0], "dim_-1_us": us[1]}
        print(f"cuFFT of {rows} rows x {BLOCK + 1} bins: along dim -2 {us[0]!r} device us, "
              f"the same laid out along dim -1 {us[1]!r}", flush=True)
    return record


def host_callbacks(host, blocks: np.ndarray, warmup: int) -> tuple:
    """``host.process`` (a ``HostEngine``) over the numpy ``blocks``, the
    first ``warmup`` untimed, each other call timed by the host clock in a
    ``LatencyRecorder``.  Returns the recorder and, for an engine with a
    tail period (``row``), whether each timed block ended one."""
    from fft_convolution_tpu_torch.utils.profiling import LatencyRecorder

    eng = host.engine
    period = eng.cfg.period if hasattr(eng, "row") else None
    rec, period_end = LatencyRecorder(block_size=BLOCK, sample_rate=SR), []
    for i, xb in enumerate(blocks):
        if i < warmup:
            host.process(xb)
            continue
        if period:
            period_end.append(eng.row == period - 1)
        with rec.measure():
            host.process(xb)
    return rec, period_end


def period_end_split(samples_s: list, period_end: list) -> dict:
    """Host-clock samples split into the blocks that end a period and the
    others: count, median, p99 and max in ms each."""
    out = {}
    for kind, want in (("period_end", True), ("other", False)):
        ms = np.asarray([t for t, e in zip(samples_s, period_end, strict=True) if e == want])
        out[kind] = {"n": int(ms.size), "p50_ms": float(np.percentile(ms, 50) * 1e3),
                     "p99_ms": float(np.percentile(ms, 99) * 1e3),
                     "max_ms": float(ms.max() * 1e3)}
    return out


def sleep_cycles(ms: float) -> int:
    """The ``torch.cuda._sleep`` argument that holds a stream about ``ms``
    on this card (timed with CUDA events, after one warm-up)."""
    probe = 1 << 22
    for _ in range(2):
        (probe_ms,) = event_ms([lambda: torch.cuda._sleep(probe)])
    return max(1, int(probe * ms / probe_ms))


def snapshots_equal(a, b) -> bool:
    """Whether two ``CudaTwoStageConvolver`` snapshots hold the same bits."""
    (fa, ta, ba, ra), (fb, tb, bb, rb) = a, b
    pairs = ([(getattr(fa, f), getattr(fb, f)) for f in ("segments", "head_overlap",
                                                          "t0_overlap")]
             + [(getattr(ta, f), getattr(tb, f)) for f in ("segments", "pre_multiplied",
                                                           "overlap")]
             + [(ba[k], bb[k]) for k in sorted(ba)])
    return ((ra, fa.current, ta.current) == (rb, fb.current, tb.current)
            and sorted(ba) == sorted(bb) and all(torch.equal(x, y) for x, y in pairs))


RACE_MODES = ("as it runs", "side stream held back", "synchronised after every block")


def race_gate(engine, blocks: np.ndarray, hold_ms: float) -> dict:
    """Three runs of a ``CudaTwoStageConvolver`` from ``engine``'s state
    (clones) through ``HostEngine`` over the numpy ``blocks`` (whole
    periods): as it runs; with its side stream held back, ``hold_ms`` of
    ``torch.cuda._sleep`` enqueued there before each period-end block (a
    missing wait then lets the current stream read a stale or half-written
    buffer, or overwrite the input the big tail has yet to read); and a twin
    that synchronises the card after every block (serial by construction).
    Per run: whether its outputs and its exit snapshot (taken right after
    the last period end) are bit-equal to the twin's, its period ends, the
    big-tail graph replays and in-line steps, and its wall seconds.  The
    caller gates it."""
    from fft_convolution_tpu_torch.runtime.host import HostEngine

    cycles = sleep_cycles(hold_ms)
    runs = {}
    for mode in RACE_MODES:
        conv = engine.clone()
        host, p = HostEngine(conv), conv.cfg.period
        ends, ys = 0, []
        t0 = time.perf_counter()
        for xb in blocks:
            if conv.row == p - 1:
                ends += 1
                if mode == "side stream held back":
                    with torch.cuda.stream(conv.side_stream):
                        torch.cuda._sleep(cycles)
            ys.append(host.process(xb))
            if mode == "synchronised after every block":
                torch.cuda.synchronize()
        snap = conv.snapshot()
        torch.cuda.synchronize()
        runs[mode] = (np.stack(ys), snap, {"period_ends": ends, "replays": conv.tail_replays,
                                           "inline": conv.tail_inline,
                                           "wall_s": time.perf_counter() - t0})
    y_ref, snap_ref, _ = runs[RACE_MODES[-1]]
    return {mode: {"outputs_bit_equal": bool(np.array_equal(y, y_ref)),
                   "snapshot_bit_equal": snapshots_equal(snap, snap_ref), **rec}
            for mode, (y, snap, rec) in runs.items()} | {"hold_ms": hold_ms,
                                                        "sleep_cycles": cycles}


def host_runtime(dev, counts: Counts, ir: np.ndarray, ir_b: np.ndarray, x_host: np.ndarray,
                 engines: dict, timing: dict, crd: Card) -> dict:
    """Phase 16 (module docstring): the host runtime over the per-block
    wrappers in ``engines`` (B1, B1p, B2, B3 at the flagship shape) and the
    flagship IRs ``ir`` and ``ir_b``; ``timing``: phases 5 and 9's
    card-tensor latencies, printed beside the host-callback ones; ``crd``:
    the card the big-tail step's share is taken on.  Returns a record."""
    from fft_convolution_tpu_torch import TwoStageFFTConvolver, runtime
    from fft_convolution_tpu_torch.examples import reverb_farm, serve_morph
    from fft_convolution_tpu_torch.models import uniform
    from fft_convolution_tpu_torch.runtime.host import HostEngine
    from fft_convolution_tpu_torch.runtime.stream import StreamingConvolver
    from fft_convolution_tpu_torch.serving import CudaCrossfadeConvolver, CudaFFTConvolver
    from fft_convolution_tpu_torch.utils import checkpoint

    record = {}
    t0 = time.perf_counter()
    lib_path = runtime.build()
    runtime.load()
    print(f"host runtime: built in {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
          flush=True)

    # numpy blocks through HostEngine against the same wrapper on card tensors
    xs_np = x_host[:HOST_PARITY_BLOCKS]
    xs_dev = torch.from_numpy(xs_np).to(dev)
    for label in ("B1", "B2", "B3"):
        host, twin = HostEngine(engines[label].clone()), engines[label].clone()
        y_host = counts.drive(f"{label} through HostEngine",
                              lambda: np.stack([host.process(xb) for xb in xs_np]),
                              {label: HOST_PARITY_BLOCKS})
        y_dev = run_blocks(twin, xs_dev).cpu().numpy()
        err = float(np.abs(y_host.astype(np.float64) - y_dev).max())
        equal = bool(np.array_equal(y_host, y_dev))
        gate(f"{label} HostEngine on numpy blocks vs the wrapper on card tensors "
             f"({HOST_PARITY_BLOCKS} blocks)", err, HOST_PARITY_TOL)
        print(f"{label} HostEngine bit-equal to the card-tensor path: {equal}", flush=True)
        record[f"{label} adapter"] = {"max_abs_err": err, "bit_equal": equal}

    # B2's race gate: the big tail on the wrapper's side stream, as it runs
    # and held back, against a twin synchronised after every block
    two = engines["B2"]
    p = two.cfg.period
    race_blocks = x_host[:(-two.row) % p + RACE_PERIODS * p]  # ends on a period end
    race = counts.drive("B2 race gate, three runs",
                        lambda: race_gate(two, race_blocks, RACE_HOLD_MS),
                        {"B2": len(RACE_MODES) * len(race_blocks)})
    for mode in RACE_MODES:
        r = race[mode]
        print(f"B2 race gate, {mode}: {len(race_blocks)} numpy blocks through HostEngine, "
              f"{r['period_ends']} period ends, {r['replays']} big-tail graph replays on the "
              f"side stream, {r['inline']} in line; outputs bit-equal to the synchronised "
              f"twin: {r['outputs_bit_equal']}, exit snapshot: {r['snapshot_bit_equal']}; "
              f"{r['wall_s']!r} s", flush=True)
        if not (r["outputs_bit_equal"] and r["snapshot_bit_equal"]):
            fail(f"B2 race gate, {mode}: differs from the twin synchronised after every block")
        if r["replays"] != r["period_ends"] or r["inline"] or r["period_ends"] < RACE_PERIODS:
            fail(f"B2 race gate, {mode}: {r['replays']} replays and {r['inline']} in-line "
                 f"steps over {r['period_ends']} period ends")
    held = race["side stream held back"]
    print(f"B2 race gate: the side stream held back {RACE_HOLD_MS!r} ms "
          f"({race['sleep_cycles']} sleep cycles) before each period end", flush=True)
    if held["wall_s"] < (held["period_ends"] - 1) * RACE_HOLD_MS / 1e3:
        fail(f"B2 race gate: the held-back run took {held['wall_s']!r} s, so the hold did not "
             "delay the big tail")
    record["B2 race gate"] = race

    # host-callback latency: a numpy block in, a numpy block out, copies and sync included
    lat = {}
    row0 = two.row
    blocks = x_host[:HOST_LATENCY_WARMUP + HOST_LATENCY_BLOCKS]
    for label in ("B1", "B1p", "B2", "B3"):
        host = HostEngine(engines[label])
        replays = two.tail_replays
        rec, period_end = counts.drive(
            f"{label} host callbacks",
            lambda: host_callbacks(host, blocks, HOST_LATENCY_WARMUP), {label: len(blocks)})
        if label == "B2":
            ends = (row0 + len(blocks)) // p  # the blocks at row p - 1
            print(f"B2 host callbacks: {two.tail_replays - replays} big-tail graph replays "
                  f"over {ends} period ends, {two.tail_inline} in line", flush=True)
            if two.tail_replays - replays != ends or two.tail_inline:
                fail("B2 host callbacks: the big tail did not run once a period end as a "
                     "graph replay")
        rep = rec.report()
        rep["max_ms"] = max(rec.samples_s) * 1e3
        card = timing[label]["kernel"]
        rep["card_tensor_sync_ms"] = [r["sync_ms"] for r in card]
        rep["card_tensor_event_ms"] = [r["event_ms"] for r in card]
        lat[label] = rep
        print(f"host-callback latency {label} over {rep['n_blocks']} warm numpy blocks: "
              f"median {rep['p50_ms']!r} ms, p99 {rep['p99_ms']!r} ms, max {rep['max_ms']!r} "
              f"ms, {rep['deadline_misses']} over the {BLOCK_MS!r} ms block; card tensors "
              f"(phases 5/9): sync median {rep['card_tensor_sync_ms']!r} ms, event median "
              f"{rep['card_tensor_event_ms']!r} ms", flush=True)
        if not rep["p50_ms"] < BLOCK_MS:
            fail(f"{label}: host-callback median {rep['p50_ms']!r} ms >= {BLOCK_MS!r} ms")
        if label == "B2":
            rep["split"] = period_end_split(rec.samples_s, period_end)
    record["host_callback_latency"] = lat

    # B2's big-tail step alone (the wrapper's period end: the uniform engine
    # at the tail block over the period input), CUDA events: the eager ops on
    # a copy of the tail state, and the wrapper's graph replay on a clone
    step = two.clone()
    tail_in = step.buffers["tail_input"].reshape(-1)
    eager = step.tail_state.clone()
    graph = step._graphs[0][0]
    for _ in range(3):
        uniform.process_block(step.cfg.tail, eager, tail_in)
        graph.replay()
    torch.cuda.synchronize()
    tail_ms = event_ms([lambda: uniform.process_block(step.cfg.tail, eager, tail_in)]
                       * TAIL_STEP_REPS)
    replay_ms = event_ms([graph.replay] * TAIL_STEP_REPS)
    lat["B2"]["big_tail_step_event_ms"] = {"median": statistics.median(tail_ms),
                                           "max": max(tail_ms), "reps": len(tail_ms)}
    lat["B2"]["big_tail_replay_event_ms"] = {"median": statistics.median(replay_ms),
                                             "max": max(replay_ms), "reps": len(replay_ms)}
    split = lat["B2"]["split"]
    for kind in ("period_end", "other"):
        r = split[kind]
        print(f"host-callback latency B2, {kind.replace('_', '-')} blocks ({r['n']}): median "
              f"{r['p50_ms']!r} ms, p99 {r['p99_ms']!r} ms, max {r['max_ms']!r} ms", flush=True)
    print(f"B2 big-tail step alone (tail block {two.cfg.tail_block}, "
          f"{two.cfg.tail.seg_count} segments): CUDA-event median {statistics.median(tail_ms)!r}"
          f" ms, max {max(tail_ms)!r} ms over {len(tail_ms)}; as the wrapper's graph replay: "
          f"median {statistics.median(replay_ms)!r} ms, max {max(replay_ms)!r} ms", flush=True)
    lat["B2"]["big_tail_step_bound"] = shares(
        "B2 big-tail step alone", roofline().stream_conv_cost(two.cfg.tail, 1), crd,
        event=statistics.median(tail_ms) / 1e3)

    # StreamingConvolver over the batched two-stage engine: 441-sample pushes
    # (the sub-block route), a push back to the block boundary, a
    # block-aligned push of whole periods (the batched route), 441 again
    eng = TwoStageFFTConvolver(ir, BLOCK, len(ir), device=dev)
    ragged = PUSH * HOST_STREAM_PUSHES
    back = -ragged % BLOCK
    aligned = STREAM_ALIGNED_PERIODS * eng.cfg.tail_block
    sizes = [PUSH] * HOST_STREAM_PUSHES + [back, aligned] + [PUSH] * 10
    x_st = x_host.reshape(-1)[:sum(sizes)]
    starts = np.cumsum([0] + sizes[:-1])

    def stream():
        s = StreamingConvolver(eng)
        return np.concatenate([s.push(x_st[i:i + n]) for i, n in zip(starts, sizes)])

    t0, core0 = time.perf_counter(), core_calls()
    y_st = counts.drive("StreamingConvolver (441-sample and block-aligned pushes)", stream, {})
    wall, cores = time.perf_counter() - t0, core_calls(core0)
    print(f"StreamingConvolver: {HOST_STREAM_PUSHES} pushes of {PUSH}, one of {back}, one "
          f"block-aligned of {aligned}, 10 of {PUSH}; the ring conv core, the fused front "
          f"end and the CHRONO tail ran {cores} times", flush=True)
    if cores != (0, 1, 1):
        fail("StreamingConvolver: the block-aligned push did not take the fused front end "
             "and the CHRONO tail once each")
    ref = conv64(torch.from_numpy(x_st).to(dev), torch.from_numpy(ir).to(dev)).cpu().numpy()
    err = float(np.abs(y_st - ref).max())
    gate(f"StreamingConvolver over TwoStageFFTConvolver, {len(sizes)} pushes ({len(x_st)} "
         f"samples), vs float64 convolution", err, PARITY_TOL)
    record["StreamingConvolver"] = {"samples": len(x_st), "aligned_push": aligned,
                                    "stream_core_calls": cores, "err_f64": err,
                                    "wall_s": wall}

    # RealTimeDispatcher over B3, a morph posted a third of the way in: the
    # lockstep callback (throughput; no underrun can occur), then the
    # wall-clock one (real-time; underruns measured)
    x_d = np.random.default_rng(16).standard_normal(DISPATCH_BLOCKS * BLOCK).astype(np.float32)
    for label, blocks, paced in (("lockstep", DISPATCH_BLOCKS, False),
                                 ("paced", PACED_BLOCKS, True)):
        xf = CudaCrossfadeConvolver(ir, BLOCK, len(ir), crossfade_samples=XFADE_FADE,
                                    device=dev)
        x_run = x_d[:blocks * BLOCK]
        serve = serve_morph.serve_paced if paced else serve_morph.serve
        t0 = time.perf_counter()
        y_d, disp = counts.drive(
            f"B3 through RealTimeDispatcher, {label} callback",
            lambda: serve(xf, x_run, ir_b, morph_at=len(x_run) // 3, push=PUSH),
            {"B3": blocks})
        wall = time.perf_counter() - t0
        k = disp.update_applied_at
        lost = len(x_run) - disp.samples_pushed
        latency = PUSH + BLOCK if paced else 0
        print(f"dispatcher, {label} callback: {disp.blocks_processed} blocks in {wall!r} s "
              f"({len(x_run) / SR / wall!r}x real time), underruns {disp.underruns}, input "
              f"samples lost {lost}, morph applied before block {k}", flush=True)
        if disp.blocks_processed != blocks or len(y_d) != len(x_run) or k is None:
            fail(f"dispatcher, {label}: {disp.blocks_processed} blocks, {len(y_d)} samples, "
                 f"morph at {k}")
        rec = {"blocks": disp.blocks_processed, "underruns": disp.underruns,
               "input_lost": lost, "update_applied_at": k, "wall_s": wall,
               "latency_samples": latency}
        if disp.underruns or lost:
            print(f"dispatcher, {label}: windows not checked, the underruns shifted the "
                  "output", flush=True)
        else:
            res = serve_morph.check(y_d[latency:], x_run, ir, ir_b, k, BLOCK,
                                    xf.cf_cfg.hold_samples, xf.cf_cfg.fading_samples)
            gate(f"dispatcher B3, {label}, before the morph (samples {res['pre_window']}) vs "
                 "float64 convolution with ir_a", res["pre_err"], PARITY_TOL)
            gate(f"dispatcher B3, {label}, after the fade (samples {res['post_window']}) vs "
                 "float64 convolution with ir_b", res["post_err"], PARITY_TOL)
            rec.update(pre_err=res["pre_err"], post_err=res["post_err"])
        record[f"RealTimeDispatcher {label}"] = rec

    # checkpoints on the card: mid-stream B1p, mid-fade B3
    ckdir = ROOT / "build" / "chip_smoke"
    ckdir.mkdir(parents=True, exist_ok=True)
    xs = torch.from_numpy(x_host[:CKPT_BLOCKS + CKPT_CONTINUE]).to(dev)

    def b1p():
        return CudaFFTConvolver(ir, BLOCK, len(ir), device=dev, storage="bf16_packed")

    def b3():
        return CudaCrossfadeConvolver(ir, BLOCK, len(ir), crossfade_samples=XFADE_FADE,
                                      device=dev)

    def checkpointed(label, make, advance):
        conv = make()
        advance(conv)
        path = str(ckdir / f"{label}.npz")
        checkpoint.save(path, conv.snapshot())
        fresh = make()
        fresh.restore(checkpoint.load(path, fresh.snapshot()))
        tail = xs[CKPT_BLOCKS:]
        return run_blocks(conv, tail), run_blocks(fresh, tail), fresh

    def advance_b3(conv):
        run_blocks(conv, xs[:CKPT_BLOCKS - 2])
        conv.update(ir_b)
        run_blocks(conv, xs[CKPT_BLOCKS - 2:CKPT_BLOCKS])
        if not conv.is_crossfading():
            fail("checkpoint: the B3 state is not mid-fade")

    for label, make, advance in (("B1p", b1p, lambda c: run_blocks(c, xs[:CKPT_BLOCKS])),
                                 ("B3", b3, advance_b3)):
        y_orig, y_back, fresh = counts.drive(
            f"{label} checkpoint", lambda: checkpointed(label, make, advance),
            {label: CKPT_BLOCKS + 2 * CKPT_CONTINUE})
        same = bool(torch.equal(y_orig, y_back))
        print(f"{label} checkpoint: {CKPT_CONTINUE} blocks after restore bit-equal: {same}",
              flush=True)
        if not same or fresh.state.segments.device != dev:
            fail(f"{label}: the restored state does not continue bit-equal on the card")
        record[f"{label} checkpoint"] = {"bit_equal": same}

    # the examples, as functions, at a small size
    morph = counts.drive("serve_morph example",
                         lambda: serve_morph.main(["--device", "cuda", "--blocks", "96"]),
                         {"B3": 96})
    farm = counts.drive("reverb_farm example",
                        lambda: reverb_farm.main(["--device", "cuda", "--voices",
                                                  str(EXAMPLE_VOICES), "--ir-seconds",
                                                  str(EXAMPLE_IR_SECONDS)]),
                        {"B5": 2, "B6": 2})
    record["examples"] = {"serve_morph": {key: morph[key] for key in ("pre_err", "post_err",
                                                                      "update_applied_at")},
                          "reverb_farm": {"err": farm["err"], "wall_s": farm["wall_s"]}}
    return record


def plain_farm(farm):
    """A clone of ``farm`` whose big tail and head path run the plain
    versions of kernels B5 and B6 on the card."""
    from fft_convolution_tpu_torch.ops import cuda_farm_heads, cuda_farm_mac

    twin = farm.clone()
    twin._step = cuda_farm_mac.phased_step_plain
    twin._heads = cuda_farm_heads.heads_step_plain
    return twin


def head_fields(state) -> dict:
    """The head path's exit state of a farm state, complex fields as
    (re, im) pairs."""
    pairs = {"ring": state.head.segments, "hist": state.hist, "overlap": state.head.overlap,
             "pre head": state.head.pre_multiplied, "pre tail0": state.tail0.pre_multiplied}
    return {k: torch.view_as_real(v) if v.is_complex() else v for k, v in pairs.items()}


def head_state_err(label: str, state, want) -> float:
    """Gate the head path's exit state against ``want`` (1e-4 a field; the
    ring heads equal).  Returns the largest error."""
    if not state.head.current == state.tail0.current == want.head.current:
        fail(f"{label}: ring head {state.head.current} / {state.tail0.current}, want "
             f"{want.head.current}")
    got, ref = head_fields(state), head_fields(want)
    errs = {k: max_abs(got[k], ref[k]) for k in got}
    print(f"{label}: max abs err by field {errs}", flush=True)
    for k, err in errs.items():
        gate(f"{label}: {k}", err, PARITY_TOL)
    return max(errs.values())


def state_nbytes(obj) -> int:
    """Bytes of every tensor in a (nested) state dataclass."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(state_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def peak_bytes(run) -> int:
    """The card memory a call allocates above what was allocated before it,
    at its peak (``torch.cuda.max_memory_allocated``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def by_kind(by_name: dict) -> dict:
    """A profile's device microseconds split into kernel B6's three kernels,
    kernel B5's and everything else (cuFFT, torch's elementwise and copy
    kernels)."""
    out = {"B6": 0.0, "B5": 0.0, "other": 0.0}
    for name, us in by_name.items():
        out["B6" if "b6_" in name else "B5" if "b5_" in name else "other"] += us
    return out


def farm_head_path(dev, farm_irs: torch.Tensor, gen: torch.Generator, crd: Card) -> dict:
    """Phase 13's head path (module docstring): kernel B6 against its plain
    version at the farm's shape, alone and inside the farm call, against the
    parent's form (the plain head path over cached meta-spectra, B5 for the
    tail).  Returns a record."""
    from fft_convolution_tpu_torch import ReverbFarm
    from fft_convolution_tpu_torch.ops import cuda_farm_heads
    from fft_convolution_tpu_torch.parallel import farm2

    rl = roofline()
    kernel, plain = cuda_farm_heads.heads_step, cuda_farm_heads.heads_step_plain
    rec = {}
    f = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], device=dev)
    cfg = f.cfg
    t = HEAD_PERIODS * cfg.period
    n_calls = HEAD_WARMUP + HEAD_TIMED
    xs = torch.randn((n_calls, t, FARM_VOICES, BLOCK), generator=gen, device=dev)
    f.process(xs[0])  # a history in the ring and hist
    st = f.state
    rows = torch.randn((HEAD_PERIODS, FARM_VOICES, cfg.tail_block), generator=gen,
                       device=dev) * FARM_SCALE
    delay = (st.tail_precalc, st.tail_output, rows)
    # the parent's form: the plain version over cached meta-spectra
    parent = functools.partial(plain, khat=farm2.farm2_head_khat(cfg, st, t))

    def call(state, x, step):
        return step(state.head, state.tail0, x, state.hist, state.suppress, delay)

    # gates: against the plain version, output and exit state; a replay bit-equal
    err = 0.0
    for flagged in ([], FARM_UPDATED):
        base = st.clone()
        base.suppress.fill_(False)
        if flagged:
            base.suppress[flagged] = True
        k, p_, again = base.clone(), base.clone(), base.clone()
        y, yp, y2 = call(k, xs[1], kernel), call(p_, xs[1], plain), call(again, xs[1], kernel)
        torch.cuda.synchronize()
        label = f"B6 vs plain, {HEAD_PERIODS}-period call, {len(flagged)} voices suppressed"
        e = max_abs(y, yp)
        gate(f"{label}: output", e, PARITY_TOL)
        err = max(err, e, head_state_err(label, k, p_))
        same = torch.equal(y, y2) and all(
            torch.equal(a, b) for a, b in zip(head_fields(k).values(),
                                              head_fields(again).values()))
        if not same:
            fail(f"{label}: a replay from the same state is not bit-equal")
        print(f"{label}: replay bit-equal", flush=True)
    rec["max_abs_err"] = err
    # the head path alone: events in turns (plain over cached meta-spectra, the
    # parent's form; kernel; kernel; plain) and a profile of each
    cost = rl.farm_heads_cost(cfg, FARM_VOICES, t)
    ev = {"kernel": [], "plain": []}
    for kind in ("plain", "kernel", "kernel", "plain"):
        s = st.clone()
        step = kernel if kind == "kernel" else parent
        for i in range(HEAD_WARMUP):
            call(s, xs[i], step)
        torch.cuda.synchronize()
        ms = event_ms([lambda i=i: call(s, xs[i], step)
                       for i in range(HEAD_WARMUP, n_calls)])
        ev[kind].append(statistics.median(ms))
    prof = {}
    for kind in ("kernel", "plain"):
        s = st.clone()
        step = kernel if kind == "kernel" else parent
        prof[kind] = profile_steps(lambda i: call(s, xs[i % n_calls], step), HEAD_PROFILED,
                                   HEAD_WARMUP)
        form = "B6" if kind == "kernel" else "plain over cached meta-spectra: the parent form"
        print(f"head path alone, {kind} ({form}): event medians {ev[kind]!r} ms, "
              f"{prof[kind]['device_us']!r} device us and "
              f"{prof[kind]['cuda_launches_per_step']!r} CUDA kernels a call (by kernel: "
              f"{prof[kind]['by_name']!r})", flush=True)
    kp = prof["kernel"]
    if sorted(kp["names"]) != sorted(n for n in kp["names"] if "b6_" in n) \
            or len(kp["names"]) != 3 or round(kp["cuda_launches_per_step"]) != 3:
        fail(f"B6: {kp['cuda_launches_per_step']!r} CUDA kernels a call ({kp['names']}), not "
             "three launches of its three kernels")
    bound = shares("B6 head path alone", cost, crd, device=kp["device_us"] / 1e6,
                   event=min(ev["kernel"]) / 1e3)
    shares("plain head path alone (the parent form)", cost, crd,
           device=prof["plain"]["device_us"] / 1e6, event=min(ev["plain"]) / 1e3)
    rec.update(ms=min(ev["kernel"]), plain_ms=min(ev["plain"]), event_ms=ev,
               device_us=kp["device_us"], device_us_by_kernel=kp["by_name"],
               cuda_launches_per_call=kp["cuda_launches_per_step"],
               plain_device_us=prof["plain"]["device_us"], bound=bound)
    del f, st, parent, delay, rows
    torch.cuda.empty_cache()

    # the farm call in both forms, f32 and bf16: events in turns, a profile
    # split by kernel, and the peak memory of one call beside the model
    for dtype, tag in ((torch.float32, "B5"), (torch.bfloat16, "B5p")):
        item = 8 if dtype == torch.float32 else 4
        fc = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], device=dev, tail_dtype=dtype)
        fc.process(xs[0])
        kh = farm2.farm2_head_khat(fc.cfg, fc.state, t)
        parent = functools.partial(plain, khat=kh)
        forms = {"kernel": lambda x: fc.process(x),
                 "parent": lambda x: farm2.farm2_stream(fc.cfg, fc.state, x, fc._step,
                                                        heads=parent)}
        fev = {"kernel": [], "parent": []}
        for kind in ("parent", "kernel", "kernel", "parent"):
            for i in range(HEAD_WARMUP):
                forms[kind](xs[i])
            torch.cuda.synchronize()
            fev[kind].append(statistics.median(event_ms(
                [lambda i=i: forms[kind](xs[i]) for i in range(HEAD_WARMUP, n_calls)])))
        model = farm2.farm2_bytes_per_voice(BLOCK, farm_irs.shape[1], t, item) * FARM_VOICES
        state_b = state_nbytes(fc.state)
        out = {"event_ms": fev, "model_bytes": model, "state_bytes": state_b,
               "khat_bytes": state_nbytes(kh)}
        for kind in ("kernel", "parent"):
            pr = profile_steps(lambda i: forms[kind](xs[i % n_calls]), HEAD_PROFILED,
                               HEAD_WARMUP)
            split = by_kind(pr["by_name"])
            held = state_b + (out["khat_bytes"] if kind == "parent" else 0)
            peak = held + peak_bytes(lambda: forms[kind](xs[1]))
            out[kind] = {"device_us": pr["device_us"], "by_kind": split,
                         "cuda_kernels": pr["cuda_launches_per_step"],
                         "by_name": pr["by_name"], "peak_bytes": peak}
            if kind == "kernel" and not abs(peak / model - 1) <= MODEL_TOL:
                fail(f"farm {tag}: measured peak {peak} bytes, farm2_bytes_per_voice x "
                     f"{FARM_VOICES} = {model}: off by more than {MODEL_TOL:.0%}")
            print(f"farm {tag} {HEAD_PERIODS}-period call, {kind} form: event medians "
                  f"{fev[kind]!r} ms; {pr['device_us']!r} device us in "
                  f"{pr['cuda_launches_per_step']!r} CUDA kernels ({split!r}); peak "
                  f"{peak / 1e9!r} GB = {peak / FARM_VOICES / 1e6!r} MB a voice (state "
                  f"{held / 1e9!r} GB and the call's transients; the model "
                  f"farm2_bytes_per_voice x {FARM_VOICES}: {model / 1e9!r} GB, "
                  f"measured / model {peak / model!r}) ({crd.smi})", flush=True)
        out["call_bound"] = shares(f"farm {tag} {HEAD_PERIODS}-period call (kernel form, "
                                   "this phase)", rl.farm_cost(fc.cfg, FARM_VOICES, t, item),
                                   crd, device=out["kernel"]["device_us"] / 1e6,
                                   event=min(fev["kernel"]) / 1e3)
        # the guard's own shape: one call of the most blocks a call takes, the
        # length farm2_init's guard prices (its own generator: later phases'
        # draws stay as they were)
        tg = fc.max_blocks_per_call
        xg = torch.randn((tg, FARM_VOICES, BLOCK), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(GUARD_SEED))
        fc.process(xg)  # cuFFT's plans at this length
        peak_g = state_b + peak_bytes(lambda: fc.process(xg))
        per_voice = farm2.farm2_bytes_per_voice(BLOCK, farm_irs.shape[1], tg, item)
        model_g = per_voice * FARM_VOICES
        total = torch.cuda.get_device_properties(dev).total_memory
        out["guard_call"] = {"t_blocks": tg, "peak_bytes": peak_g, "model_bytes": model_g}
        print(f"farm {tag} {tg}-block call (the guard's shape): peak {peak_g / 1e9!r} GB = "
              f"{peak_g / FARM_VOICES / 1e6!r} MB a voice; the model {model_g / 1e9!r} GB, "
              f"measured / model {peak_g / model_g!r}; the card's {total / 1e9!r} GB over the "
              f"model's {per_voice / 1e6!r} MB a voice: {total // per_voice} voices "
              f"({crd.smi})", flush=True)
        if not abs(peak_g / model_g - 1) <= MODEL_TOL:
            fail(f"farm {tag}, {tg}-block call: measured peak {peak_g} bytes, "
                 f"farm2_bytes_per_voice x {FARM_VOICES} = {model_g}: off by more than "
                 f"{MODEL_TOL:.0%}")
        rec[tag] = out
        del fc, kh, forms, xg
        torch.cuda.empty_cache()
    return rec


def farm_irs_on(dev) -> tuple[torch.Generator, torch.Tensor]:
    """Phase 10's IRs, drawn on the card (config 5: seed 5, scale 0.002),
    and the generator after them; the ranks of phase 17 draw the same."""
    gen = torch.Generator(device=dev).manual_seed(5)
    irs = torch.randn((FARM_VOICES, FARM_SECONDS * SR), generator=gen, device=dev) * FARM_SCALE
    return gen, irs


def mesh_inputs(dev, period: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 17's inputs, drawn on the card: the sharded two-stage engine's
    ``[calls, T, B]`` and the dp farm's ``[calls, T, V, B]``."""
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    x_ts = torch.randn((SP2_CALLS, SP2_PERIODS * period, BLOCK), generator=gen, device=dev)
    x_dp = torch.randn((DP_CALLS, DP_PERIODS * period, FARM_VOICES, BLOCK), generator=gen,
                       device=dev)
    return x_ts, x_dp


def mesh_rank(rank: int, world: int, ir: np.ndarray, ir_short: np.ndarray,
              x_sp: np.ndarray) -> dict:
    """One rank of phase 17 (module docstring), on ``cuda:0`` beside the
    other: the ``sp`` engines with the full inputs, the ``dp`` farm with this
    rank's voices.  Returns outputs on the host, launch counts, times."""
    import torch.distributed as dist

    from fft_convolution_tpu_torch import (ReverbFarm, ShardedFFTConvolver,
                                           ShardedTwoStageConvolver)
    from fft_convolution_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    counts = kernel_counts()
    out = {}

    def counted(run):
        counts.zero()
        res = run()
        torch.cuda.synchronize()
        return res, counts.read()

    # sp, per block: the flagship IR, then an update to a shorter one
    sp = make_mesh((world,), ("sp",), "cuda")
    sh = ShardedFFTConvolver(ir, BLOCK, len(ir), mesh=sp)
    xs = torch.from_numpy(x_sp).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y1, launches = counted(lambda: run_blocks(sh, xs[:SP_BLOCKS]))
    wall = time.perf_counter() - t0
    sh.update(ir_short)
    y2, launches2 = counted(lambda: run_blocks(sh, xs[SP_BLOCKS:]))
    out["sp"] = {"y": y1.cpu(), "y_update": y2.cpu(), "launches": [launches, launches2],
                 "wall_ms_per_block": wall / SP_BLOCKS * 1e3, "seg_count": sh.cfg.seg_count,
                 "slab_rows": sh.state.segments.shape[0], "active_after": sh.state.active_segs}
    del sh
    # the all-reduce of one block's [B+1] partial, on the card and on the host
    for where, buf in (("card", torch.zeros(BLOCK + 1, dtype=torch.complex64, device=dev)),
                       ("host", torch.zeros(BLOCK + 1, dtype=torch.complex64))):
        times = []
        for _ in range(ALLREDUCE_WARMUP + ALLREDUCE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(buf, group=sp.get_group("sp"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        out[f"allreduce_us_{where}"] = statistics.median(times[ALLREDUCE_WARMUP:])

    # sp, per period: the sharded two-stage engine over a 60 s IR
    _, farm_irs = farm_irs_on(dev)
    ts = ShardedTwoStageConvolver(farm_irs[0], BLOCK, farm_irs.shape[1], mesh=sp)
    x_ts, x_dp = mesh_inputs(dev, ts.cfg.period)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_ts, launches = counted(lambda: torch.stack([ts.process(xc.reshape(-1)) for xc in x_ts]))
    out["ts"] = {"y": y_ts.cpu(), "launches": launches, "tail_segments": ts.cfg.tail.seg_count,
                 "wall_ms_per_call": (time.perf_counter() - t0) / SP2_CALLS * 1e3}
    del ts

    # dp: the farm's voices split over the ranks, f32 and bf16 tails
    dp = make_mesh((world,), ("dp",), "cuda")
    for dtype, tag in ((torch.float32, "B5"), (torch.bfloat16, "B5p")):
        f = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], mesh=dp, tail_dtype=dtype)
        own = slice(f.local_voices.start, f.local_voices.stop)
        xr = x_dp[:, :, own].contiguous()
        y, launches = counted(lambda: torch.stack([f.process(xc) for xc in xr]))
        call_ms = event_ms([lambda: f.process(xr[0])] * DP_TIMED)
        out[tag] = {"y": y.cpu(), "launches": launches, "voices": (own.start, own.stop),
                    "call_ms": call_ms}
        del f, xr
    return out


def mesh_phase(dev, ir: np.ndarray, ir_b: np.ndarray, x_host: np.ndarray,
               farm_irs: torch.Tensor) -> dict:
    """Phase 17 (module docstring): the parent's references, the two ranks
    on the card, the gates.  Returns a record."""
    from fft_convolution_tpu_torch import FFTConvolver, ReverbFarm, TwoStageFFTConvolver
    from fft_convolution_tpu_torch.parallel.mesh import run_ranks

    record = {}
    ir_short = ir_b[:SP_UPDATE_SECONDS * SR]
    x_sp = x_host[:SP_BLOCKS + SP_UPDATE_BLOCKS]
    xs = torch.from_numpy(x_sp).to(dev)
    # the single-device engine with max_response_length padded to the mesh
    # multiple of segments, as the sharded engine pads it (3750 is already one)
    segs = -(-len(ir) // BLOCK)
    ref = FFTConvolver(ir, BLOCK, -(-segs // MESH_RANKS) * MESH_RANKS * BLOCK, device=dev)
    y_ref1 = ref.process(xs[:SP_BLOCKS].reshape(-1)).view(SP_BLOCKS, BLOCK)
    ref.update(ir_short)
    y_ref2 = ref.process(xs[SP_BLOCKS:].reshape(-1)).view(SP_UPDATE_BLOCKS, BLOCK)
    y64 = conv64(xs[:SP_BLOCKS].reshape(-1), torch.from_numpy(ir).to(dev))
    two = TwoStageFFTConvolver(farm_irs[0], BLOCK, farm_irs.shape[1], device=dev)
    x_ts, x_dp = mesh_inputs(dev, two.cfg.period)
    y_ts_ref = torch.stack([two.process(xc.reshape(-1)) for xc in x_ts])
    y_ts64 = conv64(x_ts.reshape(-1), farm_irs[0])
    dp_ref = {}
    for dtype, tag in ((torch.float32, "B5"), (torch.bfloat16, "B5p")):
        f = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], device=dev, tail_dtype=dtype)
        dp_ref[tag] = torch.stack([f.process(xc) for xc in x_dp])
        del f
    del two, ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_RANKS, ir, ir_short, x_sp, device="cuda", timeout=600)
    print(f"mesh: {MESH_RANKS} ranks, two processes sharing one card (gloo; not a "
          f"multi-card measurement), in {time.perf_counter() - t0:.2f} s", flush=True)

    sp_err, ts_err, dp_err = 0.0, 0.0, {"B5": 0.0, "B5p": 0.0}
    for rank, res in enumerate(ranks):
        sp = res["sp"]
        if sp["launches"] != [{k: 0 for k in sp["launches"][0]}] * 2:
            fail(f"rank {rank}: the sp path launched kernels {sp['launches']}")
        print(f"rank {rank} sp: {sp['seg_count']} segments, {sp['slab_rows']} ring rows on "
              f"this rank; wall {sp['wall_ms_per_block']!r} ms a block over {SP_BLOCKS} "
              f"blocks (one all-reduce each); all-reduce of {BLOCK + 1} complex64, median "
              f"over {ALLREDUCE_REPS}: card tensor {res['allreduce_us_card']!r} us, host "
              f"tensor {res['allreduce_us_host']!r} us", flush=True)
        y1, y2 = sp["y"].to(dev), sp["y_update"].to(dev)
        gate(f"rank {rank} ShardedFFTConvolver vs FFTConvolver ({SP_BLOCKS} blocks)",
             max_abs(y1, y_ref1), PARITY_TOL)
        gate(f"rank {rank} ShardedFFTConvolver vs float64 convolution", err64(
            y1.reshape(-1), y64), PARITY_TOL)
        gate(f"rank {rank} ShardedFFTConvolver after update to a {SP_UPDATE_SECONDS} s IR "
             f"(active {sp['active_after']}) vs FFTConvolver ({SP_UPDATE_BLOCKS} blocks)",
             max_abs(y2, y_ref2), PARITY_TOL)
        sp_err = max(sp_err, max_abs(y1, y_ref1), max_abs(y2, y_ref2))
        ts = res["ts"]
        if ts["launches"] != {k: 0 for k in ts["launches"]}:
            fail(f"rank {rank}: the sharded two-stage path launched kernels {ts['launches']}")
        y_ts = ts["y"].to(dev)
        gate(f"rank {rank} ShardedTwoStageConvolver ({ts['tail_segments']} tail segments, "
             f"{SP2_CALLS} calls of {SP2_PERIODS} periods) vs TwoStageFFTConvolver",
             max_abs(y_ts, y_ts_ref), PARITY_TOL)
        gate(f"rank {rank} ShardedTwoStageConvolver vs float64 convolution",
             err64(y_ts.reshape(-1), y_ts64), PARITY_TOL)
        print(f"rank {rank} sharded two-stage: wall {ts['wall_ms_per_call']!r} ms a call "
              f"({SP2_PERIODS} periods, one all-reduce a period)", flush=True)
        ts_err = max(ts_err, max_abs(y_ts, y_ts_ref))
        for tag, tol, scaled in (("B5", 1e-5, False), ("B5p", PACKED_REL_TOL, True)):
            r = res[tag]
            lo, hi = r["voices"]
            print(f"rank {rank} {tag} farm, voices {lo}-{hi - 1} launches: {r['launches']}",
                  flush=True)
            if r["launches"] != {k: (DP_CALLS if k in (tag, "B6") else 0)
                                 for k in r["launches"]}:
                fail(f"rank {rank}: {tag} farm launch counts {r['launches']}, not one "
                     f"{tag} and one B6 a call")
            y, want = r["y"].to(dev), dp_ref[tag][:, :, lo:hi]
            err = max_abs(y, want)
            bit_equal = bool(torch.equal(y, want))
            scale = float(want.abs().max())
            gate(f"rank {rank} {tag} farm slab vs the unsharded farm's voices {lo}-{hi - 1}"
                 + (" (of the output scale)" if scaled else ""), err / scale if scaled else err,
                 tol)
            print(f"rank {rank} {tag} farm slab bit-equal to the unsharded farm: {bit_equal}; "
                  f"{DP_PERIODS}-period call latency (event ms, {DP_TIMED} calls, the other "
                  f"rank sharing the card) {r['call_ms']!r}", flush=True)
            if not bit_equal:  # B5 and B6 sum in a fixed order, voice by voice
                fail(f"rank {rank}: the {tag} farm slab is not bit-equal to the unsharded "
                     "farm's voices")
            dp_err[tag] = max(dp_err[tag], err)
        if not all(torch.isfinite(t).all() for t in (y1, y2, y_ts)):
            fail(f"rank {rank}: non-finite output")
    record.update(
        sp={"max_abs_err": sp_err,
            "wall_ms_per_block": [r["sp"]["wall_ms_per_block"] for r in ranks],
            "allreduce_us_card": [r["allreduce_us_card"] for r in ranks],
            "allreduce_us_host": [r["allreduce_us_host"] for r in ranks]},
        two_stage={"max_abs_err": ts_err,
                   "wall_ms_per_call": [r["ts"]["wall_ms_per_call"] for r in ranks]},
        **{tag: {"max_abs_err": dp_err[tag],
                 "launches_per_rank": [r[tag]["launches"][tag] for r in ranks],
                 "call_ms_per_rank": [statistics.median(r[tag]["call_ms"]) for r in ranks]}
           for tag in ("B5", "B5p")})
    return record


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    import scipy.signal

    from fft_convolution_tpu_torch import ReverbFarm, _build
    from fft_convolution_tpu_torch.ops import (cuda_crossfade, cuda_engine, cuda_farm_mac,
                                               cuda_stream, cuda_two_stage)
    from fft_convolution_tpu_torch.ops.fft import generate_sinusoid
    from fft_convolution_tpu_torch.serving import (CudaCrossfadeConvolver, CudaFFTConvolver,
                                                   CudaStreamingConvolver,
                                                   CudaTwoStageConvolver)

    # parity paths run in IEEE float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    counts = kernel_counts()
    t_run = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase:.2f} s", flush=True)
        t_phase = now

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)
    crd = card()
    print(crd.smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    phase_done("1 build")

    # ---- inputs as the JAX bench makes them (bench.py:175-183) ----------
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(IR_SECONDS * SR) * 0.01).astype(np.float32)
    x_host = rng.standard_normal((T_BLOCKS, BLOCK)).astype(np.float32)
    xs = torch.from_numpy(x_host).to(dev)

    # ---- 2. main path, counted ------------------------------------------
    t0 = time.perf_counter()
    uni = CudaFFTConvolver(ir, BLOCK, len(ir), device=dev)
    two = CudaTwoStageConvolver(ir, BLOCK, len(ir), device=dev)
    torch.cuda.synchronize()
    print(f"flagship: uniform N={uni.cfg.seg_count}; two-stage tail "
          f"{two.cfg.tail_block}, period {two.cfg.period}, head/tail0 "
          f"{two.cfg.head.seg_count} segments, big tail {two.cfg.tail.seg_count} "
          f"segments (init {time.perf_counter() - t0:.2f} s)", flush=True)
    if (uni.cfg.seg_count, two.cfg.tail_block, two.cfg.tail.seg_count) != (3750, 8192, 57):
        fail("flagship shapes differ from N=3750, tail 8192, 57 tail segments")
    uni_plain, two_plain = uni.clone(), two.clone()
    uni_plain._step = cuda_engine.block_step_plain
    two_plain._step = cuda_two_stage.block_step_plain

    launches = {}
    y_uni = counts.drive("B1 path", lambda: run_blocks(uni, xs[:N_UNIFORM]),
                         {"B1": N_UNIFORM})
    y_two = counts.drive("B2 path", lambda: run_blocks(two, xs[:N_TWO_STAGE]),
                         {"B2": N_TWO_STAGE})
    launches.update(B1=N_UNIFORM, B2=N_TWO_STAGE)
    # the big tail ran at rows 63, 127 and 191; its first output is summed
    # into y over blocks 128-191 (IR taps >= 16384), which the float64
    # check below covers
    big_tail_runs = (-two.tail_state.current) % two.cfg.tail.seg_count
    print(f"big tail ran {big_tail_runs} times: {two.tail_replays} CUDA-graph replays on the "
          f"wrapper's side stream, {two.tail_inline} in line", flush=True)
    if not big_tail_runs == two.tail_replays == N_TWO_STAGE // two.cfg.period \
            or two.tail_inline:
        fail("big tail did not run once per period as a graph replay on the side stream")
    phase_done("2 B1/B2 paths")

    # ---- 3. kernel path vs plain path on the card -----------------------
    y_uni_plain = run_blocks(uni_plain, xs[:N_UNIFORM])
    y_two_plain = run_blocks(two_plain, xs[:N_TWO_STAGE])
    b1_err = max_abs(y_uni, y_uni_plain)
    b2_err = max_abs(y_two, y_two_plain)
    gate("B1 kernel vs plain (CudaFFTConvolver, 128 blocks)", b1_err, PARITY_TOL)
    gate("B2 kernel vs plain (CudaTwoStageConvolver, 192 blocks)", b2_err, PARITY_TOL)
    n_direct = N_TWO_STAGE * BLOCK
    direct = np.convolve(x_host.reshape(-1)[:n_direct].astype(np.float64),
                         ir[:n_direct].astype(np.float64))[:n_direct]
    gate("B2 path vs float64 direct convolution", max_abs(y_two, direct), PARITY_TOL)
    gate("B1 path vs float64 direct convolution", max_abs(y_uni, direct[:N_UNIFORM * BLOCK]),
         PARITY_TOL)
    if not (torch.isfinite(y_two).all() and torch.isfinite(y_uni).all()):
        fail("non-finite output")
    phase_done("3 B1/B2 parity")

    # ---- 4. recorded golden ---------------------------------------------
    golden = np.load(ROOT / "tests" / "golden" / "compare_partitioned.npz")["y"]
    g_ir = generate_sinusoid(128_000, 1000.0, 44100, 0.1)
    g_x = torch.from_numpy(generate_sinusoid(64 * 1000, 1300.0, 44100, 0.1)).to(dev)
    for name, cls in (("CudaFFTConvolver", CudaFFTConvolver),
                      ("CudaTwoStageConvolver", CudaTwoStageConvolver)):
        conv = cls(g_ir, 64, len(g_ir), device=dev)
        gate(f"golden {name}", max_abs(run_blocks(conv, g_x.reshape(-1, 64)), golden),
             GOLDEN_TOL)
    phase_done("4 golden")

    # ---- 5. latency, plain / kernel / kernel / plain ---------------------
    timing = {}

    def compare(label, kernel_conv, plain_conv, inputs, unit="block", **kw):
        runs = [("plain", plain_conv), ("kernel", kernel_conv),
                ("kernel", kernel_conv), ("plain", plain_conv)]
        res = {"kernel": [], "plain": []}
        for kind, conv in runs:
            res[kind].append(latency(conv, inputs, **kw))
        timing[label] = res
        for kind in ("kernel", "plain"):
            for r in res[kind]:
                print(f"latency {label} {kind}: event median {r['event_ms']!r} ms, "
                      f"event max {r['event_max_ms']!r} ms, enqueue median "
                      f"{r['enqueue_ms']!r} ms, sync median {r['sync_ms']!r} ms per {unit} "
                      f"over {r['blocks']} {unit}s", flush=True)

    compare("B1", uni, uni_plain, xs)
    compare("B2", two, two_plain, xs)
    phase_done("5 B1/B2 latency")

    # ---- 6. B3: crossfade morph at the flagship shape ---------------------
    ir_b = (rng.standard_normal(IR_SECONDS * SR) * 0.01).astype(np.float32)
    ir_c = (rng.standard_normal(IR_SECONDS * SR) * 0.01).astype(np.float32)
    xf = CudaCrossfadeConvolver(ir, BLOCK, len(ir), crossfade_samples=XFADE_FADE,
                                device=dev)
    xf_plain = xf.clone()
    xf_plain._step = cuda_crossfade.block_step_plain
    print(f"crossfade: N={xf.cfg.seg_count}, hold {xf.cf_cfg.hold_samples}, "
          f"fade {xf.cf_cfg.fading_samples} samples", flush=True)

    def run_morph(conv):
        """192 blocks; update(ir_b) at block 64, update(ir_c) two blocks into
        that fade (pending).  Returns the output and the first block from
        which both fades are over."""
        ys, settled = [], None
        for t in range(XFADE_BLOCKS):
            if t == XFADE_UPDATE:
                conv.update(ir_b)
            if t == XFADE_UPDATE + 2:
                conv.update(ir_c)
                if not conv.response_pending:
                    fail("second update did not park in the pending slot")
            ys.append(conv.process(xs[t]))
            busy = conv.is_crossfading() or conv.response_pending
            if t > XFADE_UPDATE + 2 and not busy and settled is None:
                settled = t + 1
        return torch.stack(ys), settled

    y_xf, settled = counts.drive("B3 path", lambda: run_morph(xf), {"B3": XFADE_BLOCKS})
    launches["B3"] = XFADE_BLOCKS
    y_xf_plain, settled_plain = run_morph(xf_plain)
    b3_err = max_abs(y_xf, y_xf_plain)
    gate("B3 kernel vs plain (CudaCrossfadeConvolver, 192 blocks)", b3_err, PARITY_TOL)
    if settled is None or settled != settled_plain or xf.cf_state.target != 0:
        fail(f"fades did not settle on the last IR (settled {settled}, {settled_plain})")
    n_xf = XFADE_BLOCKS * BLOCK
    x_xf = x_host.reshape(-1)[:n_xf].astype(np.float64)
    direct_a = scipy.signal.fftconvolve(x_xf, ir[:n_xf].astype(np.float64))[:n_xf]
    direct_c = scipy.signal.fftconvolve(x_xf, ir_c[:n_xf].astype(np.float64))[:n_xf]
    flat = y_xf.reshape(-1)
    gate("B3 before the update vs float64 convolution with the first IR",
         max_abs(flat[:XFADE_UPDATE * BLOCK], direct_a[:XFADE_UPDATE * BLOCK]), PARITY_TOL)
    gate(f"B3 from block {settled} (both fades over) vs float64 convolution with "
         "the last IR", max_abs(flat[settled * BLOCK:], direct_c[settled * BLOCK:]),
         PARITY_TOL)
    phase_done("6 B3 crossfade")

    # ---- 7. B4: 30 s IR streaming, f32 and bf16 tables ---------------------
    ir30 = (rng.standard_normal(STREAM_SECONDS * SR) * 0.01).astype(np.float32)
    x_st_host = rng.standard_normal((STREAM_CALLS, STREAM_CALL * BLOCK)).astype(np.float32)
    x_st = torch.from_numpy(x_st_host).to(dev)
    st = CudaStreamingConvolver(ir30, BLOCK, len(ir30), device=dev)
    st_bf = CudaStreamingConvolver(ir30, BLOCK, len(ir30), device=dev,
                                   storage="bf16_packed")
    n_st = st.cfg.seg_count
    print(f"stream: N={n_st} (chunk {st.chunk}), {STREAM_CALLS} calls of {STREAM_CALL} "
          f"blocks = {STREAM_CALLS * STREAM_CALL} blocks", flush=True)
    if n_st != STREAM_SEGS or STREAM_CALLS * STREAM_CALL <= n_st:
        fail(f"stream shape differs from N={STREAM_SEGS} or the ring would not wrap")
    st_plain, st_bf_plain = st.clone(), st_bf.clone()
    st_plain._step = st_bf_plain._step = cuda_stream.stream_plain
    y_st = counts.drive("B4 f32 path", lambda: run_blocks(st, x_st), {"B4": STREAM_CALLS})
    y_bf = counts.drive("B4 bf16 path", lambda: run_blocks(st_bf, x_st),
                        {"B4p": STREAM_CALLS})
    launches.update(B4=STREAM_CALLS, B4p=STREAM_CALLS)
    if st.state.w != (STREAM_CALLS * STREAM_CALL) % n_st:
        fail(f"ring head {st.state.w} after {STREAM_CALLS * STREAM_CALL} blocks")
    b4_err = max_abs(y_st, run_blocks(st_plain, x_st))
    gate("B4 f32 kernel vs plain (30 s IR, 11520 blocks)", b4_err, PARITY_TOL)
    b4p_err = max_abs(y_bf, run_blocks(st_bf_plain, x_st))
    gate("B4 bf16 kernel vs plain", b4p_err, PARITY_TOL)
    n_x = x_st_host.size
    direct30 = scipy.signal.fftconvolve(x_st_host.reshape(-1).astype(np.float64),
                                        ir30.astype(np.float64))[:n_x]
    print(f"B4 output scale {float(y_st.abs().max())!r}", flush=True)
    gate("B4 f32 path vs float64 fftconvolve", max_abs(y_st, direct30), PARITY_TOL)
    gate("B4 bf16 path vs f32 path, relative to the output scale", rel(y_bf, y_st),
         PACKED_REL_TOL)
    if not (torch.isfinite(y_st).all() and torch.isfinite(y_bf).all()):
        fail("non-finite stream output")
    phase_done("7 B4 stream")

    # ---- 8. B1p: bf16 ring and table at the flagship shape ------------------
    uni_bf = CudaFFTConvolver(ir, BLOCK, len(ir), device=dev, storage="bf16_packed")
    uni_bf_plain = uni_bf.clone()
    uni_bf_plain._step = cuda_engine.block_step_plain
    y_bf1 = counts.drive("B1p path", lambda: run_blocks(uni_bf, xs[:N_UNIFORM]),
                         {"B1p": N_UNIFORM})
    launches["B1p"] = N_UNIFORM
    b1p_err = max_abs(y_bf1, run_blocks(uni_bf_plain, xs[:N_UNIFORM]))
    gate("B1p kernel vs plain (CudaFFTConvolver bf16_packed, 128 blocks)", b1p_err,
         PARITY_TOL)
    gate("B1p path vs B1 f32 kernel path, relative to the output scale",
         rel(y_bf1, y_uni), PACKED_REL_TOL)
    phase_done("8 B1p")

    # ---- 9. latency of B3, B1p (per block) and B4 (per call) ----------------
    compare("B3", xf, xf_plain, xs)
    compare("B1p", uni_bf, uni_bf_plain, xs)
    compare("B4", st, st_plain, x_st, unit="call", warmup=STREAM_WARMUP,
            timed_n=STREAM_TIMED)
    compare("B4p", st_bf, st_bf_plain, x_st, unit="call", warmup=STREAM_WARMUP,
            timed_n=STREAM_TIMED)
    for label in ("B4", "B4p"):
        for kind in ("kernel", "plain"):
            per_block = [r["event_ms"] / STREAM_CALL for r in timing[label][kind]]
            print(f"latency {label} {kind}: event median per block {per_block!r} ms",
                  flush=True)
    phase_done("9 B3/B1p/B4 latency")

    # ---- 10. B5: the reverb farm at 128 voices x 60 s, f32 tail ------------
    gen, farm_irs = farm_irs_on(dev)
    t0 = time.perf_counter()
    farm = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], device=dev)
    torch.cuda.synchronize()
    cfg = farm.cfg
    shapes = (cfg.tail_block, cfg.period, cfg.head.seg_count, cfg.tail0.seg_count,
              cfg.tail.seg_count)
    print(f"farm: {FARM_VOICES} voices x {FARM_SECONDS} s, tail block {shapes[0]}, period "
          f"{shapes[1]}, head/tail0 {shapes[2]}/{shapes[3]} segments, big tail {shapes[4]} "
          f"segments (init {time.perf_counter() - t0:.2f} s)", flush=True)
    if shapes != FARM_SHAPES:
        fail(f"farm shapes {shapes} differ from {FARM_SHAPES}")
    p = cfg.period
    farm_x = torch.randn((sum(FARM_PERIODS) * p, FARM_VOICES, BLOCK), generator=gen,
                         device=dev)
    calls = list(farm_x.split([k * p for k in FARM_PERIODS]))
    farm_plain = plain_farm(farm)

    def run_calls(f, xs_):
        return torch.cat([f.process(xc) for xc in xs_])

    y_farm = counts.drive("B5/B6 f32 path", lambda: run_calls(farm, calls),
                          {"B5": len(calls), "B6": len(calls)})
    if farm.state.tail.q != sum(FARM_PERIODS) % cfg.tail.seg_count:
        fail(f"tail phase {farm.state.tail.q} after {sum(FARM_PERIODS)} periods")
    b5_err = max_abs(y_farm, run_calls(farm_plain, calls))
    gate(f"B5/B6 f32 kernels vs plain (ReverbFarm, {len(calls)} calls, all voices)", b5_err,
         PARITY_TOL)
    b6_err = max(b5_err, head_state_err("B6 exit state vs plain after phase 10's calls",
                                        farm.state, farm_plain.state))
    print(f"farm output scale {float(y_farm.abs().max())!r}", flush=True)
    for voice in (0, FARM_VOICES - 1):
        xv = farm_x[:, voice].reshape(-1).double().cpu().numpy()
        ref = scipy.signal.fftconvolve(xv, farm_irs[voice].double().cpu().numpy())[:xv.size]
        gate(f"B5 f32 farm voice {voice} vs float64 fftconvolve ({xv.size} samples)",
             max_abs(y_farm[:, voice].reshape(-1), ref), PARITY_TOL)
    if not torch.isfinite(y_farm).all():
        fail("non-finite farm output")
    phase_done("10 B5 f32 farm")

    # ---- 11. update, update_voices, two calls --------------------------------
    new_irs = torch.randn(farm_irs.shape, generator=gen, device=dev) * FARM_SCALE
    new3 = torch.randn((len(FARM_UPDATED), farm_irs.shape[1]), generator=gen,
                       device=dev) * FARM_SCALE
    x11 = list(torch.randn((2 * 8 * p, FARM_VOICES, BLOCK), generator=gen,
                           device=dev).split(8 * p))
    for f in (farm, farm_plain):
        f.update(new_irs)
    skipped = farm.clone()
    for f in (farm, farm_plain):
        f.update_voices(FARM_UPDATED, new3)
    y11 = counts.drive("B5/B6 f32 path after updates", lambda: run_calls(farm, x11),
                       {"B5": len(x11), "B6": len(x11)})
    b5_upd_err = max_abs(y11, run_calls(farm_plain, x11))
    gate("B5/B6 f32 kernels vs plain after update + update_voices (B6's suppress pass)",
         b5_upd_err, PARITY_TOL)
    b6_err = max(b6_err, b5_upd_err,
                 head_state_err("B6 exit state vs plain after the updates and two calls",
                                farm.state, farm_plain.state))
    keep = [i for i in range(FARM_VOICES) if i not in FARM_UPDATED]
    if not torch.equal(y11[:, keep], run_calls(skipped, x11)[:, keep]):
        fail("untouched voices differ from the clone that skipped update_voices")
    print(f"update_voices: {len(keep)} untouched voices bit-identical", flush=True)
    launches["B5"] = len(calls) + len(x11)
    launches["B6"] = len(calls) + len(x11)
    b5_err = max(b5_err, b5_upd_err)
    del farm, farm_plain, skipped, new_irs, new3, x11, y11
    torch.cuda.empty_cache()
    phase_done("11 B5 updates")

    # ---- 12. B5 bf16: the same farm, bf16 ring and table -----------------------
    farm_bf = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], device=dev,
                         tail_dtype=torch.bfloat16)
    farm_bf_plain = plain_farm(farm_bf)
    y_bf5 = counts.drive("B5p/B6 bf16 path", lambda: run_calls(farm_bf, calls),
                         {"B5p": len(calls), "B6": len(calls)})
    launches["B5p"] = len(calls)
    launches["B6"] += len(calls)
    b5p_err = max_abs(y_bf5, run_calls(farm_bf_plain, calls))
    gate("B5 bf16 kernel vs plain (ReverbFarm, all voices)", b5p_err, PARITY_TOL)
    gate("B5 bf16 farm vs f32 farm, relative to the output scale", rel(y_bf5, y_farm),
         PACKED_REL_TOL)
    if not torch.isfinite(y_bf5).all():
        fail("non-finite bf16 farm output")
    del farm_bf, farm_bf_plain, y_bf5, y_farm, farm_x, calls
    torch.cuda.empty_cache()
    phase_done("12 B5 bf16 farm")

    # ---- 13. farm latency, kernel path against plain path ---------------------
    rl = roofline()
    farm_step = {}  # tag: (step ms, bound and share of the step alone)
    farm_call = {}  # label: bound and share of the call (the kernel path's best median)
    for dtype, tag in ((torch.float32, "B5"), (torch.bfloat16, "B5p")):
        item = rl.C64 if dtype == torch.float32 else rl.BF16_PAIR
        f = ReverbFarm(farm_irs, BLOCK, farm_irs.shape[1], device=dev, tail_dtype=dtype)
        f_plain = plain_farm(f)
        for periods, (warm, timed) in FARM_TIMED.items():
            xt = torch.randn((warm + timed, periods * p, FARM_VOICES, BLOCK), generator=gen,
                             device=dev)
            label = f"{tag} {periods}-period"
            compare(label, f, f_plain, xt, unit="call", warmup=warm, timed_n=timed)
            audio_s = periods * p * BLOCK / SR
            for kind in ("kernel", "plain"):
                rt = [FARM_VOICES * audio_s / (r["event_ms"] / 1e3)
                      for r in timing[label][kind]]
                print(f"latency {label} {kind}: real-time voices {rt!r} "
                      f"({audio_s!r} s of audio per call)", flush=True)
            farm_call[label] = shares(
                f"{label} call", rl.farm_cost(cfg, FARM_VOICES, periods * p, item), crd,
                event=min(r["event_ms"] for r in timing[label]["kernel"]) / 1e3)
            del xt
        # the step alone at the 8-period call's T = 8, on the farm's tensors
        tail = f.state.tail
        specs = torch.randn((8, FARM_VOICES, cfg.tail_block + 1), dtype=torch.complex64,
                            generator=gen, device=dev)
        cost = rl.farm_tail_step_cost(cfg, FARM_VOICES, 8, item)
        moved = cost.bytes
        for kind, step in (("kernel", f._step), ("plain", cuda_farm_mac.phased_step_plain)):
            reps = 10 if kind == "kernel" else 3
            step(tail.ring, tail.table, specs, 0)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(reps):
                step(tail.ring, tail.table, specs, 0)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
            print(f"{tag} step alone, T=8, {kind}: {ms!r} ms; {moved / 1e9!r} GB compulsory "
                  f"-> {moved / ms / 1e9!r} TB/s", flush=True)
            if kind == "kernel":
                farm_step[tag] = (ms, shares(f"{tag} step alone, T=8", cost, crd,
                                             step=ms / 1e3))
        del f, f_plain, tail, specs
        torch.cuda.empty_cache()
    heads = farm_head_path(dev, farm_irs, gen, crd)
    b6_err = max(b6_err, heads["max_abs_err"])
    print(json.dumps({"farm_head_path": heads}), flush=True)
    phase_done("13 B5/B6 latency, the head path")

    # ---- 14. device time and CUDA launches per step, from the profiler ------------
    p_two = two.cfg.period
    steps = {
        "B1": lambda i: cuda_engine.block_step(uni.consts, uni.state, xs[i]),
        "B1p": lambda i: cuda_engine.block_step_packed(uni_bf.consts, uni_bf.state, xs[i]),
        "B2": lambda i: cuda_two_stage.block_step(two.consts, two.fstate, two.buffers,
                                                  i % p_two, xs[i]),
        "B3": lambda i: cuda_crossfade.block_step(xf.consts, xf.state, xf.cf_cfg,
                                                  xf.cf_state, xs[i]),
    }
    # the roofline costs (utils/roofline.py): B1/B1p a one-block uniform
    # stream, B4/B4p a 64-block one (bf16: ring and table, table alone), B3
    # a one-block crossfade stream, B2 its own step
    bf16 = rl.BF16_PAIR
    costs = {"B1": rl.stream_conv_cost(uni.cfg, 1),
             "B1p": rl.stream_conv_cost(uni_bf.cfg, 1, ring_item=bf16, table_item=bf16),
             "B2": rl.two_stage_step_cost(two.cfg),
             "B3": rl.crossfade_stream_cost(xf.cfg, 1),
             "B4": rl.stream_conv_cost(st.cfg, STREAM_CALL),
             "B4p": rl.stream_conv_cost(st_bf.cfg, STREAM_CALL, table_item=bf16)}
    profiled = {label: profile_steps(step, PROFILE_STEPS, PROFILE_WARMUP)
                for label, step in steps.items()}
    for label, conv in (("B4", st), ("B4p", st_bf)):
        profiled[label] = profile_steps(
            lambda i, c=conv: c._step(c.consts, c.state, x_st[i % STREAM_CALLS]
                                      .reshape(-1, BLOCK)),
            PROFILE_CALLS, PROFILE_CALL_WARMUP)
    bounds = {}
    for label, prof in profiled.items():
        per_kernel = ", ".join(f"{name} {us!r}" for name, us in prof["by_name"].items())
        print(f"profile {label}: {prof['device_us']!r} device us and "
              f"{prof['cuda_launches_per_step']!r} CUDA kernels per step "
              f"(device us by kernel: {per_kernel})", flush=True)
        bounds[label] = shares(f"profile {label}", costs[label], crd,
                               device=prof["device_us"] / 1e6)
    for label, want in (("B1", 1), ("B1p", 1), ("B2", 1), ("B3", 1), ("B4", 3), ("B4p", 3)):
        # `want` kernels, each once a step (the profiler may drop an event of 256)
        prof = profiled[label]
        if len(prof["names"]) != want or round(prof["cuda_launches_per_step"]) != want:
            fail(f"{label}: {prof['cuda_launches_per_step']!r} CUDA kernels per step "
                 f"({prof['names']}), not {want} launches of {want} kernels")
    phase_done("14 device profile")

    # ---- 15. batched streams at the JAX benchmarks' shapes --------------------
    batched = batched_streams(dev, counts, ir30, x_st, crd,
                              (profiled["B4"]["device_us"], costs["B4"]))
    print(json.dumps({"batched_streams": batched}), flush=True)
    phase_done("15 batched streams")

    # ---- 16. the host runtime ---------------------------------------------------
    host = host_runtime(dev, counts, ir, ir_b, x_host,
                        {"B1": uni, "B1p": uni_bf, "B2": two, "B3": xf}, timing, crd)
    print(json.dumps({"host_runtime": host}), flush=True)
    phase_done("16 host runtime")

    # ---- 17. the mesh: two ranks on one card -------------------------------------
    mesh = mesh_phase(dev, ir, ir_b, x_host, farm_irs)
    print(json.dumps({"mesh": mesh}), flush=True)
    phase_done("17 mesh")

    def best(label, kind, key="event_ms"):
        return min(r[key] for r in timing[label][kind])

    def row(label, name, source, replaces, err, timed=None):
        timed = timed or label
        out = {"name": name, "route": "cuda",
               "source": f"fft_convolution_tpu_torch/csrc/{source}",
               "replaces": f"fft_convolution_tpu/{replaces}",
               "launches": launches[label], "max_abs_err": err,
               "ms": best(timed, "kernel"), "plain_ms": best(timed, "plain")}
        if label in profiled:
            bd = bounds[label]
            out.update(device_us=profiled[label]["device_us"],
                       device_us_by_kernel=profiled[label]["by_name"],
                       cuda_launches_per_step=profiled[label]["cuda_launches_per_step"],
                       share=bd["share_device"])
        else:  # B5: the step alone at T = 8, and the 8-period call
            step_ms, bd = farm_step[label]
            call = farm_call[timed]
            out.update(step_ms=step_ms, share=bd["share_step"], call_bound_us=call["bound_us"],
                       call_share=call["share_event"])
        out.update({k: bd[k] for k in ("bound_ms", "bound_us", "bound_by", "l2_resident")})
        out["library_ms"] = None
        return out

    kernels = [
        row("B1", "B1 uniform block step", "b1_uniform_step.cu", "ops/pallas_engine.py:171",
            b1_err),
        row("B2", "B2 fused head+tail0 block step", "b2_two_stage_step.cu",
            "ops/pallas_two_stage.py:92", b2_err),
        row("B3", "B3 crossfade A/B block step with the mix", "b3_crossfade_step.cu",
            "ops/pallas_crossfade.py:135", b3_err),
        row("B4", "B4-f32 long-IR stream, f32 table (ms per 64-block call)",
            "b4_stream.cu", "ops/pallas_stream.py:96", b4_err),
        row("B4p", "B4-bf16 long-IR stream, bf16 table (ms per 64-block call)",
            "b4_stream.cu", "ops/pallas_stream.py:96", b4p_err),
        row("B1p", "B1p uniform block step, bf16 ring and table", "b1_uniform_step.cu",
            "ops/pallas_engine.py:240", b1p_err),
    ]
    for label, name, replaces, err in (
            ("B5", "B5-f32 farm big-tail phased step", "ops/pallas_farm_mac.py:186", b5_err),
            ("B5p", "B5-bf16 farm big-tail phased step, bf16 ring and table",
             "ops/pallas_farm_mac.py:299", b5p_err)):
        kernels.append(row(label, name + f" ({FARM_VOICES} voices x {FARM_SECONDS} s; ms "
                           "per 8-period ReverbFarm.process call; step_ms and the bound "
                           "for the step alone at T=8); also under the dp mesh, per rank "
                           "(dp_mesh: phase 17)", "b5_farm_tail.cu",
                           replaces, err, timed=f"{label} 8-period"))
        kernels[-1]["dp_mesh"] = {"ranks": MESH_RANKS, **mesh[label]}
    bd = heads["bound"]
    kernels.append({
        "name": f"B6 farm head+tail0 path ({FARM_VOICES} voices x {FARM_SECONDS} s; ms per "
                f"{HEAD_PERIODS}-period call of the head path alone; plain_ms: the plain "
                "version over cached meta-spectra, the parent's form)",
        "route": "cuda", "source": "fft_convolution_tpu_torch/csrc/b6_farm_heads.cu",
        "replaces": "fft_convolution_tpu/parallel/farm2.py:931",
        "launches": launches["B6"], "max_abs_err": b6_err, "ms": heads["ms"],
        "plain_ms": heads["plain_ms"], "device_us": heads["device_us"],
        "device_us_by_kernel": heads["device_us_by_kernel"],
        "cuda_launches_per_step": heads["cuda_launches_per_call"],
        "share": bd["share_device"],
        **{k: bd[k] for k in ("bound_ms", "bound_us", "bound_by", "l2_resident")},
        "library_ms": None})
    print(f"total: {time.perf_counter() - t_run:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
