"""On-card smoke run of the PyTorch/CUDA port (``fft_convolution_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build the hand-written kernels (nvcc, ``sm_90a``) and print the card;
2. main path: ``CudaFFTConvolver`` (kernel B1) for 128 blocks and
   ``CudaTwoStageConvolver`` (kernel B2, big tail every 64 blocks) for 192
   blocks at the flagship shape — block 128, a 10 s 48 kHz IR — with every
   launch counter set to 0 before and read after;
3. the same wrappers through the kernels' plain PyTorch versions on the card,
   held to 1e-4 (max abs) against the kernel path, and the two-stage output
   also against a float64 direct convolution;
4. both wrappers over the recorded golden (``tests/golden``), held to 1e-5;
5. per-block latency, kernel path against plain path (recorded, not gated).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches, error and times.
Imports nothing of JAX.
"""

from __future__ import annotations

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


def latency(conv, xs: torch.Tensor) -> dict:
    """Per-block latency of ``conv.process`` on blocks already on the card.
    ``event_ms``: CUDA events around each call, no synchronisation in the
    loop (device time from the block's start to its last kernel, host launch
    gaps included).  ``sync_ms``: host clock around each call plus a
    synchronise (the real-time callback shape)."""
    for xb in xs[:WARMUP_BLOCKS]:
        conv.process(xb)
    torch.cuda.synchronize()
    timed = xs[WARMUP_BLOCKS:WARMUP_BLOCKS + TIMED_BLOCKS]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in timed]
    for (start, end), xb in zip(events, timed):
        start.record()
        conv.process(xb)
        end.record()
    torch.cuda.synchronize()
    ev = [s.elapsed_time(e) for s, e in events]
    sync = []
    for xb in timed:
        t0 = time.perf_counter()
        conv.process(xb)
        torch.cuda.synchronize()
        sync.append((time.perf_counter() - t0) * 1e3)
    return {"event_ms": statistics.median(ev), "event_max_ms": max(ev),
            "sync_ms": statistics.median(sync), "blocks": len(ev)}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    from fft_convolution_tpu_torch import _build
    from fft_convolution_tpu_torch.ops import cuda_engine, cuda_two_stage
    from fft_convolution_tpu_torch.ops.fft import generate_sinusoid
    from fft_convolution_tpu_torch.serving import CudaFFTConvolver, CudaTwoStageConvolver

    # parity paths run in IEEE float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

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

    cuda_engine.block_step.launches = 0
    cuda_two_stage.block_step.launches = 0
    y_uni = run_blocks(uni, xs[:N_UNIFORM])
    y_two = run_blocks(two, xs[:N_TWO_STAGE])
    torch.cuda.synchronize()
    launches = {"B1": cuda_engine.block_step.launches,
                "B2": cuda_two_stage.block_step.launches}
    print(f"main path launches: {launches}", flush=True)
    if launches != {"B1": N_UNIFORM, "B2": N_TWO_STAGE}:
        fail(f"launch counts {launches} != blocks ({N_UNIFORM}, {N_TWO_STAGE})")
    # the big tail ran at rows 63, 127 and 191; its first output is summed
    # into y over blocks 128-191 (IR taps >= 16384), which the float64
    # check below covers
    big_tail_runs = (-two.tail_state.current) % two.cfg.tail.seg_count
    print(f"big tail ran {big_tail_runs} times", flush=True)
    if big_tail_runs != N_TWO_STAGE // two.cfg.period:
        fail("big tail did not run once per period")

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

    # ---- 4. recorded golden ---------------------------------------------
    golden = np.load(ROOT / "tests" / "golden" / "compare_partitioned.npz")["y"]
    g_ir = generate_sinusoid(128_000, 1000.0, 44100, 0.1)
    g_x = torch.from_numpy(generate_sinusoid(64 * 1000, 1300.0, 44100, 0.1)).to(dev)
    for name, cls in (("CudaFFTConvolver", CudaFFTConvolver),
                      ("CudaTwoStageConvolver", CudaTwoStageConvolver)):
        conv = cls(g_ir, 64, len(g_ir), device=dev)
        gate(f"golden {name}", max_abs(run_blocks(conv, g_x.reshape(-1, 64)), golden),
             GOLDEN_TOL)

    # ---- 5. latency, plain / kernel / kernel / plain ---------------------
    timing = {}
    for label, kernel_conv, plain_conv in (("B1", uni, uni_plain), ("B2", two, two_plain)):
        runs = [("plain", plain_conv), ("kernel", kernel_conv),
                ("kernel", kernel_conv), ("plain", plain_conv)]
        res = {"kernel": [], "plain": []}
        for kind, conv in runs:
            res[kind].append(latency(conv, xs))
        timing[label] = res
        for kind in ("kernel", "plain"):
            for r in res[kind]:
                print(f"latency {label} {kind}: event median {r['event_ms']!r} ms, "
                      f"event max {r['event_max_ms']!r} ms, sync median "
                      f"{r['sync_ms']!r} ms over {r['blocks']} blocks", flush=True)

    def best(label, kind, key="event_ms"):
        return min(r[key] for r in timing[label][kind])

    kernels = [
        {"name": "B1 uniform block step", "route": "cuda",
         "source": "fft_convolution_tpu_torch/csrc/b1_uniform_step.cu",
         "replaces": "fft_convolution_tpu/ops/pallas_engine.py:171",
         "launches": launches["B1"], "max_abs_err": b1_err,
         "ms": best("B1", "kernel"), "plain_ms": best("B1", "plain")},
        {"name": "B2 fused head+tail0 block step", "route": "cuda",
         "source": "fft_convolution_tpu_torch/csrc/b2_two_stage_step.cu",
         "replaces": "fft_convolution_tpu/ops/pallas_two_stage.py:92",
         "launches": launches["B2"], "max_abs_err": b2_err,
         "ms": best("B2", "kernel"), "plain_ms": best("B2", "plain")},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
