"""Device time per step of the port's per-block and stream kernels, for one
checkout.

Run from the repository root on a machine with one NVIDIA card::

    python3 profile_steps.py [--root DIR]

Imports ``fft_convolution_tpu_torch`` from ``DIR`` (default: this
checkout), builds its kernels, makes the flagship serving wrappers of
``chip_smoke.py`` (block 128, a random 10 s 48 kHz IR, seed 0) and its
long-IR streaming wrappers (a random 30 s IR, f32 and bf16 tables, calls
of 64 blocks) and prints one JSON line: the card's name and power limit,
and for B1, B1p, B2 and B3 the device microseconds and CUDA kernels per
step from a ``torch.profiler`` window over 256 warm steps
(``chip_smoke.profile_steps``), for B4 and B4p the same per call over 24
warm calls, the device microseconds by CUDA kernel name (one kernel a step
for each of B1-B3; three a call for B4 in this checkout, four in an older
one), and the median CUDA-event span of one ``process`` call
and the host's time to enqueue it (``chip_smoke.latency``; B4: 32 timed
calls after 4), and each path's ``bound_us``, ``bound_by`` and ``share``
of the device time (``chip_smoke.shares``, gated <= 1, which also prints
them).  The bounds come from THIS checkout's
``fft_convolution_tpu_torch/utils/roofline.py``, loaded by path before
``DIR`` goes on ``sys.path``, so every checkout is divided by one
yardstick.  To compare two checkouts on one card, run both in one machine
session, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from chip_smoke import (BLOCK, IR_SECONDS, PROFILE_CALL_WARMUP, PROFILE_CALLS,
                        PROFILE_STEPS, PROFILE_WARMUP, SR, STREAM_CALL, STREAM_SECONDS,
                        STREAM_TIMED, STREAM_WARMUP, T_BLOCKS, card, latency, profile_steps,
                        roofline, shares)


def _latency(r: dict) -> dict:
    return {"event_ms": r["event_ms"], "enqueue_ms": r["enqueue_ms"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent),
                    help="checkout whose fft_convolution_tpu_torch is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_steps: no CUDA device")
    rl, crd = roofline(), card()  # this checkout's cost model, before DIR's package
    sys.path.insert(0, args.root)
    import fft_convolution_tpu_torch as port
    from fft_convolution_tpu_torch import _build
    from fft_convolution_tpu_torch.ops import cuda_crossfade, cuda_engine, cuda_two_stage
    from fft_convolution_tpu_torch.serving import (CudaCrossfadeConvolver, CudaFFTConvolver,
                                                   CudaStreamingConvolver,
                                                   CudaTwoStageConvolver)

    _build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(IR_SECONDS * SR) * 0.01).astype(np.float32)
    xs = torch.from_numpy(rng.standard_normal((T_BLOCKS, BLOCK)).astype(np.float32)).to(dev)
    uni = CudaFFTConvolver(ir, BLOCK, len(ir), device=dev)
    uni_bf = CudaFFTConvolver(ir, BLOCK, len(ir), device=dev, storage="bf16_packed")
    two = CudaTwoStageConvolver(ir, BLOCK, len(ir), device=dev)
    xf = CudaCrossfadeConvolver(ir, BLOCK, len(ir), crossfade_samples=4 * BLOCK, device=dev)
    p, bf16 = two.cfg.period, rl.BF16_PAIR
    steps = {
        "B1": (uni, lambda i: cuda_engine.block_step(uni.consts, uni.state, xs[i]),
               rl.stream_conv_cost(uni.cfg, 1)),
        "B1p": (uni_bf, lambda i: cuda_engine.block_step_packed(uni_bf.consts, uni_bf.state,
                                                                xs[i]),
                rl.stream_conv_cost(uni_bf.cfg, 1, ring_item=bf16, table_item=bf16)),
        "B2": (two, lambda i: cuda_two_stage.block_step(two.consts, two.fstate, two.buffers,
                                                        i % p, xs[i]),
               rl.two_stage_step_cost(two.cfg)),
        "B3": (xf, lambda i: cuda_crossfade.block_step(xf.consts, xf.state, xf.cf_cfg,
                                                       xf.cf_state, xs[i]),
               rl.crossfade_stream_cost(xf.cfg, 1)),
    }
    out = {"root": str(pathlib.Path(port.__file__).resolve().parent.parent), "card": crd.smi}

    def bounded(label, cost, prof):
        bd = shares(f"{label} ({out['root']})", cost, crd, device=prof["device_us"] / 1e6)
        return {"bound_us": bd["bound_us"], "bound_by": bd["bound_by"],
                "share": bd["share_device"]}

    for label, (conv, step, cost) in steps.items():
        prof = profile_steps(step, PROFILE_STEPS, PROFILE_WARMUP)
        out[label] = {"device_us": prof["device_us"],
                      "cuda_launches_per_step": prof["cuda_launches_per_step"],
                      "device_us_by_kernel": prof["by_name"], **bounded(label, cost, prof),
                      **_latency(latency(conv, xs))}
    ir30 = (rng.standard_normal(STREAM_SECONDS * SR) * 0.01).astype(np.float32)
    calls = STREAM_WARMUP + STREAM_TIMED
    x_st = torch.from_numpy(rng.standard_normal((calls, STREAM_CALL * BLOCK))
                            .astype(np.float32)).to(dev)
    for label, storage in (("B4", "float32"), ("B4p", "bf16_packed")):
        conv = CudaStreamingConvolver(ir30, BLOCK, len(ir30), device=dev, storage=storage)
        prof = profile_steps(lambda i, c=conv: c._step(c.consts, c.state,
                                                       x_st[i % calls].reshape(-1, BLOCK)),
                             PROFILE_CALLS, PROFILE_CALL_WARMUP)
        cost = rl.stream_conv_cost(conv.cfg, STREAM_CALL,
                                   table_item=bf16 if storage == "bf16_packed" else rl.C64)
        out[label] = {"device_us": prof["device_us"],
                      "cuda_launches_per_step": prof["cuda_launches_per_step"],
                      "device_us_by_kernel": prof["by_name"], **bounded(label, cost, prof),
                      **_latency(latency(conv, x_st, warmup=STREAM_WARMUP,
                                         timed_n=STREAM_TIMED))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
