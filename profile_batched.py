"""Phase 15 of ``chip_smoke.py`` (the batched streams) for one checkout.

Run from the repository root on a machine with one NVIDIA card::

    python3 profile_batched.py [--root DIR]

Imports ``fft_convolution_tpu_torch`` from ``DIR`` (default: this
checkout) and runs ``chip_smoke.batched_streams`` on it: every gate of the
phase (conv-core routing, 1e-4 against float64 and against the block loop,
no hand-written kernel launched), then one JSON line with the card's name
and power limit and, for each shape, the median CUDA-event ms of a warm
call, the device microseconds and CUDA kernels of one call
(``torch.profiler``), the error against float64, and the call's
``bound_us``, ``bound_by`` and shares of the device and the event time
(``chip_smoke.shares``, gated <= 1), each two-stage form's too.  The
bounds come from THIS checkout's
``fft_convolution_tpu_torch/utils/roofline.py``, loaded by path before
``DIR`` goes on ``sys.path``, so every checkout is divided by one
yardstick.  The B4 yardstick runs on a random 30 s IR (seed 0) in 64-block
calls.  To compare two checkouts, run both on the same card one after the
other, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from chip_smoke import (BLOCK, SR, STREAM_CALL, STREAM_SECONDS, Counts, batched_streams, card,
                        roofline)

KEYS = ("ms", "device_us", "cuda_kernels", "err_f64", "bound_us", "bound_by", "share_device",
        "share_event", "dim_-2_us", "dim_-1_us")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent),
                    help="checkout whose fft_convolution_tpu_torch is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_batched: no CUDA device")
    roofline()  # this checkout's cost model, before DIR's package
    crd = card()
    sys.path.insert(0, args.root)
    import fft_convolution_tpu_torch as port
    from fft_convolution_tpu_torch.ops import (cuda_crossfade, cuda_engine, cuda_farm_mac,
                                               cuda_stream, cuda_two_stage)

    counts = Counts(B1=cuda_engine.block_step, B1p=cuda_engine.block_step_packed,
                    B2=cuda_two_stage.block_step, B3=cuda_crossfade.block_step,
                    B4=cuda_stream.stream, B4p=cuda_stream.stream_packed,
                    B5=cuda_farm_mac.phased_step, B5p=cuda_farm_mac.phased_step_packed)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ir30 = (rng.standard_normal(STREAM_SECONDS * SR) * 0.01).astype(np.float32)
    x30 = torch.from_numpy(rng.standard_normal((40, STREAM_CALL * BLOCK))
                           .astype(np.float32)).to(dev)
    record = batched_streams(dev, counts, ir30, x30, crd)
    out = {"root": str(pathlib.Path(port.__file__).resolve().parent.parent), "card": crd.smi,
           **{name: {**{k: rec[k] for k in KEYS if k in rec},
                     **({"forms": {label: {k: f[k] for k in KEYS if k in f}
                                   for label, f in rec["forms"].items()}}
                        if "forms" in rec else {})}
              for name, rec in record.items()}}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
