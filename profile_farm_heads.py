"""Device time of the reverb farm's head path (kernel B6) and of the farm
call, for one checkout.

Run from the repository root on a machine with one NVIDIA card::

    python3 profile_farm_heads.py [--root DIR]

Imports ``fft_convolution_tpu_torch`` from ``DIR`` (default: this
checkout), builds its kernels and runs ``chip_smoke.py``'s phase 13 head
path (``chip_smoke.farm_head_path``) at config 5's shape: 128 voices of
random 60 s 48 kHz IRs drawn as phase 10 draws them (seed 5, scale 0.002),
block 128, 8-period calls (T = 2048).  That is B6 against its plain
version (gated as there); the head path alone in turns, B6 and the
parent's form (the plain version over cached meta-spectra), event ms and
device microseconds by CUDA kernel; the farm call in both forms with f32
and bf16 tails; and the peak memory of a call beside
``farm2_bytes_per_voice``.  Prints the card's name and power limit, then
the record as one JSON line.  The bounds come from THIS checkout's
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

import torch

from chip_smoke import card, farm_head_path, farm_irs_on


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent),
                    help="checkout whose fft_convolution_tpu_torch is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_farm_heads: no CUDA device")
    crd = card()  # peaks from this checkout's cost model, before DIR's package
    sys.path.insert(0, args.root)
    import fft_convolution_tpu_torch as port
    from fft_convolution_tpu_torch import _build

    _build.library()
    dev = torch.device("cuda", 0)
    gen, irs = farm_irs_on(dev)
    print(crd.smi, flush=True)
    rec = farm_head_path(dev, irs, gen, crd)
    root = str(pathlib.Path(port.__file__).resolve().parent.parent)
    print(json.dumps({"root": root, "card": crd.smi, "farm_head_path": rec}), flush=True)


if __name__ == "__main__":
    main()
