"""Device time of the reverb farm's big-tail transforms (kernel B7) against
their plain versions (the rows' gather and cuFFT's r2c; c2r, the
overlap-add and the carry on torch), for one checkout.

Run from the repository root on a machine with one NVIDIA card::

    python3 profile_farm_tail.py [--voices 1024] [--periods 8]

Runs ``chip_smoke.py``'s B7 record (``chip_smoke.farm_tail_transforms``) at
the farm's tail block (32768 samples, block 128): ``--periods`` tail rows
of ``--voices`` voices drawn on the card, B7 gated against the plain
versions, then a ``torch.profiler`` window of each launch and each plain
form with device microseconds by CUDA kernel and the share of
``roofline.farm_tail_dft_cost``'s bound.  The defaults are the benchmark's
``farm60.dev8`` call.  Prints the card's name and power limit, then the
record as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from chip_smoke import card, farm_tail_transforms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voices", type=int, default=1024)
    ap.add_argument("--periods", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_farm_tail: no CUDA device")
    from fft_convolution_tpu_torch import _build

    crd = card()
    _build.library()
    print(crd.smi, flush=True)
    rec = farm_tail_transforms(torch.device("cuda", 0), crd, args.voices, args.periods)
    print(json.dumps({"card": crd.smi, "farm_tail_transforms": rec}), flush=True)


if __name__ == "__main__":
    main()
