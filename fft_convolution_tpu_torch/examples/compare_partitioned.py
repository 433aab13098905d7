"""Parity and timing of uniform against two-stage convolution — the port's
counterpart of ``examples/compare_partitioned.py`` and of the reference
example (``examples/compare_partitioned.rs:9-68``): a 128,000-tap 1 kHz
sinusoid IR (~2.9 s at 44.1 kHz), block 64, 1000 blocks; prints each
engine's wall time (numpy in, numpy out, the sync included) and the
max_abs_diff parity figure, and writes both outputs as WAVs.

Run: ``python -m fft_convolution_tpu_torch.examples.compare_partitioned
[--device cuda] [--blocks 1000] [--outdir .]``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..api import FFTConvolver
from ..api_two_stage import TwoStageFFTConvolver
from ..runtime.host import HostEngine
from ..utils.audio import generate_sinusoid, save_wav

SAMPLE_RATE = 44100
BLOCK_SIZE = 64
RESPONSE_LEN = 128_000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device of the engines")
    ap.add_argument("--blocks", type=int, default=1000, help="input length in blocks")
    ap.add_argument("--outdir", default=".", help="where to write the WAVs")
    args = ap.parse_args(argv)

    response = generate_sinusoid(RESPONSE_LEN, 1000.0, SAMPLE_RATE, 0.1)
    x = generate_sinusoid(args.blocks * BLOCK_SIZE, 1300.0, SAMPLE_RATE, 0.1)
    engines = {
        "Uniform": FFTConvolver(response, BLOCK_SIZE, len(response), device=args.device),
        "Partitioned": TwoStageFFTConvolver(response, BLOCK_SIZE, len(response),
                                            device=args.device),
    }
    outputs, took_ms = {}, {}
    for name, engine in engines.items():
        host = HostEngine(engine)
        # warm the kernel meta-spectra and transform plans at the timed shape,
        # so the timing is the steady-state loop the reference times
        host.process(x)
        host.reset()
        t0 = time.perf_counter()
        outputs[name] = host.process(x)
        took_ms[name] = (time.perf_counter() - t0) * 1e3
        print(f"{name} took = {took_ms[name]:.2f} ms")

    output_a, output_b = outputs["Uniform"], outputs["Partitioned"]
    max_abs_diff = float(np.abs(output_a - output_b).max())
    print(f"max_abs_diff = {max_abs_diff}")
    paths = []
    for name, y in (("output_a.wav", output_a), ("output_b.wav", output_b)):
        path = os.path.join(args.outdir, name)
        save_wav(path, y, SAMPLE_RATE)
        print(f"Saved: {path}")
        paths.append(path)
    return {"output_a": output_a, "output_b": output_b, "max_abs_diff": max_abs_diff,
            "took_ms": took_ms, "wavs": paths}


if __name__ == "__main__":
    main()
