"""Reverb farm demo: many voices, distinct IRs, one engine — the port's
counterpart of ``examples/reverb_farm.py``.

Runs a :class:`~..api_farm.ReverbFarm` (the production configuration for
long IRs: the big tail on kernel B5 on the card) for two tail periods a
call through the numpy boundary, checks voice 0 against a standalone
:class:`~..api_two_stage.TwoStageFFTConvolver`, and reports the aggregate
real-time factor.

Run: ``python -m fft_convolution_tpu_torch.examples.reverb_farm [--voices 8]
[--ir-seconds 4] [--device cuda]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..api_farm import ReverbFarm
from ..api_two_stage import TwoStageFFTConvolver
from ..runtime.host import HostEngine

SR, BLOCK = 48000, 128
# voice 0 against its standalone engine (the JAX example's check)
TOL, N_CHECK = 1e-5, 4096


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voices", type=int, default=8)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help="torch device of the farm")
    args = ap.parse_args(argv)

    v = args.voices
    ir_len = int(args.ir_seconds * SR)
    rng = np.random.default_rng(0)
    decay = np.exp(-np.arange(ir_len) / (SR * args.ir_seconds / 6))
    irs = (rng.standard_normal((v, ir_len)) * decay * 0.02).astype(np.float32)

    farm = ReverbFarm(irs, BLOCK, ir_len, device=args.device)
    t = 2 * farm.period
    x = (rng.standard_normal((t, v, BLOCK)) * 0.3).astype(np.float32)
    host = HostEngine(farm)
    host.process(x)  # warm the head meta-spectra and transform plans at this T
    host.reset()     # keeps the IR tables and the meta-spectra

    t0 = time.perf_counter()
    ys = host.process(x)
    wall = time.perf_counter() - t0
    audio = t * BLOCK / SR
    print(f"{v} voices x {args.ir_seconds:.1f} s IRs: {audio:.2f} s audio in "
          f"{wall * 1e3:.1f} ms wall, numpy in and out ({v * audio / wall:.0f} real-time "
          f"voices)")

    ref = HostEngine(TwoStageFFTConvolver(irs[0], BLOCK, ir_len, device=args.device))
    y_ref = ref.process(x[:, 0, :].reshape(-1))
    n_check = min(N_CHECK, len(y_ref))
    err = float(np.abs(ys[:, 0, :].reshape(-1)[:n_check] - y_ref[:n_check]).max())
    print(f"voice 0 vs standalone engine: max abs diff {err:.2e}")
    if not err <= TOL:
        raise AssertionError(f"voice 0 differs from its standalone engine by {err} > {TOL}")
    return {"voices": v, "T": t, "calls": 2, "wall_s": wall, "err": err, "y": ys}


if __name__ == "__main__":
    main()
