"""End-to-end WAV reverb: load (or synthesize) audio, convolve it with an
IR, write the wet mix — the port's counterpart of ``examples/reverb_wav.py``.

The engine runs behind :class:`~..runtime.host.HostEngine`, so its output
is a numpy array ready to mix, and the time printed includes the copies and
the sync.  Without ``--in``/``--ir`` a synthetic drum loop and an
exponentially decaying noise reverb are generated, so the demo is
self-contained.

Run: ``python -m fft_convolution_tpu_torch.examples.reverb_wav [--in dry.wav]
[--ir ir.wav] [--out wet.wav] [--engine uniform|two_stage] [--block 128]
[--device cuda] [--seconds 4] [--ir-seconds 3]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..api import FFTConvolver
from ..api_two_stage import TwoStageFFTConvolver
from ..runtime.host import HostEngine
from ..utils.audio import load_wav, save_wav


def synth_drums(sr: int, seconds: float) -> np.ndarray:
    n = int(sr * seconds)
    out = np.zeros(n, np.float32)
    rng = np.random.default_rng(7)
    for beat in range(int(seconds * 4)):
        at = int(beat * sr / 4)
        dur = min(2000, n - at)
        env = np.exp(-np.arange(dur) / (sr * 0.01 if beat % 4 else sr * 0.05))
        tone = np.sin(2 * np.pi * (60 if beat % 4 == 0 else 180) * np.arange(dur) / sr)
        noise = rng.standard_normal(dur) * (0.4 if beat % 2 else 0.05)
        out[at:at + dur] += ((tone + noise) * env * 0.5).astype(np.float32)
    return np.clip(out, -1, 1)


def synth_reverb_ir(sr: int, seconds: float) -> np.ndarray:
    n = int(sr * seconds)
    rng = np.random.default_rng(8)
    ir = rng.standard_normal(n).astype(np.float32)
    ir *= np.exp(-np.arange(n) / (sr * seconds / 6)).astype(np.float32)
    ir[0] = 1.0  # direct sound
    return (ir / np.abs(ir).sum() * 8).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="inp", default=None, help="dry 16-bit WAV")
    ap.add_argument("--ir", default=None, help="impulse response, 16-bit WAV")
    ap.add_argument("--out", default="wet.wav")
    ap.add_argument("--engine", default="two_stage", choices=["uniform", "two_stage"])
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="torch device of the engine")
    ap.add_argument("--seconds", type=float, default=4.0, help="synthetic dry length")
    ap.add_argument("--ir-seconds", type=float, default=3.0, help="synthetic IR length")
    args = ap.parse_args(argv)

    sr = 48000
    dry, sr = load_wav(args.inp) if args.inp else (synth_drums(sr, args.seconds), sr)
    ir = load_wav(args.ir)[0] if args.ir else synth_reverb_ir(sr, args.ir_seconds)

    cls = FFTConvolver if args.engine == "uniform" else TwoStageFFTConvolver
    conv = HostEngine(cls(ir, args.block, len(ir), device=args.device))
    conv.process(dry)  # warm the meta-spectra and transform plans
    conv.reset()

    t0 = time.perf_counter()
    wet = conv.process(dry)
    dt = time.perf_counter() - t0
    print(f"{args.engine}: {len(dry) / sr:.2f} s audio with a {len(ir) / sr:.2f} s IR "
          f"in {dt * 1e3:.1f} ms ({len(dry) / sr / dt:.0f}x realtime, numpy in and out)")

    mix = np.clip(0.7 * dry + 0.6 * wet[:len(dry)], -1, 1)
    save_wav(args.out, mix, sr)
    print(f"Saved: {args.out}")
    return {"dry": dry, "ir": ir, "wet": wet, "mix": mix, "sample_rate": sr, "ms": dt * 1e3}


if __name__ == "__main__":
    main()
