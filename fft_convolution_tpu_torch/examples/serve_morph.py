"""Deployment-shaped serving demo: morph-while-serving through the
real-time dispatcher — the port's counterpart of ``examples/serve_morph.py``.

The production stack in one script:

    audio callback (odd-size host buffers)
      └─ RealTimeDispatcher (native lock-free rings + block assembler)
           └─ CudaCrossfadeConvolver (kernel B3: ONE launch a block over a
              shared input ring, both IR tables and the sample-accurate
              raised-cosine crossfader)

A third of the way in, the callback posts ``update(ir_b)`` to the
dispatcher, never to the engine: the dispatcher thread applies it between
two blocks (``update_applied_at``), and the crossfader holds, ramps and
snaps to B as the reference does (``src/crossfade_convolver.rs:242-278``).

Two callbacks drive it.  :func:`serve` runs in lockstep with the
dispatcher: it waits whenever it is one buffer and one block ahead of the
output it has pulled, and pulls only what is ready.  So it can never
underrun, and its wall time is the dispatcher's throughput, not real-time
behaviour; ``main`` uses it, since its output is whole for the parity
checks.  :func:`serve_paced` is the real-time shape: one buffer in and one
buffer out each buffer period by the wall clock, behind a fixed output
latency, so its underrun count is a measurement.

The checks: before the morph the output is ``ir_a`` convolved with the
input; from ``update_applied_at`` + hold + fade on it is ``ir_b`` convolved
with the WHOLE input.  The shared ring keeps the input history through the
swap, and B's overlap is right from the block after it, which the hold
covers, so that window needs no further IR length of settling.

Run: ``python -m fft_convolution_tpu_torch.examples.serve_morph
[--device cuda] [--blocks 96] [--wav out.wav]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..runtime.dispatcher import RealTimeDispatcher
from ..serving import CudaCrossfadeConvolver
from ..utils.audio import save_wav

SR = 48_000
BLOCK = 128
IR_LEN = 2048
PUSH = 441          # 10 ms at 44.1 kHz: a host buffer that is no multiple of the block
TOL = 1e-4          # against float64 (the JAX example's gate)


def serve(engine, x: np.ndarray, response_b: np.ndarray, morph_at: int,
          push: int = PUSH, drain_timeout: float = 60.0):
    """The lockstep callback: push ``x`` in ``push``-sample buffers through
    a :class:`RealTimeDispatcher` over ``engine``, post
    ``update(response_b)`` once ``morph_at`` samples are in, and pull all
    the output that is ready (no padding, so the output stays contiguous).
    It waits whenever it is one buffer and one block ahead of the output it
    has pulled, and does not follow the wall clock, so no underrun can
    occur and the wall time measures throughput.  Returns ``(y,
    dispatcher)``; ``y`` covers the whole blocks of ``x``."""
    disp = RealTimeDispatcher(engine)
    ahead = push + disp.block_size
    out, pushed, pulled, posted = [], 0, 0, False
    deadline = time.monotonic() + drain_timeout
    with disp:
        while pushed < len(x):
            got = disp.pull(disp.available())
            if len(got):
                out.append(got)
                pulled += len(got)
                deadline = time.monotonic() + drain_timeout
            if pushed - pulled >= ahead:
                if time.monotonic() > deadline:  # raises the thread's error or TimeoutError
                    disp.drain(timeout=0)
                time.sleep(0.0002)
                continue
            pushed += disp.push(x[pushed:pushed + min(push, len(x) - pushed)])
            if not posted and pushed >= morph_at:
                disp.update(response_b)
                posted = True
        disp.drain(timeout=drain_timeout)
        out.append(disp.pull(disp.available()))
    return np.concatenate(out), disp


def serve_paced(engine, x: np.ndarray, response_b: np.ndarray | None = None,
                morph_at: int | None = None, push: int = PUSH, sample_rate: int = SR,
                latency: int | None = None, drain_timeout: float = 60.0):
    """The callback as an audio host calls it: once a buffer period
    (``push / sample_rate`` seconds) by the wall clock it pushes the next
    ``push`` samples of ``x`` and pulls the output due for that buffer,
    never waiting on the dispatcher.  The output lags the input by
    ``latency`` samples (default one buffer and one block, the least that
    leaves the dispatcher a whole buffer period for the blocks it needs);
    the first buffers fill that lag with silence.  Output not ready when
    due is padded with zeros and counted in ``dispatcher.underruns``; input
    the full ring refuses is lost (``len(x) - dispatcher.samples_pushed``).
    ``update(response_b)`` is posted once ``morph_at`` samples are in.
    Returns ``(y, dispatcher)``: ``y`` is the host's output, ``len(x)``
    samples, and with no underrun ``y[latency:]`` is the dispatcher's."""
    disp = RealTimeDispatcher(engine)
    latency = push + disp.block_size if latency is None else latency
    period = push / sample_rate
    out, posted = [], response_b is None
    with disp:
        t0 = time.monotonic()
        for k, start in enumerate(range(0, len(x), push)):
            wait = t0 + k * period - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            buf = x[start:start + push]
            end = start + len(buf)
            disp.push(buf)
            if not posted and end >= morph_at:
                disp.update(response_b)
                posted = True
            silence = min(len(buf), max(0, latency - start))
            out.append(np.zeros(silence, np.float32))
            if len(buf) > silence:
                out.append(disp.pull(len(buf) - silence))
        disp.drain(timeout=drain_timeout)
    return np.concatenate(out), disp


def conv64(x: np.ndarray, ir: np.ndarray) -> np.ndarray:
    """The first ``len(x)`` samples of ``x`` convolved with ``ir``, in
    float64 (numpy FFTs)."""
    nfft = 1 << (len(x) + len(ir) - 2).bit_length()
    spec = np.fft.rfft(x.astype(np.float64), nfft) * np.fft.rfft(ir.astype(np.float64), nfft)
    return np.fft.irfft(spec, nfft)[:len(x)]


def check(y: np.ndarray, x: np.ndarray, ir_a: np.ndarray, ir_b: np.ndarray,
          applied_at: int, block: int, hold: int, fade: int) -> dict:
    """Max abs errors of the pre-morph window ``[0, applied_at * block)``
    against ``ir_a`` and of the post-fade window ``[applied_at * block +
    hold + fade, len(y))`` against ``ir_b``, both float64 convolutions of
    the whole input.  Raises ``ValueError`` if either window is empty."""
    pre, post = applied_at * block, applied_at * block + hold + fade
    if pre == 0 or post >= len(y):
        raise ValueError(f"empty window: the morph landed at block {applied_at} of "
                         f"{len(y) // block}")
    xs = x[:len(y)]
    pre_err = float(np.abs(y[:pre] - conv64(xs, ir_a)[:pre]).max())
    post_err = float(np.abs(y[post:] - conv64(xs, ir_b)[post:]).max())
    return {"pre_err": pre_err, "post_err": post_err, "pre_window": (0, pre),
            "post_window": (post, len(y))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device of the engine")
    ap.add_argument("--blocks", type=int, default=96)
    ap.add_argument("--wav", default=None, help="write the output here")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(5)
    decay = np.exp(-np.arange(IR_LEN) / 300).astype(np.float32)
    ir_a = (rng.standard_normal(IR_LEN).astype(np.float32) * decay) * 0.2
    ir_b = -(rng.standard_normal(IR_LEN).astype(np.float32) * decay) * 0.2
    engine = CudaCrossfadeConvolver(ir_a, BLOCK, IR_LEN, crossfade_samples=4 * BLOCK,
                                    device=args.device)
    total = args.blocks * BLOCK
    x = rng.standard_normal(total).astype(np.float32) * 0.3

    t0 = time.perf_counter()
    y, disp = serve(engine, x, ir_b, morph_at=total // 3)
    wall = time.perf_counter() - t0
    audio_s = total / SR
    print(f"served {disp.blocks_processed} blocks ({audio_s:.2f} s audio) in {wall:.2f} s "
          f"wall — {audio_s / wall:.1f}x realtime in lockstep with the dispatcher, "
          f"morph applied before block {disp.update_applied_at}")
    if len(y) != total or disp.update_applied_at is None:
        raise AssertionError(f"{len(y)} of {total} samples served, morph applied at "
                             f"{disp.update_applied_at}")
    res = check(y, x, ir_a, ir_b, disp.update_applied_at, BLOCK,
                engine.cf_cfg.hold_samples, engine.cf_cfg.fading_samples)
    print(f"pre-morph parity vs float64 convolution with ir_a: {res['pre_err']:.3e}; "
          f"post-fade parity vs float64 convolution with ir_b: {res['post_err']:.3e}")
    if not (res["pre_err"] <= TOL and res["post_err"] <= TOL):
        raise AssertionError(f"parity {res['pre_err']}, {res['post_err']} > {TOL}")
    if args.wav:
        save_wav(args.wav, y, SR)
        print(f"wrote {args.wav}")
    return {**res, "y": y, "blocks": disp.blocks_processed,
            "update_applied_at": disp.update_applied_at, "wall_s": wall}


if __name__ == "__main__":
    main()
