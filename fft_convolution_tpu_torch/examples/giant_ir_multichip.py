"""Giant-IR multi-device demo: one voice, an IR spanning the ranks — the
port's counterpart of ``examples/giant_ir_multichip.py``.

Spawns ranks (:func:`..parallel.mesh.run_ranks`) on an ``"sp"`` mesh and
serves a long IR through :class:`~..parallel.two_stage_sp.
ShardedTwoStageConvolver`: head and tail0 replicated on every rank for the
latency path, the main tail's frequency-delay line sharded over ``"sp"``
with one all-reduce of ``complex64 [tail_block + 1]`` a tail period.
Checks the output against the single-device ``TwoStageFFTConvolver``
(1e-5) and prints each rank's memory.

Run: ``python -m fft_convolution_tpu_torch.examples.giant_ir_multichip
[--ranks 2] [--ir-seconds 2] [--device cuda|cpu]`` (the card by default,
every rank on ``cuda:0``; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..api_two_stage import TwoStageFFTConvolver
from ..models.two_stage import compute_tail_block_size
from ..parallel.mesh import make_mesh, run_ranks
from ..parallel.two_stage_sp import ShardedTwoStageConvolver

SR, BLOCK = 48000, 128
TOL = 1e-5  # against the single-device engine (the JAX example's check)
TAIL_PERIODS = 4


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rank(rank: int, world: int, ir: np.ndarray, x: np.ndarray, device: str) -> dict:
    sh = ShardedTwoStageConvolver(ir, BLOCK, len(ir), mesh=make_mesh((world,), ("sp",), device))
    y = sh.process(x).cpu().numpy()
    st = sh.state
    small = [t for s in (st.head, st.tail0)
             for t in (s.segments, s.segments_ir, s.overlap, s.input_buffer, s.pre_multiplied)]
    return {"y": y, "tail_ring": _nbytes(st.tail.segments),
            "tail_table": _nbytes(st.tail.segments_ir), "head_tail0": _nbytes(*small),
            "tail_segments": sh.cfg.tail.seg_count, "period": sh.cfg.period}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--ir-seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    ir_len = int(args.ir_seconds * SR)
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(ir_len) * 0.01).astype(np.float32)
    tb = compute_tail_block_size(BLOCK, ir_len)
    x = (rng.standard_normal(TAIL_PERIODS * tb) * 0.5).astype(np.float32)

    res = run_ranks(_rank, args.ranks, ir, x, args.device, device=args.device)
    r0 = res[0]
    print(f"mesh: {args.ranks} ranks over 'sp'; tail_block={tb}, period={r0['period']}, "
          f"{r0['tail_segments']} tail segments")
    for rank, r in enumerate(res):
        print(f"rank {rank}: tail ring slab {r['tail_ring'] / 1e6:.2f} MB, tail IR table "
              f"(replicated) {r['tail_table'] / 1e6:.2f} MB, head+tail0 (replicated) "
              f"{r['head_tail0'] / 1e6:.2f} MB")
    print(f"collective: one all-reduce of {(tb + 1) * 8 / 1024:.0f} KB a tail period "
          f"({tb} samples, {tb / SR * 1e3:.1f} ms of audio)")

    y_ref = TwoStageFFTConvolver(ir, BLOCK, ir_len, device=args.device).process(x).cpu().numpy()
    err = max(float(np.abs(r["y"] - y_ref).max()) for r in res)
    print(f"max_abs_diff vs single-device engine: {err:.2e}")
    if not err <= TOL:
        raise AssertionError(f"sharded output differs from the single-device engine by "
                             f"{err} > {TOL}")
    return {"err": err, "ranks": res}


if __name__ == "__main__":
    main()
