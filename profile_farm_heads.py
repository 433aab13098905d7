"""Device time of the reverb farm's head path (kernel B6) and of the farm
call, for one checkout.

Run from the repository root on a machine with one NVIDIA card::

    python3 profile_farm_heads.py [--root DIR] [--columns-only | --finish-w]

Imports ``fft_convolution_tpu_torch`` from ``DIR`` (default: this
checkout), builds its kernels and runs ``chip_smoke.py``'s phase 13 head
path (``chip_smoke.farm_head_path``) at config 5's shape: 128 voices of
random 60 s 48 kHz IRs drawn as phase 10 draws them (seed 5, scale 0.002),
block 128, 8-period calls (T = 2048).  That is B6 against its plain
version (gated as there); the head path alone in turns, B6 and its plain
version, event ms and device microseconds by CUDA kernel; the farm call
with f32 and bf16 tails; and the peak memory of a call beside
``farm2_bytes_per_voice``.  First, and alone with ``--columns-only``: the
column launch ``b6_columns``' device microseconds a call at the benchmark
cells' head shapes (block 128, n = 256: 1024 voices at T = 512 and 2048,
2048 voices at T = 512) and at n = 64 and 1024 (column transforms of 256
and 4096 points) on a random head state, beside its byte floor:
each (voice, bin) column reads 2n table rows, 2n - 1 history rows and T
spectra and writes 2n - 1 history rows and T conv rows, 8 bytes each.
Alone with ``--finish-w``: B6 at ``farm60.morph8``'s head shape (1024
voices, n = 256, T = 2048) with no voice flagged, with 64 (the cell's
updates a call) and with every voice: ``b6_finish``'s device microseconds
a call without and with the suppress pass's remainder ``w`` to read, and
the pass's own kernels beside them.  Prints the card's name and power
limit, then the record as one JSON line.  The bounds come from THIS
checkout's ``fft_convolution_tpu_torch/utils/roofline.py``, loaded by path
before ``DIR`` goes on ``sys.path``, so every checkout is divided by one
yardstick.  To compare two checkouts on one card, run both in one machine
session, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from chip_smoke import Card, card, farm_head_path, farm_irs_on, profile_steps

# (voices, n, T): the cells' (block 128, n = 256), then the column transform's
# other two sizes, M = 256 and 4096
COLUMN_SHAPES = ((1024, 256, 512), (1024, 256, 2048), (2048, 256, 512), (1024, 64, 512),
                 (128, 1024, 1024))
COLUMN_B = 128
COLUMN_CALLS, COLUMN_WARMUP = 6, 2
# (voices, n, T) of farm60.morph8's head path, and the voices flagged a call
FINISH_SHAPE, FINISH_FLAGGED = (1024, 256, 2048), (0, 64, 1024)


def column_floor_bytes(v: int, n: int, b: int, t: int) -> int:
    """The column launch's compulsory bytes: 8 (6n - 2 + 2T) a column."""
    return v * (b + 1) * 8 * (6 * n - 2 + 2 * t)


def head_inputs(gen, dev, v: int, n: int, t: int) -> tuple:
    """A random head state of ``v`` voices and ``n`` segments at block
    :data:`COLUMN_B` (head and tail0 stages, ``hist``) and two calls' blocks
    ``[2, t, v, B]``."""
    from fft_convolution_tpu_torch.models import uniform

    b = COLUMN_B

    def spectra(rows, scale=1.0):
        x = torch.randn((v, rows, b), generator=gen, device=dev) * scale
        return torch.fft.rfft(x, n=2 * b)

    def stage():
        return uniform.UniformState(
            segments=spectra(n), segments_ir=spectra(n, 0.01),
            overlap=torch.zeros((v, b), device=dev),
            input_buffer=torch.zeros((v, b), device=dev),
            pre_multiplied=torch.zeros((v, b + 1), dtype=torch.complex64, device=dev),
            current=n // 3, input_fill=0, active_segs=n)

    return stage(), stage(), spectra(n - 1), torch.randn((2, t, v, b), generator=gen, device=dev)


def column_launch(dev, crd: Card) -> list[dict]:
    """``b6_columns``' device microseconds a call at each of
    :data:`COLUMN_SHAPES`, by ``torch.profiler`` over warm ``heads_step``
    calls on a random head state, beside the byte floor."""
    from fft_convolution_tpu_torch.ops import cuda_farm_heads

    gen = torch.Generator(device=dev).manual_seed(22)
    b = COLUMN_B
    out = []
    for v, n, t in COLUMN_SHAPES:
        st_h, st_t0, hist, xs = head_inputs(gen, dev, v, n, t)
        suppress = torch.zeros(v, dtype=torch.bool)
        prof = profile_steps(lambda i: cuda_farm_heads.heads_step(
            st_h, st_t0, xs[i % 2], hist, suppress), COLUMN_CALLS, COLUMN_WARMUP)
        cols = sum(us for name, us in prof["by_name"].items() if "b6_columns" in name)
        floor = column_floor_bytes(v, n, b, t) / crd.peaks.hbm_bytes_per_s * 1e6
        rec = {"voices": v, "n": n, "T": t, "b6_columns_us": cols, "floor_us": floor,
               "share_of_floor": floor / cols, "b6_us": prof["device_us"],
               "by_name": prof["by_name"]}
        print(f"b6_columns at V={v}, T={t}, n={n}, B={b}: {cols!r} device us a call, "
              f"byte floor {floor!r} us ({floor / cols:.1%} of it); B6 {prof['device_us']!r} "
              f"us ({crd.smi})", flush=True)
        out.append(rec)
        del st_h, st_t0, hist, xs
        torch.cuda.empty_cache()
    return out


def finish_w(dev, crd: Card) -> list[dict]:
    """``b6_finish``'s device microseconds a call at :data:`FINISH_SHAPE`
    with each count of :data:`FINISH_FLAGGED` voices flagged (evenly
    spaced, every call: ``heads_step`` leaves the flags as they are), and
    the suppress pass's kernels (every kernel but B6's three)."""
    from fft_convolution_tpu_torch.ops import cuda_farm_heads

    gen = torch.Generator(device=dev).manual_seed(24)
    v, n, t = FINISH_SHAPE
    st_h, st_t0, hist, xs = head_inputs(gen, dev, v, n, t)
    out = []
    for f in FINISH_FLAGGED:
        suppress = torch.zeros(v, dtype=torch.bool)
        if f:
            suppress[::v // f] = True
        prof = profile_steps(lambda i: cuda_farm_heads.heads_step(
            st_h, st_t0, xs[i % 2], hist, suppress), COLUMN_CALLS, COLUMN_WARMUP)
        by_name = prof["by_name"]
        finish = sum(us for name, us in by_name.items() if "b6_finish" in name)
        b6 = sum(us for name, us in by_name.items() if "b6_" in name)
        rec = {"voices": v, "n": n, "T": t, "flagged": int(suppress.sum()),
               "b6_finish_us": finish, "b6_us": b6, "suppress_pass_us": prof["device_us"] - b6,
               "by_name": by_name}
        print(f"B6 at V={v}, T={t}, n={n}, {rec['flagged']} voices flagged: b6_finish "
              f"{finish!r} device us a call, B6 {b6!r}, the suppress pass's kernels "
              f"{rec['suppress_pass_us']!r} ({crd.smi})", flush=True)
        out.append(rec)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent),
                    help="checkout whose fft_convolution_tpu_torch is profiled")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--columns-only", action="store_true",
                      help="time the column launch at the cells' shapes and stop")
    mode.add_argument("--finish-w", action="store_true",
                      help="time b6_finish and the suppress pass at farm60.morph8's shape "
                           "with 0, 64 and every voice flagged, and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_farm_heads: no CUDA device")
    crd = card()  # peaks from this checkout's cost model, before DIR's package
    sys.path.insert(0, args.root)
    import fft_convolution_tpu_torch as port
    from fft_convolution_tpu_torch import _build

    _build.library()
    dev = torch.device("cuda", 0)
    print(crd.smi, flush=True)
    root = str(pathlib.Path(port.__file__).resolve().parent.parent)
    rec = {"root": root, "card": crd.smi}
    if args.finish_w:
        rec["finish_w"] = finish_w(dev, crd)
    else:
        rec["column_launch"] = column_launch(dev, crd)
    if not (args.columns_only or args.finish_w):
        gen, irs = farm_irs_on(dev)
        rec["farm_head_path"] = farm_head_path(dev, irs, gen, crd)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
