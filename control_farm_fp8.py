"""The readings a bf16-tail farm cell's limit is set from: the program's
compared numbers over many seeds (the lower reading) and those of its
control one precision below bf16 (the upper reading), in one process on
the card.

    python3 control_farm_fp8.py --workload farm60bf16.dev2 --seeds 1 2 ... \\
        --control-seeds 101 102 103 --seconds 3

The control is the same farm with its big tail's bf16 table rounded to
float8 e4m3 (``table.to(torch.float8_e4m3fn).to(torch.bfloat16)``) once it
is built: :func:`fp8_table`.  Both sides run the benchmark's harness as
``python -m portbench.control`` does (:func:`portbench.control.readings`),
under the cell's own limits.  Prints the card's name and power limit, then
one JSON line: each seed's numbers, the largest of the program's and the
smallest of the control's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

FP8 = torch.float8_e4m3fn


def round_table_fp8(table: torch.Tensor) -> None:
    """Round a bf16 tail table ``[N, V, tb+1, 2]`` to float8 e4m3 in place,
    a segment at a time so the transient stays one row's."""
    if table.dtype != torch.bfloat16:
        raise ValueError(f"the fp8 control rounds a bf16 tail table, got {table.dtype}")
    for row in table:
        row.copy_(row.to(FP8).to(torch.bfloat16))


@contextlib.contextmanager
def fp8_table():
    """Every ``ReverbFarm`` built inside has its tail table rounded to
    float8 e4m3 once it is built (:func:`round_table_fp8`)."""
    from fft_convolution_tpu_torch import ReverbFarm

    init = ReverbFarm.__init__

    def rounded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        round_table_fp8(self.state.tail.table)

    ReverbFarm.__init__ = rounded
    try:
        yield
    finally:
        ReverbFarm.__init__ = init


def readings(workload: str, seeds: list[int], control_seeds: list[int], seconds: float,
             device="cuda:0") -> dict:
    """``portbench.control.readings`` with the fp8-rounded table as the
    control."""
    from portbench import control

    out = control.readings(workload, seeds, [], seconds, device)
    with fp8_table():
        ctl = control.readings(workload, [], control_seeds, seconds, device)
    out["control"], out["upper"] = ctl["control"], ctl["upper"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("control_farm_fp8: no CUDA device")
    from portbench import harness

    print(harness.power_limit(), flush=True)
    print(json.dumps(readings(args.workload, args.seeds, args.control_seeds, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
