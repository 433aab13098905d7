"""The readings a cell's limits are set from: the program's compared
numbers over many seeds (the lower reading) and its control's (the upper
reading), in one process on the card.  The benchmark's own runs never run
the control.

    python -m portbench.control --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103 --seconds 3

The control is one precision below the configuration's float32: the
program's own bfloat16 path where it has one (``ReverbFarm``'s bf16 tail),
else the reference rounded to bfloat16 in the program's place.  Prints one
JSON line: each seed's numbers, the largest of the program's and the
smallest of the control's.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def readings(workload: str, seeds: list[int], control_seeds: list[int], seconds: float,
             device="cuda:0") -> dict:
    import torch

    from . import harness

    with open(harness.BENCHMARK) as f:
        bench = json.load(f)
    wl = harness.workload(bench, workload)
    config = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    limits = harness.limits_for(workload)
    out: dict = {"workload": workload, "program": {}, "control": {}}
    for kind, ss in (("program", seeds), ("control", control_seeds)):
        for s in ss:
            r = harness.run(config, traffic, s, seconds, False, device, [], [], limits,
                            control=kind == "control")
            out[kind][str(s)] = {k: v["value"] for k, v in r["compared"].items()}
            print(f"{workload} {kind} seed {s}: {out[kind][str(s)]}", file=sys.stderr, flush=True)
            del r
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    names = {k for v in list(out["program"].values()) + list(out["control"].values()) for k in v}
    out["lower"] = {k: max(v[k] for v in out["program"].values()) for k in names
                    if out["program"]}
    out["upper"] = {k: min(v[k] for v in out["control"].values()) for k in names
                    if out["control"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    print(json.dumps(readings(args.workload, args.seeds, args.control_seeds, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
