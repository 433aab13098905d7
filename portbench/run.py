"""Run one cell of ``BENCHMARK.json`` on this machine's card and print its
result as the last line of standard output.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, when there is no CUDA card or fewer
than the cell asks for, when the program cannot be loaded, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``fft_convolution_tpu`` is loaded in
this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the set-up's clock starts before any import

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    with open(harness.BENCHMARK) as f:
        bench = json.load(f)
    wl = harness.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    e2e, layers = harness.cell_metrics(bench, args.workload)
    result = harness.run(config, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         e2e, layers, harness.limits_for(args.workload), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
