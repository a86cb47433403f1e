"""Readings for the limits of a cell's correctness check, on the chip.

    python3 h100_bench/tools/calibrate.py --workload <cell> --seconds 3 \
        --seeds <n> ... [--control-seeds <n> ...] > readings.jsonl

Runs the cell once a seed in one process (set-up, a short window at the
cell's own load, the check), and prints one JSON line a seed: the program's
readings of every number the check compares (the lower readings of each
limit come from the largest of these over a dozen seeds or more). On the
control seeds it also runs the driver's ``control``: the reference in the
nearest precision below the configuration's (TF32 for fp32 with TF32 off)
put in the program's place, and for training the half-batch fault planted
in the reference, each held to the reference (their smallest readings are
the upper ones). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    from h100_bench.lib import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}

        def hook(ctx, driver, state, record, readings):
            line["program"] = readings
            if seed in args.control_seeds:
                t = time.perf_counter()
                line["control"] = driver.control(ctx, state, record)
                line["control_s"] = time.perf_counter() - t

        t0 = time.perf_counter()
        result = harness.run(ROOT, args.workload, seed, args.seconds, False, "cuda:0",
                             time.time(), after_check=hook)
        line.update(correct=result["correct"], attempted=result["attempted"],
                    failed=result["failed"], run_s=time.perf_counter() - t0,
                    metrics={k: v["value"] for k, v in result["metrics"].items()})
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
