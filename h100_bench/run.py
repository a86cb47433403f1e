"""The benchmark of the PyTorch / CUDA port of SMIN on one NVIDIA H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: set-up (the
port's kernels built if they are not, the seed's weights and traffic made on
the card, every shape of the cell warmed up), a window of ``--seconds``,
then the check of what the window produced against the plain reference.
Prints each compared number beside its limit on standard error, then one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and with ``--trace 1`` a ``breakdown``. Exits non-zero without a result
when there is no card, fewer cards than the cell asks for, or a module of
JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from h100_bench.lib import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {cell.chips} CUDA device(s), {have} visible",
              file=sys.stderr)
        return 2
    t_start = min(harness.process_start(), T_IMPORT)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
