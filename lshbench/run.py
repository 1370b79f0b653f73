#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the CUDA card of this machine.

    python3 lshbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as one JSON object on the last line of standard
output, and each number that decides `correct` beside its limit on the
last lines of standard error.  Exits non-zero, with no result, where
the machine has fewer CUDA cards than the cell asks for, where the
program (`src/repro_torch`) is absent, or where the process has loaded
JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches a library may keep, at fixed places inside the checkout (the
# program's own kernels build into src/repro_torch/kernels/build)
CACHE = ROOT / ".lshbench-cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from lshbench import harness, spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
