#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, for one cell.

    python3 lshbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 [--out FILE]

For each of `--seeds`, one run of the cell as `run.py` makes it (a
window of `--seconds`), and its numbers.  For each of `--control-seeds`,
the control's numbers at the cell's size: the reference put in the
program's place, in the precision below the configuration's (bfloat16
operands for a float32 cell, whose scores are sums of products, not a
matrix product), or, where the configuration states no precision,
with one of its guarantees broken (the probes that the CNB cache serves
left out).  One process, so that each seed pays only its world's
set-up.  Prints one JSON line a reading, and writes them to `--out`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device, sample: int) -> dict:
    """The control's numbers for `sample` query users of the cell's
    traffic, drawn from `seed`."""
    import numpy as np
    import torch

    from lshbench import check, spec, traffic

    cfg = cell.config
    world = spec.world(cfg["world"])
    inp = world.make_inputs(cfg, seed, torch.device(device))
    ref = world.reference(cfg, inp)
    users = torch.from_numpy(traffic.rng(seed, 1).choice(
        inp.n, size=sample, replace=False).astype(np.int64)).to(device)
    if cfg["score"] == "dot":
        kind, kw = "bfloat16", dict(precision="bfloat16")
    else:
        kind, kw = "cache_probes_dropped", dict(node_probes=False)
    m, with_self = spec.load_module(
        "drivers", cell.traffic["kind"]).answer_form(cfg)
    ids, scores, _ = ref.top(users, m, with_self=with_self, **kw)
    out = check.judge(ref, users, ids, scores.float(), m,
                      with_self=with_self)
    return dict(out, control=kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from lshbench import harness, spec

    cell = spec.find_cell(args.workload)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for s in [int(v) for v in args.seeds.split(",") if v]:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, s, args.seconds, False,
                               device=args.device, t_start=t0)
        emit(dict(kind="program", seed=s, correct=res["correct"],
                  checks={k: v["value"] for k, v in res["checks"].items()},
                  metrics={k: v["value"] for k, v in res["metrics"].items()},
                  wall_s=time.perf_counter() - t0))
    for s in [int(v) for v in args.control_seeds.split(",") if v]:
        t0 = time.perf_counter()
        emit(dict(kind="control", seed=s, **control_numbers(
            cell, s, args.device, harness.SAMPLE),
            wall_s=time.perf_counter() - t0))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
