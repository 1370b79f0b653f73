#!/usr/bin/env python3
"""The highest rate an open-loop mix sustains under its serving limit,
found once by a sweep (a cell of that mix fixes its rate from it).

    python3 lshbench/sweep.py --config <config> --mix <mix> \\
        --rates 4000,8000,... [--seed 0] [--out FILE]

The mix (`traffic/<mix>.json`, kind `open_poisson`) gives the frontend
(`frontend`: `FrontendConfig` fields), the limit (`p99_limit_ms`,
nothing shed) and the sweep's `trials` schedules of `seconds` a rate.
The world and the program are built as a run builds them
(`harness.setup`).  For each rate: the copied `max_qps_at_slo` over
fresh `RetrievalFrontend`s, then one traced schedule of 2 s for the
device's busy share and the rows a batch.  Prints one JSON line a rate
and the highest passing rate.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class UserRows:
    """The dense query row of each of `users`, made when it is asked
    for (a window's rows would not fit in host memory at once)."""

    def __init__(self, rows, users):
        self.rows, self.users = rows, users

    def __len__(self):
        return len(self.users)

    def __getitem__(self, i):
        if isinstance(i, (int,)) or getattr(i, "ndim", 1) == 0:
            return self.rows(self.users[i:i + 1])[0].copy()
        return UserRows(self.rows, self.users[i])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from lshbench import devtrace, harness, loadgen, spec, traffic
    from repro_torch.serve import FrontendConfig, RetrievalFrontend
    from repro_torch.serve.frontend import dispatch_pad

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA card", file=sys.stderr)
        return 2
    cfg, mix = spec.load_config(args.config), spec.load_traffic(args.mix)
    world, inp, system = harness.setup(cfg, args.seed, "cuda")
    backend, rows = system.backend(), world.QueryRows(inp)
    m = int(cfg["m"])
    fcfg = FrontendConfig(m=m, **mix["frontend"])
    seconds, trials = float(mix["sweep"]["seconds"]), int(mix["sweep"]["trials"])
    limit = float(mix["p99_limit_ms"])
    # every dispatch shape the frontend can form, once
    for pad in sorted({dispatch_pad(b, backend.min_batch)
                       for b in range(1, fcfg.max_batch + 1)}):
        u = traffic.users(mix, args.seed + pad, inp.n, pad)
        backend.dispatch(rows(u), u.astype(np.int32), m)
    torch.cuda.synchronize()

    def make_frontend():
        return RetrievalFrontend(backend, fcfg)

    def traced(rate):
        n = int(rate * 2.0)
        arr = loadgen.poisson_arrivals(rate, n, seed=args.seed + 7)
        pick = traffic.users(mix, args.seed + 7, inp.n, n)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        fe = make_frontend()
        torch.cuda.synchronize()
        prof.start()
        with torch.profiler.record_function(devtrace.WINDOW):
            res = loadgen.run_open_loop(fe, UserRows(rows, pick), arr,
                                        exclude=pick,
                                        spans=devtrace.spans(True))
        torch.cuda.synchronize()
        prof.stop()
        tr = devtrace.TraceSummary(prof)
        s = res.summary
        return dict(busy_share=tr.busy_s / tr.window_s,
                    rows_a_batch=s["dispatched"] / max(s["batches"], 1),
                    traced_p99_ms=res.p99_ms, idle_gaps=tr.idle_gaps(5))

    users = np.arange(inp.n)
    out = []
    for rate in [float(v) for v in args.rates.split(",")]:
        t0 = time.perf_counter()
        trial = []

        def seen(rate_, fe, res):
            trial.append(dict(p99_ms=res.p99_ms, p50_ms=res.percentile_ms(50),
                              shed=res.shed, completed=res.completed))

        best, knee = loadgen.max_qps_at_slo(
            make_frontend, UserRows(rows, users), [rate], p99_slo_ms=limit,
            n_arrivals=lambda q: q * seconds, seed=args.seed, trials=trials,
            exclude=users, on_result=seen)
        row = dict(rate=rate, p99_ms=knee[0][1], shed=knee[0][2],
                   passes=best > 0, trials=trial, **traced(rate),
                   wall_s=time.perf_counter() - t0)
        out.append(row)
        print(json.dumps(row), flush=True)
    passing = [row["rate"] for row in out if row["passes"]]
    print(json.dumps({"highest_passing_rate": max(passing, default=None),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
