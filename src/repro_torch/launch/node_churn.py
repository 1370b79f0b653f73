"""Elastic-membership scenario driver: live node join/leave under content
churn (DESIGN.md Sec. 9).

Drives `repro_torch.core.churn.run_node_churn` (interleaved membership
rounds: zone split/merge and bucket-state handoff, soft-state content
churn, and queries) and prints the per-epoch ledger: node count, recall,
handoff bytes, refresh bytes, router drops.  Optionally runs the
static-topology reference (`run_churn`) on the same RNG trajectory and
reports the recall gap (the acceptance bound is 0.02).

Every node count's nodes live in this one process on one device (the
CUDA card unless `--device cpu`), so no host-device setup is needed.

    PYTHONPATH=src python -m repro_torch.launch.node_churn --smoke --device cpu
"""

from __future__ import annotations

import argparse


def _parse_schedule(text: str) -> tuple[int, ...]:
    try:
        sched = tuple(int(x) for x in text.split(",") if x.strip())
    except ValueError as e:
        raise SystemExit(f"bad --schedule {text!r}: {e}")
    if not sched:
        raise SystemExit("--schedule must name at least one node count")
    return sched


def run(args, obs=None) -> dict:
    import numpy as np

    from repro_torch.core.churn import (
        ChurnConfig, NodeChurnConfig, run_churn, run_node_churn,
    )

    cfg = ChurnConfig(
        num_users=args.users, dim=args.d, k=args.k, L=args.L,
        capacity=args.capacity, epochs=args.epochs,
        update_rate=args.update_rate, churn_rate=args.churn_rate,
        refresh_every=args.refresh_every, ttl_epochs=args.ttl_epochs,
        num_queries=args.queries, m=args.m, seed=args.seed,
    )
    sched = _parse_schedule(args.schedule)
    out = run_node_churn(NodeChurnConfig(churn=cfg, schedule=sched), obs=obs,
                         device=args.device)

    print(f"[node-churn] schedule={','.join(map(str, sched))} "
          f"refresh_every={cfg.refresh_every}")
    print("epoch,n_nodes,recall,handoff_bytes,refresh_bytes,dropped")
    for i in range(len(out["recalls"])):
        print(f"{i + 1},{out['n_nodes'][i]},{out['recalls'][i]:.4f},"
              f"{out['handoff_bytes'][i]},{out['refresh_bytes'][i]},"
              f"{out['dropped_probes'][i]}")
    print(f"[node-churn] mean_recall={out['mean_recall']:.4f} "
          f"rounds={len(out['reshard_events'])} "
          f"total_handoff_bytes={out['total_handoff_bytes']} "
          f"total_refresh_bytes={out['total_refresh_bytes']} "
          f"dropped={int(out['dropped_probes'].sum())}")

    if args.reference:
        ref = run_churn(cfg, device=args.device)
        gap = float(np.abs(out["recalls"] - ref["recalls"]).max())
        print(f"[node-churn] static-reference recall gap (max |diff|) = "
              f"{gap:.4f}")
        out["reference_gap"] = gap
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small preset + sanity assertions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--schedule", default="1,2,4,2,1,2,1",
                    help="comma-separated node count per epoch "
                         "(powers of two; last value holds)")
    ap.add_argument("--users", type=int, default=4000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--update-rate", type=float, default=0.05)
    ap.add_argument("--churn-rate", type=float, default=0.02)
    ap.add_argument("--refresh-every", type=int, default=2)
    ap.add_argument("--ttl-epochs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-reference", dest="reference",
                    action="store_false",
                    help="skip the static-topology comparison run")
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome-trace-event JSON (Perfetto) here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry JSON snapshot here")
    args = ap.parse_args(argv)

    if args.smoke:
        args.users, args.d, args.k, args.L = 1200, 32, 5, 2
        args.epochs, args.queries, args.capacity = 6, 64, 64
        args.schedule = "1,2,4,2,1,2,1"
        args.reference = True  # the smoke gate asserts the recall gap

    obs = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import Observability

        obs = Observability()

    out = run(args, obs=obs)

    if obs is not None:
        # every membership round must have dumped the flight ring
        rounds = len(out["reshard_events"])
        dumped = sum(d["reason"] == "reshard" for d in obs.flight.dumps)
        if dumped != rounds:
            raise SystemExit(f"{dumped} reshard dumps for {rounds} rounds")
        if args.trace_out:
            obs.export_trace(args.trace_out)
            print(f"[node-churn] trace -> {args.trace_out}")
        if args.metrics_out:
            obs.export_metrics(args.metrics_out)
            print(f"[node-churn] metrics -> {args.metrics_out}")

    if args.smoke:
        _smoke_gates(args, out)
        print("[smoke] OK")
    return out


def _smoke_gates(args, out) -> None:
    """The elastic run tracks the static reference on the same RNG
    trajectory (acceptance bound), charges handoff on exactly the
    membership epochs, and drops nothing in the router."""
    import numpy as np

    from repro_torch.core import costmodel

    def gate(ok, what):
        if not ok:
            raise SystemExit(f"[smoke] failed: {what}")

    gate(out["reference_gap"] <= 0.02,
         f"reference gap {out['reference_gap']} > 0.02")
    gate(int(out["dropped_probes"].sum()) == 0, "probes dropped")
    n = out["n_nodes"]
    n0 = _parse_schedule(args.schedule)[0]
    changed = np.concatenate([[n[0] != n0], n[1:] != n[:-1]])
    gate(np.all((out["handoff_bytes"] > 0) == changed),
         f"handoff {out['handoff_bytes']} on node counts {n}")
    for ev in out["reshard_events"]:
        gate(ev.handoff_bytes == costmodel.estimate_handoff_bytes(
            args.L, 1 << args.k, args.capacity, args.d, ev.old_n, ev.new_n),
            f"{ev} off the closed form")


if __name__ == "__main__":
    main()
