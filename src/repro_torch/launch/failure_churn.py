"""Failure-injection scenario driver: fail-stop node kills under content
churn, served through R-way replicas (DESIGN.md Sec. 10).

Drives `repro_torch.core.churn.run_failure_churn` (nodes vanish with no
handoff at scheduled epochs, queries read through zone-adjacent replicas,
first-responder or quorum, and the next re-announce revives the node and
repopulates its zone) and prints the per-epoch ledger: live nodes,
recall, recall gap against the no-failure reference on the same RNG
trajectory, replication and recovery bytes, router drops.

All nodes live in this one process on one device (the CUDA card unless
`--device cpu`), or, under torchrun, in blocks over its processes (gloo
ranks with `--device cpu`, NCCL over one card a rank otherwise); every
rank runs the scenario and rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.failure_churn --smoke --device cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.failure_churn --smoke --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.launch.mesh import say


def _parse_kills(text: str) -> tuple[tuple[int, int], ...]:
    """'epoch:node[,epoch:node...]' -> ((epoch, node), ...)."""
    kills = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            epoch, node = part.split(":")
            kills.append((int(epoch), int(node)))
        except ValueError as e:
            raise SystemExit(f"bad --kills entry {part!r} "
                             f"(want epoch:node): {e}")
    if not kills:
        raise SystemExit("--kills must name at least one epoch:node")
    return tuple(kills)


def run(args, obs=None) -> dict:
    from repro_torch.core.churn import (
        ChurnConfig, FailureChurnConfig, run_failure_churn,
    )

    cfg = ChurnConfig(
        num_users=args.users, dim=args.d, k=args.k, L=args.L,
        capacity=args.capacity, epochs=args.epochs,
        update_rate=args.update_rate, churn_rate=args.churn_rate,
        refresh_every=args.refresh_every, ttl_epochs=args.ttl_epochs,
        num_queries=args.queries, m=args.m, seed=args.seed,
    )
    kills = _parse_kills(args.kills)
    out = run_failure_churn(FailureChurnConfig(
        churn=cfg, n_nodes=args.n_nodes, replication=args.replication,
        read_mode=args.read_mode, kills=kills,
    ), obs=obs, device=args.device)

    say(f"[failure-churn] n_nodes={args.n_nodes} R={args.replication} "
          f"read_mode={args.read_mode} "
          f"kills={','.join(f'{e}:{v}' for e, v in kills)} "
          f"refresh_every={cfg.refresh_every}")
    say("epoch,live,recall,ref_recall,gap,replication_bytes,"
          "recovery_bytes,dropped")
    for i in range(len(out["recalls"])):
        say(f"{i + 1},{out['live_nodes'][i]},{out['recalls'][i]:.4f},"
              f"{out['reference_recalls'][i]:.4f},"
              f"{out['recall_gap'][i]:+.4f},"
              f"{out['replication_bytes'][i]},{out['recovery_bytes'][i]},"
              f"{out['dropped_probes'][i]}")
    say(f"[failure-churn] degraded_gap={out['degraded_gap']:.4f} "
          f"recovered_gap={out['recovered_gap']:.4f} "
          f"recovery_epochs={out['recovery_epochs']} "
          f"total_replication_bytes={out['total_replication_bytes']} "
          f"total_recovery_bytes={out['total_recovery_bytes']} "
          f"dropped={int(out['dropped_probes'].sum())}")
    return out


def main(argv=None):
    from repro_torch.launch.mesh import is_rank0, torchrun_group

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small preset + sanity assertions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-nodes", type=int, default=4)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--read-mode", choices=("first", "quorum"),
                    default="first")
    ap.add_argument("--kills", default="3:1",
                    help="comma-separated epoch:node fail-stop events")
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
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome-trace-event JSON (Perfetto) here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry JSON snapshot here")
    args = ap.parse_args(argv)

    if args.smoke:
        args.users, args.d, args.k, args.L = 1200, 32, 5, 2
        args.epochs, args.queries, args.capacity = 6, 64, 64
        args.n_nodes, args.replication, args.kills = 4, 2, "3:1"

    obs = None
    if args.trace_out or args.metrics_out or args.smoke:
        from repro_torch.obs import Observability

        obs = Observability()

    with torchrun_group(args.device):
        out = run(args, obs=obs)
        if obs is not None and is_rank0():
            if args.trace_out:
                obs.export_trace(args.trace_out)
                say(f"[failure-churn] trace -> {args.trace_out}")
            if args.metrics_out:
                obs.export_metrics(args.metrics_out)
                say(f"[failure-churn] metrics -> {args.metrics_out}")

        if args.smoke:
            smoke_gates(out, obs.flight, args.L, args.users, args.d,
                        args.replication, (1 << args.k) // args.n_nodes,
                        args.capacity, args.refresh_every, args.epochs,
                        len(_parse_kills(args.kills)))
            say("[smoke] OK")
    return out


def smoke_gates(out, flight, L, users, d, replication, buckets_per_node,
                capacity, refresh_every, epochs, n_kills) -> None:
    """The acceptance gates of a failure run: killing a node with no
    handoff keeps recall within 0.05 of the no-failure run, recovers to
    parity within the re-announce period, charges every replication and
    recovery byte by its closed form, and the flight recorder's epoch
    records account exactly for the aggregate arrays.  Raises
    SystemExit naming the first gate that fails."""
    import numpy as np

    from repro_torch.core import costmodel

    def gate(ok, what):
        if not ok:
            raise SystemExit(f"[smoke] failed: {what}")

    gate(out["degraded"].any(), "the kill did not degrade liveness")
    gate(not out["degraded"][-1], "still degraded in the last epoch")
    gate(out["degraded_gap"] <= 0.05,
         f"degraded gap {out['degraded_gap']} > 0.05")
    gate(out["recovered_gap"] <= 0.02,
         f"recovered gap {out['recovered_gap']} > 0.02")
    gate(out["recovery_epochs"] <= refresh_every,
         f"recovery took {out['recovery_epochs']} epochs")
    gate(int(out["dropped_probes"].sum()) == 0, "probes dropped")
    # before the kill the replica layer is invisible: equal recalls
    pre = np.arange(out["recalls"].size) < int(np.argmax(out["degraded"]))
    gate(pre.any() and np.array_equal(out["recalls"][pre],
                                      out["reference_recalls"][pre]),
         "pre-kill recalls differ from the reference run's")
    per_announce = costmodel.estimate_replication_bytes(L, users, d,
                                                        replication)
    announced = out["replication_bytes"] > 0
    gate(per_announce > 0 and announced.any() and np.all(
        out["replication_bytes"][announced] == per_announce),
        "replication bytes off the closed form")
    per_zone = costmodel.estimate_recovery_bytes(L, buckets_per_node,
                                                 capacity, d)
    recovered = out["recovery_bytes"] > 0
    gate(recovered.any() and np.all(
        out["recovery_bytes"][recovered] == per_zone),
        "recovery bytes off the closed form")
    gate(out["total_recovery_bytes"] == sum(
        b for _e, _n, b in out["recoveries"]), "recovery total")
    # every kill dumped the flight ring, and the ring's epoch records sum
    # exactly to the aggregate arrays
    kill_dumps = [x for x in flight.dumps if x["reason"] == "kill_node"]
    gate(len(kill_dumps) == n_kills, f"{len(kill_dumps)} kill dumps")
    for field, total in (
            ("dropped_probes", int(out["dropped_probes"].sum())),
            ("replication_bytes", out["total_replication_bytes"]),
            ("recovery_bytes", out["total_recovery_bytes"]),
            ("refresh_bytes", out["total_refresh_bytes"])):
        gate(flight.total(field) == total,
             f"flight {field} {flight.total(field)} != {total}")
    eps = flight.records(kind="epoch")
    gate(len(eps) == epochs + 1, f"{len(eps)} epoch records")
    gate([r.extra["recovery_bytes"] for r in eps[1:]]
         == out["recovery_bytes"].tolist(), "per-epoch recovery records")


if __name__ == "__main__":
    main()
