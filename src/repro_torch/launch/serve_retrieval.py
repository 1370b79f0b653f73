"""Online retrieval serving driver: load generation over the
`repro_torch.serve` frontend (DESIGN.md Sec. 7 + 13).

Two load modes.  The default CLOSED loop drives a zipf-skewed query
stream through the dynamic batcher tick by tick — submitting `--offered`
arrivals per tick and serving one coalesced batch per tick, so backlog
(and admission rejects) build up whenever offered load exceeds service
capacity.  `--open-loop` instead draws a Poisson arrival schedule at a
FIXED offered rate (`--rate`, qps; 0 = auto from measured capacity),
measures latency from each arrival's SCHEDULED time (coordinated
omission counts against the server), and serves the same schedule twice
on one warm runtime — synchronous (depth 1) then pipelined
(`--pipeline` staged device batches) — reporting p50/p99 against the
`--slo-p99-ms` target for each and verifying the served ids are
BIT-IDENTICAL across the two paths.

Live churn can be interleaved (`--churn-every`): every T ticks a slice
of the corpus drifts and re-announces, bumping the store generation and
invalidating the sketch-keyed result cache.

Reports p50/p99 latency, queries/sec, cache hit rate, messages/query
(Table-1 cost model — hits cost zero network), rejects, ring-full
pushback, and router `dropped_probes`.

With `--trace-out PATH` the run records every pipeline stage span and
per-query flight record and writes a Chrome-trace-event JSON loadable in
Perfetto (ui.perfetto.dev); `--metrics-out PATH` writes the metrics
registry snapshot; `--recall-probe-every N` shadow-rescores every Nth
served miss against the exact top-m (DESIGN.md Sec. 12).

Runs on the CUDA card unless `--device cpu`; on the card the engine
sketches through the simhash kernel and scores through bucket_topk.

Under torchrun every rank builds the same world; rank 0 prints and
writes files.  The closed loop runs in lockstep (every rank forms the
same batches).  The open loop runs under a controller
(`repro_torch.serve.control`): rank 0 runs the schedule and announces
each batch, the other ranks serve what they receive, and the capacity,
the offered rate and the sync == pipelined verdict are rank 0's.

    PYTHONPATH=src python -m repro_torch.launch.serve_retrieval --smoke \
        --device cpu --trace-out serve_trace.json
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve_retrieval --smoke --open-loop \
        --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    DenseCorpus, EngineConfig, LshEngine, LshParams, make_hyperplanes,
)
from repro_torch.core.hashing import sketch_codes_batched
from repro_torch.core.store import build_store_host, expire, insert_batch
from repro_torch.launch.mesh import is_rank0, say, torchrun_group
from repro_torch.obs import Observability, ObsConfig
from repro_torch.serve import (
    FrontendConfig, RetrievalFrontend, RuntimeBackend, poisson_arrivals,
    run_open_loop,
)
from repro_torch.serve.control import Controller


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def build_frontend(args, rng, obs=None):
    """Corpus + store + engine + frontend; returns (frontend, emb, h,
    store): `emb` the host corpus the workload draws its queries from."""
    dev = resolve_device(args.device)
    emb = _unit(rng.standard_normal((args.n, args.d))).astype(np.float32)
    params = LshParams(d=args.d, k=args.k, L=args.L, seed=args.seed + 1)
    h = make_hyperplanes(params, device=dev)
    vecs = torch.tensor(emb, device=dev)
    codes = sketch_codes_batched(vecs, h)
    store = build_store_host(codes, params.num_buckets,
                             capacity=args.capacity, device=dev)
    engine = LshEngine(
        params, h, store, DenseCorpus(vecs), None,
        EngineConfig(variant=args.variant, use_kernels=dev.type == "cuda"),
        device=dev,
    )
    frontend = RetrievalFrontend(
        RuntimeBackend(engine),
        FrontendConfig(
            m=args.m, max_batch=args.max_batch,
            queue_capacity=args.queue_capacity, cache=not args.no_cache,
            pipeline_depth=args.pipeline,
        ),
        obs=obs,
    )
    return frontend, emb, h, store


def make_workload(args, rng):
    """Zipf-skewed arrival stream over a finite query pool (repeats are
    what a result cache exists for — the paper's OSN users re-query)."""
    pool = rng.integers(0, args.n, size=args.pool)
    w = 1.0 / (np.arange(args.pool) + 1.0)  # zipf(1) over pool ranks
    picks = rng.choice(args.pool, size=args.queries, p=w / w.sum())
    return pool[picks]  # corpus row per arrival


def churn_tick(args, rng, emb, h, store, frontend, now: int):
    """One write epoch: drift a corpus slice, re-announce all, GC.

    `now` is the write-epoch counter: re-announces are stamped with it
    and expiry collects entries whose last stamp is more than `ttl`
    epochs old — the copies a drifted vector left in its OLD buckets are
    genuinely garbage-collected after ttl write epochs.  `emb` is
    updated in place on the host and crosses to torch as a copy, so the
    installed corpus never shares the buffer the next tick writes."""
    n_upd = max(1, int(args.churn_frac * args.n))
    upd = rng.choice(args.n, n_upd, replace=False)
    emb[upd] = _unit(
        emb[upd] + 0.5 * rng.standard_normal((n_upd, args.d))
    ).astype(np.float32)
    vecs = torch.tensor(emb, device=h.device)
    codes = sketch_codes_batched(vecs, h)
    store = insert_batch(
        store, torch.arange(args.n, dtype=torch.int32, device=h.device),
        codes, now,
    )
    store = expire(store, now, ttl=args.ttl_epochs)
    frontend.backend.update(store, DenseCorpus(vecs))
    return store


def _warm(backend, args, cache: bool) -> None:
    """Dispatch every pow-2 batch shape of the grid (1..max_batch) once,
    with fresh vectors (all misses), through a frontend of its own — so
    nothing leaks into the measured run's cache or telemetry."""
    warm = RetrievalFrontend(
        backend,
        FrontendConfig(m=args.m, max_batch=args.max_batch,
                       queue_capacity=args.queue_capacity, cache=cache),
    )
    wrng = np.random.default_rng(args.seed + 99)
    b = 1
    while b <= args.max_batch:
        warm.search(_unit(wrng.standard_normal((b, args.d))).astype(
            np.float32))
        b *= 2


def run(args, obs=None) -> dict:
    rng = np.random.default_rng(args.seed)
    frontend, emb, h, store = build_frontend(args, rng, obs=obs)
    arrivals = make_workload(args, rng)

    # warm up so reported latencies measure serving, not first-call costs
    if args.warmup:
        _warm(frontend.backend, args, cache=not args.no_cache)

    sent = 0
    tick = 0
    write_epoch = 0
    if args.warmup and args.churn_every:  # the write-epoch path too
        write_epoch += 1
        store = churn_tick(args, rng, emb, h, store, frontend, write_epoch)
    while sent < len(arrivals) or frontend.pending:
        burst = arrivals[sent:sent + args.offered]
        sent += len(burst)
        for row in burst:
            frontend.submit(emb[row], exclude=int(row))
        frontend.step()
        tick += 1
        if args.churn_every and tick % args.churn_every == 0:
            write_epoch += 1
            store = churn_tick(args, rng, emb, h, store, frontend,
                               write_epoch)
    frontend.flush()

    say(frontend.stats.format_summary())
    cost = frontend.backend.cost()
    say(f"[serve] closed-form messages/query (no cache) = {cost.messages:.1f}"
        f"  store generation = {frontend.backend.generation}")
    if obs is not None:
        frontend.stats.publish(obs.registry)
        probe = obs.registry.value("serve_recall_probe", window="mean")
        if probe is not None:
            say(f"[serve] shadow recall probe (1-in-"
                f"{obs.config.recall_probe_every} misses) = {probe:.3f}")
    return frontend.stats.summary()


def run_openloop(args, obs=None) -> dict:
    """Open-loop mode: one Poisson/uniform arrival schedule at a fixed
    offered rate, served TWICE on the same warm runtime — synchronous
    (depth 1), then pipelined (`--pipeline`) — latency measured from the
    SCHEDULE (DESIGN.md Sec. 13).  Returns per-mode results plus the
    bit-identity verdict the smoke gate checks, and `control`.

    Arrivals are paced by the wall clock, so in a world of several
    processes rank 0 leads (`control`, a `serve.control.Controller`;
    None in one process): the warm-up, the capacity probe and both
    timed modes run on rank 0, which announces every dispatch, and the
    other ranks serve what they receive; their `sync` / `pipelined` are
    None, and the capacity, rate and verdict are rank 0's."""
    rng = np.random.default_rng(args.seed)
    frontend, emb, h, store = build_frontend(args, rng, obs=obs)
    backend = frontend.backend
    control = Controller.of_world()
    if control is not None and not control.leads:
        control.follow(backend)
        capacity, rate, identical = control.share()
        return dict(sync=None, pipelined=None, identical=bool(identical),
                    rate=rate, capacity=capacity, control=control)
    with (contextlib.nullcontext() if control is None
          else control.leading(backend)):
        out = _openloop_modes(args, backend, emb)
    if control is not None:
        control.share([out["capacity"], out["rate"],
                       float(out["identical"])])
    return dict(out, control=control)


def _openloop_modes(args, backend, emb) -> dict:
    """`run_openloop`'s runs on this process's backend: warm-up, the
    capacity probe, then the schedule at sync and pipelined depth."""

    def fresh(depth):
        return RetrievalFrontend(
            backend,
            FrontendConfig(m=args.m, max_batch=args.max_batch,
                           queue_capacity=args.queue_capacity,
                           cache=not args.no_cache, pipeline_depth=depth),
        )

    # warm every dispatch shape the run can hit, then measure capacity
    if args.warmup:
        _warm(backend, args, cache=not args.no_cache)
    wq = emb[np.random.default_rng(args.seed + 7).integers(
        0, args.n, size=args.max_batch)]
    # cache OFF for the capacity probe: repeats must redispatch, or the
    # "service time" would be a cache lookup
    meter = RetrievalFrontend(
        backend, FrontendConfig(m=args.m, max_batch=args.max_batch,
                                queue_capacity=args.queue_capacity,
                                cache=False))
    meter.search(wq)  # one untimed pass
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        meter.search(wq)
    svc = (time.perf_counter() - t0) / reps
    capacity = args.max_batch / svc
    rate = args.rate if args.rate > 0 else 0.5 * capacity
    print(f"[openloop] batch service {svc * 1e3:.2f} ms "
          f"-> capacity ~{capacity:.0f} qps; offered rate {rate:.0f} qps")

    rows = np.random.default_rng(args.seed + 1).integers(
        0, args.n, size=args.queries)
    arr = poisson_arrivals(rate, args.queries, seed=args.seed,
                           deterministic=args.smoke)
    out = {}
    for name, depth in (("sync", 1), ("pipelined", max(args.pipeline, 2))):
        res = run_open_loop(fresh(depth), emb[rows], arr,
                            exclude=rows)
        out[name] = res
        verdict = "PASS" if res.slo_ok(args.slo_p99_ms) else "FAIL"
        print(f"[openloop] {name:9s} (depth {depth}): "
              f"p50 {res.p50_ms:7.2f} ms  p99 {res.p99_ms:7.2f} ms  "
              f"shed {res.shed}  served {res.served_qps:.0f} qps  "
              f"SLO p99<={args.slo_p99_ms:.0f}ms {verdict}")
    s, p = out["sync"], out["pipelined"]
    identical = (
        s.completed == p.completed == args.queries
        and set(s.ids) == set(p.ids)
        and all(np.array_equal(s.ids[i], p.ids[i]) for i in s.ids)
    )
    print(f"[openloop] sync == pipelined served ids: "
          f"{'bit-identical' if identical else 'MISMATCH'}")
    return dict(sync=s, pipelined=p, identical=identical, rate=rate,
                capacity=capacity)


def _gate(ok: bool, what) -> None:
    if not ok:
        raise SystemExit(f"[smoke] failed: {what}")


def build_parser() -> argparse.ArgumentParser:
    """The CLI's arguments (the reference's, plus `--device`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small preset + sanity assertions (CI)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--variant", default="cnb")
    ap.add_argument("--pool", type=int, default=512,
                    help="distinct queries in the workload")
    ap.add_argument("--queries", type=int, default=4000,
                    help="total arrivals")
    ap.add_argument("--offered", type=int, default=32,
                    help="arrivals submitted per tick (offered load)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--queue-capacity", type=int, default=256)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--churn-every", type=int, default=0,
                    help="write epoch every T ticks (0 = static index)")
    ap.add_argument("--churn-frac", type=float, default=0.02)
    ap.add_argument("--ttl-epochs", type=int, default=4,
                    help="GC horizon in write epochs (paper Sec. 4.1)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="staged device batches (1 = synchronous; "
                         "DESIGN.md Sec. 13)")
    ap.add_argument("--open-loop", action="store_true",
                    help="open-loop mode: fixed offered rate, latency "
                         "from scheduled arrival, sync vs pipelined")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop offered rate in qps (0 = half of "
                         "measured closed-loop capacity)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="open-loop p99 SLO target in milliseconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome-trace-event JSON (Perfetto) here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry JSON snapshot here")
    ap.add_argument("--recall-probe-every", type=int, default=0,
                    help="shadow-rescore every Nth served miss against "
                         "the exact top-m (0 = off; needs obs enabled)")
    return ap


def smoke_preset(args) -> None:
    """`--smoke`'s small world and its defaults, set on `args`."""
    args.n, args.d, args.k = 2000, 32, 6
    args.pool, args.queries = 96, 400
    args.offered, args.max_batch, args.queue_capacity = 16, 32, 128
    if args.churn_every == 0:
        args.churn_every = 8
    if (args.trace_out or args.metrics_out) \
            and args.recall_probe_every == 0:
        args.recall_probe_every = 8


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        smoke_preset(args)

    obs = None
    if args.trace_out or args.metrics_out or args.recall_probe_every:
        obs = Observability(ObsConfig(
            recall_probe_every=max(args.recall_probe_every, 0)))

    with torchrun_group(args.device):
        return _main(args, obs)


def _main(args, obs):
    if args.open_loop:
        ol = run_openloop(args, obs=obs)
        if args.smoke:
            # the open-loop cell's gate: both modes served EVERY arrival
            # (a smoke rate never sheds), the latency population is sane,
            # the SLO verdict is well-defined at both depths, and — the
            # pipeline's non-negotiable invariant — the two paths served
            # bit-identical ids on the same schedule (rank 0's runs; the
            # verdict reaches every rank)
            for name in ("sync", "pipelined") if is_rank0() else ():
                r = ol[name]
                _gate(r.completed == args.queries and r.shed == 0, name)
                _gate(np.isfinite(r.p99_ms) and r.p99_ms >= r.p50_ms > 0,
                      f"{name}: p50 {r.p50_ms} p99 {r.p99_ms}")
                _gate(r.slo_ok(args.slo_p99_ms) == (
                    r.shed == 0 and r.p99_ms <= args.slo_p99_ms), name)
                _gate(r.summary["completed"] == r.completed, name)
            _gate(ol["identical"], "pipelined ids diverged from sync")
            say("[smoke] OK")
        return ol

    s = run(args, obs=obs)

    if obs is not None and is_rank0():
        if args.trace_out:
            obs.export_trace(args.trace_out)
            say(f"[serve] trace -> {args.trace_out} "
                f"(load in ui.perfetto.dev)")
        if args.metrics_out:
            obs.export_metrics(args.metrics_out)
            say(f"[serve] metrics -> {args.metrics_out}")

    if args.smoke:
        smoke_gates(args, s, obs if is_rank0() else None)
        say("[smoke] OK")
    return s


def smoke_gates(args, s: dict, obs=None) -> None:
    """The closed loop's gate: everything admitted was served, rejects /
    ring-full / drops were counted (not negative or silent), and the
    repeated-query workload hit the cache, reducing messages/query; with
    obs, every pipeline stage was traced, the flight ring accounts for
    every completed query, and the Chrome trace is schema-valid JSON."""
    _gate(s["completed"] + s["rejected"] + s["ring_full"] == args.queries, s)
    _gate(s["dropped_probes"] == 0, s)
    _gate(np.isfinite(s["p99_us"]) and s["p99_us"] > 0, s)
    if not args.no_cache:
        _gate(s["hit_rate"] > 0.2, s)
        full = 0.5 * args.k * args.L  # Table-1 kL/2
        _gate(s["messages_per_query"] < full, s)
    if obs is None:
        return
    import json

    evs = obs.chrome_trace()["traceEvents"]
    names = {e["name"] for e in evs}
    for stage in ("serve/intake", "serve/enqueue", "serve/stage",
                  "serve/compute", "serve/reap", "serve/respond"):
        _gate(stage in names, f"missing span {stage}")
    for e in evs:
        _gate({"name", "cat", "ph", "ts", "pid", "tid"} <= set(e), e)
    _gate(len(obs.flight.records(kind="query")) == s["completed"],
          "flight query records != completed")
    _gate(obs.flight.total("dropped_probes", kind="dispatch")
          == s["dropped_probes"], "flight drops != summary drops")
    if args.trace_out:
        with open(args.trace_out) as f:
            _gate(bool(json.load(f)["traceEvents"]), "empty trace file")


if __name__ == "__main__":
    main()
