"""Kind `closed_batch`: `batch` users at a time through
`RuntimeBackend.dispatch_async`, `in_flight` batches on the device: the
oldest is waited on before another is staged.  Reports `search_qps`,
every query completed in the window over the window's seconds, under
each name of the cell's end-to-end metrics that starts with
`search_qps`."""

import collections
import time

import torch

from lshbench import devtrace, traffic
from lshbench.harness import Window


def answer_form(cfg: dict) -> tuple:
    """(results an answer holds, whether the user's own id is kept)."""
    return int(cfg["m"]), False


def drive(run) -> Window:
    order = traffic.BatchOrder(run.mix, run.seed, run.inputs.n)
    m, depth = int(run.cfg["m"]), int(run.mix["in_flight"])
    span, backend = run.span, run.system.backend()
    queries = run.world.QueryRows(run.inputs)
    inflight = collections.deque()
    done = []

    def stage():
        u = order.users[order.next()]
        with span("lshbench/queries"):
            q = queries(u)
        with span("lshbench/dispatch"):
            inflight.append((u, backend.dispatch_async(
                q, u.astype("int32"), m)))

    def reap():
        u, pending = inflight.popleft()
        with span("lshbench/readback"):
            ids, scores, stats = pending.wait()
        done.append((u, ids, scores, stats.dropped))

    for _ in range(depth + 2):             # warm-up at the window's shape
        stage()
        if len(inflight) >= depth:
            reap()
    while inflight:
        reap()
    done.clear()
    run.start()
    with span(devtrace.WINDOW):
        t0 = time.perf_counter()
        end = t0 + run.seconds
        while time.perf_counter() < end:
            stage()
            if len(inflight) >= depth:
                reap()
        while inflight:
            reap()
        t1 = time.perf_counter()
    n = sum(len(d[0]) for d in done)
    dropped = int(torch.stack([d[3] for d in done]).sum()) if done else 0
    qps = n / (t1 - t0)
    return Window(t0, n, 0, [d[:3] for d in done], dropped,
                  {name: qps for name in run.e2e_names
                   if name.startswith("search_qps")},
                  batches=len(done))
