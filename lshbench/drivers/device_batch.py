"""Kind `device_batch`: `batch` users at a time through the mesh's
search step (`IndexRuntime.search_step_fn`) on query rows already on
the card, `in_flight` batches on the device: each batch's results are
copied into pinned host memory behind an event, and the oldest is
waited on before another is launched.  The step returns its `cfg.m`
results a row with the user's own id left in, and they are judged so.
Reports `search_qps`, every query completed in the window over the
window's seconds, under each name of the cell's end-to-end metrics that
starts with `search_qps`."""

import collections
import time

import torch

from lshbench import devtrace, traffic
from lshbench.harness import Window


def answer_form(cfg: dict) -> tuple:
    """(results an answer holds, whether the user's own id is kept):
    a mesh step bakes one result of headroom over `m`."""
    return int(cfg["m"]) + 1, True


def drive(run) -> Window:
    if int(run.cfg["nodes"]) < 2:
        raise ValueError("device_batch drives a mesh's search step")
    order = traffic.BatchOrder(run.mix, run.seed, run.inputs.n)
    depth = int(run.mix["in_flight"])
    span, step = run.span, run.system.step()
    rows = run.world.DeviceRows(run.inputs)
    users = torch.from_numpy(order.users).to(run.inputs.ids.device)
    inflight = collections.deque()
    done = []

    def stage():
        sl = order.next()
        with span("lshbench/dispatch"):
            ids, scores, stats = step(rows(users[sl]))
            out = [torch.empty(t.shape, dtype=t.dtype, device="cpu",
                               pin_memory=t.is_cuda)
                   for t in (ids, scores, stats.dropped)]
            for o, t in zip(out, (ids, scores, stats.dropped)):
                o.copy_(t, non_blocking=True)
            event = None
            if ids.is_cuda:
                event = torch.cuda.Event()
                event.record()
        inflight.append((order.users[sl], out, event))

    def reap():
        u, (ids, scores, dropped), event = inflight.popleft()
        with span("lshbench/readback"):
            if event is not None:
                event.synchronize()
        done.append((u, ids.numpy(), scores.numpy(), int(dropped.sum())))

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
    qps = n / (t1 - t0)
    return Window(t0, n, 0, [d[:3] for d in done], sum(d[3] for d in done),
                  {name: qps for name in run.e2e_names
                   if name.startswith("search_qps")},
                  batches=len(done), with_self=True)
