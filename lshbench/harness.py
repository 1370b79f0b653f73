"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from lshbench import check, devtrace, spec, traffic

# top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE = 4096          # answers judged in a run, drawn from the seed
# a traced run's window: reading the trace takes ~10 s a traced second
TRACE_SECONDS = 4.0


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What a driver's measured window did."""

    t0: float                   # perf_counter at the first timed query
    attempted: int
    failed: int
    answers: list               # [(users [b], ids [b, m], scores [b, m])]
    dropped: int                # router drops reported by the steps
    e2e: dict                   # end-to-end values measured by the driver
    batches: int = 0            # batches dispatched in the window
    with_self: bool = False     # the answers keep the user's own id


@dataclasses.dataclass
class Run:
    """What a driver (`drivers/<kind>.py`) is handed."""

    system: object              # the program built on the world
    world: object               # worlds/<world>.py
    inputs: object              # the world's inputs
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    span: object                # span(name): a traced run's host span
    start: object               # start(): called as the window opens
    e2e_names: set              # the cell's end-to-end metrics


def setup(cfg: dict, seed: int, device):
    """(world module, inputs, the program built on them) of a
    configuration, made from the seed."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    w = spec.world(cfg["world"])
    inp = w.make_inputs(cfg, seed, dev)
    return w, inp, w.build_system(cfg, inp, dev)


def sample_answers(answers: list, seed: int, n: int):
    """(users, ids, scores) of `n` answers drawn from the seed among all
    the window's answers."""
    sizes = np.array([len(a[0]) for a in answers], dtype=np.int64)
    total = int(sizes.sum())
    pick = np.sort(traffic.rng(seed, 4).choice(total, size=min(n, total),
                                               replace=False))
    starts = np.cumsum(sizes) - sizes
    b = np.searchsorted(starts, pick, side="right") - 1
    row = pick - starts[b]
    users = np.array([answers[i][0][j] for i, j in zip(b, row)])
    ids = np.stack([answers[i][1][j] for i, j in zip(b, row)])
    scores = np.stack([answers[i][2][j] for i, j in zip(b, row)])
    return (torch.from_numpy(users.astype(np.int64)),
            torch.from_numpy(ids.astype(np.int64)),
            torch.from_numpy(scores.astype(np.float32)))


@dataclasses.dataclass
class LayerContext:
    """What a per-layer metric's reader may read (`metrics/<name>.py`)."""

    cfg: dict
    trace: devtrace.TraceSummary | None
    csrc: set                   # the program's hand-written kernels
    window: Window


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device, t_start: float,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """Run `cell` once; returns the result line's object."""
    cfg = cell.config
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    world, inp, system = setup(cfg, seed, dev)
    span = devtrace.spans(trace)
    prof = None

    def start():
        nonlocal prof
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        gc.freeze()
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()

    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    win = spec.driver(cell.traffic["kind"])(Run(
        system, world, inp, cfg, cell.traffic, seed, seconds, span, start,
        {m["name"] for m in cell.end_to_end}))
    if on_card:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    setup_s = win.t0 - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise ImportError(f"the run loaded {found}")
    # the program's state goes before the reference runs
    system = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = world.reference(cfg, inp)
    evicted = int((~ref.kept).any(1).sum())
    log(f"[world] {inp.n} users; bucket loads: mean "
        f"{float(ref.load.double().mean()):.1f}, max {int(ref.load.max())}; "
        f"{evicted} users evicted from some table at C = {ref.C}")
    numbers = {"dropped_probes": win.dropped, "failed": win.failed}
    judged = 0
    if win.answers:
        u, i, s = sample_answers(win.answers, seed, SAMPLE)
        numbers.update(check.judge(ref, u, i, s, i.shape[1],
                                   with_self=win.with_self))
        judged = len(u)
    ok, checks = check.verdict(numbers, cfg["limits"])
    log(f"[check] {judged} answers judged against the reference in "
        f"{time.perf_counter() - t_ref:.1f} s")

    out = {"correct": bool(ok), "attempted": int(win.attempted),
           "failed": int(win.failed)}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if not trace:
        values = dict(win.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        from repro_torch.kernels import _build

        summary = devtrace.TraceSummary(prof) if on_card else None
        ctx = LayerContext(cfg, summary, devtrace.csrc_kernels(_build.CSRC),
                           win)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if summary is not None:
            device_info.update(busy_s=summary.busy_s,
                               window_s=summary.window_s)
            out["breakdown"] = {"device_ops": summary.device_ops(),
                                "idle_gaps": summary.idle_gaps()}
    out["metrics"] = metrics
    out["device"] = device_info
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return out
