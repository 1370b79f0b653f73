"""Reading the device trace of a `--trace 1` run.

The window runs under `torch.profiler` with the harness's own
`record_function` spans around its calls into the program
(`lshbench/dispatch`, `lshbench/readback`), around its own making of a
batch's query rows (`lshbench/queries`) and one around the whole window
(`lshbench/window`).  From the trace: the device's busy time (the union
of its kernels, copies and sets inside the window), device time by
operation, and each idle stretch of the device charged to the harness
span the host was in.
"""

from __future__ import annotations

import contextlib
import re

import torch

WINDOW = "lshbench/window"
KERNEL_DEF = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*[(<]")


def csrc_kernels(csrc_dir) -> set:
    """Names of the hand-written kernels defined in `csrc_dir`/*.cu."""
    names = set()
    for path in sorted(csrc_dir.glob("*.cu")):
        names.update(KERNEL_DEF.findall(path.read_text()))
    return names


def kernel_id(name: str) -> str:
    """The bare function name of a device operation's trace name:
    'void ns::foo<3>(int)' -> 'foo'."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    name = re.split(r"[(<]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


def spans(enabled: bool):
    """`spans(on)(name)`: a `record_function` span, or nothing when the
    run is not traced (untraced runs carry no instrumentation)."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """Device operations and host spans of one traced window; times in
    seconds on the profiler's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        window = None
        device, host = [], []
        for e in prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            note = getattr(e, "is_user_annotation", False)
            if e.device_type == DeviceType.CUDA:
                if not note and not e.name.startswith("lshbench/"):
                    device.append((s, t, e.name))
            elif e.name == WINDOW:
                window = (s, t)
            elif e.name.startswith("lshbench/"):
                host.append((s, t, e.name))
        if window is None:
            raise RuntimeError("the trace holds no lshbench/window span")
        w0, w1 = window
        self.window = window
        self.window_s = w1 - w0
        self.device = [(max(s, w0), min(t, w1), n) for s, t, n in device
                       if t > w0 and s < w1]
        self.host = host
        busy = _merge([(s, t) for s, t, _ in self.device])
        self.busy_s = sum(t - s for s, t in busy)
        edges = [w0] + [v for iv in busy for v in iv] + [w1]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def device_seconds(self, keep=lambda name: True) -> float:
        return sum(t - s for s, t, n in self.device if keep(n))

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for s, t, n in self.device:
            key = n[:120]
            by[key] = by.get(key, 0.0) + (t - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds by the harness span the host was in
        ('lshbench/harness' for time outside every span)."""
        host = sorted(self.host)
        by = {}
        for g0, g1 in self.gaps:
            left = g1 - g0
            for s, t, n in host:
                if t <= g0:
                    continue
                if s >= g1:
                    break
                ov = min(t, g1) - max(s, g0)
                if ov > 0:
                    by[n] = by.get(n, 0.0) + ov
                    left -= ov
            if left > 0:
                by["lshbench/harness"] = by.get("lshbench/harness", 0.0) + left
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def idle_share(ctx):
    """The share of the traced window, in %, in which no operation ran
    on the device (a per-layer reader's `read`)."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def glue_ms(ctx):
    """Device milliseconds a batch of every operation that is not one of
    the program's hand-written kernels (`kernels/csrc`): library sorts,
    gathers, copies and elementwise work, over the traced window (a
    per-layer reader's `read`)."""
    if ctx.trace is None or not ctx.window.batches:
        return None
    glue = ctx.trace.device_seconds(lambda name: kernel_id(name)
                                    not in ctx.csrc)
    return 1e3 * glue / ctx.window.batches
