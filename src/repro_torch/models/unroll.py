"""The layer loop and activation rematerialization.

The port of `repro.models.unroll`.  The reference switches between
`jax.lax.scan` (production) and a Python unroll (the dry-run's cost
analysis, since XLA counts a while-loop body once).  In the port the
layers are always a Python loop, so `scan` is that loop whatever
`set_unroll` says; the flag and its scope stay, under the reference's
names, for the callers that set them.

`maybe_checkpoint(f)` is `torch.utils.checkpoint.checkpoint` around `f`
(non-reentrant) while the module's remat flag is on (`remat_scope`):
the forward keeps only `f`'s inputs, and the backward runs `f` again.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import sharding

_UNROLL = False


def set_unroll(value: bool) -> None:
    global _UNROLL
    _UNROLL = bool(value)


def unrolling() -> bool:
    return _UNROLL


@contextlib.contextmanager
def unroll_scope(value: bool = True):
    global _UNROLL
    prev = _UNROLL
    _UNROLL = value
    try:
        yield
    finally:
        _UNROLL = prev


def _index(xs, i):
    if xs is None:
        return None
    if isinstance(xs, dict):
        return {k: _index(v, i) for k, v in xs.items()}
    if isinstance(xs, (tuple, list)):
        return type(xs)(_index(v, i) for v in xs)
    return xs[i]


def _first_leaf(xs):
    if isinstance(xs, dict):
        return _first_leaf(next(iter(xs.values())))
    if isinstance(xs, (tuple, list)):
        return _first_leaf(xs[0])
    return xs


def _stack(ys):
    y0 = ys[0]
    if y0 is None:
        return None
    if isinstance(y0, dict):
        return {k: _stack([y[k] for y in ys]) for k in y0}
    if isinstance(y0, (tuple, list)):
        return type(y0)(_stack([y[j] for y in ys]) for j in range(len(y0)))
    return torch.stack(ys, dim=0)


def scan(f, init, xs, length: int | None = None):
    """`jax.lax.scan`'s contract (the subset the reference uses) as a
    Python loop: xs a tensor or a dict / tuple of them, sliced on the
    leading axis, or None with `length`; the per-step outputs stacked."""
    n = length if xs is None else _first_leaf(xs).shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, _index(xs, i))
        ys.append(y)
    if not ys or all(y is None for y in ys):
        return carry, None
    return carry, _stack(ys)


_REMAT = True


@contextlib.contextmanager
def remat_scope(value: bool):
    """Toggle activation rematerialization around the layer and loss
    bodies: off, autograd keeps every activation (no recompute pass)."""
    global _REMAT
    prev = _REMAT
    _REMAT = value
    try:
        yield
    finally:
        _REMAT = prev


def maybe_checkpoint(f):
    """`f`, or `f` under `torch.utils.checkpoint` while remat is on; the
    forward saves only `f`'s inputs."""
    if not _REMAT:
        return f

    @functools.wraps(f)
    def wrapped(*args, **kwargs):
        # the recompute may run on autograd's device thread: it runs
        # under the sharding context of this call (thread-local), so a
        # data-parallel body's all-reduces recompute the same values
        ctx = sharding.context()

        def body(*a, **kw):
            with sharding.restored(ctx):
                return f(*a, **kw)

        return checkpoint(body, *args, use_reentrant=False, **kwargs)

    return wrapped
