"""Rank 0 as the controller of serving on a world of several processes
(ROADMAP item 6c).

Every rank of a process world runs the serving stack over its own
backend, and each event that issues a collective must come in one order
on every rank: a dispatch (the search step's exchanges) and an install
(the store's occupancy, read over the ranks at install time).  A closed
loop gives that order by itself: every rank forms the same batches from
the same schedule, and `RuntimeBackend` checks it on each dispatch.  A
wall clock (open-loop arrivals) or a writer thread (an update ready at
one stage boundary on one rank and at the next on another) does not.

There rank 0 leads (`Controller.leading`): before each such event it
sends a header (the event's kind; for a dispatch its rows, width and m,
followed by the padded queries and excludes; for an install the index
of the writer's last job to install), then performs the event.  Every
other rank runs `follow`: it receives each event and performs it on its
own backend (`dispatch_async`) and writer (`ChurnWriter.
install_through`), until rank 0 stops it.  A query-cache hit on rank 0
dispatches nothing and so sends nothing; the followers' caches are
never consulted.

The events travel over a gloo group of every rank (`control_group`),
made once per default process group, from host memory to host memory.
A header that a follower read from the card would wait for its stream,
the steps still in flight on it included, so each follower would keep
one batch in flight.  On the host a follower stages batch k + 1 while
its batch k computes: it keeps its `PendingDispatch`es in order and
reaps each once it is ready, as rank 0 does (a reap issues no
collective).  Rank 0 sends the host arrays it was given and stages them
as in one process, so the controller adds no copy to the card and no
host sync to the stage.

Rank 0 records its event stream (`events`: every dispatch's queries,
excludes, m and results, every install, in order) and each follower the
ids of every dispatch it ran (`served`), so that a run can be held
against a replay of the stream in one process.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core.mesh import broadcast0

DISPATCH, INSTALL, STOP = 1, 2, 3
FOLLOW_DEPTH = 8   # a follower's batches in flight before it waits

_GROUPS: dict = {}


def control_group():
    """The gloo group of every rank that carries the events, made once per
    default process group (every rank makes it, in one order, on its
    first controller)."""
    made = _GROUPS.get("control")
    if made is None or made[0] is not tdist.group.WORLD:
        made = (tdist.group.WORLD, tdist.new_group(backend="gloo"))
        _GROUPS["control"] = made
    return made[1]


class Controller:
    """The event stream of one serving run over the ranks of the default
    process group; the events travel on the host (`control_group`)."""

    def __init__(self):
        self.rank = tdist.get_rank()
        self.group = control_group()
        self.events: list = []   # rank 0: ["dispatch", q, ex, m, pending]
        #                          and ["install", j], in order
        self.served: list = []   # a follower: each dispatch's ids

    @classmethod
    def of_world(cls):
        """A controller under an initialised process group, else None
        (one process needs none)."""
        return cls() if tdist.is_initialized() else None

    @property
    def leads(self) -> bool:
        return self.rank == 0

    def _header(self, vals=None) -> list:
        """Rank 0 sends `vals` (4 ints); the others receive them."""
        h = (torch.tensor(vals, dtype=torch.int64) if self.leads
             else torch.empty(4, dtype=torch.int64))
        tdist.broadcast(h, src=0, group=self.group)
        return vals if self.leads else h.tolist()

    def _payload(self, outs, like) -> list:
        """Rank 0's host tensors `outs` on every rank, in one broadcast."""
        return broadcast0(outs, like, "cpu", self.group)

    # -- rank 0 ----------------------------------------------------------

    @contextlib.contextmanager
    def leading(self, backend):
        """Rank 0's side: every dispatch of `backend` inside the block is
        announced to the followers first; they are stopped at its end."""
        backend.control = self
        try:
            yield self
        finally:
            backend.control = None
            self._header([STOP, 0, 0, 0])

    def dispatch(self, q_pad: np.ndarray, ex_pad: np.ndarray, m: int) -> None:
        """Announce one dispatch: its header, then its padded queries and
        excludes."""
        q = np.ascontiguousarray(q_pad, np.float32)
        ex = np.ascontiguousarray(ex_pad, np.int32)
        self._header([DISPATCH, q.shape[0], q.shape[1], m])
        self._payload([torch.from_numpy(q), torch.from_numpy(ex)],
                      [(q.shape, torch.float32), (ex.shape, torch.int32)])
        self.events.append(["dispatch", q.copy(), ex.copy(), m, None])

    def dispatched(self, pending) -> None:
        """The `PendingDispatch` of the dispatch just announced (its
        results, once reaped, complete the record)."""
        self.events[-1][4] = pending

    def install(self, j: int) -> None:
        """Announce that the writer's jobs up to `j` install now."""
        self._header([INSTALL, j, 0, 0])
        self.events.append(["install", j])

    def share(self, values=None) -> list[float]:
        """Rank 0's floats `values` on every rank (the others pass
        none)."""
        n = self._header([len(values), 0, 0, 0] if self.leads else None)[0]
        got = self._payload(
            [torch.tensor(values, dtype=torch.float64)] if self.leads
            else None, [((n,), torch.float64)])
        return got[0].tolist()

    def recorded(self) -> list:
        """Rank 0's event stream with each dispatch's served ids and
        scores: [("dispatch", q, ex, m, ids, scores) | ("install", j)]."""
        out = []
        for ev in self.events:
            if ev[0] == "dispatch":
                ids, scores, _ = ev[4].wait()
                out.append(("dispatch", ev[1], ev[2], ev[3], ids, scores))
            else:
                out.append(tuple(ev))
        return out

    # -- the other ranks -------------------------------------------------

    def follow(self, backend, writer=None) -> None:
        """A follower's side: perform rank 0's events on `backend` (and
        `writer`'s installs) until it stops, with up to FOLLOW_DEPTH
        batches in flight."""
        backend.control = self
        inflight = collections.deque()

        def reap(block: bool) -> None:
            while inflight and (block or inflight[0].ready()
                                or len(inflight) > FOLLOW_DEPTH):
                self.served.append(inflight.popleft().wait()[0])

        try:
            while True:
                kind, a, b, m = self._header()
                if kind == STOP:
                    break
                if kind == INSTALL:
                    if writer is None:
                        raise RuntimeError("rank 0 installs a writer's job, "
                                           "but this rank follows without "
                                           "a writer")
                    writer.install_through(a)
                    continue
                q, ex = self._payload(None, [((a, b), torch.float32),
                                             ((a,), torch.int32)])
                inflight.append(backend.dispatch_async(q.numpy(), ex.numpy(),
                                                       m))
                reap(block=False)
            reap(block=True)
        finally:
            backend.control = None
