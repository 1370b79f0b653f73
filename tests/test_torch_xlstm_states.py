"""The xLSTM's decode states laid out as the reference's dry run lays
them out (`sharding.state_spec`, `sharding.head_dim_split`), and the
decode over states split along their head dim, in one process:

  * the rule against the reference's `_decode_state_shardings` on a JAX
    `AbstractMesh`: every xlstm-1.3b and jamba state leaf at decode_32k
    and long_500k, meshes (16, 16) and (2, 16, 16); and xLSTM cuts (4
    heads of 16, 2 of 32, 3 of 16) on the SMOKE meshes (1, 2), (1, 4),
    (2, 2), (1, 8) at 4 rows and 1, which hit all three layouts (heads
    over `model`, the head dim over `model`, every head whole); each
    rank's `head_dim_split` tiles the head dim;
  * `xlstm.mlstm_step_slices` over M in {1, 2, 4, 8, 16} slices of the
    head dim against `_mlstm_chunk`'s one step, at SMOKE width (dh 16)
    and at dh 64: h within 1e-6 of its scale (`close`), the new C / n
    within 1e-6 (f32), m bit-equal;
  * `mlstm_decode` / `slstm_decode` with a `HeadDimSplit` on each of 4
    slices, run as 4 threads whose `reduce` / `gather` meet at a
    barrier, against the whole layer's decode: the mLSTM `close`,
    the sLSTM bit for bit, and `slstm_step_slices` bit for bit;
  * `xlstm.to_head_dim`, the prefill's redistribution, with threads as
    ranks and an all-to-all at a barrier: from the heads each rank's q /
    k / v columns touch to every head on each rank's rows, which tile
    the head dim exactly (or every head whole);
  * `convert.decode_states_for_rank` cuts whole states to each rank's
    shard of the rule.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.launch import dryrun as jdry
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import xlstm as X

NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _stand_in(sizes: tuple, coords: tuple = None):
    names = NAMES[len(sizes)]
    coords = coords or (0,) * len(sizes)
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 coordinate=dict(zip(names, coords)))


def _norm(spec, n: int) -> tuple:
    spec = tuple(spec) + (None,) * (n - len(tuple(spec)))
    return tuple(e if not isinstance(e, tuple) or len(e) != 1 else e[0]
                 for e in spec)


def xlstm_leaves(rows: int, hn: int, dh: int) -> dict:
    """{kind: {field: global shape}} of an xLSTM's states: the mLSTM's
    (C, n, m), the sLSTM's (c, n, h, m)."""
    return {"mlstm": {"C": (rows, hn, dh, dh), "n": (rows, hn, dh),
                      "m": (rows, hn)},
            "slstm": {f: (rows, hn, dh) for f in ("c", "n", "h", "m")}}


def mamba_leaves(cfg, rows: int) -> dict:
    return {"mamba": {"h": (rows, cfg.d_inner, cfg.mamba_d_state),
                      "conv": (rows, cfg.mamba_d_conv - 1, cfg.d_inner)}}


def reference_specs(arch: str, leaves: dict, mesh) -> dict:
    """{(kind, field): the reference's spec} of each leaf, stacked on a
    leading [2] periods axis under the reference's keys (an xLSTM
    layer's tuple as s0, s1, ... in field order)."""
    tree, keys = {}, {}
    for j, (kind, fields) in enumerate(leaves.items()):
        sub = tree[f"sub{j}"] = {}
        for i, (f, shape) in enumerate(fields.items()):
            key = f if kind == "mamba" else f"s{i}"
            sub[key] = jax.ShapeDtypeStruct((2,) + shape, np.float32)
            keys[(kind, f)] = (f"sub{j}", key)
    got = jdry._decode_state_shardings(j_get_config(arch), tree, mesh, False)
    return {k: got[s][key].spec for k, (s, key) in keys.items()}


def _cell_leaves(arch: str, shape: str) -> dict:
    cfg, rows = get_config(arch), SHAPES[shape].global_batch
    if cfg.xlstm:
        return xlstm_leaves(rows, cfg.num_heads, cfg.d_model // cfg.num_heads)
    return mamba_leaves(cfg, rows)


@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_state_layout_is_the_references_pick(arch, shape, sizes):
    leaves = _cell_leaves(arch, shape)
    ref = reference_specs(arch, leaves, AbstractMesh(sizes, NAMES[len(
        sizes)]))
    with sh.use_mesh(_stand_in(sizes)):
        for kind, fields in leaves.items():
            for f, s in fields.items():
                got = sh.state_spec(kind, f, s)
                assert (None,) + got == _norm(ref[(kind, f)], len(s) + 1), (
                    kind, f, got, ref[(kind, f)])


def test_xlstm_1_3b_splits_its_head_dim_at_decode_32k():
    """4 heads of 512 over 16 model ranks: the rows over data, the head
    dim over model (32 rows of it a rank), m [B, H] whole; at long_500k
    (one row) every head whole."""
    with sh.use_mesh(_stand_in((16, 16), (3, 5))):
        leaves = xlstm_leaves(128, 4, 512)
        assert sh.state_spec("mlstm", "C", leaves["mlstm"]["C"]) == (
            "data", None, "model", None)
        assert sh.state_spec("mlstm", "m", leaves["mlstm"]["m"]) == (
            "data", None)
        split = sh.head_dim_split("mlstm", leaves["mlstm"]["C"])
        assert split == sh.HeadDimSplit(("model",), 5 * 32, 6 * 32, 512)
        assert sh.head_dim_split("slstm", leaves["slstm"]["c"]) == split
        one = xlstm_leaves(1, 4, 512)["mlstm"]["C"]
        assert sh.state_spec("mlstm", "C", one) == (None,) * 4
        assert sh.head_dim_split("mlstm", one) == sh.HeadDimSplit(
            (), 0, 512, 512)


# the SMOKE cuts: (heads, head dim), meshes, rows
SMOKE_CUTS = [(4, 16), (2, 32), (3, 16)]
SMOKE_MESHES = [(1, 2), (1, 4), (2, 2), (1, 8)]


def _branch(spec: tuple) -> str:
    return ("heads" if spec[1] == "model" else
            "head_dim" if spec[2] == "model" else "whole")


def test_smoke_layouts_hit_every_branch():
    seen = set()
    for (hn, dh), sizes, rows in itertools.product(SMOKE_CUTS, SMOKE_MESHES,
                                                   (4, 1)):
        leaves = xlstm_leaves(rows, hn, dh)
        ref = reference_specs("xlstm-1.3b", leaves, AbstractMesh(
            sizes, NAMES[2]))
        with sh.use_mesh(_stand_in(sizes)):
            for kind, fields in leaves.items():
                for f, s in fields.items():
                    got = sh.state_spec(kind, f, s)
                    assert (None,) + got == _norm(ref[(kind, f)],
                                                  len(s) + 1), (
                        hn, dh, sizes, rows, kind, f)
                split = sh.head_dim_split(kind, next(iter(fields.values())))
                branch = _branch(sh.state_spec(kind, None, next(iter(
                    fields.values()))))
                assert (split is None) == (branch == "heads")
                assert (split is not None and not split.axes) == (
                    branch == "whole")
                seen.add(branch)
    assert seen == {"heads", "head_dim", "whole"}


@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16), (1, 8)])
def test_head_dim_splits_tile_the_head_dim(sizes):
    """Every rank's rows of xlstm-1.3b's (or the SMOKE cut's, at (1, 8))
    head dim: the model ranks' rows tile it in model-rank order, the
    same on every data (and pod) coordinate."""
    dh = 512 if sizes[-1] == 16 else 16
    shape = (128, 4, dh, dh)
    seen = {}
    for coords in itertools.product(*(range(n) for n in sizes)):
        with sh.use_mesh(_stand_in(sizes, coords)):
            split = sh.head_dim_split("mlstm", shape)
        w = dh // sizes[-1]
        assert (split.axes, split.lo, split.hi) == (
            ("model",), coords[-1] * w, (coords[-1] + 1) * w)
        seen.setdefault(coords[-1], set()).add((split.lo, split.hi))
    rows = sorted(r for v in seen.values() for r in v)
    assert all(len(v) == 1 for v in seen.values())
    assert [lo for lo, _ in rows] == [hi for _, hi in [(0, 0)] + rows[:-1]]
    assert rows[-1][1] == dh


def test_no_split_outside_a_mesh_or_at_one_model_rank():
    shape = (4, 2, 32, 32)
    assert sh.head_dim_split("mlstm", shape) is None
    assert sh.state_spec("mlstm", "C", shape) == (None,) * 4
    with sh.use_mesh(_stand_in((4, 1))):
        assert sh.head_dim_split("mlstm", shape) is None


# -- the decode step over slices of the head dim -------------------------------


def _cfg(d: int, hn: int):
    return dataclasses.replace(get_config("xlstm-1.3b", smoke=True),
                               dtype="float32", d_model=d, num_heads=hn,
                               num_kv_heads=hn, head_dim=d // hn)


def _layer(cls, cfg, seed: int = 0):
    p = cls(cfg)
    p.reset_parameters(torch.Generator().manual_seed(seed))
    return p


def _x(shape, seed: int):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32))


def _bounds(dh: int, n: int) -> list:
    w = dh // n
    return [(r * w, (r + 1) * w) for r in range(n)]


def _mlstm_state(p, b: int, seed: int):
    """The state after a 12-token prefill of the whole layer."""
    with torch.no_grad():
        _, st = X.mlstm_with_state(p, _x((b, 12, p.cfg.d_model), seed),
                                   chunk=4)
    return st


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("d,hn", [(64, 4), (256, 4)])
def test_mlstm_step_over_slices_equals_the_whole_step(n, d, hn):
    p = _layer(X.MLstm, _cfg(d, hn))
    dh = d // hn
    st = _mlstm_state(p, 3, seed=n)
    with torch.no_grad():
        q, k, v, li, lf = X.mlstm_step_inputs(p, _x((3, 1, d), seed=n + 7))
        want_h, (wc, wn, wm) = X._mlstm_chunk(q, k, v, li, lf, st)
        bounds = _bounds(dh, n)
        parts = [(st[0][:, :, lo:hi], st[1][:, :, lo:hi], st[2])
                 for lo, hi in bounds]
        h, new = X.mlstm_step_slices(q, k, v, li, lf, parts, bounds)
    assert h.shape == want_h.shape == (3, hn, 1, dh)
    assert close(h, want_h)
    for (c, nn, m), (lo, hi) in zip(new, bounds):
        assert c.shape == (3, hn, hi - lo, dh) and nn.shape == (3, hn, hi - lo)
        assert float((c - wc[:, :, lo:hi]).abs().max()) <= 1e-6
        assert float((nn - wn[:, :, lo:hi]).abs().max()) <= 1e-6
        assert torch.equal(m, wm)


def close(got, want) -> bool:
    """Within 1e-6 of `want`'s scale (max(1, its largest magnitude)):
    the reads of the split state sum over the slices in another order
    than the whole dot products, a few f32 ulps of h (|h| reaches 5 at
    dh 64, where an ulp is 4.8e-7)."""
    return float((got - want).abs().max()) <= 1e-6 * max(
        1.0, float(want.abs().max()))


class _World:
    """The ranks of a head-dim split as threads: each `meet` posts this
    rank's tensor and returns `combine` of every rank's, in rank order."""

    def __init__(self, n: int):
        self.n, self.parts = n, [None] * n
        self.barrier = threading.Barrier(n)

    def meet(self, r: int, t, combine):
        self.parts[r] = t
        self.barrier.wait()
        out = combine(list(self.parts))
        self.barrier.wait()
        return out


@dataclasses.dataclass(frozen=True)
class _ThreadSplit(sh.HeadDimSplit):
    world: _World = None
    rank: int = 0

    def reduce(self, t):
        return self.world.meet(self.rank, t, lambda ts: torch.stack(ts).sum(0))

    def gather(self, t):
        return self.world.meet(self.rank, t, lambda ts: torch.cat(ts, -1))


def _on_threads(n: int, fn) -> list:
    out = [None] * n
    threads = [threading.Thread(target=lambda r=r: out.__setitem__(r, fn(r)))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _split(world, n: int, dh: int, r: int):
    lo, hi = _bounds(dh, n)[r]
    return _ThreadSplit(("model",), lo, hi, dh, world, r)


def test_mlstm_decode_on_threads_equals_the_whole_decode():
    """`mlstm_decode` with a `HeadDimSplit` on each of 4 ranks (threads;
    no mesh, so q / k / v are whole): every rank's output equals the
    whole layer's within 1e-6 (the reads sum over the ranks), and its
    new rows of C / n and its m equal the whole decode's."""
    n, cfg = 4, _cfg(64, 2)
    p = _layer(X.MLstm, cfg)
    dh = 32
    st = _mlstm_state(p, 2, seed=3)
    x = _x((2, 1, 64), seed=4)
    with torch.no_grad():
        want, (wc, wn, wm) = X.mlstm_decode(p, x, st)
    world = _World(n)

    def rank(r):
        split = _split(world, n, dh, r)
        mine = (st[0][:, :, split.lo:split.hi], st[1][:, :, split.lo:split.hi],
                st[2])
        with torch.no_grad():
            return X.mlstm_decode(p, x, mine, split=split)

    for r, (out, (c, nn, m)) in enumerate(_on_threads(n, rank)):
        lo, hi = _bounds(dh, n)[r]
        assert close(out, want)
        assert float((c - wc[:, :, lo:hi]).abs().max()) <= 1e-6
        assert float((nn - wn[:, :, lo:hi]).abs().max()) <= 1e-6
        assert torch.equal(m, wm)


def _slstm_state(p, b: int, seed: int):
    with torch.no_grad():
        _, st = X.slstm_with_state(p, _x((b, 6, p.cfg.d_model), seed))
    return st


def test_slstm_decode_on_threads_is_the_whole_decode_bit_for_bit():
    """`slstm_decode` with a `HeadDimSplit` on each of 4 ranks: the rows
    all-gathered (`gather`), the whole step, this rank's rows kept:
    every rank's output and rows equal the whole decode's bit for bit,
    and so do `slstm_step_slices`'."""
    n, cfg = 4, _cfg(64, 2)
    p = _layer(X.SLstm, cfg)
    dh = 32
    st = _slstm_state(p, 2, seed=5)
    x = _x((2, 1, 64), seed=6)
    with torch.no_grad():
        want, wst = X.slstm_decode(p, x, st)
    world = _World(n)
    bounds = _bounds(dh, n)

    def rank(r):
        split = _split(world, n, dh, r)
        mine = tuple(t[..., split.lo:split.hi] for t in st)
        with torch.no_grad():
            return X.slstm_decode(p, x, mine, split=split)

    got = _on_threads(n, rank)
    with torch.no_grad():
        s_out, s_states = X.slstm_step_slices(
            p, x, [tuple(t[..., lo:hi] for t in st) for lo, hi in bounds],
            bounds)
    assert torch.equal(s_out, want)
    for (out, rows), s_rows, (lo, hi) in zip(got, s_states, bounds):
        assert torch.equal(out, want)
        for t, s, w in zip(rows, s_rows, wst):
            assert torch.equal(t, w[..., lo:hi]) and torch.equal(s, t)


# -- the prefill's redistribution --------------------------------------------


def _exchange_on(world: _World, r: int):
    """An all-to-all among the threads: each rank posts its buffer and
    its in-splits; rank r takes its chunk of every rank's buffer."""

    def exchange(buf, out_splits, in_splits):
        def mine(posts):
            chunks = []
            for s, (b, ins) in enumerate(posts):
                off = sum(ins[:r])
                assert ins[r] == out_splits[s]
                chunks.append(b[off:off + ins[r]])
            return torch.cat(chunks)

        return world.meet(r, (buf, in_splits), mine)

    return exchange


@pytest.mark.parametrize("d,hn,n,whole", [(64, 2, 4, False),
                                          (64, 4, 8, False),
                                          (2048, 4, 16, False),
                                          (48, 3, 2, True),
                                          (64, 4, 8, True)])
def test_redistribution_tiles_the_head_dim(d, hn, n, whole):
    """`to_head_dim` from the heads each of n ranks ran (those its d / n
    q / k / v columns touch; a head is sent by the first rank that ran
    it) to every head on each rank's rows of the head dim (or whole):
    each rank's C / n equal the whole state's rows exactly, m [B, H]
    whole, and the rows tile the head dim.  (2048, 4, 16) is
    xlstm-1.3b's cut at M = 16, at 1 row and a smaller key dim."""
    dh, b = d // hn, 1 if d == 2048 else 2
    g = np.random.default_rng(n)
    e = min(dh, 8)      # C's value dim: the exchange never reads it
    C = torch.from_numpy(g.standard_normal((b, hn, dh, e)).astype(np.float32))
    nn = torch.from_numpy(g.standard_normal((b, hn, dh)).astype(np.float32))
    m = torch.from_numpy(g.standard_normal((b, hn)).astype(np.float32))
    w = d // n
    ran = [(r * w // dh, -(-(r + 1) * w // dh)) for r in range(n)]
    bounds = [(0, dh)] * n if whole else _bounds(dh, n)
    world = _World(n)

    def rank(r):
        a, z = ran[r]
        st = {"C": C[:, a:z], "n": nn[:, a:z], "m": m[:, a:z]}
        return X.to_head_dim(st, ran, bounds, r, _exchange_on(world, r))

    got = _on_threads(n, rank)
    for out, (lo, hi) in zip(got, bounds):
        assert torch.equal(out["C"], C[:, :, lo:hi])
        assert torch.equal(out["n"], nn[:, :, lo:hi])
        assert torch.equal(out["m"], m)
        assert out["C"].is_contiguous()
    if not whole:
        assert torch.equal(torch.cat([o["C"] for o in got], 2), C)


def test_lay_out_states_leaves_them_outside_a_mesh():
    cfg = _cfg(64, 2)
    st = {"C": torch.zeros((2, 2, 32, 32)), "n": torch.zeros((2, 2, 32)),
          "m": torch.zeros((2, 2))}
    assert X.lay_out_states("mlstm", cfg, st, 2) is st


@pytest.mark.parametrize("sizes,coords,rows,branch", [
    ((1, 4), (0, 2), 4, "head_dim"), ((2, 2), (1, 1), 1, "whole"),
    ((2, 2), (1, 0), 4, "heads")])
def test_decode_states_for_rank_cut_whole_states(sizes, coords, rows,
                                                 branch):
    """`convert.decode_states_for_rank` on a 2-heads cut (4 heads at
    (2, 2) x 4 rows, 3 heads at one row): each leaf is this rank's shard
    of the rule, with the layer's `HeadDimSplit`."""
    hn, dh = {"head_dim": (2, 32), "whole": (3, 16), "heads": (4, 16)}[
        branch]
    cfg = _cfg(hn * dh, hn)
    g = np.random.default_rng(0)
    whole = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        whole.append({f: torch.from_numpy(g.standard_normal(s).astype(
            np.float32)) for f, s in xlstm_leaves(rows, hn, dh)[kind].items()})
    with sh.use_mesh(_stand_in(sizes, coords)):
        got = convert.decode_states_for_rank(whole, cfg)
    d_, m_ = coords
    per = rows // sizes[0] if rows > 1 else rows
    r0 = d_ * per if rows > 1 else 0
    for i, (st, w) in enumerate(zip(got, whole)):
        kind = cfg.layer_kind(i)
        split = st.get("dh_split")
        for f in M.STATE_FIELDS[kind]:
            want = w[f][r0:r0 + per]
            if branch == "heads":
                want = want[:, m_ * hn // 2:(m_ + 1) * hn // 2]
            elif branch == "head_dim" and want.dim() > 2:
                want = want[:, :, m_ * dh // 4:(m_ + 1) * dh // 4]
            assert torch.equal(st[f], want), (i, f)
        assert (split is None) == (branch == "heads")
        if branch == "whole":
            assert split == sh.HeadDimSplit((), 0, dh, dh)
