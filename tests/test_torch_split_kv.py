"""Decode attention over a KV cache split along its length, in one
process, and the layout rule that splits it (`sharding.cache_spec`).

  * `layers.sdpa_slices`: a cache cut into 1-5 slices, each slice's
    partial softmax (`_sdpa_partial`) combined (`combine_partials`),
    within 1e-6 of `_sdpa` over the whole length (f32), with the logit
    softcap on and off, GQA groups of 1 and 2, a global and a local
    (windowed) layer; a window that spans two slices; a slice the mask
    leaves empty, whose share is exactly 0;
  * `Attention.decode` with a `sharding.LengthSplit` on each of 4
    slices, run as 4 threads whose `reduce` meets at a barrier: only
    the slice that holds `pos` writes (`pos` on a slice's first and
    last row), and the output equals the whole cache's decode;
  * the rule against the reference's `_decode_state_shardings` on a JAX
    `AbstractMesh`: every configured architecture's self-attention (and
    cross) caches at decode_32k and long_500k, meshes (16, 16) and (2,
    16, 16); each rank's `length_split` tiles the length;
  * `model.prefill` over data-parallel ranks refuses to guess the
    global batch's rows.
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
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding as sh

S = 60          # cache length: divides into 1..5 slices
B, DH = 2, 16


def qkv(hq: int, hkv: int, seed: int = 0):
    g = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32))

    return t(B, 1, hq, DH), t(B, S, hkv, DH), t(B, S, hkv, DH)


def cfg_of(softcap: float, window: int):
    return types.SimpleNamespace(attn_logit_softcap=softcap,
                                 window_size=window)


def cut(k, v, pos: int, window: int, n: int):
    """The cache cut into n equal slices, each with its mask on global
    positions."""
    w = S // n
    return ([k[:, i * w:(i + 1) * w] for i in range(n)],
            [v[:, i * w:(i + 1) * w] for i in range(n)],
            [L.decode_mask(i * w, (i + 1) * w, pos, window)
             for i in range(n)])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("pos,window", [(37, 0), (59, 0), (37, 16),
                                        (9, 0)])
def test_slices_combine_to_the_whole_sdpa(n, softcap, hq, hkv, pos, window):
    q, k, v = qkv(hq, hkv, seed=n)
    cfg = cfg_of(softcap, window)
    want = L._sdpa(q, k, v, L.decode_mask(0, S, pos, window), cfg)
    got = L.sdpa_slices(q, *cut(k, v, pos, window, n), cfg)
    assert got.shape == want.shape == (B, 1, hq, DH)
    assert got.dtype == want.dtype
    assert float((got - want).abs().max()) <= 1e-6


def test_a_window_that_spans_two_slices():
    """A local layer's window of 16 at pos 37 reads positions 22..37:
    the end of slice 1 (12..23) and most of slice 2 (24..35) and slice
    3 (36..47) of five; slice 0 and slice 4 are masked out whole."""
    q, k, v = qkv(4, 2)
    cfg = cfg_of(50.0, 16)
    ks, vs, masks = cut(k, v, 37, 16, 5)
    assert [int(m.sum()) for m in masks] == [0, 2, 12, 2, 0]
    want = L._sdpa(q, k, v, L.decode_mask(0, S, 37, 16), cfg)
    assert float((L.sdpa_slices(q, ks, vs, masks, cfg)
                  - want).abs().max()) <= 1e-6


def test_an_empty_slice_adds_exactly_zero():
    """A slice the mask leaves empty has m = -1e30; its weight exp(m -
    max) is 0, so it adds exactly 0 to o and l, and the output equals
    the combine of the other slices alone bit for bit."""
    q, k, v = qkv(4, 2)
    cfg = cfg_of(50.0, 0)
    ks, vs, masks = cut(k, v, 20, 0, 3)      # slice 2 (40..59) is empty
    parts = [L._sdpa_partial(q, kk, vv, mm, cfg)
             for kk, vv, mm in zip(ks, vs, masks)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    assert bool((m[2] == -1e30).all()) and bool((m[:2] > -1e30).all())
    top = L.over_slices(m, "max")
    w = torch.exp(m - top)
    assert bool((w[2] == 0).all())
    assert bool(((o * w)[2] == 0).all()) and bool(((l * w)[2] == 0).all())
    dt = torch.float32
    with_empty = L.combine_partials(m, l, o, L.over_slices, dt)
    without = L.combine_partials(m[:2], l[:2], o[:2], L.over_slices, dt)
    assert torch.equal(with_empty, without)
    want = L._sdpa(q, k, v, L.decode_mask(0, S, 20, 0), cfg)
    assert float((with_empty - want).abs().max()) <= 1e-6


# -- Attention.decode over slices, one thread a slice ------------------------


class _Barrier:
    """The ranks of a length split as threads: each `reduce` call meets
    the others' and returns the max or sum over all of them."""

    def __init__(self, n: int):
        self.n, self.parts = n, [None] * n
        self.barrier = threading.Barrier(n)

    def reduce(self, r: int, t, op: str):
        self.parts[r] = t
        self.barrier.wait()
        out = L.over_slices(torch.stack(self.parts), op)
        self.barrier.wait()
        return out


@dataclasses.dataclass(frozen=True)
class _ThreadSplit(sh.LengthSplit):
    world: _Barrier = None
    rank: int = 0

    def reduce(self, t, op):
        return self.world.reduce(self.rank, t, op)


def _attention(hq: int, hkv: int, softcap: float):
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                              dtype="float32", num_heads=hq,
                              num_kv_heads=hkv, attn_logit_softcap=softcap)
    att = L.Attention(cfg)
    att.reset_parameters(torch.Generator().manual_seed(0))
    return att


@pytest.mark.parametrize("pos", [30, 44, 45])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("hq,hkv,softcap", [(4, 2, 50.0), (2, 2, 0.0)])
def test_decode_on_slices_writes_once_and_equals_the_whole(pos, local, hq,
                                                           hkv, softcap):
    """4 slices of 15 rows: pos 30 is slice 2's first row, 44 its last,
    45 slice 3's first.  The gemma2 smoke window (16) then spans slices
    1 and 2, or 2 and 3."""
    att = _attention(hq, hkv, softcap)
    g = np.random.default_rng(pos)
    x = torch.from_numpy(g.standard_normal((B, 1, 64)).astype(np.float32))
    ck = torch.from_numpy(g.standard_normal((B, S, hkv, 16))
                          .astype(np.float32))
    cv = torch.from_numpy(g.standard_normal((B, S, hkv, 16))
                          .astype(np.float32))
    with torch.no_grad():
        want, wk, wv = att.decode(x, ck.clone(), cv.clone(), pos,
                                  local=local)
    n, w = 4, S // 4
    world = _Barrier(n)
    outs, slices = [None] * n, [None] * n

    def rank(r):
        split = _ThreadSplit(("model",), r * w, (r + 1) * w, S, world, r)
        sk = ck[:, r * w:(r + 1) * w].clone()
        sv = cv[:, r * w:(r + 1) * w].clone()
        with torch.no_grad():
            outs[r], *slices[r] = att.decode(x, sk, sv, pos, local=local,
                                             split=split)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    owner = pos // w
    for r, (sk, sv) in enumerate(slices):
        for got, before, after in ((sk, ck, wk), (sv, cv, wv)):
            part = slice(r * w, (r + 1) * w)
            assert torch.equal(got, after[:, part])
            if r != owner:
                assert torch.equal(got, before[:, part])
        # the owner's one new row, at pos - lo
        changed = (slices[r][0] != ck[:, r * w:(r + 1) * w]).any(-1).any(
            -1).any(0)
        assert changed.nonzero().flatten().tolist() == (
            [pos - r * w] if r == owner else [])
    for out in outs:
        assert float((out - want).abs().max()) <= 1e-6


def test_decode_refuses_a_position_outside_the_cache():
    att = _attention(2, 2, 0.0)
    split = sh.LengthSplit(("model",), 0, 15, 60)
    x = torch.zeros((1, 1, 64))
    with pytest.raises(IndexError):
        att.decode(x, torch.zeros((1, 15, 2, 16)),
                   torch.zeros((1, 15, 2, 16)), 60, split=split)


# -- the rule against the reference's ------------------------------------------

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
CACHE_ARCHS = [a for a in ARCH_NAMES
               if get_config(a).uses_kv_cache]


def _caches(arch: str, shape: str) -> dict:
    """{state key: the cache's global [B, S, Hkv, dh]} of the cell."""
    cfg, spec = get_config(arch), SHAPES[shape]
    kv = (cfg.num_kv_heads, cfg.head_dim)
    out = {"k": (spec.global_batch, spec.seq_len) + kv}
    if cfg.encoder_layers:
        out["xk"] = (spec.global_batch, D.ENCDEC_DECODE_SRC_LEN) + kv
    return out


def _stand_in(sizes: tuple, coords: tuple = None):
    names = MESHES[sizes]
    coords = coords or (0,) * len(sizes)
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 coordinate=dict(zip(names, coords)))


def _norm(spec) -> tuple:
    spec = tuple(spec) + (None,) * (5 - len(tuple(spec)))
    return tuple(e if not isinstance(e, tuple) or len(e) != 1 else e[0]
                 for e in spec)


@pytest.mark.parametrize("sizes", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_layout_is_the_references_pick(arch, shape, sizes):
    caches = _caches(arch, shape)
    mesh = AbstractMesh(sizes, MESHES[sizes])
    tree = {"sub0": {key: jax.ShapeDtypeStruct((2,) + s, np.float32)
                     for key, s in caches.items()}}
    ref = jdry._decode_state_shardings(j_get_config(arch), tree, mesh,
                                       shape == "long_500k")["sub0"]
    with sh.use_mesh(_stand_in(sizes)):
        for key, s in caches.items():
            got = sh.cache_spec(s)
            assert (None,) + got == _norm(ref[key].spec), (key, got,
                                                           ref[key].spec)
            split = sh.length_split(s)
            shard = ref[key].shard_shape((2,) + s)
            assert (split is None) == (shard[2] == s[1])
            if split is not None:
                assert split.hi - split.lo == shard[2]
                assert split.length == s[1]


@pytest.mark.parametrize("sizes", list(MESHES))
def test_length_splits_tile_the_length(sizes):
    """Every rank's slice of jamba's long_500k cache (the length over
    data x model, the rows whole): the data x model ranks' slices tile
    the length in row-major order, and the pods hold the same ones."""
    s = _caches("jamba-v0.1-52b", "long_500k")["k"]
    seen = {}
    for coords in itertools.product(*(range(n) for n in sizes)):
        with sh.use_mesh(_stand_in(sizes, coords)):
            split = sh.length_split(s)
        assert split.axes == ("data", "model")
        dm = coords[-2] * 16 + coords[-1]
        assert (split.lo, split.hi) == (dm * s[1] // 256,
                                        (dm + 1) * s[1] // 256)
        seen.setdefault(dm, set()).add((split.lo, split.hi))
    assert all(len(v) == 1 for v in seen.values()) and len(seen) == 256


def test_gemma2_decode_splits_the_length_over_model():
    """gemma2-2b's 4 kv heads do not divide over 16 model ranks: its
    decode_32k caches keep the 128 rows over data and the length over
    model (2048 positions a rank), as the reference's second
    candidate."""
    with sh.use_mesh(_stand_in((16, 16), (3, 5))):
        s = _caches("gemma2-2b", "decode_32k")["k"]
        assert sh.cache_spec(s) == ("data", "model", None, None)
        split = sh.length_split(s)
    assert (split.axes, split.lo, split.hi) == (("model",), 5 * 2048,
                                                6 * 2048)


def test_prefill_over_data_ranks_needs_the_global_rows():
    cfg = get_config("gemma2-2b", smoke=True)
    model = M.Model(cfg, device="meta")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32,
                                   device="meta")}
    with D.fake_world((2, 1)) as mesh, sh.use_mesh(mesh), torch.no_grad():
        with pytest.raises(ValueError, match="global batch"):
            M.prefill(model, batch, 8)
        # one row, whole on both data ranks: the length over data
        _, states = M.prefill(model, batch, 8, rows=1)
        assert states[0]["k"].shape[1] == 4
        assert states[0]["kv_split"] == sh.LengthSplit(("data",), 0, 4, 8)
        # two rows, one a data rank: the length whole
        _, states = M.prefill(model, batch, 8, rows=2)
        assert states[0]["k"].shape[1] == 8 and "kv_split" not in states[0]
