"""`repro_torch.kernels.autotune`, the port's per-card grid cache, on the
CPU.

An empty or missing cache gives the grids the kernels launched on before
the cache existed (the literals below, for the main path's shapes on a
card of 132 SMs and one of 114); `put` / `get` round-trip through the
environment's cache file; device names normalise as the JAX package's
device kinds do, once per device; a warm `get` reads no file; the JAX
package's Pallas block-shape entries load and change no grid of the
port; the sweep's shapes launch every compiled build and tell each
swept parameter's candidates apart; and the sweep refuses a host without
a card.  The sweep's
candidates against their plain versions run on the card
(tests/test_torch_cuda.py).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

from conftest import SRC
from repro_torch.kernels import autotune
from repro_torch.kernels import bucket_topk as bt
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import simhash as sh

H100 = "nvidia_h100_80gb_hbm3"
REF_CACHE = pathlib.Path(SRC) / "repro" / "kernels" / "autotune_cache.json"

# (sms, simhash args (n, d, k, L, packed), the grid's fields as launched
# before the cache: stream, warps, chunk_rows, elems_per_block,
# col_splits, grid_rows, smem)
SIMHASH_GRIDS = [
    (sms, args, fields)
    for sms, rows in ((132, (132, 155648, 128, 57344, 4)),
                      (114, (114, 155648, 103, 65536, 5)))
    for args, fields in (
        ((1024, 128, 12, 4, False), (False, 4, 4, 1, 1, 256, 0)),
        ((1024, 128, 12, 4, True), (False, 4, 2, 1, 1, 256, 0)),
        ((1_100_000, 128, 12, 4, False), (True, 8, 64, 4, 1, rows[0],
                                          rows[1])),
        ((1_100_000, 128, 12, 4, True), (True, 8, 64, 2, 1, rows[0],
                                         rows[1])),
        ((8192, 24_576, 11, 4, False), (False, 4, 4, 1, 1, 2048, 0)),
        ((8192, 24_576, 11, 4, True), (False, 4, 2, 1, 1, 2048, 0)),
        ((16384, 128, 12, 4, False), (True, rows[4], 32, 4, 1, rows[2],
                                      rows[3])),
        ((65536, 2304, 10, 4, False), (False, 4, 4, 1, 1, 16384, 0)))
]
# (sms, (b, kc, m), (parts, words_per_part, blocks))
TOPK_GRIDS = [
    (132, (128, 6656, 10), (5, 42, 640)),
    (132, (128, 6656, 700), (5, 42, 640)),
    (132, (4096, 832, 10), (1, 26, 4096)), (132, (1, 64, 10), (2, 1, 2)),
    (114, (128, 6656, 10), (4, 52, 512)),
    (114, (128, 6656, 700), (4, 52, 512)),
    (114, (4096, 832, 10), (1, 26, 4096)), (114, (1, 64, 10), (2, 1, 2)),
]
# (sms, rows, (rows a block, blocks))
CONTAINS_GRIDS = [(sms, r, g) for sms in (132, 114) for r, g in (
    (4096, (16, 256)), (128, (1, 128)), (1, (1, 1)), (100_000, (16, 6250)))]


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """The cache file the environment names, in tmp_path (not created)."""
    path = tmp_path / "cache.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune._load.cache_clear()
    yield path
    autotune._load.cache_clear()


def tuned_grids(kind: str):
    """The three grid functions on `kind`'s tuned parameters."""
    p = {op: autotune.get(op, kind) for op in autotune.DEFAULTS["*"]}
    return (lambda *a: sh.grid(*a, p["simhash"]["warp_rows_per_sm"],
                               p["simhash"]["stream_groups"]),
            lambda *a: bt.grid(*a, p["bucket_topk"]["parts_per_sm"]),
            lambda *a: fq.contains_grid(*a, p["fused_contains"]["max_rows"]))


@pytest.mark.parametrize("content", [None, "{}", '{"other_card": {}}'],
                         ids=["missing", "empty", "other-card"])
def test_empty_or_missing_cache_gives_todays_grids(cache_file, content):
    if content is not None:
        cache_file.write_text(content)
    sim, topk, contains = tuned_grids(H100)
    for sms, args, fields in SIMHASH_GRIDS:
        assert sim(*args, sms) == sh.SimhashGrid(*fields), (sms, args)
        assert sim(*args, sms) == sh.grid(*args, sms)
    for sms, args, fields in TOPK_GRIDS:
        assert topk(*args, sms) == bt.BucketTopkGrid(*fields), (sms, args)
    for sms, r, fields in CONTAINS_GRIDS:
        assert contains(r, sms) == fq.ContainsGrid(*fields), (sms, r)


def test_defaults_are_the_module_constants_and_among_the_candidates():
    d = autotune.DEFAULTS["*"]
    assert d["simhash"] == dict(warp_rows_per_sm=sh.WARP_ROWS_PER_SM,
                                stream_groups=sh.STREAM_GROUPS)
    assert d["bucket_topk"] == dict(parts_per_sm=bt.PARTS_PER_SM)
    assert d["fused_contains"] == dict(max_rows=fq.CONTAINS_MAX_ROWS)
    for op, params in d.items():
        assert params in autotune.candidates(op), op
    assert len(autotune.candidates("simhash")) == 10


def test_put_get_round_trip_through_the_env_override(cache_file):
    assert autotune.cache_path() == cache_file
    assert autotune.get("bucket_topk", H100) == dict(parts_per_sm=4)
    assert autotune.put("bucket_topk", dict(parts_per_sm=8), H100) \
        == cache_file
    autotune.put("simhash", dict(warp_rows_per_sm=48, stream_groups=2), H100)
    autotune.put("fused_contains", dict(max_rows=32), "other_card")
    assert autotune.get("bucket_topk", H100) == dict(parts_per_sm=8)
    assert autotune.get("simhash", H100) == dict(warp_rows_per_sm=48,
                                                 stream_groups=2)
    assert autotune.get("fused_contains", H100) == dict(max_rows=16)
    assert autotune.get("fused_contains", "other_card") == dict(max_rows=32)
    assert json.loads(cache_file.read_text()) == {
        H100: {"bucket_topk": {"parts_per_sm": 8},
               "simhash": {"stream_groups": 2, "warp_rows_per_sm": 48}},
        "other_card": {"fused_contains": {"max_rows": 32}}}
    # the tuned values reach the grids (each is part of the grid's key)
    sim, topk, contains = tuned_grids(H100)
    assert topk(128, 6656, 10, 132) == bt.BucketTopkGrid(9, 24, 1152)
    assert sim(16384, 128, 12, 4, False, 132).groups == 2
    assert sim(8192, 128, 12, 4, False, 132).stream  # 48 rows an SM
    assert not sh.grid(8192, 128, 12, 4, False, 132).stream
    assert fq.contains_grid(100_000, 132, 32) == fq.ContainsGrid(32, 3125)


def test_a_partial_entry_keeps_the_other_defaults(cache_file):
    cache_file.write_text(json.dumps({H100: {"simhash": {
        "warp_rows_per_sm": 192}}}))
    assert autotune.get("simhash", H100) == dict(warp_rows_per_sm=192,
                                                 stream_groups=4)


def test_kind_normalisation_once_per_device(monkeypatch):
    assert autotune.normalize_kind(" NVIDIA H100 80GB HBM3 ") == H100
    assert autotune.device_kind("cpu") == "cpu"
    calls = []

    def name(index):
        calls.append(index)
        return f"NVIDIA Card {index}"

    monkeypatch.setattr(autotune.torch.cuda, "get_device_name", name)
    autotune._cuda_kind.cache_clear()
    try:
        for _ in range(3):
            assert autotune.device_kind("cuda:1") == "nvidia_card_1"
            assert autotune.device_kind(autotune.torch.device("cuda", 0)) \
                == "nvidia_card_0"
        assert sorted(calls) == [0, 1]
    finally:
        autotune._cuda_kind.cache_clear()


def test_a_warm_get_reads_no_file(cache_file, monkeypatch):
    autotune.put("bucket_topk", dict(parts_per_sm=2), H100)
    assert autotune.get("bucket_topk", H100) == dict(parts_per_sm=2)

    def no_read(self, *a, **kw):
        raise AssertionError(f"read {self}")

    monkeypatch.setattr(pathlib.Path, "read_text", no_read)
    monkeypatch.setattr(json, "loads", no_read)
    for _ in range(3):
        assert autotune.get("bucket_topk", H100) == dict(parts_per_sm=2)
        assert autotune.get("simhash", H100) == autotune.DEFAULTS["*"][
            "simhash"]


def test_the_jax_packages_block_shape_entries_change_no_grid(cache_file):
    ref = json.loads(REF_CACHE.read_text())
    assert "fused_query" in ref["cpu"]
    cache_file.write_text(json.dumps({
        **ref, H100: {"fused_query": {"tb": 8, "kc": 128},
                      "fused_query_routed": {"tb": 8, "kc": 128}}}))
    for kind in (H100, "cpu"):
        for op, params in autotune.DEFAULTS["*"].items():
            assert autotune.get(op, kind) == params
    sim, topk, contains = tuned_grids(H100)
    for sms, args, fields in SIMHASH_GRIDS:
        assert sim(*args, sms) == sh.SimhashGrid(*fields)
    for sms, args, fields in TOPK_GRIDS:
        assert topk(*args, sms) == bt.BucketTopkGrid(*fields)


def test_grid_refuses_params_the_kernels_were_not_built_for():
    with pytest.raises(ValueError, match="stream_groups"):
        sh.grid(1024, 128, 12, 4, False, 132, 96, 3)
    with pytest.raises(ValueError, match="max_rows"):
        fq.contains_grid(4096, 132, 64)
    # an element wider than the groups: the warp kernel, at any n
    assert not sh.grid(1_100_000, 128, 12, 4, True, 132, 96, 2).stream


@pytest.mark.parametrize("sms", [132, 114])
def test_the_sweep_shapes_launch_every_build_and_tell_candidates_apart(sms):
    """Each compiled build is launched by some candidate at some sweep
    shape (the stream kernel of 4 and of 2 hyperplane groups, the warp
    kernel; fused_contains' 16- and 32-row blocks), and at some shape the
    candidates of each swept parameter give different grids, so the
    sweep times what it varies."""
    grids = {}
    for p in autotune.candidates("simhash"):
        for n, d, k, sparse in autotune.SIMHASH_SHAPES:
            g = sh.grid(n, d, k, 4, False, sms, p["warp_rows_per_sm"],
                        p["stream_groups"])
            grids.setdefault((n, d), {})[tuple(p.values())] = g
    built = {(g.stream, g.groups if g.stream else 0)
             for at in grids.values() for g in at.values()}
    assert built == {(True, 4), (True, 2), (False, 0)}
    for name in ("warp_rows_per_sm", "stream_groups"):
        i = list(autotune.SWEEP["simhash"]).index(name)
        assert any(len({g for key, g in at.items()
                        if all(key[j] == v for j, v in enumerate(key0)
                               if j != i)}) > 1
                   for at in grids.values() for key0 in at), name
    rows = {r: {mr: fq.contains_grid(r, sms, mr).rows
                for mr in autotune.SWEEP["fused_contains"]["max_rows"]}
            for r in autotune.CONTAINS_ROWS}
    assert any(at[32] == 32 for at in rows.values())
    assert any(len(set(at.values())) == len(at) for at in rows.values())


def test_sweep_on_a_host_without_a_card_exits_non_zero(capsys):
    if autotune.torch.cuda.is_available():
        pytest.skip("a host with a card runs the sweep")
    assert autotune.main(["--sweep"]) != 0
    assert "needs a CUDA card" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.sweep(("bucket_topk",))
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune", "--sweep",
         "--ops", "simhash"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and "needs a CUDA card" in proc.stderr
    assert proc.stdout == ""
