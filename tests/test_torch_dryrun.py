"""`repro_torch.launch.dryrun` against `repro.launch.dryrun`.

  * the constants (`INT8_OPT_ARCHS`, `RULE_PRESETS`,
    `ENCDEC_DECODE_SRC_LEN`, the ring wire factors) equal the
    reference's;
  * every argument byte of rank 0 at full width, against the
    reference's own shardings on a JAX `AbstractMesh` (no devices, no
    compile): each arch's train_4k cell at (16, 16) and (2, 16, 16)
    under the default rules, and gemma2's and deepseek's under zero3 and
    zero3b, parameters + optimizer state + batch rows exactly; each
    arch's prefill_32k and decode_32k cells at (16, 16) (and the
    long_500k cells of the two archs that run it), parameters and batch
    exactly, and the decode states exactly where both packages lay them
    out alike (`STATE_LAYOUTS` names each cell where they differ, and
    why);
  * the FLOPs of one train step, prefill and decode step of each arch's
    SMOKE config at (1, 1), under `unroll_scope(True)` on both sides,
    against the reference's dot FLOPs: 2 x prod(result) x prod(contracted
    dims) over every `dot_general` of `jax.jit(...).lower(...).as_text()`.
    Equal in every cell but xLSTM's (gemma2's within 1 % a fortiori);
    xLSTM's gaps are explained term by term from the reference's own
    jaxpr (see the test), exactly but for train's, held within 1 %;
  * the fake world against real ones: gemma2 and deepseek (f32 SMOKE) at
    (1, 2) in a gloo world of 2 and at (2, 2) in one of 4
    (tests/torch_train_dist_worker.py, job `dryrun`): one real step
    under the dry run's counters gives, on every rank, the FLOPs and
    each collective's count and bytes of the dry run's cell for that
    rank, exactly; and a one-row batch, which every data rank then runs
    whole, gives one process's loss;
  * the CLI: a decode_32k cell writes one `ok: true` record with every
    key, long_500k gemma2's skip record, a failing cell exits 1, and no
    process group is left behind.
"""

from __future__ import annotations

import functools
import json
import threading
import math
import re

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch_train_dist_worker as worker
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.data import tokens as jtokens
from repro.launch import dryrun as jdry
from repro.models import model as JM
from repro.models import sharding as jsh
from repro.models import unroll as junroll
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import unroll
from repro_torch.train import train_step as ts

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def test_constants_equal_the_reference():
    assert D.INT8_OPT_ARCHS == jdry.INT8_OPT_ARCHS
    assert D.RULE_PRESETS == jdry.RULE_PRESETS
    assert D.ENCDEC_DECODE_SRC_LEN == jdry.ENCDEC_DECODE_SRC_LEN
    # the reference's five factors, and the port's broadcast
    assert {k: v for k, v in D._WIRE_FACTOR.items() if k != "broadcast"} \
        == jdry._WIRE_FACTOR
    assert D._WIRE_FACTOR["broadcast"] == 1.0 and len(jdry._WIRE_FACTOR) == 5


# -- argument bytes at full width ------------------------------------------


def shard_bytes(tree) -> int:
    """The bytes of each leaf's shard under its sharding, summed."""
    return sum(math.prod(leaf.sharding.shard_shape(leaf.shape))
               * leaf.dtype.itemsize for leaf in jax.tree.leaves(tree))


def sds(tree, shardings):
    return jax.tree.map(lambda leaf, s: jax.ShapeDtypeStruct(
        leaf.shape, leaf.dtype, sharding=s), tree, shardings)


@functools.lru_cache(maxsize=None)
def reference_shapes(arch: str) -> tuple:
    """The reference's abstract parameters and specs (`_param_sds` on a
    mesh that splits nothing), its optimizer config and abstract state:
    traced once an arch, placed on each mesh by `reference_bytes`."""
    cfg = j_get_config(arch)
    params, specs = jdry._param_sds(cfg, AbstractMesh((1, 1), (
        "data", "model")))
    shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                          params)
    ocfg = jopt.OptConfig(
        state_dtype="int8" if arch in jdry.INT8_OPT_ARCHS else "fp32")
    opt_shapes = jax.eval_shape(lambda p: jopt.init_opt_state(p, ocfg),
                                shapes)
    return shapes, specs, ocfg, opt_shapes


def reference_bytes(arch: str, shape: str, sizes: tuple, rules) -> dict:
    """The reference's rank-0 bytes of each argument of the cell, from
    its own `_param_sds`, optimizer state, `_batch_sharding` and
    `_decode_state_shardings` on an AbstractMesh."""
    mesh = AbstractMesh(sizes, MESHES[sizes])
    cfg = j_get_config(arch)
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    shapes, specs, ocfg, opt_shapes = reference_shapes(arch)
    # as `_param_sds` places them
    params = sds(shapes, jsh.spec_tree_to_shardings(mesh, specs, shapes,
                                                    rules))
    out = {"params": shard_bytes(params)}
    if spec.kind == "train":
        out["opt"] = shard_bytes(sds(opt_shapes, jsh.spec_tree_to_shardings(
            mesh, jopt.opt_state_specs(specs, ocfg), opt_shapes, rules)))
    if spec.kind != "decode":
        batch = jtokens.input_specs(cfg, b, s, kind=spec.kind)
        out["batch"] = shard_bytes(sds(batch, jdry._batch_sharding(
            mesh, batch, True, rules)))
        return out
    tok = jax.ShapeDtypeStruct((b,), jnp.int32)
    out["batch"] = shard_bytes(sds({"t": tok}, jdry._batch_sharding(
        mesh, {"t": tok}, True, rules)))
    pre = jtokens.input_specs(cfg, b, D.DECODE_PREFILL_LEN, kind="prefill")
    if cfg.encoder_layers:
        pre["frames"] = jax.ShapeDtypeStruct(
            (b, jdry.ENCDEC_DECODE_SRC_LEN, cfg.d_model), jnp.float32)
    states = jax.eval_shape(
        lambda p, bt: JM.prefill(p, cfg, bt, max_len=s)[1], params, pre)
    out["states"] = shard_bytes(sds(states, jdry._decode_state_shardings(
        cfg, states, mesh, shape == "long_500k")))
    return out


def port_bytes(arch: str, shape: str, sizes: tuple, rules) -> dict:
    with D.fake_world(sizes) as mesh:
        cell = D.build_cell(arch, shape, mesh, rules)
        return {k: D.tensor_bytes(v) for k, v in cell.arguments.items()}


TRAIN_CELLS = [(a, "train_4k", m, "default") for a in ARCH_NAMES
               for m in MESHES] + [
    (a, "train_4k", m, r) for a in ("gemma2-2b", "deepseek-moe-16b")
    for m in MESHES for r in ("zero3", "zero3b")]


@pytest.mark.parametrize("arch,shape,sizes,rules", TRAIN_CELLS)
def test_train_argument_bytes_equal_the_reference_shards(arch, shape, sizes,
                                                         rules):
    want = reference_bytes(arch, shape, sizes, D.RULE_PRESETS[rules])
    got = port_bytes(arch, shape, sizes, D.RULE_PRESETS[rules])
    assert got == want


_WHOLE_HEADS = ("the q heads do not divide over 16 model ranks: attention "
                "runs whole on every rank, with every kv head's cache; the "
                "reference splits the KV length over `model`")
# Decode cells whose states the two packages lay out differently (rank
# 0's bytes), and why.  Everywhere else they are equal.
STATE_LAYOUTS = {
    ("llama4-maverick-400b-a17b", "decode_32k"): _WHOLE_HEADS,
    ("phi3-medium-14b", "decode_32k"): _WHOLE_HEADS,
    ("starcoder2-7b", "decode_32k"): _WHOLE_HEADS,
    ("gemma2-2b", "decode_32k"): _WHOLE_HEADS,
    ("jamba-v0.1-52b", "decode_32k"):
        "32 q heads split 2 a rank, 8 kv heads do not: a rank caches its "
        "q heads' kv heads, one a q head; the reference splits the KV "
        "length over `model`",
    ("jamba-v0.1-52b", "long_500k"):
        "as decode_32k; at one row the reference splits the KV length over "
        "`data` and `model`",
    ("xlstm-1.3b", "decode_32k"):
        "4 heads over 16 model ranks: a rank runs the head its columns cut "
        "and holds that head's whole mLSTM / sLSTM state; the reference "
        "splits the head dim over `model`",
    ("xlstm-1.3b", "long_500k"):
        "the port holds less: at one row the reference's first layout does "
        "not fit and it keeps every head's state whole on every rank; a "
        "port rank holds its one head's",
}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_argument_bytes_equal_the_reference_shards(arch, monkeypatch):
    if arch == "xlstm-1.3b":
        # the sLSTM steps one token at a time on the meta device (~0.1 ms
        # an op); the states' shapes do not depend on the prefill's length
        monkeypatch.setattr(D, "DECODE_PREFILL_LEN", 8)
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        if shape == "long_500k" and arch not in (
                "jamba-v0.1-52b", "xlstm-1.3b"):
            continue
        want = reference_bytes(arch, shape, (16, 16), None)
        got = port_bytes(arch, shape, (16, 16), None)
        assert got["params"] == want["params"], shape
        assert got["batch"] == want["batch"], shape
        if "states" in got:
            why = STATE_LAYOUTS.get((arch, shape))
            if why is None:
                assert got["states"] == want["states"], shape
            else:
                assert got["states"] != want["states"], (shape, why)


# -- FLOPs against the reference's dot FLOPs ----------------------------------

_DOT = re.compile(
    r"stablehlo\.dot_general.*contracting_dims = \[([0-9, ]*)\] x "
    r"\[[0-9, ]*\].*:\s*\(tensor<((?:[0-9]+x)*)[a-z]+[0-9]*>, "
    r"tensor<[^>]*>\)\s*->\s*tensor<((?:[0-9]+x)*)[a-z]+[0-9]*>")


def _dims(text: str) -> list:
    return [int(x) for x in text.split("x") if x]


def text_dot_flops(text: str) -> int:
    """2 x prod(result) x prod(contracted lhs dims), over every
    dot_general line of a lowered module's text."""
    total = 0
    for line in text.splitlines():
        if "dot_general" not in line:
            continue
        m = _DOT.search(line)
        assert m, line
        lhs, res = _dims(m.group(2)), _dims(m.group(3))
        contracted = [int(i) for i in m.group(1).split(",") if i.strip()]
        total += 2 * math.prod(res) * math.prod(lhs[i] for i in contracted)
    return total


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if hasattr(x, "jaxpr") and hasattr(x, "consts"):
                yield x.jaxpr
            elif hasattr(x, "eqns"):
                yield x


def jaxpr_dot_flops(jaxpr) -> tuple:
    """(the dot FLOPs the jaxpr executes, a scan's body times its
    length; the part of them in dot_generals that contract at most one
    element)."""
    executed = trivial = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            n = math.prod(lhs[i] for i in lc)
            f = 2 * math.prod(e.outvars[0].aval.shape) * n
            executed += f
            trivial += f if n <= 1 else 0
            continue
        assert e.primitive.name != "while", "a loop of unknown length"
        times = e.params["length"] if e.primitive.name == "scan" else 1
        for sub in _sub_jaxprs(e):
            ex, tr = jaxpr_dot_flops(sub)
            executed += times * ex
            trivial += times * tr
    return executed, trivial


FLOP_SHAPES = {"train": (2, 64), "prefill": (2, 64), "decode": (2, 64)}


def reference_flops(arch: str) -> dict:
    """{kind: its text's and its jaxpr's dot FLOPs} of the reference's
    steps at SMOKE width on abstract inputs, each traced once (decode's
    states are the prefill's outputs where the prefill's inputs are the
    decode build's: every arch but the encoder-decoder, whose decode
    states hold `ENCDEC_DECODE_SRC_LEN` frames)."""
    cfg = j_get_config(arch, smoke=True)
    params = jax.eval_shape(lambda: JM.init_model(cfg, 0)[0])
    out = {}

    def count(traced):
        executed, trivial = jaxpr_dot_flops(traced.jaxpr.jaxpr)
        text = text_dot_flops(traced.lower().as_text())
        return dict(text=text, executed=executed, trivial=trivial)

    with junroll.unroll_scope(True):
        b, s = FLOP_SHAPES["train"]
        ocfg = jopt.OptConfig(state_dtype="fp32")
        state = jax.eval_shape(lambda p: jopt.init_opt_state(p, ocfg),
                               params)
        out["train"] = count(jts.make_train_step(cfg, ocfg).trace(
            params, state, jtokens.input_specs(cfg, b, s, kind="train")))
        b, s = FLOP_SHAPES["prefill"]
        traced = jax.jit(lambda p, bt: JM.prefill(p, cfg, bt, max_len=s)[
            :2]).trace(params, jtokens.input_specs(cfg, b, s,
                                                   kind="prefill"))
        out["prefill"] = count(traced)
        b, s = FLOP_SHAPES["decode"]
        assert FLOP_SHAPES["decode"] == FLOP_SHAPES["prefill"] and \
            s <= D.DECODE_PREFILL_LEN
        if cfg.encoder_layers:
            pre = jtokens.input_specs(cfg, b, s, kind="prefill")
            pre["frames"] = jax.ShapeDtypeStruct(
                (b, jdry.ENCDEC_DECODE_SRC_LEN, cfg.d_model), jnp.float32)
            states = jax.eval_shape(lambda p, bt: JM.prefill(
                p, cfg, bt, max_len=s)[1], params, pre)
        else:
            states = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                traced.out_info[1])
        out["decode"] = count(jax.jit(lambda p, st, t: JM.decode_step(
            p, cfg, t, st, s - 1)).trace(
            params, states, jax.ShapeDtypeStruct((b,), jnp.int32)))
    return out


def port_flops(arch: str, kind: str) -> int:
    b, s = FLOP_SHAPES[kind]
    with unroll.unroll_scope(True):
        rec = D.run_cell(arch, ShapeSpec(kind, s, b, kind), False,
                         mesh_shape=(1, 1),
                         cfg=get_config(arch, smoke=True))
    return rec["cost"]["flops"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_flops_equal_the_reference_dot_flops(arch):
    refs = reference_flops(arch)
    for kind in FLOP_SHAPES:
        ref = refs[kind]
        got = port_flops(arch, kind)
        if arch == "gemma2-2b":
            assert abs(got - ref["text"]) <= 0.01 * ref["text"], kind
        if arch != "xlstm-1.3b":
            assert got == ref["text"], (kind, ref, got)
            continue
        # xLSTM, term by term.  (i) Its mLSTM chunk step and sLSTM time
        # step are lax.scan bodies: the lowered text holds each once,
        # shared by the layers, where they run once a chunk and a time
        # step of every layer (`executed` counts each body times its
        # length; one chunk and one step at decode, where the two
        # agree).  (ii) The chunk's state update ("bhqd,bhqe,bhq->bhde")
        # multiplies k by the gate weights, and at decode's one-token
        # chunk four more products run over one element: jnp.einsum emits
        # each as a dot_general, torch.einsum as an elementwise product,
        # which counts no FLOPs (`trivial`).  Held exactly for prefill and
        # decode.  (iii) In train, autograd's backward of the chunk's
        # einsums contracts in another order than JAX's transpose, and
        # runs some of the one-element products as bmm: within 1 %.
        assert (ref["executed"] != ref["text"]) == (kind != "decode"), kind
        assert ref["trivial"] > 0, kind
        want = ref["executed"] - ref["trivial"]
        if kind == "train":
            assert abs(got - want) <= 0.01 * want, (kind, ref, got)
        else:
            assert got == want, (kind, ref, got)


# -- the fake world against real gloo worlds ----------------------------------


@pytest.fixture(scope="module")
def real_worlds(tmp_path_factory):
    """{world: each rank's outputs} of job `dryrun` at worlds 2 and 4."""
    out = {}

    def run(world):
        d = tmp_path_factory.mktemp(f"dryrun{world}")
        out[world] = worker.spawn("dryrun", world, str(d), timeout=300)

    # the two worlds at once
    other = threading.Thread(target=run, args=(4,))
    other.start()
    run(2)
    other.join()
    assert set(out) == {2, 4}
    return out


@pytest.mark.parametrize("arch", worker.DRYRUN_ARCHS)
@pytest.mark.parametrize("world,layout", [(2, (1, 2)), (4, (2, 2))])
def test_fake_world_counts_equal_a_real_step(real_worlds, arch, world,
                                             layout):
    spec = ShapeSpec("real", worker.DRYRUN_S, worker.DRYRUN_B, "train")
    for rank, real in enumerate(real_worlds[world]):
        rec = D.run_cell(arch, spec, False, mesh_shape=layout, rank=rank,
                         cfg=worker.f32(arch))
        assert rec["cost"]["flops"] == int(real[f"{arch}/flops"])
        coll = rec["collectives"]
        counts = {k.split("/")[-1]: int(v) for k, v in real.items()
                  if k.startswith(f"{arch}/count/")}
        wire = {k.split("/")[-1]: float(v) for k, v in real.items()
                if k.startswith(f"{arch}/bytes/")}
        assert coll["counts"] == counts and coll["bytes_by_op"] == wire
        # the model axis's all-reduces; ZeRO-3's gathers and
        # reduce-scatters where the data axis splits the weights
        assert "all-reduce" in counts
        assert ("reduce-scatter" in counts) == (layout[0] > 1)


def test_one_row_batch_runs_whole_on_every_data_rank(real_worlds):
    """At (2, 2) a batch of one row does not split over the two data
    ranks: as the reference replicates it, each runs it whole, and the
    loss is one process's."""
    cfg = worker.f32("gemma2-2b")
    model = M.init_model(cfg, 0, device="cpu")
    batch = worker.tok.make_batch(cfg, worker.tok.DataConfig(), 0, 1,
                                  worker.DRYRUN_S, device="cpu")
    loss_fn = ts.make_loss_fn(cfg, ts.TrainHParams())
    with torch.no_grad():
        _, metrics = loss_fn(model, batch)
    for real in real_worlds[4]:
        assert float(real["one_row/xent"]) == pytest.approx(
            float(metrics["xent"]), rel=1e-5)
        # the row counted once a data rank, in the loss's sum and count
        assert int(real["one_row/tokens"]) == 2 * int(metrics["tokens"])
    with D.fake_world((16, 16), rank=17) as mesh:
        cell = D.build_cell("xlstm-1.3b", ShapeSpec(
            "long", 512, 1, "decode"), mesh,
            cfg=get_config("xlstm-1.3b", smoke=True))
        assert [tuple(t.shape) for t in cell.arguments["batch"]] == [(1,)]


def test_no_model_share_under_a_zero3_preset():
    """zero3 puts `model` among the batch axes: the model ranks hold
    other rows and no layer computes a model share."""
    with D.fake_world((2, 4)) as mesh:
        with sh.use_mesh(mesh):
            assert sh.model_size() == 4
        for name in ("zero3", "zero3b"):
            with sh.use_mesh(mesh, D.RULE_PRESETS[name]):
                assert sh.model_size() == 1 and sh.batch_axes() == (
                    "data", "model")


# -- the CLI -----------------------------------------------------------------


RECORD_KEYS = {"arch", "shape", "kind", "batch", "seq", "mesh", "multi_pod",
               "unrolled", "rules", "remat", "ok", "t_build_s", "t_step_s",
               "memory", "cost", "collectives", "aten_ops", "fits"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes", "alias_bytes", "peak_bytes",
               "argument_bytes_max_rank"}


def test_cli_writes_a_cell_and_a_skip_record(tmp_path, capsys):
    assert D.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "gemma2-2b__decode_32k__pod1.json")
                     .read_text())
    assert RECORD_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
    assert rec["ok"] and rec["mesh"] == [16, 16] and rec["fits"]
    assert set(rec["cost"]) == {"flops", "bytes_accessed", "transcendentals"}
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["counts"]
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]
    assert not dist.is_initialized()
    assert D.main(["--arch", "gemma2-2b", "--shape", "long_500k",
                   "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "gemma2-2b__long_500k__pod1.json")
                      .read_text())
    assert skip["skipped"] and skip["ok"] and "long_500k" in skip["reason"]
    assert "[skip]" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_cli_exits_1_on_a_failed_cell(tmp_path, capsys, monkeypatch):
    def broken(*a, **kw):
        with D.fake_world((16, 16)):
            raise RuntimeError("a cell that fails")

    monkeypatch.setattr(D, "run_cell", broken)
    assert D.main(["--arch", "gemma2-2b", "--shape", "train_4k",
                   "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "gemma2-2b__train_4k__pod1.json")
                     .read_text())
    assert not rec["ok"] and "a cell that fails" in rec["error"]
    assert "gemma2-2b__train_4k__pod1" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_fake_world_refuses_a_live_group_and_cleans_up():
    with pytest.raises(ValueError), D.fake_world((1, 2)):
        assert dist.is_initialized() and dist.get_world_size() == 2
        raise ValueError("inside")
    assert not dist.is_initialized()
    with D.fake_world((1, 1)):
        with pytest.raises(RuntimeError, match="already initialised"), \
                D.fake_world((1, 1)):
            pass
    assert not dist.is_initialized()
