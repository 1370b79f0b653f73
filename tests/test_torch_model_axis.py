"""The model axis: tensor and expert parallelism over `--mesh-model`
(`models.sharding`'s `enter` / `leave` / `model_gather` / `model_slice`,
the layers' shares, `train_step.Zero3` and the vocab-parallel loss,
`launch.train` / `launch.serve`), in gloo ranks spawned with
`torch.multiprocessing` (tests/torch_train_dist_worker.py, job
`model_axis`: one world of 2 ranks on a (1, 2) mesh, one of 4 on (2, 2)
and (1, 4)), against the reference run in JAX subprocesses on forced
host devices (`REF_JOBS`, all in the background) and against the
port's one rank:

  * training, 2 steps on one set of weights (the port's init, laid out
    as the reference's tree) and the reference's batches (smoke configs
    in f32): (1, 2) gemma2, deepseek, jamba (its period cut to
    its first two layers: attention + MLP, mamba + MoE), xlstm; (2, 2)
    gemma2, deepseek; (1, 4) gemma2 (its 2 kv heads whole while the 4 q
    heads split), xlstm cut to 2 heads (a shard of mLSTM's q / k / v
    holds half a head) and starcoder2 cut to 6 heads (they do not
    divide over 4, d_ff does).  Held against the reference's
    `make_train_step` under `make_host_mesh(D, M)` and the port's
    one-rank `make_train_step`, with tests/test_torch_train_dist.py's
    limits: loss, xent, lb_loss and grad_norm within 5e-5, parameters
    within 1e-5 but for Adam's 1 in 1000 elements a leaf, within 1e-4;
    for the xLSTM cases within 1.5 x the distance at which the
    reference's own run under the mesh stands from its one-device run on
    that leaf, where that is further (`far_bounds`: one sLSTM gate
    element, 2.2e-4 at (1, 2));
  * the whole logits of all ten architectures at (1, 2), and of the (1,
    4) cases, within 1e-4 of the reference's and of one rank's;
  * the trap cases, each by name: the concatenated projections (jamba's
    in_proj, the xLSTM's up_proj at (1, 2)), a shard that cuts a head,
    GQA with whole kv heads, heads that do not divide;
  * each rank's share of the work, recorded per call in the first
    training forward (`worker.record_shares`): q heads, MLP columns,
    mamba channels, logits columns, experts and their table rows, half
    of one rank's at (1, 2); resident parameter and state bytes those
    the specs give;
  * training under the zero3 preset at (1, 2), gemma2 and deepseek
    (the batch split over data and model, no model share in a layer):
    2 steps within the limits above of one rank's;
  * the int8 update on shards a model split cuts equals one rank's bit
    for bit; resumes (1, 2) -> (2, 1) and back as close as a straight
    run;
  * `launch.serve --mesh-model 2` and `--mesh-data 2 --mesh-model 2`
    for gemma2, deepseek, jamba and xlstm (f32 weights: the argmax of
    bf16 logits ties too often): greedy tokens equal one rank's and the
    reference's under the same mesh;
  * the model-axis plan of every architecture at its published width
    for M = 2, 4, 8, 16 on the meta device: which leaves split, and each
    rank's bytes those of the specs' shards.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch
import torch_train_dist_worker as worker
from test_torch_train_dist import (COMMON, assert_params_close, flat,
                                   start_ref, wait)

from repro.configs import get_config as j_get_config
from repro.data import tokens as jtokens
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

MODEL_REF = COMMON + """
import json
from repro.configs import get_config
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.models import sharding as sh
from repro.train import optimizer as opt
from repro.train import train_step as ts
plan = json.loads(sys.argv[2])
data, model = plan["mesh"]
res = {}

def case(mesh, name):
    arch, over = plan["cases"][name]
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **over)
    d = dict(np.load(os.path.join(out, f"case_{name}.npz")))
    box = {}
    def init():
        p, box["specs"] = M.init_model(cfg, 0)
        return p
    jax.eval_shape(init)
    params = jax.tree.map(jnp.asarray, tree_of(d, "params/"))
    params = jax.tree.map(jax.device_put, params, sh.spec_tree_to_shardings(
        mesh, box["specs"], params))
    return cfg, d, params

def train(mesh, tag, names):
    for name in names:
        cfg, d, params = case(mesh, name)
        ocfg = opt.OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
        state = opt.init_opt_state(params, ocfg)
        step = ts.make_train_step(cfg, ocfg, ts.TrainHParams(loss_chunk=8))
        for i in range(2):
            batch = {k[7:]: jnp.asarray(v) for k, v in d.items()
                     if k.startswith(f"batch{i}/")}
            params, state, m = step(params, state, batch)
            for k in ("loss", "xent", "lb_loss", "z_loss", "grad_norm",
                      "tokens"):
                res[f"{tag}/{name}/step{i}/{k}"] = np.asarray(m[k])
        res.update(flat(params, f"{tag}/{name}/params/"))

# the same steps on one device, for the distance the reference's own
# layouts stand apart
one = make_host_mesh(1, 1)
with sh.use_mesh(one):
    train(one, "1x1", plan["one"])
mesh = make_host_mesh(data, model)
tag = f"{data}x{model}"
with sh.use_mesh(mesh):
    train(mesh, tag, plan["train"])
    for name in plan["forward"]:
        cfg, d, params = case(mesh, name)
        batch = {k[7:]: jnp.asarray(v) for k, v in d.items()
                 if k.startswith("batch0/") and k != "batch0/labels"}
        fwd = jax.jit(lambda p, b: M.logits_from_hidden(
            p, cfg, M.forward(p, cfg, b)[0]))
        res[f"{tag}/{name}/logits"] = np.asarray(fwd(params, batch))
    for name in plan["serve"]:
        cfg, d, params = case(mesh, name)
        batch = {k[6:]: jnp.asarray(v) for k, v in d.items()
                 if k.startswith("serve/")}
        s = plan["gen"]
        res[f"{tag}/{name}/serve"] = np.asarray(jserve.generate(
            params, cfg, batch, steps=s, max_len=batch["tokens"].shape[1]
            + s + 8))
np.savez(os.path.join(out, f"ref_{plan['job']}.npz"), **res)
"""

# the reference's jobs, one JAX subprocess each, all in the background:
# (devices, mesh, training cases, forwards, serving cases, cases also
# trained on one device); (1, 2) in two for the critical path
REF_JOBS = {
    "1x2-train": (2, (1, 2), worker.MODEL_TRAIN[(1, 2)], (), (), ()),
    "1x2-rest": (2, (1, 2), (), worker.MODEL_FORWARD[(1, 2)],
                 worker.MODEL_SERVE[(1, 2)], ("xlstm-1.3b",)),
    "2x2": (4, (2, 2), worker.MODEL_TRAIN[(2, 2)], (),
            worker.MODEL_SERVE[(2, 2)], ()),
    "1x4": (4, (1, 4), worker.MODEL_TRAIN[(1, 4)], worker.MODEL_FORWARD[
        (1, 4)], (), ("xlstm-2heads",)),
}
TRAIN = [(f"{d}x{m}", name) for (d, m), names in worker.MODEL_TRAIN.items()
         for name in names]
FORWARD = [(f"{d}x{m}", name) for (d, m), names in
           worker.MODEL_FORWARD.items() for name in names]
SERVE = [(f"{d}x{m}", name) for (d, m), names in worker.MODEL_SERVE.items()
         for name in names]


def serve_args(name: str):
    return serve_mod.parse_args(["--arch", worker.MODEL_CASES[name][0]]
                                + worker.MODEL_SERVE_ARGV)


def reference_tree(model: M.Model, jc) -> dict:
    """The port's parameters laid out as the reference's tree (its
    layers stacked on [num_periods] again): `convert.leaves_by_name`
    run backwards, on a tree of the reference's structure
    (`jax.eval_shape` of its init, no compile) whose leaves hold their
    elements' indices into one buffer."""
    leaves, treedef = jax.tree.flatten(jax.eval_shape(
        lambda: JM.init_model(jc, 0)[0]))
    offs = np.cumsum([0] + [math.prod(leaf.shape) for leaf in leaves])
    ids = jax.tree.unflatten(treedef, [
        np.arange(o, offs[i + 1]).reshape(leaf.shape)
        for i, (o, leaf) in enumerate(zip(offs, leaves))])
    buf = np.full(offs[-1], np.nan, np.float32)
    state = model.state_dict()
    for name, idx in convert.leaves_by_name(ids, model).items():
        buf[idx.ravel()] = state[name].float().numpy().ravel()
    assert not np.isnan(buf).any()
    return jax.tree.unflatten(treedef, [
        buf[o:offs[i + 1]].reshape(leaf.shape)
        for i, (o, leaf) in enumerate(zip(offs, leaves))])


def case_inputs(name: str) -> dict:
    """The case's weights (the port's `init_model` draws, scaled as the
    reference's init: its jitted init costs 3-10 s a config), laid out
    as the reference's tree, its 2 training batches (the reference's
    `make_batch`) and the serve driver's request batch, flat."""
    arch, over = worker.MODEL_CASES[name]
    jc = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32",
                             **over)
    arrays = flat(reference_tree(M.init_model(worker.case_cfg(name), 0,
                                              device="cpu"), jc), "params/")
    for i in range(worker.TRAIN_STEPS):
        b = jtokens.make_batch(jc, jtokens.DataConfig(seed=0), i,
                               worker.TRAIN_B, worker.TRAIN_S)
        arrays.update({f"batch{i}/{k}": np.asarray(v) for k, v in b.items()})
    args = serve_args(name)
    sb = serve_mod.make_batch(worker.case_cfg(name), args.batch,
                              args.prompt_len, args.seed, "cpu")
    arrays.update({f"serve/{k}": v.numpy() for k, v in sb.items()})
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two worlds' outputs, each spawned once, the JAX references
    (one subprocess a mesh) running in the background meanwhile."""
    tmp = str(tmp_path_factory.mktemp("model_axis"))
    inputs = {}
    for name in worker.MODEL_CASES:
        inputs[name] = case_inputs(name)
        np.savez(os.path.join(tmp, f"case_{name}.npz"), **inputs[name])
    np.savez(os.path.join(tmp, "int8.npz"), **worker.int8_inputs())
    refs = {}
    for job, (devices, mesh, train, fwd, serve, one) in REF_JOBS.items():
        plan = {"job": job, "mesh": mesh, "cases": worker.MODEL_CASES,
                "train": train, "forward": fwd, "serve": serve, "one": one,
                "gen": serve_args("gemma2-2b").gen}
        refs[job] = start_ref(MODEL_REF, devices, tmp, json.dumps(plan))
    out = {"tmp": tmp, "inputs": inputs}
    for world in (2, 4):
        d = os.path.join(tmp, f"world{world}")
        os.makedirs(d)
        ranks = worker.spawn("model_axis", world, d, timeout=400, inputs=tmp,
                             ckpt_root=d)
        for tag in ("1x2",) if world == 2 else ("2x2", "1x4"):
            out[tag] = ranks
    out["ref"] = {}   # every job's outputs, keyed "<D>x<M>/<case>/..."
    for job, proc in refs.items():
        wait(proc, f"the reference's {job}")
        out["ref"].update(np.load(os.path.join(tmp, f"ref_{job}.npz")))
    return out


# -- the port's one rank ---------------------------------------------------------


def one_rank(runs, name: str):
    """The port's one-rank run of a case: (metrics by step, the model
    after 2 steps, the first forward's shares)."""
    key = "one_rank/" + name
    if key not in runs:
        d = runs["inputs"][name]
        cfg = worker.case_cfg(name)
        model = convert.model_from(worker.tree_of(d, "params/"), cfg,
                                   device="cpu")
        ocfg = opt.OptConfig(**worker.OPT)
        state = opt.init_opt_state(dict(model.named_parameters()), ocfg)
        step = ts.make_train_step(cfg, ocfg, worker.HP)
        metrics, shares = [], {}
        for i in range(worker.TRAIN_STEPS):
            batch = {k[len(f"batch{i}/"):]: torch.from_numpy(v)
                     for k, v in d.items() if k.startswith(f"batch{i}/")}
            if i == 0:
                install, remove = worker.record_shares(shares, "one")
                install(model)
            try:
                state, m = step(model, state, batch)
            finally:
                if i == 0:
                    remove()
            metrics.append({k: float(v) for k, v in m.items()})
        runs[key] = (metrics, model, shares)
    return runs[key]


def one_rank_logits(runs, name: str) -> np.ndarray:
    d = runs["inputs"][name]
    model = convert.model_from(worker.tree_of(d, "params/"),
                               worker.case_cfg(name), device="cpu")
    batch = {k[7:]: torch.from_numpy(v) for k, v in d.items()
             if k.startswith("batch0/") and k != "batch0/labels"}
    with torch.no_grad():
        return M.logits_from_hidden(model, M.forward(model, batch)).numpy()


def ref_params(runs, tag: str, name: str) -> dict:
    ref = runs["ref"]
    model = M.Model(worker.case_cfg(name), device="meta")
    pre = f"{tag}/{name}/params/"
    return convert.leaves_by_name(worker.tree_of(
        {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}, ""),
        model)


def params_close(got: dict, want: dict, far: dict):
    """tests/test_torch_train_dist.py's `assert_params_close`, with each
    leaf's far elements (at most 1 in 1000, none in a leaf of fewer than
    1000) held within `far[name]`."""
    for name, w in want.items():
        d = np.abs(np.asarray(got[name], np.float64) - w)
        n_far = int((d > 1e-5).sum())
        assert n_far <= 1e-3 * d.size, (name, n_far, d.size)
        assert d.max() <= far[name], (name, d.max(), far[name])


def far_bounds(runs, tag: str, name: str, want_ref: dict) -> dict:
    """Each leaf's bound on the far elements: 1e-4 (the data-parallel
    tests' bound), or for the xLSTM cases (random xLSTM weights amplify
    rounding) 1.5 x the distance at which the reference's own run under
    this mesh stands from its one-device run on that leaf, where that
    is further.  Adam moves a parameter whose gradient is near zero
    beside eps by a share of lr that the gradient's last bits decide:
    on the sLSTM gates one such element stands 2.2e-4 apart between the
    reference's (1, 1) and (1, 2) runs."""
    if f"1x1/{name}/step0/loss" not in runs["ref"]:
        return {n: 1e-4 for n in want_ref}
    one = ref_params(runs, "1x1", name)
    return {n: max(1e-4, 1.5 * float(np.abs(one[n] - w).max()))
            for n, w in want_ref.items()}


def check_training(runs, tag: str, name: str):
    """Every rank's 2 steps against the reference's under the same mesh
    and the port's one rank."""
    ref = runs["ref"]
    metrics, model, _ = one_rank(runs, name)
    want_ref = ref_params(runs, tag, name)
    far = far_bounds(runs, tag, name, want_ref)
    want_one = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for out in runs[tag]:
        for i in range(worker.TRAIN_STEPS):
            for k in ("loss", "xent", "lb_loss", "grad_norm"):
                got = float(out[f"{tag}/{name}/step{i}/{k}"])
                for exp in (float(ref[f"{tag}/{name}/step{i}/{k}"]),
                            metrics[i][k]):
                    assert abs(got - exp) <= 5e-5 * max(abs(exp), 1.0), \
                        (tag, name, i, k, got, exp)
            assert int(out[f"{tag}/{name}/step{i}/tokens"]) == \
                int(ref[f"{tag}/{name}/step{i}/tokens"])
        got = {n: out[f"{tag}/{name}/param/{n}"] for n in want_one}
        params_close(got, want_ref, far)
        params_close(got, want_one, far)


def check_logits(runs, tag: str, name: str):
    want_ref = runs["ref"][f"{tag}/{name}/logits"]
    want_one = one_rank_logits(runs, name)
    for out in runs[tag]:
        got = out[f"{tag}/{name}/logits"]
        assert got.shape == want_one.shape
        np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, want_one, rtol=0, atol=1e-4)


# -- training and forwards ---------------------------------------------------------


@pytest.mark.parametrize("tag,name", TRAIN)
def test_training_matches_the_reference_and_one_rank(runs, tag, name):
    check_training(runs, tag, name)
    if name == "deepseek-moe-16b":
        assert float(runs["ref"][f"{tag}/{name}/step0/lb_loss"]) > 0


@pytest.mark.parametrize("name", worker.MODEL_ZERO3)
def test_zero3_training_matches_one_rank(runs, name):
    """The zero3 preset at (1, 2): its batch axes take `model`, so the
    two ranks train on other rows of the batch and no layer computes a
    model share (`sharding.model_size` is 1) of the weights Zero3
    gathers whole.  2 steps held against the port's one rank at the
    limits above."""
    metrics, model, _ = one_rank(runs, name)
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    pre = f"1x2zero3/{name}"
    for out in runs["1x2"]:
        for i in range(worker.TRAIN_STEPS):
            for k in ("loss", "xent", "lb_loss", "grad_norm"):
                got, exp = float(out[f"{pre}/step{i}/{k}"]), metrics[i][k]
                assert abs(got - exp) <= 5e-5 * max(abs(exp), 1.0), \
                    (name, i, k, got, exp)
            assert int(out[f"{pre}/step{i}/tokens"]) == metrics[i]["tokens"]
        params_close({n: out[f"{pre}/param/{n}"] for n in want}, want,
                     {n: 1e-4 for n in want})


@pytest.mark.parametrize("tag,name", FORWARD)
def test_logits_match_the_reference_and_one_rank(runs, tag, name):
    check_logits(runs, tag, name)


def test_ranks_hold_their_mesh_coordinates(runs):
    for tag, (d, m) in (("1x2", (1, 2)), ("2x2", (2, 2)), ("1x4", (1, 4))):
        coords = [tuple(out[f"{tag}/coords"].tolist()) for out in runs[tag]]
        assert coords == [(r // m, r % m) for r in range(d * m)]


# -- the trap cases ------------------------------------------------------------------


def shares(runs, tag: str, name: str, what: str) -> list:
    return [out[f"{tag}/{name}/share/{what}"].tolist() for out in runs[tag]]


def test_trap_concatenated_projections(runs):
    """jamba's mamba in_proj [d, 2 di] (x, then z) and the xLSTM's
    mLSTM up_proj [d, 4d] (x branch, then gate) at (1, 2): the spec
    gives rank 0 all of x and rank 1 all of z; each rank still runs
    half of the channels of both."""
    cfg = worker.case_cfg("jamba-2layers")
    assert shares(runs, "1x2", "jamba-2layers", "mamba_channels") == \
        [[cfg.d_inner // 2]] * 2
    for name in ("jamba-2layers", "xlstm-1.3b"):
        check_training(runs, "1x2", name)
    for name in ("jamba-v0.1-52b", "xlstm-1.3b"):
        check_logits(runs, "1x2", name)


def test_trap_a_shard_cuts_a_head(runs):
    """xlstm cut to 2 heads of 32 at (1, 4): each rank's q / k / v
    columns are half a head (16 of 32); the layer still gives the
    reference's numbers."""
    plan = mesh_mod.model_axis_plan(worker.case_cfg("xlstm-2heads"), 1, 4)
    assert plan["blocks.0.mlstm.wq"][1] == (64, 16)
    check_training(runs, "1x4", "xlstm-2heads")
    check_logits(runs, "1x4", "xlstm-2heads")


def test_trap_gqa_kv_heads_whole_while_q_heads_split(runs):
    """gemma2 smoke (4 q heads, 2 kv heads) at (1, 4): one q head a
    rank, the kv weights whole on every rank, and rank r's q head reads
    kv head r // 2 (one attended a call)."""
    plan = mesh_mod.model_axis_plan(worker.case_cfg("gemma2-2b"), 1, 4)
    assert plan["blocks.0.attn.wq"][1] == (64, 1, 16)
    assert plan["blocks.0.attn.wk"][1] == (64, 2, 16)
    assert shares(runs, "1x4", "gemma2-2b", "q_heads") == [[1]] * 4
    assert shares(runs, "1x4", "gemma2-2b", "kv_heads") == [[1]] * 4
    check_training(runs, "1x4", "gemma2-2b")
    check_logits(runs, "1x4", "gemma2-2b")


def test_trap_heads_that_do_not_divide(runs):
    """starcoder2 cut to 6 heads at (1, 4), as starcoder2-7b's 36 at M =
    8: the attention runs whole on every rank (no `leave` on its wo),
    while d_ff splits."""
    cfg = worker.case_cfg("starcoder2-6heads")
    assert shares(runs, "1x4", "starcoder2-6heads", "wq_heads") == [[6]] * 4
    assert shares(runs, "1x4", "starcoder2-6heads", "mlp_columns") == \
        [[cfg.d_ff // 4]] * 4
    check_training(runs, "1x4", "starcoder2-6heads")
    check_logits(runs, "1x4", "starcoder2-6heads")


# -- each rank's share, resident bytes -------------------------------------------


@pytest.mark.parametrize("name", worker.MODEL_TRAIN[(1, 2)])
def test_each_rank_computes_half_of_one_ranks_work(runs, name):
    """Each quantity recorded in the first training forward at (1, 2)
    is half of one rank's: heads, MLP columns, mamba channels, logits
    columns, experts run and the rows of their [E/M, cap] table."""
    _, _, one = one_rank(runs, name)
    kinds = {k.split("/")[-1] for k in one}
    want = {"gemma2-2b": {"q_heads", "kv_heads", "wq_heads", "mlp_columns",
                          "logit_columns"},
            "deepseek-moe-16b": {"experts", "expert_rows", "mlp_columns"},
            "jamba-2layers": {"mamba_channels", "experts", "expert_rows"},
            "xlstm-1.3b": {"logit_columns"}}[name]
    assert want <= kinds
    for kind in kinds:
        full = one[f"one/{kind}"].tolist()
        for got in shares(runs, "1x2", name, kind):
            assert [2 * v for v in got] == full, (name, kind, got, full)


@pytest.mark.parametrize("tag,name", TRAIN)
def test_resident_bytes_are_the_specs_shards(runs, tag, name):
    cfg = worker.case_cfg(name)
    model = M.Model(cfg, device="meta")
    specs = M.param_specs(model)
    d, m = (int(v) for v in tag.split("x"))
    for r, out in enumerate(runs[tag]):
        mesh = types.SimpleNamespace(shape={"data": d, "model": m},
                                     coordinate={"data": r // m,
                                                 "model": r % m})
        shard = sh.spec_tree_to_shardings(mesh, specs,
                                          dict(model.named_parameters()))
        p_bytes = sum(4 * math.prod(sh.local_shape(
            mesh, shard[n].spec, p.shape))
            for n, p in model.named_parameters())
        full = sum(4 * p.numel() for p in model.parameters())
        assert out[f"{tag}/{name}/resident"].tolist() == [p_bytes,
                                                          2 * p_bytes]
        assert p_bytes < full


def test_int8_update_on_model_shards_is_one_ranks_bit_for_bit(runs):
    d = dict(np.load(os.path.join(runs["tmp"], "int8.npz")))
    model = M.Model(worker.f32("gemma2-2b"), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(d[f"p/{n}"]))
    params = dict(model.named_parameters())
    grads = {n: torch.from_numpy(d[f"g/{n}"]) for n in params}
    mu = {n: {k: torch.from_numpy(d[f"mu/{n}/{k}"])
              for k in ("m_q", "m_s", "v_q", "v_s")} for n in params}
    ocfg = opt.OptConfig(**worker.OPT, state_dtype="int8")
    _, st, m = opt.apply_updates(params, grads, {
        "count": torch.tensor(3, dtype=torch.int32), "mu": mu}, ocfg)
    for out in runs["1x2"]:
        whole = set(out["1x2/int8/whole"].tolist())
        # the model axis splits the last (d_ff) axis of w_gate / w_up
        assert {"blocks.0.mlp.w_gate", "blocks.0.mlp.w_up"} <= whole
        assert "blocks.0.attn.wq" not in whole
        assert abs(float(out["1x2/int8/grad_norm"])
                   - float(m["grad_norm"])) <= 1e-6 * float(m["grad_norm"])
        for n, p in params.items():
            for k in ("m_q", "m_s", "v_q", "v_s"):
                np.testing.assert_array_equal(out[f"1x2/int8/mu/{n}/{k}"],
                                              st["mu"][n][k].numpy(),
                                              err_msg=f"{n}/{k}")
            np.testing.assert_allclose(out[f"1x2/int8/param/{n}"],
                                       p.detach().numpy(), rtol=0, atol=1e-6)


def test_resume_across_layouts(runs):
    """(1, 2) -> (2, 1) and (2, 1) -> (1, 2), each resuming the other's
    step-2 checkpoint: as close to a straight one-rank run of 4 steps."""
    straight, _ = train_mod.run(train_mod.parse_args(
        worker.RESUME_ARGV + ["--steps", "4"]), cfg=worker.resume_cfg(),
        log=lambda s: None)
    want = {n: p.detach().numpy() for n, p in straight.named_parameters()}
    for out in runs["1x2"]:
        for tag in ("m2d2", "d2m2"):
            assert_params_close({n: out[f"{tag}/param/{n}"] for n in want},
                                want)
        lines = out["d2m2/lines"].tolist() + out["m2d2/lines"].tolist()
        assert (sum(s.startswith("[resume]") and "step 2" in s
                    for s in lines) == 2) == (out is runs["1x2"][0])


# -- serving -------------------------------------------------------------------


@pytest.mark.parametrize("tag,name", SERVE)
def test_serve_tokens_equal_one_rank_and_the_reference(runs, tag, name):
    d = runs["inputs"][name]
    model = convert.model_from(worker.tree_of(d, "params/"),
                               worker.case_cfg(name), device="cpu")
    one = serve_mod.run(serve_args(name), model=model, log=lambda s: None)
    want = runs["ref"][f"{tag}/{name}/serve"]
    for out in runs[tag]:
        np.testing.assert_array_equal(out[f"{tag}/{name}/serve"], one)
        np.testing.assert_array_equal(out[f"{tag}/{name}/serve"], want)
    assert one.shape == (4, 6)


# -- the plan at full width ----------------------------------------------------------


def expected_split(spec_axes, shape, m: int):
    """The dim the model axis splits under the default rules, or None:
    the first dim whose logical axis maps to `model` (heads, kv_heads,
    d_ff, vocab, experts, d_inner) and divides m."""
    for i, ax in enumerate(spec_axes):
        if sh.DEFAULT_RULES.get(ax) == "model":
            return i if shape[i] % m == 0 else None
    return None


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_axis_plan_at_full_width(arch):
    cfg = get_config(arch)
    meta = M.Model(cfg, device="meta")
    specs = M.param_specs(meta)
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    whole = sum(math.prod(s) * p.element_size()
                for s, p in zip(shapes.values(), meta.parameters()))
    for m in (2, 4, 8, 16):
        for rank in (0, m - 1):
            plan = mesh_mod.model_axis_plan(cfg, 1, m, rank)
            mine = 0
            for n, (spec, local, nbytes) in plan.items():
                dim = expected_split(specs[n], shapes[n], m)
                want = list(shapes[n])
                if dim is not None:
                    want[dim] //= m
                assert tuple(want) == local, (arch, m, n)
                assert (dim is not None) == ("model" in spec), (arch, m, n)
                mine += math.prod(local) * nbytes
            assert mine < whole
    if arch == "gemma2-2b":   # 8 heads, 4 kv heads: at M = 8, kv whole
        p8 = mesh_mod.model_axis_plan(cfg, 1, 8)
        assert p8["blocks.0.attn.wq"][1][1] == 1
        assert p8["blocks.0.attn.wk"][1][1] == 4
    if arch == "starcoder2-7b":   # 36 heads at M = 8: attention whole
        p8 = mesh_mod.model_axis_plan(cfg, 1, 8)
        assert p8["blocks.0.attn.wq"][1][1] == 36
        assert p8["blocks.0.mlp.w_in"][1][1] == cfg.d_ff // 8
    if arch == "xlstm-1.3b":   # 4 heads of 512 at M = 8: half a head
        p8 = mesh_mod.model_axis_plan(cfg, 1, 8)
        assert p8["blocks.0.mlstm.wq"][1][1] == 256
