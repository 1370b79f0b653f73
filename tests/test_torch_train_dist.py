"""Training on several processes: `repro_torch.train.compression`,
`train.pipeline`, the elastic restore of `checkpoint`, and data-parallel
training and serving (`train_step.Zero3`, `launch.train` / `launch.serve
--mesh-data`), each in gloo ranks spawned with `torch.multiprocessing`
(tests/torch_train_dist_worker.py, one thread a rank), against the
reference run in JAX subprocesses on forced host devices:

  * `compressed_psum` at world 4 on the reference's COMPRESSION gradient
    (tests/test_train.py): the int8 codes and scales bit for bit, the
    reduced gradient and the error within 1e-6 relative (the sum over
    ranks may round apart), the reference's own limits (rel < 0.1 once,
    < 0.02 averaged over 20 error-fed steps), and the wire bytes;
  * `pipeline_forward` at world 2 on the reference's PIPELINE case
    (starcoder2 smoke cut to 4 layers, bf16, B, S = 4, 16, M = 2):
    output within 2e-4 of the reference's two-stage run and of the
    port's plain forward, gradients at cosine > 0.999 with norms within
    2 % of both (the reference's own limits: bf16 cotangents round
    differently per reduction order); one stage equals the plain
    forward;
  * elastic restore at world 8: the reference's ELASTIC checkpoint
    (written under a (4, 2) mesh) restored under (2, 4), and the port's
    own save under (4, 2) restored under (2, 4): every rank's shard its
    slice of the array, bit for bit; `sharding.constrain` redistributes
    the restored DTensor;
  * `--mesh-data 2` training on the reference's weights and batches
    (gemma2 and deepseek smoke in f32, and gemma2 with rank 1's labels
    mostly masked) against the reference's train step under
    `make_host_mesh(2, 1)` on 2 JAX devices: loss, xent, lb_loss and
    grad_norm within 5e-5 after each of 2 steps, parameters within 1e-5
    (f32 sums over ranks and over the whole batch round apart, nothing
    more, but for Adam: a parameter whose gradient is near zero beside
    eps moves by a share of lr that the gradient's last bits decide, so
    up to 1 in 1000 elements of each leaf may stand further apart, none
    in a leaf of fewer than 1000, and none further than 1e-4; the far
    ones seen stand 1.3e-5 to 2.2e-5 apart, one in a leaf at most);
    against the port's one-rank step: the same metrics and parameters,
    and each leaf's fp32 moments after the first step within 1e-6 of
    its largest (v, the squared gradient, within 2e-6), after the
    second within 5e-5 (its gradients are taken where the parameters
    stand the Adam spread apart; up to 9.2e-6 seen, in deepseek's
    embedding, which moves from run to run: the CPU's MoE backward
    accumulates in no fixed order); the int8 update on
    shards whose blocks a shard cuts equals the one-rank update on the
    same gradients bit for bit;
    each rank's parameter and state bytes those its specs give; resumes
    from D = 1 to D = 2 and back as close to a straight run;
  * `launch.serve --mesh-data 2`: the one-rank greedy tokens, and on the
    reference's weights the reference's tokens;
  * refusals: `--mesh-model 2` in one process asks for torchrun, as
    `--mesh-data 2` does; experts that do not divide over the model
    axis raise, as the reference's `moe` does; a batch that does not
    divide over D; a period count that does not divide over the stages.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_dist_worker as worker
from conftest import SRC

from repro.configs import get_config as j_get_config
from repro.data import tokens as jtokens
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch import convert
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def flat(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32) if \
                str(np.asarray(v).dtype) == "bfloat16" else np.asarray(v)
    return out


COMMON = """
import os, sys, numpy as np, jax, jax.numpy as jnp, dataclasses
from repro.compat import make_mesh
out = sys.argv[1]

def tree_of(arrays, prefix):
    t = {}
    for key, val in arrays.items():
        if key.startswith(prefix):
            node, parts = t, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return t

def flat(tree, prefix=""):
    o = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            o.update(flat(v, f"{prefix}{k}/"))
        else:
            o[prefix + k] = np.asarray(jnp.asarray(v, jnp.float32))
    return o
"""

COMPRESSION = COMMON + """
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.train import compression as C
from repro.train.optimizer import quantize_blockwise
mesh = make_mesh((4,), ("pod",))
rng = np.random.default_rng(0)
g_global = rng.standard_normal((4, 64, 33)).astype(np.float32)

def body(g_local, err):
    red, new_err = C.compressed_psum({"w": g_local}, {"w": err}, "pod")
    return red["w"], new_err["w"]

fn = shard_map(body, mesh=mesh,
               in_specs=(P("pod", None, None), P("pod", None, None)),
               out_specs=(P("pod", None, None), P("pod", None, None)))
# one step as the reference's test runs it (eager: jit's fusion rounds
# the residual apart), the 20 jitted (their sum is held at 1e-6 of its
# largest)
err = jnp.zeros_like(jnp.asarray(g_global))
red, err1 = fn(jnp.asarray(g_global), err)
acc = np.zeros((64, 33), np.float32)
err = jnp.zeros_like(jnp.asarray(g_global))
jfn = jax.jit(fn)
for _ in range(20):
    r, err = jfn(jnp.asarray(g_global), err)
    acc += np.asarray(r)[0]
qs = [quantize_blockwise(jnp.asarray(g_global[r]), 256) for r in range(4)]
np.savez(os.path.join(out, "compress.npz"), red=np.asarray(red),
         err=np.asarray(err1), acc=acc,
         q=np.stack([np.asarray(q) for q, _ in qs]),
         s=np.stack([np.asarray(s) for _, s in qs]))
"""

PIPELINE = COMMON + """
from repro.configs import get_config
from repro.models import model as M
from repro.train.pipeline import pipeline_forward
d = dict(np.load(os.path.join(out, "pipeline_in.npz")))
cfg = dataclasses.replace(get_config("starcoder2-7b", smoke=True),
                          num_layers=4)
params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                      tree_of(d, "params/"))
mesh = make_mesh((2,), ("stage",))
x, positions = jnp.asarray(d["x"]), jnp.asarray(d["positions"])
o = jax.jit(lambda b: pipeline_forward(cfg, mesh, b, x, positions,
                                       num_microbatches=2))(params["blocks"])
g = jax.jit(jax.grad(lambda b: jnp.sum(pipeline_forward(
    cfg, mesh, b, x, positions, 2) ** 2)))(params["blocks"])
np.savez(os.path.join(out, "pipeline.npz"), out=np.asarray(o),
         **flat(g, "grad/"))
"""

ELASTIC = COMMON + """
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.checkpoint import checkpoint as ckpt
rng = np.random.default_rng(0)
w = jnp.asarray(rng.standard_normal((8, 16)), jnp.float32)
mesh_a = make_mesh((4, 2), ("data", "model"))
sharded = jax.device_put(w, NamedSharding(mesh_a, P("data", "model")))
ckpt.save(os.path.join(out, "elastic_ref"), 1, {"w": sharded})
np.save(os.path.join(out, "elastic_w.npy"), np.asarray(w))
"""

TRAIN = COMMON + """
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.models import sharding as sh
from repro.train import optimizer as opt
from repro.train import train_step as ts
cases = sys.argv[2].split(",")
mesh = make_host_mesh(2, 1)
res = {}
for name, arch in (c.split(":") for c in cases):
    d = dict(np.load(os.path.join(out, f"{name}.npz")))
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    ocfg = opt.OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    hp = ts.TrainHParams(loss_chunk=8)
    box = {}
    def init():
        p, box["specs"] = M.init_model(cfg, 0)
        return p
    jax.eval_shape(init)
    specs = box["specs"]
    with sh.use_mesh(mesh):
        params = jax.tree.map(jnp.asarray, tree_of(d, "params/"))
        params = jax.tree.map(jax.device_put, params,
                              sh.spec_tree_to_shardings(mesh, specs, params))
        state = opt.init_opt_state(params, ocfg)
        step = ts.make_train_step(cfg, ocfg, hp)
        for i in range(2):
            batch = {k: jnp.asarray(d[f"batch{i}/{k}"])
                     for k in ("tokens", "labels")}
            params, state, m = step(params, state, batch)
            for k in ("loss", "xent", "lb_loss", "z_loss", "grad_norm",
                      "tokens"):
                res[f"{name}/step{i}/{k}"] = np.asarray(m[k])
    res.update(flat(params, f"{name}/params/"))
np.savez(os.path.join(out, "train.npz"), **res)
"""


def start_ref(code: str, devices: int, *args: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def wait(proc: subprocess.Popen, what: str) -> None:
    out, err = proc.communicate(timeout=400)
    if proc.returncode:
        raise AssertionError(f"{what} (rc {proc.returncode}):\n{out}\n{err}")


def init_params(cfg):
    """The reference's `init_model(cfg, 0)` parameters, jitted (the same
    values as eager, in a fraction of the time)."""
    return jax.jit(lambda: JM.init_model(cfg, 0)[0])()


def train_inputs(name: str):
    """(params tree, the 2 steps' batches) of a training case, the
    reference's: its init and its make_batch, rank 1's labels mostly
    masked in the `masked` case."""
    arch, masked = worker.TRAIN_CASES[name]
    jc = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
    params = init_params(jc)
    batches = []
    for i in range(worker.TRAIN_STEPS):
        b = jtokens.make_batch(jc, jtokens.DataConfig(seed=0), i,
                               worker.TRAIN_B, worker.TRAIN_S)
        b = {k: np.array(b[k]) for k in ("tokens", "labels")}
        if masked:   # rows 2-3 (rank 1's) keep 3 labels; row 0 loses 4
            b["labels"][2:, 3:] = -1
            b["labels"][0, :4] = -1
        batches.append(b)
    return params, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's outputs, each spawned once, the JAX references
    running in the background meanwhile."""
    tmp = str(tmp_path_factory.mktemp("train_dist"))
    # the inputs both sides share
    pcfg = worker.pipeline_cfg()
    jp = init_params(dataclasses.replace(
        j_get_config("starcoder2-7b", smoke=True), num_layers=4))
    rng = np.random.default_rng(0)
    B, S = 4, 16
    x = (rng.standard_normal((B, S, pcfg.d_model)) * 0.1).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32)[None],
                                (B, S)).copy()
    np.savez(os.path.join(tmp, "pipeline_in.npz"), x=x, positions=positions,
             **flat(jp, "params/"))
    cases = {}
    for name in worker.TRAIN_CASES:
        params, batches = train_inputs(name)
        arrays = flat(params, "params/")
        for i, b in enumerate(batches):
            arrays.update({f"batch{i}/{k}": v for k, v in b.items()})
        np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
        cases[name] = (params, batches)
    sp = init_params(j_get_config("gemma2-2b", smoke=True))
    np.savez(os.path.join(tmp, "serve.npz"), **flat(sp, "params/"))
    int8 = worker.int8_inputs()
    np.savez(os.path.join(tmp, "int8.npz"), **int8)

    refs = {
        "compress": start_ref(COMPRESSION, 4, tmp),
        "pipeline": start_ref(PIPELINE, 2, tmp),
        "elastic": start_ref(ELASTIC, 8, tmp),
        "train": start_ref(TRAIN, 2, tmp, ",".join(
            f"{n}:{a}" for n, (a, _) in worker.TRAIN_CASES.items())),
    }
    # the one-rank run whose step-2 checkpoint the D = 2 run resumes
    ckpt_d1, ckpt_d2 = (os.path.join(tmp, d) for d in ("ck1", "ck2"))
    train_mod.run(train_mod.parse_args(worker.RESUME_ARGV + [
        "--steps", "2", "--ckpt-dir", ckpt_d1]), cfg=worker.resume_cfg(),
        log=lambda s: None)
    out = {"tmp": tmp, "cases": cases, "int8": int8, "serve_params": sp}

    def spawn(job, world, **kw):
        d = os.path.join(tmp, job)
        os.makedirs(d)
        return worker.spawn(job, world, d, **kw)

    out["train"] = spawn("train", 2, inputs=tmp, ckpt_d1=ckpt_d1,
                         ckpt_d2=ckpt_d2)
    out["compress"] = spawn("compress", 4)
    out["pipeline"] = spawn("pipeline", 2,
                            inputs=os.path.join(tmp, "pipeline_in.npz"))
    wait(refs["elastic"], "the reference's ELASTIC")
    out["elastic"] = spawn("elastic", 8,
                           ref_dir=os.path.join(tmp, "elastic_ref"),
                           own_dir=os.path.join(tmp, "elastic_own"))
    for name, proc in refs.items():
        if name != "elastic":
            wait(proc, f"the reference's {name}")
        out["ref_" + name] = dict(np.load(os.path.join(tmp, f"{name}.npz"))) \
            if name != "elastic" else None
    out["ckpt_d2"] = ckpt_d2
    return out


def assert_params_close(got: dict, want: dict):
    """Every parameter within 1e-5 of its counterpart but at most 1 in
    1000 elements of each leaf (none in a leaf of fewer than 1000), and
    those within 1e-4."""
    for name, w in want.items():
        d = np.abs(np.asarray(got[name], np.float64) - w)
        far = int((d > 1e-5).sum())
        assert far <= 1e-3 * d.size, (name, far, d.size)
        assert d.max() <= 1e-4, (name, d.max())


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- compression ---------------------------------------------------------------


def test_compressed_psum_matches_the_reference(runs):
    ref = runs["ref_compress"]
    rng = np.random.default_rng(0)
    g_global = rng.standard_normal((4, 64, 33)).astype(np.float32)
    want = g_global.sum(0)
    for r, out in enumerate(runs["compress"]):
        np.testing.assert_array_equal(out["q"], ref["q"][r])
        np.testing.assert_array_equal(out["s"], ref["s"][r])
        assert rel(out["red"], ref["red"][r]) < 1e-6
        assert rel(out["err"], ref["err"][r]) < 1e-6
        assert rel(out["acc"], ref["acc"]) < 1e-6
        np.testing.assert_array_equal(out["red"], runs["compress"][0]["red"])
        # the reference's own limits, on the port's numbers
        assert rel(out["red"], want) < 0.1
        assert rel(out["acc"] / 20, want) < 0.02
        # 64 rows of one 256-block: int8 codes + one f32 scale a row
        assert out["wire"].tolist() == [64 * 256 + 64 * 4, 4 * 64 * 33]


def test_compressed_psum_strips_row_padding(runs):
    """33 columns pad to one 256-block per row: the error is the
    residual of each row's own 33 values."""
    g = np.random.default_rng(0).standard_normal((4, 64, 33)).astype(
        np.float32)
    for r, out in enumerate(runs["compress"]):
        q, s = out["q"], out["s"]
        deq = (q.astype(np.float32) * s).reshape(64, -1)[:, :33]
        np.testing.assert_array_equal(out["err"], g[r] - deq)


# -- the pipeline ----------------------------------------------------------------


def plain_forward(tmp: str):
    """The port's plain forward of the blocks (and its gradients) on the
    PIPELINE case."""
    d = dict(np.load(os.path.join(tmp, "pipeline_in.npz")))
    cfg = worker.pipeline_cfg()
    model = convert.model_from(worker.tree_of(d, "params/"), cfg,
                               device="cpu")
    params = ts.parameters(model)
    x = torch.from_numpy(d["x"])
    positions = torch.from_numpy(d["positions"])
    for blk in model.blocks:
        x, _, _ = blk(x, positions)
    loss = torch.sum(x.float() ** 2)
    names = [n for n in params if n.startswith("blocks.")]
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return x.detach().float().numpy(), {
        n: g.float().numpy() for n, g in zip(names, grads)}


def ref_grad(ref: dict, name: str) -> np.ndarray:
    """The reference's stacked block gradient of a port block name."""
    parts = name.split(".")
    i, rest = int(parts[1]), parts[2:]
    if rest[-1] == "weight":
        rest = rest[:-1]
    return ref["grad/sub0/" + "/".join(rest)][i]


def assert_grads_close(got: dict, want: dict):
    for n, b in want.items():
        a = got[n].ravel().astype(np.float64)
        b = b.ravel().astype(np.float64)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if nb < 1e-6:
            assert na < 1e-4, n
            continue
        assert float(a @ b / (na * nb)) > 0.999, n
        assert abs(na - nb) / nb < 0.02, (n, na, nb)


def test_pipeline_two_stages(runs):
    ref = runs["ref_pipeline"]
    plain, plain_g = plain_forward(runs["tmp"])
    ranks = runs["pipeline"]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["out"], ranks[-1]["out"])
        np.testing.assert_allclose(out["out"], ref["out"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(out["out"], plain, rtol=2e-4, atol=2e-4)
        # stage r holds blocks 2r, 2r + 1 (one layer a period)
        mine = {n[5:]: g for n, g in out.items() if n.startswith("grad/")}
        own = {n for n in mine if int(n.split(".")[1]) // 2 == r}
        assert own and all(not mine[n].any() for n in set(mine) - own)
        assert_grads_close({n: mine[n] for n in own},
                           {n: ref_grad(ref, n) for n in own})
        assert_grads_close({n: mine[n] for n in own},
                           {n: plain_g[n] for n in own})


def test_pipeline_one_stage_is_the_plain_forward(runs):
    plain, plain_g = plain_forward(runs["tmp"])
    for out in runs["pipeline"]:
        np.testing.assert_array_equal(out["one/out"], plain)
        got = {n[9:]: g for n, g in out.items() if n.startswith("one/grad/")}
        assert set(got) == set(plain_g)
        assert_grads_close(got, plain_g)


def test_pipeline_refuses_periods_that_do_not_divide(runs):
    for out in runs["pipeline"]:
        assert "divide over stages" in str(out["refused"])


# -- elastic restore ---------------------------------------------------------------


def test_elastic_restore_of_the_reference_checkpoint(runs):
    w = np.load(os.path.join(runs["tmp"], "elastic_w.npy"))
    for out in runs["elastic"]:
        d, m = (int(v) for v in out["coords"][:2])
        np.testing.assert_array_equal(out["ref_local"],
                                      w[4 * d:4 * d + 4, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(out["ref_full"], w)
        assert str(out["ref_placements"]) == "(Shard(dim=0), Shard(dim=1))"
        # sharding.constrain to ("batch", None): rows over data only
        np.testing.assert_array_equal(out["rows_local"], w[4 * d:4 * d + 4])
        assert str(out["rows_placements"]) == "(Shard(dim=0), Replicate())"


def test_pod_data_model_mesh_groups_and_batch_rows(runs):
    """`make_lm_mesh(2, 2, pod=2)` at world 8: rank = pod * 4 + data * 2
    + model; each set of axes' group holds the ranks that share this
    rank's other coordinates; the batch rows go by (pod, data), and
    `batch_gather` undoes `batch_rows` also where a one-row batch is
    whole and where zero3's (pod, data, model) falls back to (pod,
    data)."""
    for rank, out in enumerate(runs["elastic"]):
        p, d, m = rank // 4, rank // 2 % 2, rank % 2
        coords = [(pp, dd, mm) for pp in (0, 1) for dd in (0, 1)
                  for mm in (0, 1)]
        for axes in worker.GROUP_AXES:
            want = sorted(4 * pp + 2 * dd + mm for pp, dd, mm in coords
                          if ("pod" in axes or pp == p)
                          and ("data" in axes or dd == d)
                          and ("model" in axes or mm == m))
            assert out["group/" + "+".join(axes)].tolist() == want, axes
        i = 2 * p + d
        assert out["batch_rows"].tolist() == [2 * i, 2 * i + 1]
        assert out["batch_gather"].tolist() == list(range(8))
        # a one-row batch whole on every rank, and gathered back whole
        assert out["one_row/rows"].tolist() == [0]
        assert out["one_row/gather"].tolist() == [0]
        # zero3's batch axes: 8 rows one a rank; 4 rows by (pod, data)
        assert out["zero3/8/rows"].tolist() == [rank]
        assert out["zero3/4/rows"].tolist() == [i]
        for rows in (8, 4):
            assert out[f"zero3/{rows}/gather"].tolist() == list(range(rows))


def test_elastic_restore_of_the_ports_own_save(runs):
    for out in runs["elastic"]:
        d, m = (int(v) for v in out["coords"][:2])
        w = out["own_w"]
        np.testing.assert_array_equal(out["own_local"],
                                      w[4 * d:4 * d + 4, 4 * m:4 * m + 4])
        assert int(out["own_count"]) == 3
    # the file holds the whole array, whatever mesh wrote it
    from repro_torch.checkpoint import checkpoint as ckpt

    path = ckpt.latest_step_dir(os.path.join(runs["tmp"], "elastic_own"))
    back = ckpt.restore(path, {"w": torch.empty(8, 16),
                               "count": torch.tensor(0)})
    np.testing.assert_array_equal(back["w"].numpy(),
                                  runs["elastic"][0]["own_w"])


# -- data-parallel training ----------------------------------------------------------


METRICS = ("loss", "xent", "lb_loss", "grad_norm")


def one_rank(runs, name: str):
    """The port's one-rank run of a case: (metrics by step, the model,
    the moments after each step)."""
    key = "one_rank_" + name
    if key not in runs:
        params, batches = runs["cases"][name]
        arch, _ = worker.TRAIN_CASES[name]
        cfg = worker.f32(arch)
        model = convert.model_from(params, cfg, device="cpu")
        ocfg = opt.OptConfig(**worker.OPT)
        state = opt.init_opt_state(dict(model.named_parameters()), ocfg)
        step = ts.make_train_step(cfg, ocfg, worker.HP)
        metrics, moments = [], []
        for b in batches:
            state, m = step(model, state, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            moments.append({n: {k: t.clone() for k, t in mu.items()}
                            for n, mu in state["mu"].items()})
        runs[key] = (metrics, model, moments)
    return runs[key]


@pytest.mark.parametrize("name", list(worker.TRAIN_CASES))
def test_data_parallel_matches_the_reference(runs, name):
    ref = runs["ref_train"]
    params, _ = runs["cases"][name]
    model = M.Model(worker.f32(worker.TRAIN_CASES[name][0]), device="meta")
    want = convert.leaves_by_name(
        worker.tree_of({k[len(name) + 8:]: v for k, v in ref.items()
                        if k.startswith(f"{name}/params/")}, ""), model)
    for rank_out in runs["train"]:
        for i in range(worker.TRAIN_STEPS):
            for k in METRICS:
                got = float(rank_out[f"{name}/step{i}/{k}"])
                exp = float(ref[f"{name}/step{i}/{k}"])
                assert abs(got - exp) <= 5e-5 * max(abs(exp), 1.0), \
                    (name, i, k, got, exp)
            assert int(rank_out[f"{name}/step{i}/tokens"]) == \
                int(ref[f"{name}/step{i}/tokens"])
        assert_params_close({n: rank_out[f"{name}/param/{n}"] for n in want},
                            want)
    if name == "deepseek":
        assert float(ref["deepseek/step0/lb_loss"]) > 0
    if name == "masked":   # rank 0 holds 28 valid labels, rank 1 6
        labels = runs["cases"]["masked"][1][0]["labels"]
        assert [int((labels[r:r + 2] >= 0).sum()) for r in (0, 2)] == [28, 6]
        assert int(ref["masked/step0/tokens"]) == 34


@pytest.mark.parametrize("name", list(worker.TRAIN_CASES))
def test_data_parallel_matches_one_rank(runs, name):
    metrics, model, moments = one_rank(runs, name)
    for rank_out in runs["train"]:
        for i, m in enumerate(metrics):
            for k in METRICS:
                got = float(rank_out[f"{name}/step{i}/{k}"])
                assert abs(got - m[k]) <= 5e-5 * max(abs(m[k]), 1.0), \
                    (name, i, k)
        assert_params_close(
            {n: rank_out[f"{name}/param/{n}"] for n, _ in
             model.named_parameters()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})
        # each leaf's moments after each step, against its largest: v
        # squares the gradient, so its relative rounding is twice m's;
        # the second step's gradients are taken where the parameters
        # already stand the Adam spread apart (a stale or misreduced
        # leaf stands orders of magnitude further)
        for i, tols in enumerate(((1e-6, 2e-6), (5e-5, 5e-5))):
            for n, _ in model.named_parameters():
                for k, tol in zip(("m", "v"), tols):
                    want = moments[i][n][k].numpy()
                    got = rank_out[f"{name}/step{i}/mu/{n}/{k}"]
                    assert np.abs(got - want).max() <= \
                        tol * max(np.abs(want).max(), 1e-30), (i, n, k)


def test_data_parallel_moe_capacity_is_the_ranks_own():
    """deepseek's capacity follows the rank's tokens, as the reference's
    `local_tokens` (the batch over data x pod)."""
    from repro_torch.models.moe import capacity

    cfg = worker.f32("deepseek-moe-16b")
    local = worker.TRAIN_B // 2 * worker.TRAIN_S
    assert capacity(cfg, local) == max(int(np.ceil(
        local * cfg.moe_top_k / cfg.moe_num_experts
        * cfg.moe_capacity_factor)), 4)
    assert capacity(cfg, local) < capacity(cfg, 2 * local)


def test_int8_update_on_shards_is_one_ranks_bit_for_bit(runs):
    d = runs["int8"]
    cfg = worker.f32("gemma2-2b")
    model = M.Model(cfg, device="cpu")
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
    for out in runs["train"]:
        whole = set(out["int8/whole"].tolist())
        # the leaves whose last axis the data axis splits take whole blocks
        assert {"embed", "blocks.0.attn.wo", "blocks.0.mlp.w_down"} <= whole
        assert "blocks.0.attn.wq" not in whole
        assert rel(out["int8/grad_norm"], m["grad_norm"].numpy()) < 1e-6
        for n, p in params.items():
            for k in ("m_q", "m_s", "v_q", "v_s"):
                np.testing.assert_array_equal(out[f"int8/mu/{n}/{k}"],
                                              st["mu"][n][k].numpy(),
                                              err_msg=f"{n}/{k}")
            np.testing.assert_allclose(out[f"int8/param/{n}"],
                                       p.detach().numpy(), rtol=0, atol=1e-6)


def test_resident_bytes_are_the_specs_shards(runs):
    for name in worker.TRAIN_CASES:
        cfg = worker.f32(worker.TRAIN_CASES[name][0])
        model = M.Model(cfg, device="meta")
        specs = M.param_specs(model)
        ocfg = opt.OptConfig(**worker.OPT)
        for r, out in enumerate(runs["train"]):
            mesh = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                         coordinate={"data": r, "model": 0})
            shard = sh.spec_tree_to_shardings(
                mesh, specs, dict(model.named_parameters()))
            p_bytes = sum(4 * int(np.prod(sh.local_shape(
                mesh, shard[n].spec, p.shape)))
                for n, p in model.named_parameters())
            full = sum(4 * p.numel() for p in model.parameters())
            assert out[f"{name}/resident"].tolist() == [p_bytes, 2 * p_bytes]
            assert p_bytes < 0.75 * full   # ZeRO-3: most weights split


def test_resume_across_a_change_of_d(runs, tmp_path):
    cfg = worker.resume_cfg()
    straight, _ = train_mod.run(train_mod.parse_args(
        worker.RESUME_ARGV + ["--steps", "4"]), cfg=cfg, log=lambda s: None)
    want = {n: p.detach().numpy() for n, p in straight.named_parameters()}
    # D = 1 -> 2: the world-2 run resumed the one-rank step-2 checkpoint
    for out in runs["train"]:
        assert_params_close({n: out[f"resume12/param/{n}"] for n in want},
                            want)
        lines = out["train_lines"].tolist()
        assert any(s.startswith("[ckpt] wrote") for s in lines) == \
            (out is runs["train"][0])
    # D = 2 -> 1: one rank resumes the world-2 step-2 checkpoint
    lines = []
    resumed, _ = train_mod.run(train_mod.parse_args(
        worker.RESUME_ARGV + ["--steps", "4", "--ckpt-dir", runs["ckpt_d2"],
                              "--resume"]), cfg=cfg, log=lines.append)
    assert any(s.startswith("[resume]") and "step 2" in s for s in lines)
    assert_params_close({n: p.detach().numpy() for n, p in
                         resumed.named_parameters()}, want)


# -- data-parallel serving and the refusals ---------------------------------------------


def test_serve_data_parallel_equals_one_rank_and_the_reference(runs):
    one = serve_mod.run(serve_mod.parse_args(worker.SERVE_ARGV),
                        log=lambda s: None)
    args = serve_mod.parse_args(worker.SERVE_ARGV)
    batch = serve_mod.make_batch(worker.get_config("gemma2-2b", smoke=True),
                                 args.batch, args.prompt_len, args.seed,
                                 "cpu")
    want = np.asarray(jserve.generate(
        runs["serve_params"], j_get_config("gemma2-2b", smoke=True),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        steps=args.gen, max_len=args.prompt_len + args.gen + 8))
    for out in runs["train"]:
        np.testing.assert_array_equal(out["serve/cli"], one)
        np.testing.assert_array_equal(out["serve/ref_weights"], want)
    assert one.shape == (4, 6)


def test_refusals(runs):
    for out in runs["train"]:
        assert "does not split over --mesh-data 2" in str(
            out["refused/serve"])
        assert "does not split over --mesh-data 2" in str(
            out["refused/train"])
    # the model axis needs a process group of D x M ranks, which one
    # process is not
    with pytest.raises(RuntimeError, match="torchrun"):
        serve_mod.run(serve_mod.parse_args(worker.SERVE_ARGV + [
            "--mesh-model", "2"]))
    for flag in ("--mesh-data", "--mesh-model"):
        with pytest.raises(RuntimeError, match="torchrun"):
            train_mod.run(train_mod.parse_args(
                worker.RESUME_ARGV + [flag, "2", "--steps", "1"]),
                cfg=worker.resume_cfg())
    # deepseek smoke's 8 experts over a model axis of 3, as the
    # reference's `moe` refuses them (the mesh's shape is all that is
    # read before the refusal: no collective runs)
    cfg = worker.f32("deepseek-moe-16b")
    model = M.init_model(cfg, 0, device="cpu")
    three = types.SimpleNamespace(shape={"data": 1, "model": 3},
                                  coordinate={"data": 0, "model": 0})
    with pytest.raises(ValueError, match="experts 8 must divide over model "
                       "axis 3"), sh.use_mesh(three), torch.no_grad():
        M.forward(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
