"""Gloo ranks for tests/test_torch_train_dist.py (not collected).

`spawn(job, world, outdir, **kw)` starts `world` processes with
`torch.multiprocessing`, each on one thread, initialising a gloo process
group through `repro_torch.launch.mesh.init_process_mesh(device="cpu")`
and running one job; rank r saves its outputs to `outdir/rank{r}.npz`.

The jobs:
  * `compress`: `train.compression.compressed_psum` at world 4 on the
    reference's COMPRESSION gradient (tests/test_train.py), one step
    and 20 with error feedback;
  * `pipeline`: `train.pipeline.pipeline_forward` on the reference's
    PIPELINE case over the world's stages, and over a one-rank group;
  * `elastic`: the reference's checkpoint (written under a (4, 2) mesh)
    restored under (2, 4), and the port's own save under (4, 2) restored
    under (2, 4);
  * `train`: data-parallel training steps on the reference's weights
    and batches, the int8 update on shards, the resident bytes, resumes
    across a change of D, and data-parallel serving;
  * `model_axis` (tests/test_torch_model_axis.py), at world 2 on a
    (1, 2) mesh, at world 4 on (2, 2) and (1, 4): training steps,
    forwards and serving over the model axis on the cases' weights (in
    the reference's layout, `case_<name>.npz`), each rank's share of
    the work (`record_shares`), the int8
    update on shards a model split cuts, the resident bytes, and
    resumes across (1, 2) <-> (2, 1);
  * `dryrun` (tests/test_torch_dryrun.py), at world 2 on a (1, 2) mesh
    and at world 4 on (2, 2): one real train step of each
    `DRYRUN_ARCHS` case under `launch.dryrun.StepCounter` (its FLOPs,
    collective counts and bytes, for the dry run's cell of that rank),
    and at world 4 a one-row batch, which every data rank runs whole.

This module imports torch and the port only, never jax.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch_dist_worker import free_port

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import tokens as tok
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.train import compression as C
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.pipeline import pipeline_forward

# the data-parallel training cases: (arch, labels masked in rank 1's rows)
TRAIN_CASES = {"gemma2": ("gemma2-2b", False),
               "deepseek": ("deepseek-moe-16b", False),
               "masked": ("gemma2-2b", True)}
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
HP = ts.TrainHParams(loss_chunk=8)
# the resume runs: launch.train's flags, fp32 state; every step inside
# the warmup, so the learning rate does not depend on --steps
RESUME_ARGV = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
               "--batch", "4", "--seq", "16", "--lr", "1e-3", "--warmup",
               "10", "--log-every", "1", "--ckpt-every", "2"]
SERVE_ARGV = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
              "--batch", "4", "--prompt-len", "12", "--gen", "6"]


def f32(arch: str):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def resume_cfg():
    return f32("gemma2-2b")


def pipeline_cfg():
    return dataclasses.replace(get_config("starcoder2-7b", smoke=True),
                               num_layers=4)


def tree_of(arrays, prefix: str) -> dict:
    """The nested dict under `prefix` of a flat {"a/b/c": array} map."""
    out = {}
    for key, val in arrays.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _job_compress(kw: dict) -> dict:
    rank = dist.get_rank()
    rng = np.random.default_rng(0)
    g_global = rng.standard_normal((4, 64, 33)).astype(np.float32)
    g = {"w": torch.from_numpy(g_global[rank])}
    err = C.init_error_state(g)
    q, s = opt.quantize_blockwise(g["w"] + err["w"], 256)
    stats = {}
    red, err1 = C.compressed_psum(g, err, stats=stats)
    acc = torch.zeros(64, 33)
    err = C.init_error_state(g)
    for _ in range(20):
        r, err = C.compressed_psum(g, err)
        acc += r["w"]
    return dict(q=q.numpy(), s=s.numpy(), red=red["w"].numpy(),
                err=err1["w"].numpy(), acc=acc.numpy(),
                wire=np.asarray([stats["wire_bytes"], stats["f32_bytes"]]))


def _pipeline_run(model, cfg, group, x, positions):
    params = ts.parameters(model)
    out = pipeline_forward(cfg, group, model.blocks, x, positions, 2)
    loss = torch.sum(out.float() ** 2)
    names = [n for n, p in params.items() if n.startswith("blocks.")]
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    out_d = {"out": out.detach().float().numpy()}
    for n, g in zip(names, grads):
        if g is not None:
            out_d["grad/" + n] = g.float().numpy()
    return out_d


def _job_pipeline(kw: dict) -> dict:
    d = dict(np.load(kw["inputs"]))
    cfg = pipeline_cfg()
    model = convert.model_from(tree_of(d, "params/"), cfg, device="cpu")
    x, positions = torch.from_numpy(d["x"]), torch.from_numpy(d["positions"])
    out = _pipeline_run(model, cfg, None, x, positions)
    # one stage: a group of this rank alone (every rank makes both)
    ones = [dist.new_group([r]) for r in range(dist.get_world_size())]
    one = _pipeline_run(model, cfg, ones[dist.get_rank()], x, positions)
    out.update({"one/" + k: v for k, v in one.items()})
    try:
        pipeline_forward(dataclasses.replace(cfg, num_layers=3), None,
                         model.blocks, x, positions, 2)
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    return out


def _job_elastic(kw: dict) -> dict:
    rank = dist.get_rank()
    a = mesh_mod.make_lm_mesh(4, 2, device="cpu")
    b = mesh_mod.make_lm_mesh(2, 4, device="cpu")
    spec = ("data", "model")
    tmpl = {"w": torch.empty((8, 16))}
    target = {"w": sh.NamedSharding(b, spec)}
    out = {}
    # the reference's checkpoint, written under (4, 2)
    got = ckpt.restore(ckpt.latest_step_dir(kw["ref_dir"]), tmpl,
                       shardings=target)["w"]
    out["ref_local"] = got.to_local().numpy()
    out["ref_placements"] = np.asarray(str(got.placements))
    out["ref_full"] = got.full_tensor().numpy()
    # constrain redistributes a DTensor: rows over data, whole columns
    with sh.use_mesh(b):
        rows = sh.constrain(got, "batch", None)
    out["rows_local"] = rows.to_local().numpy()
    out["rows_placements"] = np.asarray(str(rows.placements))
    # the port's own save under (4, 2), restored under (2, 4)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 16)).astype(np.float32))
    src = sh.NamedSharding(a, spec)
    from torch.distributed.tensor import DTensor
    local = w[sh.local_slices(a, spec, w.shape)].contiguous()
    dt = DTensor.from_local(local, a.device_mesh, src.placements(),
                            run_check=False, shape=w.shape,
                            stride=w.stride())
    path = ckpt.save(kw["own_dir"], 3, {"w": dt,
                                        "count": torch.tensor(3)})
    back = ckpt.restore(path, {"w": tmpl["w"], "count": torch.tensor(0)},
                        shardings={"w": target["w"], "count": None})
    out["own_local"] = back["w"].to_local().numpy()
    out["own_count"] = back["count"].numpy()
    out["own_w"] = w.numpy()
    out["coords"] = np.asarray([b.coordinate["data"], b.coordinate["model"],
                                a.coordinate["data"], a.coordinate["model"],
                                rank])
    # a pod x data x model mesh: each set of axes' group, and the batch
    # rows of this rank under the default rules (batch -> pod, data)
    c = mesh_mod.make_lm_mesh(2, 2, pod=2, device="cpu")
    for axes in GROUP_AXES:
        out["group/" + "+".join(axes)] = np.asarray(
            dist.get_process_group_ranks(c.group(axes)))
    with sh.use_mesh(c):
        out["batch_rows"] = sh.batch_rows(torch.arange(8)).numpy()
        out["batch_gather"] = sh.batch_gather(
            sh.batch_rows(torch.arange(8)), 8).numpy()
        # a one-row batch is every rank's whole
        out["one_row/rows"] = sh.batch_rows(torch.arange(1)).numpy()
        out["one_row/gather"] = sh.batch_gather(
            sh.batch_rows(torch.arange(1)), 1).numpy()
    # the zero3 preset's batch axes (pod, data, model): 8 rows split
    # over all 8 ranks, 4 rows fall back to (pod, data)
    from repro_torch.launch.dryrun import RULE_PRESETS

    with sh.use_mesh(c, RULE_PRESETS["zero3"]):
        for rows in (8, 4):
            x = torch.arange(rows)
            out[f"zero3/{rows}/rows"] = sh.batch_rows(x).numpy()
            out[f"zero3/{rows}/gather"] = sh.batch_gather(
                sh.batch_rows(x), rows).numpy()
    return out


GROUP_AXES = [("pod",), ("data",), ("model",), ("pod", "data"),
              ("pod", "model"), ("data", "model"), ("pod", "data", "model")]


def int8_inputs() -> dict:
    """Parameters, gradients and an int8 state (from random moments) of
    gemma2 smoke in f32, for the sharded int8 update."""
    rng = np.random.default_rng(5)
    model = M.Model(f32("gemma2-2b"), device="meta")
    ocfg = opt.OptConfig(state_dtype="int8")
    out = {}
    for n, p in model.named_parameters():
        shape = tuple(p.shape)
        out[f"p/{n}"] = rng.standard_normal(shape).astype(np.float32)
        out[f"g/{n}"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(np.abs(rng.standard_normal(shape))
                             .astype(np.float32) * 1e-3)
        for k, t in opt.quantized_moments(m * 1e-2, v, ocfg).items():
            out[f"mu/{n}/{k}"] = t.numpy()
    return out


def _resident(zero: ts.Zero3, state: dict) -> np.ndarray:
    """(bytes of parameter storage this rank holds, bytes of its
    optimizer state)."""
    seen, p_bytes = set(), 0
    for t in list(zero.shards.values()) + list(zero.params.values()):
        if t.data_ptr() not in seen and t.numel():
            seen.add(t.data_ptr())
            p_bytes += t.numel() * t.element_size()
    s_bytes = sum(t.numel() * t.element_size()
                  for leaves in state["mu"].values() for t in leaves.values())
    return np.asarray([p_bytes, s_bytes])


def _train_cases(kw: dict, mesh) -> dict:
    out = {}
    for name in TRAIN_CASES:
        d = dict(np.load(os.path.join(kw["inputs"], f"{name}.npz")))
        arch, _ = TRAIN_CASES[name]
        cfg = f32(arch)
        model = convert.model_from(tree_of(d, "params/"), cfg, device="cpu")
        ocfg = opt.OptConfig(**OPT)
        zero = ts.Zero3(model, mesh)
        state = zero.init_opt_state(ocfg)
        out[f"{name}/resident"] = _resident(zero, state)
        step = ts.make_sharded_train_step(cfg, ocfg, zero, HP)
        for i in range(TRAIN_STEPS):
            batch = {k: torch.from_numpy(d[f"batch{i}/{k}"])
                     for k in ("tokens", "labels")}
            with sh.use_mesh(mesh):
                rows = {k: sh.batch_rows(v) for k, v in batch.items()}
            state, m = step(model, state, rows)
            for k in ("loss", "xent", "lb_loss", "z_loss", "grad_norm",
                      "tokens"):
                out[f"{name}/step{i}/{k}"] = m[k].numpy()
            for n, leaves in zero.full_state(state, ocfg)["mu"].items():
                for k, t in leaves.items():   # a copy: whole leaves
                    out[f"{name}/step{i}/mu/{n}/{k}"] = t.numpy().copy()
        zero.gather()
        for n, p in model.named_parameters():
            out[f"{name}/param/{n}"] = p.detach().numpy()
    return out


def _int8_update(kw: dict, mesh) -> dict:
    """apply_updates on the shards of given params, grads and int8 state
    (`train_step._Int8Moments`): the new codes, gathered."""
    d = dict(np.load(os.path.join(kw["inputs"], "int8.npz")))
    cfg = f32("gemma2-2b")
    model = M.Model(cfg, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(d[f"p/{n}"]))
    ocfg = opt.OptConfig(**OPT, state_dtype="int8")
    zero = ts.Zero3(model, mesh)
    st = zero.state_shardings(ocfg)["mu"]
    grads = {n: torch.from_numpy(d[f"g/{n}"])[sh.local_slices(
        mesh, zero.shardings[n].spec, zero.shapes[n])].contiguous()
        for n in zero.shapes}
    mu = {n: {k: torch.from_numpy(d[f"mu/{n}/{k}"])[sh.local_slices(
        mesh, st[n][k].spec, d[f"mu/{n}/{k}"].shape)].contiguous()
        for k in ("m_q", "m_s", "v_q", "v_s")} for n in zero.shapes}
    state = {"count": torch.tensor(3, dtype=torch.int32), "mu": mu}
    moments = zero.moments(ocfg)
    _, state, m = opt.apply_updates(zero.shards, grads, state, ocfg,
                                    grad_norm=zero.grad_norm(grads),
                                    moments=moments)
    out = {"int8/whole": np.asarray(sorted(moments.whole)),
           "int8/grad_norm": m["grad_norm"].numpy()}
    zero.gather(whole=True)
    for n, p in model.named_parameters():
        out[f"int8/param/{n}"] = p.detach().numpy()
    for n, leaves in zero.full_state(state, ocfg)["mu"].items():
        for k, t in leaves.items():
            out[f"int8/mu/{n}/{k}"] = t.numpy()
    return out


def _job_train(kw: dict) -> dict:
    mesh = mesh_mod.make_lm_mesh(2, 1, device="cpu")
    out = _train_cases(kw, mesh)
    out.update(_int8_update(kw, mesh))
    # resumes across D: from the one-rank run's step-2 checkpoint to 4,
    # and a D = 2 checkpoint at step 2 for a one-rank resume
    cfg = resume_cfg()
    model, state = train_mod.run(train_mod.parse_args(
        RESUME_ARGV + ["--mesh-data", "2", "--steps", "4", "--ckpt-dir",
                       kw["ckpt_d1"], "--resume"]), cfg=cfg,
        log=lambda s: None)
    for n, p in model.named_parameters():
        out[f"resume12/param/{n}"] = p.detach().numpy()
    lines = []
    train_mod.run(train_mod.parse_args(
        RESUME_ARGV + ["--mesh-data", "2", "--steps", "2", "--ckpt-dir",
                       kw["ckpt_d2"]]), cfg=cfg, log=lines.append)
    out["train_lines"] = np.asarray(lines)
    # serving: the CLI's batch, and the reference's weights
    out["serve/cli"] = serve_mod.run(serve_mod.parse_args(
        SERVE_ARGV + ["--mesh-data", "2"]), log=lambda s: None)
    d = dict(np.load(os.path.join(kw["inputs"], "serve.npz")))
    model = convert.model_from(tree_of(d, "params/"),
                               get_config("gemma2-2b", smoke=True),
                               device="cpu")
    out["serve/ref_weights"] = serve_mod.run(serve_mod.parse_args(
        SERVE_ARGV + ["--mesh-data", "2"]), model=model, log=lambda s: None)
    try:
        serve_mod.run(serve_mod.parse_args(
            SERVE_ARGV + ["--batch", "3", "--mesh-data", "2"]))
    except ValueError as e:
        out["refused/serve"] = np.asarray(str(e))
    try:
        train_mod.run(train_mod.parse_args(
            RESUME_ARGV + ["--batch", "3", "--mesh-data", "2", "--steps",
                           "1"]))
    except ValueError as e:
        out["refused/train"] = np.asarray(str(e))
    return out


# -- the model axis ------------------------------------------------------------

# the model-axis cases: (arch, overrides of its smoke config), in f32
MODEL_CASES = {**{a: (a, {}) for a in ARCH_NAMES},
               # jamba's period of 8 cut to its first two layers
               # (attention + MLP, mamba + MoE): its training step's
               # compile in the reference is a quarter of the whole's
               "jamba-2layers": ("jamba-v0.1-52b", dict(num_layers=2,
                                                         scan_period=2)),
               # mLSTM's q / k / v shards hold half a head at M = 4
               "xlstm-2heads": ("xlstm-1.3b", dict(num_heads=2,
                                                    num_kv_heads=2,
                                                    head_dim=32)),
               # 6 heads do not divide over M = 4 (the attention runs
               # whole on every rank) while d_ff does
               "starcoder2-6heads": ("starcoder2-7b", dict(num_heads=6))}
MODEL_TRAIN = {(1, 2): ("gemma2-2b", "deepseek-moe-16b", "jamba-2layers",
                        "xlstm-1.3b"),
               (2, 2): ("gemma2-2b", "deepseek-moe-16b"),
               # gemma2's 2 kv heads stay whole while its 4 q heads split
               (1, 4): ("gemma2-2b", "xlstm-2heads", "starcoder2-6heads")}
# trained at (1, 2) under the zero3 preset too: its batch axes take
# `model`, so the two ranks hold other rows and no layer splits heads
MODEL_ZERO3 = ("gemma2-2b", "deepseek-moe-16b")
MODEL_FORWARD = {(1, 2): ARCH_NAMES,
                 (1, 4): ("gemma2-2b", "xlstm-2heads", "starcoder2-6heads")}
MODEL_SERVE = {(1, 2): ("gemma2-2b", "deepseek-moe-16b", "jamba-v0.1-52b",
                        "xlstm-1.3b"),
               (2, 2): ("gemma2-2b", "deepseek-moe-16b", "jamba-v0.1-52b",
                        "xlstm-1.3b")}
MODEL_SERVE_ARGV = ["--smoke", "--device", "cpu", "--batch", "4",
                    "--prompt-len", "12", "--gen", "6"]


def case_cfg(name: str):
    arch, over = MODEL_CASES[name]
    return dataclasses.replace(f32(arch), **over)


def record_shares(out: dict, key: str):
    """Forward hooks and wrappers that record, per call, the width of
    the work this rank does: q heads and kv heads attended, MLP hidden
    columns, mamba channels, logits columns, experts run and the rows
    of their table.  Returns the function that removes them."""
    from repro_torch.models import layers, moe, ssm
    from repro_torch.models.layers import Attention, Mlp

    seen = {}

    def note(name, value):
        seen.setdefault(name, set()).add(int(value))

    real = (layers._sdpa, moe._expert_compute, ssm._ssm_scan_chunked,
            M.logits_from_hidden)

    def sdpa(q, k, v, mask, cfg):
        note("q_heads", q.shape[2])
        note("kv_heads", k.shape[2])
        return real[0](q, k, v, mask, cfg)

    def experts(p, xe):
        note("experts", xe.shape[0])
        note("expert_rows", xe.shape[0] * xe.shape[1])
        return real[1](p, xe)

    def scan(dA, dBx, C, h0, chunk):
        note("mamba_channels", dA.shape[2])
        return real[2](dA, dBx, C, h0, chunk)

    def logits(model, hidden):
        lg = real[3](model, hidden)
        note("logit_columns", lg.shape[-1])
        return lg

    hooks = []
    layers._sdpa, moe._expert_compute, ssm._ssm_scan_chunked = \
        sdpa, experts, scan
    M.logits_from_hidden = logits

    def mlp_hook(mod, args, result):
        note("mlp_columns", mod.w_down.shape[0])

    def attn_hook(mod, args, result):
        note("wq_heads", mod.wq.shape[1])

    def install(model):
        for mod in model.modules():
            if isinstance(mod, Mlp):
                hooks.append(mod.register_forward_hook(mlp_hook))
            elif isinstance(mod, Attention):
                hooks.append(mod.register_forward_hook(attn_hook))

    def remove():
        layers._sdpa, moe._expert_compute, ssm._ssm_scan_chunked = real[:3]
        M.logits_from_hidden = real[3]
        for h in hooks:
            h.remove()
        for name, vals in seen.items():
            out[f"{key}/{name}"] = np.asarray(sorted(vals))

    return install, remove


def _model_train(kw: dict, mesh, tag: str, names, rules=None) -> dict:
    """2 steps of each case on its weights and the reference's batches
    under the sharding `rules` (None: the default rules): the metrics,
    the whole parameters after, each rank's share of the work in the
    first forward and its resident bytes."""
    out = {}
    for name in names:
        d = dict(np.load(os.path.join(kw["inputs"], f"case_{name}.npz")))
        cfg = case_cfg(name)
        model = convert.model_from(tree_of(d, "params/"), cfg, device="cpu")
        ocfg = opt.OptConfig(**OPT)
        zero = ts.Zero3(model, mesh, rules)
        state = zero.init_opt_state(ocfg)
        out[f"{tag}/{name}/resident"] = _resident(zero, state)
        step = ts.make_sharded_train_step(cfg, ocfg, zero, HP)
        for i in range(TRAIN_STEPS):
            batch = {k[len(f"batch{i}/"):]: torch.from_numpy(v)
                     for k, v in d.items() if k.startswith(f"batch{i}/")}
            with sh.use_mesh(mesh, rules):
                rows = {k: sh.batch_rows(v) for k, v in batch.items()}
            if i == 0:
                install, remove = record_shares(out, f"{tag}/{name}/share")
                install(model)
            try:
                state, m = step(model, state, rows)
            finally:
                if i == 0:
                    remove()
            for k in ("loss", "xent", "lb_loss", "z_loss", "grad_norm",
                      "tokens"):
                out[f"{tag}/{name}/step{i}/{k}"] = m[k].numpy()
        zero.gather(whole=True)
        for n, p in model.named_parameters():
            out[f"{tag}/{name}/param/{n}"] = p.detach().numpy()
    return out


def _model_forward(kw: dict, mesh, tag: str, names) -> dict:
    """Each case's whole logits of its first batch, each rank computing
    its share."""
    out = {}
    for name in names:
        d = dict(np.load(os.path.join(kw["inputs"], f"case_{name}.npz")))
        model = convert.model_from(tree_of(d, "params/"), case_cfg(name),
                                   device="cpu")
        zero = ts.Zero3(model, mesh)
        zero.gather()
        batch = {k[len("batch0/"):]: torch.from_numpy(v) for k, v in d.items()
                 if k.startswith("batch0/") and k != "batch0/labels"}
        with torch.no_grad(), sh.use_mesh(mesh):
            hidden = M.forward(model, batch)
            out[f"{tag}/{name}/logits"] = M._whole_logits(
                model, hidden).numpy()
    return out


def _model_serve(kw: dict, tag: str, data: int, model_n: int,
                 names) -> dict:
    """`launch.serve` under --mesh-data / --mesh-model on the case's
    f32 weights: the whole batch's greedy tokens."""
    out = {}
    for name in names:
        d = dict(np.load(os.path.join(kw["inputs"], f"case_{name}.npz")))
        model = convert.model_from(tree_of(d, "params/"), case_cfg(name),
                                   device="cpu")
        out[f"{tag}/{name}/serve"] = serve_mod.run(serve_mod.parse_args(
            ["--arch", MODEL_CASES[name][0]] + MODEL_SERVE_ARGV + [
                "--mesh-data", str(data), "--mesh-model", str(model_n)]),
            model=model, log=lambda s: None)
    return out


def _job_model_axis(kw: dict) -> dict:
    out = {}
    world = dist.get_world_size()
    layouts = [(1, 2)] if world == 2 else [(2, 2), (1, 4)]
    for data, model_n in layouts:
        mesh = mesh_mod.make_lm_mesh(data, model_n, device="cpu")
        tag = f"{data}x{model_n}"
        out[f"{tag}/coords"] = np.asarray([mesh.coordinate["data"],
                                           mesh.coordinate["model"]])
        out.update(_model_train(kw, mesh, tag, MODEL_TRAIN[(data, model_n)]))
        out.update(_model_forward(kw, mesh, tag,
                                  MODEL_FORWARD.get((data, model_n), ())))
        out.update(_model_serve(kw, tag, data, model_n,
                                MODEL_SERVE.get((data, model_n), ())))
        if (data, model_n) == (1, 2):
            out.update({f"{tag}/{k}": v for k, v in
                        _int8_update(kw, mesh).items()})
            from repro_torch.launch.dryrun import RULE_PRESETS

            out.update(_model_train(kw, mesh, "1x2zero3", MODEL_ZERO3,
                                    RULE_PRESETS["zero3"]))
    if world == 2:
        out.update(_resume_layouts(kw))
    return out


def _resume_layouts(kw: dict) -> dict:
    """launch.train 2 steps under (1, 2) then to 4 under (2, 1), and
    the other way round, each resuming the other's checkpoint."""
    cfg = resume_cfg()
    out = {}
    for tag, first, second in (("m2d2", "--mesh-model", "--mesh-data"),
                               ("d2m2", "--mesh-data", "--mesh-model")):
        ck = os.path.join(kw["ckpt_root"], tag)
        train_mod.run(train_mod.parse_args(
            RESUME_ARGV + [first, "2", "--steps", "2", "--ckpt-dir", ck]),
            cfg=cfg, log=lambda s: None)
        lines = []
        model, _ = train_mod.run(train_mod.parse_args(
            RESUME_ARGV + [second, "2", "--steps", "4", "--ckpt-dir", ck,
                           "--resume"]), cfg=cfg, log=lines.append)
        out[f"{tag}/lines"] = np.asarray(lines)
        for n, p in model.named_parameters():
            out[f"{tag}/param/{n}"] = p.detach().numpy()
    return out


# the dry run's cells held against a real step: f32 SMOKE configs,
# batch x sequence, launch.dryrun's defaults (fp32 state, loss chunk 512)
DRYRUN_ARCHS = ("gemma2-2b", "deepseek-moe-16b")
DRYRUN_B, DRYRUN_S = 4, 32


def _counted_step(arch: str, mesh, b: int) -> tuple:
    """One sharded train step of `arch` (f32 SMOKE, seed-0 weights,
    make_batch's batch 0 of b rows) under the dry run's counters:
    (its record, its metrics)."""
    from repro_torch.launch import dryrun

    cfg = f32(arch)
    model = M.init_model(cfg, 0, device="cpu")
    zero = ts.Zero3(model, mesh)
    ocfg = opt.OptConfig()
    state = zero.init_opt_state(ocfg)
    batch = tok.make_batch(cfg, tok.DataConfig(), 0, b, DRYRUN_S,
                           device="cpu")
    with sh.use_mesh(mesh):
        rows = {k: sh.batch_rows(v) for k, v in batch.items()}
    step = ts.make_sharded_train_step(cfg, ocfg, zero, ts.TrainHParams())
    counter = dryrun.StepCounter([list(zero.shards.values()), state, rows])
    with counter:
        state, metrics = step(model, state, rows)
    return counter.record((state, metrics)), metrics


def _job_dryrun(kw: dict) -> dict:
    world = dist.get_world_size()
    data, model_n = (1, 2) if world == 2 else (2, 2)
    mesh = mesh_mod.make_lm_mesh(data, model_n, device="cpu")
    out = {}
    for arch in DRYRUN_ARCHS:
        rec, _ = _counted_step(arch, mesh, DRYRUN_B)
        out[f"{arch}/flops"] = np.asarray(rec["cost"]["flops"])
        for op, n in rec["collectives"]["counts"].items():
            out[f"{arch}/count/{op}"] = np.asarray(n)
            out[f"{arch}/bytes/{op}"] = np.asarray(
                rec["collectives"]["bytes_by_op"][op])
    if data > 1:
        _, m = _counted_step("gemma2-2b", mesh, 1)
        out["one_row/xent"] = m["xent"].numpy()
        out["one_row/tokens"] = m["tokens"].numpy()
    return out


JOBS = dict(compress=_job_compress, pipeline=_job_pipeline,
            elastic=_job_elastic, train=_job_train,
            model_axis=_job_model_axis, dryrun=_job_dryrun)


def _entry(rank: int, world: int, port: int, job: str, outdir: str,
           kw: dict) -> None:
    torch.set_num_threads(1)
    mesh_mod.init_process_mesh(device="cpu",
                               init_method=f"tcp://127.0.0.1:{port}",
                               rank=rank, world_size=world)
    try:
        out = JOBS[job](kw)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, outdir: str, timeout: float = 300,
          **kw) -> list[dict]:
    """Run `job` on `world` gloo ranks; each rank's outputs, in rank
    order.  The ranks are killed, and TimeoutError raised, if they have
    not all ended within `timeout` seconds."""
    import time

    ctx = mp.spawn(_entry, args=(world, free_port(), job, outdir, kw),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{job} on {world} ranks: not done in "
                               f"{timeout} s")
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(world)]
