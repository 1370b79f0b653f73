"""End-to-end training driver, on one device or data-parallel over
processes.

The port of `repro.launch.train`:

    ck=$(mktemp -d)   # once; a rerun with --resume continues from it
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir "$ck" --resume

Fault tolerance, as the reference's:
  * step-tagged atomic checkpoints (params + optimizer state + the data
    seed), every `--ckpt-every` steps;
  * `--resume` restarts from the latest verified checkpoint;
  * the data is a pure function of (seed, step), so after a restart
    batch `step` is bit-identical, and a resumed run's parameters equal
    a straight run's.
The host reads the loss and the gradient norm only at log steps.

Parameters and optimizer state are held by `train_step.Zero3`, which
splits nothing on one device.  `--mesh-data D` trains data-parallel over
D processes: each rank takes its rows of every global batch, and the
parameters and optimizer state are stored as the sharding rules place
them (ZeRO-3 over `data`).  `--mesh-model M` adds tensor and expert
parallelism over M processes a data row: each holds and computes its
share of the heads, d_ff, d_inner, vocab and experts.  Checkpoints keep
the one-device layout, so `--resume` works across a change of (D, M).
Under torchrun, D x M processes (gloo with `--device cpu`, NCCL on
cards):

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --device cpu --mesh-data 2 --mesh-model 2 --steps 4 \\
        --batch 4 --seq 32
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import tokens as data_tokens
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Tracer
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--opt-state", default="fp32", choices=("fp32", "int8"))
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg: ModelConfig | None = None,
        log=print):
    """Train per `args` (from `parse_args`); `cfg` replaces the arch's
    config (e.g. one cut in depth).  Returns (model, optimizer state).
    On a mesh (`--mesh-data` or `--mesh-model` > 1, or any initialised
    process group) every rank calls it and gets the whole model and
    state back; rank 0 logs."""
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    mesh, dev, log = mesh_mod.cli_mesh(args, log)
    ocfg = opt_mod.OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                             decay_steps=args.steps,
                             state_dtype=args.opt_state)
    hp = ts.TrainHParams(loss_chunk=min(512, args.seq))
    dcfg = data_tokens.DataConfig(seed=args.seed)

    model = M.init_model(cfg, args.seed, device=dev)
    zero = ts.Zero3(model, mesh)   # mesh None: one device, nothing split
    opt_state = zero.init_opt_state(ocfg)
    step_fn = ts.make_sharded_train_step(cfg, ocfg, zero, hp)
    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt.latest_step_dir(args.ckpt_dir)
        if latest:
            meta = ckpt.load_meta(latest)
            log(f"[resume] restoring {latest} (step {meta['step']})")
            tmpl, shard = zero.checkpoint_template(ocfg)
            opt_state = zero.load(ckpt.restore(latest, tmpl, device=dev,
                                               shardings=shard))
            start_step = int(meta["step"])

    tracer = Tracer()
    with tracer.span("train/run", cat="train", arch=args.arch) as run_sp:
        for step in range(start_step, args.steps):
            batch = data_tokens.make_batch(cfg, dcfg, step, args.batch,
                                           args.seq, device=dev)
            with sh.use_mesh(mesh):
                batch = {k: sh.batch_rows(v) for k, v in batch.items()}
            opt_state, metrics = step_fn(model, opt_state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["xent"])
                gn = float(metrics["grad_norm"])
                log(f"[step {step:5d}] xent={loss:.4f} gnorm={gn:.2f} "
                    f"({run_sp.elapsed_s:.1f}s)")
                if not np.isfinite(loss):
                    raise RuntimeError(f"loss diverged at step {step}")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                tree = zero.checkpoint_tree(opt_state, ocfg)
                path = ckpt.save(args.ckpt_dir, step + 1, tree,
                                 extra={"arch": args.arch,
                                        "data_seed": args.seed})
                del tree
                log(f"[ckpt] wrote {path}")
    zero.gather(whole=True)
    opt_state = zero.full_state(opt_state, ocfg)
    log("[done]")
    return model, opt_state


def main(argv=None):
    args = parse_args(argv)
    with mesh_mod.torchrun_group(args.device):
        run(args, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
