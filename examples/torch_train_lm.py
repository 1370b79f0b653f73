"""End-to-end training example (the PyTorch port's): train a reduced
configured architecture for a few hundred steps with fault-tolerant
checkpointing, stop as a preemption would, then resume from the
checkpoint.  The port of `examples/train_lm.py`; it prints the same
phases, and the training CLI's `[resume]` line when the second phase starts
(a checkpoint is written every 25 steps, so `--steps` of 50 or more).

    PYTHONPATH=src python examples/torch_train_lm.py             # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 50
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import train as train_mod   # noqa: E402


def _argv(arch: str, steps: int, ckpt: str, device: str | None) -> list:
    argv = ["--arch", arch, "--smoke", "--steps", str(steps),
            "--batch", "8", "--seq", "128", "--lr", "1e-3",
            "--ckpt-dir", ckpt, "--ckpt-every", "25", "--log-every", "20"]
    return argv + (["--device", device] if device else [])


def run(device=None, arch: str = "gemma2-2b", steps: int = 200,
        log=print) -> dict:
    """Both phases; returns the resumed run's model and optimizer state
    and the lines the driver printed."""
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    lines = []

    def say(s):
        lines.append(s)
        log(s)

    try:
        half = steps // 2
        say(f"=== phase 1: steps 0..{half} (then simulated preemption) ===")
        train_mod.run(train_mod.parse_args(_argv(arch, half, ckpt, device)),
                      log=say)
        say(f"=== phase 2: resume from checkpoint to {steps} ===")
        model, opt_state = train_mod.run(train_mod.parse_args(
            _argv(arch, steps, ckpt, device) + ["--resume"]), log=say)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"model": model, "opt_state": opt_state, "lines": lines}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device, arch=args.arch, steps=args.steps,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
