"""The port's training driver (`python -m repro_torch.launch.train`):
`tests/test_system.py::test_train_driver_with_restart` on the port (4
steps with checkpoints, stop, `--resume` to 6), whose step-6 parameters
and optimizer state equal a straight 6-step run's bit for bit; the
printed lines; the mesh flags refused outside a process group.  On the
CPU."""

from __future__ import annotations

import os

import numpy as np
import pytest

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import train as train_mod
from torch_train_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
        "--batch", "2", "--seq", "32", "--ckpt-every", "2",
        "--log-every", "2"]


def test_train_driver_with_restart(tmp_path, capsys):
    resumed, straight = str(tmp_path / "ck"), str(tmp_path / "straight")
    train_mod.main(ARGS + ["--steps", "4", "--ckpt-dir", resumed])
    out = capsys.readouterr().out
    assert "[step     0] xent=" in out and "[step     3] xent=" in out
    assert f"[ckpt] wrote {os.path.join(resumed, 'step_00000004')}" in out
    assert out.rstrip().endswith("[done]")
    train_mod.main(ARGS + ["--steps", "6", "--ckpt-dir", resumed,
                           "--resume"])
    out = capsys.readouterr().out
    step4 = os.path.join(resumed, "step_00000004")
    assert out.startswith(f"[resume] restoring {step4} (step 4)")
    assert "[step     0]" not in out and "[step     5] xent=" in out
    latest = ckpt.latest_step_dir(resumed)
    assert ckpt.load_meta(latest)["step"] == 6
    assert ckpt.load_meta(latest)["arch"] == "starcoder2-7b"

    train_mod.main(ARGS + ["--steps", "6", "--ckpt-dir", straight])
    capsys.readouterr()
    with np.load(os.path.join(latest, "arrays.npz")) as a, \
            np.load(os.path.join(straight, "step_00000006",
                                 "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("params/") for k in a.files)
        assert "opt/count" in a.files and int(a["opt/count"]) == 6
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_without_checkpoint_starts_at_zero(tmp_path, capsys):
    train_mod.main(ARGS + ["--steps", "1", "--ckpt-dir", str(tmp_path),
                           "--resume"])
    out = capsys.readouterr().out
    assert "[resume]" not in out and "[step     0] xent=" in out


@pytest.mark.parametrize("flag", ["--mesh-data", "--mesh-model"])
def test_mesh_flags_refused(flag):
    """Either axis needs a process group of that many ranks (torchrun),
    which one process is not."""
    with pytest.raises(RuntimeError, match="torchrun"):
        train_mod.main(ARGS + ["--steps", "1", flag, "2"])
