"""The port's checkpointing (`repro_torch.checkpoint.checkpoint`) against
the JAX package's (`repro.checkpoint.checkpoint`): the four non-slow
tests of `tests/test_checkpoint.py` on the port (a bf16 leaf round trip,
`latest` and the gc, a torn write, a shape mismatch), and the files,
the npz entries and the meta keys of one step equal to JAX's for the
same tree."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro_torch.checkpoint import checkpoint as ckpt


def _tree(rng):
    return {
        "params": {"w": torch.from_numpy(
            rng.standard_normal((8, 16)).astype(np.float32)),
            "b": torch.zeros(16, dtype=torch.bfloat16)},
        "opt": {"count": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return list(ckpt._leaves(tree))


def test_save_restore_roundtrip(tmp_path, rng):
    tree = _tree(rng)
    tree["params"]["b"] = torch.linspace(-3, 3, 16).to(torch.bfloat16)
    d = ckpt.save(str(tmp_path), 10, tree, extra={"arch": "x"})
    assert ckpt.verify(d)
    restored = ckpt.restore(d, tree)
    for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(restored)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), pa
    meta = ckpt.load_meta(d)
    assert meta["step"] == 10 and meta["arch"] == "x"


def test_restore_onto_another_device(tmp_path, rng):
    """`device=` places every restored leaf there."""
    tree = _tree(rng)
    d = ckpt.save(str(tmp_path), 1, tree)
    restored = ckpt.restore(d, tree, device="cpu")
    assert all(t.device.type == "cpu" for _, t in _leaves(restored))


def test_latest_and_gc(tmp_path, rng):
    tree = _tree(rng)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep_last=3)
    latest = ckpt.latest_step_dir(str(tmp_path))
    assert latest.endswith("step_00000005")
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None


def test_corruption_detected(tmp_path, rng):
    tree = _tree(rng)
    d = ckpt.save(str(tmp_path), 1, tree)
    with open(os.path.join(d, "arrays.npz"), "r+b") as f:
        f.seek(50)
        f.write(b"\xde\xad")
    assert not ckpt.verify(d)
    with pytest.raises(IOError):
        ckpt.restore(d, tree)


def test_shape_mismatch_rejected(tmp_path, rng):
    tree = _tree(rng)
    d = ckpt.save(str(tmp_path), 1, tree)
    bad = dict(tree)
    bad["params"] = {"w": torch.zeros(4, 4), "b": tree["params"]["b"]}
    with pytest.raises(ValueError):
        ckpt.restore(d, bad)


def test_layout_equals_reference(tmp_path, rng):
    """One step of the same tree written by both packages: the same
    files, the same `latest`, the same npz entries with the same
    dtypes and values (bf16 widened to f32), the same meta keys and leaf
    list; each package restores the other's step."""
    tree = _tree(rng)
    tree["params"]["b"] = torch.linspace(-1, 1, 16).to(torch.bfloat16)
    jtree = {"params": {"w": jnp.asarray(tree["params"]["w"].numpy()),
                        "b": jnp.asarray(np.linspace(-1, 1, 16),
                                         jnp.bfloat16)},
             "opt": {"count": jnp.int32(7)}}
    d = ckpt.save(str(tmp_path / "port"), 3, tree, extra={"arch": "x"})
    jd = jckpt.save(str(tmp_path / "jax"), 3, jtree, extra={"arch": "x"})
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert os.path.basename(d) == os.path.basename(jd)
    with np.load(os.path.join(d, "arrays.npz")) as a, \
            np.load(os.path.join(jd, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jd, "meta.json")) as f:
        jmeta = json.load(f)
    assert set(meta) == set(jmeta) and meta["leaves"] == jmeta["leaves"]
    # each restores the other's
    got = ckpt.restore(jd, tree)
    assert torch.equal(got["params"]["b"], tree["params"]["b"])
    jgot = jckpt.restore(d, jtree)
    np.testing.assert_array_equal(np.asarray(jgot["params"]["w"]),
                                  tree["params"]["w"].numpy())
