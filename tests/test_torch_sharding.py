"""`repro_torch.models.sharding` against `repro.models.sharding`.

Every parameter of the ten configured architectures, at full width, and
its optimizer state (fp32 for all ten, int8 for the reference's
`INT8_OPT_ARCHS`), resolved by both packages under the meshes (1, 1),
(2, 1), (4, 2), (16, 16) and (2, 16, 16) and the dry run's three rule
presets: each spec equal entry for entry.  The reference resolves on a
JAX `AbstractMesh` (no devices needed) over shapes from `jax.eval_shape`;
the port on a stand-in that has only `.shape`, over the shapes of a
model built on the meta device.  The reference stacks each layer's
leaves on a leading `layers` axis, which no preset maps: its entry is
dropped before the comparison.
"""

from __future__ import annotations

import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.launch.dryrun import INT8_OPT_ARCHS, RULE_PRESETS
from repro.models import model as JM
from repro.models import sharding as jsh
from repro.train import optimizer as jopt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.train import optimizer as opt

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x1": (("data", "model"), (2, 1)),
    "4x2": (("data", "model"), (4, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


def ref_path(name: str, cfg) -> tuple:
    """A port parameter name -> (its path in the reference's tree,
    whether the leaf is stacked on the `layers` axis)."""
    parts = name.split(".")
    if parts[-1] == "weight":          # an RmsNorm: a leaf there
        parts = parts[:-1]
    if parts[0] == "blocks":
        sub = f"sub{int(parts[1]) % cfg.scan_period}"
        return ("blocks", sub, *parts[2:]), True
    if parts[0] == "encoder":
        return ("encoder", "blocks", "sub0", *parts[2:]), True
    return tuple(parts), False


def get_in(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def reference():
    """arch -> (param specs, param shapes, {state dtype: (state specs,
    state shapes)}), the reference's, shapes abstract."""
    out = {}
    for arch in ARCH_NAMES:
        cfg = j_get_config(arch)
        box = {}

        def init(cfg=cfg, box=box):
            p, s = JM.init_model(cfg, 0)
            box["specs"] = s
            return p

        shapes = jax.eval_shape(init)
        states = {}
        for dt in ("fp32", "int8") if arch in INT8_OPT_ARCHS else ("fp32",):
            ocfg = jopt.OptConfig(state_dtype=dt)
            states[dt] = (jopt.opt_state_specs(box["specs"], ocfg),
                          jax.eval_shape(lambda p, o=ocfg:
                                         jopt.init_opt_state(p, o), shapes))
        out[arch] = (box["specs"], shapes, states)
    return out


@pytest.fixture(scope="module")
def port_models():
    return {arch: M.Model(get_config(arch), device="meta")
            for arch in ARCH_NAMES}


def ref_spec(sharding, stacked: bool) -> tuple:
    spec = tuple(sharding.spec)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


@pytest.mark.parametrize("preset", list(RULE_PRESETS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_the_reference(reference, port_models, arch, mesh_name,
                                   preset):
    names, sizes = MESHES[mesh_name]
    rules = RULE_PRESETS[preset]
    jmesh = AbstractMesh(sizes, names)
    mesh = types.SimpleNamespace(shape=dict(zip(names, sizes)))
    cfg = get_config(arch)
    model = port_models[arch]
    specs, shapes, states = reference[arch]

    jshard = jsh.spec_tree_to_shardings(jmesh, specs, shapes, rules)
    pspecs = M.param_specs(model)
    pshapes = {n: p for n, p in model.named_parameters()}
    pshard = sh.spec_tree_to_shardings(mesh, pspecs, pshapes, rules)
    for name, p in pshapes.items():
        path, stacked = ref_path(name, cfg)
        want = ref_spec(get_in(jshard, path), stacked)
        assert pshard[name].spec == want, (name, pshard[name].spec, want)
        # the same axes unresolved, and without shapes
        assert pspecs[name] == tuple(get_in(specs, path))[int(stacked):]

    for dt, (jspecs, jshapes) in states.items():
        ocfg = opt.OptConfig(state_dtype=dt)
        jst = jsh.spec_tree_to_shardings(jmesh, jspecs, jshapes, rules)
        ospecs = opt.opt_state_specs(pspecs, ocfg)
        oshapes = {"count": torch.empty((), device="meta"), "mu": {
            n: {k: torch.empty(s, device="meta") for k, s in
                opt.state_shapes(p.shape, ocfg).items()}
            for n, p in pshapes.items()}}
        ost = sh.spec_tree_to_shardings(mesh, ospecs, oshapes, rules)
        assert ost["count"].spec == tuple(jst["count"].spec) == ()
        for name in pshapes:
            path, stacked = ref_path(name, cfg)
            jleaf = get_in(jst["mu"], path)
            for key, s in ost["mu"][name].items():
                want = ref_spec(jleaf[key], stacked)
                assert s.spec == want, (dt, name, key, s.spec, want)
                shape = tuple(get_in(jshapes["mu"], path)[key].shape)
                assert tuple(oshapes["mu"][name][key].shape) == \
                    shape[int(stacked):]


def test_axis_size_and_context():
    assert sh.axis_size("data") == 1 and sh.current_mesh() is None
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 4, "model": 8})
    with sh.use_mesh(mesh, {"d_model": "model"}):
        assert sh.current_mesh() is mesh
        assert (sh.axis_size("pod"), sh.axis_size("data"),
                sh.axis_size("model"), sh.axis_size("stage")) == (2, 4, 8, 1)
        assert sh.logical_spec(("batch", "seq", "d_model")) == \
            (("pod", "data"), None, "model")
        # an axis already used by an earlier dim is dropped
        assert sh.logical_spec(("fsdp", "batch")) == ("data", "pod")
        assert sh.named_sharding("vocab", "fsdp").spec == ("model", "data")
    assert sh.current_mesh() is None and sh.named_sharding("fsdp") is None


def test_constrain_outside_a_mesh_and_on_plain_tensors():
    x = torch.arange(6.0).reshape(2, 3)
    assert sh.constrain(x, "batch", "d_model") is x
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1})
    with sh.use_mesh(mesh):
        assert sh.constrain(x, "batch", "d_model") is x


def test_local_slices_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 1},
                                 coordinate={"pod": 1, "data": 0, "model": 0})
    spec = (("pod", "data"), "model", None)
    assert sh.placements(mesh, spec) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(mesh, (None, "data")) == (Replicate(), Shard(1),
                                                   Replicate())
    # chunk (pod, data) = (1, 0) of 4 along dim 0; model of size 1 whole
    assert sh.local_slices(mesh, spec, (8, 3, 5)) == (slice(4, 6),
                                                      slice(None),
                                                      slice(None))
    assert sh.local_shape(mesh, spec, (8, 3, 5)) == (2, 3, 5)
    with pytest.raises(ValueError):
        sh.placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError):
        sh.local_slices(mesh, spec, (6, 3, 5))
