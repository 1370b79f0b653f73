"""Carry state across from the JAX package.

The port's counterpart of loading weights: hyperplanes, a bucket store,
a dense or sparse corpus, an LM's parameter tree and its optimizer
state built by `repro` (JAX arrays, or numpy arrays in the same layout)
become the port's objects, so both packages compute on the same state;
`leaves_by_name` maps any tree shaped as the reference's params (its
gradients too) onto the port's parameter names.  Nothing here imports
JAX: `np.asarray` reads a JAX array without it.  uint32 codes and words
become int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.corpus import DenseCorpus, SparseCorpus
from repro_torch.core.store import BucketStore
from repro_torch.models.config import ModelConfig
from repro_torch.models import sharding as sh
from repro_torch.models.model import STATE_FIELDS, Model


def _tensor(x, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def hyperplanes_from(h, *, device=None) -> torch.Tensor:
    """Hyperplanes [L, k, d] -> f32 tensor."""
    return _tensor(h, resolve_device(device)).float()


def store_from(store, *, device=None) -> BucketStore:
    """A store with attributes ids, timestamps, write_ptr, payload (f32
    vectors, uint32 words or None) and generation -> `BucketStore`."""
    dev = resolve_device(device)
    payload = None if store.payload is None else _tensor(store.payload, dev)
    gen = getattr(store, "generation", 0)
    return BucketStore(
        ids=_tensor(store.ids, dev).to(torch.int32),
        timestamps=_tensor(store.timestamps, dev).to(torch.int32),
        write_ptr=_tensor(store.write_ptr, dev).to(torch.int32),
        payload=payload,
        generation=torch.tensor(int(np.asarray(gen)), dtype=torch.int32,
                                device=dev),
    )


def corpus_from(vectors, *, device=None) -> DenseCorpus:
    """Unit rows [n, d] (or a DenseCorpus-like with `.vectors`) ->
    `DenseCorpus`."""
    vectors = getattr(vectors, "vectors", vectors)
    return DenseCorpus(_tensor(vectors, resolve_device(device)).float())


def sparse_corpus_from(c=None, *, nnz_ids=None, nnz_vals=None, d=None,
                       device=None) -> SparseCorpus:
    """A SparseCorpus-like `c` (attributes nnz_ids, nnz_vals, d), or numpy
    `nnz_ids` int32 / `nnz_vals` f32 [n, nnz_max] and `d` ->
    `SparseCorpus`."""
    if c is not None:
        nnz_ids, nnz_vals, d = c.nnz_ids, c.nnz_vals, c.d
    dev = resolve_device(device)
    return SparseCorpus(_tensor(nnz_ids, dev).to(torch.int32),
                        _tensor(nnz_vals, dev).float(), d=int(d))


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, paths joined with '.'."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + ".")
        else:
            yield path, val


def _layer_leaves(blocks, n_layers: int, period: int, prefix: str):
    """The reference stacks sub-layer j of every period on a leading
    [num_periods] axis (`blocks/sub{j}/...`); layer i is period
    i // period, sub i % period."""
    for i in range(n_layers):
        sub = blocks[f"sub{i % period}"]
        for path, leaf in _leaves(sub):
            yield f"{prefix}.{i}.{path}", np.asarray(leaf)[i // period]


def _reference_leaves(tree, cfg: ModelConfig) -> dict:
    """{reference name: numpy leaf} of a tree shaped as the reference's
    params, each layer's leaves taken out of their [num_periods] stack."""
    src = dict(_layer_leaves(tree["blocks"], cfg.num_layers,
                             cfg.scan_period, "blocks"))
    if cfg.encoder_layers:
        src.update(_layer_leaves(tree["encoder"]["blocks"],
                                 cfg.encoder_layers, 1, "encoder"))
    for key in ("embed", "lm_head", "prefix_proj", "final_norm",
                "enc_norm"):
        if key in tree:
            src[key] = np.asarray(tree[key])
    return src


def leaves_by_name(tree, model: Model) -> dict:
    """The name map: a tree shaped as the reference's LM params (its
    params, its gradients, or one moment of its optimizer state; JAX or
    numpy arrays) -> {the port's parameter name: numpy array}, the
    [num_periods] stacking undone.  Norms are leaves in the reference
    and `RmsNorm` modules here (`<name>.weight`)."""
    names = dict(model.named_parameters())
    out = {}
    for name, leaf in _reference_leaves(tree, model.cfg).items():
        key = name if name in names else name + ".weight"
        if key not in names:
            raise ValueError(f"{name}: no such parameter in the port")
        out[key] = leaf
    if len(out) != len(names):
        raise ValueError(f"{len(out)} leaves for {len(names)} parameters")
    return out


def _f32(leaf) -> torch.Tensor:
    """bf16 leaves (ml_dtypes numpy arrays, which `torch.from_numpy`
    refuses) travel through f32, exact both ways."""
    return torch.from_numpy(np.array(leaf, np.float32))


def model_from(params, cfg: ModelConfig, *, device=None) -> Model:
    """The reference's LM parameter tree (`repro.models.model.init_model`'s
    params, as JAX or numpy arrays) -> the port's `Model` holding the
    same values."""
    model = Model(cfg, device=device)
    state = model.state_dict()
    for name, leaf in leaves_by_name(params, model).items():
        if tuple(leaf.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: shape {leaf.shape} != "
                             f"{tuple(state[name].shape)}")
        state[name].copy_(_f32(leaf))
    return model


_MOMENTS = (("m", "v"), ("m_q", "m_s", "v_q", "v_s"))


def _moment(tree, key: str):
    """The reference's `mu` tree with each parameter's moment dict
    replaced by its entry `key`."""
    if set(tree) in [set(k) for k in _MOMENTS]:
        return tree[key]
    return {k: _moment(v, key) for k, v in tree.items()}


def opt_state_from(state, model: Model) -> dict:
    """The reference's optimizer state (`repro.train.optimizer.
    init_opt_state` / `apply_updates`', fp32 or int8, as JAX or numpy
    arrays) -> the port's: {"count": int32, "mu": {parameter name:
    {"m", "v"} f32 | {"m_q", "m_s", "v_q", "v_s"}}} on the model's
    device."""
    dev = model.device
    mu = state["mu"]
    first = mu["embed"]
    keys = next(k for k in _MOMENTS if set(first) == set(k))
    by_key = {k: leaves_by_name(_moment(mu, k), model) for k in keys}
    out = {name: {} for name in by_key[keys[0]]}
    for k, leaves in by_key.items():
        for name, leaf in leaves.items():
            a = np.asarray(leaf)
            t = (torch.from_numpy(np.array(a)) if a.dtype == np.int8
                 else _f32(a))
            out[name][k] = t.to(dev)
    count = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                         device=dev)
    return {"count": count, "mu": out}


def decode_states_from(states, cfg: ModelConfig, *, device=None) -> list:
    """The reference's decode states (`repro.models.model.prefill`'s, as
    JAX or numpy arrays: `{"sub{j}": {...}}`, each leaf stacked on a
    leading [num_periods] axis) -> the port's list of per-layer dicts.
    Attention keeps `k` / `v` (and `xk` / `xv`); a recurrent layer's
    `s0`, `s1`, ... (its state tuple, read back in sorted order) become
    the port's named fields (`model.STATE_FIELDS`); mamba's `h` / `conv`
    keep their names.  Leaves keep their dtypes (bf16 through f32)."""
    dev = resolve_device(device)

    def leaf(x, p):
        a = np.asarray(x)[p]
        t = torch.from_numpy(np.array(a, np.float32))
        if str(a.dtype) == "bfloat16":
            t = t.to(torch.bfloat16)
        return t.to(dev)

    out = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        sub = states[f"sub{i % cfg.scan_period}"]
        p = i // cfg.scan_period
        if kind in ("mlstm", "slstm"):
            vals = [sub[k] for k in sorted(sub)]
            out.append({f: leaf(v, p)
                        for f, v in zip(STATE_FIELDS[kind], vals)})
        else:
            out.append({k: leaf(v, p) for k, v in sub.items()})
    return out


def decode_states_for_rank(states: list, cfg: ModelConfig) -> list:
    """Whole decode states (`decode_states_from`'s, or one device's
    `models.model.prefill`'s) cut to this rank's share under the current
    mesh (`sharding.use_mesh`, the default rules), as `prefill` lays
    them out there: each cache by `sharding.cache_spec`, with its
    `LengthSplit` where the length splits; each recurrent state by
    `sharding.state_spec`, with an xLSTM layer's `HeadDimSplit` where its
    heads are not over `model`.  Each leaf is `sharding.local_slices`'
    shard, in storage of its own; outside a mesh the states as given."""
    mesh = sh.current_mesh()
    if mesh is None:
        return states
    out = []
    for i, st in enumerate(states):
        kind = cfg.layer_kind(i)
        new = {}
        for f, t in st.items():
            shape = tuple(t.shape)
            spec = (sh.cache_spec(shape) if kind == "attn" else
                    sh.state_spec(kind, f, shape))
            new[f] = t[sh.local_slices(mesh, spec, shape)].clone()
        for pre in ("", "x") if kind == "attn" else ():
            if pre + "k" in st:
                split = sh.length_split(tuple(st[pre + "k"].shape))
                if split is not None:
                    new[pre + "kv_split"] = split
        if kind in ("mlstm", "slstm"):
            split = sh.head_dim_split(kind, tuple(
                st["C" if kind == "mlstm" else "c"].shape))
            if split is not None:
                new["dh_split"] = split
        out.append(new)
    return out

