"""Fault-tolerant checkpointing of a tree of tensors.

The port of `repro.checkpoint.checkpoint`, with its on-disk layout: one
directory per step,
    step_<N>/
      meta.json       (step, wall time, leaf paths, the caller's extras)
      arrays.npz      (leaf path -> ndarray)
      CHECKSUM        (sha256 of arrays.npz: torn-write detection)
A tree is a nested dict of tensors, e.g. `{"params": model.state_dict(),
"opt": opt_state}`; a leaf's path joins its keys with "/".  bf16 leaves
are widened to f32 on save (npz has no bf16; lossless) and cast back to
the template's dtype on restore.  Writes are atomic: the step goes to a
`.tmp` directory that is renamed into place, and only then is `latest`
re-pointed (`os.replace`), so a crash mid-write never corrupts the
restore path.  `keep_last` bounds the steps kept.

Sharded trees: under a process group, a leaf may be a DTensor (a rank's
shard of a parameter or of its state); `save` gathers each such leaf
in turn, on every rank, rank 0 writes the whole array in the same
layout, and the other ranks wait for it.  Elastic restore, as the
reference's: `restore(..., shardings=)` gives each leaf back as this
rank's shard under the placements of the *current* mesh, whatever
mesh wrote it, read from the memory-mapped file (only the shard's
bytes are read).  A leaf split over the model axis is one such DTensor
like any other, so a run resumes across a change of (data, model).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import sharding as sh


def _leaves(tree, prefix=""):
    """(path, tensor) pairs in the tree's order, paths joined by '/'."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + "/")
        else:
            yield path, val


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor, on its device (a DTensor gathered: collective,
    every rank calls it)."""
    t = t.detach()
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _host(t: torch.Tensor) -> np.ndarray:
    """A whole tensor's array on the host (bf16 widened to f32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


class _HashingWriter(io.RawIOBase):
    """An append-only file that hashes what it writes.  Not seekable, so
    `zipfile` streams each entry with a data descriptor instead of
    seeking back to its header: the bytes hashed are the file's."""

    def __init__(self, f):
        self.f, self.sha256, self.n = f, hashlib.sha256(), 0

    def writable(self):
        return True

    def seekable(self):
        return False

    def write(self, b):
        self.sha256.update(b)
        self.n += len(b)
        return self.f.write(b)

    def tell(self):
        return self.n


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep_last: int = 3) -> str:
    """Write `tree` as step `step`; returns the step's directory.  Under
    a process group every rank calls it (DTensor leaves are gathered
    leaf by leaf), rank 0 writes, and all return once the step is
    durable."""
    writer = not dist.is_initialized() or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    names = []
    npz_path = os.path.join(tmp, "arrays.npz")
    # `np.savez`'s archive, written one leaf at a time so that only one
    # leaf is on the host at once, and hashed as it is written
    with contextlib.ExitStack() as stack:
        zf = None
        if writer:
            out = _HashingWriter(stack.enter_context(open(npz_path, "wb")))
            zf = stack.enter_context(zipfile.ZipFile(
                out, mode="w", compression=zipfile.ZIP_STORED,
                allowZip64=True))
        for path, t in _leaves(tree):
            names.append(path)
            t = _whole(t)
            if zf is not None:   # only the writer copies it to the host
                with zf.open(path + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _host(t),
                                              allow_pickle=False)
            del t
    if writer:
        with open(os.path.join(tmp, "CHECKSUM"), "w") as f:
            f.write(out.sha256.hexdigest())
        meta = {"step": step, "time": time.time(), "leaves": sorted(names),
                **(extra or {})}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(ckpt_dir, "latest.tmp"),
                   os.path.join(ckpt_dir, "latest"))
        _gc(ckpt_dir, keep_last)
    if dist.is_initialized():
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step_dir(ckpt_dir: str) -> str | None:
    marker = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    return path if os.path.exists(path) else None


def verify(step_dir: str) -> bool:
    with open(os.path.join(step_dir, "CHECKSUM")) as f:
        want = f.read().strip()
    return want == _sha256(os.path.join(step_dir, "arrays.npz"))


def restore(step_dir: str, template, device=None, shardings=None):
    """A tree like `template` (nested dicts of tensors; only their
    shapes and dtypes are read) holding the step's arrays, each in its
    template leaf's dtype, on `device` (by default each template leaf's
    device).  `shardings`: a tree of the same structure whose leaves are
    `models.sharding.NamedSharding`s (or None): such a leaf comes back
    as a DTensor holding this rank's shard under the sharding's
    placements, on the mesh's device unless `device` says otherwise.
    Raises IOError on a checksum mismatch and ValueError on a shape
    mismatch."""
    if not verify(step_dir):
        raise IOError(f"checksum mismatch in {step_dir}")
    data = _stored_arrays(os.path.join(step_dir, "arrays.npz"))

    def build(tree, shard_tree, prefix=""):
        out = {}
        for key, leaf in tree.items():
            path = f"{prefix}{key}"
            shard = None if shard_tree is None else shard_tree[key]
            if isinstance(leaf, dict):
                out[key] = build(leaf, shard, path + "/")
                continue
            arr = data(path)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {path}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            if shard is not None:
                arr = arr[sh.local_slices(shard.mesh, shard.spec,
                                          arr.shape)]
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            if device is not None:
                dev = torch.device(device)
            else:
                dev = leaf.device if shard is None else shard.mesh.device
            # a copy: the leaf never aliases the file's mapping
            t = torch.from_numpy(arr).to(dev, copy=True).to(leaf.dtype)
            if shard is not None:
                t = sh.as_dtensor(t, shard, tuple(leaf.shape))
            out[key] = t
        return out

    return build(template, shardings)


def _stored_arrays(npz_path: str):
    """name -> a memory map of that npz entry's array.  The
    entries are stored uncompressed, so each array lies in the file as
    its .npy body; mapping it skips the zip's CRC pass and a copy (the
    sha256 of the whole file, checked first, covers the bytes)."""
    with zipfile.ZipFile(npz_path) as zf:
        infos = {i.filename: i for i in zf.infolist()}

    def load(name):
        info = infos.get(name + ".npy")
        if info is None:
            raise KeyError(f"{name} is not in {npz_path}")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{name}: a compressed entry; save writes "
                             f"every entry stored")
        with open(npz_path, "rb") as f:
            f.seek(info.header_offset)
            local = f.read(30)   # the local file header's fixed part
            n_name = int.from_bytes(local[26:28], "little")
            n_extra = int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
            if 0 in shape or dtype.hasobject:
                raise ValueError(f"{name}: an empty or object array")
            if not shape:   # a 0-d leaf (the step count)
                return np.fromfile(f, dtype=dtype, count=1).reshape(())
        # copy-on-write: writable for torch, the file never written
        return np.memmap(npz_path, dtype=dtype, mode="c", offset=offset,
                         shape=shape, order="F" if fortran else "C")

    return load


def load_meta(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "meta.json")) as f:
        return json.load(f)
