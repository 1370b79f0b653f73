"""Build the CUDA kernels and load them with ctypes.

Each source `csrc/<name>.cu` has a plain C interface (no PyTorch
headers) and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into `kernels/build/` (listed in .gitignore), at first use.  The file
name carries a hash of the source, so an edited source rebuilds and an
unchanged one loads what an earlier process built.  `build_all` starts
one nvcc per source at once.

Importing this module needs no nvcc: the CPU tests import it.  Every C
entry point takes its pointers and the stream as `void*` and returns
`cudaGetLastError()`, or `SMEM_TOO_LARGE` for shapes whose block would
need more shared memory than the card allows; `check` turns either into
an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("simhash", "fused_query", "bucket_topk", "hamming")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}   # nvcc's -Xptxas -v report per source


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> None:
    """Compile every source not built yet, one nvcc each, in parallel."""
    todo = [n for n in names if n not in _libs and not _target(n).exists()]
    if todo:
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            ptxas_log[n] = out
            if p.returncode != 0:
                failed.append(f"--- {n}.cu (rc={p.returncode}) ---\n{out}")
            else:
                os.replace(tmp, _target(n))  # atomic: no half-written .so
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for n in names:
        if n not in _libs:
            _libs[n] = ctypes.CDLL(str(_target(n)))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


SMEM_TOO_LARGE = -1  # the C launchers' code for shapes that overflow smem


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error, or (ValueError)
    shapes whose block needs more shared memory than the card allows."""
    if err == SMEM_TOO_LARGE:
        raise ValueError(f"{what}: the shapes need more shared memory than "
                         "one block of this card may hold")
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


P = ctypes.c_void_p
I = ctypes.c_int

_entries: dict[tuple[str, str], object] = {}


def entry(name: str, fn: str, argtypes):
    """Entry point `fn` of `csrc/<name>.cu`, with its argtypes declared."""
    key = (name, fn)
    if key not in _entries:
        f = getattr(lib(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _entries[key] = f
    return _entries[key]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of CUDA `device` (the current device where it has no
    index), which the kernels' grids are picked for."""
    import torch

    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


def stream_of(t) -> int:
    """The raw CUDA stream PyTorch launches on for tensor `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
