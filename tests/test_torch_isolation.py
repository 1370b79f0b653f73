"""`repro_torch` stands alone: every module imports with jax made
unimportable, and none of them loads a module of the JAX package."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import repro_torch
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(n for n in sys.modules
                    if n == "repro" or n.startswith("repro."))
    print(len(names), leaked)
""")


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    n, leaked = proc.stdout.split(" ", 1)
    assert leaked.strip() == "[]"
    # package, core + 16 modules (analysis, layered and metrics among
    # them), kernels + 7 modules, launch + mesh, data + osn, convert
    assert int(n) >= 31
