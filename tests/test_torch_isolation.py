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
    serve = sorted(n for n in names if "serve" in n)
    lm = sorted(n for n in names if ".models" in n or ".configs" in n)
    print(len(names), leaked, serve, "|", lm)
""")


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    n, leaked, rest = proc.stdout.split(" ", 2)
    serve, lm = rest.split(" | ")
    assert leaked.strip() == "[]"
    # package, core + 17 modules (analysis, churn, layered and metrics
    # among them), kernels + 7 modules, launch + mesh + the node_churn,
    # failure_churn, serve_retrieval and serve (LM) CLIs, obs + flight,
    # registry and trace, data + osn, convert, serve + control, frontend,
    # lifecycle, loadgen, qcache, telemetry and writer, models + config,
    # layers, model, moe, ssm, unroll and xlstm, configs + shapes and the
    # ten arch files, train + optimizer and train_step, data.tokens,
    # checkpoint + checkpoint, launch.train; models.sharding,
    # train.compression and train.pipeline
    assert int(n) >= 76
    assert lm.strip() == str(
        ["repro_torch.configs"]
        + [f"repro_torch.configs.{m}" for m in (
            "codeqwen15_7b", "deepseek_moe_16b", "gemma2_2b",
            "jamba_v01_52b", "llama4_maverick_400b", "phi3_medium_14b",
            "phi3_vision_4_2b", "seamless_m4t_medium", "shapes",
            "starcoder2_7b", "xlstm_1_3b")]
        + ["repro_torch.models", "repro_torch.models.config",
           "repro_torch.models.layers", "repro_torch.models.model",
           "repro_torch.models.moe", "repro_torch.models.sharding",
           "repro_torch.models.ssm", "repro_torch.models.unroll",
           "repro_torch.models.xlstm"])
    assert serve.strip() == str([
        "repro_torch.launch.serve", "repro_torch.launch.serve_retrieval",
        "repro_torch.serve", "repro_torch.serve.control",
        "repro_torch.serve.frontend", "repro_torch.serve.lifecycle",
        "repro_torch.serve.loadgen", "repro_torch.serve.qcache",
        "repro_torch.serve.telemetry", "repro_torch.serve.writer"])


EXAMPLE_PROBE = textwrap.dedent("""
    import importlib, importlib.util, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    for name in ("repro_torch.core.mesh", "repro_torch.core.runtime",
                 "repro_torch.core.distributed", "repro_torch.core.churn",
                 "repro_torch.serve.frontend"):
        importlib.import_module(name)
    launch = sorted(n for n in sys.modules
                    if n.startswith("repro_torch.launch"))
    importlib.import_module("repro_torch.launch.mesh")
    spec = importlib.util.spec_from_file_location("example", EXAMPLE)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(n for n in sys.modules
                    if n == "repro" or n.startswith("repro."))
    print(leaked, launch)
""")


def test_process_mesh_and_its_example_import_without_jax():
    """The process mesh's modules and `examples/torch_distributed_search.
    py` load with jax unimportable and pull in nothing of `repro`; the
    core layer's mesh modules load nothing of the launch layer."""
    example = os.path.join(os.path.dirname(SRC), "examples",
                           "torch_distributed_search.py")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", f"EXAMPLE = {example!r}\n" + EXAMPLE_PROBE],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


P2P_PROBE = textwrap.dedent("""
    import importlib, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    for name in ("repro_torch.core.mesh", "repro_torch.core.runtime",
                 "repro_torch.core.distributed", "repro_torch.core.churn",
                 "repro_torch.serve.frontend", "repro_torch.serve.writer",
                 "repro_torch.serve.lifecycle"):
        importlib.import_module(name)
    launch = sorted(n for n in sys.modules
                    if n.startswith("repro_torch.launch"))
    for name in ("repro_torch.launch.mesh", "repro_torch.launch.node_churn",
                 "repro_torch.launch.failure_churn",
                 "repro_torch.launch.serve_retrieval"):
        importlib.import_module(name)
    leaked = sorted(n for n in sys.modules
                    if n == "repro" or n.startswith("repro."))
    print(leaked, launch)
""")


def test_p2p_process_mesh_modules_import_without_jax():
    """The modules the P2P dynamics and serving run on a process mesh
    through (replicas, kills, reshards, the churn drivers and CLIs, the
    serve backend, writer and lifecycles) load with jax unimportable and
    pull in nothing of `repro`; the core and serve layers load nothing
    of the launch layer."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", P2P_PROBE],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


ITEM7_PROBE = textwrap.dedent("""
    import importlib, importlib.util, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    for name in ("repro_torch.kernels.autotune", "repro_torch.serve.control"):
        importlib.import_module(name)
    for path in EXAMPLES:
        spec = importlib.util.spec_from_file_location("example", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(n for n in sys.modules
                    if n == "repro" or n.startswith("repro."))
    print(leaked)
""")


def test_examples_autotune_and_controller_import_without_jax():
    """`examples/torch_quickstart.py`, `examples/torch_retrieval_serve.py`,
    `kernels/autotune.py` and `serve/control.py` load with jax
    unimportable and pull in nothing of `repro`; none of their sources
    names jax or the JAX package in an import."""
    root = os.path.dirname(SRC)
    examples = [os.path.join(root, "examples", f"torch_{n}.py")
                for n in ("quickstart", "retrieval_serve")]
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", f"EXAMPLES = {examples!r}\n" + ITEM7_PROBE],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for path in examples + [
            os.path.join(SRC, "repro_torch", "kernels", "autotune.py"),
            os.path.join(SRC, "repro_torch", "serve", "control.py")]:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    assert words[1].split(".")[0] not in ("jax", "repro"), \
                        (path, line)


TRAIN_PROBE = textwrap.dedent("""
    import importlib, importlib.util, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    for name in NAMES:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("example", EXAMPLE)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(n for n in sys.modules
                    if n == "repro" or n.startswith("repro."))
    print(leaked)
""")


def test_training_modules_and_example_import_without_jax():
    """The training stack (`models/unroll.py`, `train/optimizer.py`,
    `train/train_step.py`, `data/tokens.py`, `checkpoint/checkpoint.py`,
    `launch/train.py`) and `examples/torch_train_lm.py` load with jax
    unimportable and pull in nothing of `repro`; none of their sources
    names jax or the JAX package in an import."""
    names = ["repro_torch.models.unroll", "repro_torch.train.optimizer",
             "repro_torch.train.train_step", "repro_torch.data.tokens",
             "repro_torch.checkpoint.checkpoint", "repro_torch.launch.train"]
    example = os.path.join(os.path.dirname(SRC), "examples",
                           "torch_train_lm.py")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c",
         f"NAMES = {names!r}\nEXAMPLE = {example!r}\n" + TRAIN_PROBE],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for path in [example] + [os.path.join(SRC, *n.split(".")) + ".py"
                             for n in names]:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    assert words[1].split(".")[0] not in ("jax", "repro"), \
                        (path, line)
