"""The PyTorch port stands alone: every module, and chip_smoke.py, imports
with jax, flax, yaml, msgpack, sklearn, matplotlib and the JAX package
blocked (the card's Python has none of them; Analysis imports sklearn and
matplotlib when it runs), and no port source names the reference
framework."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "matdeeplearn_torch")
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "msgpack", "sklearn",
           "matplotlib", "matdeeplearn_tpu")


def _port_modules():
    import matdeeplearn_torch

    return ["matdeeplearn_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(matdeeplearn_torch.__path__,
                                              "matdeeplearn_torch.")
        if m.name != "matdeeplearn_torch.__main__")


def test_training_slice_modules_are_walked():
    """The import check below covers the Training, SchNet, MPNN and GCN
    slices' modules."""
    mods = set(_port_modules())
    for name in ("ops._build", "ops.fused_cgconv", "training.optimizers",
                 "training.scheduler", "training.trainer", "training.jobs",
                 "utils.summary", "cli", "ops.fused_cfconv", "models.schnet",
                 "ops.fused_bilinear", "models.mpnn", "data.windowed",
                 "ops.windowed", "models.gcn", "models.megnet",
                 "data.descriptors", "data.native", "models.descriptor_nn",
                 "training.hyper", "training.checkpoint"):
        assert f"matdeeplearn_torch.{name}" in mods, name


def test_port_and_chip_smoke_import_without_jax():
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for mod in {_port_modules() + ['chip_smoke']!r}:",
        "    importlib.import_module(mod)",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sources():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh", ".cpp"))]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_names_no_reference_framework(path):
    with open(path) as f:
        text = f.read()
    found = re.findall(r"\b(jax|flax|matdeeplearn_tpu)\b", text, re.IGNORECASE)
    assert not found, f"{path} names {sorted(set(found))}"
