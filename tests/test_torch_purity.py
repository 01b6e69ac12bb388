"""The PyTorch port imports nothing of JAX or of the JAX package, and its
GPU-only tests skip with a stated reason on a host without a card."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "raft_stereo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_stereo_tpu")

# Import every module of the port in a fresh interpreter and list the
# modules that importing it added (startup code of the environment may
# load modules of its own before the port is imported).
_IMPORT_ALL = f"""
import importlib, pkgutil, sys
before = set(sys.modules)
sys.path.insert(0, {REPO!r})
import raft_stereo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    raft_stereo_tpu_torch.__path__, "raft_stereo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
print(" ".join(sorted(set(sys.modules) - before)))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "torch_profile.py")
    yield os.path.join(REPO, "tools", "torch_kernel_variants.py")


def test_port_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    assert int(out[0]) >= 20  # every module of the package was imported
    loaded = out[1].split()
    assert "raft_stereo_tpu_torch.kernels.gru_fused" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_name_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_cuda_tests_skip_with_reason_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-rs",
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         os.path.join(REPO, "tests", "test_torch_cuda.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " passed" not in proc.stdout
    assert "needs a CUDA device" in proc.stdout
