"""The port's installed entry points, and the programs its fleet names.

* Every ``raft_stereo_tpu_torch`` console script of ``pyproject.toml``
  imports and names a callable ``main``; the port installs a script for
  each CLI it runs (``raft-stereo-torch-train``/``-evaluate``/``-demo``,
  ``raft-serve-torch``, ``raft-route-torch``).
* The fleet launches and documents the port's programs: no string
  constant of ``serving/fleet/*.py`` or ``cli/route.py`` names the JAX
  package's modules (``raft_stereo_tpu.``) or its programs
  (``raft-serve``/``raft-route`` without ``-torch``).  The purity test
  reads only imports, so a launch template naming JAX's replica would
  pass it.
"""

import ast
import importlib
import os
import re
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "raft_stereo_tpu_torch")
JAX_NAMES = re.compile(r"raft_stereo_tpu\.|raft-serve(?!-torch)"
                       r"|raft-route(?!-torch)")


def _scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items()
            if v.startswith("raft_stereo_tpu_torch.")}


def test_port_installs_a_script_per_cli():
    assert _scripts() == {
        "raft-stereo-torch-demo": "raft_stereo_tpu_torch.cli.demo:main",
        "raft-stereo-torch-train": "raft_stereo_tpu_torch.cli.train:main",
        "raft-stereo-torch-evaluate":
            "raft_stereo_tpu_torch.cli.evaluate:main",
        "raft-serve-torch": "raft_stereo_tpu_torch.cli.serve:main",
        "raft-route-torch": "raft_stereo_tpu_torch.cli.route:main",
    }


@pytest.mark.parametrize("script", sorted(_scripts()))
def test_console_script_target_is_a_callable_main(script):
    module, _, attr = _scripts()[script].partition(":")
    assert attr == "main"
    assert callable(getattr(importlib.import_module(module), attr))


def _fleet_sources():
    fleet = os.path.join(PACKAGE, "serving", "fleet")
    for f in sorted(os.listdir(fleet)):
        if f.endswith(".py"):
            yield os.path.join(fleet, f)
    yield os.path.join(PACKAGE, "cli", "route.py")


@pytest.mark.parametrize("path", list(_fleet_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_fleet_strings_name_the_ports_programs(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    named = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant)
             and isinstance(node.value, str)
             and JAX_NAMES.search(node.value)]
    assert named == []


def test_the_check_sees_a_jax_template():
    """The pattern catches what it is for, and passes the port's names."""
    for text in ("python -m raft_stereo_tpu.cli.serve --port {port}",
                 "raft-serve --port 1", "spawns ``raft-route``"):
        assert JAX_NAMES.search(text)
    for text in ("python -m raft_stereo_tpu_torch.cli.serve --port {port}",
                 "raft-serve-torch --port 1", "``raft-route-torch``"):
        assert not JAX_NAMES.search(text)
