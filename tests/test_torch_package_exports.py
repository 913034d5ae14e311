"""Every package ``__init__`` of the port exports the names its JAX twin
imports.

The JAX package's ``__init__.py`` files are read with ``ast`` (JAX is not
imported): each relative import — ``from .vocabulary import Vocabulary`` or
``from . import se3`` — names what the package exports.  The port's twin,
imported in a fresh interpreter, must have each of them, so that
``from orb_slam2_ros2_tpu_torch.bow import KeyFrameDB`` works as
``from orb_slam2_ros2_tpu.bow import KeyFrameDB`` does.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "orb_slam2_ros2_tpu")


def jax_packages() -> list:
    """The JAX package and its subpackages, as dotted paths below it."""
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        if "__init__.py" in files:
            rel = os.path.relpath(dirpath, JAX_PKG)
            out.append("" if rel == "." else rel.replace(os.sep, "."))
    return sorted(out)


def exported_names(sub: str) -> list:
    """The names the JAX ``__init__.py`` of ``sub`` binds by relative imports."""
    path = os.path.join(JAX_PKG, *sub.split(".") if sub else (), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return [a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level >= 1 for a in node.names]


def test_the_four_subpackages_named_in_the_roadmap_export_something():
    for sub in ("bow", "mapstate", "geometry", "matching"):
        assert exported_names(sub), sub


@pytest.fixture(scope="module")
def port_missing() -> dict:
    """Per package, the JAX-exported names the port's twin lacks, looked up
    in a fresh interpreter (in this one a submodule another test imported
    would be an attribute of its package whatever the ``__init__`` says)."""
    wanted = {sub: exported_names(sub) for sub in jax_packages()}
    code = ("import importlib, json, sys\n"
            "wanted = json.loads(sys.argv[1])\n"
            "out = {}\n"
            "for sub, names in wanted.items():\n"
            "    m = importlib.import_module('orb_slam2_ros2_tpu_torch' + ('.' + sub if sub else ''))\n"
            "    out[sub] = [n for n in names if not hasattr(m, n)]\n"
            "assert 'jax' not in sys.modules\n"
            "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code, json.dumps(wanted)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", jax_packages())
def test_port_package_exports_the_jax_names(port_missing, sub):
    assert port_missing[sub] == [], f"orb_slam2_ros2_tpu_torch.{sub} lacks {port_missing[sub]}"
