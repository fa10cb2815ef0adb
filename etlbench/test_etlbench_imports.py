"""Nothing under etlbench/ imports JAX, the JAX package (``repro``, the
top-level name compared whole: ``repro_torch`` is the program),
``chip_smoke`` or the repository's ``tests``; the reference imports
nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "tests"}


def sources():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_forbidden_import(path):
    assert not top_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "gen.py", "work.py"):
        assert "repro_torch" not in top_imports(os.path.join(HERE, name))
    code = ("import sys; import etlbench.reference, etlbench.gen, "
            "etlbench.work, etlbench.drive, etlbench.run; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(
        ROOT, "src")]))
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
