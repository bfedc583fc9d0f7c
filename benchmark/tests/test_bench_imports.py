"""Nothing the benchmark runs loads the JAX stack or the JAX package, compared
by whole top-level names (the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "zdcsim"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (FORBIDDEN | {"zdcsim_torch"}), (path, tops)


def test_a_run_loads_no_jax(tiny):
    """A whole tiny run in a process of its own, then its modules."""
    spec, d = tiny
    code = (
        "import sys, io; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from harness.runner import execute, forbidden_modules\n"
        "from harness.spec import Spec\n"
        "execute(['--workload', 'tiny_neutron_serve', '--seed', '5', '--seconds', '0.1'],\n"
        "        spec=Spec(%r, dirs=[%r]), device='cpu', out=io.StringIO(), err=io.StringIO())\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
    ) % (BENCH, ROOT, spec.path, d)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "zdcsim_torch" in tops and not tops & FORBIDDEN


def test_run_refuses_without_a_card():
    """``run.py`` with no CUDA card: a non-zero exit and no result line."""
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "proton_serve_fused", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
