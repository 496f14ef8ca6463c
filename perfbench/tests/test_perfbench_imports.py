"""What the benchmark loads: nothing of JAX or the JAX package, anywhere
under ``perfbench/``; nothing of the program in the reference.  Top-level
module names are compared whole (``repro_torch`` is the port, ``repro`` the
JAX package)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from _perfbench_checkout import REPO

PERFBENCH = REPO / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(PERFBENCH).as_posix()
                                        for p in PERFBENCH.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(PERFBENCH / path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    code = ("import sys; sys.path.insert(0, 'perfbench')\n"
            "import reference.ssm_lm, reference.dsag\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=True)
    loaded = set(eval(proc.stdout))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_forbidden_names_are_whole_top_level_names():
    code = ("import sys; sys.path[:0] = ['src', 'perfbench']\n"
            "import run, repro_torch.launch.train, harness.dsag_train\n"
            "print(run.forbidden_modules())\n"
            "sys.modules['repro.core'] = sys.modules['run']\n"
            "print(run.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=True)
    assert proc.stdout.split("\n")[:2] == ["[]", "['repro']"]
