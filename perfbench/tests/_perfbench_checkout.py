"""A checkout of the benchmark with the CPU test cells added as files.

:func:`checkout` copies ``BENCHMARK.json`` and ``perfbench/`` into a
temporary directory, links the program's ``src/`` beside them, and adds
the cells of ``cells/`` (a smoke mamba2 and zamba2, traffic
``train.smoke``) as a later change would add a cell: a configuration file,
a traffic file, a limits file and ``BENCHMARK.json`` entries, with no edit
of the harness.  :func:`run` runs one cell there in a fresh process on the
CPU (the harness's look for a card skipped), with faults planted.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = Path(__file__).resolve().parent / "cells"
SMOKE = ("mamba2-smoke", "zamba2-smoke")
#: the smoke cells' limits: the readings of sound bf16 runs on the CPU (at
#: most 0.007 for grad_norm, 0.013 first_grad, 0.011 change, 0.008 h, 7e-4
#: loss), with room
LIMITS = {"loss": 0.003, "grad_norm": 0.03, "first_grad": 0.05, "change": 0.05, "change1": 0.02, "h": 0.04,
          "decisions": 0, "nonfinite": 0}


def checkout(tmp: Path, limits: dict | None = None) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "src", root / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copy(CELLS / "train.smoke.json", root / "perfbench" / "traffic" / "train.smoke.json")
    for name in SMOKE:
        shutil.copy(CELLS / f"{name}.json", root / "perfbench" / "configs" / f"{name}.json")
        cell = f"{name}.train.smoke"
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/2405.21060",
                                 "file": f"perfbench/configs/{name}.json", "reduced": [],
                                 "why": "a CPU test's size"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": "train.smoke",
                                   "chips": 1, "why": "a CPU test's size"})
        (root / "perfbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits or LIMITS))
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, cell: str, seed: int = 1234567890123, trace: int = 0, fault: str = "",
        variant_args: tuple = ()) -> subprocess.CompletedProcess:
    """``perfbench/run.py`` of ``root`` on the CPU for ``cell``, with
    ``fault`` (a name of ``faults.FAULTS``) planted when given."""
    code = (
        "import sys, contextlib\n"
        f"sys.path.insert(0, {str(root / 'perfbench')!r})\n"
        "import run, faults\n"
        f"ctx = faults.planted({fault!r}) if {fault!r} else contextlib.nullcontext()\n"
        "with ctx:\n"
        f"    rc = run.main(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '1',"
        f" '--trace', '{trace}'], device='cpu')\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600, check=False)


def result(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
