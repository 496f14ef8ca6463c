"""The harness end to end on the CPU: the smoke cells, added as files to a
copy of the benchmark, run one window each with the program's plain
kernels, traced and untraced; faults planted under the timed path make
``correct`` false; without a card, or without the program, no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
from _perfbench_checkout import SMOKE, checkout, result, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("perfbench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("config", SMOKE)
def test_smoke_cell_runs_one_window(root, config, trace):
    cell = f"{config}.train.smoke"
    out = result(run(root, cell, trace=trace))
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    group = bench["per_layer"] if trace else bench["end_to_end"]
    names = {m["name"] for m in group}
    assert set(out["metrics"]) <= names
    # host metrics only: a CPU run reports no device metric
    expect = {"tier2_host_ms", "step_enqueue_ms"} if trace else {"train_tokens_per_s", "setup_s"}
    assert set(out["metrics"]) == expect
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    checks = out["checks"]
    assert {"loss", "grad_norm", "first_grad", "change", "h", "decisions"} <= set(checks)
    assert all(c["value"] <= c["limit"] for c in checks.values())


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "flip"])
def test_planted_fault_reads_not_correct(root, fault):
    out = result(run(root, "zamba2-smoke.train.smoke", fault=fault))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_no_card_no_result(tmp_path):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "zamba2-2.7b.train.s4k", "--seed", "1", "--seconds", "1"],
                          cwd=checkout(tmp_path), capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path, root):
    bare = tmp_path / "bare"
    shutil.copytree(root / "perfbench", bare / "perfbench")
    shutil.copy(root / "BENCHMARK.json", bare / "BENCHMARK.json")
    proc = run(bare, "zamba2-smoke.train.smoke")
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")
