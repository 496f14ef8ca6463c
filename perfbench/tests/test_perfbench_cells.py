"""``BENCHMARK.json`` and the files it names: the shape the benchmark's
contract asks for, a cell added by files alone, and, on the card, each
cell's control (the program's int8 DSAG slots) read as not correct."""

from __future__ import annotations

import filecmp
import json
import re
import sys

import pytest
from _perfbench_checkout import REPO, checkout

sys.path.insert(0, str(REPO / "perfbench"))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_name_has_its_files():
    here = REPO / "perfbench"
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        config = json.loads((REPO / c["file"]).read_text())
        assert (here / "reference" / f"{config['reference']}.py").is_file()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert (here / "harness" / f"{traffic['runner']}.py").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()


def test_a_cell_added_as_files_needs_no_code_edit(tmp_path):
    root = checkout(tmp_path)
    for path in (REPO / "perfbench").rglob("*.py"):
        rel = path.relative_to(REPO)
        if "tests" in rel.parts or "__pycache__" in rel.parts:
            continue
        assert filecmp.cmp(path, root / rel, shallow=False), rel
    added = {p.relative_to(root).as_posix() for p in (root / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts
             and not (REPO / p.relative_to(root)).exists()}
    assert added and all(p.endswith(".json") for p in added)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_reads_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    import calibrate
    import run as bench_run
    from harness import dsag_train, judge

    _, _, config, traffic, limits = bench_run.load(REPO, cell)
    seed = 2**31 + 12345
    control = calibrate.readings(config, traffic, seed, "cuda:0", "control")
    ref = dsag_train.reference(config, traffic, seed, "cuda:0", traffic["check_steps"])
    ok, _ = judge.verdict(judge.numbers(control, ref), limits)
    assert not ok
