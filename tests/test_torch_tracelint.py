"""The port's tracelint (``repro_torch.analysis.lint``): TL001 to TL005.

Mirrors ``tests/test_tracelint.py``: every registered entry is clean at HEAD
on the CPU (the kernels' plain versions), and a seeded violation of each
rule fires with its code: a fused multiply-add (``torch.addcmul``) or a
regrouped product in the §3 latency chain (TL001), the width mask removed
from the plain K1 and K2 (TL003), a float32 leak into the event times, an
int64 times a python float, a loop carry that changes dtype, and a plain
version's output at the wrong dtype (TL004), a clone of the §5 value table
inside the tiled cache's per-rank walk (TL002) and an ``.item()`` inside it
(TL005).  The card-only checks (event
streams and K3/K7 outputs against the CPU run, K1/K2/K5 at two pad widths)
run on the card (``gpu``); their helpers are exercised here on CPU tensors.
No test imports ``jax`` or ``repro``.
"""

from __future__ import annotations

import ast
import inspect
import json
import linecache
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.lint import ENTRIES, RULES, run_lint
from repro_torch.analysis.lint.__main__ import main
from repro_torch.analysis.lint.baseline import DEFAULT_BASELINE, load_baseline, parse_baseline
from repro_torch.analysis.lint.entries import (
    CARD_ONLY,
    EntryProbe,
    _against_plain,
    _pad_invariance,
    entry_names,
)
from repro_torch.analysis.lint.rules import check_dtype_leak
from repro_torch.analysis.lint.trace import run_traced
from repro_torch.cluster import simulator
from repro_torch.experiments import fused
from repro_torch.kernels import block_sub, cache_events
from repro_torch.latency import model as latency_model

REPO = Path(__file__).resolve().parents[1]
CPU_ENTRIES = [n for n in ENTRIES if n not in CARD_ONLY]


def _codes(report) -> set:
    return {f.code for f in report.findings}


def test_rule_catalogue_keeps_the_reference_codes():
    tree = ast.parse((REPO / "src" / "repro" / "analysis" / "lint" / "findings.py").read_text())
    rules = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "RULES")
    ref = {k.value: v.elts[0].value for k, v in zip(rules.keys, rules.values)}
    assert {code: name for code, (name, _) in RULES.items()} == ref


def test_registry_has_the_reference_entries():
    ref = {"latency", "fused_logreg_grid", "fused_logreg_lb", "fused_logreg_tiled",
           "fused_logreg_churn", "fused_pca_grid", "kernels_logreg", "kernels_pca",
           "lb_update", "kernels_ops", "dsag_pjit"}
    assert set(CPU_ENTRIES) == ref
    assert CARD_ONLY == {"fused_logreg_grid_cuda", "fused_pca_grid_cuda"}
    assert entry_names("all", "cpu") == CPU_ENTRIES
    assert entry_names("all", "cuda") == list(ENTRIES)
    with pytest.raises(ValueError):
        entry_names(["fused_pca_grid_cuda"], "cpu")


@pytest.mark.parametrize("entry", CPU_ENTRIES)
def test_entry_is_clean_on_the_cpu(entry):
    report = run_lint([entry], device="cpu", baseline_path=None)
    assert report.findings == [], report.render_text()
    assert report.entries_run == [entry]


def test_fused_entries_trace_their_loop_carries():
    report_probe = ENTRIES["fused_logreg_grid"](torch.device("cpu"))
    trace = run_traced(report_probe.run, report_probe.loop)
    assert len(trace.carries) == 7  # on entry, then after each of the 6 iterations
    assert trace.carries[0]["free_at"] == "float64"
    assert trace.carries[0]["cache"]["sums"] == "float64"


# -- TL001 ---------------------------------------------------------------------------------


def _addcmul_finish(start, comp, comm):
    # the same grouping and bits (a product by 1 is exact), through a fused op
    return torch.addcmul(start, comp + comm, torch.ones_like(comp))


def test_tl001_fires_on_a_fused_multiply_add_in_the_chain(monkeypatch):
    monkeypatch.setattr(simulator, "task_finish_time", _addcmul_finish)
    monkeypatch.setattr(fused, "task_finish_time", _addcmul_finish)
    report = run_lint(["latency", "fused_logreg_grid"], device="cpu", baseline_path=None)
    assert {(f.code, f.entry) for f in report.findings} == {
        ("TL001", "latency"), ("TL001", "fused_logreg_grid")}
    assert all("addcmul" in f.symbol for f in report.findings)


def test_tl001_fires_when_the_chain_differs_from_numpy(monkeypatch):
    monkeypatch.setattr(latency_model, "comp_latency_expr",
                        lambda unit, load, slowdown, factor: unit * (load * slowdown) * factor)
    report = run_lint(["latency"], device="cpu", baseline_path=None)
    assert _codes(report) == {"TL001"}
    assert {f.symbol for f in report.findings} == {f"batch{i}" for i in range(4)}


# -- TL003 ---------------------------------------------------------------------------------


def _unmasked_window(starts, widths, n, max_width, window=block_sub._window):
    idx, mask = window(starts, widths, n, max_width)
    return idx, torch.ones(mask.shape, dtype=torch.bool)  # every pad row counts


@pytest.mark.parametrize("entry,op", [("kernels_logreg", "sum"), ("kernels_pca", "bmm")])
def test_tl003_fires_without_the_width_mask(monkeypatch, entry, op):
    monkeypatch.setattr(block_sub, "_window", _unmasked_window)
    report = run_lint([entry], device="cpu", baseline_path=None)
    assert _codes(report) == {"TL003"}
    assert report.findings[0].symbol.startswith(f"op:{op}:")


# -- TL004 ---------------------------------------------------------------------------------


def test_tl004_fires_on_a_float32_leak_into_the_event_times(monkeypatch):
    monkeypatch.setattr(fused, "task_finish_time",
                        lambda start, comp, comm: (start + (comp + comm)).float())
    report = run_lint(["fused_logreg_grid"], device="cpu", baseline_path=None)
    assert _codes(report) == {"TL004"}
    assert report.findings[0].symbol == "op:_to_copy:float64[2, 4]->float32[2, 4]"


def _probe(run, **kw) -> EntryProbe:
    probe = EntryProbe("probe", "a seeded violation", torch.device("cpu"), run=run, **kw)
    probe.trace = run_traced(run, probe.loop)
    return probe


def test_tl004_fires_on_int64_times_a_python_float():
    rows = torch.arange(1, 5)
    probe = _probe(lambda: rows * 0.5, event_algebra=True)
    assert [f.symbol for f in check_dtype_leak(probe)] == ["op:mul:int64[4]->float32[4]"]
    assert check_dtype_leak(_probe(lambda: rows.to(torch.float64) * 0.5,
                                   event_algebra=True)) == []


def _event_loop(steps: int, leak: bool):
    free_at = torch.zeros(3, dtype=torch.float64)
    for t in range(steps):
        free_at = free_at + 1.0
        if leak and t == 1:
            free_at = free_at.to(torch.float32)
    return free_at


def test_tl004_fires_on_a_carry_that_changes_dtype():
    clean = _probe(lambda: _event_loop(4, False), loop=(_event_loop, ("free_at",)))
    assert len(clean.trace.carries) == 5 and check_dtype_leak(clean) == []
    leaky = _probe(lambda: _event_loop(4, True), loop=(_event_loop, ("free_at",)))
    assert [f.symbol for f in check_dtype_leak(leaky)] == ["carry:free_at"]


def _float64_plain(*args, plain=block_sub.logreg_block_sub_plain):
    return plain(*args).double()


def test_tl004_fires_on_a_plain_output_at_the_wrong_dtype(monkeypatch):
    monkeypatch.setattr(block_sub, "logreg_block_sub_plain", _float64_plain)
    report = run_lint(["kernels_logreg"], device="cpu", baseline_path=None)
    assert _codes(report) == {"TL004"}
    assert report.findings[0].symbol == "output[0]:torch.float64"


# -- the card checks' helpers, on CPU tensors --------------------------------------------------


def test_pad_invariance_notes_bits_and_fails_past_tolerance():
    probe = EntryProbe("p", "", torch.device("cpu"))
    x = torch.arange(6, dtype=torch.float32)
    assert _pad_invariance("k", lambda pad: x, probe) == []
    assert probe.notes == ["k: pad 16 vs 32 bit-equal"]
    assert _pad_invariance("k", lambda pad: x * (1 + 1e-7 * (pad == 32)), probe) == []
    assert "within tolerance" in probe.notes[-1]
    bad = _pad_invariance("k", lambda pad: x + (pad == 32), probe)
    assert [s for s, _ in bad] == ["k:pad16-vs-32"]


def test_kernel_outputs_against_the_plain_version():
    rng = np.random.default_rng(0)
    S, R, E, F = 2, 5, 4, 3
    args = (torch.as_tensor(rng.random((S, R)) < 0.8), torch.as_tensor(rng.integers(0, E, (S, R))),
            torch.as_tensor(rng.integers(0, 3, (S, R))),
            torch.as_tensor(rng.normal(size=(S, R, F))),
            torch.zeros(S, F, dtype=torch.float64), torch.zeros(S, E, F, dtype=torch.float64),
            torch.full((S, E), -1), torch.zeros(S, dtype=torch.int64),
            torch.zeros(S, dtype=torch.int64), torch.ones(E, dtype=torch.int64))
    outs = cache_events.grid_cache_update_plain(*args)
    assert _against_plain([(args, outs)], cache_events.grid_cache_update_plain, "k3") == []
    off = (torch.nextafter(outs[0], torch.full_like(outs[0], np.inf)),) + outs[1:]
    assert [s for s, _ in _against_plain([(args, off)], cache_events.grid_cache_update_plain,
                                         "k3")] == ["k3:call0:output0"]


# -- the baseline and the CLI --------------------------------------------------------------


def test_baseline_requires_a_reason():
    with pytest.raises(ValueError, match="reason"):
        parse_baseline('[[suppress]]\ncode = "TL004"\nentry = "latency"\n')
    with pytest.raises(ValueError, match="reason"):
        parse_baseline('[[suppress]]\ncode = "TL004"\nreason = "  "\n')
    with pytest.raises(ValueError, match="code"):
        parse_baseline('[[suppress]]\nreason = "why"\n')
    (s,) = parse_baseline('[[suppress]]\ncode = "TL003"\nentry = "kernels_pca"\n'
                          'contains = "bmm"\nreason = "accepted"\n')
    assert (s.code, s.entry, s.contains, s.reason) == ("TL003", "kernels_pca", "bmm", "accepted")


def test_committed_baseline_is_the_ports_own_and_empty():
    assert DEFAULT_BASELINE.parent == REPO / "src" / "repro_torch" / "analysis" / "lint"
    assert load_baseline() == []
    assert load_baseline(REPO / "no-such-baseline.toml") == []


def test_cli_exits_zero_at_head_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--entry", "all", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"tracelint (cpu): {len(CPU_ENTRIES)} entries, 0 finding(s)" in proc.stdout


def test_cli_exits_nonzero_on_a_finding_the_baseline_does_not_hold(monkeypatch, tmp_path,
                                                                  capsys):
    monkeypatch.setattr(simulator, "task_finish_time", _addcmul_finish)
    assert main(["--entry", "latency", "--device", "cpu"]) == 1
    assert "TL001 [fma-seam] latency" in capsys.readouterr().out
    held = tmp_path / "baseline.toml"
    held.write_text('[[suppress]]\ncode = "TL001"\nentry = "latency"\ncontains = "addcmul"\n'
                    'reason = "the seeded violation of this test"\n')
    assert main(["--entry", "latency", "--device", "cpu", "--baseline", str(held)]) == 0
    assert main(["--entry", "latency", "--device", "cpu", "--baseline", str(held),
                 "--no-baseline", "--json"]) == 1


# -- TL002 / TL005 ---------------------------------------------------------------------------


def _seeded_walk(line: str):
    """``fused._apply_cache_events_tiled`` with ``line`` run first in every
    trip of its per-rank loop (compiled from its source, kept in linecache
    so the tracer finds the loop)."""
    src = inspect.getsource(fused._apply_cache_events_tiled)
    anchor = "        w_e = worker_r[:, j]\n"
    assert anchor in src
    src = src.replace(anchor, anchor + f"        {line}\n")
    name = f"<seeded walk {line}>"
    linecache.cache[name] = (len(src), None, src.splitlines(True), name)
    ns = dict(vars(fused))
    exec(compile(src, name, "exec"), ns)
    return ns["_apply_cache_events_tiled"]


_TABLE_CLONE = _seeded_walk("values0.clone()")
_WALK_ITEM = _seeded_walk("n_live = int(valid.sum().item())")


@pytest.mark.parametrize("code,fn,what", [("TL002", _TABLE_CLONE, "op:clone"),
                                          ("TL005", _WALK_ITEM, "op:_local_scalar_dense")])
def test_walk_rules_fire_on_their_seeded_violation(monkeypatch, code, fn, what):
    monkeypatch.setattr(fused, "_apply_cache_events_tiled", fn)
    report = run_lint(["fused_logreg_lb", "fused_logreg_grid"], device="cpu",
                      baseline_path=None)
    # the grid entry never walks the tiled cache: only the §6 entry fires
    assert {(f.code, f.entry) for f in report.findings} == {(code, "fused_logreg_lb")}
    assert all(f.symbol.startswith(what) for f in report.findings), report.render_text()


def test_walk_rules_see_the_loop_and_its_tables():
    """The §6 entry's trace marks the walk's ops (its reductions); the grid
    entry never enters the walk."""
    probe = ENTRIES["fused_logreg_lb"](torch.device("cpu"))
    trace = run_traced(probe.run, probe.loop, probe.region)
    inside = [op for op in trace.ops if op.in_loop]
    assert inside and {op.name for op in inside} >= {"sum"}
    grid = ENTRIES["fused_logreg_grid"](torch.device("cpu"))
    assert not any(op.in_loop for op in run_traced(grid.run, grid.loop, grid.region).ops)


@pytest.mark.parametrize("code,entry,module,name,fn", [
    ("TL001", "latency", simulator, "task_finish_time", _addcmul_finish),
    ("TL002", "fused_logreg_lb", fused, "_apply_cache_events_tiled", _TABLE_CLONE),
    ("TL003", "kernels_logreg", block_sub, "_window", _unmasked_window),
    ("TL004", "kernels_logreg", block_sub, "logreg_block_sub_plain", _float64_plain),
    ("TL005", "fused_logreg_lb", fused, "_apply_cache_events_tiled", _WALK_ITEM),
])
def test_cli_exits_nonzero_with_the_code_of_each_seeded_violation(monkeypatch, capsys, code,
                                                                 entry, module, name, fn):
    monkeypatch.setattr(module, name, fn)
    assert main(["--entry", entry, "--device", "cpu", "--json"]) == 1
    assert {f["code"] for f in json.loads(capsys.readouterr().out)["findings"]} == {code}


@pytest.mark.gpu
def test_every_entry_is_clean_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    report = run_lint("all", device="cuda:0")
    assert report.findings == [], report.render_text()
    assert set(report.entries_run) == set(ENTRIES)
    noted = {n.split(":")[0] for n in report.notes}
    assert noted == {"kernels_logreg", "kernels_pca", "kernels_ops", "lb_update"} | {
        n for n in ENTRIES if n.startswith("fused_")}
