#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration file (the
``file`` of its ``configs`` entry) and the plain reference that file names
(``reference/<name>.py``), its traffic file (``traffic/<traffic>.json``,
whose ``runner`` names the module of ``harness/`` that runs it), its
limits (``limits/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``).  A run needs a CUDA card (``chips`` of them):
without, it prints no result and exits 2.  The last line of standard output
is the result, a JSON object; the numbers the comparison held against their
limits close standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# set before torch is first imported: the allocator maps segments that grow
# in place rather than caching blocks of fixed sizes, so a step's peak is
# not raised by fragments (zamba2-2.7b's step fits in 80 GB only so)
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for path in (str(ROOT / "src"), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(root: Path, workload: str) -> tuple[dict, dict, dict, dict, dict]:
    """``(benchmark, cell, configuration, traffic, limits)`` of ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    here = root / "perfbench"
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    return bench, cell, config, traffic, limits


def metric_names(bench: dict, workload: str, traced: bool) -> list[str]:
    """The cell's metrics: the per-layer ones traced, else the end-to-end."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m["name"] for m in group if workload in m.get("workloads", [workload])]


def read_metric(root: Path, name: str, run):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", root / "perfbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device: str) -> tuple[dict, dict]:
    """One run on ``device``: ``(result line, checks)``."""
    import torch

    from harness import judge

    bench, cell, config, traffic, limits = load(root, workload)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    runner = importlib.import_module(f"harness.{traffic['runner']}")
    prog, ref, run = runner.run(config, traffic, seed, seconds, traced, device, T_START)
    values = judge.numbers(prog, ref)
    ok, checks = judge.verdict(values, limits)
    metrics = {}
    for name in metric_names(bench, workload, traced):
        value = read_metric(root, name, run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": ok and prog["nonfinite"] == 0, "attempted": run.steps,
              "failed": prog["nonfinite"], "metrics": metrics, "device": dev}
    if traced:
        p = run.profile
        dev["busy_s"] = p.busy_ns / 1e9 if p else 0.0
        dev["window_s"] = p.stretch_ns / 1e9 if p else 0.0
        if p:
            ops = sorted(p.time_by_name().items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(p.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [[n[:160], t / 1e9] for n, t in ops],
                                   "idle_gaps": [[n[:160], t / 1e9] for n, t in gaps]}
    result["checks"] = checks
    return result, checks


def main(argv: list[str] | None = None, device: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if device is None:
        import torch

        bench, cell, *_ = load(ROOT, args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    result, checks = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              device)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
