#!/usr/bin/env python3
"""Readings that the limits of a cell are set from (``limits/<cell>.json``).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--variants program control half_batch flip] [--out <file.jsonl>]

For each seed, in one process: the program's set-up steps as a benchmark run
makes them (``program``), the same with the control switched on (the
program's int8 DSAG slots, ``faults.CONTROL``) and with each fault of
``faults.py`` planted, then the plain reference once; every variant's
numbers (``harness.judge.numbers``) against it, one JSON line each.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent / "src"), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import faults  # noqa: E402
import run as bench_run  # noqa: E402
from harness import dsag_train, judge  # noqa: E402


def readings(config: dict, traffic: dict, seed: int, device: str, variant: str) -> dict:
    if variant == "control":
        traffic = dict(traffic, train_config=dict(traffic["train_config"], **faults.CONTROL))
    fault = faults.planted(variant) if variant in faults.FAULTS else contextlib.nullcontext()
    with fault:
        s = dsag_train.Session(config, traffic, seed, device)
        out, step_s = s.warm()
    out["decisions"] = np.stack(s.decisions)
    out["nonfinite"] = 0
    out["step_s"] = step_s
    s.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _, _, config, traffic, _ = bench_run.load(HERE.parent, args.workload)
    sink = open(args.out, "a") if args.out else None  # noqa: SIM115
    try:
        for seed in args.seeds:
            progs = {}
            for v in args.variants:
                t0 = time.perf_counter()
                progs[v] = readings(config, traffic, seed, args.device, v)
                progs[v]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = dsag_train.reference(config, traffic, seed, args.device,
                                       traffic["check_steps"])
            ref_s = time.perf_counter() - t0
            for v, prog in progs.items():
                line = {"workload": args.workload, "seed": seed, "variant": v,
                        "numbers": judge.numbers(prog, ref), "program_s": prog["seconds"],
                        "step_s": prog["step_s"], "reference_s": ref_s,
                        "losses": prog["losses"], "ref_losses": ref["losses"],
                        "grad_norm": prog["grad_norm"], "ref_grad_norm": ref["grad_norm"],
                        "leaves": {k: {"program": prog[k], "reference": ref[k]}
                                   for k in ("first_grad", "change1", "change", "h")}}
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
