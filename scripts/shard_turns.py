#!/usr/bin/env python3
"""Time four scenario shards on one card three ways, beside the unsharded run.

    python3 scripts/shard_turns.py      # on a machine with a CUDA card

The `pca_paper_scale` recipe's dsag at the `pca_grid_sharded` column's 40
scenarios, through the device engine: unsharded; four shards of cuda:0 run
one after another in the caller's thread; four shards in free threads (a
thread and a stream per shard, all at once); and four shards in threads that
take turns (the engine's driver, `experiments/fused.py::_run_sharded`).  The
runs go in turns (plain, caller, free, turns, turns, free, caller, plain)
and each must equal the unsharded run bit for bit.  Prints the card's name
and power limit, then each way's wall clocks.
"""

from __future__ import annotations

import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    import torch

    from repro_torch.experiments import fused
    from repro_torch.experiments.convergence import (
        paper_scale_pca_sweep,
        result_mismatches,
        run_convergence_batch,
    )
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.mesh import ScenarioMesh

    if not torch.cuda.is_available():
        raise SystemExit("shard_turns.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    # the recipe at 40 scenarios, once through (builds the kernels, warms the shapes)
    out, _ = paper_scale_pca_sweep(n_scenarios=40, engine=EngineConfig(kind="scan"))
    cfg = out.methods["dsag"]
    mesh = ScenarioMesh((torch.device("cuda", 0),) * 4)
    turns = fused._run_sharded

    def caller(spec, eval_mask, shards):
        return [sh.run(spec, eval_mask) for sh in shards]

    def free(spec, eval_mask, shards):
        streams = []
        for sh in shards:
            st = torch.cuda.Stream(device=sh.kernels.device)
            st.wait_stream(torch.cuda.current_stream(sh.kernels.device))
            streams.append(st)

        def work(sh, st):
            with torch.cuda.device(st.device), torch.cuda.stream(st):
                return sh.run(spec, eval_mask)

        with ThreadPoolExecutor(max_workers=len(shards)) as pool:
            futures = [pool.submit(work, sh, st) for sh, st in zip(shards, streams)]
            return [f.result() for f in futures]

    drivers = {"caller": caller, "free": free, "turns": turns}
    seconds: dict[str, list[float]] = {}
    try:
        for way in ("plain", "caller", "free", "turns", "turns", "free", "caller", "plain"):
            fused._run_sharded = drivers.get(way, turns)
            eng = EngineConfig(kind="scan", mesh=None if way == "plain" else mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run_convergence_batch(out.problem, out.traces, cfg, out.num_iterations,
                                      eval_every=out.eval_every, seed=out.seed, engine=eng)
            torch.cuda.synchronize()
            seconds.setdefault(way, []).append(time.perf_counter() - t0)
            bad = result_mismatches(r, out.results["dsag"])
            if bad:
                raise SystemExit(f"{way}: the run differs from the unsharded one in {bad}")
    finally:
        fused._run_sharded = turns
    for way, secs in seconds.items():
        print(f"{way:>7}: {', '.join(f'{s:.3f}' for s in secs)} s")


if __name__ == "__main__":
    main()
