"""The plain reference against the program on the CPU.

With the model and the DSAG slots in float32 the program and the reference
compute the same steps, so every number the comparison reads is float32
rounding; the Tier-2 rule gives the program's controller's decisions bit for
bit on long runs of latencies with bursts."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import pytest
from _perfbench_checkout import CELLS, REPO

sys.path.insert(0, str(REPO / "perfbench"))

from harness import dsag_train, judge  # noqa: E402
from harness import traffic as gen  # noqa: E402
from reference import dsag as dsag_ref  # noqa: E402


def _cell(name: str):
    config = json.loads((CELLS / f"{name}.json").read_text())
    traffic = json.loads((CELLS / "train.smoke.json").read_text())
    return config, traffic


@pytest.mark.parametrize("name", ["mamba2-smoke", "zamba2-smoke"])
def test_float32_program_equals_reference(name):
    config, traffic = _cell(name)
    config = dict(config, dtype="float32")
    traffic = dict(traffic, train_config=dict(traffic["train_config"],
                                              dsag_cache_dtype="float32"))
    prog, ref, run = dsag_train.run(config, traffic, 2**33 + 7, 0.5, False, "cpu",
                                    time.perf_counter())
    values = judge.numbers(prog, ref)
    assert values["decisions"] == 0 and values["nonfinite"] == 0
    for k in ("loss", "grad_norm", "first_grad", "change", "change1", "h"):
        assert values[k] < 1e-5, (k, values[k])


def test_tier2_rule_equals_the_controller():
    from repro_torch.ft.runtime import DeadlineController, FailureDetector

    _, traffic = _cell("zamba2-smoke")
    traffic = dict(traffic, latency=dict(traffic["latency"], burst_rate=0.2,
                                         burst_factor_mean=2.0, burst_duration_mean=5.0))
    lat = gen.latencies(traffic, 99)[:400]
    ref = dsag_ref.decisions(lat, traffic["w"], 0.02, traffic["failure_max_misses"])
    ctl = DeadlineController(traffic["groups"], w=traffic["w"], margin=0.02)
    det = FailureDetector(traffic["groups"], max_misses=traffic["failure_max_misses"])
    for t, row in enumerate(lat):
        mask, flush = ctl.step_masks(row, t)
        was = det.failed.copy()
        det.observe(mask)
        evict = det.failed & ~was
        assert np.array_equal(ref[t], np.stack([mask, flush & ~det.failed, evict])), t
    assert ref[:, 1].any() and ref[:, 2].any() and not ref[:, 0].all()


def test_inputs_follow_the_seed_alone():
    config, traffic = _cell("mamba2-smoke")
    a = gen.tokens(traffic, config["vocab_size"], 2**40 + 1, 5, "cpu")
    b = gen.tokens(traffic, config["vocab_size"], 2**40 + 1, 5, "cpu")
    c = gen.tokens(traffic, config["vocab_size"], 2**40 + 2, 5, "cpu")
    assert a.equal(b) and not a.equal(c)
    assert int(a.min()) >= 0 and int(a.max()) < config["vocab_size"]
    rows = a.reshape(-1, a.shape[-1])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert np.array_equal(gen.latencies(traffic, 7), gen.latencies(traffic, 7))


def test_latencies_follow_the_paper_model():
    """Over the run the drawn latencies hold the traffic file's model: each
    group's mean within its range, bursts for the stationary share of the
    time, of the mean factor."""
    _, traffic = _cell("zamba2-smoke")
    spec = dict(traffic["latency"], burst_rate=0.05, burst_duration_mean=10.0)
    lat = gen.latencies(dict(traffic, latency=spec), 2**35 + 3)
    assert lat.shape == (gen.LATENCY_STEPS, traffic["groups"]) and (lat > 0).all()
    rng = np.random.default_rng(0)
    factors = np.concatenate([gen._bursts(spec, rng, 4096, 1)[:, 0] for _ in range(40)])
    share = spec["burst_rate"] * 10.0 / (1 + spec["burst_rate"] * 10.0)
    assert abs(np.mean(factors > 1) - share) < 0.05
    assert abs(np.mean(factors[factors > 1]) - spec["burst_factor_mean"]) < 0.02
    lo = spec["comm_mean"][0] + spec["comp_mean"][0]
    hi = spec["comm_mean"][1] + spec["comp_mean"][1] * 1.5
    assert (lo * 0.95 < lat.mean(0)).all() and (lat.mean(0) < hi).all()
