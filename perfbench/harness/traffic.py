"""The one generator of the benchmark's inputs, driven by a traffic file.

Every input is a function of ``--seed`` and of the traffic file's
parameters alone, drawn in the same order whatever the run's length:

* :func:`tokens` — one step's batch ``[groups, rows, seq]`` of token ids
  on the device: ids from a Zipf law over a permutation of the vocabulary
  (``tokens.zipf``), and each position, with probability
  ``tokens.repeat``, a copy of the token ``1..tokens.max_lag`` positions
  before it (structure a model can learn).  Each step has its own stream,
  so step k's batch does not depend on how many steps a run takes.
* :func:`latencies` — ``[steps, groups]`` seconds each group takes for a
  task it starts at that step, by the paper's latency model (arXiv
  2111.13877 §3: ``X = Y + Z``, independent gamma communication and
  computation terms whose means differ from group to group; §3.2 and
  Fig. 4: multiplicative bursts that arrive as a Poisson process and last
  an exponential time).  Each group's means are drawn uniformly from
  ``latency.comm_mean`` and ``latency.comp_mean``, each draw has the
  coefficient of variation ``latency.comm_cv`` / ``latency.comp_cv``; a
  burst arrives at ``latency.burst_rate`` a second, multiplies the
  computation by ``1 + Exp(latency.burst_factor_mean - 1)`` and lasts
  ``Exp(latency.burst_duration_mean)`` seconds; a group is in a burst at
  the start with the process's stationary probability.  Step k is read at
  ``k * latency.seconds_per_step`` seconds.
"""

from __future__ import annotations

import numpy as np
import torch

#: steps of latencies drawn for every run, whatever its length
LATENCY_STEPS = 4096

_TOKENS, _LATENCY, _WEIGHTS = 1, 2, 3


def substream(seed: int, *tags: int) -> int:
    """A 63-bit seed for the stream ``tags`` of ``seed``."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(1, np.uint64)[0] >> 1)


def weight_seed(seed: int) -> int:
    return substream(seed, _WEIGHTS)


def tokens(traffic: dict, vocab: int, seed: int, step: int, device) -> torch.Tensor:
    spec = traffic["tokens"]
    groups, rows = traffic["groups"], traffic["global_batch"] // traffic["groups"]
    shape = (groups, rows, traffic["seq_len"])
    gen = torch.Generator(device=device).manual_seed(substream(seed, _TOKENS))
    ids = torch.randperm(vocab, generator=gen, device=device)
    probs = torch.arange(1, vocab + 1, dtype=torch.float32, device=device).pow(-spec["zipf"])
    gen.manual_seed(substream(seed, _TOKENS, step))
    draw = ids[torch.multinomial(probs, int(np.prod(shape)), replacement=True,
                                 generator=gen)].view(shape)
    copy = torch.rand(shape, generator=gen, device=device) < spec["repeat"]
    lag = torch.randint(1, spec["max_lag"] + 1, shape, generator=gen, device=device)
    src = torch.arange(shape[-1], device=device) - lag
    copy &= src >= 0
    out = torch.where(copy, torch.gather(draw, -1, src.clamp(min=0)), draw)
    return out.to(torch.int32)


def _gamma(rng: np.random.Generator, means: np.ndarray, cv: float, steps: int) -> np.ndarray:
    shape = 1.0 / cv**2
    return rng.gamma(shape, means / shape, (steps, means.size))


def _bursts(spec: dict, rng: np.random.Generator, steps: int, groups: int) -> np.ndarray:
    """``[steps, groups]`` burst factors: for each group, an alternating
    run of idle and burst times from its stationary start, read at the
    steps' times."""
    out = np.ones((steps, groups))
    rate, dur = spec["burst_rate"], spec["burst_duration_mean"]
    if rate <= 0:
        return out
    times = np.arange(steps) * spec["seconds_per_step"]
    busy = rate * dur / (1.0 + rate * dur)  # the share of time in a burst
    for g in range(groups):
        t, burst = 0.0, rng.random() < busy
        while t <= times[-1]:
            if burst:
                end = t + rng.exponential(dur)
                out[(times >= t) & (times < end), g] = 1.0 + rng.exponential(
                    spec["burst_factor_mean"] - 1.0)
                t = end
            else:
                t += rng.exponential(1.0 / rate)
            burst = not burst
    return out


def latencies(traffic: dict, seed: int) -> np.ndarray:
    spec, groups = traffic["latency"], traffic["groups"]
    rng = np.random.default_rng(substream(seed, _LATENCY))
    steps = LATENCY_STEPS
    comm = rng.uniform(*spec["comm_mean"], groups)
    comp = rng.uniform(*spec["comp_mean"], groups)
    y = _gamma(rng, comm, spec["comm_cv"], steps)
    z = _gamma(rng, comp, spec["comp_cv"], steps)
    return y + z * _bursts(spec, rng, steps, groups)
