"""Plain reference of the DSAG training step as the benchmark drives it
(arXiv:2111.13877), in float32 with TF32 off; it imports nothing of the
program under test.

* :class:`Tier2` — the coordinator's decisions from each step's group
  latencies: every idle group starts the step's task, a busy one queues it
  (a queue of length one, the newest task kept); results arrive in order of
  their finish times; collection stops at the w-th fresh result plus the
  §5.1 margin (``margin`` times the time the w fresh ones took); a result of
  an older step that lands meanwhile is a stale arrival, accepted into the
  cache (DSAG).  A group that misses ``max_misses`` steps in a row has
  failed: its stale arrivals are refused and, the step it fails, its cache
  entry is evicted.
* :func:`train` — steps of DSAG (paper Eq. 6) on a language model: each
  group's loss and gradient by autograd through ``model.loss`` (blocks of
  rows, so that a long sequence fits), the cache rule — a fresh group's
  slot takes its gradient, a flushed group's its pending (stale) gradient,
  an evicted group's is cleared; the gradient a group computes while not
  fresh waits in its pending slot — then ``Ĥ = Σ slots / (ξ P)`` with ξ the
  share of filled slots, clipping by the global norm, adamw, and each
  parameter stored back in its own dtype (the configuration's: bfloat16
  weights, float32 norms and SSM scalars).
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch


class Tier2:
    def __init__(self, groups: int, w: int, margin: float, max_misses: int):
        self.P, self.w, self.margin, self.max_misses = groups, w, margin, max_misses
        self.now = 0.0
        self.t = 0
        self.seq = 0
        self.heap: list[tuple[float, int, int, int]] = []  # finish, seq, group, task's step
        self.busy_until = [0.0] * groups
        self.queued: list[int | None] = [None] * groups
        self.misses = np.zeros(groups, dtype=np.int64)
        self.failed = np.zeros(groups, dtype=bool)

    def _start(self, group: int, step: int, latency: float) -> None:
        finish = self.now + latency
        heapq.heappush(self.heap, (finish, self.seq, group, step))
        self.seq += 1
        self.busy_until[group] = finish

    def step(self, latencies) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(mask, flush, evict)`` of one step, given the latency each group
        takes for a task it starts during this step."""
        lat = [float(x) for x in latencies]
        mask = np.zeros(self.P, dtype=bool)
        flush = np.zeros(self.P, dtype=bool)
        start = self.now
        for i in range(self.P):
            if self.busy_until[i] <= self.now:
                self._start(i, self.t, lat[i])
            else:
                self.queued[i] = self.t
        fresh, deadline = 0, math.inf
        while self.heap and (fresh < self.w or self.heap[0][0] <= deadline):
            if self.heap[0][0] > deadline:
                break
            finish, _, i, step = heapq.heappop(self.heap)
            self.now = finish
            if self.queued[i] is not None:
                queued, self.queued[i] = self.queued[i], None
                self._start(i, queued, lat[i])
            else:
                self.busy_until[i] = self.now
            if step == self.t:
                mask[i] = True
                fresh += 1
                if fresh == self.w:
                    if self.margin <= 0:
                        break
                    deadline = self.now + self.margin * (self.now - start)
            else:
                flush[i] = True
        self.t += 1
        was_failed = self.failed.copy()
        self.misses = np.where(mask, 0, self.misses + 1)
        self.failed = self.misses >= self.max_misses
        return mask, flush & ~self.failed, self.failed & ~was_failed


def decisions(latencies: np.ndarray, w: int, margin: float, max_misses: int) -> np.ndarray:
    """``[steps, 3, P]`` bool: each step's mask, flush and evict."""
    rule = Tier2(latencies.shape[1], w, margin, max_misses)
    return np.stack([np.stack(rule.step(lat)) for lat in latencies])


def _store(t: torch.Tensor, dtype: str) -> torch.Tensor:
    """``t`` rounded to the parameter's own dtype, held in float32."""
    return t.to(getattr(torch, dtype)).to(torch.float32)


def _norms(tree: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def train(model, cfg: dict, tc: dict, params: dict[str, torch.Tensor], batches, decide,
          row_block: int) -> dict:
    """Run ``len(batches)`` DSAG steps from ``params`` (each leaf in its own
    dtype) on ``batches`` (``[P, rows, seq]`` tokens per step) under the
    decisions ``decide`` (``[steps, 3, P]``).  Returns what the benchmark
    compares: each step's group losses and the global norm of Ĥ before
    clipping; per leaf, the norm of the first gradient adamw takes, and of
    the parameters' change and of H after the last step."""
    dtypes = {path: dtype for path, _, dtype, _ in model.leaf_specs(cfg)}
    p = {k: v.to(torch.float32) for k, v in params.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    P = batches[0].shape[0]
    cache = {k: torch.zeros((P,) + v.shape, device=v.device) for k, v in p.items()}
    pending = {k: torch.zeros_like(c) for k, c in cache.items()}
    filled = np.zeros(P, dtype=bool)
    pending_valid = np.zeros(P, dtype=bool)
    b1, b2, lr, eps, wd = tc["beta1"], tc["beta2"], tc["learning_rate"], tc["eps"], tc["weight_decay"]
    out: dict = {"losses": [], "grad_norm": []}
    for step, (tokens, (mask, flush, evict)) in enumerate(zip(batches, decide)):
        mask = mask & ~evict
        flushed = flush & ~mask & pending_valid
        take_new = mask | flushed | ~pending_valid
        losses = []
        for i in range(P):
            grad, value = _group_grad(model, cfg, p, tokens[i], row_block)
            losses.append(value)
            for k in p:
                if evict[i]:
                    cache[k][i].zero_()
                elif mask[i]:
                    cache[k][i].copy_(grad[k])
                elif flushed[i]:
                    cache[k][i].copy_(pending[k][i])
                if take_new[i]:
                    pending[k][i].copy_(grad[k])
            del grad
        filled = (filled | mask | flushed) & ~evict
        pending_valid = ~mask & ~evict
        xi = min(max(filled.sum() / P, 1e-6), 1.0)
        h_hat = {k: c.sum(dim=0) / (xi * P) for k, c in cache.items()}
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in h_hat.values()))
        scale = min(1.0, tc["grad_clip"] / (gnorm + 1e-9)) if tc["grad_clip"] > 0 else 1.0
        n = step + 1
        for k in p:
            g = h_hat[k] * scale
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            upd = -lr * ((m[k] / (1 - b1 ** n)) / (torch.sqrt(v2[k] / (1 - b2 ** n)) + eps)
                         + wd * p[k])
            p[k] = _store(p[k] + upd, dtypes[k])
            h_hat[k] = g
        if step == 0:
            out["first_grad"] = _norms(h_hat)
            out["change1"] = _norms({k: p[k] - p0[k] for k in p})
        del h_hat
        out["losses"].append(losses)
        out["grad_norm"].append(gnorm)
    out["change"] = _norms({k: p[k] - p0[k] for k in p})
    out["h"] = _norms({k: c.sum(dim=0) for k, c in cache.items()})
    return out


def _group_grad(model, cfg, params, tokens, row_block: int):
    """One group's mean loss over its rows and its gradient (float32 dicts),
    ``row_block`` rows at a time: every row has as many positions, so the
    group's mean is the mean of the blocks' means weighted by their rows."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    names = list(leaves)
    rows = tokens.shape[0]
    grad = {k: torch.zeros_like(v) for k, v in params.items()}
    total = 0.0
    for r in range(0, rows, row_block):
        blk = tokens[r:r + row_block]
        loss = model.loss(cfg, leaves, blk) * (blk.shape[0] / rows)
        parts = torch.autograd.grad(loss, [leaves[k] for k in names])
        for k, g in zip(names, parts):
            grad[k].add_(g)
        total += float(loss.detach())
        del loss, parts
    return grad, total
