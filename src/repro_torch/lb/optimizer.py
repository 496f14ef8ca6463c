"""Load-balancing optimizer (paper §6.2, Algorithm 1): the numpy-facing entry
points of the scalar ``TrainingSimulator`` and the host engine (counterpart
of ``repro.lb.optimizer``).

Given per-worker latency statistics from the profiler, produce an updated
subpartition-count vector p' that (i) equalizes expected total
per-iteration latency across workers and (ii) keeps the contribution
h(p') >= h_min, where h is estimated by replaying what-if latency traces
through the §4.2 event dynamics.  All numerical work is in
:mod:`repro_torch.lb.jit_optimizer`, which the device engine calls on its
own tensors; this class converts numpy inputs to float64 tensors on its
device and back.

The §6.2 linearisation:

    e'_{Z,i} = e_{Z,i} * p_i / p'_i        (computation mean)
    v'_{Z,i} = v_{Z,i} * p_i^2 / p'_i^2    (computation variance)
    e'_{X,i} = e_{Y,i} + e'_{Z,i}          (total)

**The what-if draws.**  h replays gamma draws made from one fixed ``[N, K]``
standard-normal base per component, drawn as the reference draws them:
``jax.random.normal`` of the two halves of ``jax.random.split(PRNGKey(seed))``,
computed bit for bit in numpy by :mod:`repro_torch.lb.threefry`.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.experiments.engine import checked_device
from repro_torch.lb import jit_optimizer as jlb
from repro_torch.lb import threefry
from repro_torch.lb.partitioner import build_p_ladder


@functools.lru_cache(maxsize=8)
def _draws(seed: int, num_workers: int, K: int) -> np.ndarray:
    keys = threefry.split(threefry.PRNGKey(seed))
    return np.stack([threefry.normal(k, (num_workers, K)) for k in keys])


def what_if_normals(seed: int, num_workers: int, K: int = jlb.SIM_ITERATIONS,
                    device="cpu") -> torch.Tensor:
    """The ``[2, N, K]`` float64 standard-normal bases (comm, comp) of the
    what-if draws, equal bit for bit to the reference's."""
    arr = _draws(int(seed), int(num_workers), int(K))
    return torch.tensor(arr, dtype=torch.float64, device=device)


@dataclasses.dataclass
class OptimizerInputs:
    """Latest profiler statistics: ``[N]`` arrays for one scenario (the
    scalar simulator) or ``[S, N]`` for a batch; ``w`` and ``margin`` are
    shared across the batch (one method configuration)."""

    e_comm: np.ndarray  # e_{Y,i}
    v_comm: np.ndarray  # v_{Y,i}
    e_comp: np.ndarray  # e_{Z,i}  (at the CURRENT p_i)
    v_comp: np.ndarray  # v_{Z,i}
    samples_per_worker: np.ndarray  # n_i
    w: int  # wait-for-w setting of the running method
    margin: float = 0.02

    def as_batch(self) -> OptimizerInputs:
        """View with a leading scenario axis (no copy for 2-D inputs)."""
        if np.ndim(self.e_comm) == 2:
            return self

        def row(a):
            return np.asarray(a, np.float64)[None, :]

        return OptimizerInputs(
            e_comm=row(self.e_comm), v_comm=row(self.v_comm), e_comp=row(self.e_comp),
            v_comp=row(self.v_comp), samples_per_worker=row(self.samples_per_worker),
            w=self.w, margin=self.margin,
        )


class LoadBalanceOptimizer:
    """Iterative ladder solver for paper Eq. (7) / Algorithm 1.

    ``ladder`` fixes the candidate subpartition counts (built from the first
    call's p and sample counts when omitted); the engines pass theirs so all
    climb the same rungs.  ``what_if_normals`` (``[2, N, K]``) overrides the
    draws :func:`what_if_normals` would pick for ``seed``; ``device`` is
    where the float64 arithmetic runs (default the card, as
    ``EngineConfig``'s; a missing card is refused with
    ``cuda-device-unavailable``), ``kernel_backend`` whether the what-if
    replay launches kernel K7 there (``"cuda"``) or its plain version
    (``"torch"``; the CPU always takes the plain version).
    """

    def __init__(
        self,
        *,
        h_tolerance: float = jlb.H_TOLERANCE,
        sim_iterations: int = jlb.SIM_ITERATIONS,
        max_rounds: int = jlb.MAX_ROUNDS,
        improvement_threshold: float = jlb.IMPROVEMENT_THRESHOLD,
        seed: int = 0,
        ladder: tuple[int, ...] | None = None,
        what_if_normals=None,
        device="cuda",
        kernel_backend: str = "cuda",
    ):
        self.h_tolerance = h_tolerance
        self.sim_iterations = sim_iterations
        self.max_rounds = max_rounds
        #: only publish a new p if the objective improves by this much
        #: (paper §6.3 first mitigation strategy, default 10%)
        self.improvement_threshold = improvement_threshold
        self.seed = seed
        self.ladder = tuple(ladder) if ladder is not None else None
        self.device = checked_device(device)
        self.kernel_backend = kernel_backend
        self._normals = (
            None if what_if_normals is None
            else torch.as_tensor(np.asarray(what_if_normals), dtype=torch.float64,
                                 device=self.device)
        )
        self.h_min: float | None = None
        #: h at the *returned* p' of the last optimize() call
        self.last_h: float | None = None

    # -- shared pieces -----------------------------------------------------
    def _ladder_for(self, p: np.ndarray, n_j: np.ndarray) -> tuple[int, ...]:
        if self.ladder is None:
            self.ladder = build_p_ladder(int(np.max(p)), int(np.max(n_j)))
        return self.ladder

    def normals(self, num_workers: int) -> torch.Tensor:
        """The what-if normal bases for ``num_workers`` on the optimizer's device."""
        if self._normals is None or self._normals.shape[1] != num_workers:
            self._normals = what_if_normals(self.seed, num_workers, self.sim_iterations,
                                            self.device)
        return self._normals

    def _t(self, a, dtype=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- h(p) via batched what-if trace replay ------------------------------
    def estimate_h(self, inputs: OptimizerInputs, p: Sequence[int], p_new: Sequence[int]) -> float:
        """h(p') for one scenario's inputs; deterministic given (draws,
        inputs, p, p'), so re-estimating at a returned vector reproduces
        ``last_h``."""
        b = inputs.as_batch()
        N = np.shape(b.e_comm)[1]
        h = jlb.estimate_h(
            self._t(b.e_comm), self._t(b.v_comm), self._t(b.e_comp), self._t(b.v_comp),
            self._t(b.samples_per_worker), self._t(p)[None, :], self._t(p_new)[None, :],
            w=int(b.w), margin=float(b.margin), normals=self.normals(N),
            K=int(self.sim_iterations), kernel_backend=self.kernel_backend,
        )
        return float(h.cpu()[0])

    # -- Algorithm 1 + publication gate (batched) ---------------------------
    def update_batch(
        self,
        p: np.ndarray,
        inputs: OptimizerInputs,
        h_min: np.ndarray | None = None,
        active: np.ndarray | None = None,
        alive: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Algorithm 1 and the §6.3 publish gate for S scenarios at once.

        ``p`` is ``[S, N]`` int, ``inputs`` holds ``[S, N]`` arrays, ``h_min``
        the per-scenario contribution floor carried across calls (NaN = not
        yet established), ``active`` which scenarios balance this round,
        ``alive`` (``[S, N]`` bool, optional) the churn liveness mask (dead
        workers are left out of the hill-climb and keep their p; see
        :func:`repro_torch.lb.jit_optimizer.algorithm1`).
        Returns ``(p_new [S, N] int64, h_min [S], last_h [S], publish [S])``.
        """
        p = np.asarray(p, dtype=np.int64)
        S, N = p.shape
        if h_min is None:
            h_min = np.full(S, np.nan)
        if active is None:
            active = np.ones(S, dtype=bool)
        ladder = self._ladder_for(p, inputs.samples_per_worker)
        p_new, h_min_out, last_h, publish = jlb.lb_update(
            self._t(p), self._t(inputs.e_comm), self._t(inputs.v_comm),
            self._t(inputs.e_comp), self._t(inputs.v_comp),
            self._t(inputs.samples_per_worker), self._t(h_min),
            self._t(active, torch.bool),
            ladder=ladder, w=int(inputs.w), margin=float(inputs.margin),
            normals=self.normals(N), K=int(self.sim_iterations),
            h_tol=float(self.h_tolerance), max_rounds=int(self.max_rounds),
            threshold=float(self.improvement_threshold), kernel_backend=self.kernel_backend,
            alive=None if alive is None else self._t(alive, torch.bool),
        )
        return (
            p_new.cpu().numpy().astype(np.int64),
            h_min_out.cpu().numpy(),
            last_h.cpu().numpy(),
            publish.cpu().numpy().astype(bool),
        )

    def optimize_batch(self, p: np.ndarray, inputs: OptimizerInputs,
                       h_min: np.ndarray | None = None):
        """Algorithm 1 for S scenarios (no publish gate): see update_batch."""
        p_new, h_min_out, last_h, _ = self.update_batch(p, inputs, h_min)
        return p_new, h_min_out, last_h

    def optimize(self, p: Sequence[int], inputs: OptimizerInputs) -> np.ndarray:
        """Algorithm 1 for one scenario (an S = 1 batch); keeps ``h_min`` and
        ``last_h`` on the optimizer."""
        hm = None if self.h_min is None else np.array([self.h_min])
        p_new, h_min, last_h = self.optimize_batch(
            np.asarray(p, dtype=np.int64)[None, :], inputs.as_batch(), hm
        )
        self.h_min = float(h_min[0])
        self.last_h = float(last_h[0])
        return p_new[0]

    # -- publication gate (paper §6.3) -------------------------------------
    def should_publish_batch(self, p: np.ndarray, p_new: np.ndarray,
                             inputs: OptimizerInputs) -> np.ndarray:
        """``[S]`` bool: the Eq.-(7) objective improves by more than
        ``improvement_threshold``."""
        out = jlb.should_publish(
            self._t(p), self._t(p_new), self._t(inputs.e_comm), self._t(inputs.e_comp),
            float(self.improvement_threshold),
        )
        return out.cpu().numpy().astype(bool)

    def should_publish(self, p: Sequence[int], p_new: Sequence[int],
                       inputs: OptimizerInputs) -> bool:
        """Paper §6.3: distribute p' only if the Eq.-(7) objective improves by
        more than ``improvement_threshold`` (cache evictions are costly)."""
        return bool(
            self.should_publish_batch(
                np.asarray(p, np.float64)[None, :],
                np.asarray(p_new, np.float64)[None, :],
                inputs.as_batch(),
            )[0]
        )
