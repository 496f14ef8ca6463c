"""Paper problems (§2/§7) packaged for the live two-tier trainer, from
``repro.launch.paper_jobs``.

Group g owns the paper's partition ``[p_start(n, G, g+1), p_stop(...)]`` and
its per-group loss is scaled so that the mean over groups equals the full
objective:

    logreg:  L_g(V) = G/n · Σ_{i∈g} log(1 + e^{-y_i x_i·V}) + λ/2 ‖V‖²
    pca:     L_g(V) = -G/2 · ‖X_g V‖²_F + 1/2 ‖V‖²_F

so each group gradient is ``G·(block subgradient) + (regularizer grad)``.
Where the reference differentiates the loss with ``vmap(value_and_grad)``,
:meth:`PaperJob.group_value_and_grad` evaluates that identity through the
kernels, every group in one launch:

* logreg: ``G · K1(X, y, V, starts, widths) + λ·V``.  K1
  (``logreg_block_sub``) divides by ``X.shape[0] = n``; the factor G is
  applied after the kernel, in float32.
* pca: ``-G · K5(X_g, V) + V`` with K5 (``gram_matvec``) over the leading
  group dim.

The losses are plain torch, outside any kernel, as in the reference.  The
stacked group data lives on the device, built once in ``__post_init__``
(the reference copies it with ``jnp.asarray`` every step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.problems import (
    FiniteSumProblem,
    LogisticRegressionProblem,
    PCAProblem,
    make_genomics_like_matrix,
    make_higgs_like,
)
from repro_torch.experiments.engine import (
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
    kernel_shape_capability,
)
from repro_torch.kernels import block_sub, gram_matvec
from repro_torch.lb.partitioner import p_start, p_stop

PAPER_ARCHES = ("logreg", "pca")


def paper_train_config(eta: float, *, dsag: bool = True) -> TrainConfig:
    """The TrainConfig under which the live step is plain ``V - η·Ĥ``.

    Momentum, weight decay, gradient clipping and the bf16 cache are all
    off, so the Tier-1 update is the convergence engines' iterate rule.
    """
    return TrainConfig(
        dsag=dsag,
        optimizer="sgd",
        learning_rate=eta,
        beta1=0.0,  # make_optimizer maps beta1 -> sgd momentum
        weight_decay=0.0,
        grad_clip=0.0,
        dsag_cache_dtype="float32",
    )


@dataclasses.dataclass
class PaperJob:
    """One paper problem wired for :mod:`repro_torch.launch.train`.

    ``num_groups`` must divide ``num_samples`` (equal partitions, the live
    trainer's regime and the paper's §7 experiments').  ``engine`` names the
    device holding the data and whether the gradients run through the CUDA
    kernels or their plain versions.
    """

    problem: FiniteSumProblem
    num_groups: int
    name: str  # logreg | pca
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    def __post_init__(self):
        cap = engine_capability(self.engine)
        if not cap.supported:
            raise EngineCapabilityError(cap)
        n = self.problem.num_samples
        G = self.num_groups
        if n % G:
            raise ValueError(f"{n} samples not divisible by {G} groups")
        d = np.shape(self.problem.X)[1]
        shape_err = (block_sub.shape_error(G, n, d, None, n // G) if self.name == "logreg"
                     else gram_matvec.shape_error(G, n // G, d, self.problem.k))
        cap = kernel_shape_capability(self.engine, [shape_err])
        if not cap.supported:
            raise EngineCapabilityError(cap)
        bounds = [(p_start(n, G, i), p_stop(n, G, i)) for i in range(1, G + 1)]
        self.loads = np.array(
            [self.problem.compute_cost(s, e) for s, e in bounds], dtype=np.float64
        )
        self._fk = self.problem.fused_kernels(self.engine.device)
        dev = self._fk.device
        m = n // G
        # equal contiguous partitions: the stacked [G, m, ...] batch is a view
        # of the [n, ...] data, which K1 reads through (start, width) windows
        X = torch.as_tensor(np.asarray(self.problem.X), device=dev)
        self._batch = {"X": X.view(G, m, X.shape[1])}
        if self.name == "logreg":
            y = torch.as_tensor(np.asarray(self.problem.y), device=dev)
            self._batch["y"] = y.view(G, m)
            self._starts = torch.tensor([s for s, _ in bounds], dtype=torch.int64, device=dev)
            self._widths = torch.full((G,), m, dtype=torch.int64, device=dev)

    @property
    def device(self) -> torch.device:
        return self._fk.device

    # -- the live trainer's model interface --------------------------------
    def init_params(self, seed: int) -> torch.Tensor:
        return torch.as_tensor(self.problem.init(seed), dtype=torch.float32, device=self.device)

    def group_value_and_grad(self, params: torch.Tensor, batch: dict):
        """``(losses [G], grads [G, ...])`` of the per-group losses."""
        n = self.problem.num_samples
        G = self.num_groups
        cuda = self.engine.kernel_backend == "cuda"
        Xg = batch["X"]
        if self.name == "logreg":
            yg = batch["y"]
            lam = self.problem.lam
            z = yg * (Xg * params).sum(dim=2)
            data = (G / n) * torch.logaddexp(torch.zeros_like(z), -z).sum(dim=1)
            losses = data + 0.5 * lam * torch.sum(params * params)
            sub = block_sub.logreg_block_sub if cuda else block_sub.logreg_block_sub_plain
            Vb = params.expand(G, -1).contiguous()
            d = Xg.shape[2]
            k1 = sub(Xg.reshape(n, d), yg.reshape(n), Vb, self._starts, self._widths,
                     n // G)
            return losses, G * k1 + lam * params
        xv = torch.matmul(Xg, params)  # [G, m, k], outside any kernel as in the reference
        losses = -0.5 * G * (xv * xv).sum(dim=(1, 2)) + 0.5 * torch.sum(params * params)
        gram = gram_matvec.gram_matvec if cuda else gram_matvec.gram_matvec_plain
        return losses, -G * gram(Xg, params) + params

    def project_fn(self, params: torch.Tensor) -> torch.Tensor:
        """Stiefel re-projection after the optimizer step: the thin QR with
        the ``sign(diag(R))`` fix (PCA only)."""
        if self.name != "pca":
            return params
        # torch.linalg.qr returns a column-major Q (on the card too), and the
        # sign fix keeps its strides: K5 takes a row-major V
        return self._fk.project(params).contiguous()

    def batch_iterator(self) -> Iterator[dict[str, Any]]:
        """Full-partition batches: every step re-evaluates group g on its
        whole sample range, like the simulator's subpartitions=1 workers."""
        while True:
            yield self._batch

    def suboptimality(self, params: torch.Tensor) -> float:
        """The problem's float64 suboptimality (pulls one float to the host)."""
        return float(self._fk.suboptimality(params[None])[0])


def make_paper_job(
    arch: str, num_groups: int, *, samples: int = 1024, seed: int = 0,
    engine: EngineConfig | None = None,
) -> PaperJob:
    """Build the live job for ``--arch logreg`` / ``--arch pca``."""
    engine = engine or EngineConfig()
    if arch == "logreg":
        X, y = make_higgs_like(samples, seed=seed)
        return PaperJob(
            problem=LogisticRegressionProblem(X=X, y=y),
            num_groups=num_groups,
            name="logreg",
            engine=engine,
        )
    if arch == "pca":
        X = make_genomics_like_matrix(samples, 64, seed=seed)
        return PaperJob(
            problem=PCAProblem(X=X), num_groups=num_groups, name="pca", engine=engine
        )
    raise ValueError(f"unknown paper arch {arch!r}; expected one of {PAPER_ARCHES}")
