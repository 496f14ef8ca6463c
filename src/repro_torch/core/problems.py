"""Finite-sum problems of the paper's experiments (§2, §7), in torch.

Counterparts of ``repro.core.problems``:

* :class:`PCAProblem` — PCA as empirical-risk minimization (paper Eq. 9);
  the block subgradient is ``-X_b^T (X_b V)`` on the Stiefel manifold kept
  by the thin-QR projection.
* :class:`LogisticRegressionProblem` — L2-regularized logistic regression on
  HIGGS-like data, ``λ = 1/n``.

Problems keep their data as numpy arrays (as the reference does) and build a
:class:`FusedKernels` per torch device on demand: the data on that device,
the §3 block-subgradient dispatch (kernel K1/K2 or its plain version, by
backend), the suboptimality in float64, the projection and the regularizer
gradient.  The generators :func:`make_higgs_like` and
:func:`make_genomics_like_matrix` and the optima (numpy Newton solve, numpy
``eigvalsh``) are copied verbatim, so the same seed gives the same data and
the same optimum as the reference.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels import block_sub


def width_bucket(m: int, num_samples: int) -> int:
    """Static gather width of the reference for an interval of width ``m``.

    The next power of two, except the full range keeps its exact width.  The
    reference evaluates every width at this static shape for XLA's bit
    contract; the port's kernels loop over exact widths and do not need it.
    Kept for parity checks and for the plain versions' static pad width.
    """
    if m == num_samples:
        return m
    return 1 << (m - 1).bit_length()


@dataclasses.dataclass
class FusedKernels:
    """One problem's torch kernels on one device.

    ``sub_blocks(Vb, starts, widths, backend, max_width=None)`` evaluates G
    block subgradients at per-task windows: ``backend="cuda"`` calls the
    kernel wrapper (K1/K2), ``"torch"`` the plain version.
    ``suboptimality`` / ``project`` / ``regularizer_grad`` act on ``[S, ...]``
    iterate stacks.  ``value_dtype`` is the dtype ``sub_blocks`` returns.
    """

    device: torch.device
    num_samples: int
    value_shape: tuple[int, ...]
    value_dtype: torch.dtype
    cost_per_row: float
    kernel: Callable  # (Vb, starts, widths, max_width) -> [G, ...], K1/K2 wrapper
    plain: Callable  # the same signature, plain torch
    suboptimality: Callable  # [S, ...] -> [S] float64
    project: Callable  # [S, ...] -> [S, ...]
    regularizer_grad: Callable  # [S, ...] -> [S, ...]

    def sub_blocks(self, Vb, starts, widths, backend: str, max_width=None):
        fn = self.kernel if backend == "cuda" else self.plain
        return fn(Vb, starts, widths, max_width)


class FiniteSumProblem:
    """Interface shared by the engines: numpy data, per-device kernels."""

    num_samples: int
    cost_per_row: float

    def __post_init__(self):
        self._kernels: dict[torch.device, FusedKernels] = {}

    def init(self, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def fused_kernels(self, device="cuda") -> FusedKernels:
        """The problem's kernels on ``device`` (built once per device)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        k = self._kernels.get(dev)
        if k is None:
            k = self._build_kernels(dev)
            self._kernels[dev] = k
        return k

    def _build_kernels(self, device: torch.device) -> FusedKernels:
        raise NotImplementedError

    def compute_cost(self, start: int, stop: int) -> float:
        """Computational load c of the block (paper §3: ops count)."""
        return float(self.cost_per_row * (stop - start + 1))


# ---------------------------------------------------------------------------
# PCA on a genomics-like sparse binary matrix
# ---------------------------------------------------------------------------


def make_genomics_like_matrix(
    n: int, d: int, *, density: float = 0.0536, seed: int = 0
) -> np.ndarray:
    """Synthetic stand-in for the 1000-Genomes binary matrix (§2): sparse
    binary with ~5.36% density and a planted low-rank structure so the top
    principal components are well separated (row-permuted, like the paper)."""
    rng = np.random.default_rng(seed)
    k0 = 6
    # geometric population sizes and disjoint dense column blocks give a
    # well-separated eigenvalue ladder
    sizes = 0.5 ** np.arange(k0)
    sizes = sizes / sizes.sum()
    assign = np.clip(np.searchsorted(np.cumsum(sizes), rng.random(n)), 0, k0 - 1)
    cols = np.arange(d)
    block = np.minimum(cols * k0 // d, k0 - 1)  # column -> population block
    dense_mask = block[None, :] == assign[:, None]
    # calibrate hi/lo to hit the target overall density
    frac_dense = float(dense_mask.mean())
    hi = min(0.7 * density / max(frac_dense, 1e-6), 0.95)
    lo = max((density - hi * frac_dense) / max(1 - frac_dense, 1e-6), density * 0.05)
    probs = np.where(dense_mask, hi, lo)
    x = (rng.random((n, d)) < probs).astype(np.float32)
    perm = rng.permutation(n)
    return x[perm]


@dataclasses.dataclass
class PCAProblem(FiniteSumProblem):
    X: np.ndarray  # [n, d]
    k: int = 3

    def __post_init__(self):
        super().__post_init__()
        self.num_samples = int(self.X.shape[0])
        self.dim = int(self.X.shape[1])
        self.cost_per_row = 2.0 * self.dim * self.k
        # reference optimum: exact top-k eigendecomposition of X^T X
        gram = np.asarray(self.X, dtype=np.float64).T @ np.asarray(self.X, np.float64)
        evals = np.linalg.eigvalsh(gram)
        self._opt_explained = float(np.sum(np.sort(evals)[::-1][: self.k]))
        self._total_var = float(np.trace(gram))

    def init(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(self.dim, self.k)).astype(np.float32)
        q, _ = np.linalg.qr(v)
        return q

    def _build_kernels(self, device: torch.device) -> FusedKernels:
        X = torch.as_tensor(self.X, device=device)
        X64 = X.to(torch.float64)
        opt, total = self._opt_explained, self._total_var

        def kernel(Vb, starts, widths, max_width=None):
            return block_sub.pca_block_sub(X, Vb, starts, widths, max_width)

        def plain(Vb, starts, widths, max_width=None):
            return block_sub.pca_block_sub_plain(X, Vb, starts, widths, max_width)

        def suboptimality(V_stack):
            # (optimal explained variance - achieved) / total variance, in
            # float64 (the reference's X64 @ V, outside any Pallas kernel)
            xv = X64 @ V_stack.to(torch.float64)  # [S, n, k]
            explained = (xv * xv).sum(dim=(1, 2))
            return torch.clamp_min((opt - explained) / total, 1e-16)

        def project(V_stack):
            # Gram-Schmidt == thin-QR orthonormalization, sign-fixed
            q, r = torch.linalg.qr(V_stack)
            diag = torch.diagonal(r, dim1=-2, dim2=-1)
            return q * torch.sign(diag)[..., None, :]

        return FusedKernels(
            device=device,
            num_samples=self.num_samples,
            value_shape=(self.dim, self.k),
            value_dtype=X.dtype,
            cost_per_row=self.cost_per_row,
            kernel=kernel,
            plain=plain,
            suboptimality=suboptimality,
            project=project,
            regularizer_grad=lambda V_stack: V_stack,  # ∇ 1/2||V||_F^2
        )


# ---------------------------------------------------------------------------
# Logistic regression on HIGGS-like data
# ---------------------------------------------------------------------------


def make_higgs_like(
    n: int, d: int = 28, *, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic binary-classification data shaped like HIGGS (28 features,
    labels ±1), feature-normalized with an intercept appended (paper §7)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    logits = x @ w_true + 0.5 * rng.normal(size=(n,)).astype(np.float32)
    y = np.where(rng.random(n) < 1.0 / (1.0 + np.exp(-logits)), 1.0, -1.0).astype(
        np.float32
    )
    # normalize to zero mean / unit variance, add intercept = 1
    x = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-8)
    x = np.concatenate([x, np.ones((n, 1), np.float32)], axis=1)
    return x, y


@dataclasses.dataclass
class LogisticRegressionProblem(FiniteSumProblem):
    X: np.ndarray  # [n, d] (already includes intercept column)
    y: np.ndarray  # [n] in {-1, +1}
    lam: float | None = None  # default 1/n, as in the paper

    def __post_init__(self):
        super().__post_init__()
        self.num_samples = int(self.X.shape[0])
        self.dim = int(self.X.shape[1])
        self.cost_per_row = 2.0 * self.dim
        if self.lam is None:
            self.lam = 1.0 / self.num_samples
        self._opt: np.ndarray | None = None

    def init(self, seed: int = 0) -> np.ndarray:
        return np.zeros((self.dim,), dtype=np.float32)

    def _solve_optimum(self) -> np.ndarray:
        """Newton's method — logreg is strongly convex with λ>0."""
        v = np.zeros(self.dim, dtype=np.float64)
        x = self.X.astype(np.float64)
        y = self.y.astype(np.float64)
        n = self.num_samples
        for _ in range(50):
            z = y * (x @ v)
            s = 1.0 / (1.0 + np.exp(z))  # σ(-z)
            grad = -(x.T @ (y * s)) / n + self.lam * v
            w = s * (1.0 - s)
            hess = (x.T * w) @ x / n + self.lam * np.eye(self.dim)
            step = np.linalg.solve(hess, grad)
            v = v - step
            if np.linalg.norm(step) < 1e-12:
                break
        return v

    @property
    def optimum(self) -> np.ndarray:
        if self._opt is None:
            self._opt = self._solve_optimum()
        return self._opt

    def _build_kernels(self, device: torch.device) -> FusedKernels:
        X = torch.as_tensor(self.X, device=device)
        y = torch.as_tensor(self.y, device=device)
        X64, y64 = X.to(torch.float64), y.to(torch.float64)
        lam = self.lam

        def kernel(Vb, starts, widths, max_width=None):
            return block_sub.logreg_block_sub(X, y, Vb, starts, widths, max_width)

        def plain(Vb, starts, widths, max_width=None):
            return block_sub.logreg_block_sub_plain(X, y, Vb, starts, widths, max_width)

        def objective(V_stack):
            V64 = V_stack.to(torch.float64)
            z = y64 * (V64 @ X64.T)  # [S, n]
            loss = torch.logaddexp(torch.zeros_like(z), -z).mean(dim=1)
            return loss + 0.5 * lam * (V64 * V64).sum(dim=1)

        # the optimum's objective through the same float64 expression, so
        # the suboptimality of the optimum itself is ~0, not a device offset
        opt_obj = objective(torch.as_tensor(self.optimum, device=device)[None])[0]

        def suboptimality(V_stack):
            return torch.clamp_min(objective(V_stack) - opt_obj, 1e-16)

        return FusedKernels(
            device=device,
            num_samples=self.num_samples,
            value_shape=(self.dim,),
            value_dtype=X.dtype,
            cost_per_row=self.cost_per_row,
            kernel=kernel,
            plain=plain,
            suboptimality=suboptimality,
            project=lambda V_stack: V_stack,  # G = identity
            # lam * V stays in V's float32, as the reference's weakly typed
            # python-float product does
            regularizer_grad=lambda V_stack: lam * V_stack,
        )
