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

Every float expression that feeds the convergence engines lives here once:
the scalar ``TrainingSimulator`` and the host engine call the numpy-facing
methods of :class:`FiniteSumProblem` (which run the same
:class:`FusedKernels` on the engine's device), the device engine calls the
kernels directly.  The three agree bit for bit because every result is
independent of the batch it was computed in:

* a task's block subgradient depends on its window and on the pad width of
  the call (K1's slab count and warps, the plain versions' gather width),
  never on the other tasks: every engine passes the run's static
  :func:`~repro_torch.cluster.simulator.task_pad_width`;
* the suboptimality and the projection are taken one iterate at a time, as
  the reference maps them with ``lax.map``: a batched float64 product or
  reduction need not sum in a single iterate's order (MKL's on the CPU does
  not; cuBLAS, cuSOLVER and torch's reductions choose their kernels by
  shape).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.experiments.engine import as_engine_config
from repro_torch.kernels import block_sub

F64 = torch.float64


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
    iterate stacks; so does ``value``, the float64 quantity the
    suboptimality is measured on (logreg's objective, PCA's explained
    variance), and ``optimum_value`` is its value at the optimum.
    ``value_dtype`` is the dtype ``sub_blocks`` returns.
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
    value: Callable  # [S, ...] -> [S] float64
    optimum_value: float

    def sub_blocks(self, Vb, starts, widths, backend: str, max_width=None):
        fn = self.kernel if backend == "cuda" else self.plain
        return fn(Vb, starts, widths, max_width)


def _map_rows(one):
    """``one`` (an iterate -> a tensor) over the rows of an ``[S, ...]``
    stack, one call per row: each row's bits are then those of the same
    iterate alone (what ``lax.map`` gives the reference)."""

    def mapped(V_stack):
        return torch.stack([one(V_stack[s]) for s in range(V_stack.shape[0])])

    return mapped


def _sign_fixed_qr(V):
    """Gram-Schmidt == thin-QR orthonormalization with ``sign(diag(R))``
    fixed, row-major (the QR's Q is column-major, on the card too)."""
    q, r = torch.linalg.qr(V)
    return (q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]).contiguous()


class FiniteSumProblem:
    """Interface shared by the engines: numpy data, per-device kernels.

    The numpy-facing methods below are what the scalar ``TrainingSimulator``
    and the host engine call: numpy in, numpy out, each evaluated through
    :meth:`fused_kernels` on ``engine.device`` (default ``EngineConfig()``:
    the card, kernels K1/K2) with ``engine.kernel_backend``.  Subgradients
    take the run's static ``pad_width`` (see the module docstring).
    """

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

    def compute_cost_batch(self, starts, stops) -> np.ndarray:
        """Vectorized :meth:`compute_cost` (same float expression per row)."""
        rows = np.asarray(stops, dtype=np.int64) - np.asarray(starts, np.int64) + 1
        return self.cost_per_row * rows

    # -- numpy-facing methods (scalar simulator, host engine) ---------------
    def _kernels_for(self, engine):
        eng = as_engine_config(engine, _stacklevel=3)
        return self.fused_kernels(eng.device), eng.kernel_backend

    def subgradient(self, V, start: int, stop: int, *, pad_width=None, engine=None):
        """Sum of ∇f_k(V) for k in [start, stop] (1-based inclusive)."""
        return self.subgradient_blocks_masked(
            np.asarray(V)[None], np.array([start]), np.array([stop]),
            pad_width=pad_width, engine=engine,
        )[0]

    def subgradient_blocks(self, V_stack, starts, stops, *, pad_width=None, engine=None):
        """[G, ...] block subgradients of G equal-width (iterate, interval)
        tasks; row g equals ``subgradient(V_stack[g], starts[g], stops[g])``
        bit for bit at the same ``pad_width``."""
        widths = np.asarray(stops, np.int64) - np.asarray(starts, np.int64) + 1
        if widths.size and not np.all(widths == widths[0]):
            raise ValueError("subgradient_blocks requires equal-width intervals")
        return self.subgradient_blocks_masked(
            V_stack, starts, stops, pad_width=pad_width, engine=engine
        )

    def subgradient_blocks_masked(
        self, V_stack, starts, stops, *, pad_width=None, engine=None
    ):
        """Like :meth:`subgradient_blocks` for mixed-width intervals: one
        kernel call (the kernels take per-task windows), rows past each
        width masked.  ``pad_width`` (default: the widest interval) bounds
        every width."""
        k, backend = self._kernels_for(engine)
        starts = np.asarray(starts, dtype=np.int64)
        widths = np.asarray(stops, dtype=np.int64) - starts + 1
        if widths.size == 0:
            return np.zeros((0,) + k.value_shape, dtype=np.float32)
        W = int(widths.max()) if pad_width is None else int(pad_width)
        if widths.max() > W:
            raise ValueError(f"an interval is wider than pad_width={W}")
        # fresh tensors on the device (torch.tensor copies)
        out = k.sub_blocks(
            torch.tensor(np.asarray(V_stack), device=k.device),
            torch.tensor(starts, device=k.device),
            torch.tensor(widths, device=k.device),
            backend,
            W,
        )
        return out.cpu().numpy()

    def regularizer_grad(self, V: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def project(self, V, *, engine=None) -> np.ndarray:
        """The G(·) operator of paper Eq. (2)."""
        return self.project_batch(np.asarray(V)[None], engine=engine)[0]

    def project_batch(self, V_stack, *, engine=None) -> np.ndarray:
        """Apply G(·) to a stack of iterates, one at a time (the device
        engine's call)."""
        k, _ = self._kernels_for(engine)
        return k.project(torch.tensor(np.asarray(V_stack), device=k.device)).cpu().numpy()

    def suboptimality(self, V, *, engine=None) -> float:
        return float(self.suboptimality_batch(np.asarray(V)[None], engine=engine)[0])

    def suboptimality_batch(self, V_stack, *, engine=None) -> np.ndarray:
        """[S] float64 suboptimality gaps; row s equals
        ``suboptimality(V_stack[s])`` bit for bit (one iterate per call)."""
        k, _ = self._kernels_for(engine)
        return k.suboptimality(torch.tensor(np.asarray(V_stack), device=k.device)).cpu().numpy()

    def _value_batch(self, V_stack, engine) -> np.ndarray:
        k, _ = self._kernels_for(engine)
        return k.value(torch.tensor(np.asarray(V_stack), device=k.device)).cpu().numpy()


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

        def explained_one(V):
            # float64, the reference's X64 @ V outside any Pallas kernel
            xv = X64 @ V.to(F64).contiguous()  # [n, k]
            return (xv * xv).sum()

        def suboptimality_one(V):
            # (optimal explained variance - achieved) / total variance
            return torch.clamp_min((opt - explained_one(V)) / total, 1e-16)

        return FusedKernels(
            device=device,
            num_samples=self.num_samples,
            value_shape=(self.dim, self.k),
            value_dtype=X.dtype,
            cost_per_row=self.cost_per_row,
            kernel=kernel,
            plain=plain,
            suboptimality=_map_rows(suboptimality_one),
            project=_map_rows(_sign_fixed_qr),
            regularizer_grad=lambda V_stack: V_stack,  # ∇ 1/2||V||_F^2
            value=_map_rows(explained_one),
            optimum_value=opt,
        )

    def regularizer_grad(self, V: np.ndarray) -> np.ndarray:
        return V  # ∇ 1/2||V||_F^2

    def explained_variance(self, V, *, engine=None) -> float:
        """``||X V||_F^2`` in float64 (what the suboptimality compares with
        the top-k eigenvalues' sum)."""
        return float(self._value_batch(np.asarray(V)[None], engine)[0])


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

        def objective(V):
            V64 = V.to(F64)
            z = y64 * (X64 @ V64)  # [n]
            loss = torch.logaddexp(torch.zeros_like(z), -z).mean()
            return loss + 0.5 * lam * (V64 * V64).sum()

        # the optimum's objective through the same float64 expression, so
        # the suboptimality of the optimum itself is ~0, not a device offset
        opt_obj = objective(torch.as_tensor(self.optimum, device=device))

        def suboptimality_one(V):
            return torch.clamp_min(objective(V) - opt_obj, 1e-16)

        return FusedKernels(
            device=device,
            num_samples=self.num_samples,
            value_shape=(self.dim,),
            value_dtype=X.dtype,
            cost_per_row=self.cost_per_row,
            kernel=kernel,
            plain=plain,
            suboptimality=_map_rows(suboptimality_one),
            project=lambda V_stack: V_stack,  # G = identity
            # lam * V stays in V's float32, as the reference's weakly typed
            # python-float product does
            regularizer_grad=lambda V_stack: lam * V_stack,
            value=_map_rows(objective),
            optimum_value=float(opt_obj),
        )

    def objective(self, V, *, engine=None) -> float:
        """The regularized logistic loss at ``V``, in float64."""
        return float(self.objective_batch(np.asarray(V)[None], engine=engine)[0])

    def objective_batch(self, V_stack, *, engine=None) -> np.ndarray:
        """[S] float64 objectives, one iterate per call."""
        return self._value_batch(V_stack, engine)

    @property
    def optimum_objective(self) -> float:
        """The objective at the Newton optimum, through the kernels of the
        first device they were built on (the CPU when none was)."""
        k = next(iter(self._kernels.values()), None) or self.fused_kernels("cpu")
        return k.optimum_value

    def regularizer_grad(self, V: np.ndarray) -> np.ndarray:
        # float32 stays float32: numpy takes the python float lam as weakly
        # typed, as torch does in the device engine's lam * V
        return float(self.lam) * V
