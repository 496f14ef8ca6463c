"""DSAG and its supporting machinery (counterpart of ``repro.core``).

- :mod:`repro_torch.core.gradient_cache`: the §5 interval-keyed subgradient cache.
- :mod:`repro_torch.core.problems`: the paper's finite-sum problems (PCA,
  logreg) and their torch kernels.
- :mod:`repro_torch.core.dsag_pjit`: the live trainer's Tier-1 DSAG step.
"""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "CacheEntry": "gradient_cache",
    "GradientCache": "gradient_cache",
    "FiniteSumProblem": "problems",
    "LogisticRegressionProblem": "problems",
    "PCAProblem": "problems",
    "make_genomics_like_matrix": "problems",
    "make_higgs_like": "problems",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
