"""Analysis of the port's programs: the counterpart of ``repro.analysis``.

* :mod:`repro_torch.analysis.kernel_costs` — the H100's peaks and one cost
  model per hand-written kernel (K1–K7): the bytes and FLOPs each launch
  must move and do, and :func:`~repro_torch.analysis.kernel_costs.bound_ms`
  (numpy only: the kernel wrappers import it);
* :mod:`repro_torch.analysis.roofline` — ``model_flops`` and ``derive``
  (compute, memory and collective terms and an mfu) and the analytic product
  FLOPs of a dense model's forward;
* :mod:`repro_torch.analysis.cost` — ``count_cost(fn, *args)``: FLOPs and
  HBM bytes of one run of a torch program, counted op by op under a
  dispatch mode, the kernels billed by their cost models;
* :mod:`repro_torch.analysis.lint` — the TL001/TL003/TL004 invariants
  (FMA seam, mask evidence over padded axes, no dtype leak) checked on the
  port's engines: ``python -m repro_torch.analysis.lint --entry all``.

Nothing here is imported by the engines but the kernels' cost models,
which the kernel wrappers report to an active counter.
"""
