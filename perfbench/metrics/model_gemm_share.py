"""model_gemm_share: the device time of matrix-multiply kernels (cuBLAS and
CUTLASS names, ``harness.yardstick.GEMM_PATTERNS``) over the device's busy
time in the profiled stretch, in percent."""

from harness import yardstick


def read(run):
    p = run.profile
    if p is None or not p.busy_ns:
        return None
    gemm = sum(e - s for name, s, e in p.kernels() if yardstick.is_gemm(name))
    return 100.0 * gemm / p.busy_ns if gemm else None
