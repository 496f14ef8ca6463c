"""Dynamic load balancing (paper §6; counterpart of ``repro.lb``): partition
arithmetic and Algorithm 2 (``partitioner``), the torch form of Algorithm 1
and its parts (``jit_optimizer``), the reference's what-if draws
(``threefry``), and the numpy-facing optimizer (``optimizer``)."""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "p_start": "partitioner",
    "p_stop": "partitioner",
    "p_trans": "partitioner",
    "align_partitions": "partitioner",
    "cyclic_increment": "partitioner",
    "Subpartitioner": "partitioner",
    "LoadBalanceOptimizer": "optimizer",
    "OptimizerInputs": "optimizer",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
