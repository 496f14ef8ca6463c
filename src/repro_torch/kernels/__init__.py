"""Hand-written CUDA kernels of the port, each beside its plain-torch version.

=========================  =====================================  =================================
wrapper                    TPU kernel it replaces                 CUDA source
=========================  =====================================  =================================
``logreg_block_sub`` (K1)  ``repro/kernels/block_sub.py``         ``csrc/block_sub.cu``
``pca_block_sub`` (K2)     ``repro/kernels/block_sub.py``         ``csrc/block_sub.cu``
``grid_cache_update`` (K3) ``repro/kernels/cache_events.py``      ``csrc/cache_events.cu``
``dsag_cache_update`` (K4) ``repro/kernels/dsag_update.py``       ``csrc/dsag_update.cu``
``gram_matvec`` (K5)       ``repro/kernels/gram_matvec.py``       ``csrc/gram_matvec.cu``
``flash_attention`` (K6)   ``repro/kernels/flash_attention.py``   ``csrc/flash_attention.cu``
``what_if_replay`` (K7)    none: XLA, ``repro/lb/jit_optimizer``  ``csrc/what_if.cu``
=========================  =====================================  =================================

K7 is the §6 what-if replay behind Algorithm 1's h estimate: the reference
runs it in XLA, not Pallas, and the port's eager form took ~2000 launches
per estimate.  K1, K2 and K5 share a second, wide path (``csrc/rows_wide.cuh``) for feature
widths past their fast paths' caps, so every width runs on the card.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper counts its launches
in its module's ``launch_counts``; :func:`launch_counts` merges them.  Beside
each count it reports the launch's cost model
(:mod:`repro_torch.analysis.kernel_costs`) to the thread's active cost counter
(:func:`repro_torch.analysis.cost.count_cost`), if there is one.
"""

from __future__ import annotations

from repro_torch.kernels import (
    block_sub,
    cache_events,
    dsag_update,
    flash_attention,
    gram_matvec,
    what_if,
)

_MODULES = (block_sub, cache_events, dsag_update, gram_matvec, flash_attention, what_if)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    out: dict[str, int] = {}
    for mod in _MODULES:
        out.update(mod.launch_counts)
    return out


def reset_launch_counts() -> None:
    for mod in _MODULES:
        for name in mod.launch_counts:
            mod.launch_counts[name] = 0
