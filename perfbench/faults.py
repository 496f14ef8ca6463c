"""Faults planted in the program under test, for the benchmark's own checks
(``calibrate.py`` on the card, ``tests/`` on the CPU): each breaks the
timed path underneath the harness, which must then read ``correct`` false.

* ``unchanged`` — the DSAG step returns the state it was given;
* ``half_batch`` — each group's loss and gradient over the first half of
  its rows, the mean taken over them;
* ``flip`` — the Tier-2 controller's mask of group 0 flipped at the second
  step, where the controller produces it.

:data:`CONTROL` is the configuration change that makes the control run:
the program's own int8 DSAG slots, the precision below the configured
bfloat16.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "flip")
CONTROL = {"dsag_cache_dtype": "int8"}


@contextlib.contextmanager
def planted(name: str):
    import repro_torch.launch.train as train_mod
    from repro_torch.ft.runtime import DeadlineController

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; the faults are {FAULTS}")
    real_make, real_masks = train_mod.make_train_step, DeadlineController.step_masks

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def broken(state, batch, mask, flush, evict=None):
            if name == "half_batch":
                batch = {k: v[:, :max(v.shape[1] // 2, 1)] for k, v in batch.items()}
            new_state, metrics = step(state, batch, mask, flush, evict)
            return (state if name == "unchanged" else new_state), metrics

        return broken

    calls = []

    def masks(self, latencies, step):
        mask, flush = real_masks(self, latencies, step)
        calls.append(step)
        if len(calls) == 2:
            mask = mask.copy()
            mask[0] = ~mask[0]
        return mask, flush

    if name == "flip":
        DeadlineController.step_masks = masks
    else:
        train_mod.make_train_step = make
    try:
        yield
    finally:
        train_mod.make_train_step, DeadlineController.step_masks = real_make, real_masks
