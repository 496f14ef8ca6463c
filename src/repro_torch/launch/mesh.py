"""The scenario mesh of the device engine (counterpart of
``repro.launch.mesh.make_scenario_mesh``).

The reference shards the ``[S, ...]`` scenario batch of its fused scan over
a 1-D ``jax.sharding.Mesh`` with ``shard_map``.  The port's mesh is the
tuple of torch devices the shards run on, one shard per entry, in shard
order.  An entry may repeat: ``(cpu,) * 4`` runs four shards on the CPU
(the counterpart of ``--xla_force_host_platform_device_count=4``), and
``(cuda:0,) * 4`` four shards on one card, each on its own stream.  CUDA
entries name their card (``cuda:k``): the shards never depend on a
thread's current device.

The reference's ``make_production_mesh`` and ``make_test_mesh`` serve the
model zoo's sharded training and dry run, which the port does not run yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The devices of a scenario-sharded run, one shard each, in shard order."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a ScenarioMesh needs at least one device")
        types = {d.type for d in devices}
        if len(types) > 1:
            raise ValueError(f"a ScenarioMesh's devices must be of one type, got {sorted(types)}")
        if types - {"cpu", "cuda"}:
            raise ValueError(f"a ScenarioMesh runs on cpu or cuda devices, got {sorted(types)}")
        if any(d.type == "cuda" and d.index is None for d in devices):
            raise ValueError("name each card of a ScenarioMesh (cuda:k), not cuda")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_scenario_mesh(num_devices: int | None = None) -> ScenarioMesh:
    """The first ``num_devices`` visible cards (all of them for ``None``),
    one shard each.  Raises ``ValueError``, before any launch, when more are
    asked for than ``torch.cuda.device_count()`` sees."""
    avail = torch.cuda.device_count()
    if num_devices is None:
        num_devices = avail
    if not 1 <= num_devices <= avail:
        raise ValueError(
            f"make_scenario_mesh: requested {num_devices} devices but only {avail} CUDA "
            f"devices are visible (several shards on one device: pass "
            f"ScenarioMesh((torch.device('cuda', 0),) * n))"
        )
    return ScenarioMesh(tuple(torch.device("cuda", k) for k in range(num_devices)))
