"""Entry points of the live two-tier trainer and serving, and the scenario
mesh of the device engine (:mod:`repro_torch.launch.mesh`)."""

from repro_torch._exports import lazy_exports

#: public names -> the submodule that holds each
_EXPORTS = {
    "ScenarioMesh": "mesh",
    "make_scenario_mesh": "mesh",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
