"""Batched scenario sweeps over the §3/§4.2 simulated fleet (paper §7;
counterpart of ``repro.experiments``).

* :mod:`repro_torch.experiments.sweep`: the vectorized event-dynamics engine
  (iteration-time sweeps) and its scalar references;
* :mod:`repro_torch.experiments.convergence`: the host convergence engine,
  the sweeps and the scalar replays;
* :mod:`repro_torch.experiments.fused`: the device convergence engine (the
  whole iteration body on the card, through the CUDA kernels), selected by
  :class:`~repro_torch.experiments.engine.EngineConfig`, whose ``mesh`` /
  ``num_devices`` shard the scenario axis (:mod:`repro_torch.launch.mesh`);
* :mod:`repro_torch.experiments.grid`: the (seeds x methods x w x regimes)
  driver;
* :mod:`repro_torch.experiments.results`: ordering verdicts, the profiler
  feed, and the ``BENCH_sweep.json`` / ``BENCH_convergence.json`` payloads.
"""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "BatchedRunResult": "sweep",
    "BurstRegime": "grid",
    "CALM": "grid",
    "CAP_ACTIVE_SET": "engine",
    "CAP_OK": "engine",
    "CAP_TILED": "engine",
    "ConvergenceBatchResult": "convergence",
    "ConvergenceSweepOutcome": "convergence",
    "DEFAULT_REGIMES": "grid",
    "EngineCapability": "engine",
    "EngineCapabilityError": "engine",
    "EngineConfig": "engine",
    "HEAVY_BURSTS": "grid",
    "MethodSpec": "grid",
    "PAPER_BURSTS": "grid",
    "PAPER_SCALE_PCA": "convergence",
    "ScenarioMesh": "repro_torch.launch.mesh",
    "SweepOutcome": "grid",
    "SweepRow": "grid",
    "as_engine_config": "engine",
    "convergence_ordering": "results",
    "convergence_payload": "results",
    "default_convergence_methods": "convergence",
    "default_methods": "grid",
    "feed_profiler": "results",
    "make_paper_scale_pca": "convergence",
    "make_scenario_mesh": "repro_torch.launch.mesh",
    "outcome_to_dict": "results",
    "paper_ordering": "results",
    "paper_scale_pca_sweep": "convergence",
    "replay_batch": "sweep",
    "run_convergence_batch": "convergence",
    "run_convergence_scan": "fused",
    "run_convergence_sweep": "convergence",
    "run_pca_grid_sharded_column": "results",
    "scan_capability": "fused",
    "run_sweep": "grid",
    "scalar_convergence_run": "convergence",
    "scalar_convergence_seconds": "convergence",
    "scalar_reference": "sweep",
    "scalar_sweep_seconds": "grid",
    "scalar_sync_reference": "sweep",
    "synchronous_times_batch": "sweep",
    "write_bench_convergence": "results",
    "write_bench_sweep": "results",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
