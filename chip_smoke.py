#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # the full check (needs one CUDA card)
    python3 chip_smoke.py --quick    # build and hold the kernels only
    python3 chip_smoke.py --profile  # kernels, then where the card's time goes
    python3 chip_smoke.py --build-times  # one nvcc call against one per source

Phases (any failure raises and the script exits non-zero):

1. fail unless torch sees a CUDA card; print the card's name and power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc and
   print each kernel's registers, spills and shared memory (``-Xptxas -v``);
   hold the kernels' limits mirrored in ``_build.LIMITS`` (and K5's tile
   rows) against the compiled ones;
3. at the main paths' shapes: hold each kernel against its plain-torch
   version on the card (K1/K2/K5: float32 tolerance; K3/K4: ``torch.equal``;
   K6: :data:`K6_RTOL`, also at a length no multiple of its tiles, with
   GQA, non-causal over whisper's 1500 frames and at head dims 192 and 256;
   K1/K2/K5 must also repeat their bits) and time kernel, plain
   version and, where one PyTorch call computes the same function (K2, K5,
   K6), that call; beside each event time, the kernel's device time per
   call from ``torch.profiler`` (event times of small calls include the
   wrapper's host time); then K1, K2 and K5 past their fast paths' widths
   (the wide path: K1 at d = 97 and 1000, K2 at d = 180 and at k = 12, K5
   at d = 1100 and at k = 12), held and timed the same way; K4 on its other
   path too (staged or streaming), equal to the plain version, device time
   beside the chosen one's; K1 and K2 at the scalar simulator's single task
   and the host engine's median batch (:data:`HOST_BATCH`), and at the §6
   launch shapes (every task padded to the widest window of any ladder
   rung: 82 rows for ``lb_scan``, the 1000-row local range for PCA); K7
   (the §6 what-if replay, no TPU counterpart: it replaces an XLA scan) at
   the ``lb_scan`` batch, its scalar call and PCA's batch, and with a
   liveness mask (phase 9's calls: dead workers' draws +inf, per-scenario
   waits ``w_eff`` of 80 in nine scenarios and 75 in one, and at S = 1),
   equal to its plain version (``torch.equal``); K3 at the ``grid`` shape
   on a state a churn clear leaves (200 slots per scenario with tag -1 and
   stale non-zero values), ``torch.equal``; at phase 11's shapes (K2 and
   K3 at ``pca_grid_sharded``'s 40 scenarios and a shard's 10, K1 and K7
   at a shard of the churn column: 2 scenarios of 40 workers, 8 and 4
   dead); last, K3 at 10000 events per
   scenario (its plain version's launches, like phases 4-9, leave the
   profiler without device times for later calls);
4. slice 1, the convergence sweep: run the ``grid`` (logreg, n=16384, 100
   workers x 10 scenarios) and ``pca_paper_scale`` (n=50000, 50 workers x 4
   scenarios) recipes at full size through the kernels, all four methods,
   with every launch counter set to 0 just before and read just after;
   check ``dsag < sag < coded`` median time-to-gap and print it beside the
   committed ``BENCH_convergence.json`` values; rerun the grid recipe's dsag
   and sag with the plain versions on the card: event times and fresh
   counts must be equal, suboptimality within ``rtol=1e-4``; then the CLI
   ``python -m repro_torch.convergence_sweep --problem pca --cols 180`` (K2's
   wide path) with the counters set to 0 just before and read just after,
   and again with ``--kernel-backend torch``: event streams equal,
   suboptimality within ``rtol=1e-4`` + ``atol=1e-6``;
5. slice 2, the live two-tier trainer (``repro_torch.launch.train``), with
   the counters set to 0 just before and read just after: the committed
   ``live_validation`` recipe (logreg 512 x 29, 8 groups) for dsag and sag,
   and the paper-scale logreg (16000 x 29, 100 groups) and PCA (50000 x 64,
   50 groups) jobs, through K1, K4 and K5; streams, fresh/flush counts,
   final gaps, losses and max ξ against the JAX reference's values; the
   logreg paper-scale dsag run again through the plain versions on the card;
6. slice 3, serving (``repro_torch.launch.serve``): qwen1.5-0.5b at full
   width and depth (seeded random weights), 4 prompts of 2048 tokens, prefill
   and 32 greedy tokens through K6, with the counters set to 0 just before
   and read just after ``Server.generate``; then, over the same weights,
   prefill and 31 teacher-forced decode steps through K6, through the plain
   ``full_attention`` and through the float32 model (the yardstick), held
   to :data:`SERVE_TOL`; the float32 model through K6 against it through
   ``full_attention`` (:data:`SERVE_F32_TOL`); decode of token s from an
   (s-1)-token cache against the s-token prefill, in bfloat16 and in float32,
   and (the witness of the bfloat16 gap) from the K6 cache with the decode's
   scores kept in float32;
   K6 against its plain version on layer 0's real q, k, v; K6 launches = 24
   per prefill;
7. slice 7, the engines and the iteration-time sweeps, with the counters set
   to 0 just before each path and read just after: the ``grid`` recipe's
   dsag, sag, sgd and coded through the host engine (all 10 scenarios) and
   the scalar ``TrainingSimulator`` (scenario 0), through K1, held equal to
   the device engine's phase-4 runs bit for bit (times, fresh counts,
   per-worker latencies, rejects, evictions and suboptimality); the same for
   ``pca_paper_scale``'s dsag and sag at :data:`PCA_ENGINE_DEPTH` iterations
   through K2; each engine's wall clock; the host engine's median K1/K2
   batch equal to :data:`HOST_BATCH` (phase 3 holds and times K1 and K2
   there and at the scalar simulator's single task, as no device time can
   be taken after phase 3's windowed K3 check);
   the live pin without the reference (the port's controller equals the
   port's simulator on the ``live_validation`` recipe and the paper-scale
   logreg job, dsag and sag); the ``BENCH_sweep.json`` grid (100 workers x
   10 seeds x 100 iterations, 3 regimes) on the card, every cell and the
   three orderings equal to the committed file, beside the scalar event
   loop's seconds;
8. slice 8, §6 load balancing, with the counters set to 0 just before each
   path and read just after: (a) the ``lb_scan`` recipe (the ``grid``
   recipe's dsag with the balancer, ``GRID_LB``) through the device and
   host engines on the card, through K1 and K7: bit-equal to each other
   (times, suboptimality, fresh counts, per-worker latencies, publication
   times, evictions, rejects), and the column (median time-to-gap,
   ``repartitions_mean``, reached fraction, the orderings against phase
   4's medians) equal to the committed ``BENCH_convergence.json``
   ``lb_scan``; wall clocks beside the reference's committed CPU seconds,
   and Algorithm 1's calls and h estimates timed; (b) the scalar simulator
   on scenario 0, equal to row 0 of (a); (c) the slot budget: (a) ran the
   tiled cache (the device engine's only §6 cache), which the tightest
   budget holding its resident entries still takes, and one entry less
   makes ``kind="scan"`` refuse with ``active-slots-exceed-budget`` before
   any launch;
   (d) ``pca_paper_scale``'s dsag with the balancer at
   :data:`PCA_LB_DEPTH` iterations, scalar == host == device through K2;
   (e) (a)'s first Algorithm-1 call again, timed through K7 and through
   its plain version on the card (not counted);
9. slice 9, elastic-fleet churn, with the counters set to 0 just before each
   path and read just after: (a) the committed ``BENCH_convergence.json``
   ``churn`` column from its recipe (dsag, sag, coded through the host and
   device engines, K1 and K3): the schedule, medians, reached fractions,
   ordering and ``bitexact_scan_vs_host`` equal to the committed values,
   and the scalar simulator on scenario 0 equal to row 0; (b) the ``grid``
   recipe at full width under the column's schedule rule (the slowest
   fifth dies at 30% of the churn-free run, half of it rejoins at 70%):
   dsag, sag, sgd, coded device == host bit for bit, scalar == row 0 for
   dsag and sag, wall clocks beside phase 4's, the ordering reported; (c)
   the ``lb_scan`` recipe under the same schedule, device == host ==
   scalar (publication times included) through K1 and K7 with the mask,
   at least one Algorithm-1 call with a dead worker; (d) §7.2: the scalar
   simulator with ``SlowdownRemoval`` timed events on a replayed trace
   equal to the engines on ``paper_artificial_churn``'s schedule; (e)
   ``pca_paper_scale``'s dsag and sag under the schedule rule at
   :data:`PCA_ENGINE_DEPTH` iterations, scalar == host == device through K2
   and K3; (f) the live pin under churn (the port's controller == the
   port's simulator on ``live_validation``, groups dying and rejoining);
10. slice 10, the paper path's leftovers and the live trainer's rest, with
   the counters set to 0 just before each path and read just after: (a)
   ``write_bench_convergence`` of phase 4's ``grid`` run (to a temporary
   file) and ``convergence_payload`` of its ``pca_paper_scale`` run, equal
   to the committed ``BENCH_convergence.json`` in every field but the wall
   clocks (``mean_final_gap`` within rtol 1e-4, + atol 1e-6 for PCA); (b)
   the what-if draws equal to the shipped reference draws, and the CLI's
   ``--load-balance`` at its default 40 workers (a key the package never
   shipped) and :data:`CLI_LB_ITERS` iterations, device == host bit for
   bit, every scenario publishing, through K1 and K7; (c) the Fig. 8
   experiments at the reference's full iterations (``logreg_higgs`` 4 x
   1200 through K1 and K7, ``pca_genomics`` 120/120/400/400/400 through
   K2), wall clock and time to gap; (d) ``TrainerOptions()``'s default
   (adamw, bf16 slots, live-sampled stragglers), adafactor, and int8 slots
   on the paper-scale logreg and PCA jobs (K4's int8 entry), each step
   through K4, fresh/flush counts and virtual time equal to the reference's
   float32 runs, host ms per step; (e) an int8 run saved every 20 steps, the
   latest restored ``torch.equal`` to the saved state, 20 more steps;
   phase 3 holds K4's int8 entry at [100, 1, 29] and [50, 64, 3] with
   ``torch.equal`` and times it;
11. slice 11, scenario sharding of the device engine, with the counters
   set to 0 just before each part and read just after: (a) the committed
   ``BENCH_convergence.json`` ``pca_grid_sharded`` column
   (``run_pca_grid_sharded_column``: 40 scenarios of ``pca_paper_scale``,
   sharded and unsharded, through K2 and K3), first on the cards torch sees
   (one shard on one card), then on four shards of ``cuda:0`` (the committed
   ``num_devices``): bit-exact against the unsharded run, and equal to the
   committed column as phase 10 (a) holds a payload (the coded
   ``mean_total_time`` to the reference host engine's value); its
   ``sharded_seconds``, ``unsharded_seconds`` and ``device_scaling`` beside
   the count of distinct cards the shards shared; (b) ``make_scenario_mesh(1)``
   on the ``grid`` recipe's four methods, bit-equal to phase 4's runs; (c)
   §6 under churn on four shards of ``cuda:0`` (phase 9 (a)'s churned
   traces, 5 scenarios: pad 3; dsag with the balancer on ``GRID_LB``'s
   schedule), bit-equal to the unsharded device run, publication times
   included, every shard publishing, through K1 and K7; (d) the churn
   column's dsag, sag and coded on the same four shards, bit-equal to phase
   9 (a)'s device runs; (e) ``make_scenario_mesh(count + 1)`` and
   ``EngineConfig(num_devices=count + 1)`` refused before any launch;
12. the analysis layer (``repro_torch.analysis``): (a) the lint
   (``run_lint("all", device="cuda:0")``: TL001 to TL005 over every entry
   (TL002 and TL005 over the tiled §6 cache's per-rank walk: no table copy,
   no host sync per rank), the ``*_cuda`` ones through K1, K2, K3; the event streams, K3's and
   K7's outputs against the CPU run, K1, K2 and K5 at two pad widths), failing
   on any finding its baseline does not hold; (b) each phase-3 row's bytes,
   FLOPs and peak from its kernel's cost model, its bound, and its kernel
   and device times as multiples of the bound; (c) the serving roofline of
   phase 6's cell: ``count_cost`` over one prefill of 4 × 2048 tokens and one
   decode step through K6 (K6 billed by its cost model), failing unless the
   prefill's counted product FLOPs equal the analytic count (2 × the layers'
   and the unembedding's parameters × the tokens they see) and K6's 24
   launches its causal-pairs FLOPs; ``derive`` with phase 6's measured prefill
   seconds and decode ms per step: flops, bytes, the three terms, the
   dominant one, model FLOPs, the useful fraction and the mfu, whose N is
   the parameters the step multiplies a token by (the prefill unembeds one
   row per sequence), with the reference's N (all parameters) beside it;
13. the model zoo's DSAG training path (~45 s): (a) qwen1.5-0.5b at full
   width and depth (464.1 M parameters, bf16), P = 4, global batch 8 x 128,
   ``TrainConfig()`` (adamw, bf16 slots, remat full), 8 steps with
   live-sampled stragglers: the losses (finite), host ms per step, ms per
   synchronized step, peak memory, the mfu of 6·N·D at the bf16 peak, K4
   launches (one per step; ``--profile`` profiles one such step); (b) K4
   at ``[4, n]`` bf16 on the run's second step's inputs, ``torch.equal``
   to its plain twin, timed beside its bound; (c) the smoke
   config in float32, sgd, 20 steps on replayed traces: the card (K4)
   against the port on the CPU (streams, ξ, ``mask_count`` equal; losses
   within :data:`TRAIN_CHECK_RTOL`); (d) the quickstart
   (``repro_torch.examples.quickstart``): the loss falls; (e) K6 refuses a
   grad-requiring input before any launch;
14. serving the MoE, MLA, SSM and hybrid families at their published widths
   (~1 min): mamba2-370m (48 layers) and zamba2-2.7b (54) at full depth,
   grok-1-314b and deepseek-v2-236b cut to 4 layers (:data:`FAMILY_ARCHS`),
   random bf16 weights from seed 0, 4 x 1024-token prompts, 32 greedy tokens
   through ``Server.generate``; each model freed before the next.  (a) tokens
   in range, K6 launches per prefill = the GQA applications (grok 4, zamba2
   9, mamba2 and deepseek's MLA 0), prefill s, decode ms per step, tokens/s,
   peak memory; (b) K6 against its plain version on the first GQA
   attention's real q, k, v (:func:`k6_within_tolerance` widened by
   :func:`score_rounding_slack`, the float32 rounding of scores in the
   thousands), the model through K6 against it through the plain attention
   (zamba2 gated in bf16 by :data:`SERVE_TOL` and in float32 by
   :data:`SERVE_F32_TOL`; grok gated in float32 at one layer, its bf16
   numbers printed beside the share of (token, layer) pairs whose top-k
   experts agree), the pairs dropped at the published capacity factor; (c)
   decode of token s from an (s-1)-token cache against the s-token prefill
   at a capacity factor that drops no pair (bf16 at the phase's depth, with
   the float32-score witness beside GQA models' and held for
   :data:`F32_SCORE_DECODE_GATE`; float32 at full depth or, for MoE, one
   layer); (d) the smoke config in float32, card against CPU
   (:data:`FAMILY_CPU_TOL`, greedy tokens equal);
15. serving the rest of the registry at its published widths (~2 min):
   qwen2-7b (28 layers, q heads padded 28 -> 32), starcoder2-15b (40, the
   GELU MLP), pixtral-12b (40; 768 text tokens after 256 image embeddings)
   and whisper-base (6 encoder + 6 decoder layers, heads padded 8 -> 16, 4 x
   1500 audio frames) at full depth, qwen1.5-32b cut to 32 of 64 layers
   (:data:`REGISTRY_ARCHS`; heads padded 40 -> 48), random bf16 weights from
   seed 0, 4 prompts of 1024 positions, 32 greedy tokens through
   ``Server.generate``; each model freed before the next.  (a)-(d) as phase
   14: tokens in range, K6 launches per prefill and per decode step
   (:func:`k6_per_call`: a decoder layer each, whisper 6 encoder + 6 causal
   + 6 cross per prefill and 6 cross per decode step), prefill s, decode ms
   per step, tokens/s, peak memory; every attention call of one prefill and
   the decode step after it held through K6 on the plain run's own q, k, v
   (:func:`teacher_forced_k6`: whisper's encoder, causal, cross and decode
   cross calls at their real shapes), bf16 at full depth and float32 at
   :data:`REGISTRY_F32_LAYERS` decoder layers (whisper: one encoder and one
   decoder layer); the model through K6 against it through the plain
   attention with float32 scores (:func:`attend_f32_scores`) and decode
   against prefill, within :data:`SERVE_TOL` in bf16 and
   :data:`SERVE_F32_TOL` in float32, except the pairs in
   :data:`REGISTRY_E2E_UNHELD` (starcoder2-15b and whisper-base in bf16:
   printed, not held); the smoke config card == CPU; (e) whisper-base
   trains 8 steps at full width through ``Trainer`` (``TrainConfig()``, P =
   4): K4 once per step over [4, n] bf16, no K6, finite losses, host ms per
   step and peak memory;
16. training the MoE, MLA, SSM and hybrid families on the card, each model
   freed before the next: (a) mamba2-370m at full width and depth and (b)
   zamba2-2.7b at full width, cut to two groups of six Mamba2 layers and
   the shared block (:data:`FAMILY_TRAIN_ARCHS`), each trained
   :data:`FAMILY_TRAIN_STEPS` steps through ``Trainer`` (``TrainConfig()``, P = 4,
   8 x 128 tokens, random bf16 weights from seed 0): finite losses, K4 once
   per step over [4, n] bf16, no K6, host ms per step, peak memory, and K4
   on the second step's inputs bit-equal to its plain twin, timed beside its
   bound; (c) grok-1-314b, deepseek-v2-236b and pixtral-12b at full width,
   the embedding and one block in bf16 (:data:`FAMILY_LAYER_ARCHS`: no DSAG
   state of them fits one card): ``Model.train_loss`` and
   ``torch.autograd.grad`` over 8 x 128 tokens (pixtral's after 256 stub
   image embeddings), finite, two runs bit-equal, the MoE backward through
   ``_Dispatch``/``_Combine`` against the indexing form within
   :data:`MOE_BWD_TOL`, ms per forward + backward and peak memory; (d) the
   four smoke configs in float32, :data:`FAMILY_TRAIN_STEPS` ``Trainer``
   steps (sgd, replayed traces), card against CPU: streams equal, losses and the final
   parameters' relative RMS within :data:`TRAIN_CHECK_RTOL`, K4 once per
   step; (e) the SSD at chunk
   128 past a cumulative decay of 88.7: every gradient finite on the card
   and within :data:`SSD_CPU_TOL` of the CPU port's;
17. the mesh path (~2 min): qwen1.5-0.5b on a (data=2, model=2) device mesh
   of four processes on the card (``RankPool``, gloo: NCCL refuses two
   ranks on one device), each run held against the unsharded port on the
   same inputs, computed first in this process (while the ranks start) and
   freed before their first task.  (a) training at full width,
   :data:`MESH_TRAIN_BF16_LAYERS` of 24 layers, through
   ``Trainer(TrainerOptions(mesh=))`` and its step (:data:`MESH_TC`: DSAG
   groups on ``data``, FSDP, adamw, bf16 slots; P = 2, :data:`MESH_TRAIN`
   tokens), 2 steps with group 1 masked at the second: losses, per-group
   losses, ξ and the parameters' relative RMS within :data:`MESH_TOL`, K4
   once per step on every rank over its local ``[1, n]`` slots, the
   collectives of one step per rank (``count_cost``: kinds, calls and
   ring-model wire bytes); (b) the same in float32 at 2 layers with float32
   slots, held tight; (c) serving: ``Server(mesh=)`` prefill and 4 decode
   steps (:data:`MESH_SERVE`), bf16 at :data:`MESH_SERVE_BF16_LAYERS` of 24
   layers (cut to make room for phase 19) and float32 at 2 layers,
   against the unsharded ``Server``: every K6 call (each rank's 8 local
   heads) held on its own inputs against the plain attention, the prefill
   logits within :data:`MESH_TOL`, the float32 tokens equal; every rank's K4
   and K6 launches counted into the kernels line; K4 and K6 then timed at
   the ranks' local shapes in this process;
18. the reference's production DSAG layouts on a mesh (qwen1.5-0.5b at full
   width, four ranks on the card over gloo; each run against the unsharded
   port on the same groups, inputs and ``TrainConfig``, computed first in
   this process), :data:`LAYOUT_RUNS`: (a) the reference's above-50 B
   configuration (adafactor, int8 slots, ``zero`` groups, P = 2) on (2, 2),
   bf16 at :data:`LAYOUT_BF16_LAYERS` of 24 layers (cut to make room for
   phase 19; :data:`MESH_TOL`'s bf16 bounds) and float32 at 2
   layers (float32 bounds; after the first step ``filled`` and
   ``pending_valid`` equal; per int8 slot leaf every element within one
   step of the unsharded port's, but for a share of each leaf on the
   attention scores' path, :data:`INT8_SCORE_PATH`, whose random-init
   gradient is ill-conditioned); (b) ``pod`` groups with
   int8 slots and adamw on (pod=2, data=2, model=1); (c) ``none`` groups
   and ``dsag=False`` (no K4); every K4-int8 launch held on every row
   (:class:`Int8LaunchChecks`: row axes from the state's slot spec, a split
   launch's maxima the MAX over them and its outputs its plain twin's given
   them, ``torch.equal``; in float32 the second step's split launches also
   against the whole-row update on their rows gathered over those axes);
   launches, seconds per step per rank, peak memory per rank and wire bytes
   of a step by kind and by site (``count_cost``); (d) a mesh trainer's
   checkpoint: (a) in float32 saves after its 2 steps, takes 2 more, then
   restores and takes them again: bit for bit the uninterrupted run, and
   the file restored into the unsharded port equal leaf for leaf to the
   gathered mesh state; (e) K4 at (c)'s local float32 slots and K4-int8's
   split form (the row-max kernel and the update given maxima) at the
   largest split local shape of (a), each against its plain twin, timed
   beside its bound;
19. the MoE family on a mesh: grok-1-314b (its 8 experts ffn-sharded: each
   ``model`` rank a share of every expert's hidden dim, the
   down-projection's partial sums all-reduced) and deepseek-v2-236b (160
   experts expert-parallel, 80 per rank, the outputs all-gathered; MLA) on
   (data=2, model=2), four ranks on the card over gloo, each run against the
   unsharded port on the same weights and inputs, computed first in this
   process (while the ranks start) and freed before their first task.  (a)
   ``Server(mesh=)`` at published widths, 1 layer in bf16 and in float32
   (:data:`MOE_SERVE_F32_FIELDS`: in float32 the experts' hidden width
   halved and grok-1's vocab cut, to fit four ranks on the card), :data:`MOE_SERVE` (16 prompts: the configs'
   ``moe_dispatch_chunks``, whole chunks on each data rank), prefill and 1
   decode step: every K6 call of grok-1's prefill held on its own inputs
   against the plain attention; in float32 every token's experts equal the
   unsharded run's and the logits within :data:`MESH_TOL`; in bf16 the
   logits' gap and the share of flipped routes printed; (b) one full-width
   MoE layer of each, bf16, :data:`MOE_LAYER_TRAFFIC` (one dispatch chunk
   over both data ranks: its expert choices all-gathered), forward and
   backward on the unsharded layer's routes (:class:`RouteForcer`; at most
   :data:`MOE_FLIP_CAP` of the mesh's own may differ): the output, the aux,
   ``x``'s gradient and the router's and experts' gradients within
   :data:`MOE_MESH_BF16_TOL`; the experts' collective counted once forward
   and once backward; seconds, peak memory and wire bytes by kind and site
   per rank; (c) the
   production DSAG mesh step at reduced widths (:data:`MOE_REDUCED`,
   0.35-0.4 B parameters each, float32), :data:`MOE_LAYOUT_RUNS`: adafactor,
   int8 slots, ``zero`` groups, P = 2, FSDP on (2, 2) for both, and ``pod``
   groups with float32 slots (K4) on (pod=2, data=2, model=1) for
   deepseek-v2, phase 18's checks and bounds but the gathered whole-row
   comparison (for time), the mesh on the unsharded run's routes (at most
   :data:`MOE_FLIP_CAP` of its own differing in a step), and the int8 slots after
   the first step are held within one step but for :data:`MOE_SPREAD_MULT`
   times the share a one-ulp nudge of the parameters moves in the
   unsharded port (its attention scores are near one-hot at random init);
   (d) K6 at grok-1's
   rank-local prefill shape and K4-int8's split form at (c)'s largest split
   expert shard, each against its plain twin, timed beside its bound;
20. the dry run (``repro_torch.launch.dryrun``, ~8 s; on the host, over meta
   tensors in a fake process group): (a) phase 18's ``a bf16`` step
   (qwen1.5-0.5b at :data:`LAYOUT_BF16_LAYERS` layers, adafactor, int8 slots,
   ``zero`` groups on (2, 2)) counted dry under ``dry_run("card")`` on rank
   0 of a fake world of 4, held equal to the rank-0 ``count_cost`` of that
   step really run on the card in phase 18: FLOPs, bytes, every row (calls,
   FLOPs, bytes; K4-int8's and its row-max pass's by their cost models),
   the collectives by kind and by site (any difference fails); (b) its ``peak_estimate_bytes``
   printed beside phase 18's measured peak per rank and their ratio (not
   held); (c) :data:`DRYRUN_CELL` on the 16x16 production mesh at full
   width, its one-line summary printed;
21. print one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

F32_RTOL = 1e-4  # kernel vs plain: float32 sums in another order
F32_ATOL_REL = 1e-5  # ... plus this times the largest |plain| value

#: the JAX reference's live trainer (``repro.launch.train`` on the CPU) on
#: the paper-scale jobs of :func:`paper_live_opts`: final gap (step 79),
#: virtual seconds at step 79, loss at steps 0 and 79, max ξ, Σ fresh, Σ flush
PAPER_LIVE = {
    ("logreg", "dsag"): (0.06209114794638987, 0.45683806155687146, 0.6931475400924683,
                         0.27441734075546265, 1.0, 6420, 1213),
    ("logreg", "sag"): (0.06065378725356596, 0.45328783348307056, 0.6931475400924683,
                        0.27296364307403564, 0.8899999856948853, 6400, 0),
    ("pca", "dsag"): (5.4318966143239383e-05, 0.43198621088886074, -3762.041748046875,
                      -17223.625, 1.0, 3211, 540),
    ("pca", "sag"): (0.0001726642506709912, 0.4317791705027311, -3762.041748046875,
                     -17213.455078125, 0.9399999976158142, 3200, 0),
}
#: paper-scale jobs: (samples, groups, w, eta)
PAPER_JOBS = {"logreg": (16_000, 100, 80, 0.25), "pca": (50_000, 50, 40, 0.9)}
#: live path tolerances against the reference: relative, on the final gap
#: (logreg; PCA's gap near 5e-5 comes from a float32 iterate re-projected by
#: a QR whose last bits differ from LAPACK's) and on the losses
LIVE_GAP_RTOL = {"logreg": 1e-4, "pca": 1e-2}
LIVE_LOSS_RTOL = 1e-4
#: K6 against its plain version's float32 result: float32 rounding, plus half
#: a bfloat16 ulp (2**-8 relative) where the output is bfloat16
K6_RTOL = {"float32": 1e-4, "bfloat16": 1e-4 + 2.0**-8}
K6_ATOL_REL = 1e-5
#: the serving cell: batch, prompt length, generated tokens
SERVE_B, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 32
#: logits of the K6 run against the plain-attention run, bfloat16: the plain
#: path rounds scores to bfloat16 before its float32 softmax (the reference's
#: full_attention), K6 keeps them in float32, and at this init (projection
#: std 1/sqrt(24)) scores reach a few hundred, where a bfloat16 ulp is 1 to 4:
#: close keys' probabilities move, and 24 layers of random weights carry it
#: on (measured on the H100: 0.42).  The same holds for decode from an
#: (s-1)-token cache against a K6 prefill: the decode step's attention is the
#: plain one (0.38; against the plain prefill 0.07).  Bounds on the relative
#: RMS difference ||a - b|| / ||b|| of each logit vector (two unrelated logit
#: vectors give ~1.4).  The K6 run must also be no further from the float32
#: run than the plain run is; the float32 checks below are the tight ones.
SERVE_TOL = {"k6_vs_plain": 0.5, "decode_vs_prefill": 0.5}
#: the model in float32 through K6 against it through full_attention, and its
#: decode against its prefill: float32 rounding only
SERVE_F32_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(torch, kernel, plain, reps: int, plain_reps: int) -> tuple[float, float]:
    """Kernel and plain times, taken in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, plain_reps)
    k1 = cuda_ms(torch, kernel, reps)
    k2 = cuda_ms(torch, kernel, reps)
    p2 = cuda_ms(torch, plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


#: a phase-3 row's cost-model fields: phase 12 (b) prints them; the kernels line leaves them out
COST_KEYS = ("bytes", "flops", "peak")


def bound_of(cost: tuple) -> dict:
    """A phase-3 row's cost (``(bytes, flops, peak)`` from a kernel's model in
    ``repro_torch.analysis.roofline``) and its bound there."""
    from repro_torch.analysis import roofline

    b_ms, b_by = roofline.bound_ms(*cost)
    return dict(bytes=cost[0], flops=cost[1], peak=cost[2], bound_ms=b_ms, bound_by=b_by)


def grid_tasks(n: int, N: int, p: int, S: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Per-task (start, width) of S*N grid tasks at random sub-block indices."""
    from repro_torch.lb.partitioner import p_start, p_stop

    base = np.array([p_start(n, N, i + 1) for i in range(N)])
    n_loc = np.array([p_stop(n, N, i + 1) for i in range(N)]) - base + 1
    k = rng.integers(1, p + 1, size=(S, N))
    lo = base[None, :] + (k - 1) * n_loc[None, :] // p
    hi = base[None, :] + k * n_loc[None, :] // p - 1
    return lo.reshape(-1).astype(np.int64), (hi - lo + 1).reshape(-1).astype(np.int64)


def lb_tasks(n: int, N: int, p0: int, S: int, rng) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-task (start, width) of S*N tasks under §6 load balancing: each
    worker at a random rung of the run's p-ladder and a random sub-block;
    and the run's pad width (every rung's widest window)."""
    from repro_torch.cluster.simulator import MethodConfig, lb_ladder_for, task_pad_width
    from repro_torch.lb.partitioner import p_start, p_stop

    base = np.array([p_start(n, N, i + 1) for i in range(N)])
    n_loc = np.array([p_stop(n, N, i + 1) for i in range(N)]) - base + 1
    ladder = np.array(lb_ladder_for(MethodConfig("dsag", subpartitions=p0), n_loc))
    p = np.minimum(ladder[rng.integers(0, ladder.size, size=(S, N))], n_loc[None, :])
    k = 1 + np.floor(rng.random((S, N)) * p).astype(np.int64)
    lo = base[None, :] + (k - 1) * n_loc[None, :] // p
    hi = base[None, :] + k * n_loc[None, :] // p - 1
    pad = task_pad_width(MethodConfig("dsag", subpartitions=p0, load_balance=True), n, N)
    return lo.reshape(-1).astype(np.int64), (hi - lo + 1).reshape(-1).astype(np.int64), pad


def device_ms(torch, fn, calls: int) -> tuple[float | None, str]:
    """Device time per call of ``fn`` under ``torch.profiler``: the CUDA
    kernels' time in ``key_averages()`` over ``calls`` calls, divided by
    ``calls`` (no host time in it), and the kernels' names with their
    launches per call.  None where the profiler recorded no device time, or
    dropped some of the launches, in three tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then drops device events: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kern)
        if us > 0 and min(e.count for e in kern) >= calls:
            names = ", ".join(f"{e.key[:40]} x{e.count / calls:g}" for e in kern)
            return us / 1e3 / calls, names
    return None, "the profiler recorded no device time"


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_block_sub(torch, kind: str, X, y, rng, shapes=None, k: int = 3) -> list:
    """Phase 3 for K1 (logreg: grid, live and coded calls) or K2 (pca: grid
    and coded calls) at the main paths' shapes, or at ``shapes`` (call ->
    grid layout (N, p, S), or (N, p, S, G): the first G tasks of that layout
    padded to its widest window, as the scalar simulator and the host engine
    call the kernels; or ("lb", N, p0, S): the §6 layout of :func:`lb_tasks`)
    with ``X``'s width and, for K2, ``k`` columns."""
    from repro_torch.analysis import roofline
    from repro_torch.cluster.simulator import MethodConfig, task_pad_width
    from repro_torch.core.problems import make_higgs_like
    from repro_torch.kernels import block_sub

    dev = X.device
    d = X.shape[1]
    if kind == "logreg":
        # grid: the sweep's per-iteration call; live: the paper-scale live
        # logreg job's call (100 groups of n // G = 160 rows over n = 16000,
        # launch/paper_jobs.py); coded: the sweep's full-width call
        shapes = shapes or {"grid": (100, 10, 10), "live": (16_000, 100), "coded": None}
        S_coded, k = 10, None
    else:
        shapes = shapes or {"grid": (50, 5, 4), "coded": None}
        S_coded = 4
    rows = []
    for call, shp in shapes.items():
        Xc, yc = X, y
        if shp is None:
            n = X.shape[0]
            starts = np.ones(S_coded, dtype=np.int64)
            widths = np.full(S_coded, n, dtype=np.int64)
        elif call == "live":
            n, G = shp
            Xl, yl = make_higgs_like(n, seed=0)
            Xc, yc = torch.as_tensor(Xl, device=dev), torch.as_tensor(yl, device=dev)
            starts = 1 + (n // G) * np.arange(G, dtype=np.int64)
            widths = np.full(G, n // G, dtype=np.int64)
        elif shp[0] == "lb":
            n = X.shape[0]
            starts, widths, pad = lb_tasks(n, *shp[1:], rng)
        else:
            n = X.shape[0]
            N, p, S = shp[:3]
            starts, widths = grid_tasks(n, N, p, S, rng)
            pad = task_pad_width(MethodConfig("dsag", subpartitions=p), n, N)
            if len(shp) == 4:
                starts, widths = starts[:shp[3]], widths[:shp[3]]
        G = starts.size
        if kind == "logreg":
            Vb = torch.as_tensor(0.1 * rng.normal(size=(G, d)), dtype=torch.float32, device=dev)
        else:
            q, _ = np.linalg.qr(rng.normal(size=(G, d, k)))
            Vb = torch.as_tensor(q, dtype=torch.float32, device=dev).contiguous()
        st = torch.as_tensor(starts, device=dev)
        wd = torch.as_tensor(widths, device=dev)
        # the static widest window, as the sweep (fused.py) and the live job pass it
        W = pad if shp is not None and call != "live" else int(widths.max())
        if kind == "logreg":
            def kernel():
                return block_sub.logreg_block_sub(Xc, yc, Vb, st, wd, W)

            def plain():
                return block_sub.logreg_block_sub_plain(Xc, yc, Vb, st, wd, W)
        else:
            def kernel():
                return block_sub.pca_block_sub(Xc, Vb, st, wd, W)

            def plain():
                return block_sub.pca_block_sub_plain(Xc, Vb, st, wd, W)
        got = kernel()
        want = plain()
        again = kernel()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=F32_RTOL, atol=F32_ATOL_REL * scale
        ):
            fail(f"{kind}_block_sub ({call}) disagrees with its plain version: "
                 f"max |diff| {err:.3e} at max |plain| {scale:.3e}")
        if not torch.equal(got, again):
            fail(f"{kind}_block_sub ({call}) does not repeat its bits")
        k_ms, p_ms = timed_pair(torch, kernel, plain, reps=50, plain_reps=20)
        dev_ms, dev_kernels = device_ms(torch, kernel, 50)
        lib_ms = None
        if kind == "pca":
            ar = torch.arange(W, device=dev)
            idx = (st[:, None] - 1 + ar[None, :]).clamp(0, n - 1)
            xg = Xc[idx] * (ar[None, :] < wd[:, None])[:, :, None].float()
            lib_ms = cuda_ms(torch, lambda: -torch.bmm(xg.transpose(1, 2), torch.bmm(xg, Vb)), 20)
        bound = bound_of(roofline.logreg_block_sub_cost(starts, widths, n, d) if kind == "logreg"
                         else roofline.pca_block_sub_cost(starts, widths, n, d, k))
        b_ms, b_by = bound["bound_ms"], bound["bound_by"]
        plan = (block_sub.logreg_plan(G, n, d, W) if kind == "logreg"
                else block_sub.pca_plan(G, n, d, k, W))
        path = "wide" if plan.wide else "fast"
        rows.append(dict(call=call, G=G, d=d, k=k, max_width=W, path=path, max_abs_err=err,
                         ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, library_ms=lib_ms, **bound))
        print(f"  {kind}_block_sub [{call}] G={G} d={d}{'' if k is None else f' k={k}'} "
              f"width<={W} ({path} path): "
              f"max|diff|={err:.3e} (|plain|<={scale:.3e}), repeats its bits; kernel "
              f"{k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), "
              f"plain {p_ms:.4f} ms, bmm pair {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    return rows


def check_what_if(torch, S: int, N: int, w: int, margin: float, rng,
                  dead: list | None = None) -> dict:
    """Phase 3 for K7 at one §6 shape: what-if draws made from the shipped
    normals and profiler-like moments (as estimate_h makes them); exact
    equality with the plain version.  With ``dead`` (dead workers per
    scenario), the churn call: those workers' draws +inf (random ones of
    each scenario) and per-scenario waits ``w_eff = min(w, #alive)``."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import what_if
    from repro_torch.lb import jit_optimizer as jlb
    from repro_torch.lb.optimizer import what_if_normals

    dev = torch.device("cuda")
    K = jlb.SIM_ITERATIONS

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    e_comm = f64(rng.uniform(1e-4, 1e-3, (S, N)))
    e_comp = f64(rng.uniform(1e-3, 5e-3, (S, N)))
    v_comm = (f64(rng.uniform(0.05, 0.3, (S, N))) * e_comm) ** 2
    v_comp = (f64(rng.uniform(0.05, 0.3, (S, N))) * e_comp) ** 2
    comm, comp = jlb._draw_what_if(what_if_normals(0, N, K, dev), e_comm, v_comm, e_comp, v_comp)
    wait, n_live = w, S * N
    if dead is not None:
        alive = np.ones((S, N), bool)
        for s, n_dead in enumerate(dead):
            alive[s, rng.choice(N, n_dead, replace=False)] = False
        alive_t = torch.as_tensor(alive, device=dev)
        comm = torch.where(alive_t[:, :, None], comm, torch.inf)
        wait = torch.clamp_max(alive_t.sum(dim=1), w)
        n_live = int(alive.sum())
    total = (comp + comm).contiguous()

    def kernel():
        return what_if.what_if_replay(total, wait, margin)

    def plain():
        return what_if.what_if_replay_plain(total, wait, margin)

    got, want, again = kernel(), plain(), kernel()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        fail(f"what_if_replay S={S} N={N}: differs from its plain version "
             f"(max |diff| {float((got - want).abs().max()):.3e}) or does not repeat")
    k_ms, p_ms = timed_pair(torch, kernel, plain, reps=50, plain_reps=5)
    dev_ms, dev_kernels = device_ms(torch, kernel, 20)
    bound = bound_of(roofline.what_if_replay_cost(S, N, K, n_live, dead is not None))
    b_ms, b_by = bound["bound_ms"], bound["bound_by"]
    mask, extra = "", {}
    if dead is not None:
        # the wrapper's device time includes its range check of the waits (a
        # reduction and a copy to the host); K7's own, launched directly
        from repro_torch.kernels import _build
        from repro_torch.kernels.block_sub import _stream

        u = torch.empty((S, N), dtype=torch.float64, device=dev)
        k7_ms, _ = device_ms(torch, lambda: _build.launch(
            "dsag_what_if_replay", total.data_ptr(), u.data_ptr(), wait.data_ptr(), S, N, K, 0,
            int(margin > 0.0), float(margin), 1.0 / K, total.device.index,
            _stream(total.device)), 20)
        mask = f" dead={sorted(set(dead))} w_eff={sorted(set(wait.tolist()))}"
        extra = dict(kernel_alone_device_ms=k7_ms)
        if not (got[~alive_t] == 0).all():
            fail(f"what_if_replay S={S} N={N}: a dead worker took part in the replay")
    alone = f"; K7 alone: device {fmt_ms(extra['kernel_alone_device_ms'])}" if extra else ""
    print(f"  what_if_replay S={S} N={N} K={K} w={w}{mask} margin={margin}: equal to its "
          f"plain version, repeats its bits; kernel {k_ms:.4f} ms (device {fmt_ms(dev_ms)}: "
          f"{dev_kernels}{alone}), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(call=f"S={S} N={N} w={w}{mask}", max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                plain_ms=p_ms, library_ms=None, **bound, **extra)


def check_cache_walk(torch, S: int, R: int, E: int, F: int, T: int, rng,
                     plain_reps: int = 3, cleared: int = 0) -> dict:
    """Phase 3 for K3 at one dsag shape; exact equality.  ``cleared`` slots
    of every scenario are in the state a churn clear leaves them: tag -1 and
    a stale non-zero value row, which the walk must take as empty."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import cache_events

    dev = torch.device("cuda")
    order = np.argsort(rng.random((S, R)), axis=1)
    args = dict(
        valid_r=torch.as_tensor(rng.random((S, R)) < 0.8, device=dev),
        slot_r=torch.as_tensor(rng.integers(0, E, size=(S, R)), device=dev),
        tag_r=torch.as_tensor(np.sort(rng.integers(0, T, size=(S, R)), axis=1)[
            np.arange(S)[:, None], order], device=dev),
        vals_r=torch.as_tensor(rng.normal(size=(S, R, F)), device=dev),
        sums=torch.as_tensor(rng.normal(size=(S, F)), device=dev),
        values=torch.as_tensor(rng.normal(size=(S, E, F)), device=dev),
        iters=torch.as_tensor(rng.integers(0 if cleared else -1, T, size=(S, E)), device=dev),
        covered=torch.as_tensor(rng.integers(0, 1000, size=S), device=dev),
        rejected=torch.as_tensor(rng.integers(0, 10, size=S), device=dev),
        slot_width=torch.as_tensor(rng.integers(1, 300, size=E), device=dev),
    )
    if cleared:
        gone = np.stack([rng.choice(E, cleared, replace=False) for _ in range(S)])
        args["iters"][torch.arange(S, device=dev)[:, None], torch.as_tensor(gone, device=dev)] = -1
    a = tuple(args.values())
    got = cache_events.grid_cache_update(*a)
    # the device time before the plain version runs: after its ~10^5 small
    # launches at R = 10000 the profiler recorded no device time for a while
    dev_ms, dev_kernels = device_ms(torch, lambda: cache_events.grid_cache_update(*a), 50)
    want = cache_events.grid_cache_update_plain(*a)
    torch.cuda.synchronize()
    names = ("sums", "values", "iters", "covered", "rejected")
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            fail(f"grid_cache_update output {name} is not equal to its plain version")
    k_ms, p_ms = timed_pair(torch, lambda: cache_events.grid_cache_update(*a),
                            lambda: cache_events.grid_cache_update_plain(*a),
                            reps=50, plain_reps=plain_reps)
    n_valid = int(args["valid_r"].sum())
    n_rej = int((got[4] - args["rejected"]).sum())
    accepted = n_valid - n_rej
    bound = bound_of(roofline.grid_cache_update_cost(S, R, E, F, accepted))
    b_ms, b_by = bound["bound_ms"], bound["bound_by"]
    state = ""
    if cleared:
        slot_r = args["slot_r"].cpu().numpy()
        hits = int(sum(np.isin(slot_r[s][args["valid_r"][s].cpu().numpy()], gone[s]).sum()
                       for s in range(S)))
        nonzero = bool((args["values"][torch.arange(S, device=dev)[:, None],
                                        torch.as_tensor(gone, device=dev)] != 0).all())
        if not hits or not nonzero:
            fail(f"grid_cache_update cleared state: {hits} events on cleared slots, "
                 f"stale values non-zero {nonzero}")
        state = f", {cleared} cleared slots with stale values per scenario ({hits} events on them)"
    print(f"  grid_cache_update S={S} R={R} E={E} F={F}{state}: equal (accepted {accepted}, "
          f"rejected {n_rej}); kernel {k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), "
          f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(call=f"S{S}_R{R}_E{E}_F{F}" + (f"_cleared{cleared}" if cleared else ""),
                max_abs_err=0.0, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, library_ms=None,
                **bound)


def k4_launch(torch, g, c, h, mask, streaming: bool):
    """K4's kernel on a given path, launched directly (for the comparison of
    its two paths; not counted): ``(new_c, new_h)``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_sub import _stream

    p, n = g.shape
    new_c, new_h = torch.empty_like(c), torch.empty_like(h)
    _build.launch("dsag_dsag_cache_update", g.data_ptr(), c.data_ptr(), h.data_ptr(),
                  mask.data_ptr(), new_c.data_ptr(), new_h.data_ptr(), p, n,
                  int(g.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
                  int(streaming), g.device.index or 0, _stream(g.device))
    return new_c, new_h


def check_dsag_update(torch, p: int, n: int, slot_dtype, rng, inputs=None,
                      plain_reps: int = 10) -> dict:
    """Phase 3 for K4 at one shape, on random slots or on ``inputs`` (a
    ``(g, c, h, mask)`` the main path gave K4); exact equality with the
    plain version."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import dsag_update

    dev = torch.device("cuda")
    if inputs is not None:
        g, c, h, mask = inputs
    else:
        g = torch.as_tensor(rng.normal(size=(p, n)), dtype=torch.float32,
                            device=dev).to(slot_dtype)
        c = torch.as_tensor(rng.normal(size=(p, n)), dtype=torch.float32,
                            device=dev).to(slot_dtype)
        h = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
        mask = torch.as_tensor(rng.random(p) < 0.7, dtype=torch.float32, device=dev)
    got = dsag_update.dsag_cache_update(g, c, h, mask)
    want = dsag_update.dsag_cache_update_plain(g, c, h, mask)
    torch.cuda.synchronize()
    for name, a, b in zip(("new_c", "new_h"), got, want):
        if not torch.equal(a, b):
            fail(f"dsag_cache_update [{p}, {n}] {slot_dtype}: {name} is not equal "
                 f"to its plain version")
    k_ms, p_ms = timed_pair(torch, lambda: dsag_update.dsag_cache_update(g, c, h, mask),
                            lambda: dsag_update.dsag_cache_update_plain(g, c, h, mask),
                            reps=50, plain_reps=plain_reps)
    dev_ms, dev_kernels = device_ms(torch, lambda: dsag_update.dsag_cache_update(g, c, h, mask), 50)
    bound = bound_of(roofline.dsag_cache_update_cost(p, n, g.element_size()))
    b_ms, b_by = bound["bound_ms"], bound["bound_by"]
    dt = str(slot_dtype).removeprefix("torch.")
    # the path the wrapper does not take here, held and timed beside it
    streaming = n >= dsag_update.STREAM_MIN_N
    path, other = ("stream", "staged") if streaming else ("staged", "stream")
    for name, a, b in zip(("new_c", "new_h"), k4_launch(torch, g, c, h, mask, not streaming),
                          want):
        if not torch.equal(a, b):
            fail(f"dsag_cache_update [{p}, {n}] {slot_dtype} ({other} path): {name} is not "
                 f"equal to its plain version")
    other_ms, _ = device_ms(torch, lambda: k4_launch(torch, g, c, h, mask, not streaming), 50)
    print(f"  dsag_cache_update [{p}, {n}] {dt} ({path}): equal; kernel {k_ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"the {other} path, equal too: device {fmt_ms(other_ms)}")
    return dict(call=f"p{p}_n{n}_{dt}", path=path, max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                other_path_device_ms=other_ms, plain_ms=p_ms, library_ms=None, **bound)


def _int8_inputs(torch, p: int, rows: int, b: int, rng) -> tuple:
    """K4-int8's operands at one shape, the live mix of row sources:
    ``(g, cq, cs, pq, ps, h, code)`` on the card."""
    from repro_torch.kernels import dsag_update
    from repro_torch.optim.compression import quantize

    dev = torch.device("cuda")

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    c, pe = quantize(f32(p, rows, b), block=b), quantize(f32(p, rows, b), block=b)
    # the live mix: ~70% fresh, a few flushes and evictions, the rest kept
    src = rng.choice([dsag_update.TAKE_G, dsag_update.TAKE_PENDING, dsag_update.ZERO,
                      dsag_update.KEEP], size=p, p=[0.7, 0.1, 0.02, 0.18])
    take = np.where(rng.random(p) < 0.8, dsag_update.TAKE_NEW, 0)
    code = torch.as_tensor(src + take, dtype=torch.uint8, device=dev)
    return (f32(p, rows, b), c.q, c.scale[..., 0].contiguous(), pe.q,
            pe.scale[..., 0].contiguous(), f32(rows, b), code)


def _int8_update_row(torch, args, maxima, shape: str, plain_reps: int) -> dict:
    """K4-int8 (``maxima``: its split form) against its plain twin on
    ``args``, ``torch.equal`` on every output; timed beside its bound."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import dsag_update

    split = maxima is not None
    p, rows, b = args[0].shape
    got = dsag_update.dsag_cache_update_int8(*args, maxima)
    want = dsag_update.dsag_cache_update_int8_plain(*args, maxima)
    torch.cuda.synchronize()
    for name, a, w in zip(("cache q", "cache scale", "pending q", "pending scale", "h"),
                          got, want):
        if not torch.equal(a, w):
            fail(f"dsag_cache_update_int8 {shape}{' split' if split else ''}: {name} is not "
                 f"equal to its plain version")
    k_ms, p_ms = timed_pair(torch, lambda: dsag_update.dsag_cache_update_int8(*args, maxima),
                            lambda: dsag_update.dsag_cache_update_int8_plain(*args, maxima),
                            reps=50, plain_reps=plain_reps)
    dev_ms, dev_kernels = device_ms(
        torch, lambda: dsag_update.dsag_cache_update_int8(*args, maxima), 50)
    bound = bound_of(roofline.dsag_cache_update_int8_cost(p, rows, b, split=split))
    b_ms, b_by = bound["bound_ms"], bound["bound_by"]
    print(f"  dsag_cache_update_int8 {shape}{' (split form: given row maxima)' if split else ''}"
          f": equal; kernel {k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), plain "
          f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); no single PyTorch call computes it")
    return dict(call=f"p{p}_rows{rows}_b{b}" + ("_split" if split else ""), max_abs_err=0.0,
                ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, library_ms=None, **bound)


def check_dsag_update_int8(torch, p: int, rows: int, b: int, rng) -> dict:
    """Phase 3 for K4's int8 entry at one shape (``p`` groups of ``rows``
    rows of ``b`` elements, one bf16 scale per row); ``torch.equal`` to the
    plain version, every output."""
    return _int8_update_row(torch, _int8_inputs(torch, p, rows, b, rng), None,
                            f"[{p}, {rows}, {b}]", plain_reps=10)


def check_dsag_int8_split(torch, p: int, rows: int, b: int, rng, plain_reps: int = 2):
    """Phase 18 for K4-int8's split form at a rank's shard of each row: the
    row-max kernel and the update given maxima, each against its plain twin
    (``torch.equal``) and timed; returns ``(row-max row, update row)``."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import dsag_update

    args = _int8_inputs(torch, p, rows, b, rng)
    mx_args = args[:5] + (args[6],)
    shape = f"[{p}, {rows}, {b}]"
    got = dsag_update.dsag_int8_row_max(*mx_args)
    want = dsag_update.dsag_int8_row_max_plain(*mx_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        fail(f"dsag_int8_row_max {shape}: not equal to its plain version")
    k_ms, p_ms = timed_pair(torch, lambda: dsag_update.dsag_int8_row_max(*mx_args),
                            lambda: dsag_update.dsag_int8_row_max_plain(*mx_args),
                            reps=50, plain_reps=plain_reps)
    dev_ms, dev_kernels = device_ms(torch, lambda: dsag_update.dsag_int8_row_max(*mx_args), 50)
    bound = bound_of(roofline.dsag_int8_row_max_cost(p, rows, b))
    print(f"  dsag_int8_row_max {shape}: equal; kernel {k_ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}); no single PyTorch call "
          f"computes it")
    row_max = dict(call=f"p{p}_rows{rows}_b{b}_split", max_abs_err=0.0, ms=k_ms,
                   device_ms=dev_ms, plain_ms=p_ms, library_ms=None, **bound)
    # a whole row's maxima are at least the shard's: twice the shard's stands
    # for the other shards' larger values
    return row_max, _int8_update_row(torch, args, (got[0] * 2, got[1] * 2), shape, plain_reps)


def check_gram_matvec(torch, x, v) -> dict:
    """Phase 3 for K5 at one shape (``x`` [m, d] or [B, m, d])."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import gram_matvec

    got = gram_matvec.gram_matvec(x, v)
    want = gram_matvec.gram_matvec_plain(x, v)
    again = gram_matvec.gram_matvec(x, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    shape = "x".join(str(s) for s in x.shape) + "·" + "x".join(str(s) for s in v.shape)
    if not torch.isfinite(got).all() or not torch.allclose(
        got, want, rtol=F32_RTOL, atol=F32_ATOL_REL * scale
    ):
        fail(f"gram_matvec {shape} disagrees with its plain version: max |diff| "
             f"{err:.3e} at max |plain| {scale:.3e}")
    if not torch.equal(got, again):
        fail(f"gram_matvec {shape} does not repeat its bits")
    k_ms, p_ms = timed_pair(torch, lambda: gram_matvec.gram_matvec(x, v),
                            lambda: gram_matvec.gram_matvec_plain(x, v), reps=50, plain_reps=20)
    dev_ms, dev_kernels = device_ms(torch, lambda: gram_matvec.gram_matvec(x, v), 50)
    if x.dim() == 3:
        vb = v.expand(x.shape[0], *v.shape)
        lib_ms = cuda_ms(torch, lambda: torch.bmm(x.transpose(1, 2), torch.bmm(x, vb)), 20)
    else:
        lib_ms = cuda_ms(torch, lambda: x.T @ (x @ v), 20)
    B = x.shape[0] if x.dim() == 3 else 1
    m, d = x.shape[-2:]
    k = v.shape[1]
    bound = bound_of(roofline.gram_matvec_cost(B, m, d, k))
    b_ms, b_by = bound["bound_ms"], bound["bound_by"]
    path = "wide" if gram_matvec.is_wide(B, d, k) else "fast"
    print(f"  gram_matvec {shape} ({path} path): max|diff|={err:.3e} "
          f"(|plain|<={scale:.3e}); kernel "
          f"{k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, "
          f"matmul pair {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(call=shape, path=path, max_abs_err=err, ms=k_ms, device_ms=dev_ms,
                plain_ms=p_ms, library_ms=lib_ms, **bound)


def k6_within_tolerance(torch, got, want32) -> bool:
    rtol = K6_RTOL[str(got.dtype).removeprefix("torch.")]
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want32, rtol=rtol, atol=K6_ATOL_REL * float(want32.abs().max()))


def check_flash(torch, b: int, h: int, sq: int, sk: int, d: int, rng,
                causal: bool = True, dtype=None, kvh: int | None = None,
                bshd: bool = False) -> dict:
    """Phase 3 for K6 at one shape (bfloat16 by default): ``[b, h, s, d]``
    through ``flash_attention_op``, or with ``kvh`` kv heads (GQA) or
    ``bshd`` in the model's ``[b, s, h, d]`` layout through
    ``flash_attention_bshd`` (which takes a non-causal call over any key
    count, as whisper's encoder and cross-attention make)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.analysis import roofline
    from repro_torch.kernels import flash_attention as k6

    dtype = dtype or torch.bfloat16
    dev = torch.device("cuda")
    kvh = kvh or h

    def draw(n, heads):
        return torch.as_tensor(rng.normal(size=(b, n, heads, d)), dtype=torch.float32,
                               device=dev).to(dtype)

    if kvh == h and not bshd:
        q, k, v = (draw(n, h).transpose(1, 2).contiguous() for n in (sq, sk, sk))
        qh, kh, vh = q, k, v  # [b, h, s, d]

        def kernel():
            return k6.flash_attention_op(q, k, v, causal=causal)
    else:
        q, k, v = draw(sq, h), draw(sk, kvh), draw(sk, kvh)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return k6.flash_attention_bshd(q, k, v, causal=causal).transpose(1, 2)
    # the plain version takes the kv heads repeated (its CPU path does the same)
    kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (kh, vh))

    def plain():
        return k6.flash_attention_plain(qh, kr, vr, causal=causal)

    got = kernel()
    want = plain()
    want32 = k6.flash_attention_plain(qh.float(), kr.float(), vr.float(), causal=causal)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    heads = f"{h}" if kvh == h else f"{h} q / {kvh} kv"
    shape = f"[{b}, {heads}, {sq}/{sk}, {d}] {str(dtype).removeprefix('torch.')}"
    if not k6_within_tolerance(torch, got, want32):
        fail(f"flash_attention {shape} disagrees with its plain version: max |diff| "
             f"{float((got.float() - want32).abs().max()):.3e}")
    k_ms, p_ms = timed_pair(torch, kernel, plain, reps=20, plain_reps=5)
    dev_ms, dev_kernels = device_ms(torch, kernel, 20)
    # the library call: SDPA with K6's bottom-right causal mask (its
    # is_causal=True is top-left, the same only where sq == sk), on the same
    # kv heads (enable_gqa) and layout
    mask = causal_lower_right(sq, sk) if causal else None
    gqa = {"enable_gqa": True} if kvh != h else {}

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, **gqa)

    lib = library()
    lib_err = float((lib.float() - want32).abs().max())
    if lib_err > 0.05 * float(want32.abs().max()):  # a bf16 call, not another function
        fail(f"SDPA with a bottom-right causal mask disagrees with K6's function at {shape}: "
             f"max |diff| {lib_err:.3e}")
    lib_ms = cuda_ms(torch, library, 20)
    bound = bound_of(roofline.flash_attention_cost(b, h, kvh, sq, sk, d, causal, dtype))
    b_ms, b_by, flops = bound["bound_ms"], bound["bound_by"], bound["flops"]
    print(f"  flash_attention {shape} causal={causal}: max|diff|={err:.3e} vs plain "
          f"({str(dtype).removeprefix('torch.')} out); kernel {k_ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
          f"(max |SDPA - float32 plain| {lib_err:.3e}), "
          f"kernel/SDPA {k_ms / lib_ms:.2f}, bound {b_ms:.5f} ms ({b_by}, {flops:.3e} flops, "
          f"{flops / k_ms * 1e-9:.1f} TFLOP/s)")
    return dict(call=shape, max_abs_err=err, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                library_ms=lib_ms, **bound)


def committed_ttg() -> dict:
    bench = json.loads((ROOT / "BENCH_convergence.json").read_text())
    return {
        "grid": {m: v["median_time_to_gap"] for m, v in bench["methods"].items()},
        "pca_paper_scale": {
            m: v["median_time_to_gap"] for m, v in bench["pca_paper_scale"]["methods"].items()
        },
    }


def run_recipes(torch) -> tuple[dict, dict]:
    """Phase 4: both recipes through the kernels, then the plain rerun."""
    from repro_torch.experiments.convergence import (
        grid_logreg_sweep,
        paper_scale_pca_sweep,
        run_convergence_batch,
    )
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.results import convergence_ordering
    from repro_torch.kernels import launch_counts, reset_launch_counts

    committed = committed_ttg()
    counts = {}
    outcomes = {}
    reset_launch_counts()
    for recipe, sweep in (("grid", grid_logreg_sweep), ("pca_paper_scale", paper_scale_pca_sweep)):
        before = launch_counts()
        t0 = time.perf_counter()
        out, gap = sweep(seed=0, engine=EngineConfig(device="cuda", kernel_backend="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        counts[recipe] = {k: after[k] - before[k] for k in after}
        outcomes[recipe] = (out, gap)
        o = convergence_ordering(out, gap)
        print(f"  {recipe}: 4 methods x {out.traces.num_scenarios} scenarios x "
              f"{out.num_iterations} iters in {wall:.2f} s host wall clock "
              f"(engine {out.engine_seconds:.2f} s); launches {counts[recipe]}")
        print(f"    {'method':>6} {'port t->gap (sim s)':>22} {'committed (JAX, CPU)':>22} equal")
        for m in out.results:
            mine = o[f"median_time_to_gap_{m}"]
            theirs = committed[recipe].get(m)
            same = mine == (np.inf if theirs is None else theirs)
            print(f"    {m:>6} {mine!r:>22} {theirs!r:>22} {same}")
        for m, res in out.results.items():
            S, T = res.times.shape
            if res.suboptimality.shape != (S, T) or res.per_worker_latency.shape[:2] != (S, T):
                fail(f"{recipe}/{m}: result shapes {res.times.shape}, {res.suboptimality.shape}")
            if not np.isfinite(res.times).all() or not np.isfinite(res.suboptimality[:, -1]).all():
                fail(f"{recipe}/{m}: non-finite times or final suboptimality")
        t = {m: o[f"median_time_to_gap_{m}"] for m in ("dsag", "sag", "coded")}
        if not (np.isfinite(t["dsag"]) and t["dsag"] < t["sag"] < t["coded"]):
            fail(f"{recipe}: median time-to-gap ordering dsag < sag < coded broken: {t}")
        print(f"    dsag < sag < coded holds: sag/dsag={o['sag_over_dsag']:.3f} "
              f"coded/dsag={o['coded_over_dsag']:.3f}")
    total = launch_counts()
    for name in ("logreg_block_sub", "pca_block_sub", "grid_cache_update"):
        if total[name] == 0:
            fail(f"kernel {name} was never launched on the sweep path")
    if counts["grid"]["logreg_block_sub"] == 0 or counts["pca_paper_scale"]["pca_block_sub"] == 0:
        fail("a recipe ran without its block-subgradient kernel")
    if counts["grid"]["grid_cache_update"] == 0 or counts["pca_paper_scale"]["grid_cache_update"] == 0:
        fail("a recipe ran without the cache-walk kernel")

    # the grid recipe's dsag and sag once more, through the plain versions
    out, _ = outcomes["grid"]
    plain_engine = EngineConfig(device="cuda", kernel_backend="torch")
    for m in ("dsag", "sag"):
        ref = run_convergence_batch(out.problem, out.traces, out.methods[m], out.num_iterations,
                                    eval_every=out.eval_every, seed=out.seed, engine=plain_engine)
        res = out.results[m]
        if not (np.array_equal(ref.times, res.times)
                and np.array_equal(ref.fresh_counts, res.fresh_counts)
                and np.array_equal(ref.rejected_stale, res.rejected_stale)
                and np.array_equal(ref.per_worker_latency, res.per_worker_latency, equal_nan=True)):
            fail(f"grid/{m}: kernel and plain runs differ in their event streams")
        ok = np.isfinite(ref.suboptimality)
        rel = np.abs(res.suboptimality[ok] - ref.suboptimality[ok]) / np.abs(ref.suboptimality[ok])
        if not np.array_equal(ok, np.isfinite(res.suboptimality)) or rel.max() > 1e-4:
            fail(f"grid/{m}: suboptimality differs from the plain run by {rel.max():.3e}")
        print(f"  grid/{m} kernels vs plain on the card: event streams equal, "
              f"suboptimality max rel diff {rel.max():.3e} (tolerance 1e-4)")
    return total, counts, outcomes


#: the wide-feature sweep: the CLI at its default sizes with a PCA width past
#: K2's fast path (d*k > 1024 or 48 KB of shared memory from d = 180 at k = 3)
WIDE_SWEEP_ARGV = ["--problem", "pca", "--cols", "180"]


def run_wide_sweep(torch) -> dict:
    """Phase 4, last: ``python -m repro_torch.convergence_sweep --problem pca
    --cols 180`` through the kernels (K2's wide path, K3), with the counters
    set to 0 just before and read just after, then through
    ``--kernel-backend torch`` on the card: event streams equal,
    suboptimality within rtol 1e-4 + atol 1e-6."""
    from repro_torch import convergence_sweep
    from repro_torch.kernels import block_sub, launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out, gap, _ = convergence_sweep.run(WIDE_SWEEP_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    plain, _, _ = convergence_sweep.run(WIDE_SWEEP_ARGV + ["--kernel-backend", "torch"])
    S, N = out.traces.num_scenarios, out.traces.num_workers
    d, k = out.problem.X.shape[1], out.problem.k
    if not block_sub.pca_plan(S * N, out.problem.num_samples, d, k, None).wide:
        fail(f"--cols {d}: K2 took its fast path, not the wide one")
    for name in ("pca_block_sub", "grid_cache_update"):
        if counts[name] == 0:
            fail(f"--cols {d} sweep: kernel {name} was never launched")
    worst = 0.0
    for m, res in out.results.items():
        ref = plain.results[m]
        if not (np.array_equal(ref.times, res.times)
                and np.array_equal(ref.fresh_counts, res.fresh_counts)
                and np.array_equal(ref.rejected_stale, res.rejected_stale)
                and np.array_equal(ref.per_worker_latency, res.per_worker_latency, equal_nan=True)):
            fail(f"--cols {d} sweep/{m}: kernel and plain runs differ in their event streams")
        if not np.allclose(res.suboptimality, ref.suboptimality, rtol=1e-4, atol=1e-6,
                           equal_nan=True):
            fail(f"--cols {d} sweep/{m}: suboptimality differs from the plain run")
        ok = np.isfinite(ref.suboptimality)
        worst = max(worst, float(np.max(np.abs(res.suboptimality[ok] - ref.suboptimality[ok]))))
    print(f"  convergence_sweep {' '.join(WIDE_SWEEP_ARGV)} (n={out.problem.num_samples}, d={d}, "
          f"k={k}, {N} workers x {S} scenarios x {out.num_iterations} iters): {wall:.2f} s host; "
          f"launches {counts}; event streams equal to the plain run on the card, "
          f"suboptimality max |diff| {worst:.3e} (rtol 1e-4, atol 1e-6)")
    return counts


def paper_live_opts(arch: str, method: str, engine, steps: int = 80):
    """Trainer options of one paper-scale live job: heavy-burst traces of a
    ``make_heterogeneous_cluster`` fleet normalised to one group's load, 2
    scenarios (scenario 0 replayed), margin 0.02, eval every 10 steps."""
    from repro_torch.core.problems import (
        LogisticRegressionProblem,
        PCAProblem,
        make_genomics_like_matrix,
        make_higgs_like,
    )
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet
    from repro_torch.launch.paper_jobs import paper_train_config
    from repro_torch.launch.train import TrainerOptions

    n, G, w, eta = PAPER_JOBS[arch]
    if arch == "logreg":
        X, y = make_higgs_like(n, seed=0)
        prob = LogisticRegressionProblem(X=X, y=y)
    else:
        prob = PCAProblem(X=make_genomics_like_matrix(n, 64, seed=0))
    cluster = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, 2, 4 * steps, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    return TrainerOptions(
        arch=arch, steps=steps, samples=n, num_groups=G, dsag_w=w, method=method,
        traces=traces, scenario=0, train_config=paper_train_config(eta),
        simulate_stragglers=False, failure_max_misses=10**6, eval_every=10,
        log_every=10**6, seed=0, engine=engine,
    )


def timed_run(torch, opts):
    """(trainer, history, host seconds of ``run()`` ending in a synchronize)."""
    from repro_torch.launch.train import Trainer

    trainer = Trainer(opts)
    t0 = time.perf_counter()
    hist = trainer.run()
    torch.cuda.synchronize()
    return trainer, hist, time.perf_counter() - t0


def run_live(torch) -> dict:
    """Phase 5: the live two-tier trainer through K1, K4 and K5."""
    import dataclasses

    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.ft.validation import controller_streams, group_loads
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet
    from repro_torch.launch.paper_jobs import paper_train_config
    from repro_torch.launch.train import TrainerOptions, check_history

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    live_committed = json.loads((ROOT / "BENCH_convergence.json").read_text())["live_validation"]
    r = live_committed["recipe"]
    reset_launch_counts()

    # 5.1 the committed live_validation recipe
    n, G, T = r["num_samples"], r["n_workers"], r["num_iterations"]
    X, y = make_higgs_like(n, seed=r["seed"])
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=r["seed"] + 3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, r["n_scenarios"], 4 * T, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=r["seed"] + 7)
    first_virtual = {}
    print(f"  live_validation recipe (logreg {n} x 29, {G} groups, w={r['w']}, {T} steps, "
          f"margin {r['margin']}):")
    for m in ("dsag", "sag"):
        opts = TrainerOptions(
            arch="logreg", steps=T, samples=n, num_groups=G, dsag_w=r["w"], method=m,
            traces=traces, scenario=r["scenario"],
            train_config=dataclasses.replace(paper_train_config(r["eta"]),
                                             dsag_margin=r["margin"]),
            simulate_stragglers=False, failure_max_misses=10**6,
            eval_every=r["eval_every"], log_every=10**6, seed=r["seed"], engine=card,
        )
        _, hist, wall = timed_run(torch, opts)
        cs = controller_streams(traces, r["scenario"], w=r["w"], num_iterations=T,
                                loads=group_loads(prob, G), margin=r["margin"],
                                accepts_stale=m == "dsag")
        for f in ("mask", "flush", "evict"):
            if not np.array_equal(np.stack(hist[f"{f}_stream"]), getattr(cs, f)):
                fail(f"live_validation/{m}: the trainer's {f} stream differs from "
                     f"controller_streams")
        gap = hist["eval"][-1][3]
        want = live_committed["methods"][m]["final_gap_live"]
        rel = abs(gap - want) / want
        first_virtual[m] = next((v for (_s, _w, v, g) in hist["eval"] if g <= r["gap"]), np.inf)
        print(f"    {m}: streams equal controller_streams; final gap {gap!r} vs committed "
              f"{want!r} (rel diff {rel:.2e}, tolerance 1e-4); first eval at gap <= "
              f"{r['gap']} at virtual {first_virtual[m]:.6f} s (simulator's time-to-gap "
              f"{live_committed['methods'][m]['virtual_time_to_gap']:.6f} s); "
              f"{wall:.2f} s host, {wall / T * 1e3:.2f} ms/step")
        if not np.isfinite(gap) or rel > 1e-4:
            fail(f"live_validation/{m}: final gap {gap} vs committed {want}")
    if not first_virtual["dsag"] <= first_virtual["sag"]:
        fail(f"live_validation: dsag reached the gap later than sag: {first_virtual}")

    # 5.2 the paper-scale jobs
    finals = {}
    print(f"    {'job':>12} {'port final gap':>24} {'reference':>24} {'loss 0 -> 79':>24} "
          f"{'max xi':>7} {'fresh/flush':>11} {'host s':>7} {'ms/step':>8}")
    for arch in PAPER_JOBS:
        for m in ("dsag", "sag"):
            trainer, hist, wall = timed_run(torch, paper_live_opts(arch, m, card))
            gap_ref, virt_ref, l0_ref, l79_ref, xi_ref, fresh_ref, flush_ref = PAPER_LIVE[arch, m]
            gap = hist["eval"][-1][3]
            fresh = int(np.sum(hist["mask_stream"]))
            flush = int(np.sum(hist["flush_stream"]))
            xi = max(hist["xi"])
            loss0, loss79 = hist["loss"][0], hist["loss"][-1]
            print(f"    {arch + '/' + m:>12} {gap!r:>24} {gap_ref!r:>24} "
                  f"{f'{loss0:.6g} -> {loss79:.6g}':>24} {xi:>7.3f} {f'{fresh}/{flush}':>11} "
                  f"{wall:>7.3f} {wall / len(hist['loss']) * 1e3:>8.3f}")
            if (fresh, flush) != (fresh_ref, flush_ref) or xi != xi_ref:
                fail(f"{arch}/{m}: fresh/flush {fresh}/{flush}, max xi {xi} vs the "
                     f"reference's {fresh_ref}/{flush_ref}, {xi_ref}")
            if hist["virtual"][-1] != virt_ref:
                fail(f"{arch}/{m}: virtual time {hist['virtual'][-1]!r} vs {virt_ref!r}")
            if not np.isclose(gap, gap_ref, rtol=LIVE_GAP_RTOL[arch], atol=0.0):
                fail(f"{arch}/{m}: final gap {gap!r} vs the reference's {gap_ref!r}")
            for got, want in ((loss0, l0_ref), (loss79, l79_ref)):
                if not np.isclose(got, want, rtol=LIVE_LOSS_RTOL, atol=0.0):
                    fail(f"{arch}/{m}: loss {got!r} vs the reference's {want!r}")
            if m == "dsag":
                ok, msg = check_history(hist)
                if not ok:
                    fail(f"{arch}/dsag: {msg}")
            finals[arch, m] = (trainer.state["params"], hist)
    print(f"    gap tolerance rtol {LIVE_GAP_RTOL}; loss rtol {LIVE_LOSS_RTOL}; fresh, "
          f"flush, max xi and virtual time exact; dsag passes --check")
    counts = launch_counts()
    for name in ("logreg_block_sub", "dsag_cache_update", "gram_matvec"):
        if counts[name] == 0:
            fail(f"kernel {name} was never launched on the live path")
    print(f"  live path launches: {counts}")

    # 5.3 the logreg paper-scale dsag run through the plain versions on the card
    plain = EngineConfig(device="cuda", kernel_backend="torch")
    trainer, hist, wall = timed_run(torch, paper_live_opts("logreg", "dsag", plain))
    V_k, hist_k = finals["logreg", "dsag"]
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        if not np.array_equal(np.stack(hist[f]), np.stack(hist_k[f])):
            fail(f"logreg/dsag: kernel and plain runs differ in {f}")
    V_p = trainer.state["params"]
    err = float((V_k - V_p).abs().max())
    if not torch.allclose(V_k, V_p, rtol=1e-4, atol=1e-5 * float(V_p.abs().max())):
        fail(f"logreg/dsag: kernel and plain final params differ by {err:.3e}")
    print(f"  logreg/dsag through the plain versions on the card: streams equal, final "
          f"params max |diff| {err:.3e} (rtol 1e-4, atol 1e-5 max|V|); {wall:.2f} s host")
    return counts


#: phase 7: iterations of the pca_paper_scale recipe held scalar == host ==
#: device (the recipe runs 80; the scalar simulator walks one event at a time)
PCA_ENGINE_DEPTH = 20
#: the host engine's median K1/K2 batch (tasks per masked call) on the grid
#: recipe's dsag, sag and sgd and on pca_paper_scale's dsag and sag at
#: PCA_ENGINE_DEPTH: phase 3 times the kernels there, phase 7 checks the
#: medians (the event streams, hence the batches, are deterministic)
HOST_BATCH = {"logreg_block_sub": 947, "pca_block_sub": 200}


def engines_equal(label: str, scalar, batched: dict, scenario: int = 0) -> None:
    """Fail unless every batched result (engine -> ConvergenceBatchResult)
    equals the scalar history on ``scenario``, and the batched results equal
    each other on every scenario, bit for bit."""
    from repro_torch.experiments.convergence import history_mismatches

    (first, res0), *rest = batched.items()
    bad = history_mismatches(scalar, res0, scenario)
    if bad:
        fail(f"{label}: the scalar simulator differs from the {first} engine in {bad}")
    for name, res in rest:
        for s in range(res.num_scenarios):
            bad = history_mismatches(res0.history(s), res, s)
            if bad:
                fail(f"{label}: the {name} engine differs from the {first} engine "
                     f"on scenario {s} in {bad}")


def recording(block_sub, name: str, sizes: list):
    """``mock.patch`` of a K1/K2 wrapper that records each masked-batch
    call's task count (not the coded bound's full-range calls)."""
    real = getattr(block_sub, name)

    def wrapper(X, *args):
        Vb, max_width = args[-4], args[-1]
        if max_width != X.shape[0]:
            sizes.append(Vb.shape[0])
        return real(X, *args)

    return mock.patch.object(block_sub, name, wrapper)


def run_engines(torch, outcomes: dict) -> dict:
    """Phase 7: the scalar simulator and the host engine through K1/K2 against
    the device engine (bit for bit), the live pin without the reference, and
    the ``BENCH_sweep.json`` grid on the card.  Returns the K1/K2 launches
    of the host and scalar runs."""
    import dataclasses

    from repro_torch.cluster.simulator import MethodConfig
    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
    from repro_torch.experiments.convergence import run_convergence_batch, scalar_convergence_run
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import HEAVY_BURSTS, run_sweep, scalar_sweep_seconds
    from repro_torch.experiments.results import outcome_to_dict
    from repro_torch.ft.validation import pin_streams
    from repro_torch.kernels import block_sub, launch_counts, reset_launch_counts
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    host = dataclasses.replace(card, kind="host")
    counts = {"logreg_block_sub": 0, "pca_block_sub": 0}
    host_G = {"logreg_block_sub": [], "pca_block_sub": []}

    # (a) scalar == host == device through K1/K2
    for recipe, kname, methods, depth in (
        ("grid", "logreg_block_sub", ("dsag", "sag", "sgd", "coded"), None),
        ("pca_paper_scale", "pca_block_sub", ("dsag", "sag"), PCA_ENGINE_DEPTH),
    ):
        out, _ = outcomes[recipe]
        T = depth or out.num_iterations
        out = dataclasses.replace(out, num_iterations=T,
                                  methods={m: out.methods[m] for m in methods})
        runs = {"scan": {}, "host": {}}
        walls = {}
        for kind, eng in (("scan", card), ("host", host)):
            if kind == "scan" and depth is None:  # phase 4's runs at full depth
                runs[kind] = {m: out.results[m] for m in methods}
                walls[kind] = None
                continue
            reset_launch_counts()
            t0 = time.perf_counter()
            with recording(block_sub, kname, host_G[kname] if kind == "host" else []):
                for m in methods:
                    runs[kind][m] = run_convergence_batch(
                        out.problem, out.traces, out.methods[m], T,
                        eval_every=out.eval_every, seed=out.seed, engine=eng)
            torch.cuda.synchronize()
            walls[kind] = time.perf_counter() - t0
            if kind == "host":
                n_host = launch_counts()[kname]
                counts[kname] += n_host
        reset_launch_counts()
        t0 = time.perf_counter()
        scalar = {m: scalar_convergence_run(out, m, 0, engine=card) for m in methods}
        walls["scalar"] = time.perf_counter() - t0
        n_scalar = launch_counts()[kname]
        counts[kname] += n_scalar
        if n_host == 0 or n_scalar == 0:
            fail(f"{recipe}: {kname} was not launched on the host ({n_host}) or the "
                 f"scalar ({n_scalar}) path")
        for m in methods:
            engines_equal(f"{recipe}/{m}", scalar[m], {k: runs[k][m] for k in ("scan", "host")})
        S = out.traces.num_scenarios
        scan_wall = (f"{walls['scan']:.2f} s" if walls["scan"] is not None
                     else f"{outcomes[recipe][0].engine_seconds:.2f} s (phase 4, all 4 methods)")
        print(f"  {recipe} ({len(methods)} methods, {T} iterations, scenario 0 of {S}): "
              f"scalar == host == device bit for bit (times, fresh counts, per-worker "
              f"latencies, rejects, evictions, suboptimality); host and device equal on "
              f"all {S} scenarios")
        print(f"    wall clock: device engine {scan_wall}; host engine {walls['host']:.2f} s "
              f"({n_host} {kname} launches, tasks per launch median "
              f"{int(np.median(host_G[kname]))}); scalar simulator {walls['scalar']:.2f} s "
              f"for scenario 0 ({n_scalar} launches), {walls['scalar'] * S:.2f} s scaled to "
              f"{S} scenarios (scalar_convergence_seconds' extrapolation)")

    # phase 3 held and timed K1/K2 at these batches
    medians = {k: int(np.median(v)) for k, v in host_G.items()}
    if medians != HOST_BATCH:
        fail(f"the host engine's median K1/K2 batches {medians} are not phase 3's {HOST_BATCH}")

    # (b) the live pin: the port's controller == the port's scalar simulator
    live = json.loads((ROOT / "BENCH_convergence.json").read_text())["live_validation"]
    r = live["recipe"]
    n, G, T = r["num_samples"], r["n_workers"], r["num_iterations"]
    X, y = make_higgs_like(n, seed=r["seed"])
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=r["seed"] + 3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, r["n_scenarios"], 4 * T, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=r["seed"] + 7)
    jobs = [("live_validation", prob, cluster, traces, r["scenario"], T, r["w"], r["eta"],
             r["margin"], r["seed"])]
    n, G, w, eta = PAPER_JOBS["logreg"]
    X, y = make_higgs_like(n, seed=0)
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, 2, 4 * 80, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    jobs.append(("paper-scale logreg", prob, cluster, traces, 0, 80, w, eta, 0.02, 0))
    for label, prob, cluster, traces, scen, T, w, eta, margin, seed in jobs:
        for m in ("dsag", "sag"):
            cfg = MethodConfig(name=m, w=w, eta=eta, margin=margin, subpartitions=1)
            t0 = time.perf_counter()
            ctrl, sim, hist = pin_streams(prob, cluster, traces, scen, cfg, T, seed=seed,
                                          engine=card)
            wall = time.perf_counter() - t0
            if not (ctrl == sim and np.array_equal(ctrl.times, sim.times)):
                fail(f"pin {label}/{m}: controller and simulator differ: "
                     f"{ctrl.mismatch_summary(sim)}")
            msg = ""
            if label == "live_validation":
                want = live["methods"][m]["virtual_time_to_gap"]
                got = hist.time_to_gap(r["gap"])
                msg = (f"; simulator time-to-gap {got!r} (the reference's {want!r}, "
                       f"equal: {got == want})")
            print(f"  pin {label}/{m} ({traces.num_workers} groups, {T} steps): controller "
                  f"== simulator (mask, flush, evict, virtual times; Σ fresh "
                  f"{int(sim.mask.sum())}, Σ flush {int(sim.flush.sum())}) in {wall:.2f} s{msg}")

    # (c) the BENCH_sweep.json grid on the card
    committed = json.loads((ROOT / "BENCH_sweep.json").read_text())
    g = committed["grid"]
    sweep = run_sweep(n_workers=g["n_workers"], n_seeds=g["n_seeds"],
                      num_iterations=g["num_iterations"], w_fracs=(0.8,), device="cuda")
    mine = outcome_to_dict(sweep)
    fields = ("mean_iter_time", "std_iter_time", "mean_fresh", "n_seeds")
    if set(mine["cells"]) != set(committed["cells"]):
        fail(f"sweep cells {sorted(mine['cells'])} vs committed {sorted(committed['cells'])}")
    for key, cell in committed["cells"].items():
        for f in fields:
            if mine["cells"][key][f] != cell[f]:
                fail(f"sweep cell {key}: {f} {mine['cells'][key][f]!r} vs committed {cell[f]!r}")
    if mine["ordering"] != committed["ordering"]:
        fail(f"sweep orderings differ from the committed ones: {mine['ordering']}")
    scalar_s = scalar_sweep_seconds(sweep)
    print(f"  BENCH_sweep grid ({g['n_workers']} workers x {g['n_seeds']} seeds x "
          f"{g['num_iterations']} iterations, {len(mine['cells'])} cells, 3 regimes): "
          f"{', '.join(fields)} and the 3 orderings equal the committed file; engine "
          f"{sweep.engine_seconds:.3f} s on the card, scalar_sweep_seconds {scalar_s:.2f} s "
          f"({scalar_s / sweep.engine_seconds:.1f}x)")
    return counts


#: phase 8 (d): iterations of pca_paper_scale's dsag with the §6 balancer
#: (the recipe runs 80; the scalar simulator walks one event at a time)
PCA_LB_DEPTH = 40
#: the lb_scan column's values held for equality with the committed file
LB_KEYS = ("median_time_to_gap_dsag_lb", "reached_gap_frac_dsag_lb", "dsag_lb_fastest_to_gap",
           "sag_over_dsag_lb", "coded_over_dsag_lb", "sgd_over_dsag_lb")


def counting(jlb, name: str, log: list):
    """``mock.patch`` of an optimizer function that logs each call's
    seconds (ending in a synchronize) and first arguments."""
    import torch

    real = getattr(jlb, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, args, kw))
        return out

    return mock.patch.object(jlb, name, wrapper)


def run_lb(torch, outcomes: dict) -> dict:
    """Phase 8: §6 load balancing through the three engines on the card."""
    import dataclasses

    from repro_torch.cluster.simulator import TraceLatencySource, TrainingSimulator
    from repro_torch.experiments.convergence import (
        GRID_LB,
        run_convergence_batch,
    )
    from repro_torch.experiments.engine import (
        CAP_ACTIVE_SET,
        CAP_TILED,
        EngineCapabilityError,
        EngineConfig,
    )
    from repro_torch.experiments.fused import scan_capability
    from repro_torch.experiments.results import run_lb_scan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.lb import jit_optimizer as jlb

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    committed = json.loads((ROOT / "BENCH_convergence.json").read_text())["lb_scan"]
    counts = dict.fromkeys(launch_counts(), 0)

    def add_counts() -> dict:
        now = launch_counts()
        for k, v in now.items():
            counts[k] += v
        return now

    # (a) the lb_scan recipe through the device and host engines
    out, gap = outcomes["grid"]
    N, S, T = out.traces.num_workers, out.traces.num_scenarios, out.num_iterations
    dsag = dataclasses.replace(out.methods["dsag"], **GRID_LB)
    calls, hs = [], []
    reset_launch_counts()
    with counting(jlb, "lb_update", calls), counting(jlb, "estimate_h", hs):
        run = run_lb_scan(out.problem, out.traces, dsag, num_iterations=T,
                          eval_every=out.eval_every, seed=out.seed, engine=card)
    n_a = add_counts()
    if n_a["logreg_block_sub"] == 0 or n_a["what_if_replay"] == 0:
        fail(f"lb_scan ran without logreg_block_sub or what_if_replay: {n_a}")
    bad = run.mismatches()
    if bad:
        fail(f"lb_scan: the host and device engines differ in {bad}")
    base = {m: float(np.median(r.time_to_gap(gap))) for m, r in out.results.items()}
    col = run.column(gap, base)
    print(f"  lb_scan (grid recipe's dsag, load_balance, {GRID_LB}; {N} workers x {S} "
          f"scenarios x {T} iterations): host == device bit for bit (times, suboptimality, "
          f"fresh counts, per-worker latencies, repartition events, evictions, rejects); "
          f"launches over both engines: {n_a['logreg_block_sub']} logreg_block_sub, "
          f"{n_a['what_if_replay']} what_if_replay")
    print(f"    {'value':>28} {'port (card)':>22} {'committed':>22} equal")
    mine = dict(col["ordering"], repartitions_mean=col["repartitions_mean"])
    for key in LB_KEYS + ("repartitions_mean",):
        theirs = committed["ordering"].get(key, committed.get(key))
        print(f"    {key:>28} {mine[key]!r:>22} {theirs!r:>22} {mine[key] == theirs}")
        if mine[key] != theirs:
            fail(f"lb_scan: {key} {mine[key]!r} differs from the committed {theirs!r}")
    opt_s = [c[0] for c in calls]
    print(f"    wall clock (host, synchronized): device engine {run.scan_seconds:.2f} s, host "
          f"engine {run.host_seconds:.2f} s; the reference's CPU figures (JAX on the CPU, "
          f"committed): scan {committed['scan_seconds']:.2f} s, host "
          f"{committed['host_seconds']:.2f} s")
    # the engines are bit-equal, so each made the same calls
    print(f"    Algorithm 1 (lb_update): {len(calls) // 2} batched calls per engine, "
          f"{sum(opt_s):.2f} s over both, {np.median(opt_s):.3f} s median per call; "
          f"{len(hs)} h estimates (K={jlb.SIM_ITERATIONS} what-if iterations each), "
          f"{np.median([h[0] for h in hs]) * 1e3:.2f} ms median each")

    # (b) the scalar simulator on scenario 0
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = TrainingSimulator(out.problem, out.cluster, run.config, eval_every=out.eval_every,
                             seed=out.seed, latency_source=TraceLatencySource(out.traces, 0),
                             engine=card).run(T)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    n_b = add_counts()
    engines_equal("lb_scan scalar/scenario 0", hist, {"scan": run.scan})
    print(f"  lb_scan scalar simulator, scenario 0: == row 0 of the device engine bit for bit "
          f"({len(hist.repartition_events)} repartitions) in {wall_b:.2f} s "
          f"({n_b['logreg_block_sub']} logreg_block_sub, {n_b['what_if_replay']} "
          f"what_if_replay launches)")

    # (c) the slot budget: (a) ran the tiled cache; the tightest budget that
    # holds its resident entries takes the recipe, one entry less refuses it
    cap = scan_capability(out.problem, run.config, N)
    tight = scan_capability(out.problem, run.config, N, slot_budget=cap.slots_resident)
    if cap.code != CAP_TILED or tight.code != CAP_TILED:
        fail(f"lb_scan: scan_capability reports {cap.code} (default budget) and {tight.code} "
             f"(budget {cap.slots_resident}), not {CAP_TILED}")
    reset_launch_counts()
    try:
        run_convergence_batch(out.problem, out.traces, run.config, T, eval_every=out.eval_every,
                              seed=out.seed,
                              engine=dataclasses.replace(card, kind="scan",
                                                         slot_budget=cap.slots_resident - 1))
    except EngineCapabilityError as e:
        code = e.capability.code
    else:
        fail(f"lb_scan ran on the device engine past a slot budget of {cap.slots_resident - 1}")
    refused_launches = sum(launch_counts().values())
    if code != CAP_ACTIVE_SET or refused_launches:
        fail(f"lb_scan past its slot budget: refused with {code}, after {refused_launches} "
             f"launches (expected {CAP_ACTIVE_SET}, before any)")
    print(f"  lb_scan slot budget: (a) ran the tiled cache ({cap.code}, <= "
          f"{cap.slots_resident} resident entries of a {cap.slots_total}-slot universe); "
          f"budget {cap.slots_resident} -> {tight.code}; budget {cap.slots_resident - 1} -> "
          f"kind='scan' refused with {code} before any launch")

    # (d) PCA with §6 through K2 at reduced depth
    out_p, _ = outcomes["pca_paper_scale"]
    cfg_p = dataclasses.replace(out_p.methods["dsag"], load_balance=True, **GRID_LB)
    Tp = PCA_LB_DEPTH
    runs, walls = {}, {}
    reset_launch_counts()
    for kind in ("scan", "host"):
        t0 = time.perf_counter()
        runs[kind] = run_convergence_batch(out_p.problem, out_p.traces, cfg_p, Tp,
                                           eval_every=out_p.eval_every, seed=out_p.seed,
                                           engine=dataclasses.replace(card, kind=kind))
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist_p = TrainingSimulator(out_p.problem, out_p.cluster, cfg_p, eval_every=out_p.eval_every,
                               seed=out_p.seed,
                               latency_source=TraceLatencySource(out_p.traces, 0),
                               engine=card).run(Tp)
    torch.cuda.synchronize()
    walls["scalar"] = time.perf_counter() - t0
    n_d = add_counts()
    if n_d["pca_block_sub"] == 0 or n_d["what_if_replay"] == 0:
        fail(f"PCA with §6 ran without pca_block_sub or what_if_replay: {n_d}")
    engines_equal("pca_paper_scale dsag+lb", hist_p, runs)
    reps = [len(e) for e in runs["scan"].repartition_events]
    if sum(reps) == 0:
        fail("PCA with §6: no scenario published a repartition")
    print(f"  pca_paper_scale dsag, load_balance ({GRID_LB}), {Tp} of 80 iterations, "
          f"{out_p.traces.num_scenarios} scenarios: scalar == host == device bit for bit "
          f"(repartitions per scenario {reps}, evictions {runs['scan'].evictions.tolist()}); "
          f"device {walls['scan']:.2f} s, host {walls['host']:.2f} s, scalar scenario 0 "
          f"{walls['scalar']:.2f} s; {n_d['pca_block_sub']} pca_block_sub, "
          f"{n_d['what_if_replay']} what_if_replay launches")

    # (e) (a)'s first Algorithm-1 call again, through K7 and through its plain
    # version on the card (comparison runs: their launches are not counted)
    args, kw = calls[0][1], calls[0][2]
    for backend in ("cuda", "torch"):
        hs_e = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting(jlb, "estimate_h", hs_e):
            jlb.lb_update(*args, **dict(kw, kernel_backend=backend))
        torch.cuda.synchronize()
        print(f"  lb_scan's first Algorithm-1 call, replay through "
              f"{'K7' if backend == 'cuda' else 'its plain version'}: "
              f"{time.perf_counter() - t0:.3f} s, {len(hs_e)} h estimates, "
              f"{np.median([h[0] for h in hs_e]) * 1e3:.2f} ms median each")
    reset_launch_counts()
    return counts


#: the §7.2 run of phase 9 (d): the paper's 49 workers, slowed by
#: 1 + (i/N) 0.4, the last 10 relieved halfway through the churn-free run
ART72 = dict(n_workers=49, n_scenarios=4, num_iterations=60, w=40, removed=10)


def churn_of(out, committed_recipe: dict, T: int | None = None):
    """``out``'s traces under the churn column's schedule rule (its
    fractions from the committed recipe), waiting for the recipe's dsag w:
    ``(churned traces, schedule dict)``."""
    from repro_torch.cluster.simulator import effective_w
    from repro_torch.experiments.results import fleet_churn

    r = committed_recipe
    churn, sch = fleet_churn(
        out.traces, effective_w(out.methods["dsag"], out.traces.num_workers),
        T or out.num_iterations, death_frac=r["death_frac"], death_at_frac=r["death_at_frac"],
        revive_frac=r["revive_frac"], revive_at_frac=r["revive_at_frac"], device="cuda")
    return out.traces.with_churn(churn), sch


def run_churn(torch, outcomes: dict) -> dict:
    """Phase 9: elastic-fleet churn through the three engines on the card."""
    import dataclasses

    from repro_torch.cluster.simulator import (
        MethodConfig,
        TraceLatencySource,
        TrainingSimulator,
    )
    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
    from repro_torch.experiments.convergence import (
        GRID_LB,
        result_mismatches,
        run_convergence_batch,
        scalar_convergence_run,
    )
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.experiments.results import run_churn_column
    from repro_torch.ft.validation import controller_streams, group_loads, pin_streams
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.latency.model import (
        ChurnSchedule,
        SlowdownRemoval,
        make_heterogeneous_cluster,
        make_paper_artificial_cluster,
        paper_artificial_churn,
        sample_fleet,
    )
    from repro_torch.lb import jit_optimizer as jlb

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    bench = json.loads((ROOT / "BENCH_convergence.json").read_text())
    committed = bench["churn"]
    counts = dict.fromkeys(launch_counts(), 0)

    def add_counts() -> dict:
        now = launch_counts()
        for k, v in now.items():
            counts[k] += v
        return now

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def batched(prob, traces, methods, T, eval_every, seed) -> tuple[dict, dict]:
        """Each method through the device and the host engine: results and
        wall clocks; fails unless the engines agree bit for bit."""
        runs, walls = {}, {}
        for m, cfg in methods.items():
            for kind in ("scan", "host"):
                runs[m, kind], walls[m, kind] = timed(lambda: run_convergence_batch(
                    prob, traces, cfg, T, eval_every=eval_every, seed=seed,
                    engine=dataclasses.replace(card, kind=kind)))
            bad = result_mismatches(runs[m, "scan"], runs[m, "host"])
            if bad:
                fail(f"churn {m}: the device and host engines differ in {bad}")
        return runs, walls

    def sch_text(sch) -> str:
        return (f"workers {sch['dead_workers']} die at {sch['death_at']!r} s, "
                f"{sch['revived_workers']} rejoin at {sch['revive_at']!r} s")

    # (a) the committed churn column, host and device engines through K1 and K3
    reset_launch_counts()
    col_run, wall_a = timed(lambda: run_churn_column(committed["recipe"], engine=card))
    n_a = add_counts()
    col = col_run.column
    outcomes["churn"] = col_run  # phase 11 (c), (d) shard its runs
    if n_a["logreg_block_sub"] == 0 or n_a["grid_cache_update"] == 0:
        fail(f"the churn column ran without logreg_block_sub or grid_cache_update: {n_a}")
    print(f"  churn column (committed recipe: {committed['recipe']['n_workers']} workers x "
          f"{committed['recipe']['n_scenarios']} scenarios x "
          f"{committed['recipe']['num_iterations']} iterations; {sch_text(col['schedule'])}): "
          f"{wall_a:.2f} s for dsag, sag, coded through both engines; launches "
          f"{n_a['logreg_block_sub']} logreg_block_sub, {n_a['grid_cache_update']} "
          f"grid_cache_update")
    print(f"    {'value':>34} {'port (card)':>22} {'committed':>22} equal")
    rows = [("bitexact_scan_vs_host", col["bitexact_scan_vs_host"],
             committed["bitexact_scan_vs_host"])]
    rows += [(f"schedule.{k}", v, committed["schedule"][k]) for k, v in col["schedule"].items()]
    rows += [(f"{m}.{k}", v, committed["methods"][m][k])
             for m in col["methods"] for k, v in col["methods"][m].items()]
    rows += [(f"ordering.{k}", v, committed["ordering"].get(k)) for k, v in col["ordering"].items()]
    for key, mine, theirs in rows:
        print(f"    {key:>34} {mine!r:>22} {theirs!r:>22} {mine == theirs}")
    for key in ("bitexact_scan_vs_host", "schedule", "methods", "ordering"):
        if col[key] != committed[key]:
            fail(f"churn column: {key} {col[key]!r} differs from the committed {committed[key]!r}")
    reset_launch_counts()
    wall_s = {}
    for m, cfg in col_run.methods.items():
        if m not in col_run.runs:
            continue
        hist, wall_s[m] = timed(lambda: TrainingSimulator(
            col_run.problem, col_run.cluster, cfg, eval_every=committed["recipe"]["eval_every"],
            seed=committed["recipe"]["seed"],
            latency_source=TraceLatencySource(col_run.traces, 0), engine=card).run(
                committed["recipe"]["num_iterations"]))
        engines_equal(f"churn column {m}", hist, col_run.runs[m])
    n_as = add_counts()
    print(f"    scalar simulator, scenario 0: == row 0 for dsag, sag, coded "
          f"({', '.join(f'{m} {w:.2f} s' for m, w in wall_s.items())}; "
          f"{n_as['logreg_block_sub']} logreg_block_sub launches)")

    # (b) the grid recipe at full width under the column's schedule rule
    out, gap = outcomes["grid"]
    churned, sch = churn_of(out, committed["recipe"])
    methods = {m: out.methods[m] for m in ("dsag", "sag", "sgd", "coded")}
    T = out.num_iterations
    # the churn-free device runs again, warm, beside the churned ones: what
    # the liveness algebra and the clears (a host read per iteration) cost
    # (a comparison run: its launches are not counted)
    _, wall_free = timed(lambda: [run_convergence_batch(
        out.problem, out.traces, cfg, T, eval_every=out.eval_every, seed=out.seed,
        engine=dataclasses.replace(card, kind="scan")) for cfg in methods.values()])
    reset_launch_counts()
    runs, walls = batched(out.problem, churned, methods, T, out.eval_every, out.seed)
    n_b = add_counts()
    if n_b["logreg_block_sub"] == 0 or n_b["grid_cache_update"] == 0:
        fail(f"the grid recipe under churn ran without K1 or K3: {n_b}")
    reset_launch_counts()
    churned_out = dataclasses.replace(out, traces=churned)
    for m in ("dsag", "sag"):
        hist, walls[m, "scalar"] = timed(lambda: scalar_convergence_run(churned_out, m, 0,
                                                                        engine=card))
        engines_equal(f"grid/{m} under churn", hist, {"scan": runs[m, "scan"]})
    n_bs = add_counts()
    med = {m: float(np.median(runs[m, "scan"].time_to_gap(gap))) for m in methods}
    base = {m: float(np.median(r.time_to_gap(gap))) for m, r in out.results.items()}
    print(f"  grid recipe under churn ({out.traces.num_workers} workers x "
          f"{out.traces.num_scenarios} scenarios x {T} iterations, w {methods['dsag'].w}; "
          f"{sch_text(sch)}): dsag, sag, sgd, coded device == host bit for bit on every "
          f"scenario; scalar == row 0 for dsag and sag")
    print(f"    wall clock: device engine {sum(walls[m, 'scan'] for m in methods):.2f} s, host "
          f"engine {sum(walls[m, 'host'] for m in methods):.2f} s (4 methods; churn-free "
          f"device run, warm, in this call {wall_free:.2f} s; phase 4's "
          f"{out.engine_seconds:.2f} s); scalar scenario 0 dsag "
          f"{walls['dsag', 'scalar']:.2f} s, sag {walls['sag', 'scalar']:.2f} s; launches "
          f"{n_b['logreg_block_sub']} logreg_block_sub, {n_b['grid_cache_update']} "
          f"grid_cache_update (+{n_bs['logreg_block_sub']} scalar)")
    n_alive = out.traces.num_workers - len(sch["dead_workers"])
    print(f"    median t->gap under churn {med}; churn-free {base}; dsag < sag < coded "
          f"{med['dsag'] < med['sag'] < med['coded']} (reported, not required: with "
          f"{len(sch['dead_workers'])} dead and w = {methods['dsag'].w}, dsag waits for "
          f"min(w, {n_alive}) living workers)")

    # (c) §6 under churn at full width: the lb_scan recipe with the same schedule
    dsag_lb = dataclasses.replace(out.methods["dsag"], load_balance=True, **GRID_LB)
    calls = []
    reset_launch_counts()
    with counting(jlb, "lb_update", calls):
        runs_c, walls_c = batched(out.problem, churned, {"dsag_lb": dsag_lb}, T,
                                  out.eval_every, out.seed)
    n_c = add_counts()
    if n_c["logreg_block_sub"] == 0 or n_c["what_if_replay"] == 0:
        fail(f"§6 under churn ran without K1 or K7: {n_c}")
    with_dead = sum(1 for _, args, kw in calls if kw.get("alive") is not None
                    and bool((~kw["alive"] & args[7][:, None]).any()))
    if with_dead == 0:
        fail("§6 under churn: no Algorithm-1 call was made with a dead worker")
    reset_launch_counts()
    hist_c, wall_cs = timed(lambda: TrainingSimulator(
        out.problem, out.cluster, dsag_lb, eval_every=out.eval_every, seed=out.seed,
        latency_source=TraceLatencySource(churned, 0), engine=card).run(T))
    n_cs = add_counts()
    engines_equal("lb_scan under churn, scalar/scenario 0", hist_c,
                  {"scan": runs_c["dsag_lb", "scan"]})
    reps = [len(e) for e in runs_c["dsag_lb", "scan"].repartition_events]
    med_c = float(np.median(runs_c["dsag_lb", "scan"].time_to_gap(gap)))
    opt_s = [c[0] for c in calls]
    print(f"  lb_scan recipe under churn ({GRID_LB}; same schedule): device == host bit for bit "
          f"on all {out.traces.num_scenarios} scenarios (publication times included), scalar == "
          f"row 0 ({len(hist_c.repartition_events)} repartitions); repartitions per scenario "
          f"{reps}; median t->gap {med_c!r}")
    print(f"    wall clock: device engine {walls_c['dsag_lb', 'scan']:.2f} s, host engine "
          f"{walls_c['dsag_lb', 'host']:.2f} s, scalar scenario 0 {wall_cs:.2f} s; Algorithm 1: "
          f"{len(calls)} batched calls over both engines, {with_dead} with a dead worker in an "
          f"active scenario, {sum(opt_s):.2f} s, {np.median(opt_s):.3f} s median per call; "
          f"launches {n_c['logreg_block_sub']} logreg_block_sub, {n_c['what_if_replay']} "
          f"what_if_replay (+{n_cs['what_if_replay']} scalar)")

    # (d) §7.2: SlowdownRemoval events on a replayed trace through the scalar
    # simulator, against the engines on the folded schedule
    a = ART72
    X, y = make_higgs_like(16_384, seed=0)
    prob = LogisticRegressionProblem(X=X, y=y)
    N = a["n_workers"]
    cluster = make_paper_artificial_cluster(
        num_workers=N, load_unit=prob.compute_cost(1, 16_384 // (N * 10)), seed=1)
    traces = sample_fleet(cluster, a["n_scenarios"], a["num_iterations"], seed=7)
    methods = {"dsag": MethodConfig(name="dsag", w=a["w"], eta=0.25, subpartitions=10),
               "sag": MethodConfig(name="sag", w=N, eta=0.25, subpartitions=10)}
    base_d = run_convergence_batch(prob, traces, methods["sag"], a["num_iterations"],
                                   eval_every=5, engine=card)
    remove_at = float(np.median(base_d.times[:, -1])) / 2
    paper = paper_artificial_churn(num_workers=N, remove_at=remove_at,
                                   num_removed=a["removed"])
    removal = SlowdownRemoval(time=remove_at, workers=tuple(range(N - a["removed"], N)))
    reset_launch_counts()
    runs_d, walls_d = batched(prob, traces.with_churn(paper), methods, a["num_iterations"], 5, 0)
    for m, cfg in methods.items():
        src = TraceLatencySource(traces, 0)
        hist_d, walls_d[m, "scalar"] = timed(lambda: TrainingSimulator(
            prob, cluster, cfg, eval_every=5, latency_source=src,
            timed_events=[(remove_at, removal)], engine=card).run(a["num_iterations"]))
        folded = src.traces.churn
        if not (np.array_equal(folded.times, paper.times)
                and np.array_equal(folded.slowdown, paper.slowdown)):
            fail("§7.2: the folded timed event is not paper_artificial_churn's schedule")
        engines_equal(f"§7.2 {m}", hist_d, {"scan": runs_d[m, "scan"], "host": runs_d[m, "host"]})
    n_d = add_counts()
    before = base_d.times[:, -1]
    print(f"  §7.2 ({N} workers slowed by 1 + (i/N) 0.4, the last {a['removed']} relieved at "
          f"{remove_at!r} s, {a['n_scenarios']} scenarios x {a['num_iterations']} iterations): "
          f"the scalar simulator with SlowdownRemoval timed events == the device and host "
          f"engines on paper_artificial_churn's schedule, bit for bit, dsag and sag; sag's run "
          f"{np.median(before):.4f} s without the removal, "
          f"{np.median(runs_d['sag', 'scan'].times[:, -1]):.4f} s with it; wall clock "
          f"device {sum(walls_d[m, 'scan'] for m in methods):.2f} s, host "
          f"{sum(walls_d[m, 'host'] for m in methods):.2f} s, scalar scenario 0 dsag "
          f"{walls_d['dsag', 'scalar']:.2f} s, sag {walls_d['sag', 'scalar']:.2f} s; "
          f"{n_d['logreg_block_sub']} logreg_block_sub launches")

    # (e) PCA: pca_paper_scale's dsag and sag under the schedule rule, K2 and K3
    out_p, _ = outcomes["pca_paper_scale"]
    Tp = PCA_ENGINE_DEPTH
    churned_p, sch_p = churn_of(out_p, committed["recipe"], Tp)
    methods_p = {m: out_p.methods[m] for m in ("dsag", "sag")}
    reset_launch_counts()
    runs_e, walls_e = batched(out_p.problem, churned_p, methods_p, Tp, out_p.eval_every,
                              out_p.seed)
    out_pc = dataclasses.replace(out_p, traces=churned_p, num_iterations=Tp)
    for m in methods_p:
        hist_e, walls_e[m, "scalar"] = timed(lambda: scalar_convergence_run(out_pc, m, 0,
                                                                            engine=card))
        engines_equal(f"pca_paper_scale/{m} under churn", hist_e, {"scan": runs_e[m, "scan"]})
    n_e = add_counts()
    if n_e["pca_block_sub"] == 0 or n_e["grid_cache_update"] == 0:
        fail(f"PCA under churn ran without K2 or K3: {n_e}")
    print(f"  pca_paper_scale dsag and sag under churn ({Tp} of 80 iterations; "
          f"{sch_text(sch_p)}): scalar == host == device bit for bit; "
          f"{n_e['pca_block_sub']} pca_block_sub, {n_e['grid_cache_update']} grid_cache_update "
          f"launches; device {sum(walls_e[m, 'scan'] for m in methods_p):.2f} s, host "
          f"{sum(walls_e[m, 'host'] for m in methods_p):.2f} s")

    # (f) the live pin under churn: the port's controller == the port's simulator
    live = bench["live_validation"]
    r = live["recipe"]
    n, G, T = r["num_samples"], r["n_workers"], r["num_iterations"]
    X, y = make_higgs_like(n, seed=r["seed"])
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=r["seed"] + 3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, r["n_scenarios"], 4 * T, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=r["seed"] + 7)
    scen = r["scenario"]
    base_f = controller_streams(traces, scen, w=r["w"], num_iterations=T,
                                loads=group_loads(prob, G))
    alive = np.ones((3, G), dtype=bool)
    alive[1, [2, 5]] = False
    alive[2, 5] = False
    tch = traces.with_churn(ChurnSchedule(
        times=np.array([float(base_f.times[T // 3]), float(base_f.times[2 * T // 3])]),
        slowdown=np.tile(traces.slowdown, (3, 1)), alive=alive))
    reset_launch_counts()
    for m in ("dsag", "sag"):
        cfg = MethodConfig(name=m, w=r["w"], eta=r["eta"], margin=r["margin"], subpartitions=1)
        (ctrl, sim, _), wall = timed(lambda: pin_streams(prob, cluster, tch, scen, cfg, T,
                                                         seed=r["seed"], engine=card))
        if not (ctrl == sim and np.array_equal(ctrl.times, sim.times)):
            fail(f"pin live_validation/{m} under churn: {ctrl.mismatch_summary(sim)}")
        if not sim.evict.any():
            fail(f"pin live_validation/{m} under churn: no death cleared a cache slot")
        print(f"  pin live_validation/{m} under churn (groups 2 and 5 die at step {T // 3}, "
              f"2 rejoins at step {2 * T // 3}): controller == simulator (mask, flush, evict, "
              f"virtual times; Σ fresh {int(sim.mask.sum())}, Σ evict {int(sim.evict.sum())}) "
              f"in {wall:.2f} s")
    add_counts()
    reset_launch_counts()
    return counts


#: phase 10 (b): iterations of the CLI's --load-balance run
CLI_LB_ITERS = 200
#: phase 10 (a): the committed payload fields that are wall clocks (not compared)
WALL_CLOCK_KEYS = ("engine_seconds",)
#: phase 10 (a): a committed field that the reference's fused XLA engine
#: wrote, where its own host engine and scalar simulator (and so the port's
#: three engines) give another value, held exactly to that one instead: the
#: coded bound's event times at pca_paper_scale differ between the
#: reference's two engines by an ulp host engine on the CPU, jax 0.9, in
#: tests/test_torch_paper_leftovers.py; ROADMAP §3); the same at the 40
#: scenarios of pca_grid_sharded (phase 11 (a);
#: tests/test_torch_sharding.py)
REFERENCE_HOST_VALUES = {("pca_paper_scale", "coded", "mean_total_time"): 3.1569299381795615,
                         ("pca_grid_sharded", "coded", "mean_total_time"): 3.7930601062032934}


def same_value(a, b) -> bool:
    """Equal, NaN equal to NaN (a ratio over a method that missed the gap)."""
    return a == b or (isinstance(a, float) and isinstance(b, float) and np.isnan(a)
                      and np.isnan(b))


def payload_mismatches(label: str, mine: dict, theirs: dict, atol: float) -> list[str]:
    """The fields of a written ``convergence_payload`` (read back from its
    JSON) that differ from the committed one: ``grid``, ``gap``, the ordering
    and every method field exact (:data:`REFERENCE_HOST_VALUES` where it
    names one), ``mean_final_gap`` within rtol 1e-4 (+ ``atol``); wall
    clocks skipped."""
    bad = [k for k in ("grid", "gap") if mine[k] != theirs[k]]
    bad += [f"ordering/{k}" for k, v in theirs["ordering"].items()
            if not same_value(mine["ordering"].get(k), v)]
    if set(mine["methods"]) != set(theirs["methods"]):
        bad.append("methods")
    for m, v in theirs["methods"].items():
        got = mine["methods"].get(m, {})
        for f in ("median_time_to_gap", "mean_total_time", "mean_fresh", "w", "load_balance"):
            if not same_value(got.get(f), REFERENCE_HOST_VALUES.get((label, m, f), v[f])):
                bad.append(f"{m}/{f}")
        if not np.isclose(got.get("mean_final_gap", np.nan), v["mean_final_gap"], rtol=1e-4,
                          atol=atol):
            bad.append(f"{m}/mean_final_gap")
    return bad


def live_rest_opts(arch: str, engine, steps: int = 80, **fields):
    """The paper-scale live job of :func:`paper_live_opts` (dsag) with
    ``TrainConfig`` fields replaced."""
    import dataclasses

    opts = paper_live_opts(arch, "dsag", engine, steps=steps)
    return dataclasses.replace(opts, train_config=dataclasses.replace(opts.train_config,
                                                                      **fields))


def run_paper_rest(torch, outcomes: dict) -> dict:
    """Phase 10: the paper path's leftovers and the live trainer's rest."""
    import dataclasses
    import tempfile

    from repro_torch import convergence_sweep
    from repro_torch.examples import logreg_higgs, pca_genomics
    from repro_torch.experiments.convergence import result_mismatches
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.results import (
        convergence_payload,
        write_bench_convergence,
        write_json,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import Trainer, TrainerOptions
    from repro_torch.lb.optimizer import what_if_normals
    from repro_torch.optim.compression import Quantized

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    committed = json.loads((ROOT / "BENCH_convergence.json").read_text())
    counts = dict.fromkeys(launch_counts(), 0)

    def add(now: dict) -> dict:
        for k, v in now.items():
            counts[k] += v
        return now

    # (a) the BENCH_convergence.json payload of phase 4's runs
    t0 = time.perf_counter()
    out, gap = outcomes["grid"]
    pca_out, pca_gap = outcomes["pca_paper_scale"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "BENCH_convergence.json"
        write_bench_convergence(out, str(path), gap=gap)
        written = json.loads(path.read_text())
        # the paper-scale column nests its own payload (as in the committed file)
        write_json(convergence_payload(pca_out, pca_gap), str(path))
        pca = json.loads(path.read_text())
    for label, mine, theirs, atol in (("grid", written, committed, 0.0),
                                      ("pca_paper_scale", pca, committed["pca_paper_scale"],
                                       1e-6)):
        bad = payload_mismatches(label, mine, theirs, atol)
        if bad:
            fail(f"phase 10 (a): the {label} payload differs from the committed one in {bad}")
        fg = {m: (v["mean_final_gap"], theirs["methods"][m]["mean_final_gap"])
              for m, v in mine["methods"].items()}
        print(f"  (a) {label}: convergence_payload equals the committed BENCH_convergence.json "
              f"in grid, gap, ordering and every method's median_time_to_gap, "
              f"mean_total_time, mean_fresh, w, load_balance; mean_final_gap (port, "
              f"committed) {fg} within rtol 1e-4 + atol {atol}; wall clocks "
              f"{WALL_CLOCK_KEYS} not compared")
        for (lab, m, f), v in REFERENCE_HOST_VALUES.items():
            if lab == label:
                print(f"    {m}/{f}: port {mine['methods'][m][f]!r} == the reference host "
                      f"engine's {v!r}; committed (its fused engine) "
                      f"{theirs['methods'][m][f]!r}")
    print(f"    (a) took {time.perf_counter() - t0:.2f} s")

    # (b) the draws: the reference's at every key; the CLI's --load-balance at
    # its default 40 workers (a key the package never shipped), device == host,
    # at 200 iterations (the default 40 end near 0.12 simulated s, before the
    # balancer's first call at 0.5 s)
    t0 = time.perf_counter()
    with np.load(ROOT / "src/repro_torch/lb/what_if_normals.npz") as z:
        for name in z.files:
            N = int(name.split("_N")[1].split("_")[0])
            if not np.array_equal(what_if_normals(0, N).numpy(), z[name]):
                fail(f"phase 10 (b): the what-if draws of {name} are not the reference's")
    runs = {}
    reset_launch_counts()
    for kind in ("scan", "host"):
        runs[kind], _, _ = convergence_sweep.run(["--load-balance", "--engine", kind,
                                                  "--iters", str(CLI_LB_ITERS)])
    n_b = add(launch_counts())
    for m in runs["scan"].results:
        bad = result_mismatches(runs["scan"].results[m], runs["host"].results[m])
        if bad:
            fail(f"phase 10 (b): --load-balance --workers 40, {m}: device and host differ in "
                 f"{bad}")
    if n_b["what_if_replay"] == 0 or n_b["logreg_block_sub"] == 0:
        fail(f"phase 10 (b): the --load-balance run missed K1 or K7: {n_b}")
    reps = [len(e) for e in runs["scan"].results["dsag"].repartition_events]
    if min(reps) == 0:
        fail(f"phase 10 (b): a scenario ran no Algorithm-1 publication: {reps}")
    print(f"  (b) the what-if draws equal the shipped reference draws (seed 0, N = 100, 50); "
          f"convergence_sweep --load-balance --iters {CLI_LB_ITERS} (40 workers, threefry "
          f"draws): device == host bit "
          f"for bit for {len(runs['scan'].results)} methods, dsag repartitions per scenario "
          f"{reps}; launches {n_b['logreg_block_sub']} logreg_block_sub, "
          f"{n_b['what_if_replay']} what_if_replay, {n_b['grid_cache_update']} "
          f"grid_cache_update; {time.perf_counter() - t0:.2f} s")

    # (c) Fig. 8 at the reference's full recipe
    for label, mod, kernel in (("logreg_higgs (4 x 1200 iterations)", logreg_higgs,
                                "logreg_block_sub"),
                               ("pca_genomics (120/120/400/400/400 iterations)", pca_genomics,
                                "pca_block_sub")):
        reset_launch_counts()
        t0 = time.perf_counter()
        ttg = mod.main(engine=card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_c = add(launch_counts())
        if n_c[kernel] == 0 or (mod is logreg_higgs and n_c["what_if_replay"] == 0):
            fail(f"phase 10 (c): {label} missed its kernels: {n_c}")
        if not all(np.isfinite(t) for t in ttg.values()):
            fail(f"phase 10 (c): {label} did not reach the gap: {ttg}")
        print(f"  (c) {label} on the card: {wall:.2f} s host wall clock; time to gap (sim s) "
              f"{ttg}; launches {n_c[kernel]} {kernel}, {n_c['what_if_replay']} "
              f"what_if_replay; no cut")

    # (d) the live trainer's rest
    rest = (
        ("TrainerOptions() default (adamw, bf16 slots, live-sampled stragglers)",
         TrainerOptions(engine=card, log_every=10**6), None),
        ("logreg paper scale, adafactor", live_rest_opts("logreg", card, optimizer="adafactor",
                                                          learning_rate=0.05), "logreg"),
        ("logreg paper scale, int8 slots", live_rest_opts("logreg", card,
                                                          dsag_cache_dtype="int8"), "logreg"),
        ("pca paper scale, int8 slots", live_rest_opts("pca", card, dsag_cache_dtype="int8"),
         "pca"),
    )
    for label, opts, job in rest:
        reset_launch_counts()
        trainer, hist, wall = timed_run(torch, opts)
        n_d = add(launch_counts())
        int8 = opts.train_config.dsag_cache_dtype == "int8"
        k4 = "dsag_cache_update_int8" if int8 else "dsag_cache_update"
        if n_d[k4] != len(hist["loss"]) or not np.isfinite(hist["loss"]).all():
            fail(f"phase 10 (d): {label}: {n_d[k4]} {k4} launches in {len(hist['loss'])} "
                 f"steps, losses finite: {np.isfinite(hist['loss']).all()}")
        if int8 and not isinstance(trainer.state["dsag"]["cache"], Quantized):
            fail(f"phase 10 (d): {label}: the cache is not int8")
        note = ""
        if job is not None:
            # the Tier-2 streams do not depend on the iterate: the reference's
            # float32 run's counts and virtual time (phase 5's table)
            _g, virt_ref, *_, fresh_ref, flush_ref = PAPER_LIVE[job, "dsag"]
            fresh, flush = int(np.sum(hist["mask_stream"])), int(np.sum(hist["flush_stream"]))
            if (fresh, flush) != (fresh_ref, flush_ref) or hist["virtual"][-1] != virt_ref:
                fail(f"phase 10 (d): {label}: fresh/flush {fresh}/{flush}, virtual "
                     f"{hist['virtual'][-1]!r} vs {fresh_ref}/{flush_ref}, {virt_ref!r}")
            note = (f"fresh/flush {fresh}/{flush} and virtual time equal the reference's; "
                    f"final gap {hist['eval'][-1][3]:.6g}; ")
        print(f"  (d) {label}: {len(hist['loss'])} steps, loss {hist['loss'][0]:.6g} -> "
              f"{hist['loss'][-1]:.6g}; {note}{wall:.3f} s host, "
              f"{wall / len(hist['loss']) * 1e3:.3f} ms/step; launches {k4} {n_d[k4]}, "
              f"logreg_block_sub {n_d['logreg_block_sub']}, gram_matvec {n_d['gram_matvec']}")

    # (e) checkpoints: an int8 live run saved every 20 steps, the latest
    # restored equal to the saved tensors, then 20 more steps
    with tempfile.TemporaryDirectory() as ckpt:
        opts = dataclasses.replace(
            live_rest_opts("logreg", card, steps=60, dsag_cache_dtype="int8",
                           checkpoint_every=20), checkpoint_dir=ckpt)
        reset_launch_counts()
        trainer, hist, wall = timed_run(torch, opts)
        saved = trainer.state
        restored, step = trainer.ckpt.restore_latest(trainer.init_state())
        pairs = [("params", restored["params"], saved["params"]),
                 ("opt/mu", restored["opt"]["mu"], saved["opt"]["mu"]),
                 ("h", restored["dsag"]["h"], saved["dsag"]["h"])]
        for slot in ("cache", "pending"):
            pairs += [(f"{slot}/q", restored["dsag"][slot].q, saved["dsag"][slot].q),
                      (f"{slot}/scale", restored["dsag"][slot].scale, saved["dsag"][slot].scale)]
        for name, a, b in pairs:
            if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
                fail(f"phase 10 (e): the restored {name} differs from the saved one")
        _, more, wall_more = timed_run(torch, dataclasses.replace(opts, steps=80, restore=True))
        n_e = add(launch_counts())
        kept = sorted(p.name for p in Path(ckpt).iterdir())
        if step != 59 or len(more["loss"]) != 20 or not np.isfinite(more["loss"]).all():
            fail(f"phase 10 (e): restored step {step}, {len(more['loss'])} more steps")
        print(f"  (e) checkpoints: int8 logreg paper-scale run saved every 20 steps "
              f"({wall:.2f} s host), step {step} restored torch.equal to the saved state "
              f"(int8 q, bf16 scales, params, momentum, H), 20 more steps "
              f"({wall_more:.2f} s host; loss {more['loss'][-1]:.6g}); kept {kept}; launches "
              f"dsag_cache_update_int8 {n_e['dsag_cache_update_int8']}")
    return counts


#: phase 11 (a): shards on one card, for the committed pca_grid_sharded
#: column's num_devices
SHARDS_ON_ONE_CARD = 4
#: the suboptimality tolerance of a PCA run against the reference (float32
#: sums in another order): rtol, atol
PCA_SUBOPT_TOL = (1e-4, 1e-6)
#: phase 11 (a): the evaluations of the reference's dsag run at
#: pca_grid_sharded (its fused engine, 40 scenarios; (scenario, iteration,
#: suboptimality)) that lie within PCA_SUBOPT_TOL of the gap, 1e-4: there a
#: time to gap may fall on either side of the reference's, as
#: tests/test_torch_parity.py states (the card's float32 sums put scenario
#: 13 at iteration 32 at 1.0001e-4, the reference at 9.9993e-5).  Phase 11
#: (a) holds the port's values there within the tolerance of these, puts
#: these back, and then holds the column to the committed one exactly.
#: tests/test_torch_sharding.py derives the list from the reference.
REFERENCE_MARGINAL_EVALS = {
    ("pca_grid_sharded", "dsag"): ((13, 32, 9.99932163331199e-05),
                                   (18, 32, 0.00010089072892300887)),
}


def at_reference_crossings(label: str, outcome, gap: float):
    """``outcome`` with the reference's suboptimality put back at its
    evaluations within tolerance of the gap (:data:`REFERENCE_MARGINAL_EVALS`),
    once the port's own values there are held within that tolerance of
    them: ``(outcome, the evaluations whose side of the gap that moved)``."""
    import dataclasses

    results, moved = dict(outcome.results), []
    for (lab, m), evals in REFERENCE_MARGINAL_EVALS.items():
        if lab != label:
            continue
        sub = results[m].suboptimality.copy()
        for s, t, want in evals:
            got = float(sub[s, t])
            if not np.isclose(got, want, rtol=PCA_SUBOPT_TOL[0], atol=PCA_SUBOPT_TOL[1]):
                fail(f"{label}/{m}: scenario {s} iteration {t}: suboptimality {got!r} is not "
                     f"within {PCA_SUBOPT_TOL} of the reference's {want!r}")
            if (got <= gap) != (want <= gap):
                moved.append(f"{m} scenario {s} iteration {t}: port {got!r}, reference "
                              f"{want!r}")
            sub[s, t] = want
        results[m] = dataclasses.replace(results[m], suboptimality=sub)
    return dataclasses.replace(outcome, results=results), moved


def run_sharding(torch, outcomes: dict) -> dict:
    """Phase 11: scenario sharding of the device engine on the card."""
    import dataclasses
    import tempfile

    from repro_torch.experiments.convergence import (
        GRID_LB,
        result_mismatches,
        run_convergence_batch,
    )
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.fused import shard_rows
    from repro_torch.experiments.results import (
        convergence_payload,
        run_pca_grid_sharded_column,
        write_json,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import ScenarioMesh, make_scenario_mesh

    card = EngineConfig(device="cuda", kernel_backend="cuda", kind="scan")
    committed = json.loads((ROOT / "BENCH_convergence.json").read_text())["pca_grid_sharded"]
    n_cards = torch.cuda.device_count()
    one_card = ScenarioMesh((torch.device("cuda", 0),) * SHARDS_ON_ONE_CARD)
    counts = dict.fromkeys(launch_counts(), 0)

    def add_counts() -> dict:
        now = launch_counts()
        for k, v in now.items():
            counts[k] += v
        return now

    def same(label: str, a, b) -> None:
        bad = result_mismatches(a, b)
        if bad:
            fail(f"phase 11 {label}: the sharded run differs from the unsharded one in {bad}")

    # (a) the committed pca_grid_sharded column: the cards torch sees (one
    # shard here), then four shards on cuda:0, the committed num_devices
    for label, engine, D, distinct in (
            ("(a) default", card, min(SHARDS_ON_ONE_CARD, n_cards), min(SHARDS_ON_ONE_CARD,
                                                                         n_cards)),
            ("(a) (cuda:0,) x 4", dataclasses.replace(card, mesh=one_card),
             SHARDS_ON_ONE_CARD, 1)):
        reset_launch_counts()
        t0 = time.perf_counter()
        run = run_pca_grid_sharded_column(engine=engine)
        wall = time.perf_counter() - t0
        n = add_counts()
        col = run.column
        if n["pca_block_sub"] == 0 or n["grid_cache_update"] == 0:
            fail(f"phase 11 {label}: the column ran without K2 or K3: {n}")
        if not col["bitexact_sharded_vs_unsharded"]:
            fail(f"phase 11 {label}: the sharded column is not bit-exact against the unsharded")
        if col["num_devices"] != D:
            fail(f"phase 11 {label}: {col['num_devices']} shards, expected {D}")
        held, moved = at_reference_crossings("pca_grid_sharded", run.sharded, col["gap"])
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "col.json"
            write_json(dict(col, **convergence_payload(held, col["gap"])), str(path))
            mine = json.loads(path.read_text())
            write_json(col, str(path))
            raw = json.loads(path.read_text())
        if set(raw) != set(committed):
            fail(f"phase 11 {label}: keys {sorted(raw)} differ from the committed column's")
        bad = payload_mismatches("pca_grid_sharded", mine, committed, PCA_SUBOPT_TOL[1])
        if bad:
            fail(f"phase 11 {label}: the column differs from the committed one in {bad}: "
                 f"methods {mine['methods']}, ordering {mine['ordering']}")
        med = {m: v["median_time_to_gap"] for m, v in mine["methods"].items()}
        raw_med = {m: v["median_time_to_gap"] for m, v in raw["methods"].items()}
        print(f"  {label}: pca_grid_sharded ({mine['grid']['n_scenarios']} scenarios x "
              f"{mine['grid']['n_workers']} workers x {mine['grid']['num_iterations']} "
              f"iterations, {mine['grid']['num_samples']} x 96, k = 3) on {D} shards over "
              f"{distinct} distinct card(s): bit-exact against the unsharded run; equal to the "
              f"committed column in grid, gap, ordering and every method's median_time_to_gap, "
              f"mean_total_time, mean_fresh, w, load_balance (coded mean_total_time == the "
              f"reference host engine's {REFERENCE_HOST_VALUES['pca_grid_sharded', 'coded', 'mean_total_time']!r}"
              f"), mean_final_gap within rtol 1e-4 + atol 1e-6; medians {med}")
        print(f"    at the reference's evaluations within {PCA_SUBOPT_TOL} of the gap "
              f"({REFERENCE_MARGINAL_EVALS['pca_grid_sharded', 'dsag']}): the port's values "
              f"within the tolerance; on the other side of the gap: {moved or 'none'}; the "
              f"port's own medians {raw_med}")
        print(f"    sharded_seconds {col['sharded_seconds']:.3f}, unsharded_seconds "
              f"{col['unsharded_seconds']:.3f}, device_scaling {col['device_scaling']:.3f} "
              f"({D} shards sharing {distinct} distinct card(s); committed, the reference on 4 "
              f"forced host devices: {committed['sharded_seconds']:.1f} / "
              f"{committed['unsharded_seconds']:.1f} s); {wall:.2f} s in all; launches "
              f"{n['pca_block_sub']} pca_block_sub, {n['grid_cache_update']} grid_cache_update")

    # (b) a one-card make_scenario_mesh(1) on the grid recipe's four methods,
    # against phase 4's unsharded runs
    out, _ = outcomes["grid"]
    mesh1 = make_scenario_mesh(1)
    reset_launch_counts()
    t0 = time.perf_counter()
    for m, cfg in out.methods.items():
        r = run_convergence_batch(out.problem, out.traces, cfg, out.num_iterations,
                                  eval_every=out.eval_every, seed=out.seed,
                                  engine=dataclasses.replace(card, mesh=mesh1))
        same(f"(b) grid/{m}", r, out.results[m])
    wall = time.perf_counter() - t0
    n = add_counts()
    if n["logreg_block_sub"] == 0 or n["grid_cache_update"] == 0:
        fail(f"phase 11 (b): the grid recipe ran without K1 or K3: {n}")
    print(f"  (b) make_scenario_mesh(1) {mesh1.devices}: the grid recipe's "
          f"{', '.join(out.methods)} == phase 4's unsharded runs bit for bit; {wall:.2f} s "
          f"(phase 4: {out.engine_seconds:.2f} s); launches {n['logreg_block_sub']} "
          f"logreg_block_sub, {n['grid_cache_update']} grid_cache_update")

    # (c) §6 under churn over four shards of cuda:0: phase 9 (a)'s churned
    # traces, dsag with the balancer on the lb_scan recipe's schedule
    run = outcomes["churn"]
    rec = run.column["recipe"]
    T, S = rec["num_iterations"], run.traces.num_scenarios
    dsag_lb = dataclasses.replace(run.methods["dsag"], load_balance=True, **GRID_LB)
    reset_launch_counts()
    t0 = time.perf_counter()
    plain, sharded = (run_convergence_batch(
        run.problem, run.traces, dsag_lb, T, eval_every=rec["eval_every"], seed=rec["seed"],
        engine=dataclasses.replace(card, mesh=mesh)) for mesh in (None, one_card))
    wall = time.perf_counter() - t0
    n = add_counts()
    same("(c) dsag + §6 under churn", sharded, plain)
    if n["logreg_block_sub"] == 0 or n["what_if_replay"] == 0:
        fail(f"phase 11 (c): §6 under churn ran without K1 or K7: {n}")
    pubs = [sum(len(sharded.repartition_events[s]) for s in set(rows.tolist()))
            for rows in shard_rows(S, one_card.size)]
    if min(pubs) == 0:
        fail(f"phase 11 (c): a shard published nothing: {pubs}")
    print(f"  (c) §6 under churn ({rec['n_workers']} workers x {S} scenarios x {T} "
          f"iterations, the churn column's schedule, start {GRID_LB['lb_startup_delay']} s, "
          f"every {GRID_LB['lb_interval']} s) on (cuda:0,) x 4 (pad {(-S) % one_card.size}): "
          f"== the unsharded device run bit for bit, publication times included; publications "
          f"per shard {pubs}; {wall:.2f} s for both runs; launches {n['logreg_block_sub']} "
          f"logreg_block_sub, {n['what_if_replay']} what_if_replay")

    # (d) the churn column's dsag, sag and coded over four shards of cuda:0,
    # against phase 9 (a)'s device runs
    reset_launch_counts()
    t0 = time.perf_counter()
    for m, res in run.runs.items():
        r = run_convergence_batch(run.problem, run.traces, run.methods[m], T,
                                  eval_every=rec["eval_every"], seed=rec["seed"],
                                  engine=dataclasses.replace(card, mesh=one_card))
        same(f"(d) churn/{m}", r, res["scan"])
    wall = time.perf_counter() - t0
    n = add_counts()
    if n["logreg_block_sub"] == 0 or n["grid_cache_update"] == 0:
        fail(f"phase 11 (d): the churn column ran without K1 or K3: {n}")
    print(f"  (d) the churn column's {', '.join(run.runs)} on (cuda:0,) x 4 == phase 9 (a)'s "
          f"device runs bit for bit; {wall:.2f} s (phase 9 (a), device: "
          f"{sum(v['scan'] for v in run.seconds.values()):.2f} s); launches "
          f"{n['logreg_block_sub']} logreg_block_sub, {n['grid_cache_update']} grid_cache_update")

    # (e) more cards than visible: refused before any launch
    reset_launch_counts()
    for attempt in (lambda: make_scenario_mesh(n_cards + 1),
                    lambda: run_convergence_batch(
                        out.problem, out.traces, out.methods["dsag"], out.num_iterations,
                        engine=dataclasses.replace(card, num_devices=n_cards + 1))):
        try:
            attempt()
        except ValueError as err:
            msg = str(err)
        else:
            fail(f"phase 11 (e): {n_cards + 1} cards of {n_cards} were not refused")
    n = add_counts()
    if any(n.values()):
        fail(f"phase 11 (e): the refusal came after a launch: {n}")
    print(f"  (e) make_scenario_mesh({n_cards + 1}) and EngineConfig(num_devices="
          f"{n_cards + 1}) refused before any launch: {msg}")
    reset_launch_counts()
    return counts


def logit_diff(torch, got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, ||got - want|| / ||want||), float32."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("non-finite logits")
    d = got - want
    return float(d.abs().max() / want.abs().max()), float(d.norm() / want.norm())


def decode_step_f32_scores(cfg, params, x, cache, index: int, use_rope: bool = True):
    """``models.attention.gqa_decode_step`` with its scores and probabilities
    kept in float32, as K6's prefill keeps them: K6's plain version over the
    cache's first ``index + 1`` positions."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import _project_qkv, _repeat_kv
    from repro_torch.models.layers import apply_rope

    q, k_new, v_new = _project_qkv(cfg, params, x)
    if use_rope:
        pos = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
        q, k_new = apply_rope(q, pos, cfg.rope_theta), apply_rope(k_new, pos, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, index:index + 1] = k_new.to(k.dtype)
    v[:, index:index + 1] = v_new.to(v.dtype)
    groups = q.shape[2] // k.shape[2]
    kk, vv = (_repeat_kv(t[:, :index + 1], groups).transpose(1, 2) for t in (k, v))
    out = flash_attention_plain(q.transpose(1, 2), kk, vv).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype)), cache


def attend_f32_scores(q, k, v, *, causal: bool, q_offset: int = 0, scale=None,
                      backend: str = "torch"):
    """``models.attention._attend`` with its scores and probabilities kept in
    float32, as K6 keeps them: K6's plain version over the repeated kv heads
    (prefill and cross-attention calls: q_offset 0, the default scale), the
    output cast to q's dtype."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import _repeat_kv

    if q_offset or scale is not None:
        raise ValueError("the float32-score witness takes prefill calls only")
    g = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, _repeat_kv(k, g), _repeat_kv(v, g)))
    return flash_attention_plain(qh, kh, vh, causal=causal).transpose(1, 2).to(q.dtype)


def serving_prompts(vocab: int):
    return np.random.default_rng(0).integers(0, vocab, (SERVE_B, SERVE_PROMPT))


def run_serving(torch) -> tuple:
    """Phase 6: serve qwen1.5-0.5b at full width and depth through K6;
    returns the phase's numbers and the server (phase 12 counts its work)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.layers import apply_norm, apply_rope, tree_map
    from repro_torch.models.transformer import embed_inputs, layer_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    max_len = SERVE_PROMPT + SERVE_TOKENS + 8
    srv = Server("qwen1.5-0.5b", smoke=False, max_len=max_len, device="cuda", seed=0)
    cfg, params, L = srv.cfg, srv.params, srv.cfg.num_layers
    prompts = serving_prompts(cfg.vocab_size)
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads x "
          f"{cfg.resolved_head_dim}, {srv.model.num_params() / 1e6:.1f} M params "
          f"(bf16, seed 0); batch {SERVE_B} x prompt {SERVE_PROMPT}, {SERVE_TOKENS} tokens, "
          f"cache {max_len}")
    srv.generate({"tokens": prompts[:, :128]}, 2)  # warm the libraries (not counted)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks = srv.generate({"tokens": prompts}, SERVE_TOKENS)
    counts = launch_counts()
    t = srv.timings
    if counts["flash_attention"] != L:
        fail(f"serving: {counts['flash_attention']} flash_attention launches for one "
             f"prefill, expected {L}")
    vocab_padded = params["embed"]["tok"].shape[0]
    if toks.shape != (SERVE_B, SERVE_TOKENS) or not bool(((toks >= 0) & (toks < vocab_padded)).all()):
        fail(f"serving: generated tokens of shape {tuple(toks.shape)} outside [0, {vocab_padded})")
    decode_ms = t["decode"] / (SERVE_TOKENS - 1) * 1e3
    tok_s = SERVE_B * SERVE_TOKENS / (t["prefill"] + t["decode"])
    print(f"  generate through K6 ({smi}): prefill {t['prefill']:.4f} s "
          f"({SERVE_B * SERVE_PROMPT / t['prefill']:.0f} prompt tok/s), decode "
          f"{decode_ms:.3f} ms/token step ({SERVE_B / decode_ms * 1e3:.0f} tok/s), "
          f"{tok_s:.1f} generated tok/s end to end; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    out = {"launches": counts["flash_attention"], "prefill_s": t["prefill"],
           "decode_ms_per_token": decode_ms, "tokens_per_s": tok_s}
    k6_prefills = 1

    with torch.inference_mode():
        # three runs over the same weights, teacher-forced with the plain run's
        # tokens: bf16 through K6, bf16 through full_attention, and the float32
        # model through full_attention as the yardstick of both
        tokens = torch.as_tensor(prompts, device="cuda")
        batch = {"tokens": tokens}
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda a: a.float(), params)
        runs = {"k6": (srv.model, params),
                "plain": (build_model(cfg, kernel_backend="torch"), params),
                "f32": (build_model(cfg32, kernel_backend="torch"), p32)}
        logits, caches, prefill_s = {}, {}, {}
        for name, (model, p) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches[name] = model.prefill(p, batch, max_len)
            torch.cuda.synchronize()
            prefill_s[name] = time.perf_counter() - t0
            logits[name] = [lg[:, -1]]
        k6_prefills += 1
        tok = logits["plain"][0].argmax(-1)[:, None]
        for step in range(SERVE_TOKENS - 1):
            for name, (model, p) in runs.items():
                lg, caches[name] = model.decode_step(p, tok, caches[name], SERVE_PROMPT + step)
                logits[name].append(lg[:, -1])
            tok = logits["plain"][-1].argmax(-1)[:, None]
        rms = {pair: [logit_diff(torch, a, b)[1] for a, b in zip(logits[pair[0]], logits[pair[1]])]
               for pair in (("k6", "plain"), ("k6", "f32"), ("plain", "f32"))}
        agree = float(np.mean([float((a.argmax(-1) == b.argmax(-1)).float().mean())
                               for a, b in zip(logits["k6"], logits["plain"])]))
        tol = SERVE_TOL["k6_vs_plain"]
        worst = max(rms["k6", "plain"])
        err_k6, err_plain = float(np.mean(rms["k6", "f32"])), float(np.mean(rms["plain", "f32"]))
        print(f"  prefill + {SERVE_TOKENS - 1} teacher-forced steps (prefill s: K6 "
              f"{prefill_s['k6']:.4f}, plain {prefill_s['plain']:.4f}, float32 plain "
              f"{prefill_s['f32']:.4f}): rel RMS of logits K6 vs plain worst {worst:.4f} "
              f"(tolerance {tol}); against the float32 run, mean K6 {err_k6:.4f} and plain "
              f"{err_plain:.4f} (K6 must be no further); greedy tokens K6 vs plain agree "
              f"{agree:.3f} of {SERVE_B * SERVE_TOKENS}")
        if worst > tol:
            fail(f"serving: K6 and plain runs differ by rel RMS {worst} (tolerance {tol})")
        if err_k6 > err_plain:
            fail(f"serving: the K6 run is further from the float32 run ({err_k6}) than "
                 f"the plain run ({err_plain})")
        out.update(k6_vs_plain_rel_rms=worst, k6_vs_f32_rel_rms=err_k6,
                   plain_vs_f32_rel_rms=err_plain, greedy_agree=agree,
                   plain_prefill_s=prefill_s["plain"])
        del caches

        # the float32 model through K6 against the float32 model through full_attention
        k6_32 = build_model(cfg32, kernel_backend="cuda")
        lg, cache = k6_32.prefill(p32, batch, max_len)
        del cache
        k6_prefills += 1
        lg_f32k6 = lg[:, -1]
        d32 = logit_diff(torch, lg_f32k6, logits["f32"][0])
        print(f"  float32 model through K6 vs through full_attention: prefill logits "
              f"max|diff|/max {d32[0]:.3e}, rel RMS {d32[1]:.3e} (tolerance {SERVE_F32_TOL})")
        if max(d32) > SERVE_F32_TOL:
            fail(f"serving: float32 K6 and plain prefills differ by {d32}")
        out.update(f32_max_rel=d32[0], f32_rel_rms=d32[1])

        # decode of token s from an (s-1)-token cache against the s-token prefill:
        # bf16 through K6, bf16 with no kernel (prefill and decode attention
        # alike), and float32 through K6
        cases = (("bf16 K6", srv.model, params, logits["k6"][0], SERVE_TOL["decode_vs_prefill"]),
                 ("bf16 plain", runs["plain"][0], params, logits["plain"][0], None),
                 ("float32 K6", k6_32, p32, lg_f32k6, SERVE_F32_TOL))
        for label, model, p, want, tol in cases:
            _, cache_m1 = model.prefill(p, {"tokens": tokens[:, :-1]}, max_len)
            k6_prefills += model.kernel_backend == "cuda"
            lg_d, _ = model.decode_step(p, tokens[:, -1:], cache_m1, SERVE_PROMPT - 1)
            del cache_m1
            dp = logit_diff(torch, lg_d[:, -1], want)[1]
            print(f"  {label}: decode of token {SERVE_PROMPT} from a {SERVE_PROMPT - 1}-token "
                  f"cache vs the {SERVE_PROMPT}-token prefill: rel RMS {dp:.3e} "
                  f"(tolerance {tol if tol is not None else 'none: printed beside K6'})")
            if tol is not None and dp > tol:
                fail(f"serving: {label} decode-vs-prefill logits differ by rel RMS {dp} "
                     f"(tolerance {tol})")
            out[f"decode_vs_prefill_rel_rms_{label.replace(' ', '_')}"] = dp
        # the witness of the bf16 K6 gap: the same decode from the K6 cache with
        # its scores kept in float32 (K6's plain version over the cache)
        _, cache_m1 = srv.model.prefill(params, {"tokens": tokens[:, :-1]}, max_len)
        k6_prefills += 1
        with mock.patch.object(attn, "gqa_decode_step", decode_step_f32_scores):
            lg_d, _ = srv.model.decode_step(params, tokens[:, -1:], cache_m1, SERVE_PROMPT - 1)
        del cache_m1
        dp = logit_diff(torch, lg_d[:, -1], logits["k6"][0])[1]
        print(f"  bf16 K6, decode with float32 scores (witness): decode vs prefill rel RMS "
              f"{dp:.3e} (none: printed beside the bf16 K6 and plain rows)")
        out["decode_vs_prefill_rel_rms_bf16_K6_f32_scores"] = dp
        del logits
    total = launch_counts()["flash_attention"]
    if total != L * k6_prefills:
        fail(f"serving: {total} flash_attention launches for {k6_prefills} prefills")
    print(f"  flash_attention launches in phase 6: {total} = {L} x {k6_prefills} prefills")
    with torch.inference_mode():
        # K6 on layer 0's real activations (scores of a few hundred at this init)
        lp = layer_params(params["blocks"], 0)
        h = apply_norm(cfg, lp["ln1"], embed_inputs(cfg, params, tokens))
        q, k, v = attn._project_qkv(cfg, lp["attn"], h)
        pos = torch.arange(SERVE_PROMPT, device="cuda").expand(SERVE_B, SERVE_PROMPT)
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
        got = k6.flash_attention_bshd(q, k, v)
        want32 = k6.flash_attention_plain(*(x.float().transpose(1, 2) for x in (q, k, v)))
        if not k6_within_tolerance(torch, got, want32.transpose(1, 2)):
            fail("flash_attention on layer 0's activations disagrees with its plain version")
        print(f"  K6 on layer 0's q, k, v (|q| <= {float(q.abs().max()):.1f}): within "
              f"tolerance of its plain version, max |diff| "
              f"{float((got.float() - want32.transpose(1, 2)).abs().max()):.3e}")

    return out, srv


def run_analysis(torch, per_kernel: dict, serving: dict, srv) -> dict:
    """Phase 12: the analysis layer on the card: (a) the lint over every
    entry on cuda:0, (b) each phase-3 row's cost model and bound, (c) the
    serving roofline of phase 6's cell."""
    from repro_torch.analysis import roofline
    from repro_torch.analysis.cost import count_cost
    from repro_torch.analysis.lint import run_lint
    from repro_torch.configs.base import ShapeConfig

    t0 = time.perf_counter()
    report = run_lint("all", device="cuda:0")
    for line in report.render_text().splitlines():
        print(f"  (a) {line}")
    if report.findings:
        fail(f"phase 12 (a): {len(report.findings)} lint finding(s) not in the baseline")
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")

    for name, rows in per_kernel.items():
        for r in rows:
            bound = r["bound_ms"]
            dev = "not measured" if r["device_ms"] is None else f"{r['device_ms'] / bound:.1f}x"
            print(f"  (b) {name} [{r['call']}]: {r['bytes']:.6g} B, {r['flops']:.6g} FLOP at "
                  f"{r['peak'] / 1e12:g} TFLOP/s -> bound {bound:.6g} ms ({r['bound_by']}); "
                  f"kernel {r['ms'] / bound:.1f}x the bound, device {dev}")

    t0 = time.perf_counter()
    cfg, params, model = srv.cfg, srv.params, srv.model
    L, b, s = cfg.num_layers, SERVE_B, SERVE_PROMPT
    held = {}
    with torch.inference_mode():
        tokens = torch.as_tensor(serving_prompts(cfg.vocab_size), device="cuda")
        max_len = SERVE_PROMPT + SERVE_TOKENS + 8
        prefill = count_cost(lambda: held.update(
            out=model.prefill(params, {"tokens": tokens}, max_len)))
        logits, cache = held.pop("out")
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        decode = count_cost(lambda: held.update(
            out=model.decode_step(params, tok, cache, SERVE_PROMPT)))
        del cache, held["out"]
    k6 = prefill.rows.get("flash_attention")
    if k6 is None or k6.calls != L:
        fail(f"phase 12 (c): the prefill's count holds no K6 row of {L} launches: "
             f"{None if k6 is None else k6.calls}")
    attn = params["blocks"]["attn"]
    h, kvh, hd = attn["wq"].shape[2], attn["wk"].shape[2], cfg.resolved_head_dim
    k6_flops = L * roofline.flash_attention_cost(b, h, kvh, s, s, hd, True, torch.bfloat16)[1]
    gemm = roofline.serving_gemm_flops(cfg, params, b * s, b)
    counted = prefill.flops_of("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")
    if counted != gemm or k6.flops != k6_flops:
        fail(f"phase 12 (c): counted prefill product FLOPs {counted:.6g} (K6 {k6.flops:.6g}) "
             f"differ from the analytic {gemm:.6g} (K6 {k6_flops:.6g})")
    num_params = model.num_params()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {}
    for label, cost, shape, measured, n_tok in (
            ("prefill", prefill, ShapeConfig("prefill", s, b, "prefill"), serving["prefill_s"],
             b * s),
            ("decode", decode, ShapeConfig("decode", s + SERVE_TOKENS, b, "decode"),
             serving["decode_ms_per_token"] / 1e3, b)):
        # the mfu's N: the parameters the step multiplies a token by (the
        # prefill unembeds one row per sequence, the embedding lookup is no
        # product); the reference's N, all parameters, is printed beside it
        n_prod = roofline.serving_gemm_flops(cfg, params, n_tok, b) / (2 * n_tok)
        ideal = roofline.derive(cfg, shape, n_prod, cost)
        rf = roofline.derive(cfg, shape, n_prod, cost, step_time_s=measured)
        all_params = roofline.derive(cfg, shape, num_params, cost, step_time_s=measured)
        row = dict(rf.as_dict(), product_params=n_prod, roofline_mfu=ideal.mfu,
                   memory_share=rf.memory_s / measured, num_params=num_params,
                   mfu_num_params=all_params.mfu)
        out[label] = row
        print(f"  (c) {label} ({smi}): counted {cost.flops:.6g} FLOP, {cost.bytes:.6g} B; "
              f"compute {rf.compute_s * 1e3:.4f} ms, memory {rf.memory_s * 1e3:.4f} ms, "
              f"collective 0 (one card): {rf.dominant}-bound; model FLOPs "
              f"{rf.model_flops_per_device:.6g} (useful {rf.useful_flops_fraction:.4f}); "
              f"measured {measured * 1e3:.3f} ms (phase 6): mfu {rf.mfu:.5f} (N = "
              f"{n_prod / 1e6:.4f} M product params; the reference's N = all "
              f"{num_params / 1e6:.1f} M params gives {all_params.mfu:.5f}), memory term "
              f"{row['memory_share']:.4f} of the step; at the roofline mfu {ideal.mfu:.4f}")
        for kind in ("flops", "bytes"):
            top = ", ".join(f"{n} x{c} {v:.4g}" for v, n, c in cost.top_costs(4)[kind])
            print(f"      top {kind}: {top}")
    print(f"  (c) prefill products: counted {counted:.6g} FLOP = analytic 2 x layer and "
          f"unembedding parameters x tokens; K6 {L} launches, {k6.flops:.6g} FLOP = its "
          f"causal-pairs model; took {time.perf_counter() - t0:.1f} s")
    return out


#: phase 13 (a): the full-width training cell: steps, global batch and sequence
#: length (the reference trainer's default shape), over P = 4 DSAG groups
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 128
#: phase 13 (c): steps of the smoke config in float32, card against CPU, and
#: the losses' tolerance: sgd (no per-element normalization to amplify a
#: float32 rounding), float32 products summed in another order
TRAIN_CHECK_STEPS, TRAIN_CHECK_RTOL = 20, 1e-5


def state_to(torch, tree, dev):
    """A train state (nested dicts of tensors) copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: state_to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


def run_training(torch) -> tuple[dict, dict, dict]:
    """Phase 13: the model zoo's DSAG training path.  Returns the phase's
    numbers, its K4 launches and K4's row at the full-width shape."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.kernels import dsag_update as k4
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet
    from repro_torch.launch.train import Trainer, TrainerOptions

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = EngineConfig(device="cuda", kernel_backend="cuda")
    out: dict = {}

    # (a) full width and depth, adamw, bf16 slots, remat "full" (TrainConfig()),
    # live-sampled stragglers; K4's inputs of the second step kept for (b)
    trn = Trainer(TrainerOptions(arch="qwen1.5-0.5b", smoke=False, steps=TRAIN_STEPS,
                                 global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 train_config=TrainConfig(), log_every=10**6, engine=card))
    cfg, n_params = trn.cfg, trn.model.num_params()
    P, n = trn.gs.num_groups, trn.layout.numel
    print(f"  (a) {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M parameters ({cfg.dtype}; flat n = {n}), P = {P}, global "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, adamw, {trn.opts.train_config.dsag_cache_dtype} "
          f"slots, remat {trn.opts.train_config.remat}, {TRAIN_STEPS} steps")
    wrapper, k4_inputs = k4.dsag_cache_update, []

    def keep_second(g, c, h, mask):
        if len(k4_inputs) < 2:
            k4_inputs.append(tuple(t.clone() for t in (g, c, h, mask)))
        return wrapper(g, c, h, mask)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(k4, "dsag_cache_update", keep_second):
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = trn.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"phase 13 (a): losses {losses}")
    if counts["dsag_cache_update"] != TRAIN_STEPS:
        fail(f"phase 13 (a): {counts['dsag_cache_update']} K4 launches in {TRAIN_STEPS} steps")
    host_ms = float(np.mean(hist["step_time"][2:])) * 1e3
    # the step synchronized, three more steps from the trained state
    batch = trn.batch_on_device(next(trn.data))
    bits = torch.tensor([[True] * P, [False] * P, [False] * P], device="cuda")
    holder = [trn.state]

    def one_step():
        holder[0], _ = trn.step_fn(holder[0], batch, *bits)

    step_ms = cuda_ms(torch, one_step, 2)
    shape = ShapeConfig("train_cell", TRAIN_SEQ, TRAIN_BATCH, "train")
    mflops = roofline.model_flops(cfg, shape, n_params, None)
    mfu = mflops / roofline.PEAK_BF16 / (step_ms / 1e3)
    print(f"  (a) {smi}: losses {', '.join(f'{x:.4f}' for x in losses)}; host "
          f"{host_ms:.1f} ms per step (steps 2-{TRAIN_STEPS - 1}, enqueue), {step_ms:.1f} ms per "
          f"step synchronized (2 steps after the run), run wall {wall:.2f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; K4 launches {counts['dsag_cache_update']} = steps; mfu "
          f"{mfu:.4f} (6·N·D = {mflops:.4g} FLOP per step, N = {n_params}, bf16 peak); "
          f"fresh groups per step {hist['mask_count']}")
    # (b) K4 at [P, n] bf16 on the run's second step's inputs (its first real
    # gradients against a filled cache), bit-equal to its plain twin
    row = check_dsag_update(torch, P, n, torch.bfloat16, None, inputs=k4_inputs[1],
                            plain_reps=2)
    del k4_inputs
    out.update(host_ms_per_step=host_ms, step_ms=step_ms, peak_bytes=peak, mfu=mfu,
               losses=losses, model_flops=mflops, num_params=n_params, flat_n=n)
    del trn, holder, batch, one_step
    torch.cuda.empty_cache()

    # (c) the smoke config in float32: the card (kernels) against the port on
    # the CPU (plain versions), 20 steps with replayed traces
    cl = make_heterogeneous_cluster(4, seed=3, burst_rate=0.0)
    traces = sample_fleet(cl, 1, 400, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    tc = TrainConfig(optimizer="sgd", learning_rate=1e-3, dsag_cache_dtype="float32")

    def check_trainer(engine):
        return Trainer(TrainerOptions(arch="qwen1.5-0.5b", dtype="float32",
                                      steps=TRAIN_CHECK_STEPS, global_batch=8, seq_len=64,
                                      traces=traces, scenario=0, simulate_stragglers=False,
                                      train_config=tc, log_every=10**6, engine=engine))

    on_cpu = check_trainer(EngineConfig(device="cpu", kernel_backend="torch"))
    state0 = on_cpu.init_state()
    reset_launch_counts()
    hp = on_cpu.run()
    n_cpu = launch_counts()["dsag_cache_update"]
    on_card = check_trainer(card)
    on_card.init_state = lambda: state_to(torch, state0, "cuda")
    reset_launch_counts()
    hc = on_card.run()
    n_card = launch_counts()["dsag_cache_update"]
    for f in ("mask_stream", "flush_stream", "evict_stream", "xi", "mask_count"):
        if not np.array_equal(np.asarray(hc[f]), np.asarray(hp[f])):
            fail(f"phase 13 (c): the card's {f} differs from the CPU's")
    rel = float(np.max(np.abs(np.asarray(hc["loss"]) / np.asarray(hp["loss"]) - 1)))
    if rel > TRAIN_CHECK_RTOL:
        fail(f"phase 13 (c): losses differ by rtol {rel} (tolerance {TRAIN_CHECK_RTOL})")
    if n_card != TRAIN_CHECK_STEPS or n_cpu != 0:
        fail(f"phase 13 (c): K4 launches card {n_card}, CPU {n_cpu}")
    flushes = int(np.stack(hc["flush_stream"]).sum())
    print(f"  (c) smoke float32, sgd, {TRAIN_CHECK_STEPS} steps, replayed traces: streams, xi, "
          f"mask_count equal card == CPU ({flushes} flushes, fresh {hc['mask_count']}); losses "
          f"within rtol {rel:.2e} (tolerance {TRAIN_CHECK_RTOL}); K4 launches {n_card}")
    out["card_vs_cpu_loss_rtol"] = rel

    # (d) the quickstart on the card: the loss falls
    from repro_torch.examples.quickstart import main as quickstart

    reset_launch_counts()
    t0 = time.perf_counter()
    _, qh = quickstart([])
    q_wall = time.perf_counter() - t0
    q_k4 = launch_counts()["dsag_cache_update"]
    first, last = float(np.mean(qh["loss"][:10])), float(np.mean(qh["loss"][-10:]))
    if not last < first or q_k4 != len(qh["loss"]):
        fail(f"phase 13 (d): quickstart loss {first} -> {last}, K4 launches {q_k4}")
    print(f"  (d) quickstart: {len(qh['loss'])} steps in {q_wall:.1f} s, mean loss of the "
          f"first 10 steps {first:.4f} -> last 10 {last:.4f}; K4 launches {q_k4}")
    out["quickstart"] = {"first10": first, "last10": last, "seconds": q_wall}

    # (e) K6 refuses to be differentiated
    q = torch.zeros(1, 64, 2, 64, device="cuda", requires_grad=True)
    reset_launch_counts()
    try:
        k6.flash_attention_bshd(q, q.detach(), q.detach())
    except RuntimeError as e:
        print(f"  (e) K6 refuses grad-requiring inputs: {e}")
    else:
        fail("phase 13 (e): K6 took a grad-requiring input")
    if launch_counts()["flash_attention"]:
        fail("phase 13 (e): K6 launched for a grad-requiring input")
    launches = {"dsag_cache_update": counts["dsag_cache_update"] + n_card + q_k4}
    return out, launches, row


#: phase 14: the archs of the MoE, MLA, SSM and hybrid families at their
#: published widths: the MoE models cut to this many layers (one card holds
#: neither whole: grok-1 is 316 B parameters, deepseek-v2 244 B), the others
#: at full depth
FAMILY_ARCHS = {"mamba2-370m": None, "zamba2-2.7b": None, "grok-1-314b": 4,
                "deepseek-v2-236b": 4}
#: phase 14: batch, prompt length and generated tokens of each model
FAMILY_B, FAMILY_PROMPT, FAMILY_TOKENS = 4, 1024, 32
#: phase 14 (c): archs whose bf16 decode-vs-prefill check is held on the
#: decode with float32 scores (the witness), the served decode's printed
#: beside it.  grok-1's scores reach 8.7e3 at this init (projection std 0.5
#: over d_model 6144), where a bf16 score's ulp is 16 to 32: the served decode
#: attention rounds its scores to bf16 (the reference's ``gqa_decode_step``),
#: K6's prefill keeps them in float32, so near-tied keys swap weight and the
#: routing that follows flips (measured on an H100 80GB HBM3 at 700 W: served
#: 0.585, witness 0.0142, against the 0.5 bound; in float32 at one layer 6.4e-5)
F32_SCORE_DECODE_GATE = ("grok-1-314b",)
#: phase 14 (d): the smoke configs in float32 on the card against the CPU
#: (float32 rounding of cuBLAS and K6 against the CPU's plain ops): logits and
#: caches within rtol plus this times the largest |CPU| value
FAMILY_CPU_TOL = 1e-4


def gqa_applications(cfg) -> int:
    """K6 launches per prefill: the GQA attention applications (none for SSM
    and MLA, one per group of ``attn_every`` layers for the hybrid)."""
    if cfg.family == "ssm" or cfg.use_mla:
        return 0
    return cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers


def no_drop_cf(cfg) -> float:
    """A capacity factor at which no (token, expert) pair drops: capacity
    ``t·k·cf / E`` >= t for every expert."""
    return float(math.ceil(cfg.num_experts / cfg.top_k))


class RouteLog:
    """Stands in for ``moe_apply``: records each call's top-k experts (sorted
    per token) and the pairs its capacity drops, then calls it."""

    def __init__(self, torch, moe_mod):
        self.torch, self.moe, self.apply, self.calls = torch, moe_mod, moe_mod.moe_apply, []

    def __call__(self, cfg, p, x, capacity_factor=None):
        m = self.moe
        tokens = x.reshape(m.dispatch_chunks(cfg, x.shape[0]), -1, x.shape[-1])
        idx = m.route(cfg, p, tokens)[2]
        cap = m.capacity_of(cfg, tokens.shape[1], capacity_factor or cfg.capacity_factor)
        counts = self.torch.stack([self.torch.bincount(c.reshape(-1), minlength=cfg.num_experts)
                                   for c in idx])
        dropped = int((counts - cap).clamp(min=0).sum())
        self.calls.append((idx.reshape(-1, cfg.top_k).sort(-1).values, dropped))
        return self.apply(cfg, p, x, capacity_factor=capacity_factor)


def family_prefill(torch, model, params, tokens, max_len: int, moe_mod, extra=None):
    """Last-position prefill logits and the run's :class:`RouteLog`; ``extra``
    holds the VLM's or enc-dec family's embeddings."""
    log = RouteLog(torch, moe_mod)
    with torch.inference_mode(), mock.patch.object(moe_mod, "moe_apply", log):
        logits, cache = model.prefill(params, dict(extra or {}, tokens=tokens), max_len)
    del cache
    return logits[:, -1], log


def decode_vs_prefill(torch, model, params, tokens, max_len: int, want, extra=None) -> float:
    """Rel RMS of token s's logits decoded from an (s-1)-token cache against
    ``want``, the s-token prefill's (the VLM's image positions counted)."""
    from repro_torch.launch.serve import prompt_positions

    with torch.inference_mode():
        _, cache = model.prefill(params, dict(extra or {}, tokens=tokens[:, :-1]), max_len)
        index = prompt_positions(model.cfg, tokens.shape[1]) - 1
        logits, _ = model.decode_step(params, tokens[:, -1:], cache, index)
    del cache
    return logit_diff(torch, logits[:, -1], want)[1]


#: phase 14 (b): float32 roundings of a score, in units of 2**-24 times the
#: largest |score| of its row, allowed on each side of K6 and its plain
#: version (both sum the same exact bf16 products in float32, in other
#: orders, then scale them): the plain version's scores are off float64's by
#: up to ~2 such units at grok-1's activations (measured on an H100 80GB HBM3)
SCORE_ROUNDING_ULPS = 16


def score_rounding_slack(torch, q, k, v, out, causal: bool = True):
    """How far each output of a softmax attention (causal by default) over
    ``[b, h, s, d]`` float32 inputs moves when every score of its row moves by up to
    ``eps = SCORE_ROUNDING_ULPS · 2**-24 · max|score|``: ``do/ds_i = p_i (v_i -
    o)``, so ``|do| <= eps · Σ p_i |v_i - o| <= eps · (P|V| + |o|)``.  Where
    scores reach thousands (grok-1 at this init) and two keys nearly tie, this
    float32 rounding moves an output whose values cancel by several of its own
    bf16 ulps, in K6 and in the plain version alike."""
    from repro_torch.kernels.flash_attention import NEG_INF

    sq, sk = q.shape[2], k.shape[2]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril(sk - sq)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    eps = SCORE_ROUNDING_ULPS * 2.0**-24 * s.abs().masked_fill(~keep, 0).amax(-1, keepdim=True)
    p = torch.softmax(s.masked_fill_(~keep, NEG_INF), dim=-1)
    return eps * (torch.einsum("bhqk,bhkd->bhqd", p, v.abs()) + out.abs())


def k6_on_layer_activations(torch, cfg, params, tokens) -> dict:
    """K6 against its plain version on the first GQA attention's real q, k, v
    (layer 0; the hybrid's shared block at group 0, after its Mamba2 layers):
    :func:`k6_against_plain_on`."""
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import apply_norm, apply_rope
    from repro_torch.models.transformer import embed_inputs, layer_params

    with torch.inference_mode():
        x = embed_inputs(cfg, params, tokens)
        if cfg.family == "hybrid":
            for i in range(cfg.attn_every):
                lp = layer_params(params["blocks"], i)
                x = x + ssm_mod.mamba_forward(cfg, lp["mamba"], apply_norm(cfg, lp["ln"], x))
            block = params["shared_attn"]
        else:
            block = layer_params(params["blocks"], 0)
        q, k, v = attn._project_qkv(cfg, block["attn"], apply_norm(cfg, block["ln1"], x))
        pos = torch.arange(tokens.shape[1], device="cuda").expand(tokens.shape)
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    return k6_against_plain_on(torch, cfg, q, k, v, True, "the first GQA attention", 14)


def k6_violations(torch, q, k, v, out, causal: bool):
    """K6's output ``out`` on ``[b, s, h, d]`` q, k, v against the plain
    version: ``(outside k6_within_tolerance, outside it widened by
    score_rounding_slack, |out - plain|, the [b, h, s, d] float32 tensors)``."""
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.models import attention as attn

    got = out.transpose(1, 2).float()
    g = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, attn._repeat_kv(k, g),
                                                      attn._repeat_kv(v, g)))
    want32 = k6.flash_attention_plain(qh, kh, vh, causal=causal)
    diff = (got - want32).abs()
    rtol = K6_RTOL[str(q.dtype).removeprefix("torch.")]
    tol = rtol * want32.abs() + K6_ATOL_REL * float(want32.abs().max())
    slack = score_rounding_slack(torch, qh, kh, vh, want32, causal=causal)
    return (int((diff > tol).sum()), int((diff > tol + slack).sum()), diff,
            (qh, kh, vh, got, want32))


def k6_against_plain_on(torch, cfg, q, k, v, causal: bool, what: str, phase: int,
                        quiet: bool = False) -> dict:
    """K6 (``flash_attention_bshd``) against its plain version on a model's
    real ``[b, s, h, d]`` q, k, v: :func:`k6_within_tolerance` (at the
    inputs' dtype), widened by :func:`score_rounding_slack`; the
    float64-score result printed beside both as the witness.  One K6
    launch."""
    from repro_torch.kernels import flash_attention as k6

    with torch.inference_mode():
        out = k6.flash_attention_bshd(q, k, v, causal=causal)
        strict, wide, diff, (qh, kh, vh, got, want32) = k6_violations(torch, q, k, v, out,
                                                                      causal)
        # the witness: attention with float64 scores and probabilities
        s64 = torch.einsum("bhqd,bhkd->bhqk", qh.double(), kh.double()) / math.sqrt(q.shape[-1])
        sq, sk = s64.shape[-2:]
        if causal:
            s64.masked_fill_(~torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(sk - sq),
                             k6.NEG_INF)
        exact = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s64, -1), vh.double())
        del s64
        err_k6, err_plain = (float((t.double() - exact).abs().max()) for t in (got, want32))
        res = {"max_abs_err": float(diff.max()), "violations_strict": strict,
               "violations": wide, "k6_vs_f64": err_k6, "plain_vs_f64": err_plain}
    if not quiet:
        print(f"    (b) K6 on {what}'s q, k, v ({q.shape[2]} q / {k.shape[2]} kv heads x "
              f"{q.shape[3]}, {q.shape[1]} queries over {k.shape[1]} keys, "
              f"{'causal' if causal else 'non-causal'}, |q| <= {float(q.abs().max()):.1f}): "
              f"max |K6 - plain| {res['max_abs_err']:.3e}; outside k6_within_tolerance "
              f"{strict} of {diff.numel()}, outside it widened by the float32 score rounding "
              f"({SCORE_ROUNDING_ULPS} ulps of the row's largest score) {wide}; against "
              f"float64 scores max |K6 - exact| {err_k6:.3e}, max |plain - exact| "
              f"{err_plain:.3e}")
    if wide or not bool(torch.isfinite(got).all()):
        fail(f"phase {phase} (b): K6 on {cfg.name}'s {what} disagrees with its plain "
             f"version beyond the float32 score rounding at {wide} outputs")
    return res


def card_against_cpu(torch, arch: str, phase: int = 14) -> dict:
    """Phase 14 (d) (and 15 (d)): ``arch``'s smoke config in float32 on the
    card (K6 where the model has GQA) and on the CPU (plain): prefill and 4
    greedy decode steps, logits and every cache leaf; the VLM's and enc-dec
    family's stub embeddings beside the 40 prompt tokens."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import prompt_positions, stub_batch
    from repro_torch.models import build_model
    from repro_torch.models.layers import _leaves, tree_map

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)))
    emb = {k: v for k, v in stub_batch(cfg, 2, 40, seed=4).items() if k != "tokens"}
    n = prompt_positions(cfg, 40)
    runs = {}
    for dev, backend in (("cpu", "torch"), ("cuda", "cuda")):
        model = build_model(cfg, kernel_backend=backend)
        p = tree_map(lambda a: a.to(dev), params)
        batch = {k: v.to(dev) for k, v in dict(emb, tokens=toks).items()}
        steps, tok = [], None
        with torch.inference_mode():
            logits, cache = model.prefill(p, batch, n + 8)
            for t in range(5):
                if t:
                    logits, cache = model.decode_step(p, tok, cache, n - 1 + t)
                tok = logits[:, -1:].argmax(-1)
                # copies: the next step writes the cache in place
                leaves = [logits] + [c for _, c in _leaves(cache)]
                steps.append([a.float().cpu().clone() for a in leaves] + [tok.cpu()])
        runs[backend] = steps
    worst = 0.0
    for s_card, s_cpu in zip(runs["cuda"], runs["torch"]):
        if not torch.equal(s_card[-1], s_cpu[-1]):
            fail(f"phase {phase} (d): {cfg.name}: greedy tokens differ card vs CPU")
        for a, b in zip(s_card[:-1], s_cpu[:-1]):
            scale = float(b.abs().max())
            if not torch.allclose(a, b, rtol=FAMILY_CPU_TOL, atol=FAMILY_CPU_TOL * scale):
                fail(f"phase {phase} (d): {cfg.name}: card and CPU differ by "
                     f"{float((a - b).abs().max()):.3e} (|CPU| <= {scale:.3e})")
            worst = max(worst, float((a - b).abs().max()) / max(scale, 1e-30))
    return {"max_rel": worst}


def run_families(torch) -> dict:
    """Phase 14: serve the MoE, MLA, SSM and hybrid families at their
    published widths.  Returns the phase's numbers (``k6_main``: K6's
    launches in the main path's ``generate`` runs)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    max_len = FAMILY_PROMPT + FAMILY_TOKENS + 8
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {"k6_main": 0, "models": {}}
    for arch, depth in FAMILY_ARCHS.items():
        t_model = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth) if depth else full
        gqa = gqa_applications(cfg)
        # the server of this arch over the config at this depth (the published
        # widths), weights drawn from seed 0 on the card
        srv = Server(arch, smoke=True, max_len=max_len, device="cuda", seed=0)
        srv.cfg, srv.model = cfg, build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        srv.params = srv.model.init(torch.Generator(device="cuda").manual_seed(0))
        model, params = srv.model, srv.params
        init_peak = torch.cuda.max_memory_allocated()
        cut = (f"{depth} of {full.num_layers} layers (cut: one card holds neither MoE model)"
               if depth else f"all {cfg.num_layers} layers")
        print(f"  {arch}: {cut}, d_model {cfg.d_model}, {model.num_params() / 1e9:.2f} B "
              f"parameters (bf16, seed 0; {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
              f"init peak {init_peak / 2**30:.1f} GiB); batch {FAMILY_B} x prompt "
              f"{FAMILY_PROMPT}, {FAMILY_TOKENS} tokens; {gqa} K6 launches per prefill")
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                    (FAMILY_B, FAMILY_PROMPT))
        tokens = torch.as_tensor(prompts, device="cuda")
        reset_launch_counts()
        srv.generate({"tokens": prompts[:, :64]}, 2)  # warm the libraries
        k6_expected = gqa  # every K6 launch of this model's checks: one per GQA prefill layer

        # (a) generation through the server
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()["flash_attention"]
        toks = srv.generate({"tokens": prompts}, FAMILY_TOKENS)
        n6 = launch_counts()["flash_attention"] - n0
        k6_expected += gqa
        t = srv.timings
        peak = torch.cuda.max_memory_allocated()
        if n6 != gqa:
            fail(f"phase 14 (a): {arch}: {n6} K6 launches for one prefill, expected {gqa}")
        vocab_padded = params["embed"]["tok"].shape[0]
        if toks.shape != (FAMILY_B, FAMILY_TOKENS) or not bool(
                ((toks >= 0) & (toks < vocab_padded)).all()):
            fail(f"phase 14 (a): {arch}: tokens of shape {tuple(toks.shape)} outside "
                 f"[0, {vocab_padded})")
        decode_ms = t["decode"] / (FAMILY_TOKENS - 1) * 1e3
        tok_s = FAMILY_B * FAMILY_TOKENS / (t["prefill"] + t["decode"])
        print(f"    (a) generate ({smi}): prefill {t['prefill']:.4f} s "
              f"({FAMILY_B * FAMILY_PROMPT / t['prefill']:.0f} prompt tok/s), decode "
              f"{decode_ms:.3f} ms/token step ({FAMILY_B / decode_ms * 1e3:.0f} tok/s), "
              f"{tok_s:.1f} generated tok/s end to end; peak memory {peak / 2**30:.2f} GiB; "
              f"K6 launches {n6}")
        res = {"layers": cfg.num_layers, "params": model.num_params(), "prefill_s": t["prefill"],
               "decode_ms_per_token": decode_ms, "tokens_per_s": tok_s, "peak_bytes": peak,
               "init_peak_bytes": init_peak, "k6_launches": n6}
        out["k6_main"] += n6

        # (b) K6 on the model's real activations, and the whole model through
        # K6 against it through the plain attention (bf16)
        lg_main, log_main = family_prefill(torch, model, params, tokens, max_len, moe_mod)
        k6_expected += gqa
        if cfg.num_experts:
            dropped = sum(d for _, d in log_main.calls)
            res["dropped_pairs_published_cf"] = dropped
            print(f"    pairs dropped at the published capacity factor "
                  f"{cfg.capacity_factor}: {dropped} of "
                  f"{FAMILY_B * FAMILY_PROMPT * cfg.top_k * cfg.num_layers} in one prefill")
        if gqa:
            res["k6_on_activations"] = k6_on_layer_activations(torch, cfg, params, tokens)
            k6_expected += 1
            plain = build_model(cfg, kernel_backend="torch")
            lg_plain, log_plain = family_prefill(torch, plain, params, tokens, max_len, moe_mod)
            rms = logit_diff(torch, lg_main, lg_plain)[1]
            res["k6_vs_plain_rel_rms_bf16"] = rms
            line = (f"    (b) bf16 prefill logits through K6 vs the plain attention: rel RMS "
                    f"{rms:.4f}")
            if cfg.num_experts:
                agree = float(np.mean([float((a == b).all(-1).float().mean()) for (a, _), (b, _)
                                       in zip(log_main.calls, log_plain.calls)]))
                res["topk_agree_k6_vs_plain"] = agree
                print(f"{line} (printed, not gated: a routing flip at a near-tie is no kernel "
                      f"fault); (token, layer) pairs whose top-{cfg.top_k} experts agree "
                      f"{agree:.4f}")
            else:
                tol = SERVE_TOL["k6_vs_plain"]
                print(f"{line} (tolerance {tol})")
                if rms > tol:
                    fail(f"phase 14 (b): {arch}: bf16 K6 and plain prefills differ by rel RMS "
                         f"{rms} (tolerance {tol})")
            del plain, log_plain

        # (c) decode of token s from an (s-1)-token cache against the s-token
        # prefill, bf16, at a capacity factor that drops no pair
        if cfg.num_experts:
            cf = no_drop_cf(cfg)
            model_c = build_model(dataclasses.replace(cfg, capacity_factor=cf))
            want, _ = family_prefill(torch, model_c, params, tokens, max_len, moe_mod)
            k6_expected += gqa
            label = f"bf16, capacity factor {cf:g} (no pair drops)"
        else:
            model_c, want, label = model, lg_main, "bf16"
        dp = decode_vs_prefill(torch, model_c, params, tokens, max_len, want)
        k6_expected += gqa
        tol = SERVE_TOL["decode_vs_prefill"]
        gate = "printed; the witness below is held" if arch in F32_SCORE_DECODE_GATE else tol
        print(f"    (c) {label}: decode of token {FAMILY_PROMPT} from a "
              f"{FAMILY_PROMPT - 1}-token cache vs the {FAMILY_PROMPT}-token prefill: rel RMS "
              f"{dp:.3e} (tolerance {gate})")
        if gqa:
            # the witness: the same decode with its attention scores kept in
            # float32, as K6's prefill keeps them
            with mock.patch.object(attn, "gqa_decode_step", decode_step_f32_scores):
                res["decode_vs_prefill_rel_rms_bf16_f32_scores"] = decode_vs_prefill(
                    torch, model_c, params, tokens, max_len, want)
            k6_expected += gqa
            print(f"    (c) the same decode with float32 scores (witness): rel RMS "
                  f"{res['decode_vs_prefill_rel_rms_bf16_f32_scores']:.3e} (tolerance "
                  f"{tol if arch in F32_SCORE_DECODE_GATE else 'none: printed'})")
        gated = (res["decode_vs_prefill_rel_rms_bf16_f32_scores"]
                 if arch in F32_SCORE_DECODE_GATE else dp)
        if gated > tol:
            fail(f"phase 14 (c): {arch}: bf16 decode vs prefill rel RMS {gated} "
                 f"(tolerance {tol})")
        res["decode_vs_prefill_rel_rms_bf16"] = dp

        # float32: the MoE models at one layer (grok at four would need 85 GB),
        # the others at full depth; the bf16 weights cast
        L32 = 1 if cfg.num_experts else cfg.num_layers
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=L32)
        if cfg.num_experts:
            cfg32 = dataclasses.replace(cfg32, capacity_factor=no_drop_cf(cfg))
        p32 = {k: (tree_map(lambda a: a[:L32].float(), v) if k == "blocks"
                   else tree_map(lambda a: a.float(), v)) for k, v in params.items()}
        del srv, model, params, model_c, want, log_main
        gc.collect()
        torch.cuda.empty_cache()
        k6_32 = build_model(cfg32)
        gqa32 = gqa_applications(cfg32)
        lg32, _ = family_prefill(torch, k6_32, p32, tokens, max_len, moe_mod)
        k6_expected += gqa32
        if gqa:
            lg32_plain, _ = family_prefill(torch, build_model(cfg32, kernel_backend="torch"),
                                           p32, tokens, max_len, moe_mod)
            d32 = logit_diff(torch, lg32, lg32_plain)
            print(f"    (b) float32 ({L32} layers) through K6 vs the plain attention: prefill "
                  f"logits max|diff|/max {d32[0]:.3e}, rel RMS {d32[1]:.3e} (tolerance "
                  f"{SERVE_F32_TOL})")
            if max(d32) > SERVE_F32_TOL:
                fail(f"phase 14 (b): {arch}: float32 K6 and plain prefills differ by {d32}")
            res["k6_vs_plain_f32"] = d32
            if not cfg.num_experts:  # full depth: the float32 run is the bf16 runs' yardstick
                e_k6, e_plain = (logit_diff(torch, lg, lg32)[1] for lg in (lg_main, lg_plain))
                print(f"    bf16 prefill logits against the float32 run: rel RMS through K6 "
                      f"{e_k6:.4f}, through the plain attention {e_plain:.4f} (printed)")
                res.update(bf16_k6_vs_f32_rel_rms=e_k6, bf16_plain_vs_f32_rel_rms=e_plain)
        dp32 = decode_vs_prefill(torch, k6_32, p32, tokens, max_len, lg32)
        k6_expected += gqa32
        print(f"    (c) float32 ({L32} layers): decode vs prefill rel RMS {dp32:.3e} "
              f"(tolerance {SERVE_F32_TOL})")
        if dp32 > SERVE_F32_TOL:
            fail(f"phase 14 (c): {arch}: float32 decode vs prefill rel RMS {dp32} "
                 f"(tolerance {SERVE_F32_TOL})")
        res["decode_vs_prefill_rel_rms_f32"] = dp32
        del k6_32, p32, lg32, lg_main
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the smoke config, float32: the card against the CPU
        d = card_against_cpu(torch, arch)
        smoke_gqa = gqa_applications(get_smoke_config(arch))
        print(f"    (d) smoke config, float32, prefill + 4 greedy steps: card == CPU tokens, "
              f"logits and caches within max |diff| / max|CPU| {d['max_rel']:.2e} "
              f"(tolerance rtol {FAMILY_CPU_TOL} + {FAMILY_CPU_TOL} x max)")
        res["card_vs_cpu_max_rel"] = d["max_rel"]
        k6_expected += smoke_gqa
        total = launch_counts()["flash_attention"]
        if total != k6_expected:
            fail(f"phase 14: {arch}: {total} K6 launches, expected {k6_expected} (one per GQA "
                 f"layer of each prefill through K6, one on the activations)")
        res["seconds"] = time.perf_counter() - t_model
        print(f"    K6 launches for {arch} in the phase: {total} (the main path's {n6}); "
              f"{res['seconds']:.1f} s")
        out["models"][arch] = res
    return out


#: phase 15: the rest of the registry at its published widths, at full depth
#: but qwen1.5-32b, cut to this many of its 64 layers (the whole model is
#: 36.5 B parameters, 73 GB in bf16: with the float32 draw of one stacked
#: leaf during the init it leaves no room on an 80 GB card)
REGISTRY_ARCHS = {"qwen2-7b": None, "starcoder2-15b": None, "pixtral-12b": None,
                  "qwen1.5-32b": 32, "whisper-base": None}
#: phase 15 (b), (c): decoder layers of the float32 runs (the float32 weights
#: at full depth would not fit beside the bf16 ones), and whisper-base's
#: encoder and decoder layers: at this init its float32 model carries a
#: rounding of the scores on into its logits, more with each layer (K6
#: against the plain attention: rel RMS 2.5e-6 at one layer each, 0.629 at
#: all six; H100 80GB HBM3, 700 W)
REGISTRY_F32_LAYERS, WHISPER_F32_LAYERS = 4, 1
#: phase 15 (b), (c): the end-to-end comparisons printed and not held, with
#: the reason; every other (arch, dtype) holds the model through K6 against it
#: through the plain attention with float32 scores, and decode against prefill,
#: within SERVE_TOL (bf16) or SERVE_F32_TOL (float32).  At this init attention
#: is near one-hot (scores in the hundreds), and these models carry a rounding
#: of the scores on into their logits (H100 80GB HBM3, 700 W): starcoder2-15b
#: reads 0.661 and 0.516 against 0.5, whisper-base 1.002 and 0.116, while each
#: of their K6 calls, held on its own inputs (:func:`teacher_forced_k6`),
#: agrees with its plain version within k6_within_tolerance
REGISTRY_E2E_UNHELD = {
    ("starcoder2-15b", "bfloat16"): "starcoder2-15b amplifies bf16 rounding at this init",
    ("whisper-base", "bfloat16"): "whisper-base amplifies bf16 rounding at this init",
}
#: phase 15 (e): whisper-base trained at full width: steps, global batch,
#: tokens per sequence (the reference trainer's default shape), P = 4
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 8, 8, 128


def k6_per_call(cfg) -> tuple[int, int]:
    """K6 launches per prefill and per decode step: each decoder layer's
    causal self-attention at prefill; whisper adds each encoder layer's
    self-attention and each decoder layer's cross-attention, which runs at
    every decode step too."""
    if cfg.family == "enc_dec":
        return cfg.encoder_layers + 2 * cfg.num_layers, cfg.num_layers
    return cfg.num_layers, 0


def registry_batch(torch, cfg, text: int, seed: int = 0) -> dict:
    """The CLI's stub batch on the card: ``text`` prompt tokens and the VLM's
    or enc-dec family's embeddings (normal times 0.1, bf16)."""
    from repro_torch.launch.serve import stub_batch

    return {k: torch.as_tensor(v).to("cuda") for k, v in stub_batch(cfg, FAMILY_B, text,
                                                                      seed).items()}


def held(value: float, tol: float, arch: str, dtype: str, what: str) -> str:
    """Fail if ``value`` (a rel RMS between two runs of one model) is past
    ``tol``, unless ``(arch, dtype)`` is one of :data:`REGISTRY_E2E_UNHELD`.
    Returns the bound's description for the report."""
    if (arch, dtype) in REGISTRY_E2E_UNHELD:
        return "printed, not held: " + REGISTRY_E2E_UNHELD[arch, dtype]
    if value > tol:
        fail(f"{what}: rel RMS {value} past the tolerance {tol}")
    return f"tolerance {tol}"


def teacher_forced_k6(torch, cfg, model, params, tokens, max_len: int, extra) -> dict:
    """Every attention call of one prefill and of the decode step after it,
    run through the plain attention (``model``'s backend ``"torch"``), also
    runs through K6 on the same q, k, v (:func:`k6_against_plain_on`, which
    fails on a disagreement), and the model goes on with the plain result:
    each K6 call of the main path held on its own inputs at its own shape, at
    full depth, where the whole model's logits amplify every rounding.
    Prints one line for each kind of call; one K6 launch per call."""
    from repro_torch.launch.serve import prompt_positions
    from repro_torch.models import attention as attn

    plain_attend, rows, where = attn._attend, {}, ["prefill"]

    def both(q, k, v, *, causal, q_offset=0, scale=None, backend="torch"):
        if q_offset or scale is not None:
            fail(f"phase 15 (b): {cfg.name}: an attention call K6 does not take "
                 f"(q_offset {q_offset}, scale {scale})")
        kind = (f"{where[0]}, {'causal' if causal else 'non-causal'} {q.shape[1]} queries over "
                f"{k.shape[1]} keys, {q.shape[2]} q / {k.shape[2]} kv heads x {q.shape[3]}")
        row = k6_against_plain_on(torch, cfg, q, k, v, causal, kind, 15, quiet=True)
        rows.setdefault(kind, []).append(dict(row, q_max=float(q.abs().max())))
        return plain_attend(q, k, v, causal=causal, backend="torch")

    with torch.inference_mode(), mock.patch.object(attn, "_attend", both):
        _, cache = model.prefill(params, dict(extra, tokens=tokens), max_len)
        where[0] = "decode step"
        model.decode_step(params, tokens[:, -1:], cache, prompt_positions(cfg, tokens.shape[1]))
    del cache
    for kind, rs in rows.items():
        print(f"    (b) {cfg.dtype}, teacher-forced: {len(rs)} x ({kind}), |q| <= "
              f"{max(r['q_max'] for r in rs):.1f}: max |K6 - plain| "
              f"{max(r['max_abs_err'] for r in rs):.3e}; outside k6_within_tolerance "
              f"{sum(r['violations_strict'] for r in rs)}, outside it widened by the float32 "
              f"score rounding {sum(r['violations'] for r in rs)}; against float64 scores "
              f"max |K6 - exact| {max(r['k6_vs_f64'] for r in rs):.3e}, max |plain - exact| "
              f"{max(r['plain_vs_f64'] for r in rs):.3e}")
    every = [r for rs in rows.values() for r in rs]
    return {"prefill_calls": sum(len(rs) for kind, rs in rows.items()
                                 if kind.startswith("prefill")),
            "decode_calls": sum(len(rs) for kind, rs in rows.items()
                                if kind.startswith("decode")),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "violations_strict": sum(r["violations_strict"] for r in every),
            "k6_vs_f64": max(r["k6_vs_f64"] for r in every),
            "plain_vs_f64": max(r["plain_vs_f64"] for r in every)}


def run_registry(torch) -> dict:
    """Phase 15: serve the rest of the registry at its published widths.
    Returns the phase's numbers (``k6_main``: K6's launches in the main
    path's ``generate`` runs)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Server, prompt_positions
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    max_len = FAMILY_PROMPT + FAMILY_TOKENS + 8
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {"k6_main": 0, "models": {}}
    for arch, depth in REGISTRY_ARCHS.items():
        t_model = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth) if depth else full
        n_pre, n_dec = k6_per_call(cfg)
        # the prompt fills FAMILY_PROMPT positions: pixtral's 256 image
        # embeddings come first
        text = FAMILY_PROMPT - prompt_positions(cfg, 0)
        srv = Server(arch, smoke=True, max_len=max_len, device="cuda", seed=0)
        srv.cfg, srv.model = cfg, build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        srv.params = srv.model.init(torch.Generator(device="cuda").manual_seed(0))
        model, params = srv.model, srv.params
        init_peak = torch.cuda.max_memory_allocated()
        batch = registry_batch(torch, cfg, text)
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        tokens = batch["tokens"]
        cut = (f"{depth} of {full.num_layers} layers (cut: the whole model does not fit the "
               f"card)" if depth else f"all {cfg.num_layers} layers"
               + (f" and {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else ""))
        inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        print(f"  {arch}: {cut}, d_model {cfg.d_model}, {model.num_params() / 1e9:.2f} B "
              f"parameters (bf16, seed 0; {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
              f"init peak {init_peak / 2**30:.1f} GiB); {inputs}, {FAMILY_TOKENS} tokens; K6 "
              f"launches per prefill {n_pre}, per decode step {n_dec}")
        reset_launch_counts()
        srv.generate(dict(extra, tokens=tokens[:, :64]), 2)  # warm the libraries
        k6_expected = n_pre + n_dec

        # (a) generation through the server
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()["flash_attention"]
        toks = srv.generate(batch, FAMILY_TOKENS)
        n6 = launch_counts()["flash_attention"] - n0
        want6 = n_pre + (FAMILY_TOKENS - 1) * n_dec
        k6_expected += want6
        t = srv.timings
        peak = torch.cuda.max_memory_allocated()
        if n6 != want6:
            fail(f"phase 15 (a): {arch}: {n6} K6 launches in generate, expected {want6}")
        vocab_padded = params["embed"]["tok"].shape[0]
        if toks.shape != (FAMILY_B, FAMILY_TOKENS) or not bool(
                ((toks >= 0) & (toks < vocab_padded)).all()):
            fail(f"phase 15 (a): {arch}: tokens of shape {tuple(toks.shape)} outside "
                 f"[0, {vocab_padded})")
        decode_ms = t["decode"] / (FAMILY_TOKENS - 1) * 1e3
        tok_s = FAMILY_B * FAMILY_TOKENS / (t["prefill"] + t["decode"])
        print(f"    (a) generate ({smi}): prefill {t['prefill']:.4f} s "
              f"({FAMILY_B * FAMILY_PROMPT / t['prefill']:.0f} prompt positions/s), decode "
              f"{decode_ms:.3f} ms/token step ({FAMILY_B / decode_ms * 1e3:.0f} tok/s), "
              f"{tok_s:.1f} generated tok/s end to end; peak memory {peak / 2**30:.2f} GiB; "
              f"K6 launches {n6} = {n_pre} + {FAMILY_TOKENS - 1} x {n_dec}")
        res = {"layers": cfg.num_layers, "params": model.num_params(), "prefill_s": t["prefill"],
               "decode_ms_per_token": decode_ms, "tokens_per_s": tok_s, "peak_bytes": peak,
               "init_peak_bytes": init_peak, "k6_launches": n6}
        out["k6_main"] += n6

        # (b) every attention call of one bf16 prefill and decode step through
        # K6 on the plain run's own q, k, v; then the whole model through K6
        # against it through the plain attention
        plain = build_model(cfg, kernel_backend="torch")
        tf = teacher_forced_k6(torch, cfg, plain, params, tokens, max_len, extra)
        if (tf["prefill_calls"], tf["decode_calls"]) != (n_pre, n_dec):
            fail(f"phase 15 (b): {arch}: {tf['prefill_calls']} + {tf['decode_calls']} attention "
                 f"calls in the teacher-forced prefill and decode step, expected {n_pre} + "
                 f"{n_dec}")
        k6_expected += n_pre + n_dec
        res["teacher_forced_bf16"] = tf
        n0 = launch_counts()["flash_attention"]
        lg_main, _ = family_prefill(torch, model, params, tokens, max_len, moe_mod, extra)
        if launch_counts()["flash_attention"] - n0 != n_pre:
            fail(f"phase 15 (a): {arch}: {launch_counts()['flash_attention'] - n0} K6 "
                 f"launches in one prefill, expected {n_pre}")
        k6_expected += n_pre
        # the plain attention rounds its scores to bf16 (the reference's
        # full_attention), K6 keeps them in float32: at this init (projection
        # std 1/sqrt(L) over d_model) scores reach hundreds, where a bf16
        # score's ulp is 1 to 4, so the served plain run is printed and the
        # gate holds K6 against the plain attention with float32 scores (the
        # witness: K6's plain version inside the model)
        lg_plain, _ = family_prefill(torch, plain, params, tokens, max_len, moe_mod, extra)
        with mock.patch.object(attn, "_attend", attend_f32_scores):
            lg_wit, _ = family_prefill(torch, plain, params, tokens, max_len, moe_mod, extra)
        rms_plain = logit_diff(torch, lg_main, lg_plain)[1]
        rms = logit_diff(torch, lg_main, lg_wit)[1]
        res["k6_vs_plain_rel_rms_bf16"] = rms_plain
        res["k6_vs_plain_f32_scores_rel_rms_bf16"] = rms
        print(f"    (b) bf16 prefill logits through K6 vs the plain attention: rel RMS "
              f"{rms_plain:.4f} (printed: bf16 scores); vs the plain attention with float32 "
              f"scores (witness) {rms:.4f} ("
              + held(rms, SERVE_TOL["k6_vs_plain"], arch, "bfloat16",
                     f"phase 15 (b): {arch}: bf16 K6 vs float32-score plain") + ")")

        # (c) decode of token s from an (s-1)-token cache against the s-token
        # prefill, bf16; the K6 launches of one decode step counted; the
        # served decode (bf16 scores, the reference's gqa_decode_step)
        # printed, the float32-score decode (witness) held
        with torch.inference_mode():
            _, cache = model.prefill(params, dict(extra, tokens=tokens[:, :-1]), max_len)
            n0 = launch_counts()["flash_attention"]
            logits, _ = model.decode_step(params, tokens[:, -1:], cache,
                                          prompt_positions(cfg, tokens.shape[1]) - 1)
            n_step = launch_counts()["flash_attention"] - n0
        del cache
        k6_expected += n_pre + n_dec
        if n_step != n_dec:
            fail(f"phase 15 (c): {arch}: {n_step} K6 launches in one decode step, "
                 f"expected {n_dec}")
        dp = logit_diff(torch, logits[:, -1], lg_main)[1]
        with mock.patch.object(attn, "gqa_decode_step", decode_step_f32_scores):
            dp_wit = decode_vs_prefill(torch, model, params, tokens, max_len, lg_main, extra)
        k6_expected += n_pre + n_dec
        print(f"    (c) bf16: decode of position {FAMILY_PROMPT} from a {FAMILY_PROMPT - 1}-"
              f"position cache vs the {FAMILY_PROMPT}-position prefill: rel RMS {dp:.3e} "
              f"(printed: bf16 scores); with float32 scores (witness) {dp_wit:.3e} ("
              + held(dp_wit, SERVE_TOL["decode_vs_prefill"], arch, "bfloat16",
                     f"phase 15 (c): {arch}: bf16 float32-score decode vs prefill")
              + f"); K6 launches in the step {n_step}")
        res["decode_vs_prefill_rel_rms_bf16"] = dp
        res["decode_vs_prefill_rel_rms_bf16_f32_scores"] = dp_wit

        # float32 at a cut depth (:data:`REGISTRY_F32_LAYERS`): the bf16
        # weights cast, then freed
        enc_dec = cfg.family == "enc_dec"
        L32 = WHISPER_F32_LAYERS if enc_dec else min(cfg.num_layers, REGISTRY_F32_LAYERS)
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=L32,
                                    encoder_layers=L32 if enc_dec else cfg.encoder_layers)
        layers32 = f"{L32} decoder layers" + (f" and {L32} encoder layers" if enc_dec else "")
        p32 = {k: (tree_map(lambda a: a[:L32].float(), v) if k in ("blocks", "enc_blocks")
                   else tree_map(lambda a: a.float(), v)) for k, v in params.items()}
        del srv, model, params, plain, lg_main, lg_plain, lg_wit, logits
        gc.collect()
        torch.cuda.empty_cache()
        n32, n32_dec = k6_per_call(cfg32)
        k6_32, plain32 = build_model(cfg32), build_model(cfg32, kernel_backend="torch")
        # every attention call of the float32 model, K6 on the plain run's inputs
        tf = teacher_forced_k6(torch, cfg32, plain32, p32, tokens, max_len, extra)
        k6_expected += n32 + n32_dec
        if (tf["prefill_calls"], tf["decode_calls"]) != (n32, n32_dec):
            fail(f"phase 15 (b): {arch}: {tf['prefill_calls']} + {tf['decode_calls']} attention "
                 f"calls in the float32 prefill and decode step, expected {n32} + {n32_dec}")
        res["teacher_forced_f32"] = tf
        lg32, _ = family_prefill(torch, k6_32, p32, tokens, max_len, moe_mod, extra)
        lg32_plain, _ = family_prefill(torch, plain32, p32, tokens, max_len, moe_mod, extra)
        k6_expected += n32
        d32 = logit_diff(torch, lg32, lg32_plain)
        res["k6_vs_plain_f32"] = d32
        print(f"    (b) float32 ({layers32}): through K6 vs the plain attention: "
              f"prefill logits max|diff|/max {d32[0]:.3e}, rel RMS {d32[1]:.3e} ("
              + held(max(d32), SERVE_F32_TOL, arch, "float32",
                     f"phase 15 (b): {arch}: float32 K6 vs plain") + ")")
        dp32 = decode_vs_prefill(torch, k6_32, p32, tokens, max_len, lg32, extra)
        k6_expected += n32 + n32_dec
        print(f"    (c) float32 ({layers32}): decode vs prefill rel RMS {dp32:.3e} ("
              + held(dp32, SERVE_F32_TOL, arch, "float32",
                     f"phase 15 (c): {arch}: float32 decode vs prefill") + ")")
        res["decode_vs_prefill_rel_rms_f32"] = dp32
        del k6_32, plain32, p32, lg32, lg32_plain
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the smoke config, float32: the card against the CPU
        d = card_against_cpu(torch, arch, phase=15)
        from repro_torch.configs import get_smoke_config

        s_pre, s_dec = k6_per_call(get_smoke_config(arch))
        k6_expected += s_pre + 4 * s_dec
        print(f"    (d) smoke config, float32, prefill + 4 greedy steps: card == CPU tokens, "
              f"logits and caches within max |diff| / max|CPU| {d['max_rel']:.2e} "
              f"(tolerance rtol {FAMILY_CPU_TOL} + {FAMILY_CPU_TOL} x max)")
        res["card_vs_cpu_max_rel"] = d["max_rel"]
        total = launch_counts()["flash_attention"]
        if total != k6_expected:
            fail(f"phase 15: {arch}: {total} K6 launches, expected {k6_expected}")
        res["seconds"] = time.perf_counter() - t_model
        print(f"    K6 launches for {arch} in the phase: {total} (the main path's {n6}); "
              f"{res['seconds']:.1f} s")
        out["models"][arch] = res
    out["whisper_training"], out["train_launches"] = run_whisper_training(torch)
    return out


def run_whisper_training(torch) -> tuple[dict, dict]:
    """Phase 15 (e): whisper-base trains at full width through ``Trainer``
    (the model-zoo branch, ``TrainConfig()``: adamw, bf16 slots, remat full;
    P = 4, live-sampled stragglers): K4 once per step over the flat [4, n]
    bf16 slots, the plain attention (no K6), finite losses."""
    import gc

    from repro_torch.configs.base import TrainConfig
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import Trainer, TrainerOptions

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()
    trn = Trainer(TrainerOptions(arch="whisper-base", smoke=False, steps=WHISPER_TRAIN_STEPS,
                                 global_batch=WHISPER_TRAIN_BATCH, seq_len=WHISPER_TRAIN_SEQ,
                                 train_config=TrainConfig(), log_every=10**6,
                                 engine=EngineConfig(device="cuda", kernel_backend="cuda")))
    cfg, n_params = trn.cfg, trn.model.num_params()
    P, n = trn.gs.num_groups, trn.layout.numel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = trn.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if len(losses) != WHISPER_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"phase 15 (e): losses {losses}")
    if counts["dsag_cache_update"] != WHISPER_TRAIN_STEPS or counts["flash_attention"]:
        fail(f"phase 15 (e): {counts['dsag_cache_update']} K4 launches in "
             f"{WHISPER_TRAIN_STEPS} steps, {counts['flash_attention']} K6 launches")
    host_ms = float(np.mean(hist["step_time"][2:])) * 1e3
    print(f"  (e) {cfg.name}: {cfg.encoder_layers} + {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e6:.1f} M parameters (flat n = {n}), P = {P}, global "
          f"batch {WHISPER_TRAIN_BATCH} x {WHISPER_TRAIN_SEQ} tokens + {cfg.encoder_seq} audio "
          f"frames, adamw, bf16 slots, remat full ({smi}): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; host {host_ms:.1f} ms per step (steps "
          f"2-{WHISPER_TRAIN_STEPS - 1}), run wall {wall:.2f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; K4 launches {counts['dsag_cache_update']} = steps at "
          f"[{P}, {n}] bf16")
    res = {"params": n_params, "numel": n, "losses": losses, "host_ms_per_step": host_ms,
           "wall_s": wall, "peak_bytes": peak, "k4_launches": counts["dsag_cache_update"]}
    del trn
    gc.collect()
    torch.cuda.empty_cache()
    return res, {"dsag_cache_update": counts["dsag_cache_update"]}


#: phase 16 (a), (b): the SSM and hybrid archs trained through ``Trainer`` at
#: their published widths, and the depth each is cut to (None: full depth).
#: zamba2-2.7b keeps two of its nine groups of six Mamba2 layers and the shared
#: block, the deepest that fits under ~70 GiB: a run peaked at 84.1 bytes per
#: parameter at one group (H100 80GB HBM3, 700 W), so two groups (0.747 B
#: parameters) take ~59 GiB and three (0.986 B) ~77 GiB
FAMILY_TRAIN_ARCHS = {"mamba2-370m": None, "zamba2-2.7b": 12}
#: phase 16 (a), (b), (d): steps of each run (mamba2-370m's take ~3.9 s each
#: on the card: four keep the script in its time)
FAMILY_TRAIN_STEPS = 4
#: phase 16 (c): archs whose full-width layer runs forward and backward alone
#: (embedding, one block, unembedding; bf16): no DSAG state of them fits one
#: card (a grok-1 layer alone holds 4.8 B expert parameters, a deepseek-v2
#: layer 3.9 B; pixtral-12b's embedding tables are 1.34 B), so no Trainer
FAMILY_LAYER_ARCHS = ("grok-1-314b", "deepseek-v2-236b", "pixtral-12b")
#: phase 16 (c): the MoE backward through ``_Dispatch``/``_Combine`` against
#: autograd through the indexing form (an accumulating ``index_put``), each
#: gradient leaf within four bf16 ulps of its largest value
MOE_BWD_TOL = 2.0**-5
#: phase 16 (e): the SSD at the published chunk of 128: b, s, heads, head
#: dim, state, and the float32 bound of the card against the CPU
SSD_SHAPE, SSD_CPU_TOL = (1, 128, 2, 4, 8), 1e-4


def free_cuda(torch) -> None:
    import gc

    gc.collect()
    # cuBLAS's workspaces live in the caching allocator: a small one left in
    # a large segment keeps the whole segment reserved
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def train_family_arch(torch, arch: str, layers, smi: str) -> tuple[dict, dict, dict]:
    """Phase 16 (a)/(b): ``arch`` at its published width (``layers`` deep,
    None: all) trained :data:`FAMILY_TRAIN_STEPS` steps through ``Trainer``
    (``TrainConfig()``: adamw, bf16 slots, remat full; P = 4, live-sampled
    stragglers, random bf16 weights from seed 0).  Returns its numbers, its
    launches and K4's row on the run's second step's inputs."""
    import dataclasses

    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.kernels import dsag_update as k4
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def cut(a):
        return dataclasses.replace(get_config(a), num_layers=layers or get_config(a).num_layers)

    free_cuda(torch)
    with mock.patch.object(train_mod, "get_config", cut):
        trn = train_mod.Trainer(train_mod.TrainerOptions(
            arch=arch, smoke=False, steps=FAMILY_TRAIN_STEPS, global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, train_config=TrainConfig(), log_every=10**6,
            engine=EngineConfig(device="cuda", kernel_backend="cuda")))
    cfg, n_params = trn.cfg, trn.model.num_params()
    P, n = trn.gs.num_groups, trn.layout.numel
    # K4's inputs of the second step (its first real gradients against a
    # filled cache), copied to the host so that they add nothing to the peak
    wrapper, k4_inputs = k4.dsag_cache_update, []

    def keep_second(g, c, h, mask):
        if len(k4_inputs) < 2:
            k4_inputs.append(tuple(t.to("cpu") for t in (g, c, h, mask)))
        return wrapper(g, c, h, mask)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(k4, "dsag_cache_update", keep_second):
        hist = trn.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if len(losses) != FAMILY_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"phase 16: {arch}: losses {losses}")
    if counts["dsag_cache_update"] != FAMILY_TRAIN_STEPS or counts["flash_attention"]:
        fail(f"phase 16: {arch}: {counts['dsag_cache_update']} K4 launches in "
             f"{FAMILY_TRAIN_STEPS} "
             f"steps, {counts['flash_attention']} K6 launches")
    host_ms = float(np.mean(hist["step_time"][2:])) * 1e3
    depth = f"{cfg.num_layers} of {get_config(arch).num_layers}" if layers else cfg.num_layers
    print(f"  {cfg.name}: {depth} layers, d_model {cfg.d_model}, {n_params / 1e6:.1f} M "
          f"parameters (flat n = {n}), P = {P}, global batch {TRAIN_BATCH} x {TRAIN_SEQ}, adamw, "
          f"bf16 slots, remat full ({smi}): losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"host {host_ms:.1f} ms per step (steps 2-{FAMILY_TRAIN_STEPS - 1}), run wall "
          f"{wall:.2f} s; "
          f"peak memory {peak / 2**30:.2f} GiB ({peak / n_params:.1f} B per parameter); K4 "
          f"launches {counts['dsag_cache_update']} = steps at [{P}, {n}] bf16, K6 0")
    # K4 on those inputs: bit-equal to its plain twin, timed beside its bound
    # (not counted)
    del trn
    free_cuda(torch)
    inputs = tuple(t.to("cuda") for t in k4_inputs[1])
    del k4_inputs
    row = check_dsag_update(torch, P, n, torch.bfloat16, None, inputs=inputs, plain_reps=2)
    del inputs
    free_cuda(torch)
    res = {"layers": cfg.num_layers, "params": n_params, "numel": n, "losses": losses,
           "host_ms_per_step": host_ms, "wall_s": wall, "peak_bytes": peak,
           "k4_launches": counts["dsag_cache_update"]}
    return res, {"dsag_cache_update": counts["dsag_cache_update"]}, row


def indexing_moe(torch, moe_mod):
    """``moe_mod``'s ``_Dispatch``/``_Combine`` as plain indexing, whose
    autograd backward is an accumulating ``index_put`` (the port's MoE
    before its gather pair): the comparison of phase 16 (c)."""

    def pad(a):
        return torch.cat([a, a.new_zeros((a.shape[0], 1) + a.shape[2:])], dim=1)

    def dispatch(tokens, src_of_slot, slot_of_pair):
        xi = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
        return pad(tokens)[xi, src_of_slot]

    def combine(y_flat, gates, slot_of_pair, src_of_slot, pair_of_slot):
        nx, t, k = gates.shape
        xi = torch.arange(nx, device=y_flat.device)[:, None]
        y_pairs = pad(y_flat)[xi, slot_of_pair].reshape(nx, t, k, -1)
        return (y_pairs * gates[..., None]).sum(dim=2)

    return (mock.patch.object(moe_mod._Dispatch, "apply", dispatch),
            mock.patch.object(moe_mod._Combine, "apply", combine))


def layer_forward_backward(torch, arch: str, smi: str) -> dict:
    """Phase 16 (c): ``arch``'s embedding and one block at its published
    width in bf16 (random weights from seed 0): ``Model.train_loss`` over
    8 x 128 tokens (pixtral: after 256 stub image embeddings) and
    ``torch.autograd.grad`` of every parameter, twice (bit-equal); MoE
    models once more with the indexing form, within :data:`MOE_BWD_TOL`."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import _leaves

    free_cuda(torch)
    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    leaves = [t.requires_grad_(True) for _, t in _leaves(params)]
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    batch = {k: torch.as_tensor(v[0], device="cuda") for k, v in next(make_batch_iterator(
        cfg, 1, TRAIN_BATCH, TRAIN_SEQ + n_img, seed=0)).items()}

    def grads():
        loss = model.train_loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    loss, first = grads()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss2, second = grads()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    k6 = launch_counts()["flash_attention"]
    if not bool(torch.isfinite(loss)) or not all(bool(torch.isfinite(g).all()) for g in first):
        fail(f"phase 16 (c): {arch}: a non-finite loss ({float(loss)}) or gradient")
    same = torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(first, second))
    if not same or k6:
        fail(f"phase 16 (c): {arch}: two backward runs differ ({not same}) or K6 ran ({k6})")
    del second
    out = {"params": model.num_params(), "loss": float(loss), "ms_fwd_bwd": ms,
           "peak_bytes": peak, "bit_equal_runs": True}
    worst = None
    if cfg.num_experts:
        patches = indexing_moe(torch, moe_mod)
        with patches[0], patches[1]:
            _, plain = grads()
        worst = 0.0
        for (name, _), a, b in zip(_leaves(params), first, plain):
            scale = float(b.abs().max())
            err = float((a.float() - b.float()).abs().max())
            if err > MOE_BWD_TOL * scale:
                fail(f"phase 16 (c): {arch}: {name}'s gradient through the gather pair differs "
                     f"from the indexing form's by {err:.3e} (|g| <= {scale:.3e})")
            worst = max(worst, err / max(scale, 1e-30))
        del plain
        out["gather_vs_indexing_max_rel"] = worst
    what = (f"the gather pair against the indexing form within {worst:.3e} of each leaf's "
            f"largest value (tolerance {MOE_BWD_TOL}); " if worst is not None else "")
    print(f"  (c) {cfg.name}: embedding + 1 of {get_config(arch).num_layers} layers, "
          f"{out['params'] / 1e9:.3f} B parameters, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens"
          f"{f' after {n_img} image embeddings' if n_img else ''} ({smi}): loss {float(loss):.4f}, "
          f"gradients finite, two runs bit-equal; {what}{ms:.1f} ms per forward + backward; "
          f"peak memory {peak / 2**30:.2f} GiB; K6 0")
    del first, leaves, params, model
    free_cuda(torch)
    return out


def smoke_train_card_vs_cpu(torch, arch: str, traces) -> dict:
    """Phase 16 (d): ``arch``'s smoke config in float32, sgd,
    :data:`FAMILY_TRAIN_STEPS` ``Trainer`` steps on replayed traces, on the
    card (K4) and on the CPU (plain): the streams equal, the losses and the final parameters' relative RMS
    difference within :data:`TRAIN_CHECK_RTOL`, K4 once per step on the
    card."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import Trainer, TrainerOptions

    tc = TrainConfig(optimizer="sgd", learning_rate=1e-2, dsag_cache_dtype="float32")
    runs, k4 = {}, {}
    state0 = None
    for dev, backend in (("cpu", "torch"), ("cuda", "cuda")):
        trn = Trainer(TrainerOptions(arch=arch, dtype="float32", steps=FAMILY_TRAIN_STEPS,
                                     global_batch=8, seq_len=64, traces=traces, scenario=0,
                                     simulate_stragglers=False, train_config=tc,
                                     log_every=10**6,
                                     engine=EngineConfig(device=dev, kernel_backend=backend)))
        if state0 is None:
            state0 = trn.init_state()
        else:
            trn.init_state = lambda: state_to(torch, state0, dev)
        reset_launch_counts()
        runs[dev] = (trn.run(), trn.state["params"].cpu())
        k4[dev] = launch_counts()["dsag_cache_update"]
    (hc, pc), (hp, pp) = runs["cuda"], runs["cpu"]
    for f in ("mask_stream", "flush_stream", "evict_stream", "xi", "mask_count"):
        if not np.array_equal(np.asarray(hc[f]), np.asarray(hp[f])):
            fail(f"phase 16 (d): {arch}: the card's {f} differs from the CPU's")
    rel = float(np.max(np.abs(np.asarray(hc["loss"]) / np.asarray(hp["loss"]) - 1)))
    # the final parameters' relative RMS difference, as the port's trainer
    # tests hold them (tests/test_torch_train_lm.py); the largest element's
    # difference beside it, printed
    prel = float(torch.linalg.norm(pc - pp) / torch.linalg.norm(pp))
    pmax = float((pc - pp).abs().max() / pp.abs().max())
    if not np.isfinite(hc["loss"]).all() or rel > TRAIN_CHECK_RTOL or prel > TRAIN_CHECK_RTOL:
        fail(f"phase 16 (d): {arch}: losses differ by rtol {rel}, final parameters by a "
             f"relative RMS of {prel} (tolerance {TRAIN_CHECK_RTOL})")
    if k4["cuda"] != FAMILY_TRAIN_STEPS or k4["cpu"]:
        fail(f"phase 16 (d): {arch}: K4 launches card {k4['cuda']}, CPU {k4['cpu']}")
    return {"loss_rtol": rel, "params_rel_rms": prel, "params_max_rel": pmax, "k4": k4["cuda"]}


def ssd_full_chunk_on_card(torch) -> dict:
    """Phase 16 (e): ``_ssd_chunked`` at the published chunk of 128 on inputs
    whose cumulative decay passes float32's 88.7 (A = -1, dt = softplus of
    normals, seed 0): every gradient finite on the card, and equal to the
    CPU port's within :data:`SSD_CPU_TOL`."""
    from repro_torch.models import ssm as ssm_mod

    b, s, h, p, n = SSD_SHAPE
    rng = np.random.default_rng(0)
    host = {"x": rng.normal(size=(b, s, h, p)), "dt": np.log1p(np.exp(rng.normal(size=(b, s, h)))),
            "A": -np.ones(h), "B": rng.normal(size=(b, s, n)), "C": rng.normal(size=(b, s, n))}
    w = rng.normal(size=(b, s, h, p))
    decay = float(np.cumsum(host["dt"] * -host["A"], axis=1).max())
    if decay <= 88.72:
        fail(f"phase 16 (e): the cumulative decay {decay} does not pass 88.7")
    grads = {}
    for dev in ("cpu", "cuda"):
        args = [torch.tensor(host[k], dtype=torch.float32, device=dev, requires_grad=True)
                for k in ("x", "dt", "A", "B", "C")]
        y, st = ssm_mod._ssd_chunked(*args, 128)
        loss = (y * torch.tensor(w, dtype=torch.float32, device=dev)).sum() + st.sum()
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, args)]
    worst = 0.0
    for name, a, c in zip(("x", "dt", "A", "B", "C"), grads["cuda"], grads["cpu"]):
        scale = float(c.abs().max())
        if not bool(torch.isfinite(a).all()) or not torch.allclose(
                a, c, rtol=SSD_CPU_TOL, atol=SSD_CPU_TOL * scale):
            fail(f"phase 16 (e): the SSD's gradient of {name} on the card is not finite or "
                 f"differs from the CPU's by {float((a - c).abs().max()):.3e} "
                 f"(|CPU| <= {scale:.3e})")
        worst = max(worst, float((a - c).abs().max()) / scale)
    print(f"  (e) the SSD at chunk 128 (cumulative decay {decay:.1f} > 88.7): the gradients of "
          f"x, dt, A, B, C finite on the card and within {worst:.2e} of the CPU port's largest "
          f"(tolerance {SSD_CPU_TOL})")
    return {"max_decay": decay, "card_vs_cpu_max_rel": worst}


def run_family_training(torch) -> tuple[dict, dict, list]:
    """Phase 16: train the MoE, MLA, SSM and hybrid families on the card.
    Returns the phase's numbers, its K4 launches and K4's rows at the
    trained models' ``[4, n]``."""
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out: dict = {}
    launches = {"dsag_cache_update": 0}
    rows = []
    t0 = time.perf_counter()
    for arch, layers in FAMILY_TRAIN_ARCHS.items():
        res, n, row = train_family_arch(torch, arch, layers, smi)
        out[arch] = res
        launches["dsag_cache_update"] += n["dsag_cache_update"]
        rows.append(row)
    print(f"  (a), (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for arch in FAMILY_LAYER_ARCHS:
        out[arch] = layer_forward_backward(torch, arch, smi)
    print(f"  (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cl = make_heterogeneous_cluster(4, seed=3, burst_rate=0.0)
    traces = sample_fleet(cl, 1, 400, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    smoke = {arch: smoke_train_card_vs_cpu(torch, arch, traces)
             for arch in ("grok-1-314b", "deepseek-v2-236b", "mamba2-370m", "zamba2-2.7b")}
    for arch, r in smoke.items():
        launches["dsag_cache_update"] += r["k4"]
    print("  (d) smoke configs, float32, sgd, " + "; ".join(
        f"{a}: losses within rtol {r['loss_rtol']:.2e}, final parameters' relative RMS "
        f"{r['params_rel_rms']:.2e} (largest element {r['params_max_rel']:.2e} of the largest), "
        f"K4 {r['k4']}" for a, r in smoke.items())
        + f" (tolerance {TRAIN_CHECK_RTOL}); took {time.perf_counter() - t0:.1f} s")
    out["smoke_card_vs_cpu"] = smoke
    out["ssd_full_chunk"] = ssd_full_chunk_on_card(torch)
    return out, launches, rows


# ---------------------------------------------------------------------------
# phase 17: the mesh path
# ---------------------------------------------------------------------------

#: phase 17: the (data, model) mesh of four ranks on the one card
MESH_SHAPE = (2, 2)
MESH_ARCH = "qwen1.5-0.5b"
#: (a)/(b): global batch (sequences over the P = 2 groups), tokens, steps;
#: the masks of the two steps (group 1 misses the second)
MESH_TRAIN = (4, 256)
MESH_MASKS = ((True, True), (True, False))
#: (a): the bf16 trainer's decoder layers (of 24), cut to keep the script
#: in its time (at full depth its two steps took 17 s per rank)
MESH_TRAIN_BF16_LAYERS = 12
#: (c): prompts, prompt length, generated tokens (prefill + 4 decode steps)
MESH_SERVE = (4, 512, 5)
#: (c): the bf16 server's decoder layers (of 24), cut to make room for
#: phase 19 in the script's time
MESH_SERVE_BF16_LAYERS = 4
#: the bounds of each comparison with the unsharded port (PERF.md states
#: them and why, written before the first run): bf16 at full depth sums the
#: TP partial products in bf16 over 48 reduction sites (24 at the 12 layers
#: run now) and adamw normalizes each gradient element; float32 at 2 layers
#: differs by float32 rounding
MESH_TOL = {"bf16_loss": 1e-2, "bf16_params": 2e-2, "bf16_logits": SERVE_TOL["k6_vs_plain"],
            "f32_loss": 1e-5, "f32_params": 1e-4, "f32_logits": 1e-4}


def mesh_train_config(dtype: str):
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(dsag=True, dsag_groups="dp", fsdp=True,
                       dsag_cache_dtype="bfloat16" if dtype == "bfloat16" else "float32")


def _cut_config(layers):
    from repro_torch.configs import get_config

    def cut(arch):
        cfg = get_config(arch)
        return cfg if layers is None else __import__("dataclasses").replace(cfg, num_layers=layers)

    return cut


def mesh_batches(torch, cfg, groups: int, steps: int = len(MESH_MASKS)):
    from repro_torch.data import make_batch_iterator

    it = make_batch_iterator(cfg, groups, MESH_TRAIN[0], MESH_TRAIN[1], seed=0)
    return [next(it) for _ in range(steps)]


def mesh_unsharded_train(torch, dtype: str, layers, path: str) -> list:
    """(a)/(b)'s yardstick: the unsharded port's step (P = 2, the same
    config, inputs and masks) on the card; its final parameters (each leaf in
    its dtype) saved to ``path``; each step's metrics."""
    from repro_torch.core.dsag_pjit import GroupSpec, init_train_state, make_train_step
    from repro_torch.models import build_model

    cfg = __import__("dataclasses").replace(_cut_config(layers)(MESH_ARCH), dtype=dtype)
    tc = mesh_train_config(dtype)
    model = build_model(cfg)
    gs = GroupSpec(2, ())
    step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                           backend="cuda", layout=model.layout)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(model.layout.flatten(model.init(gen)), tc, gs, model.layout)
    out = []
    for batch, mask in zip(mesh_batches(torch, cfg, 2), MESH_MASKS):
        m = torch.tensor(mask, device="cuda")
        state, met = step(state, {k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                          m, torch.zeros_like(m), torch.zeros_like(m))
        out.append({k: v.detach().cpu().numpy().tolist() for k, v in met.items()})
    torch.save({k: v.cpu() for k, v in _paths(model.layout.tree(state["params"], cast=True))},
               path)
    del state
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def mesh_train_rank(dtype: str, layers, want_path: str) -> dict:
    """One rank of (a)/(b): ``Trainer(TrainerOptions(mesh=))`` builds the
    mesh run (placing, degathering, the step); its step runs the phase's
    inputs and masks, the second step under ``count_cost``.  Returns the
    rank's metrics, launches, collectives, K4's local shape and its
    parameters' squared distance from the unsharded run's (each element
    counted once over the ranks that hold it)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch.launch.train as train_mod
    from repro_torch.analysis.cost import count_cost
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding
    from repro_torch.models.layers import get_path

    mesh = make_test_mesh(MESH_SHAPE, device_type="cuda")
    try:
        with mock.patch.object(train_mod, "get_config", _cut_config(layers)):
            trn = train_mod.Trainer(train_mod.TrainerOptions(
                arch=MESH_ARCH, smoke=False, global_batch=MESH_TRAIN[0], seq_len=MESH_TRAIN[1],
                dtype=dtype, mesh=mesh, train_config=mesh_train_config(dtype),
                log_every=10**6, engine=EngineConfig(device="cuda", kernel_backend="cuda")))
        state = trn.init_state()
        layouts = trn.step_fn.layouts
        dev = trn.device
        batches = mesh_batches(torch, trn.cfg, trn.gs.num_groups)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        metrics, seconds, cost = [], [], None
        for i, (batch, mask) in enumerate(zip(batches, MESH_MASKS)):
            m = torch.tensor(mask, device=dev)
            args = (trn.batch_on_device(batch), m, torch.zeros_like(m), torch.zeros_like(m))
            t0 = time.perf_counter()
            if i == 1:
                held = {}
                cost = count_cost(lambda: held.update(out=trn.step_fn(state, *args)))
                state, met = held.pop("out")
            else:
                state, met = trn.step_fn(state, *args)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: v.detach().cpu().numpy().tolist() for k, v in met.items()})
            if torch.distributed.get_rank() == 0:
                print(f"      rank 0: step {i + 1} {seconds[-1]:.2f} s", flush=True)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # the parameters against the unsharded run's: this rank's shard of
        # each leaf, weighted by how many ranks hold it
        want = torch.load(want_path)
        mine = layouts.store.tree(state["params"], cast=True)
        d2 = n2 = 0.0
        for x in layouts.store.leaves:
            spec = get_path(layouts.specs, x.path)
            w = sharding.local_shard(want["/".join(x.path)], spec, mesh).to(dev).float()
            rep = sharding.replication(spec, mesh)
            d2 += float(((get_path(mine, x.path).float() - w) ** 2).sum()) / rep
            n2 += float((w ** 2).sum()) / rep
        return {"metrics": metrics, "seconds": seconds, "counts": counts, "peak": peak,
                "k4_shape": [1, layouts.tp.numel], "store_numel": layouts.store.numel,
                "coll_counts": cost.coll_counts, "coll_wire": cost.coll_wire_bytes,
                "d2": d2, "n2": n2, "rank": torch.distributed.get_rank()}
    finally:
        sharding.set_mesh(None)


def mesh_serve_rank(dtype: str | None, layers, batch, num_tokens: int) -> dict:
    """One rank of (c): ``Server(mesh=)`` generates; every K6 call is held on
    its own inputs against the plain attention (:func:`k6_violations`, as
    phase 14 holds K6 on real activations; those comparisons launch
    nothing); the prefill's logits kept."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch.launch.serve as serve_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import sharding

    mesh = make_test_mesh(MESH_SHAPE, device_type="cuda")
    try:
        with mock.patch.object(serve_mod, "get_config", _cut_config(layers)):
            srv = serve_mod.Server(MESH_ARCH, smoke=False, max_len=MESH_SERVE[1] + num_tokens + 8,
                                   mesh=mesh, dtype=dtype)
        real, calls = attn_mod.flash_attention_bshd, []

        def held(q, k, v, *, causal=True):
            out = real(q, k, v, causal=causal)
            strict, wide, diff, _ = k6_violations(torch, q, k, v, out, causal)
            calls.append((list(q.shape), list(k.shape), not wide and bool(
                torch.isfinite(out).all()), float(diff.max()), strict))
            return out

        kept = {}
        prefill = srv.model.prefill

        def keep_logits(*a, **kw):
            logits, cache = prefill(*a, **kw)
            kept["logits"] = sharding.full(logits).float().cpu()
            return logits, cache

        reset_launch_counts()
        with mock.patch.object(attn_mod, "flash_attention_bshd", held), \
                mock.patch.object(srv.model, "prefill", keep_logits):
            toks = srv.generate(batch, num_tokens)
        torch.cuda.synchronize()
        counts = launch_counts()
        return {"tokens": toks.cpu().numpy(), "logits": kept["logits"].numpy(), "calls": calls,
                "counts": counts, "timings": srv.timings, "max_len": srv.max_len,
                "peak": torch.cuda.max_memory_allocated()}
    finally:
        sharding.set_mesh(None)


def mesh_unsharded_serve(torch, dtype, layers, batch, num_tokens: int) -> dict:
    """(c)'s yardstick: the unsharded ``Server`` (K6) on the same prompts."""
    import repro_torch.launch.serve as serve_mod

    with mock.patch.object(serve_mod, "get_config", _cut_config(layers)):
        srv = serve_mod.Server(MESH_ARCH, smoke=False, max_len=MESH_SERVE[1] + num_tokens + 8,
                               dtype=dtype)
    kept, prefill = {}, srv.model.prefill

    def keep_logits(*a, **kw):
        logits, cache = prefill(*a, **kw)
        kept["logits"] = logits.float().cpu()
        return logits, cache

    with mock.patch.object(srv.model, "prefill", keep_logits):
        toks = srv.generate(batch, num_tokens)
    out = {"tokens": toks.cpu().numpy(), "logits": kept["logits"].numpy()}
    del srv
    return out


def run_mesh(torch, smi: str) -> tuple[dict, dict, list]:
    """Phase 17: the mesh path (see the module docstring).  Returns its
    numbers, every rank's K4 and K6 launches, and K4's and K6's rows at the
    ranks' local shapes."""
    import tempfile

    from repro_torch.launch.mesh import RankPool
    from repro_torch.launch.serve import stub_batch
    from repro_torch.configs import get_config

    res: dict = {"mesh": list(MESH_SHAPE), "card": smi}
    launches = {"dsag_cache_update": 0, "flash_attention": 0}
    cfg = get_config(MESH_ARCH)
    b, s, n_tok = MESH_SERVE
    prompts = stub_batch(cfg, b, s, seed=7)
    # the ranks start (import, join the group) beside the unsharded runs
    # below; until their first task each holds only its CUDA context
    t0 = time.perf_counter()
    pool = RankPool(MESH_SHAPE[0] * MESH_SHAPE[1], "cuda", timeout=600)
    res["pool_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh") as tmp, pool:
        runs = {"a": ("bfloat16", MESH_TRAIN_BF16_LAYERS), "b": ("float32", 2)}
        serve_runs = {"a": ("bfloat16", MESH_SERVE_BF16_LAYERS), "b": ("float32", 2)}
        want_train, want_serve = {}, {}
        t0 = time.perf_counter()
        for label, (dtype, layers) in runs.items():
            free_cuda(torch)
            want_train[label] = mesh_unsharded_train(torch, dtype, layers, f"{tmp}/{label}.pt")
        for label, (dtype, layers) in serve_runs.items():
            free_cuda(torch)
            want_serve[label] = mesh_unsharded_serve(torch, dtype, layers, prompts, n_tok)
        free_cuda(torch)
        res["unsharded_s"] = time.perf_counter() - t0
        print(f"  {pool.world} ranks on cuda:0 over {pool.backend} "
              f"(started in {res['pool_s']:.1f} s; the unsharded runs took "
              f"{res['unsharded_s']:.1f} s)")
        for label, (dtype, layers) in runs.items():
            t0 = time.perf_counter()
            got = pool.run(mesh_train_rank, dtype, layers, f"{tmp}/{label}.pt")
            res[f"train_{label}"] = mesh_train_check(label, dtype, layers, got,
                                                     want_train[label], launches, smi)
            res[f"train_{label}"]["phase_s"] = time.perf_counter() - t0
        for label, (dtype, layers) in serve_runs.items():
            t0 = time.perf_counter()
            got = pool.run(mesh_serve_rank, dtype, layers, prompts, n_tok)
            res[f"serve_{label}"] = mesh_serve_check(torch, label, dtype, layers, got,
                                                     want_serve[label], launches)
            res[f"serve_{label}"]["phase_s"] = time.perf_counter() - t0
    # the kernels at the ranks' local shapes, timed here (not counted)
    rng = np.random.default_rng(17)
    free_cuda(torch)
    n_tp = res["train_a"]["k4_shape"][1]
    rows = [check_dsag_update(torch, 1, n_tp, torch.bfloat16, rng, plain_reps=2),
            check_flash(torch, b // MESH_SHAPE[0], cfg.num_heads // MESH_SHAPE[1], s, s,
                        cfg.resolved_head_dim, rng, kvh=cfg.num_kv_heads // MESH_SHAPE[1])]
    free_cuda(torch)
    return res, launches, rows


def mesh_train_check(label: str, dtype: str, layers, got: list, want: list, launches: dict,
                     smi: str) -> dict:
    """Hold one training run's ranks against the unsharded run (phase 17)."""
    tol_loss, tol_params = MESH_TOL[f"{'bf16' if dtype == 'bfloat16' else 'f32'}_loss"], \
        MESH_TOL[f"{'bf16' if dtype == 'bfloat16' else 'f32'}_params"]
    r0 = got[0]
    worst = 0.0
    for step, (g, w) in enumerate(zip(r0["metrics"], want)):
        for r in got[1:]:  # the metrics are the same on every rank
            if r["metrics"][step] != g:
                fail(f"phase 17 ({label}): rank {r['rank']}'s metrics differ from rank 0's")
        if g["xi"] != w["xi"] or g["mask_count"] != w["mask_count"]:
            fail(f"phase 17 ({label}): step {step}: xi/mask count {g['xi']}/{g['mask_count']} "
                 f"!= {w['xi']}/{w['mask_count']}")
        for key in ("loss", "per_group_loss"):
            a, bb = np.asarray(g[key]), np.asarray(w[key])
            rel = float(np.max(np.abs(a - bb) / np.abs(bb)))
            worst = max(worst, rel)
            if not np.all(np.isfinite(a)) or rel > tol_loss:
                fail(f"phase 17 ({label}): step {step} {key} {a} against {bb} (rel {rel:.3g} "
                     f"> {tol_loss})")
    params_rms = (sum(r["d2"] for r in got) / sum(r["n2"] for r in got)) ** 0.5
    if not params_rms <= tol_params:
        fail(f"phase 17 ({label}): parameters' relative RMS {params_rms:.3g} > {tol_params}")
    k4 = [r["counts"]["dsag_cache_update"] for r in got]
    k6 = [r["counts"]["flash_attention"] for r in got]
    if k4 != [len(MESH_MASKS)] * len(got) or any(k6):
        fail(f"phase 17 ({label}): K4 launches per rank {k4} (want one per step), K6 {k6}")
    launches["dsag_cache_update"] += sum(k4)
    depth = "full depth" if layers is None else f"{layers} layers"
    print(f"  ({label}) train {MESH_ARCH} {dtype}, {depth} ({smi}): losses "
          f"{[round(m['loss'], 6) for m in r0['metrics']]} (unsharded "
          f"{[round(m['loss'], 6) for m in want]}; worst rel {worst:.3g} <= {tol_loss}); "
          f"per-group {r0['metrics'][1]['per_group_loss']}; xi "
          f"{[m['xi'] for m in r0['metrics']]}; parameters' relative RMS {params_rms:.3g} <= "
          f"{tol_params}; K4 {sum(k4)} launches ({k4} per rank) over the local "
          f"{r0['k4_shape']} slots (store n = {r0['store_numel']}); step s per rank "
          f"{[round(x, 3) for x in r0['seconds']]} (the second counted); peak per rank "
          f"{max(r['peak'] for r in got) / 2**30:.2f} GiB")
    wire = r0["coll_wire"]
    print(f"      collectives of step 2 per rank (count_cost): "
          + ", ".join(f"{k} x{r0['coll_counts'][k]} {wire[k] / 2**20:.2f} MiB"
                      for k in sorted(wire))
          + f"; total {sum(wire.values()) / 2**20:.2f} MiB on the wire")
    return {"losses": [m["loss"] for m in r0["metrics"]], "unsharded": [m["loss"] for m in want],
            "per_group": [m["per_group_loss"] for m in r0["metrics"]],
            "xi": [m["xi"] for m in r0["metrics"]], "worst_loss_rel": worst,
            "params_rel_rms": params_rms, "k4_launches": k4, "k4_shape": r0["k4_shape"],
            "step_s": [r["seconds"] for r in got], "peak_bytes": [r["peak"] for r in got],
            "coll_counts": r0["coll_counts"], "coll_wire_bytes": wire}


def mesh_serve_check(torch, label: str, dtype: str, layers, got: list, want: dict,
                     launches: dict) -> dict:
    """Hold one serving run's ranks against the unsharded server (phase 17)."""
    key = "bf16" if dtype == "bfloat16" else "f32"
    toks = got[0]["tokens"]
    for r in got[1:]:
        if not np.array_equal(r["tokens"], toks):
            fail(f"phase 17 ({label}): the ranks returned different tokens")
    # each data rank's prefill logits: its slice of the batch
    per = MESH_SERVE[0] // MESH_SHAPE[0]
    logits = np.concatenate([got[d * MESH_SHAPE[1]]["logits"] for d in range(MESH_SHAPE[0])])
    max_rel, norm_rel = logit_diff(torch, torch.as_tensor(logits), torch.as_tensor(want["logits"]))
    if not max_rel <= MESH_TOL[f"{key}_logits"]:
        fail(f"phase 17 ({label}): prefill logits {max_rel:.3g} > {MESH_TOL[key + '_logits']}")
    agree = float(np.mean(toks == want["tokens"]))
    if key == "f32" and agree != 1.0:
        fail(f"phase 17 ({label}): float32 tokens differ from the unsharded server's")
    calls = [c for r in got for c in r["calls"]]
    bad = [c for c in calls if not c[2]]
    if bad:
        fail(f"phase 17 ({label}): {len(bad)} K6 calls outside tolerance: {bad[:2]}")
    k6 = [r["counts"]["flash_attention"] for r in got]
    L = len(calls) // len(got)
    if k6 != [L] * len(got) or not L:
        fail(f"phase 17 ({label}): K6 launches per rank {k6}, held calls {len(calls)}")
    launches["flash_attention"] += sum(k6)
    depth = "full depth" if layers is None else f"{layers} layers"
    t = got[0]["timings"]
    print(f"  ({label}) serve {MESH_ARCH} {dtype}, {depth}: {MESH_SERVE[0]} x {MESH_SERVE[1]} "
          f"prompts ({per} per data rank), {MESH_SERVE[2]} tokens; prefill logits against the "
          f"unsharded server {max_rel:.3g} max / {norm_rel:.3g} norm (<= "
          f"{MESH_TOL[key + '_logits']}); tokens agree {agree:.3f}; K6 {sum(k6)} launches "
          f"({k6} per rank) on local q {calls[0][0]} k {calls[0][1]}, each held against the "
          f"plain attention within k6_within_tolerance widened by the float32 score "
          f"rounding (worst |K6 - plain| {max(c[3] for c in calls):.3g}; outside the strict "
          f"tolerance {sum(c[4] for c in calls)} outputs); prefill {t['prefill']:.3f} s, "
          f"decode {t['decode']:.3f} s (rank 0)")
    return {"logits_max_rel": max_rel, "logits_norm_rel": norm_rel, "token_agreement": agree,
            "k6_launches": k6, "k6_local_q": calls[0][0], "k6_local_k": calls[0][1],
            "k6_worst": max(c[3] for c in calls), "timings": t,
            "peak_bytes": [r["peak"] for r in got]}


# ---------------------------------------------------------------------------
# phase 18: the reference's production DSAG layouts on a mesh
# ---------------------------------------------------------------------------

#: the reference's production training settings (``launch/dryrun.py``
#: ``default_train_config``), and its above-50 B configuration (layout (a))
PROD_TC = dict(fsdp=True, dsag=True, remat="full")
LAYOUT_A = dict(PROD_TC, optimizer="adafactor", dsag_cache_dtype="int8", dsag_groups="zero",
                dsag_num_groups=2)
#: phase 18's bf16 run's decoder layers (of 24), cut to make room for phase
#: 19 in the script's time
LAYOUT_BF16_LAYERS = 4
#: phase 18's runs of qwen1.5-0.5b at full width: label -> (mesh shape,
#: TrainConfig fields, groups, dtype, decoder layers (None: all 24))
LAYOUT_RUNS = {
    "a bf16": ((2, 2), LAYOUT_A, 2, "bfloat16", LAYOUT_BF16_LAYERS),
    "a f32": ((2, 2), LAYOUT_A, 2, "float32", 2),
    "b pod": ((2, 2, 1), dict(PROD_TC, dsag_cache_dtype="int8", dsag_groups="pod"), 2,
              "float32", 2),
    "c none": ((2, 2), dict(PROD_TC, dsag_cache_dtype="float32", dsag_groups="none"), 1,
               "float32", 2),
    "c no dsag": ((2, 2), dict(PROD_TC, dsag=False, dsag_groups="none"), 1, "float32", 2),
}
#: the Tier-2 bits of the two steps by group count (group 1 misses the second)
LAYOUT_MASKS = {2: MESH_MASKS, 1: ((True,), (True,))}
#: an int8 slot element's absolute slack beside its steps, relative to the
#: slots' largest magnitude
INT8_ATOL = 1e-5
#: the int8 slot leaves whose gradient goes through the attention scores'
#: softmax (the embedding, ln1, q and k): near one-hot at random init, so
#: float32 rounding moves a few of their elements by more than a step; at
#: most this share of each of them may lie beyond one step after the first
#: step, none of any other leaf's (layouts_states_check)
INT8_SCORE_PATH = ("embed/tok", "ln1/scale", "attn/wq", "attn/wk", "attn/bq", "attn/bk")
INT8_SCORE_PATH_SHARE = 1e-2
#: (d): the run that checkpoints after its two compared steps, and the
#: Tier-2 bits and flushes of the two steps it then takes
CKPT_RUN = "a f32"
CKPT_MASKS = ((False, True), (True, False))
CKPT_FLUSH = ((False, False), (False, True))


def _layout(label: str):
    """A phase-18 or phase-19 (c) run: ``(mesh shape, TrainConfig, groups,
    dtype, arch, the config function that cuts it, a depth label, phase)``."""
    from repro_torch.configs.base import TrainConfig

    if label in MOE_LAYOUT_RUNS:
        shape, fields, groups, dtype, arch = MOE_LAYOUT_RUNS[label]
        return (shape, TrainConfig(**fields), groups, dtype, arch, moe_reduced_config,
                "reduced widths", 19)
    shape, fields, groups, dtype, layers = LAYOUT_RUNS[label]
    depth = "full depth" if layers is None else f"{layers} layers"
    return shape, TrainConfig(**fields), groups, dtype, MESH_ARCH, _cut_config(layers), depth, 18


def _dsag_state(tree) -> dict:
    """The DSAG part of an unsharded train-state tree (the checkpoint's
    paths), on the host: ``filled``, ``pending_valid`` and the int8 slots'
    payloads and scales."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    return {path: leaf.detach().cpu() for path, leaf in _flatten_with_paths(tree)
            if path.startswith("['dsag']") and ("['filled']" in path or "['pending_valid']" in path
                                               or "[<flat index" in path)}


def layouts_unsharded(torch, label: str, path: str) -> dict:
    """A phase-18 run's yardstick: the unsharded port's step on the card
    (the same config, groups, inputs and masks); its final parameters saved
    to ``path`` and, in float32, its DSAG state after the first step to
    ``path.state1``, an MoE's routes (per step, every ``route`` call's) to
    ``path.routes``; each step's metrics."""
    import dataclasses

    from repro_torch.checkpoint.checkpoint import train_state_tree
    from repro_torch.core.dsag_pjit import GroupSpec, init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    _, tc, groups, dtype, arch, cut, _, _ = _layout(label)
    cfg = dataclasses.replace(cut(arch), dtype=dtype)
    model = build_model(cfg)
    gs = GroupSpec(groups, ())
    step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                           backend="cuda", layout=model.layout)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(model.layout.flatten(model.init(gen)), tc, gs, model.layout)
    out, rec = [], RouteRecorder(moe_mod)
    with mock.patch.object(moe_mod, "route", rec):
        for batch, mask in zip(mesh_batches(torch, cfg, groups), LAYOUT_MASKS[groups]):
            m = torch.tensor(mask, device="cuda")
            state, met = step(state, {k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                              m, torch.zeros_like(m), torch.zeros_like(m))
            out.append({k: v.detach().cpu().numpy().tolist() for k, v in met.items()})
            rec.step()
            if dtype == "float32" and len(out) == 1:
                torch.save(_dsag_state(train_state_tree(state, model.layout)),
                           path + ".state1")
    torch.save({k: v.cpu() for k, v in _paths(model.layout.tree(state["params"], cast=True))},
               path)
    torch.save(rec.steps, path + ".routes")
    del state
    witness = spread = None
    if label in MOE_LAYOUT_RUNS:
        # the same steps again from parameters one ulp up: the unsharded
        # port's own float32 spread (losses, parameters, int8 slots after the
        # first step), the witness beside MESH_TOL in layouts_train_check
        params = model.layout.flatten(model.init(torch.Generator(device="cuda").manual_seed(0)))
        nudged = init_train_state(torch.nextafter(params, torch.full_like(params, math.inf)),
                                  tc, gs, model.layout)
        del params
        loss_spread = []
        for i, (batch, mask) in enumerate(zip(mesh_batches(torch, cfg, groups),
                                              LAYOUT_MASKS[groups])):
            m = torch.tensor(mask, device="cuda")
            nudged, met = step(nudged, {k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                               m, torch.zeros_like(m), torch.zeros_like(m))
            loss_spread.append(max(float(np.max(np.abs(
                np.asarray(met[k].detach().cpu()) - np.asarray(out[i][k]))
                / np.abs(np.asarray(out[i][k])))) for k in ("loss", "per_group_loss")))
            if i == 0 and tc.dsag_cache_dtype == "int8":
                torch.save(_dsag_state(train_state_tree(nudged, model.layout)), path + ".state1n")
        want = torch.load(path)
        d2 = n2 = 0.0
        for k, v in _paths(model.layout.tree(nudged["params"], cast=True)):
            w = want[k].cuda().float()
            d2 += float(((v.float() - w) ** 2).sum())
            n2 += float((w ** 2).sum())
        spread = {"loss": loss_spread, "params": (d2 / n2) ** 0.5}
        del nudged, want
        if tc.dsag_cache_dtype == "int8":
            witness = int8_one_ulp_witness(torch, path)
    return {"metrics": out, "witness": witness, "spread": spread}


class Int8LaunchChecks:
    """Inside a rank: every K4-int8 launch of the step, one per int8 leaf in
    the slot layout's order, held on every row (``torch.equal``) against
    ``dsag_cache_update_int8_plain``, which phase 3 holds bit-equal to the
    kernel and which launches and counts nothing.  A leaf's row axes come
    from the train state's slot spec (``sharding.dim_axes`` of its payload's
    last dim), not from the step: a leaf with none must launch whole (no
    maxima); a leaf with some must launch split, its maxima must equal the
    shard's plain row maxima MAX-reduced over those axes (so the step
    reduced over them), and its outputs the plain twin's given those
    maxima.  While :attr:`gather` is set, each split launch's rows are also
    gathered whole over those axes (through the host) and held against the
    whole-row plain update.  The checks run outside any ``count_cost``;
    their time is kept apart in :attr:`seconds`."""

    def __init__(self, trn, mesh):
        from repro_torch.models import sharding
        from repro_torch.models.layers import get_path

        L, tc = trn.step_fn.layouts, trn.opts.train_config
        specs = trn.state_specs["dsag"]["cache"]
        self.leaves = [(x.path, tuple(x.shape),
                        sharding.dim_axes(get_path(specs, x.path).q, -1, mesh))
                       for x in L.slot.leaves] if tc.dsag and tc.dsag_cache_dtype == "int8" else []
        self.k = L.rows.stop - L.rows.start
        self.mesh, self.log, self.gather, self.seconds = mesh, [], False, 0.0

    def __enter__(self):
        from repro_torch.kernels import dsag_update as k4

        self._patch = mock.patch.object(k4, "dsag_cache_update_int8",
                                        self._held(k4.dsag_cache_update_int8))
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def _held(self, real):
        def held(*args):
            import torch
            from torch.utils._python_dispatch import _disable_current_modes

            out = real(*args)
            path, shape, axes = self.leaves[len(self.log) % len(self.leaves)]
            t0 = time.perf_counter()
            with _disable_current_modes():
                err = self._hold(torch, args[:7], args[7] if len(args) > 7 else None, out,
                                 shape, axes)
            self.seconds += time.perf_counter() - t0
            self.log.append(("split" if axes else "whole", tuple(args[0].shape),
                             "/".join(path), err, self.gather and bool(axes)))
            return out

        return held

    def _max_over(self, torch, t, axes):
        t = t.cpu()
        for a in axes:
            torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                         group=self.mesh.get_group(a))
        return t

    def _gather(self, torch, t, axes):
        """``t`` [..., b] from every rank along ``axes``, whole along b."""
        t = t.cpu().contiguous()
        for a in reversed(axes):  # the minor axis first
            group = self.mesh.get_group(a)
            parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size(group))]
            torch.distributed.all_gather(parts, t, group=group)
            t = torch.cat(parts, dim=-1)
        return t

    def _hold(self, torch, args, maxima, out, shape, axes) -> str | None:
        from repro_torch.kernels import dsag_update as k4

        g, cq, cs, pq, ps, h, code = args
        b = shape[-1] if shape else 1
        if tuple(g.shape) != (self.k, math.prod(shape) // b, b):
            return f"launched on {tuple(g.shape)}, not on its leaf's {shape}"
        if (maxima is not None) != bool(axes):
            return f"maxima {'given' if maxima is not None else 'absent'}, row axes {axes}"
        if not axes:
            return None
        want_max = self._max_over(torch, torch.stack(k4.dsag_int8_row_max_plain(
            g, cq, cs, pq, ps, code)), axes).to(g.device)
        if not torch.equal(torch.stack(maxima), want_max):
            return f"row maxima not the MAX over {axes}"
        names = ("cache q", "cache scale", "pending q", "pending scale", "h")
        plain = k4.dsag_cache_update_int8_plain(*args, (want_max[0], want_max[1]))
        bad = [n for n, a, w in zip(names, out, plain) if not torch.equal(a, w)]
        if bad:
            return f"{bad} differ from the plain twin's given the maxima"
        if not self.gather:
            return None
        g_, cq_, pq_, h_ = (self._gather(torch, t, axes).to(g.device) for t in (g, cq, pq, h))
        want = k4.dsag_cache_update_int8_plain(g_, cq_, cs, pq_, ps, h_, code)
        got = [self._gather(torch, t, axes).to(g.device) if i in (0, 2, 4) else t
               for i, t in enumerate(out)]
        bad = [n for n, a, w in zip(names, got, want) if not torch.equal(a, w)]
        return f"{bad} differ from the whole-row update on the gathered rows" if bad else None


def layouts_train_rank(label: str, want_path: str, ckpt_dir: str | None = None) -> dict:
    """One rank of a phase-18 run: ``Trainer(TrainerOptions(mesh=))`` builds
    it, its step runs the phase's inputs and masks (the second step under
    ``count_cost``), every K4-int8 launch held (:class:`Int8LaunchChecks`;
    in float32 the second step's split launches also on their gathered
    rows).  Returns the rank's metrics, launches, collectives (by kind and
    by site), seconds per step, peak memory, K4's local shape, the
    parameters' squared distance from the unsharded run's, (float32, int8)
    the DSAG state after the first step against the unsharded port's and,
    with ``ckpt_dir``, (d): :func:`checkpoint_resume` from the state after
    the two steps."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch.launch.train as train_mod
    from repro_torch.analysis.cost import count_cost
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding
    from repro_torch.models.layers import get_path

    free_cuda(torch)  # the last task's cached blocks: the card is shared
    shape, tc, groups, dtype, arch, cut, _, _ = _layout(label)
    int8 = tc.dsag and tc.dsag_cache_dtype == "int8"
    masks = LAYOUT_MASKS[groups]
    mesh = make_test_mesh(shape, device_type="cuda")
    try:
        with mock.patch.object(train_mod, "get_config", cut):
            trn = train_mod.Trainer(train_mod.TrainerOptions(
                arch=arch, smoke=False, global_batch=MESH_TRAIN[0], seq_len=MESH_TRAIN[1],
                dtype=dtype, mesh=mesh, train_config=tc, log_every=10**6,
                checkpoint_dir=ckpt_dir, restore=ckpt_dir is not None,
                engine=EngineConfig(device="cuda", kernel_backend="cuda")))
        state = trn.init_state()
        L = trn.step_fn.layouts
        dev = trn.device
        batches = [trn.batch_on_device(b) for b in mesh_batches(
            torch, trn.cfg, groups, len(masks) + (len(CKPT_MASKS) if ckpt_dir else 0))]
        metrics, seconds, check_s, states, cost = [], [], [], {}, None
        # an MoE takes the unsharded run's routes (its own are counted)
        forcer = RouteForcer(moe_mod, rank_routes(torch.load(want_path + ".routes"), groups, L)) \
            if label in MOE_LAYOUT_RUNS else None
        with Int8LaunchChecks(trn, mesh) as checks, mock.patch.object(
                moe_mod, "route", forcer or moe_mod.route):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            for i, mask in enumerate(masks):
                m = torch.tensor(mask, device=dev)
                args = (batches[i], m, torch.zeros_like(m), torch.zeros_like(m))
                # the whole-row comparison on gathered rows: phase 18's (its
                # host gathers of every split row are too slow for phase 19)
                checks.gather = (dtype == "float32" and i == len(masks) - 1
                                 and label not in MOE_LAYOUT_RUNS)
                t0, c0 = time.perf_counter(), checks.seconds
                if i == 1:
                    held = {}
                    cost = count_cost(lambda: held.update(out=trn.step_fn(state, *args)))
                    state, met = held.pop("out")
                else:
                    state, met = trn.step_fn(state, *args)
                torch.cuda.synchronize()
                check_s.append(checks.seconds - c0)
                seconds.append(time.perf_counter() - t0 - check_s[-1])
                metrics.append({k: v.detach().cpu().numpy().tolist() for k, v in met.items()})
                if forcer is not None:
                    forcer.step()
                if i == 0 and dtype == "float32" and int8:
                    states = int8_slots_against(torch, trn, state, mesh, want_path + ".state1")
            counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = torch.load(want_path)
        mine = L.store.tree(state["params"], cast=True)
        d2 = n2 = 0.0
        for x in L.store.leaves:
            spec = get_path(L.specs, x.path)
            w = sharding.local_shard(want["/".join(x.path)], spec, mesh).to(dev).float()
            rep = sharding.replication(spec, mesh)
            d2 += float(((get_path(mine, x.path).float() - w) ** 2).sum()) / rep
            n2 += float((w ** 2).sum()) / rep
        return {"metrics": metrics, "seconds": seconds, "check_s": check_s, "counts": counts,
                "peak": peak, "k4_shape": [L.rows.stop - L.rows.start, L.slot.numel],
                "store_numel": L.store.numel, "coll_counts": cost.coll_counts,
                "coll_wire": cost.coll_wire_bytes, "coll_sites": cost.coll_site_wire_bytes,
                "cost": cost if torch.distributed.get_rank() == 0 else None,
                "d2": d2, "n2": n2, "rank": torch.distributed.get_rank(),
                "int8_launches": checks.log, "states": states,
                "route_flips": forcer.flips if forcer else None,
                "route_tokens": forcer.tokens if forcer else None,
                "inner": L.inner, "groups": [L.rows.start, L.rows.stop],
                "ckpt": None if ckpt_dir is None else checkpoint_resume(
                    torch, trn, state, batches[len(masks):], len(masks), ckpt_dir, groups)}
    finally:
        sharding.set_mesh(None)


def rank_routes(steps: list, groups: int, L) -> list:
    """Per step, the unsharded run's ``route`` calls (``steps``: each
    group's calls in turn) that a rank of layouts ``L`` makes: its groups'
    calls, each cut to the rank's slice of the group's batch."""
    out = []
    for calls in steps:
        per = len(calls) // groups
        out.append([c.reshape(L.n_inner, -1, c.shape[-1])[L.inner]
                    for g in range(L.rows.start, L.rows.stop)
                    for c in calls[g * per:(g + 1) * per]])
    return out


def checkpoint_resume(torch, trn, state, batches: list, done: int, directory: str,
                      groups: int) -> dict:
    """(d), inside a rank, from ``state`` after ``done`` steps: the trainer's
    manager saves it (gathered, rank 0 writes); the uninterrupted run takes
    the steps of :data:`CKPT_MASKS` (``batches``), then ``maybe_restore``
    (each rank's shards, by the state's specs) and the restored run takes
    them again.  Returns whether the two final states are equal bit for bit
    on this rank, the checkpoint's step and, on rank 0, whether the file
    restored into the unsharded port (its flat state) equals the gathered
    mesh state leaf for leaf."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.models import sharding

    def run(state):
        for batch, mask, flush in zip(batches, CKPT_MASKS, CKPT_FLUSH):
            m = torch.tensor(mask, device=trn.device)
            state, _ = trn.step_fn(state, batch, m, torch.tensor(flush, device=trn.device),
                                   torch.zeros_like(m))
        return state

    t0 = time.perf_counter()
    trn.ckpt.save(done - 1, trn._tree(state), blocking=True)
    save_s = time.perf_counter() - t0
    saved = {p: sharding.full(t).detach().cpu() for p, t in _flatten_with_paths(trn._tree(state))}
    whole = run(state)
    t0 = time.perf_counter()
    restored, start = trn.maybe_restore(trn.init_state())
    restore_s = time.perf_counter() - t0
    resumed = run(restored)
    a = [t for _, t in _flatten_with_paths(trn._tree(whole))]
    b = [t for _, t in _flatten_with_paths(trn._tree(resumed))]
    same = start == done and all(torch.equal(x.to_local(), y.to_local()) for x, y in zip(a, b))
    unsharded_equal = None
    if torch.distributed.get_rank() == 0:  # the file into the unsharded port
        from repro_torch.checkpoint.checkpoint import (
            restore_checkpoint,
            train_state_from_tree,
            train_state_tree,
        )
        from repro_torch.core.dsag_pjit import GroupSpec, init_train_state

        layout = trn.layout
        like = init_train_state(layout.flatten(trn.model.init(
            torch.Generator(device=trn.device).manual_seed(0))), trn.opts.train_config,
            GroupSpec(groups, ()),
            layout)
        back = restore_checkpoint(f"{directory}/step_{done - 1:08d}",
                                  train_state_tree(like, layout))
        flat = dict(_flatten_with_paths(train_state_tree(train_state_from_tree(back, layout),
                                                         layout)))
        unsharded_equal = sorted(flat) == sorted(saved) and all(
            torch.equal(flat[k].cpu(), saved[k]) for k in saved)
    return {"same": bool(same), "start": start, "save_s": save_s, "restore_s": restore_s,
            "leaves": len(saved), "unsharded_equal": unsharded_equal}


def int8_slots_against(torch, trn, state, mesh, path: str) -> dict:
    """Inside a rank, after the first step of (a)/(b) in float32: this
    rank's DSAG state against its shards of the unsharded port's (``path``,
    the whole state on the host): ``filled`` and ``pending_valid`` equal;
    for each int8 slot leaf (the cache and the pending slot of each
    parameter), each element's dequantized value in steps of its row's scale
    (the larger of the two, plus 127 bf16 ulps of it: a row whose absmax
    moves by float32 rounding may round to the neighbouring bf16 scale)
    beyond :data:`INT8_ATOL` of the slots' largest magnitude.  Returns, per
    leaf, its elements more than one step apart, all its elements (each
    counted once however many ranks hold it) and its worst steps."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.models import sharding

    dev = trn.device
    want = torch.load(path)
    mine = dict(_flatten_with_paths(trn._tree(state)))
    specs = dict(_flatten_with_paths(trn.state_specs))
    out = {"flags_equal": all(bool((mine[p].to_local().cpu() == w).all())
                              for p, w in want.items() if "[<flat index" not in p)}
    pairs = []
    for qp in (p for p in want if p.endswith("[<flat index 0>]")):
        leaf = qp[:-len("[<flat index 0>]")]
        sp = leaf + "[<flat index 1>]"
        q, s = (sharding.local_shard(want[p], specs[p], mesh).to(dev) for p in (qp, sp))
        mq, ms = (mine[p].to_local() for p in (qp, sp))
        pairs.append((leaf, mq.float() * ms.float(), ms.float(), q.float() * s.float(),
                      s.float(), sharding.replication(specs[qp], mesh)))
    top = torch.tensor(max(float(max(a.abs().max(), w.abs().max())) for _, a, _, w, _, _ in pairs))
    torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
    atol = INT8_ATOL * float(top)
    leaves = {}
    for leaf, ga, gs, wa, ws, rep in pairs:
        steps = int8_steps_apart(ga, gs, wa, ws, atol)
        leaves[int8_leaf_name(leaf)] = [float((steps > 1).sum()) / rep, steps.numel() / rep,
                                        float(steps.max())]
    return {**out, "leaves": leaves}


def int8_leaf_name(leaf: str) -> str:
    """An int8 slot leaf's name (``cache/blocks/attn/wq``) from its state path."""
    return "/".join(k.strip("[]'") for k in leaf.strip("/").split("/")[1:])


def int8_steps_apart(ga, gs, wa, ws, atol: float):
    """Two int8 slots' dequantized values ``ga``, ``wa`` (row scales ``gs``,
    ``ws``) apart, in steps of the larger row scale (plus 127 bf16 ulps of
    it: a row whose absmax moves by float32 rounding may round to the
    neighbouring bf16 scale), beyond ``atol``."""
    sc = gs.maximum(ws)
    step = (sc + 127 * torch_exp2_floor(sc) / 128.0) * (1 + 1e-6)
    return ((ga - wa).abs() - atol).clamp_min(0) / step


def int8_one_ulp_witness(torch, path: str) -> dict:
    """Per int8 slot leaf, the share of elements more than one step apart
    between the unsharded port's state after step 1 (``path.state1``) and
    the same step from parameters one ulp up (``path.state1n``): how far
    float32 rounding alone moves each leaf's gradient."""
    a, b = torch.load(path + ".state1"), torch.load(path + ".state1n")
    deq = {}
    for qp in (p for p in a if p.endswith("[<flat index 0>]")):
        leaf = qp[:-len("[<flat index 0>]")]
        sp = leaf + "[<flat index 1>]"
        deq[leaf] = tuple((t[qp].cuda().float() * t[sp].cuda().float(), t[sp].cuda().float())
                          for t in (a, b))
    atol = INT8_ATOL * max(float(max(x.abs().max(), y.abs().max()))
                           for (x, _), (y, _) in deq.values())
    return {int8_leaf_name(leaf): float((int8_steps_apart(x, xs, y, ys, atol) > 1).float().mean())
            for leaf, ((x, xs), (y, ys)) in deq.items()}


def layouts_states_check(label: str, got: list, witness: dict | None = None) -> dict:
    """(a)/(b) in float32: the ranks' :func:`int8_slots_against` after the
    first step: the flags equal everywhere; per int8 slot leaf, every
    element within one step of the unsharded port's, but for at most
    :data:`INT8_SCORE_PATH_SHARE` of each leaf on the attention scores' path
    (:data:`INT8_SCORE_PATH`: at random init the scores are near one-hot
    and these gradients ill-conditioned, so the mesh's float32 rounding
    moves a few of their elements by several steps; see PERF.md) and, with
    ``witness`` (phase 19 (c): :func:`int8_one_ulp_witness`), at most
    :data:`MOE_SPREAD_MULT` times the share that a one-ulp nudge of the
    parameters moves beyond one step in the unsharded port itself.  A fault
    of the layout (a wrong shard, group, mean or scale) moves most of a
    leaf's elements."""
    phase = _layout(label)[-1]
    witness = witness or {}
    if not all(r["states"]["flags_equal"] for r in got):
        fail(f"phase {phase} ({label}): filled/pending_valid differ from the unsharded port's")
    leaves = {}
    for r in got:
        for leaf, (beyond, total, worst) in r["states"]["leaves"].items():
            b, t, w = leaves.get(leaf, (0.0, 0.0, 0.0))
            leaves[leaf] = (b + beyond, t + total, max(w, worst))
    def allowed(leaf, total):
        score = INT8_SCORE_PATH_SHARE if leaf.endswith(INT8_SCORE_PATH) else 0.0
        return max(score, MOE_SPREAD_MULT * witness.get(leaf, 0.0)) * total

    over = {leaf: v for leaf, v in leaves.items() if v[0] > allowed(leaf, v[1])}
    beyond = {leaf: v for leaf, v in leaves.items() if v[0]}
    rest = max((v[2] for k, v in leaves.items() if k not in beyond), default=0.0)
    print(f"      after step 1, int8 slot elements more than one step from the unsharded "
          f"port's, per leaf (share, worst steps; at most {INT8_SCORE_PATH_SHARE} on the "
          f"scores' path, none elsewhere"
          + (f", or {MOE_SPREAD_MULT} x the unsharded port's one-ulp share" if witness else "")
          + "): "
          + ("; ".join(f"{leaf} {v[0]:.0f} of {v[1]:.0f} ({v[0] / v[1]:.2g}, {v[2]:.3g})"
                       for leaf, v in sorted(beyond.items())) or "none")
          + f"; every other leaf's worst {rest:.3g} steps"
          + ("; the one-ulp witness's non-zero shares: " + ", ".join(
              f"{k} {v:.2g}" for k, v in sorted(witness.items()) if v) if witness else ""))
    if over:
        fail(f"phase {phase} ({label}): int8 slot leaves beyond one step of the unsharded port's "
             f"after step 1 (beyond, elements, worst steps): {over}")
    return {"step1_beyond_one_step": {k: list(v) for k, v in beyond.items()},
            "step1_worst_steps": max(v[2] for v in leaves.values()),
            "step1_one_ulp_witness": witness}


def layout_route_flips(got: list) -> tuple[list[int], list[int]]:
    """Per step, an MoE run's token routes (the forward's and the remat
    recomputation's) whose own experts differ from the unsharded run's, and
    the routes compared: each (inner coordinate, groups) once."""
    seen, flips, tokens = set(), None, None
    for r in got:
        key = (r["inner"], tuple(r["groups"]))
        if r["route_flips"] is None or key in seen:
            continue
        seen.add(key)
        flips = [a + b for a, b in zip(flips or [0] * len(r["route_flips"]), r["route_flips"])]
        tokens = [a + b for a, b in zip(tokens or [0] * len(r["route_tokens"]),
                                        r["route_tokens"])]
    return flips or [], tokens or []


def torch_exp2_floor(x):
    """``2^floor(log2 x)`` elementwise (x > 0): a bf16 ulp is this / 128."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.clamp_min(torch.finfo(torch.float32).tiny))))


def layouts_train_check(label: str, got: list, want: dict, launches: dict, smi: str) -> dict:
    """Hold one phase-18 (or 19 (c)) run's ranks against the unsharded run.
    An MoE's mesh run took the unsharded run's routes (:class:`RouteForcer`):
    the share of its own that differ (near-ties that the mesh's float32
    rounding decides the other way) is held under :data:`MOE_FLIP_CAP` per
    step, and every value at :data:`MESH_TOL`'s bound plus
    :data:`MOE_SPREAD_MULT` times the unsharded port's own spread under a
    one-ulp nudge of its parameters (``want["spread"]``: at these reduced
    widths adafactor's first update moves the second step by more than
    1e-5 from rounding alone)."""
    shape, tc, groups, dtype, arch, _, depth, phase = _layout(label)
    key = "bf16" if dtype == "bfloat16" else "f32"
    spread = want.get("spread") or {"loss": [0.0] * len(want["metrics"]), "params": 0.0}
    tol_loss = [MESH_TOL[f"{key}_loss"] + MOE_SPREAD_MULT * x for x in spread["loss"]]
    tol_params = MESH_TOL[f"{key}_params"] + MOE_SPREAD_MULT * spread["params"]
    r0 = got[0]
    flips, routes = layout_route_flips(got)
    if any(f > MOE_FLIP_CAP * n for f, n in zip(flips, routes)):
        fail(f"phase {phase} ({label}): token routes whose own experts differ from the "
             f"unsharded run's, per step, {flips} of {routes} (more than {MOE_FLIP_CAP})")
    worst = 0.0
    for step, (g, w) in enumerate(zip(r0["metrics"], want["metrics"])):
        for r in got[1:]:
            if r["metrics"][step] != g:
                fail(f"phase {phase} ({label}): rank {r['rank']}'s metrics differ from rank 0's")
        if g["xi"] != w["xi"] or g["mask_count"] != w["mask_count"]:
            fail(f"phase {phase} ({label}): step {step}: xi/mask count {g['xi']}/{g['mask_count']} "
                 f"!= {w['xi']}/{w['mask_count']}")
        for k in ("loss", "per_group_loss"):
            a, bb = np.asarray(g[k]), np.asarray(w[k])
            rel = float(np.max(np.abs(a - bb) / np.abs(bb)))
            worst = max(worst, rel)
            if not np.all(np.isfinite(a)) or rel > tol_loss[step]:
                fail(f"phase {phase} ({label}): step {step} {k} {a} against {bb} (rel {rel:.3g} > "
                     f"{tol_loss[step]:.3g})")
    params_rms = (sum(r["d2"] for r in got) / sum(r["n2"] for r in got)) ** 0.5
    if not params_rms <= tol_params:
        fail(f"phase {phase} ({label}): parameters' relative RMS {params_rms:.3g} > "
             f"{tol_params:.3g}")
    states = layouts_states_check(label, got, want.get("witness")) if dtype == "float32" and (
        tc.dsag and tc.dsag_cache_dtype == "int8") else {}
    counts = {k: [r["counts"][k] for r in got]
              for k in ("dsag_cache_update", "dsag_cache_update_int8", "dsag_int8_row_max",
                        "flash_attention")}
    steps = len(MESH_MASKS)
    int8 = tc.dsag and tc.dsag_cache_dtype == "int8"
    split = [sum(1 for x in r["int8_launches"] if x[0] == "split") for r in got]
    gathered = [sum(1 for x in r["int8_launches"] if x[4]) for r in got]
    bad = [(r["rank"], x[2], x[3]) for r in got for x in r["int8_launches"] if x[3]]
    if bad:
        fail(f"phase {phase} ({label}): K4-int8 launches not held: {bad[:4]}")
    if any(counts["flash_attention"]) or (
            counts["dsag_cache_update"] != [0 if int8 or not tc.dsag else steps] * len(got)) or (
            int8 and (not all(counts["dsag_int8_row_max"]) or split != counts["dsag_int8_row_max"]
                      or counts["dsag_cache_update_int8"] != [len(r["int8_launches"])
                                                             for r in got])) or (
            not int8 and any(counts["dsag_cache_update_int8"] + counts["dsag_int8_row_max"])):
        fail(f"phase {phase} ({label}): launches per rank {counts}, split K4-int8 held {split}")
    for k in ("dsag_cache_update", "dsag_cache_update_int8", "dsag_int8_row_max"):
        launches[k] = launches.get(k, 0) + sum(counts[k])
    wire = r0["coll_wire"]
    print(f"  ({label}) {arch} {dtype}, {depth}, mesh {shape}, {tc.dsag_groups} groups "
          f"(P = {groups}), dsag={tc.dsag}, {tc.optimizer}, {tc.dsag_cache_dtype} slots ({smi}): "
          f"losses {[round(m['loss'], 6) for m in r0['metrics']]} (unsharded "
          f"{[round(m['loss'], 6) for m in want['metrics']]}; worst rel {worst:.3g} <= "
          f"{[float(f'{x:.3g}') for x in tol_loss]} per step); xi "
          f"{[m['xi'] for m in r0['metrics']]}; parameters' relative RMS {params_rms:.3g} <= "
          f"{tol_params:.3g}"
          + (f" (MESH_TOL + {MOE_SPREAD_MULT} x the unsharded port's one-ulp spread: losses "
             f"{[float(f'{x:.3g}') for x in spread['loss']]}, parameters "
             f"{spread['params']:.3g})" if want.get("spread") else "") + "; "
          + (f"own routes differing from the unsharded run's per step {flips} of {routes} "
             f"(<= {MOE_FLIP_CAP}; the unsharded run's taken); " if routes else "")
          + f"launches per rank {counts} (K4-int8 held on "
          f"every row: the split form's {split} against the plain twin given the row maxima "
          f"over the slot spec's row axes, {gathered} also against the whole-row update on "
          f"the gathered rows); local slots {r0['k4_shape']} (store n = "
          f"{r0['store_numel']}); s per step per rank "
          f"{[[round(x, 3) for x in r['seconds']] for r in got]} (the second counted; the "
          f"launch checks' {[[round(x, 2) for x in r['check_s']] for r in got]} s left "
          f"out); peak per rank (the checks' buffers in) "
          f"{[round(r['peak'] / 2**30, 2) for r in got]} GiB")
    print(f"      wire bytes of step 2 per rank by kind: " + ", ".join(
        f"{k} x{r0['coll_counts'][k]} {wire[k] / 2**20:.2f} MiB" for k in sorted(wire))
        + f" (total {sum(wire.values()) / 2**20:.2f} MiB); by site: " + ", ".join(
        f"{k} {v / 2**20:.2f}" for k, v in sorted(r0["coll_sites"].items())))
    shapes = sorted({x[1] for r in got for x in r["int8_launches"] if x[0] == "split"},
                    key=lambda s: -math.prod(s))
    return {"losses": [m["loss"] for m in r0["metrics"]],
            "unsharded": [m["loss"] for m in want["metrics"]],
            "xi": [m["xi"] for m in r0["metrics"]], "worst_loss_rel": worst,
            "params_rel_rms": params_rms, "launches": counts, "split_held": split,
            "split_held_gathered": gathered,
            "k4_shape": r0["k4_shape"], "store_numel": r0["store_numel"],
            "step_s": [r["seconds"] for r in got], "check_s": [r["check_s"] for r in got],
            "peak_bytes": [r["peak"] for r in got],
            "coll_counts": r0["coll_counts"], "coll_wire_bytes": wire,
            "coll_site_wire_bytes": r0["coll_sites"], "int8_split_shapes": shapes[:3],
            "route_flips_per_step": flips, "routes_per_step": routes,
            "one_ulp_spread": want.get("spread"), **states}


def run_layouts(torch, smi: str) -> tuple[dict, dict, list]:
    """Phase 18: the reference's production DSAG layouts on a mesh (see the
    module docstring).  Returns its numbers, every rank's K4, K4-int8 and
    row-max launches, and the kernels' rows at the ranks' local shapes."""
    import tempfile

    from repro_torch.launch.mesh import RankPool

    res: dict = {"card": smi}
    launches: dict = {}
    # the ranks start beside the unsharded runs (as in phase 17)
    t0 = time.perf_counter()
    pool = RankPool(4, "cuda", timeout=600)
    res["pool_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="layouts") as tmp, pool:
        want = {}
        t0 = time.perf_counter()
        for label in LAYOUT_RUNS:
            free_cuda(torch)
            want[label] = layouts_unsharded(torch, label, f"{tmp}/{label}.pt")
        free_cuda(torch)
        res["unsharded_s"] = time.perf_counter() - t0
        print(f"  {pool.world} ranks on cuda:0 over {pool.backend} (started in "
              f"{res['pool_s']:.1f} s; the unsharded runs took {res['unsharded_s']:.1f} s)")
        for label in LAYOUT_RUNS:
            t0 = time.perf_counter()
            got = pool.run(layouts_train_rank, label, f"{tmp}/{label}.pt",
                           f"{tmp}/ckpt" if label == CKPT_RUN else None)
            # rank 0's whole count of step 2, for phase 20 (not printed)
            RANK0_COSTS[label] = got[0].pop("cost")
            res[label] = layouts_train_check(label, got, want[label], launches, smi)
            res[label]["phase_s"] = time.perf_counter() - t0
            if label == CKPT_RUN:
                res["checkpoint"] = checkpoint_check([r["ckpt"] for r in got])
    # (e) the kernels at the ranks' local shapes, timed here (not counted): K4
    # at (c)'s float32 slots under ``none``, K4-int8's split form at (a)'s
    # largest split shard
    rng = np.random.default_rng(18)
    free_cuda(torch)
    k4_row = check_dsag_update(torch, *res["c none"]["k4_shape"], torch.float32, rng,
                               plain_reps=2)
    row_max_row, int8_row = check_dsag_int8_split(torch, *res["a bf16"]["int8_split_shapes"][0],
                                                  rng)
    free_cuda(torch)
    return res, launches, [k4_row, row_max_row, int8_row]


#: phase 18's rank-0 ``count_cost`` of each run's second step, by label
RANK0_COSTS: dict = {}


# ---------------------------------------------------------------------------
# phase 20: the dry run
# ---------------------------------------------------------------------------

#: phase 20 (a): the phase-18 run whose step the dry run is held to
DRYRUN_RUN = "a bf16"
#: (c): the production cell counted at full width on 16x16
DRYRUN_CELL = ("qwen2-7b", "train_4k")


def run_dryrun(torch, layouts_res: dict, smi: str) -> dict:
    """Phase 20 (see the module docstring): the dry run against phase 18's
    count on the card, its memory estimate beside the card's peak, and one
    production cell at full width."""
    import dataclasses

    from repro_torch.analysis.cost import missing_bookkeeping
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    res: dict = {"card": smi}
    # count_cost leaves torch's bookkeeping out by its modules' files
    missing = missing_bookkeeping()
    if missing:
        fail(f"phase 20: this torch lacks the bookkeeping modules {missing}: "
             f"count_cost would count their ops")
    _, tc, groups, dtype, arch, cut, depth, _ = _layout(DRYRUN_RUN)
    cfg = dataclasses.replace(cut(arch), dtype=dtype)
    shape = ShapeConfig("phase 18", MESH_TRAIN[1], MESH_TRAIN[0], "train")
    t0 = time.perf_counter()
    dry = dryrun.dry_count(cfg, shape, LAYOUT_RUNS[DRYRUN_RUN][0], tc, mode="card")
    res["a_s"] = time.perf_counter() - t0
    cost = dry["cost"]
    diffs = RANK0_COSTS[DRYRUN_RUN].diff(cost)
    if diffs:
        fail(f"phase 20 (a): the dry count differs from phase 18's rank-0 count on the card "
             f"in {len(diffs)} fields (name, card's, dry's): {diffs[:6]}")
    kernels = {n: (r.calls, r.flops, r.bytes) for n, r in cost.rows.items()
               if not n.startswith("aten.")}
    if set(kernels) != {"dsag_cache_update_int8", "dsag_int8_row_max"}:
        fail(f"phase 20 (a): the dry count's kernels are {sorted(kernels)}")
    res["a"] = {"rows": len(cost.rows), "flops": cost.flops, "bytes": cost.bytes,
                "kernels": kernels, "coll_site_counts": cost.coll_site_counts}
    print(f"  (a) {arch} {dtype}, {depth}, (2, 2), {tc.dsag_groups} groups (P = {groups}), "
          f"{tc.optimizer}, {tc.dsag_cache_dtype} slots: the dry count (dry_run(\"card\"), "
          f"rank 0 of a fake world of 4, {res['a_s']:.1f} s) equals phase 18's rank-0 count on "
          f"the card row by row: {len(cost.rows)} rows, {cost.flops:.6g} FLOPs, "
          f"{cost.bytes:.6g} bytes, kernels (calls, FLOPs, bytes) {kernels}, collectives by "
          f"site {cost.coll_site_counts}")
    # (b) the memory estimate against the card's peak per rank
    mem = dry["memory"]
    est = mem["peak_estimate_bytes"]
    peaks = layouts_res[DRYRUN_RUN]["peak_bytes"]
    res["b"] = {"memory": mem, "peak_bytes": peaks, "ratio": [est / p for p in peaks]}
    print(f"  (b) the dry run's peak_estimate_bytes {est / 2**30:.3f} GiB (arguments "
          f"{mem['argument_bytes'] / 2**30:.3f}, temporaries {mem['temp_bytes'] / 2**30:.3f}) "
          f"against phase 18's torch.cuda.max_memory_allocated per rank "
          f"{[round(p / 2**30, 3) for p in peaks]} GiB (two steps, the launch checks' buffers "
          f"in): ratio {[round(r, 3) for r in res['b']['ratio']]} (printed, not held; {smi})")
    # (c) one production cell at full width on 16x16
    t0 = time.perf_counter()
    cell = dryrun.run_cell(*DRYRUN_CELL, False)
    res["c_s"] = time.perf_counter() - t0
    rl, mem = cell["roofline"], cell["memory"]
    tcd = cell["train_config"]
    res["c"] = {"memory": mem, "roofline": {k: rl[k] for k in (
        "compute_s", "memory_s", "collective_s", "dominant", "mfu", "flops_per_device",
        "bytes_per_device")}, "wire_bytes": rl["collectives"]["wire_bytes"],
        "kernels": cell["cost"]["kernels"], "count_s": cell["count_s"]}
    print(f"  (c) {' x '.join(DRYRUN_CELL)} on 16x16 (published widths and depth, "
          f"{tcd['dsag_groups']} groups, {tcd['optimizer']}, {tcd['dsag_cache_dtype']} slots): "
          f"{mem['peak_estimate_bytes'] / 2**30:.2f} GiB per rank, terms c/m/x = "
          f"{rl['compute_s']:.4f}/{rl['memory_s']:.4f}/{rl['collective_s']:.4f} s, dominant "
          f"{rl['dominant']}, mfu {rl['mfu']:.4f} (a count at H100 80GB HBM3, 700 W peaks, "
          f"not a timing; counted in {res['c_s']:.1f} s)")
    return res


def checkpoint_check(ck: list) -> dict:
    """(d): the resumed run equals the uninterrupted one on every rank, and
    the checkpoint restores into the unsharded port leaf for leaf."""
    done = len(MESH_MASKS)
    if not all(r["same"] for r in ck) or {r["start"] for r in ck} != {done}:
        fail(f"phase 18 (d): the resumed mesh run differs from the uninterrupted one "
             f"({[(r['same'], r['start']) for r in ck]})")
    if not ck[0]["unsharded_equal"]:
        fail("phase 18 (d): the mesh checkpoint restored unsharded differs from the gathered "
             "mesh state")
    steps = done + len(CKPT_MASKS)
    print(f"  (d) checkpoint of ({CKPT_RUN}): saved after step {done} of {steps} "
          f"({ck[0]['save_s']:.2f} s: gathered, rank 0 writes), restored by the state's specs "
          f"({max(r['restore_s'] for r in ck):.2f} s) and run on: equal bit for bit to the "
          f"uninterrupted run on every rank; the file restored into the unsharded port: "
          f"{ck[0]['leaves']} leaves equal to the gathered mesh state")
    return {"resumed_equal": True, "unsharded_equal": True, "leaves": ck[0]["leaves"],
            "save_s": ck[0]["save_s"], "restore_s": [r["restore_s"] for r in ck]}


# ---------------------------------------------------------------------------
# phase 19: the MoE family on a mesh
# ---------------------------------------------------------------------------

MOE_ARCHS = ("grok-1-314b", "deepseek-v2-236b")
MOE_MESH = (2, 2)
#: (a): requests (the configs' ``moe_dispatch_chunks``: one request per
#: chunk, eight whole chunks on each data rank), prompt tokens, generated
#: tokens (prefill + 1 decode step: each step of four ranks through gloo
#: takes 1.6-8.6 s, so the script keeps its time)
MOE_SERVE = (16, 512, 2)
#: (a): label -> (dtype, decoder layers); one layer each, so the script
#: keeps its time (a second bf16 layer took ~35 s more of four ranks)
MOE_SERVE_RUNS = {"bf16": ("bfloat16", 1), "f32": ("float32", 1)}
#: (a) in float32: fields replaced besides the depth.  Four ranks of one
#: full-width layer hold its FSDP shards (the model once over the four), a
#: degathered half each (twice) and gloo's staging of a gathered leaf (two
#: copies): past the card's 80 GB for grok-1 (26 GB in float32) and
#: deepseek-v2 (20 GB).  So the experts' hidden width is halved and grok-1's
#: vocab cut to a quarter; d_model, the router, the attention (K6's shapes)
#: and the expert count, top-k and mode stay published
MOE_SERVE_F32_FIELDS = {"grok-1-314b": {"vocab_size": 32768, "d_ff_expert": 16384},
                        "deepseek-v2-236b": {"d_ff_expert": 768}}
#: (a) in float32 the logits, (c) the losses and parameters, are held within
#: MESH_TOL's bound plus this many times the unsharded port's own change
#: under a one-ulp nudge of every parameter (``tests/test_torch_registry.py``'s
#: rule), (c)'s int8 slots within this many times its share: at random init a
#: stack of one or two layers draws its weights with std 1 or 0.707 (the
#: reference's fan-in is the layer count), so float32 rounding moves
#: deepseek-v2's logits past 1e-4 of their largest (2.19e-4 between the mesh
#: and the unsharded port, every route equal, in an H100 run) and, through
#: adafactor's first update, (c)'s second step past 1e-5 (3.38e-4 for grok-1
#: on the same routes), while a layout fault moves them by O(1)
MOE_SPREAD_MULT = 4
#: (b): sequences x tokens of one full-width MoE layer, and the gradient
#: rows held: the first this many of each expert leaf's d_model dim
MOE_LAYER_TRAFFIC = (4, 256)
MOE_GRAD_ROWS = 256
#: (b): the bf16 bound of the mesh layer against the unsharded one, of each
#: tensor's largest value: the ffn mode sums its two ranks' bf16 partial
#: products (one more bf16 rounding than the unsharded product)
MOE_MESH_BF16_TOL = MOE_BWD_TOL
#: (b), (c): the most token routes of a step whose own experts may differ
#: from the unsharded run's (near-ties that the mesh's reduction order
#: decides the other way: 0.1 % in (b) in bf16, up to 2.4 % in (c) after
#: adafactor's first update, in H100 runs); a layout fault that moves routes
#: moves most of them.  Below it the mesh takes the unsharded run's routes
#: (:class:`RouteForcer`), so every value is held at its bound
MOE_FLIP_CAP = 0.05
#: (c): the reduced widths (PERF.md §4): ~0.35-0.4 B parameters (the
#: ``pod`` run holds a whole float32 copy per rank: model = 1), each arch's
#: structure kept (grok-1: 8 experts, top-2, GQA; deepseek-v2: MLA with its
#: published head dims and kv rank, 160 routed experts, top-6, 2 shared);
#: ``moe_dispatch_chunks`` by the reference's rule, the DP degree (2)
MOE_REDUCED = {
    "grok-1-314b": dict(num_layers=2, d_model=2048, num_heads=16, num_kv_heads=4,
                        vocab_size=16384, d_ff_expert=3072, moe_dispatch_chunks=2),
    "deepseek-v2-236b": dict(num_layers=2, d_model=2048, num_heads=16, num_kv_heads=16,
                             vocab_size=16384, d_ff_expert=128, moe_dispatch_chunks=2),
}
#: (c): label -> (mesh shape, TrainConfig fields, groups, dtype, arch)
MOE_LAYOUT_RUNS = {
    "grok zero": ((2, 2), LAYOUT_A, 2, "float32", "grok-1-314b"),
    "deepseek zero": ((2, 2), LAYOUT_A, 2, "float32", "deepseek-v2-236b"),
    "deepseek pod": ((2, 2, 1), dict(PROD_TC, dsag_cache_dtype="float32", dsag_groups="pod"), 2,
                     "float32", "deepseek-v2-236b"),
}


def moe_reduced_config(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **MOE_REDUCED[arch])


def moe_serve_cut(dtype: str, layers: int):
    """(a)'s config function: ``layers`` decoder layers (and, in float32,
    :data:`MOE_SERVE_F32_FIELDS`)."""
    import dataclasses

    from repro_torch.configs import get_config

    def cut(arch):
        fields = MOE_SERVE_F32_FIELDS.get(arch, {}) if dtype == "float32" else {}
        return dataclasses.replace(get_config(arch), num_layers=layers, **fields)

    return cut


class RouteRecorder:
    """Records each ``route`` call's expert indices ``[tokens, k]`` (on the
    host, outside any ``count_cost``), in call order; :meth:`step` closes a
    training step's calls into :attr:`steps`."""

    def __init__(self, moe_mod):
        self.real, self.calls, self.steps = moe_mod.route, [], []

    def __call__(self, cfg, params, tokens):
        from torch.utils._python_dispatch import _disable_current_modes

        out = self.real(cfg, params, tokens)
        with _disable_current_modes():
            self.calls.append(out[2].reshape(-1, cfg.top_k).cpu())
        return out

    def step(self) -> None:
        self.steps.append(self.calls)
        self.calls = []


class RouteForcer:
    """Each ``route`` call takes its experts from the unsharded run's
    (``forced``: per step, its calls' ``[tokens, k]`` in call order) and
    its gates from its own probabilities, renormalized over them, so that
    the mesh dispatches the unsharded run's pairs; :attr:`flips` counts per
    step the tokens whose own choice differs, :attr:`tokens` those compared.
    Raises where the calls do not match the unsharded run's."""

    def __init__(self, moe_mod, forced: list):
        self.real, self.forced = moe_mod.route, forced
        self.step_i = self.call_i = 0
        self.flips, self.tokens = [0] * len(forced), [0] * len(forced)

    def __call__(self, cfg, params, tokens):
        import torch
        from torch.utils._python_dispatch import _disable_current_modes

        probs, _, own = self.real(cfg, params, tokens)
        calls = self.forced[self.step_i]
        if self.call_i >= len(calls) or calls[self.call_i].numel() != own.numel():
            raise RuntimeError(f"route call {self.call_i} of step {self.step_i}: "
                               f"{list(own.shape)} against the unsharded run's "
                               f"{[list(c.shape) for c in calls]}")
        with _disable_current_modes():
            want = calls[self.call_i].to(own.device).reshape(own.shape)
            self.flips[self.step_i] += int(
                (own.sort(-1).values != want.sort(-1).values).any(-1).sum())
            self.tokens[self.step_i] += own.numel() // own.shape[-1]
        self.call_i += 1
        vals = torch.gather(probs, -1, want)
        return probs, vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), want

    def step(self) -> None:
        if self.call_i != len(self.forced[self.step_i]):
            raise RuntimeError(f"step {self.step_i}: {self.call_i} route calls, the unsharded "
                               f"run {len(self.forced[self.step_i])}")
        self.step_i, self.call_i = self.step_i + 1, 0


def moe_unsharded_serve(torch, arch: str, dtype: str, layers: int, batch, n_tok: int) -> dict:
    """(a)'s yardstick: the unsharded ``Server`` (K6 for grok-1) on the same
    prompts: tokens, prefill logits, every route."""
    import repro_torch.launch.serve as serve_mod
    from repro_torch.models import moe as moe_mod

    with mock.patch.object(serve_mod, "get_config", moe_serve_cut(dtype, layers)):
        srv = serve_mod.Server(arch, smoke=False, max_len=MOE_SERVE[1] + n_tok + 8, dtype=dtype)
    kept, prefill, rec = {}, srv.model.prefill, RouteRecorder(moe_mod)

    def keep_logits(*a, **kw):
        logits, cache = prefill(*a, **kw)
        kept["logits"] = logits.float().cpu()
        return logits, cache

    with mock.patch.object(srv.model, "prefill", keep_logits), \
            mock.patch.object(moe_mod, "route", rec):
        toks = srv.generate(batch, n_tok)
    out = {"tokens": toks.cpu().numpy(), "logits": kept["logits"].numpy(), "routes": rec.calls,
           "timings": srv.timings, "spread": None}
    if dtype == "float32":
        # the model's own float32 conditioning: its prefill logits with every
        # parameter one ulp up (tests/test_torch_registry.py's spread)
        from repro_torch.models.layers import tree_map

        nudged = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, math.inf)),
                          srv.params)
        with torch.inference_mode():
            logits, _ = srv.model.prefill(nudged, {k: torch.as_tensor(v).to(srv.device) for k, v
                                                   in batch.items()}, MOE_SERVE[1] + n_tok + 8)
        want = kept["logits"]
        out["spread"] = float((logits.float().cpu() - want).abs().max() / want.abs().max())
        del nudged, logits
    del srv
    return out


def moe_serve_rank(arch: str, dtype: str, layers: int, batch, n_tok: int) -> dict:
    """One rank of (a): ``Server(mesh=)`` generates on (2, 2); every K6 call
    held on its own inputs against the plain attention (those comparisons
    launch nothing); the prefill's logits and every route kept."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch.launch.serve as serve_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding

    free_cuda(torch)  # the last task's cached blocks: the card is shared
    mesh = make_test_mesh(MOE_MESH, device_type="cuda")
    try:
        t0 = time.perf_counter()
        with mock.patch.object(serve_mod, "get_config", moe_serve_cut(dtype, layers)):
            srv = serve_mod.Server(arch, smoke=False, max_len=MOE_SERVE[1] + n_tok + 8,
                                   mesh=mesh, dtype=dtype)
        init_s = time.perf_counter() - t0
        real, calls = attn_mod.flash_attention_bshd, []

        def held(q, k, v, *, causal=True):
            out = real(q, k, v, causal=causal)
            strict, wide, diff, _ = k6_violations(torch, q, k, v, out, causal)
            calls.append((list(q.shape), list(k.shape), not wide and bool(
                torch.isfinite(out).all()), float(diff.max()), strict))
            return out

        kept, prefill, rec = {}, srv.model.prefill, RouteRecorder(moe_mod)

        def keep_logits(*a, **kw):
            logits, cache = prefill(*a, **kw)
            kept["logits"] = sharding.full(logits).float().cpu()
            return logits, cache

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with mock.patch.object(attn_mod, "flash_attention_bshd", held), \
                mock.patch.object(srv.model, "prefill", keep_logits), \
                mock.patch.object(moe_mod, "route", rec):
            toks = srv.generate(batch, n_tok)
        torch.cuda.synchronize()
        return {"tokens": toks.cpu().numpy(), "logits": kept["logits"].numpy(), "calls": calls,
                "counts": launch_counts(), "timings": srv.timings, "init_s": init_s,
                "routes": rec.calls, "data": sharding.dp_coordinate(mesh)[0],
                "peak": torch.cuda.max_memory_allocated()}
    finally:
        sharding.set_mesh(None)


def route_flips(got: list, want: list, data: int, n_dp: int) -> tuple[int, int]:
    """Tokens whose expert set differs between a data rank's route calls and
    the unsharded calls' rows of its batch slice, and the tokens compared."""
    flips = total = 0
    for g, w in zip(got, want):
        n = w.shape[0] // n_dp
        w = w[data * n:(data + 1) * n]
        flips += int((g.sort(-1).values != w.sort(-1).values).any(-1).sum())
        total += g.shape[0]
    return flips, total


def moe_serve_check(torch, arch: str, label: str, got: list, want: dict, launches: dict) -> dict:
    """Hold one (a) run's ranks against the unsharded server."""
    dtype, layers = MOE_SERVE_RUNS[label]
    key = "bf16" if dtype == "bfloat16" else "f32"
    toks = got[0]["tokens"]
    if any(not np.array_equal(r["tokens"], toks) for r in got[1:]):
        fail(f"phase 19 (a) {arch} {label}: the ranks returned different tokens")
    logits = np.concatenate([got[d * MOE_MESH[1]]["logits"] for d in range(MOE_MESH[0])])
    max_rel, norm_rel = logit_diff(torch, torch.as_tensor(logits), torch.as_tensor(want["logits"]))
    agree = float(np.mean(toks == want["tokens"]))
    n_calls = len(want["routes"])
    if any(len(r["routes"]) != n_calls for r in got):
        fail(f"phase 19 (a) {arch} {label}: route calls per rank "
             f"{[len(r['routes']) for r in got]}, unsharded {n_calls}")
    prefill_calls = layers  # one route per layer at prefill, then per decode step
    flips = [route_flips(r["routes"][:prefill_calls], want["routes"][:prefill_calls], r["data"],
                         MOE_MESH[0]) for r in got]
    flips_all = [route_flips(r["routes"], want["routes"], r["data"], MOE_MESH[0]) for r in got]
    share = sum(f for f, _ in flips) / sum(t for _, t in flips)
    if key == "f32":
        if any(f for f, _ in flips_all) or agree != 1.0:
            fail(f"phase 19 (a) {arch} float32: routes flipped {flips_all} or tokens differ "
                 f"(agreement {agree})")
        bound = MESH_TOL["f32_logits"] + MOE_SPREAD_MULT * want["spread"]
        if not max_rel <= bound:
            fail(f"phase 19 (a) {arch} float32: prefill logits {max_rel:.3g} > {bound:.3g} "
                 f"({MESH_TOL['f32_logits']} + {MOE_SPREAD_MULT} x the one-ulp spread "
                 f"{want['spread']:.3g})")
    calls = [c for r in got for c in r["calls"]]
    bad = [c for c in calls if not c[2]]
    if bad:
        fail(f"phase 19 (a) {arch} {label}: {len(bad)} K6 calls outside tolerance: {bad[:2]}")
    k6 = [r["counts"]["flash_attention"] for r in got]
    want_k6 = layers if arch == "grok-1-314b" else 0
    if k6 != [want_k6] * len(got) or len(calls) != sum(k6):
        fail(f"phase 19 (a) {arch} {label}: K6 launches per rank {k6} (want {want_k6} per "
             f"prefill), held calls {len(calls)}")
    launches["flash_attention"] = launches.get("flash_attention", 0) + sum(k6)
    t = got[0]["timings"]
    k6_txt = (f"K6 {sum(k6)} launches ({k6} per rank) on local q {calls[0][0]} k {calls[0][1]}, "
              f"each held against the plain attention (worst |K6 - plain| "
              f"{max(c[3] for c in calls):.3g})" if calls else "K6 0 (MLA: the plain attention)")
    cut = MOE_SERVE_F32_FIELDS.get(arch, {}) if key == "f32" else {}
    print(f"  (a) serve {arch} {dtype}, {layers} layers{f' {cut}' if cut else ''}: "
          f"{MOE_SERVE[0]} x {MOE_SERVE[1]} prompts, {MOE_SERVE[2]} tokens on {MOE_MESH}; prefill "
          f"logits against the unsharded server {max_rel:.3g} max / {norm_rel:.3g} norm"
          + (f" (<= {MESH_TOL['f32_logits']} + {MOE_SPREAD_MULT} x the unsharded logits' "
             f"one-ulp spread {want['spread']:.3g})" if key == "f32" else " (printed)") + "; "
          f"tokens agree {agree:.4f}; prefill routes flipped {sum(f for f, _ in flips)} of "
          f"{sum(t_ for _, t_ in flips)} tokens ({share:.3g}), all calls "
          f"{sum(f for f, _ in flips_all)}; {k6_txt}; init {got[0]['init_s']:.1f} s, prefill "
          f"{t['prefill']:.3f} s, decode {t['decode']:.3f} s (rank 0; unsharded "
          f"{want['timings']['prefill']:.3f} / {want['timings']['decode']:.3f} s); peak per rank "
          f"{[round(r['peak'] / 2**30, 2) for r in got]} GiB")
    return {"logits_max_rel": max_rel, "logits_norm_rel": norm_rel, "token_agreement": agree,
            "unsharded_one_ulp_spread": want["spread"],
            "prefill_route_flips": [sum(f for f, _ in flips), sum(t_ for _, t_ in flips)],
            "route_flips_all_calls": [sum(f for f, _ in flips_all),
                                      sum(t_ for _, t_ in flips_all)],
            "k6_launches": k6, "k6_local_q": calls[0][0] if calls else None,
            "k6_local_k": calls[0][1] if calls else None,
            "k6_worst": max((c[3] for c in calls), default=None), "timings": t,
            "unsharded_timings": want["timings"], "init_s": [r["init_s"] for r in got],
            "peak_bytes": [r["peak"] for r in got]}


def moe_layer_setup(torch, arch: str):
    """(b)'s config, its MoE declarations and FSDP specs, and the traffic
    ``x`` and the output weights ``w`` (bf16, from seed 19, on the card)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import make_rules, specs_from_decls

    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    decls = moe_mod.moe_decls(cfg)
    gen = torch.Generator(device="cuda").manual_seed(19)
    b, s = MOE_LAYER_TRAFFIC
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    return cfg, decls, specs_from_decls(decls, make_rules(cfg, True)), x, w


def grad_rows(name: str, g):
    """The first :data:`MOE_GRAD_ROWS` of an expert leaf's d_model dim (the
    router's gradient whole)."""
    if name == "router":
        return g
    dim = 2 if name in ("w_down", "shared_down") else 1
    if name.startswith("shared"):
        dim = 1 if name == "shared_down" else 0
    return g.narrow(dim, 0, MOE_GRAD_ROWS)


def moe_layer_unsharded(torch, arch: str, path: str) -> dict:
    """(b)'s yardstick: the unsharded layer forward and backward on the
    card (the gradients of the parameters and of ``x``, as a layer inside a
    model takes them); its output, aux, routes, ``x``'s gradient and the
    parameters' gradient rows saved to ``path``."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import init_from_decls

    cfg, decls, _, x, w = moe_layer_setup(torch, arch)
    params = init_from_decls(decls, torch.Generator(device="cuda").manual_seed(0), cfg.dtype)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    x = x.requires_grad_(True)
    rec = RouteRecorder(moe_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(moe_mod, "route", rec):
        out, aux = moe_mod.moe_apply(cfg, leaves, x)
        dx, *grads = torch.autograd.grad((out.float() * w.float()).sum() + aux,
                                         [x] + list(leaves.values()))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.save({"out": out.detach().cpu(), "aux": float(aux), "routes": rec.calls[0],
                "dx": dx.cpu(),
                "grads": {k: grad_rows(k, g).cpu() for k, g in zip(leaves, grads)}}, path)
    del params, leaves, grads, out, dx
    free_cuda(torch)
    return {"seconds": seconds}


def moe_layer_rank(arch: str, want_path: str) -> dict:
    """One rank of (b): the layer's parameters drawn in turns (each rank's
    FSDP shards), degathered, and ``moe_apply`` forward and backward on the
    rank's slice of the traffic (one token stream over ``data``) on the
    unsharded run's routes (:class:`RouteForcer`), once timed and once under
    ``count_cost`` (its output and aux bit-equal to the first run's).
    Returns its seconds, peak memory, collectives, the tokens whose own
    routes differ, and its gaps from the unsharded layer: the output, the
    aux, ``x``'s gradient on its slice and the gradient rows' mean over the
    data ranks (the router whole; each expert leaf's first
    :data:`MOE_GRAD_ROWS` d_model rows, the rank's shard of them)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis.cost import count_cost
    from repro_torch.launch.mesh import card_turns, make_test_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding
    from repro_torch.models.layers import init_from_decls

    free_cuda(torch)  # the last task's cached blocks: the card is shared
    mesh = make_test_mesh(MOE_MESH, device_type="cuda")
    sharding.set_mesh(mesh)
    try:
        cfg, decls, specs, x, w = moe_layer_setup(torch, arch)
        dev = x.device
        shards = card_turns(lambda: init_from_decls(
            decls, torch.Generator(device=dev).manual_seed(0), cfg.dtype, specs, mesh), dev)
        cm = sharding.compute_mesh(mesh)
        placed = {k: DTensor.from_local(v, mesh, sharding.placements(specs[k], mesh),
                                        run_check=False) for k, v in shards.items()}
        tp = {k: DTensor.from_local(v.to_local().detach().requires_grad_(True), cm,
                                    v.placements[-cm.ndim:], run_check=False)
              for k, v in sharding.degather(placed, specs, mesh).items()}
        del placed, shards
        idx, R = sharding.dp_coordinate(mesh)
        b = x.shape[0] // R
        x_loc = x[idx * b:(idx + 1) * b].detach().requires_grad_(True)
        w_loc = w[idx * b:(idx + 1) * b]
        xd = DTensor.from_local(x_loc, cm, [Replicate()] * cm.ndim, run_check=False)
        want = torch.load(want_path)
        n = b * x.shape[1]
        routes, forcers = want["routes"][idx * n:(idx + 1) * n], []

        def run():
            forcers.append(RouteForcer(moe_mod, [[routes]]))
            with implicit_replication(), sharding.token_stream(sharding.dp_axes()), \
                    mock.patch.object(moe_mod, "route", forcers[-1]):
                out, aux = moe_mod.moe_apply(cfg, tp, xd)
                loc = out.to_local()
                loss = R * (loc.float() * w_loc.float()).sum() + aux.to_local()
                dx, *grads = torch.autograd.grad(loss, [x_loc] + list(tp.values()))
            forcers[-1].step()
            return loc.detach(), aux.to_local().detach(), dx, grads

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, aux, dx, grads = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()

        def gap(got, ref):
            ref = ref.to(dev).float()
            return float((got.float() - ref).abs().max() / ref.abs().max())

        # each rank's loss carries R times its slice's share and its own
        # probabilities' aux gradient: x's gradient over R is the unsharded one
        rel = {"aux": abs(float(aux) - want["aux"]) / abs(want["aux"]),
               "out": gap(out, want["out"][idx * b:(idx + 1) * b]),
               "dx": gap(dx / R, want["dx"][idx * b:(idx + 1) * b])}
        data = mesh.get_group("data")
        for k, g in zip(tp, grads):
            mine = grad_rows(k, g.to_local()).float().contiguous()
            torch.distributed.all_reduce(mine, group=data)
            mine /= R
            ref = sharding.local_shard(want["grads"][k], sharding.strip_axis(specs[k], "data"),
                                       mesh).to(dev).float()
            rel[f"grad {k}"] = float((mine - ref).abs().max() / ref.abs().max())
        del grads, want, dx
        held: dict = {}
        cost = count_cost(lambda: held.update(again=run()[:2]))
        same_runs = torch.equal(out, held["again"][0]) and torch.equal(aux, held["again"][1])
        return {"seconds": seconds, "peak": peak, "rel": rel, "flips": forcers[0].flips[0],
                "tokens": n, "same_runs": same_runs, "coll_counts": cost.coll_counts,
                "coll_wire": cost.coll_wire_bytes, "coll_sites": cost.coll_site_wire_bytes,
                "coll_site_counts": cost.coll_site_counts, "rank": torch.distributed.get_rank()}
    finally:
        sharding.set_mesh(None)


def moe_layer_check(arch: str, got: list, want: dict, smi: str) -> dict:
    """Hold (b)'s ranks against the unsharded layer."""
    from repro_torch.models.moe import _ep_mode
    from repro_torch.configs import get_config

    # the ranks of one data coordinate route the same tokens: count them once
    flips = sum(r["flips"] for r in got) // MOE_MESH[1]
    total = sum(r["tokens"] for r in got) // MOE_MESH[1]
    worst = {k: max(r["rel"][k] for r in got) for k in got[0]["rel"]}
    if not all(r["same_runs"] for r in got):
        fail(f"phase 19 (b) {arch}: two runs of the mesh layer differ")
    if not flips <= MOE_FLIP_CAP * total:
        fail(f"phase 19 (b) {arch}: {flips} of {total} token routes differ from the unsharded "
             f"layer's (more than {MOE_FLIP_CAP})")
    over = {k: v for k, v in worst.items() if not v <= MOE_MESH_BF16_TOL}
    if over:
        fail(f"phase 19 (b) {arch}: the mesh layer against the unsharded one beyond "
             f"{MOE_MESH_BF16_TOL} of each tensor's largest value: {over}")
    ep = _ep_mode(get_config(arch))
    site = "moe EP combine: all-gather" if ep else "moe ffn all-reduce: all-reduce"
    if any(r["coll_site_counts"].get(site) != 2 for r in got):
        fail(f"phase 19 (b) {arch}: {site} counted {[r['coll_site_counts'].get(site) for r in got]}"
             f" times per rank, not once forward and once backward")
    mode = "expert-parallel" if ep else "ffn-sharded"
    r0 = got[0]
    wire = r0["coll_wire"]
    print(f"  (b) one {arch} MoE layer at full width, {mode}, bf16, {MOE_LAYER_TRAFFIC[0]} x "
          f"{MOE_LAYER_TRAFFIC[1]} tokens (one chunk over both data ranks) on {MOE_MESH} ({smi}): "
          f"own routes differ on {flips} of {total} tokens (<= {MOE_FLIP_CAP}; the unsharded "
          f"layer's taken); gaps from the unsharded layer (of each tensor's largest value): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (<= {MOE_MESH_BF16_TOL}); forward + backward s per rank "
          f"{[round(r['seconds'], 3) for r in got]} (unsharded {want['seconds']:.3f} s); peak "
          f"per rank {[round(r['peak'] / 2**30, 2) for r in got]} GiB")
    print(f"      wire bytes per rank (count_cost) by kind: " + ", ".join(
        f"{k} x{r0['coll_counts'][k]} {wire[k] / 2**20:.2f} MiB" for k in sorted(wire))
        + "; by site: " + ", ".join(f"{k} {v / 2**20:.2f}" for k, v in
                                     sorted(r0["coll_sites"].items())))
    return {"mode": mode, "route_flips": [flips, total], "worst_rel": worst,
            "seconds": [r["seconds"] for r in got], "unsharded_s": want["seconds"],
            "peak_bytes": [r["peak"] for r in got], "coll_counts": r0["coll_counts"],
            "coll_wire_bytes": wire, "coll_site_wire_bytes": r0["coll_sites"]}


def run_moe_mesh(torch, smi: str) -> tuple[dict, dict, list]:
    """Phase 19: the MoE family on a mesh (see the module docstring).
    Returns its numbers, every rank's launches, and K6's and K4-int8's rows
    at its local shapes."""
    import tempfile

    from repro_torch.launch.mesh import RankPool
    from repro_torch.launch.serve import stub_batch

    res: dict = {"card": smi, "mesh": list(MOE_MESH)}
    launches: dict = {}
    b, s, n_tok = MOE_SERVE
    prompts = {(arch, label): stub_batch(moe_serve_cut(dtype, layers)(arch), b, s, seed=19)
               for arch in MOE_ARCHS for label, (dtype, layers) in MOE_SERVE_RUNS.items()}
    # the ranks start beside the unsharded runs (as in phase 17); their
    # allocators grow segments in place: four ranks' gathered layers and
    # staging copies come and go on one card
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"):
        pool = RankPool(MOE_MESH[0] * MOE_MESH[1], "cuda", timeout=900)
    res["pool_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="moe_mesh") as tmp, pool:
        t0 = time.perf_counter()
        want_serve, want_layer, want_layout = {}, {}, {}
        for (arch, label), batch in prompts.items():
            free_cuda(torch)
            dtype, layers = MOE_SERVE_RUNS[label]
            want_serve[arch, label] = moe_unsharded_serve(torch, arch, dtype, layers, batch, n_tok)
        for arch in MOE_ARCHS:
            free_cuda(torch)
            want_layer[arch] = moe_layer_unsharded(torch, arch, f"{tmp}/{arch}.pt")
        for label in MOE_LAYOUT_RUNS:
            free_cuda(torch)
            want_layout[label] = layouts_unsharded(torch, label, f"{tmp}/{label}.pt")
        free_cuda(torch)
        res["unsharded_s"] = time.perf_counter() - t0
        free, total = torch.cuda.mem_get_info()
        print(f"  {pool.world} ranks on cuda:0 over {pool.backend} (started in "
              f"{res['pool_s']:.1f} s; the unsharded runs took {res['unsharded_s']:.1f} s; "
              f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card, this process "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved)", flush=True)
        for (arch, label), batch in prompts.items():
            t0 = time.perf_counter()
            dtype, layers = MOE_SERVE_RUNS[label]
            got = pool.run(moe_serve_rank, arch, dtype, layers, batch, n_tok)
            r = moe_serve_check(torch, arch, label, got, want_serve[arch, label], launches)
            r["phase_s"] = time.perf_counter() - t0
            res[f"serve {arch} {label}"] = r
        for arch in MOE_ARCHS:
            t0 = time.perf_counter()
            got = pool.run(moe_layer_rank, arch, f"{tmp}/{arch}.pt")
            res[f"layer {arch}"] = moe_layer_check(arch, got, want_layer[arch], smi)
            res[f"layer {arch}"]["phase_s"] = time.perf_counter() - t0
        for label in MOE_LAYOUT_RUNS:
            t0 = time.perf_counter()
            got = pool.run(layouts_train_rank, label, f"{tmp}/{label}.pt")
            res[label] = layouts_train_check(label, got, want_layout[label], launches, smi)
            res[label]["phase_s"] = time.perf_counter() - t0
    # (d) the kernels at this phase's local launch shapes, timed here (not
    # counted): K6 at grok-1's rank-local prefill (24 q / 4 kv heads of its
    # 48 / 8 over model = 2, 8 of the 16 prompts per data rank), K4-int8's
    # split form at (c)'s largest split expert leaf
    from repro_torch.configs import get_config

    rng = np.random.default_rng(19)
    free_cuda(torch)
    grok = get_config("grok-1-314b")
    k6_row = check_flash(torch, b // MOE_MESH[0], grok.num_heads // MOE_MESH[1], s, s,
                         grok.resolved_head_dim, rng, kvh=grok.num_kv_heads // MOE_MESH[1])
    shapes = sorted((sh for label in MOE_LAYOUT_RUNS for sh in res[label]["int8_split_shapes"]),
                    key=lambda sh: -math.prod(sh))
    row_max_row, int8_row = check_dsag_int8_split(torch, *shapes[0], rng)
    free_cuda(torch)
    return res, launches, [k6_row, row_max_row, int8_row]


def profile_run(torch, label: str, setup, iters: int) -> dict | None:
    """One warm run under ``torch.profiler``: host wall clock (ending in a
    synchronize), the union of device kernel intervals (busy time), the idle
    share, kernel count, and the kernels that take the most time.
    ``setup()`` returns the run to time (set-up stays outside the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    setup()()  # warm
    torch.cuda.synchronize()
    run = setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"  profile {label}: the profiler recorded no device time (not measured)")
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name: dict[str, float] = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    busy_ms = busy / 1e3
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profile {label} ({iters} iters, profiler on): host wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.2f} ms over a {window_ms:.1f} ms kernel window, "
          f"idle share {1 - busy_ms / window_ms:.3f}; {len(spans)} device kernels "
          f"({len(spans) / iters:.0f} per iteration)")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
    return {"busy_ms": busy_ms, "window_ms": window_ms, "by_name_us": by_name}


def profile_paths(torch) -> None:
    """``--profile``: the grid recipe's dsag column (60 iterations) and the
    paper-scale live logreg and PCA dsag jobs (80 steps each)."""
    from repro_torch.experiments.convergence import grid_logreg_sweep, run_convergence_batch
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer

    out, _ = grid_logreg_sweep(seed=0, engine=EngineConfig())  # problem, traces, methods
    cfg, T = out.methods["dsag"], out.num_iterations
    profile_run(torch, "grid/dsag", lambda: lambda: run_convergence_batch(
        out.problem, out.traces, cfg, T, eval_every=out.eval_every, engine=EngineConfig()), T)
    for arch in PAPER_JOBS:
        opts = paper_live_opts(arch, "dsag", EngineConfig())
        profile_run(torch, f"live {arch}/dsag", lambda: Trainer(opts).run, opts.steps)


def profile_training(torch) -> None:
    """``--profile``: one step of phase 13 (a)'s full-width training cell
    (the device's idle share; the kernels that take the most time)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer, TrainerOptions

    trn = Trainer(TrainerOptions(arch="qwen1.5-0.5b", smoke=False, steps=1,
                                 global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 train_config=TrainConfig(), log_every=10**6,
                                 engine=EngineConfig()))
    P = trn.gs.num_groups
    holder = [trn.init_state()]
    batch = trn.batch_on_device(next(trn.data))
    bits = torch.tensor([[True] * (P - 1) + [False], [False] * P, [False] * P], device="cuda")

    def one_step():
        holder[0], _ = trn.step_fn(holder[0], batch, *bits)

    one_step()  # the first step allocates the state's slots
    prof = profile_run(torch, "train step (qwen1.5-0.5b full width, P = 4)", lambda: one_step, 1)
    if prof is not None:
        k4_us = sum(us for name, us in prof["by_name_us"].items() if "dsag" in name)
        print(f"    K4 share of the step's device time: {k4_us / 1e3 / prof['busy_ms']:.3f} "
              f"({k4_us / 1e3:.3f} of {prof['busy_ms']:.3f} ms)")


def profile_serving(torch) -> None:
    """``--profile``: the serving cell's prefill (K6's share of device time)
    and one decode step (the device's idle share)."""
    from repro_torch.launch.serve import Server

    max_len = SERVE_PROMPT + SERVE_TOKENS + 8
    srv = Server("qwen1.5-0.5b", smoke=False, max_len=max_len, device="cuda", seed=0)
    batch = {"tokens": torch.as_tensor(serving_prompts(srv.cfg.vocab_size), device="cuda")}
    params, model = srv.params, srv.model

    @torch.inference_mode()
    def prefill():
        return model.prefill(params, batch, max_len)

    prof = profile_run(torch, "serve prefill", lambda: prefill, 1)
    if prof is not None:
        k6_us = sum(us for name, us in prof["by_name_us"].items() if "flash_fwd" in name)
        print(f"    K6 share of prefill device time: {k6_us / 1e3 / prof['busy_ms']:.3f} "
              f"({k6_us / 1e3:.3f} of {prof['busy_ms']:.3f} ms)")
    logits, cache = prefill()
    tok = logits[:, -1].argmax(-1)[:, None]

    @torch.inference_mode()
    def step():
        return model.decode_step(params, tok, cache, SERVE_PROMPT)

    profile_run(torch, "serve decode step", lambda: step, 1)


def profile_families(torch) -> None:
    """``--profile``: phase 14's models (the same configs, weights and
    prompts): one prefill and one decode step each, their device idle share
    and kernels per step."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    max_len = FAMILY_PROMPT + FAMILY_TOKENS + 8
    for arch, depth in FAMILY_ARCHS.items():
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=depth) if depth else cfg
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (FAMILY_B, FAMILY_PROMPT)), device="cuda")

        @torch.inference_mode()
        def prefill():
            return model.prefill(params, {"tokens": tokens}, max_len)

        profile_run(torch, f"{arch} prefill", lambda: prefill, 1)
        logits, cache = prefill()
        tok = logits[:, -1].argmax(-1)[:, None]

        @torch.inference_mode()
        def step():
            return model.decode_step(params, tok, cache, FAMILY_PROMPT)

        profile_run(torch, f"{arch} decode step", lambda: step, 1)
        del model, params, cache, logits, prefill, step
        gc.collect()
        torch.cuda.empty_cache()


def ptxas_report(log: str) -> list[str]:
    """``-Xptxas -v``'s registers, spills and shared memory, one line per
    kernel and line of the report, under the kernel's (template) name."""
    import re

    lines, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            # _ZN <len><anonymous namespace> <len><kernel> [I Li<D> E ...]
            name = entry.group(1)
            parts = re.match(r"_ZN(\d+)", name)
            if parts:
                rest = name[parts.end() + int(parts.group(1)):]
                m = re.match(r"(\d+)", rest)
                if m:
                    rest = rest[m.end():]
                    tmpl = re.match(r"IL[ib](\d+)E", rest[int(m.group(1)):])
                    name = rest[:int(m.group(1))] + (f"<{tmpl.group(1)}>" if tmpl else "")
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(' : ', 1)[-1].strip()}")
    return lines


def build_times(_build) -> None:
    """``--build-times``: the kernel library built from scratch by one ``nvcc``
    call over every source, against ``_build.compile_library`` (one ``nvcc``
    per source, started together, then a link), in turns."""
    import tempfile

    sources = sorted(_build.CSRC.glob("*.cu"))
    one_call = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared"]
    times: dict[str, list[float]] = {"one nvcc call": [], "one nvcc per source": []}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for rep in range(2):
            for label in (times if rep == 0 else reversed(times)):
                out = Path(tmp) / f"{rep}_{len(times[label])}_{label[-6:]}.so"
                t0 = time.perf_counter()
                if label == "one nvcc call":
                    subprocess.run([*one_call, "-o", str(out), *map(str, sources)],
                                   capture_output=True, check=True)
                else:
                    _build.compile_library(sources, out)
                times[label].append(time.perf_counter() - t0)
    print(f"  build from scratch, {len(sources)} sources, s: " + "; ".join(
        f"{label} {', '.join(f'{t:.2f}' for t in ts)}" for label, ts in times.items()))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.problems import make_genomics_like_matrix, make_higgs_like
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: built {_build.build_info['path']} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_report(_build.build_info.get("log", "")):
        print(f"  ptxas: {line}")

    # the launch plans and the engines' capability checks read the kernels'
    # limits from Python mirrors: hold each against the compiled value
    bad = _build.mirror_mismatches()
    if bad:
        fail(f"mirrored kernel limits differ from the compiled ones (mirrored, compiled): {bad}")
    print(f"  {len(_build.LIMITS)} mirrored limits equal the compiled ones")

    if "--build-times" in sys.argv[1:]:
        build_times(_build)

    print("phase 3: kernels against their plain versions at the recipes' shapes")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    Xh, yh = make_higgs_like(16_384, seed=0)
    Xh, yh = torch.as_tensor(Xh, device=dev), torch.as_tensor(yh, device=dev)
    Xg = torch.as_tensor(make_genomics_like_matrix(50_000, 96, seed=0), device=dev)
    # the wide paths (any feature width): K1 on the grid call's task layout
    # at d = 97 and 1000, K2 at d = 180 (k = 3) and k = 12 (d = 96)
    Xw = {d: torch.as_tensor(rng.normal(size=(16_384, d)), dtype=torch.float32, device=dev)
          for d in (97, 1000)}
    X180 = torch.as_tensor(make_genomics_like_matrix(50_000, 180, seed=0), device=dev)
    per_kernel = {
        "logreg_block_sub": check_block_sub(torch, "logreg", Xh, yh, rng) + [
            row for d in (97, 1000) for row in check_block_sub(
                torch, "logreg", Xw[d], yh, rng, shapes={f"grid d={d}": (100, 10, 10)})],
        "pca_block_sub": check_block_sub(torch, "pca", Xg, None, rng)
        + check_block_sub(torch, "pca", X180, None, rng, shapes={"grid d=180": (50, 5, 4)})
        + check_block_sub(torch, "pca", Xg, None, rng, shapes={"grid k=12": (50, 5, 4)}, k=12),
        "grid_cache_update": [
            check_cache_walk(torch, 10, 200, 1000, 29, 60, rng),
            check_cache_walk(torch, 4, 100, 250, 288, 80, rng),
        ],
        # the live path's shapes: logreg paper scale, PCA paper scale (50
        # groups x 64 x 3), live_validation; then the bf16 kernels_bench shape
        "dsag_cache_update": [
            check_dsag_update(torch, 100, 29, torch.float32, rng),
            check_dsag_update(torch, 50, 192, torch.float32, rng),
            check_dsag_update(torch, 8, 29, torch.float32, rng),
            check_dsag_update(torch, 8, 1 << 20, torch.bfloat16, rng),
        ],
        # K4's int8 entry at the live logreg [100 groups, 29] and paper-scale
        # PCA [50 groups, 64 rows, 3] slots (phase 10)
        "dsag_cache_update_int8": [
            check_dsag_update_int8(torch, 100, 1, 29, rng),
            check_dsag_update_int8(torch, 50, 64, 3, rng),
        ],
        "gram_matvec": [
            check_gram_matvec(
                torch,
                torch.as_tensor(make_genomics_like_matrix(50_000, 64, seed=0),
                                device=dev).view(50, 1000, 64),
                torch.as_tensor(np.linalg.qr(rng.normal(size=(64, 3)))[0],
                                dtype=torch.float32, device=dev).contiguous()),
            check_gram_matvec(
                torch,
                torch.as_tensor(rng.normal(size=(4096, 512)), dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(512, 8)), dtype=torch.float32, device=dev)),
            # the wide path: d past 1024, k past 8
            check_gram_matvec(
                torch,
                torch.as_tensor(make_genomics_like_matrix(50_000, 1100, seed=0),
                                device=dev).view(50, 1000, 1100),
                torch.as_tensor(np.linalg.qr(rng.normal(size=(1100, 3)))[0],
                                dtype=torch.float32, device=dev).contiguous()),
            check_gram_matvec(
                torch,
                torch.as_tensor(rng.normal(size=(4096, 64)), dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(64, 12)), dtype=torch.float32, device=dev)),
        ],
        # the serving prefill (24 launches per prefill), the kernels_bench
        # shape, a decode-like single query row over the full cache, a length
        # that is no multiple of the tiles, and GQA (16 q heads over 2 kv
        # heads) in the model's [b, s, h, d] layout
        "flash_attention": [
            check_flash(torch, SERVE_B, 16, SERVE_PROMPT, SERVE_PROMPT, 64, rng),
            check_flash(torch, 1, 4, 1024, 1024, 128, rng),
            check_flash(torch, SERVE_B, 16, 1, SERVE_PROMPT + SERVE_TOKENS + 5, 64, rng),
            check_flash(torch, SERVE_B, 16, 2085, 2085, 64, rng),
            check_flash(torch, SERVE_B, 16, SERVE_PROMPT, SERVE_PROMPT, 64, rng, kvh=2),
            # phase 14's GQA prefills: grok-1 (48 q / 8 kv heads x 128) and
            # zamba2's shared block (32 heads x 80, run zero-padded to 128)
            check_flash(torch, FAMILY_B, 48, FAMILY_PROMPT, FAMILY_PROMPT, 128, rng, kvh=8),
            check_flash(torch, FAMILY_B, 32, FAMILY_PROMPT, FAMILY_PROMPT, 80, rng),
            # phase 15's: whisper-base's encoder (16 heads, padded from 8,
            # non-causal over its 1500 frames) and its cross-attention at
            # prefill (1024 queries over the 1500 encoded frames) and at each
            # decode step (one query), all in the model's layout;
            # starcoder2-15b's GQA prefill (48 q / 4 kv heads); head dims
            # above 128: 192 (zero-padded to the d = 256 build) and 256
            check_flash(torch, FAMILY_B, 16, 1500, 1500, 64, rng, causal=False, bshd=True),
            check_flash(torch, FAMILY_B, 16, FAMILY_PROMPT, 1500, 64, rng, causal=False,
                        bshd=True),
            check_flash(torch, FAMILY_B, 16, 1, 1500, 64, rng, causal=False, bshd=True),
            check_flash(torch, FAMILY_B, 48, FAMILY_PROMPT, FAMILY_PROMPT, 128, rng, kvh=4),
            check_flash(torch, FAMILY_B, 16, FAMILY_PROMPT, FAMILY_PROMPT, 192, rng),
            check_flash(torch, FAMILY_B, 16, FAMILY_PROMPT, FAMILY_PROMPT, 256, rng),
        ],
    }
    # K1 and K2 at the scalar simulator's single task and the host engine's
    # median masked batch (phase 7 fails unless the host engine's batches
    # have that median), padded to the run's task_pad_width
    G_log, G_pca = HOST_BATCH["logreg_block_sub"], HOST_BATCH["pca_block_sub"]
    per_kernel["logreg_block_sub"] += check_block_sub(
        torch, "logreg", Xh, yh, rng,
        shapes={"scalar G=1": (100, 10, 10, 1), f"host G={G_log}": (100, 10, 10, G_log)})
    per_kernel["pca_block_sub"] += check_block_sub(
        torch, "pca", Xg, None, rng,
        shapes={"scalar G=1": (50, 5, 4, 1), f"host G={G_pca}": (50, 5, 4, G_pca)})
    # K1 and K2 at the §6 launch shapes (phase 8): every task padded to the
    # widest window of any ladder rung, 82 rows for the lb_scan recipe, the
    # whole 1000-row local range (rung 1) for pca_paper_scale
    per_kernel["logreg_block_sub"] += check_block_sub(
        torch, "logreg", Xh, yh, rng, shapes={"lb_scan": ("lb", 100, 10, 10)})
    per_kernel["pca_block_sub"] += check_block_sub(
        torch, "pca", Xg, None, rng, shapes={"pca lb": ("lb", 50, 5, 4)})
    # K7 at the §6 shapes: the lb_scan recipe's batched call (the device and
    # host engines) and its scalar call, and pca_paper_scale's batched call
    per_kernel["what_if_replay"] = [
        check_what_if(torch, 10, 100, 80, 0.02, rng),
        check_what_if(torch, 1, 100, 80, 0.02, rng),
        check_what_if(torch, 4, 50, 40, 0.02, rng),
        # under churn (phase 9): dead workers' draws +inf and per-scenario
        # waits w_eff = min(w, #alive), 80 in nine scenarios and 75 in one
        check_what_if(torch, 10, 100, 80, 0.02, rng, dead=[20] * 9 + [25]),
        check_what_if(torch, 1, 100, 80, 0.02, rng, dead=[20]),
    ]
    # K3 at the grid shape on a state a churn clear leaves: 200 slots of each
    # scenario with tag -1 and stale non-zero values
    per_kernel["grid_cache_update"].append(
        check_cache_walk(torch, 10, 200, 1000, 29, 60, rng, cleared=200))
    # phase 11's shapes: pca_grid_sharded's batch of 40 scenarios and a
    # shard's 10 (K2, K3), the churn column's shard of 2 scenarios (K1 on its
    # 4096 rows, K7 with its dead workers: 8 dead, then 4)
    per_kernel["pca_block_sub"] += check_block_sub(
        torch, "pca", Xg, None, rng, shapes={"sharded S=40": (50, 5, 40),
                                             "shard S=10": (50, 5, 10)})
    per_kernel["grid_cache_update"] += [check_cache_walk(torch, 40, 100, 250, 288, 80, rng),
                                        check_cache_walk(torch, 10, 100, 250, 288, 80, rng)]
    Xc, yc = (torch.as_tensor(a, device=dev) for a in make_higgs_like(4096, seed=0))
    per_kernel["logreg_block_sub"] += check_block_sub(
        torch, "logreg", Xc, yc, rng, shapes={"churn shard S=2": (40, 4, 2),
                                              "churn lb shard S=2": ("lb", 40, 4, 2)})
    per_kernel["what_if_replay"].append(check_what_if(torch, 2, 40, 32, 0.02, rng, dead=[8, 4]))
    # K3 at a dsag sweep of 5000 workers (p = 10): five windows of ranks, one
    # walk block per scenario; last, as its plain version's many launches
    # leave the profiler without device times for the kernels after it (so do
    # phases 4-7: every device time is taken in phase 3)
    per_kernel["grid_cache_update"].append(check_cache_walk(
        torch, 2, 10_000, 50_000, 29, 60, np.random.default_rng(1), plain_reps=1))
    if "--profile" in sys.argv[1:]:
        profile_paths(torch)
        profile_serving(torch)
        profile_training(torch)
        profile_families(torch)
    if {"--quick", "--profile", "--build-times"} & set(sys.argv[1:]):
        print(json.dumps({"per_kernel": per_kernel}))
        return

    print("phase 4: the grid and pca_paper_scale recipes through the kernels")
    sweep_launches, _, outcomes = run_recipes(torch)
    wide_launches = run_wide_sweep(torch)
    print("phase 5: the live two-tier trainer through the kernels")
    live_launches = run_live(torch)
    print("phase 6: serving qwen1.5-0.5b at full width and depth through K6")
    serving, server = run_serving(torch)
    print("phase 7: the scalar simulator and the host engine against the device engine, "
          "the live pin, the BENCH_sweep grid")
    t0 = time.perf_counter()
    engine_launches = run_engines(torch, outcomes)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    print("phase 8: §6 load balancing through the device, host and scalar engines")
    t0 = time.perf_counter()
    lb_launches = run_lb(torch, outcomes)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s")
    print("phase 9: elastic-fleet churn through the device, host and scalar engines")
    t0 = time.perf_counter()
    churn_launches = run_churn(torch, outcomes)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    print("phase 10: the paper path's leftovers and the live trainer's rest")
    t0 = time.perf_counter()
    paper_launches = run_paper_rest(torch, outcomes)
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    print("phase 11: scenario sharding of the device engine")
    t0 = time.perf_counter()
    sharding_launches = run_sharding(torch, outcomes)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    print("phase 12: the analysis layer: the lint on cuda:0, the kernels' bounds, the "
          "serving roofline")
    t0 = time.perf_counter()
    analysis = run_analysis(torch, per_kernel, serving, server)
    del server
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    print("phase 13: the model zoo's DSAG training path (qwen1.5-0.5b at full width)")
    t0 = time.perf_counter()
    training, train_launches, k4_row = run_training(torch)
    per_kernel["dsag_cache_update"].append(k4_row)
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    print("phase 14: serving the MoE, MLA, SSM and hybrid families at full width "
          "(mamba2-370m and zamba2-2.7b at full depth; grok-1-314b and deepseek-v2-236b cut "
          "to 4 layers)")
    t0 = time.perf_counter()
    families = run_families(torch)
    families["seconds"] = time.perf_counter() - t0
    print(f"  phase 14 took {families['seconds']:.1f} s")
    print("phase 15: serving the rest of the registry at full width (qwen2-7b, "
          "starcoder2-15b, pixtral-12b and whisper-base at full depth; qwen1.5-32b cut to "
          "32 of 64 layers); whisper-base trained at full width")
    t0 = time.perf_counter()
    registry = run_registry(torch)
    registry["seconds"] = time.perf_counter() - t0
    print(f"  phase 15 took {registry['seconds']:.1f} s")
    print("phase 16: training the MoE, MLA, SSM and hybrid families on the card "
          "(mamba2-370m at full depth, zamba2-2.7b at two groups of six layers; one layer of "
          "grok-1-314b, deepseek-v2-236b and pixtral-12b forward and backward)")
    t0 = time.perf_counter()
    fam_train, fam_train_launches, k4_rows = run_family_training(torch)
    per_kernel["dsag_cache_update"] += k4_rows
    fam_train["seconds"] = time.perf_counter() - t0
    print(f"  phase 16 took {fam_train['seconds']:.1f} s")
    print(f"phase 17: the mesh path: {MESH_ARCH} on a (data={MESH_SHAPE[0]}, "
          f"model={MESH_SHAPE[1]}) mesh of four ranks on cuda:0, against the unsharded port")
    t0 = time.perf_counter()
    mesh_res, mesh_launches, (k4_mesh, k6_mesh) = run_mesh(torch, smi.stdout.strip())
    per_kernel["dsag_cache_update"].append(k4_mesh)
    per_kernel["flash_attention"].append(k6_mesh)
    mesh_res["seconds"] = time.perf_counter() - t0
    print(f"  phase 17 took {mesh_res['seconds']:.1f} s")
    print(f"phase 18: the reference's production DSAG layouts: {MESH_ARCH} on (2, 2) and "
          f"(pod=2, data=2, model=1) meshes of four ranks on cuda:0 (zero, pod and none "
          f"groups, dsag=False, int8 slots, adafactor, a mesh trainer's checkpoint), against "
          f"the unsharded port")
    t0 = time.perf_counter()
    layouts_res, layouts_launches, (k4_lay, row_max_lay, int8_lay) = run_layouts(
        torch, smi.stdout.strip())
    per_kernel["dsag_cache_update"].append(k4_lay)
    per_kernel["dsag_cache_update_int8"].append(int8_lay)
    per_kernel["dsag_int8_row_max"] = [row_max_lay]
    layouts_res["seconds"] = time.perf_counter() - t0
    print(f"  phase 18 took {layouts_res['seconds']:.1f} s")
    print(f"phase 19: the MoE family on a mesh: grok-1-314b (ffn-sharded experts) and "
          f"deepseek-v2-236b (expert-parallel, MLA) on {MOE_MESH} meshes of four ranks on cuda:0: "
          f"served at published widths (1 layer, bf16 and float32), one full-width MoE "
          f"layer forward and backward, the production DSAG step at reduced widths, against the "
          f"unsharded port")
    t0 = time.perf_counter()
    moe_res, moe_launches, (k6_moe, row_max_moe, int8_moe) = run_moe_mesh(
        torch, smi.stdout.strip())
    per_kernel["flash_attention"].append(k6_moe)
    per_kernel["dsag_int8_row_max"].append(row_max_moe)
    per_kernel["dsag_cache_update_int8"].append(int8_moe)
    moe_res["seconds"] = time.perf_counter() - t0
    print(f"  phase 19 took {moe_res['seconds']:.1f} s")
    print("phase 20: the dry run: phase 18's step counted over meta tensors on rank 0 of a "
          "fake world, against its count on the card; one production cell at full width")
    t0 = time.perf_counter()
    dry_res = run_dryrun(torch, layouts_res, smi.stdout.strip())
    dry_res["seconds"] = time.perf_counter() - t0
    print(f"  phase 20 took {dry_res['seconds']:.1f} s")
    print("phase 21: the kernels line")
    reg_train = registry.pop("train_launches")
    launches = {k: sweep_launches[k] + live_launches[k] + wide_launches[k]
                + engine_launches.get(k, 0) + lb_launches.get(k, 0)
                + churn_launches.get(k, 0) + paper_launches.get(k, 0)
                + sharding_launches.get(k, 0) + train_launches.get(k, 0)
                + reg_train.get(k, 0) + fam_train_launches.get(k, 0)
                + mesh_launches.get(k, 0) + layouts_launches.get(k, 0)
                + moe_launches.get(k, 0)
                for k in sweep_launches}
    launches["flash_attention"] = (serving["launches"] + families["k6_main"]
                                   + registry["k6_main"] + mesh_launches["flash_attention"]
                                   + moe_launches["flash_attention"])

    meta = {
        "logreg_block_sub": ("src/repro_torch/kernels/csrc/block_sub.cu",
                             "src/repro/kernels/block_sub.py:134"),
        "pca_block_sub": ("src/repro_torch/kernels/csrc/block_sub.cu",
                          "src/repro/kernels/block_sub.py:99"),
        "grid_cache_update": ("src/repro_torch/kernels/csrc/cache_events.cu",
                              "src/repro/kernels/cache_events.py:107"),
        "dsag_cache_update": ("src/repro_torch/kernels/csrc/dsag_update.cu",
                              "src/repro/kernels/dsag_update.py:47"),
        # K4's int8 entry: the reference's int8 leaf update (jnp, no Pallas)
        "dsag_cache_update_int8": ("src/repro_torch/kernels/csrc/dsag_update.cu",
                                   "src/repro/core/dsag_pjit.py:165"),
        # K4-int8's split form's row-max pass (phase 18): the same reference line
        "dsag_int8_row_max": ("src/repro_torch/kernels/csrc/dsag_update.cu",
                              "src/repro/core/dsag_pjit.py:165"),
        "gram_matvec": ("src/repro_torch/kernels/csrc/gram_matvec.cu",
                        "src/repro/kernels/gram_matvec.py:41"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78"),
        # no TPU kernel: the XLA scan it replaces
        "what_if_replay": ("src/repro_torch/kernels/csrc/what_if.cu",
                           "src/repro/lb/jit_optimizer.py:157"),
    }
    kernels = []
    for name, rows in per_kernel.items():
        main_row = rows[0]  # the per-iteration call of the first recipe / job
        source, replaces = meta[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], launches_sweep=sweep_launches.get(name, 0),
            launches_wide_sweep=wide_launches.get(name, 0),
            launches_live=live_launches.get(name, 0),
            launches_engines=engine_launches.get(name, 0),
            launches_lb=lb_launches.get(name, 0),
            launches_churn=churn_launches.get(name, 0),
            launches_paper=paper_launches.get(name, 0),
            launches_sharding=sharding_launches.get(name, 0),
            launches_train=train_launches.get(name, 0),
            launches_serve=serving["launches"] if name == "flash_attention" else 0,
            launches_families=families["k6_main"] if name == "flash_attention" else 0,
            launches_registry=(registry["k6_main"] if name == "flash_attention"
                               else reg_train.get(name, 0)),
            launches_family_training=fam_train_launches.get(name, 0),
            launches_mesh=mesh_launches.get(name, 0),
            launches_layouts=layouts_launches.get(name, 0),
            launches_moe_mesh=moe_launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], kernel_ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            calls=[{k: v for k, v in r.items() if k not in COST_KEYS} for r in rows],
        ))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"roofline": analysis}))
    print(json.dumps({"training": training}))
    print(json.dumps({"families": families}))
    print(json.dumps({"registry": registry}))
    print(json.dumps({"family_training": fam_train}))
    print(json.dumps({"mesh": mesh_res}))
    print(json.dumps({"layouts": layouts_res}))
    print(json.dumps({"moe_mesh": moe_res}))
    print(json.dumps({"dryrun": dry_res}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
