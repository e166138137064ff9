"""Drive the PyTorch port on one CUDA card: the config-5 CVI step in
covariance form (unfused and with the fused combines) and in square-root
form, the temporal Poisson CVI fit in both forms, prediction at new times
on both models, hyperparameter training on both, the serving path
(posterior sampling, streaming assimilation and forecasts, and the
spatio-temporal model's predictions at new sites), the physics-informed
path (the Allen-Cahn, pendulum and monotonic CVI models with their
Monte-Carlo residuals, and `ode_gp`) and the scattered-sensor and
vector-field paths (scattered and sparse spatio-temporal models, the
Helmholtz flow, the magnetic field, the state-space LMC), and AOT serving
(config-5 `predict_f` exported with `torch.export`, reloaded and served),
and the batch GP family (BatchGP by Cholesky and CG, SVGP, the curl-free,
Helmholtz and derivative recipes, the batch LMC), and the nonlinear-dynamics
and volatility path (EKF / EKS and the iterated parallel EKS of
`NonlinearSSGP`, the dynamics zoo, the dynamic-correlation model, the L-BFGS
trainers), and the Markov-kernel zoo with the prior mean (Sum / Product
state spaces, `Periodic`, the Wiener family, means in the state-space
models, flows, uncertain inputs, the misc and aggregated batch kernels), and
the last batch-style models (`VecchiaGP` with its neighbour sets on the
card, `GPRN`, `LatentVariableGP`), and time-axis sharding (the filter and
smoother split over a `torch.distributed` DeviceMesh, on ranks that share
the card), and independent models stacked under `torch.func.vmap` (many
series in one step, every kernel launched once for all of them).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: versions, card name and power limit, TF32 off;
  2. build: compile the three kernel libraries from physs_gp_tpu_torch/csrc,
     one nvcc per source, side by side;
  3. kernels: each of the eight kernels against its plain PyTorch version on
     the card, in float64 and float32, at the main path's shapes (for the
     fused combines both routes, tiled at d = 3, 7, 31, 32 and block at
     d = 33, 56, at N = 1, 127, 128, 255, 256, 257, 25 000, each launch's
     route asserted, then unaligned, odd-strided and stride-0 operands and
     the blocked scan's strided and stride-0 views; for
     the solve the scan's [256, 32, 32] inverse with a stride-0 identity and the
     square-root scan's [512, 32, 32] with r = 64; for the LQ [512, 32, 64]
     and [256, 32, 64]), wide and odd shapes (d = 7, 31; d = 64 and 80 on
     the block kernels), with all-zero, rank-deficient, identity and
     chunk-first batch members; the product, the Gram + Cholesky, the solve
     and the LQ also on operands that are not 16-byte aligned (a view one
     element into its storage, an odd row stride), on a stride-0 batch and
     at N = 1, 255, 257; the temporal model's shapes (d = 1 and 2: every
     product with sizes in {1, 2}, the solves with r = 1 .. 6, the LQ at
     m = d .. 6, the Cholesky, the Gram + Cholesky) at N = 1, 255, 257 and
     100 000, all on the warp kernels; the scattered path's shapes at
     T = 100 000, chunk 25 000 (d = 24 and p = 4 operands with masked
     filler rows, the scan's strided views at its batches 128 to 512, the
     SC_* tables), all on the warp kernels; then kernel, plain and library call
     timed with CUDA events beside the bound from bytes and operations, the
     product, the Gram + Cholesky, the solve and the LQ also at the scans'
     batches ([256, 32, 32]; the solve also [512, 32, 32] with r = 64, the
     LQ [512, 32, 64] and [256, 32, 64]; the fused combines at [256] and
     [128] in float32 and float64, beside the unfused route's time) as
     device time back to back, and every kernel the temporal model launches
     at its shapes there (the square-root scan's [1024] and [2048], the
     chunk's 50 000 and the series' 100 000);
  3b. backward: the backward of every kernel wrapper on the training path
     (`bmm` with every (ta, tb), `psd_solve`, `psd_solve_logdet`,
     `gen_solve`, `_cholesky_any(assume_psd=True)`, `tria`, `tria_sum`,
     both fused combines) at the scans' batches and at full width, with
     contiguous, expanded and transposed cotangents, against the same call
     with every wrapper on its plain version, on the same card tensors
     (every batch member); then the kernel calls only the backward makes,
     timed;
  4. anchors against the JAX reference, float64, T = 256, 3 steps: the
     covariance slice, unfused and with PHYSS_FUSED_COMBINE=1, against
     tests/data/config5_T256_golden.npz and the square-root slice against
     tests/data/config5_sqrt_T256_golden.npz, without and with the knob
     (which must leave the square-root slice unfused); the fitted models'
     predict_f at 40 new times, and the temporal slice in both forms with
     its predict_f, predict_y and nlpd at 50 new times, against
     tests/data/temporal_T256_golden.npz and predict_T256_golden.npz; the
     temporal covariance slice again with the knob, which must launch no
     fused combine and give the same ELBOs bit for bit; the training
     anchors against tests/data/train_T256_golden.npz (config-5 covariance,
     also with the knob, and square-root; the temporal model in both
     forms): after 2 natgrad_scan steps the objective and its gradient,
     then 3 vb_ng_adam_scan iterations;
  5. oracles, float64: the config-5 fused scans at T = 2048 against the
     port's sequential Kalman filter and RTS smoother; the temporal model
     at T = 2048, its flat d = 2 scans against the sequential covariance
     pass and its parallel square-root scans against the sequential
     square-root filter and smoother;
  6. full width: config-5 at T = 100 000, chunk 25 000, 3 steps each:
     covariance float32 then float64, the same with PHYSS_FUSED_COMBINE=1,
     square-root float32 then float64, the float32 covariance and
     square-root models then predicting at 1000 new times; the temporal
     Poisson fit at T = 100 000, chunk 50 000, 1024 blocks, 3 steps, in
     both forms and both types, each fitted model then predicting at 1000
     new times (predict_f, predict_y, nlpd), the two forms held together in
     float64 at rtol 1e-6. Launch counters are reset just before each
     float32 path and read just after, with the route each solve, LQ,
     Cholesky and fused launch took (a warp per matrix, or four warps per
     fused pair, for d <= 32; a block above): on every path each launch
     takes the warp or tiled kernels;
  7. full-width training: 3 vb_ng_adam_scan iterations of config-5 (float32
     in covariance, fused and square-root form, float64 in covariance form)
     and 3 VB_NG_Adam iterations of the temporal model (both forms and
     types), each iteration split into its natural-gradient half and its
     Adam half's forward, backward and update, with peak memory and the
     forward's and the backward's launches per kernel and route; the
     float32 gradient at each float64 run's state against the float64 one;
  8. serving anchors, float64, T = 256, against
     tests/data/serving_T256_golden.npz (run before phase 6, which pins
     PHYSS_KZZ_JITTER): config-5's `sample_f` fed the JAX draws in
     covariance, square-root and fused form, `StreamingGP` and
     `StreamingCVI` states, segment moments and forecasts, and
     `predict_grid` of `advection_diffusion_gp` at config-5's geometry;
  9. serving at config-5 width (T = 100 000, chunk 25 000): F1 `sample_f`
     (16 paths in covariance form, 4 in square-root form, at 1000 new
     times) held to `predict_f` by its standardised draws; F2
     `StreamingGP` assimilation (float64, against the batch filter) and 50
     float32 requests (update 256 rows, forecast 64 times; p50 and p99);
     F3 `StreamingCVI` on config-5 (float64, segment ELBOs summing to the
     batch lml); F4 `StreamingCVI` on the temporal Poisson data (float32,
     10 segments, against the batch fit); F5 `advection_diffusion_gp`
     (float64: its lml equal to F2's, `predict_grid` at 64 sites at the
     training times and at 1000 new times); each path timed with its
     peak memory, its launch counters reset just before it and read just
     after, on the warp and tiled kernels only;
 10. physics anchors, float64, against tests/data/physics_golden.npz (made
     by scripts/port/make_physics_golden.py from the JAX package): the
     Allen-Cahn experiment at full width (T = 56, Ns = 10, Nc = 12,
     n_mc = 32) for 3 Gauss-Newton steps fed the JAX draws, in sequential
     covariance and square-root form, the pendulum and the monotonic model
     at their experiments' sizes (3 steps each) and `ode_gp`'s lml and
     `predict_f`; then the experiment's hardware gate on the JAX-trained
     Allen-Cahn sites (float64 covariance posterior to 1e-7, float32
     square-root posterior within max |Δmean| 0.02 of the JAX CPU float32
     one);
 11. the physics path at full width: Allen-Cahn, float32, sequential
     square-root, 20 Gauss-Newton iterations with fresh draws and `nlpd` on
     the extrapolation window, with each iteration's wall time, peak
     memory, the busy share of one profiled iteration and the launches by
     kernel and route: this path must take the block-per-matrix kernels of
     the solves, the LQ and the Cholesky (d = 34, the [64, 64] update
     pre-array), which the kernels phase also checks and times at these
     shapes;
 12. vector-field anchors (Phase A), float64, against
     tests/data/vector_field_golden.npz (made by
     scripts/port/make_vector_field_golden.py from the JAX package): first
     both LQ kernels on a Householder tail with a subnormal vᵀv; then the
     scattered experiment's full configuration (200 times, 516 rows, the 12
     k-means sites the JAX recipe chose; d = 24, Ng = 4; chunk 64, padded)
     in parallel covariance, square-root and fused form (lml, the posterior
     through `unsort`, `scattered_st_predict` at the held-out rows),
     `sparse_st_gp` with its gradient, Helmholtz at the quick configuration
     (D = 100: PyTorch's own routines) in sequential covariance and
     square-root form and one CVI step, the magnetic field with and without
     the potential block in both scans, and `lmc_markov_gp` (lml, two
     Poisson CVI steps); the Helmholtz square-root anchor must take the
     "lq" wrapper's library route (its pre-arrays exceed `lq_fits`);
 13. the scattered model at full length (Phase B): the experiment's field,
     noise, kernels and sites at 25 times per unit over 100 000 times
     (about 250 000 rows, 20 % held out), float32, parallel covariance and
     square-root form at chunk 25 000: `log_marginal_likelihood`,
     `posterior` and `scattered_st_predict` timed, peak memory, launches by
     kernel and route (every kernel of the form, warp routes only), the
     float64 lml beside the float32 ones (relative gap at most
     SCATTERED_LML_GAP); then the outcome gates of the
     scattered and the Helmholtz experiments
     (scripts/port/vector_field_outcome.py);
 14. AOT serving (`utils/serving`, the kernels as custom ops): the kernels
     phase also times the host cost of one `bmm` call at [256, 32, 32]
     through the dispatcher (`torch.ops.physs_gp.bmm`) against the launch
     code called directly and the eager wrapper; after the float64 anchors,
     their fitted T = 256 models (covariance with the fused knob on,
     square-root) export `predict_f` at the golden's 40 new times on the
     card, reload it from the bytes and hold it to predict_T256_golden.npz
     (the two programs together launch all eight kernels); after phase 6 the float32 covariance model at EXPORT_T
     steps (chunk EXPORT_CHUNK, 3 natural-gradient steps) exports its
     `predict_f` at 1000 new times, reloads it and holds it to the live
     call (rtol 1e-6, the same launches per kernel), with the export and
     load wall, nodes, bytes, p50 / p99 of EXPORT_CALLS loaded and live
     calls and the peak memory; the `kernels` line's `launches_by_path`
     has the loaded call's launches under "export";
 15. batch anchors (`phase_batch_anchor`), float64, against
     tests/data/batch_golden.npz (made by scripts/port/make_batch_golden.py
     from the JAX package): `curl_free_gp` and `helmholtz_gp` at N = 40,
     `deriv_gp` with NaNs and joint samples, CG `BatchGP` fed the JAX
     probes, SVGP whitened and unwhitened, the monotonic batch-VI arm at
     its quick size, a batch LMC with a constant mean; counters reset per
     configuration, each taking the `chol` kernel's warp or block route on
     its 2-D factors of n <= 80 (under "batch anchors f64" in
     `launches_by_path`);
 16. the batch family at full size (`phase_batch_full`): the curl-free
     experiment (float32) against its independent-RBF baseline, the
     monotonic batch-VI arm (float64, 300 steps) against the JAX package's
     float64 runs, `BatchGP` at n = 2048 / 4096 / 8192 by Cholesky and by
     CG (lml and gradient wall, peak, CG steps, lml gap <= 3e-3), the SLQ's
     `eigh` timed, a curl-free Gram at N = 4096 (build, lml and gradient).
 17. dynamics anchors (`phase_dynamics_anchor`), float64, against
     tests/data/dynamics_golden.npz (made by
     scripts/port/make_dynamics_golden.py from the JAX package): the
     pendulum `NonlinearSSGP` (EKF / EKS, the damping gradient, the iterated
     parallel EKS at d = 2), `lorenz_gp` at d = 3 by both methods (the
     parallel passes also with PHYSS_FUSED_COMBINE=1), `lotka_volterra_gp`,
     `latent_force_gp`, `euler_maruyama_sample_given`,
     `correlation_cholesky`, `LMC.init_drd`, `HetGaussian`,
     `dynamic_covariance_gp` on the JAX draws (rtol 1e-9), `LBFGSTrainer`
     and `VB_NG_LBFGS` (rtol 1e-8); counters reset per configuration (under
     "dynamics anchors f64" in `launches_by_path`);
 18. the dynamics path at length (`phase_dynamics_full`): the JAX tests'
     outcome gates on their own data beside the JAX package's figures,
     `lorenz_gp` at T = 20 000 (dt 0.0002) by the iterated parallel EKS in
     float32 and float64 (first propagation and passes timed apart), the
     dynamic-correlation model at P = 5 over T = 2520, `VB_NG_LBFGS` on
     config-5 at T = 100 000 (float32, 2 epochs, line-search trials per
     step); each run's launches, which must include `bmm` and `gj_solve` on
     the d = 3, d = 20 and config-5 runs.
 19. Markov anchors (`phase_markov_anchor`), float64, against
     tests/data/markov_golden.npz (made by scripts/port/make_markov_golden.py
     from the JAX package): a bare `Periodic`, `Matern32 + Periodic` (a Q
     block that is exactly zero) and the d = 30 quasi-periodic model with a
     `LinearMean` in covariance and square-root form at T = 256, the four
     Wiener kinds, `StreamingGP` on `WienerVelocity` with a mean anchored at
     t[0], a `ConstantMean`, 3 Poisson `CVIGP` steps with a mean, every
     flow's `TransformedData`, 3 `UncertainInputLikelihood` CVI steps and
     `BatchGP` on the misc and aggregated kernels (lml, ELBO and means rtol
     1e-9, variances 1e-7); counters reset per configuration, all on the
     warp routes (under "markov anchors f64" in `launches_by_path`); the
     kernels phase checks every kernel at this path's shapes
     (`_check_markov_shapes`);
 20. the Markov path at length (`phase_markov_full`): `Matern32(720) +
     Periodic(24, J = 6) * Matern32(336)` (d = 30) with a `LinearMean` on
     the log of 100 000 hourly values (2 % missing), chunk 25 000: lml + the
     log-Jacobian correction, `predict_f` at 1000 new times (200 past the
     data) and `to_data_space`, timed with the peak memory, in covariance
     and square-root form, float32 and float64, and in covariance form with
     PHYSS_FUSED_COMBINE=1; then 3 Poisson `CVIGP` steps with a
     `ConstantMean` on counts of the same structure (float32); each run's
     launches by kernel and route (warp or tiled only) under "markov ..." in
     `launches_by_path`; the float64 forms' lml within rtol 1e-6 and each
     float32 lml within 1e-2 of its float64 one.
 21. Vecchia / GPRN / LatentVariableGP anchors (`phase_vecchia_gprn_anchor`),
     float64, against tests/data/vecchia_golden.npz (made by
     scripts/port/make_vecchia_golden.py from the JAX package): `VecchiaGP`
     at N = 200, m = 12 (lml, gradient, predictions, nlpd; with missing
     rows and a `ConstantMean`), `GPRN` in each mixing on the JAX draws,
     `LatentVariableGP` in both modes (rtol 1e-9, variances 1e-7); counters
     reset per configuration (under "vecchia anchors f64" in
     `launches_by_path`); the kernels phase checks and times `gj_solve` at
     Vecchia's [100 000, 16, 16], r = 2 (warp route) and `chol` at GPRN's
     [1, 64, 64] (block route), in float32 and float64 (`at_vecchia`);
 22. the slice at full size (`phase_vecchia_gprn_full`): the card's
     neighbour sets against the CPU's at N = 5 000; `VecchiaGP` at
     N = 100 000 on [0, 10]^2, m = 16 (ordering and neighbour sets on the
     card, lml, gradient, 20 Adam steps, predictions at 1 000 points, in
     float32 and float64, the float32 lml within 1e-3 of float64's, every
     `gj_solve` on the warp route); the gap to the exact lml at N = 8 192
     falling as m grows; `GPRN` at N = 20 000, P = L = 3, M = 64 in each
     mixing and type (`chol` on its block route) and its sign-dependent
     fit; `LatentVariableGP` at N = 4 096 in both modes and its two-branch
     separation.
 23. sharding anchors (`phase_sharded_anchor`), float64: spawned ranks
     (`parallel/ranks.py`) share cuda:0, n = 1 under NCCL and n = 2 and 4
     under gloo, the three spawns side by side; on every rank the config-5
     covariance and square-root slices and the temporal slice in both forms
     (T = 256, chunk 64, 8 blocks, 3 steps) through the ("t",) mesh, each
     rank holding its segment of the sites, equal the same rank's unsharded
     run (lml and ELBOs rtol 1e-9, sites gathered over the series and
     posterior moments 1e-7) and the golden files above; then the dryrun's
     checks (`parallel/dryrun.py`: lml value and gradient, a Poisson CVI
     step, 3 `natgrad_scan` steps, a config-5 step, at n = 4 the composite
     dp x t value and gradient on a 2 x 2 mesh) against their unsharded
     runs (rtol 1e-8), and the dryrun's part 2 (dp-vmap: 2 n Poisson series,
     each rank stacking its two for one step, the summed ELBO all-reduced
     over a ("dp",) mesh) against one single-process stack of all 2 n;
 24. sharding at full width (`phase_sharded_full`, after phase 6, whose
     ELBOs it compares with): config-5 at T = 100 000, chunk 25 000, on 4
     gloo ranks that share the card, each building, holding and updating
     its 25 000-step segment alone, in covariance, fused and square-root
     form, float32 and float64: the surrogate lml (the sharded filter) and
     its gradient, the float64 ones against this process's unsharded ones
     (the square-root float64 gradient at T = 50 000: at 100 000 four ranks
     do not fit on one card; the unsharded peak there is printed), then 2
     natural-gradient steps against phase 6's ELBOs (float64 rtol
     1e-9; float32 step 1 within 1e-2 of float64, the float32 gaps to phase
     6's printed); per rank the walls, and for the gradient and the steps
     apart (counted from after the model is built) the peak memory against
     the unsharded run's (this process's gradient, phase 6's steps; at most
     0.4 of it), the exchanges' calls, bytes and time (totals, results
     gathered to full T: none allowed, gradients) and the launches by
     kernel and route (under "sharded ... rank k lml + gradient" and "...
     steps" in `launches_by_path`), and the card's memory in use by all
     processes. No speed-up figure: the ranks share one card.
 25. stacked anchors (`phase_stacked_anchor`, `models/stacked.py`: B
     independent models under `torch.func.vmap`), float64, T = 256: B = 8
     temporal series in both forms and B = 2 config-5 series in covariance,
     fused and square-root form, each member with its own data and
     parameters, 2 `natgrad_scan` steps of the stack against each member's
     own run (ELBOs rtol 1e-9, sites and posterior moments 1e-7, bit for bit
     printed); then each of the eight kernel wrappers under `vmap` (one
     launch) against a loop over the members (B launches) at d = 32 and
     d = 2, rel 1e-12;
 26. stacks at full size (`phase_stacked_full`), float32: the temporal
     model as B = 1024 series of T = 1000 in both forms, config-5 as B = 4
     series of T = 25 000 (chunk 25 000) in covariance, fused and
     square-root form: one stacked `step_with_elbo` after a warm-up step,
     its wall, peak memory and launches by kernel and route, against one
     series' step; that step once more with every wrapper on its plain
     version on the card: every member's ELBO and sites equal (rtol
     1e-5); 8 series spread over the stack, the last included, alone: their
     ELBOs equal the stack's (rtol 1e-5); the stacked step's launches equal
     to one series' step's (`launches_per_stacked_step` in the summary).
The total time is printed before the summary lines. The second-to-last line is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Needs one card; imports no JAX.
"""
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "config5_T256_golden.npz")
GOLDEN_SQRT = os.path.join(REPO, "tests", "data", "config5_sqrt_T256_golden.npz")
GOLDEN_TEMPORAL = os.path.join(REPO, "tests", "data", "temporal_T256_golden.npz")
GOLDEN_PREDICT = os.path.join(REPO, "tests", "data", "predict_T256_golden.npz")
# Normwise relative tolerance: max|kernel - plain| / max|plain|. "rankdef" is
# for the rank-deficient member of a Cholesky batch: its floored pivots
# amplify the rounding noise of the Gram, which the kernel and the plain
# version sum in different orders, by ~1/sqrt(eps_rel); in float32 the two
# factors' products then differ by ~1e-3 of the member's scale.
TOL = {
    torch.float64: {"bmm": 1e-12, "solve": 1e-10, "logdet": 1e-10, "factor": 1e-11,
                    "rankdef": 1e-11, "fused": 1e-10},
    torch.float32: {"bmm": 1e-5, "solve": 1e-4, "logdet": 1e-4, "factor": 2e-5,
                    "rankdef": 1e-2, "fused": 1e-4},  # fused: the solve's, per field
}
N_MAIN, N_LML, D = 25_000, 100_000, 32
N_SCAN = 256  # blocks of the blocked scan: the batch of its sequential pass
# the temporal model at the bench's settings: T, chunk, blocks of the scan
N_TEMPORAL, TEMPORAL_CHUNK, TEMPORAL_BLOCKS = 100_000, 50_000, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, published
FP64_FLOPS_PER_S = 34e12  # H100 SXM, float64 outside the tensor cores, published
SOURCES = {
    "bmm": "batched_linalg", "gj_solve": "batched_linalg", "gj_solve_logdet": "batched_linalg",
    "lq": "batched_factor", "chol": "batched_factor", "chol_gram": "batched_factor",
    "fused_filter": "fused_combine", "fused_smooth": "fused_combine",
}
REPLACES = {
    "bmm": "physs_gp_tpu/ops/pallas/batched_linalg.py:131",
    "gj_solve": "physs_gp_tpu/ops/pallas/batched_linalg.py:68",
    "gj_solve_logdet": "physs_gp_tpu/ops/pallas/batched_linalg.py:94",
    "lq": "physs_gp_tpu/ops/pallas/batched_qr.py:46",
    "chol": "physs_gp_tpu/ops/pallas/batched_chol.py:101",
    "chol_gram": "physs_gp_tpu/ops/pallas/batched_chol.py:56",
    "fused_filter": "physs_gp_tpu/ops/pallas/fused_combine.py:130",
    "fused_smooth": "physs_gp_tpu/ops/pallas/fused_combine.py:161",
}
FUSED = ("fused_filter", "fused_smooth")
# the kernels one config-5 `predict_f` launches, by form (no site ELL in
# square-root form); the knob adds the fused combines
EXPORT_KERNELS = {"cov": ("bmm", "gj_solve", "gj_solve_logdet", "chol"),
                  "sqrt": ("bmm", "gj_solve", "lq", "chol", "chol_gram")}
EXPORT_CALLS = 20  # loaded and live calls of the exported full-width predict_f
# The exported full-width model: two chunks (T + 1000 new times = 5 000
# steps at chunk 2 500), so the program still carries a chunk boundary. At
# T = 100 000 (five chunks of 25 000, 34 065 nodes) export took 315 s on an
# H100 machine's host, load 61 s; at T = 49 000 (two chunks of 25 000,
# 14 534 nodes) 192-315 s, load 27 s; at T = 24 000 (two chunks of 12 500,
# 9046 nodes) 121-222 s for the whole phase on two hosts; at T = 12 000
# (two chunks of 6 500, 6470 nodes) 92-116 s: still among the script's
# largest phases, and the one whose host time spreads most.
# T = 6 000 at chunk 3 500 until the stacked phases came (PR 18: cut to
# keep the script's time)
EXPORT_T, EXPORT_CHUNK = 4_000, 2_500
# the export anchors predict the 256 + 40 steps in one chunk of 64 blocks
# (5 sequential steps and 6 levels of block totals to trace; with 32 blocks
# 10 and 5, 2357 and 3905 nodes, 78-94 s for the phase)
EXPORT_ANCHOR_CHUNK, EXPORT_ANCHOR_BLOCKS = 320, "64"
# the full-width run whose count stands under `launches` in the summary
LAUNCHES_PATH = {name: "cov fused f32" if name in FUSED else "sqrt f32" for name in SOURCES}


def phase_device():
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    print("[device] TF32 off for matmul and cuDNN")


def phase_build():
    from physs_gp_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build()
    print(f"[build] {len(build.build_info)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, info in build.build_info.items():
        print(f"[build] {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, dtype=torch.float64, device="cuda")


def _spd(gen, N, d, dtype, dom=5.0):
    A = _randn(gen, N, d, d)
    return (A @ A.transpose(-1, -2) / d + dom * torch.eye(d, dtype=torch.float64, device="cuda")).to(dtype)


def _icj(gen, N, d, dtype):
    """Identity-dominated I + C J with SPD C, J, as in the filtering combine."""
    C = _spd(gen, N, d, torch.float64, dom=1.0) * 0.1
    J = _spd(gen, N, d, torch.float64, dom=1.0) * 0.1
    return (torch.eye(d, dtype=torch.float64, device="cuda") + C @ J).to(dtype)


def _factors(gen, N, d, m, dtype, rank=2):
    """[N, d, m] with member 0 all zero and member 1 of the given rank."""
    X = _randn(gen, N, d, m)
    X[0] = 0.0
    if N > 1:
        X[1] = _randn(gen, d, rank) @ _randn(gen, rank, m)
    return X.to(dtype)


def _filter_elems(gen, N, d, dtype, first=1):
    """Random filtering elements (A, b, C, J, eta); member 0 is the identity
    element, member `first` (0 when N = 1) a chunk's first element (A = 0,
    J = 0, eta = 0)."""
    from physs_gp_tpu_torch.ops.parallel_kalman import _FilterElems

    A, b, eta = 0.1 * _randn(gen, N, d, d), _randn(gen, N, d), _randn(gen, N, d)
    C = 0.3 * _spd(gen, N, d, torch.float64, dom=1.0)
    J = 0.3 * _spd(gen, N, d, torch.float64, dom=1.0)
    A[0], b[0], C[0], J[0], eta[0] = torch.eye(d, dtype=torch.float64, device="cuda"), 0.0, 0.0, 0.0, 0.0
    first = min(first, N - 1)
    A[first], J[first], eta[first] = 0.0, 0.0, 0.0
    return _FilterElems(*(x.to(dtype) for x in (A, b, C, J, eta)))


def _smoother_elems(gen, N, d, dtype, last=1):
    """Random smoothing elements (E, g, L); member 0 is the identity element,
    member `last` (0 when N = 1) a series' last element (E = 0)."""
    from physs_gp_tpu_torch.ops.parallel_kalman import _SmootherElems

    E, g = 0.2 * _randn(gen, N, d, d), _randn(gen, N, d)
    L = _spd(gen, N, d, torch.float64, dom=0.5)
    E[0], g[0], L[0] = torch.eye(d, dtype=torch.float64, device="cuda"), 0.0, 0.0
    E[min(last, N - 1)] = 0.0
    return _SmootherElems(*(x.to(dtype) for x in (E, g, L)))


def _scan_views(elems, ident, B, L, l):
    """(carry, x[l]) as the blocked scan's sequential pass builds them: the
    identity element expanded with batch stride 0 and a strided view of
    [L, B, ...] (batch stride L d d, L d for the vectors)."""
    carry = type(elems)(*(x.expand((B,) + tuple(x.shape)) for x in ident))
    x = type(elems)(*(v.reshape((B, L) + tuple(v.shape[1:])).transpose(0, 1)[l] for v in elems))
    return carry, x


def _layouts(x):
    """The values of x [N, rows, cols] as the main path's views hand them to
    a kernel: contiguous, starting one element into the storage, with an odd
    row stride (both off the 16-byte staging), and member 0 as a stride-0
    batch."""
    N, rows, cols = x.shape
    shifted = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    shifted[1:] = x.reshape(-1)
    odd = torch.zeros(N, rows, cols + 3 - cols % 2, dtype=x.dtype, device=x.device)
    odd[..., :cols] = x
    return {"contiguous": x, "shifted": shifted[1:].view(N, rows, cols),
            "odd row stride": odd[..., :cols], "stride-0 batch": x[:1].expand(N, rows, cols)}


def _chol_rank(d):
    # at d >= 32 a rank-2 Gram overflows the reference algorithm's pivot floor
    return 2 if d <= 8 else d - 1


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max()), float((x - ref).abs().max())


def _time(fn, target_s=0.2):
    """ms per call over a run of calls (fewer for slow calls), CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(1, min(20, int(target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _nbytes(*xs):
    """Bytes in memory: an expanded (stride-0) operand counts its storage once."""
    return sum(min(x.untyped_storage().nbytes(), x.numel() * x.element_size()) for x in xs)


def phase_kernels():
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import build
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {name: 0.0 for name in SOURCES}

    def report(name, kind, rel, ab, dtype, label):
        ok = rel <= TOL[dtype][kind]
        print(f"[kernels] {name} {label} {str(dtype)[6:]}: max_abs_err {ab:.3e} "
              f"rel {rel:.3e} (tol {TOL[dtype][kind]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        if dtype == torch.float32 and kind != "rankdef":
            worst[name] = max(worst[name], ab)

    def check(name, kind, out, ref, dtype, label):
        report(name, kind, *_rel(out, ref), dtype, label)

    def check_factor(name, L, Lp, dtype, label, floored):
        """All finite; L and L Lᵀ against the plain factor. With `floored`,
        member 1 (rank-deficient, floored pivots) is held on L Lᵀ alone."""
        if not torch.isfinite(L).all():
            raise AssertionError(f"{name} {label}: non-finite factor")
        keep = torch.ones(L.shape[0], dtype=torch.bool, device=L.device)
        if floored and L.shape[0] > 1:
            keep[1] = False
        G, Gp = L @ L.transpose(-1, -2), Lp @ Lp.transpose(-1, -2)
        report(name, "factor", *_rel(L[keep], Lp[keep]), dtype, f"{label} L")
        report(name, "factor", *_rel(G[keep], Gp[keep]), dtype, f"{label} L L^T")
        if not keep.all():
            report(name, "rankdef", *_rel(G[1], Gp[1]), dtype, f"{label} rank-deficient L L^T")

    def check_solve(name, X, Xp, dtype, label):
        """Members with a zero pivot (all-zero, singular) are non-finite in
        both; the rest against the plain solve."""
        fin, finp = (torch.isfinite(x).flatten(1).all(1) for x in (X, Xp))
        if not torch.equal(fin, finp) or (X.shape[0] >= 3 and fin[0]):
            raise AssertionError(f"{name} {label}: the non-finite members differ")
        check(name, "solve", X[fin], Xp[fin], dtype, label)

    def check_fused(name, out, ref, dtype, label):
        for field, a, b in zip(out._fields, out, ref):
            if not a.is_contiguous():
                raise AssertionError(f"{name} {label}: {field} is not contiguous")
            ab = float((a - b).abs().max())
            report(name, "fused", ab / max(float(b.abs().max()), 1e-30), ab, dtype, f"{label} {field}")

    def check_fused_pair(ei, ej, sj, si, dtype, label):
        """Both combines against their plain versions, each launch on the
        route its d selects (tiled for d <= 32, block above)."""
        d = ei.A.shape[-1]
        build.reset_launch_counts(*FUSED)
        check_fused("fused_filter", fc.fused_filtering_combine(ei, ej),
                    fc.fused_filter_plain(ei, ej), dtype, label)
        check_fused("fused_smooth", fc.fused_smoothing_combine(sj, si),
                    fc.fused_smooth_plain(sj, si), dtype, label)
        want = "tiled" if d <= D else "block"
        routes = build.route_counts(*FUSED)
        if any(routes[k][want] != 1 for k in FUSED):
            raise AssertionError(f"fused combines {label}: routes {routes}, expected {want}")

    for dtype in (torch.float64, torch.float32):
        wide = dtype == torch.float64  # d = 64 and 80 run in float64 (the fused combines' d > 32 in both)
        # bmm: all four transposes at [25000, 32, 32], rectangular, edges
        cases = [((N_MAIN, D, D), (N_MAIN, D, D), ta, tb) for ta in (False, True) for tb in (False, True)]
        cases += [((N_MAIN, D, D), (N_MAIN, D, 2 * D + 1), False, False),
                  ((N_MAIN, 2 * D + 1, D), (N_MAIN, 2 * D + 1, D), True, False),
                  ((1, 80, 80), (1, 80, 80), False, True),
                  ((300, 7, 7), (300, 7, 7), True, True)]
        for sa, sb, ta, tb in cases:
            A = _randn(gen, *sa).to(dtype)
            B = _randn(gen, *sb).to(dtype)
            check("bmm", "bmm", bl.batch_bmm(A, B, ta, tb), bl.bmm_plain(A, B, ta, tb),
                  dtype, f"{list(sa)}x{list(sb)} ta={ta:d} tb={tb:d}")
        # the same on unaligned, odd-strided and stride-0 operands, ragged batches
        pairs = [("shifted", "contiguous"), ("contiguous", "odd row stride"),
                 ("stride-0 batch", "shifted"), ("odd row stride", "stride-0 batch")]
        for N in (1, 255, 257, N_SCAN):
            As, Bs = _layouts(_randn(gen, N, D, D).to(dtype)), _layouts(_randn(gen, N, D, D).to(dtype))
            if build.aligned16(As["shifted"]) or build.aligned16(As["odd row stride"]) \
                    or not build.aligned16(As["stride-0 batch"]):
                raise AssertionError("bmm: the operand layouts do not exercise both stagings")
            for (la, lb), (ta, tb) in zip(pairs, [(False, True), (False, False), (True, False), (True, True)]):
                check("bmm", "bmm", bl.batch_bmm(As[la], Bs[lb], ta, tb),
                      bl.bmm_plain(As[la], Bs[lb], ta, tb), dtype,
                      f"[{N},{D},{D}] {la} x {lb} ta={ta:d} tb={tb:d}")
        # solves: identity-dominated and SPD systems at the main-path widths
        for N, d, r, mk in [(N_MAIN, D, 1, _spd), (N_MAIN, D, D, _icj),
                            (N_MAIN, D, 2 * D + 1, _spd), (N_MAIN, D, 3 * D + 1, _spd),
                            (1, 80, 80, _spd), (300, 7, 3, _icj)]:
            M = mk(gen, N, d, dtype)
            R = _randn(gen, N, d, r).to(dtype)
            check("gj_solve", "solve", bl.batch_solve(M, R), bl.gj_solve_plain(M, R),
                  dtype, f"[{N},{d},{d}] r={r}")
        for N, d, r in [(N_MAIN, D, 1), (N_MAIN, D, D), (1, 80, 80), (300, 7, 3)]:
            M = _spd(gen, N, d, dtype)
            R = _randn(gen, N, d, r).to(dtype)
            X, ld = bl.batch_solve_logdet(M, R)
            Xp, ldp = bl.gj_solve_logdet_plain(M, R)
            check("gj_solve_logdet", "solve", X, Xp, dtype, f"[{N},{d},{d}] r={r} X")
            check("gj_solve_logdet", "logdet", ld, ldp, dtype, f"[{N},{d},{d}] r={r} logdet")
        # the scans' solves (stride-0 identity, r = 64), ragged batches and
        # layouts, d = 31 and 64 (block kernel), zero / identity / singular
        # members: a zero pivot is non-finite in kernel and plain alike
        eye = torch.eye(D, dtype=dtype, device="cuda")
        for N, d, r, rhs in [(N_SCAN, D, D, "stride-0 identity"), (N_SCAN // 2, D, D, "stride-0 identity"),
                             (2 * N_SCAN, D, 2 * D, "contiguous"), (1, D, D, "odd row stride"),
                             (255, D, D + 1, "shifted"), (257, 31, 3 * D + 1, "odd row stride"),
                             (300, 7, 3, "shifted"), (2000, 64, 2 * 64 + 1, "contiguous")]:
            if d > D and not wide:
                continue
            M = _spd(gen, N, d, dtype)
            if N >= 3:
                M[0], M[1], M[2, 0] = 0.0, torch.eye(d, dtype=dtype, device="cuda"), 0.0
            R = eye[:d, :d].expand(N, d, d) if rhs == "stride-0 identity" \
                else _layouts(_randn(gen, N, d, r).to(dtype))[rhs]
            for layout, Mv in _layouts(M).items():
                if layout == "stride-0 batch":
                    continue
                label = f"[{N},{d},{d}] {layout} r={r} {rhs}" + (", zero/identity/singular members" if N >= 3 else "")
                check_solve("gj_solve", bl.batch_solve(Mv, R), bl.gj_solve_plain(Mv, R), dtype, label)
                X, ld = bl.batch_solve_logdet(Mv, R)
                Xp, ldp = bl.gj_solve_logdet_plain(Mv, R)
                check_solve("gj_solve_logdet", X, Xp, dtype, label + " X")
                check_solve("gj_solve_logdet", ld[:, None, None], ldp[:, None, None], dtype,
                            label + " logdet")
        # LQ: L_S, Xi, Z and lml pre-arrays, the combine's stacked Xi/Lam
        for N, d, m in [(N_MAIN, D, 2 * D), (N_MAIN, D, D), (2 * N_SCAN, D, 2 * D), (N_SCAN, D, 2 * D),
                        (N_LML, D, 2 * D), (2000, 64, 128), (500, 80, 160), (300, 7, 9),
                        (300, 31, 63), (300, D, 40)]:
            if d > D and not wide:
                continue
            B = _factors(gen, N, d, m, dtype)
            B[2] = 0.0
            B[2, :, :d] = torch.eye(d, dtype=dtype, device="cuda")
            L = bq.batch_tria(B)
            if not (L[0] == 0).all() or not torch.equal(L[2], B[2, :, :d]):
                raise AssertionError("lq: an all-zero pre-array must give L = 0, [I | 0] L = I")
            check_factor("lq", L, bq.tria_plain(B), dtype, f"[{N},{d},{m}]", False)
        for N in (1, 255, 257, N_SCAN):
            Bs = _layouts(_randn(gen, N, D, 2 * D).to(dtype))
            for layout, B in Bs.items():
                check_factor("lq", bq.batch_tria(B), bq.tria_plain(B), dtype,
                             f"[{N},{D},{2 * D}] {layout}", False)
        # Cholesky: Q, R, P0 and the smoothed covariances
        for N, d in [(N_LML, D), (3, D), (2000, 64), (500, 80), (300, 7)]:
            if d > D and not wide:
                continue
            X = _factors(gen, N, d, d + 3, dtype, _chol_rank(d))
            A = X @ X.transpose(-1, -2)
            A[2:] += 0.1 * torch.eye(d, dtype=dtype, device="cuda")
            check_factor("chol", bc.batch_cholesky(A), bc.cholesky_plain(A), dtype,
                         f"[{N},{d},{d}]", True)
        # Gram + Cholesky: Joseph update, combine, lml predicted factors
        for N, d, mx, my, eye in [(N_MAIN, D, D, D, False), (N_LML, D, D, D, False),
                                  (N_MAIN, D, D, 0, True), (2000, 64, 64, 64, False),
                                  (500, 80, 80, 80, False), (300, 7, 7, 9, False)]:
            if d > D and not wide:
                continue
            X = _factors(gen, N, d, mx, dtype, _chol_rank(d))
            Y = None
            if my:
                Y = _factors(gen, N, d, my, dtype)
                Y[1] = 0.0  # member 1 stays rank-deficient
            check_factor("chol_gram", bc.batch_chol_gram(X, Y, eye),
                         bc.chol_gram_plain(X, Y, eye), dtype,
                         f"[{N},{d},{mx}]+[{N},{d},{my}] plus_eye={eye:d}", not eye)
        for N in (1, 255, 257, N_SCAN):
            Xs = _layouts(_randn(gen, N, D, D).to(dtype))
            Ys = _layouts(_randn(gen, N, D, D).to(dtype))
            for lx, ly in pairs:
                check_factor("chol_gram", bc.batch_chol_gram(Xs[lx], Ys[ly]),
                             bc.chol_gram_plain(Xs[lx], Ys[ly]), dtype,
                             f"[{N},{D},{D}] {lx} + [{N},{D},{D}] {ly}", False)
        # fused combines: the tiled route (d <= 32) and the block route (33,
        # 56: the widest float64 filtering kernel) at the sequential pass's and
        # the Sklansky levels' batches, around them and at full width; then
        # unaligned, odd-strided and stride-0 operands and the scan's views
        for d in (3, 7, 31, D, D + 1, 56):
            for N in (1, N_SCAN // 2 - 1, N_SCAN // 2, N_SCAN - 1, N_SCAN, N_SCAN + 1, N_MAIN):
                ei, ej = _filter_elems(gen, N, d, dtype), _filter_elems(gen, N, d, dtype, first=2)
                sj, si = _smoother_elems(gen, N, d, dtype), _smoother_elems(gen, N, d, dtype, last=2)
                check_fused_pair(ei, ej, sj, si, dtype, f"[{N},{d},{d}]")
        for d in (7, D, D + 1):
            N = N_SCAN + 1
            ei, ej = _filter_elems(gen, N, d, dtype), _filter_elems(gen, N, d, dtype, first=2)
            sj, si = _smoother_elems(gen, N, d, dtype), _smoother_elems(gen, N, d, dtype, last=2)
            lay = {k: _layouts(v) for k, v in (("A", ei.A), ("C", ei.C), ("J", ei.J), ("E", si.E), ("L", si.L))}
            odd = ei._replace(A=lay["A"]["shifted"], C=lay["C"]["odd row stride"], J=lay["J"]["stride-0 batch"],
                              b=_layouts(ei.b[..., None])["shifted"][..., 0])
            sodd = si._replace(E=lay["E"]["odd row stride"], L=lay["L"]["shifted"],
                               g=_layouts(si.g[..., None])["shifted"][..., 0])
            check_fused_pair(odd, ej, sj, sodd, dtype, f"[{N},{d},{d}] shifted / odd row stride / stride-0 left")
            check_fused_pair(ej, odd, sodd, sj, dtype, f"[{N},{d},{d}] shifted / odd row stride / stride-0 right")
        carry, x = _scan_views(_filter_elems(gen, 3 * N_SCAN, D, dtype),
                               pk._ident_filter_elem(D, torch.empty(0, dtype=dtype, device="cuda")),
                               N_SCAN, 3, 1)
        assert carry.A.stride(0) == 0 and x.A.stride(0) == 3 * D * D and x.b.stride(0) == 3 * D
        for label, (a, b) in {"stride-0 carry, strided x": (carry, x), "strided x, x": (x, x)}.items():
            check_fused("fused_filter", fc.fused_filtering_combine(a, b),
                        fc.fused_filter_plain(a, b), dtype, f"[{N_SCAN},{D},{D}] {label}")
        carry, x = _scan_views(_smoother_elems(gen, 3 * N_SCAN, D, dtype),
                               pk._ident_smoother_elem(D, torch.empty(0, dtype=dtype, device="cuda")),
                               N_SCAN, 3, 2)
        for label, (a, b) in {"stride-0 carry, strided x": (carry, x), "strided x, x": (x, x)}.items():
            check_fused("fused_smooth", fc.fused_smoothing_combine(a, b),
                        fc.fused_smooth_plain(a, b), dtype, f"[{N_SCAN},{D},{D}] {label}")
        # its own generator: the checks above keep the draws they had
        _check_small_d(torch.Generator(device="cuda").manual_seed(7), dtype, report)
        _check_physics_shapes(torch.Generator(device="cuda").manual_seed(8), dtype, report)
        _check_scattered_shapes(torch.Generator(device="cuda").manual_seed(9), dtype, report)
        if dtype == torch.float64:  # the batch family's factors are float64
            _check_batch_shapes(torch.Generator(device="cuda").manual_seed(10), dtype, report)
        _check_dynamics_shapes(torch.Generator(device="cuda").manual_seed(11), dtype, report)
        _check_markov_shapes(torch.Generator(device="cuda").manual_seed(12), dtype, report)
        _check_vecchia_shapes(torch.Generator(device="cuda").manual_seed(13), dtype, report)
    torch.cuda.synchronize()
    times = _time_kernels(gen)
    times["bmm"]["host_us_per_call"] = _time_dispatch(gen)
    for name, rows in _time_scan_batch(gen).items():
        times[name]["at_scan_batch"] = rows
    times.update(_time_fused(gen))
    for name, rows in _time_temporal(gen).items():
        times[name]["at_temporal"] = rows
    for name, rows in _time_physics(gen).items():
        times[name]["at_physics"] = rows
    for name, rows in _time_vecchia(gen).items():
        times[name]["at_vecchia"] = rows
    return worst, times


def _check_small_d(gen, dtype, report):
    """The temporal model's shapes (state d = 1 or 2, one head) at N = 1,
    255, 257 and the series' full width: every product with sizes in {1, 2}
    in all four transpose cases, the solves with r = 1, 2, 4, 5, 6 (all-zero,
    identity and singular members from N = 3 on), the LQ at m = d .. 6 (and
    the sequential square-root filter's [3, 3] update pre-array), the
    Cholesky with an all-zero and a rank-deficient member (from N = 3 on), and the Gram +
    Cholesky with mx, my <= 2, with and without + I. One line per kernel,
    check and N gives the worst relative error over its shapes; every launch
    must take the warp kernel."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import build

    eye = {d: torch.eye(d, dtype=dtype, device="cuda") for d in (1, 2, 3)}

    def members(N, d, m):
        """[N, d, m]: from N = 3 on, member 0 all zero and member 1 of rank 1."""
        return _factors(gen, N, d, m, dtype, rank=1) if N > 2 else _randn(gen, N, d, m).to(dtype)

    build.reset_launch_counts()
    for N in (1, 255, 257, N_TEMPORAL):
        worst = {}

        def acc(name, kind, out, ref):
            rel, ab = _rel(out, ref)
            w = worst.setdefault((name, kind), [0.0, 0.0])
            w[0], w[1] = max(w[0], rel), max(w[1], ab)

        for m, n, k in itertools.product((1, 2), repeat=3):
            for ta, tb in itertools.product((False, True), repeat=2):
                A = _randn(gen, N, *((k, m) if ta else (m, k))).to(dtype)
                B = _randn(gen, N, *((n, k) if tb else (k, n))).to(dtype)
                acc("bmm", "bmm", bl.batch_bmm(A, B, ta, tb), bl.bmm_plain(A, B, ta, tb))
        for d in (1, 2):
            for r in (1, 2, 4, 5, 6):
                M = _spd(gen, N, d, dtype)
                if N >= 3:
                    M[0], M[1], M[2, 0] = 0.0, eye[d], 0.0
                R = _randn(gen, N, d, r).to(dtype)
                for name, (X, ld), (Xp, ldp) in [
                        ("gj_solve", (bl.batch_solve(M, R), None), (bl.gj_solve_plain(M, R), None)),
                        ("gj_solve_logdet", bl.batch_solve_logdet(M, R), bl.gj_solve_logdet_plain(M, R))]:
                    fin, finp = (torch.isfinite(x).flatten(1).all(1) for x in (X, Xp))
                    if not torch.equal(fin, finp):
                        raise AssertionError(f"{name} [{N},{d},{d}] r={r}: the non-finite members differ")
                    acc(name, "solve", X[fin], Xp[fin])
                    if ld is not None:
                        acc(name, "logdet", ld[fin], ldp[fin])
            for m in range(d, 7):
                B = members(N, d, m)
                L, Lp = bq.batch_tria(B), bq.tria_plain(B)
                acc("lq", "factor", L, Lp)
                acc("lq", "factor", L @ L.mT, Lp @ Lp.mT)
            X = members(N, d, d + 1)
            A = X @ X.mT
            A[2:] += 0.1 * eye[d]
            L, Lp = bc.batch_cholesky(A), bc.cholesky_plain(A)
            acc("chol", "factor", L[2:] if N > 2 else L, Lp[2:] if N > 2 else Lp)
            acc("chol", "rankdef", L @ L.mT, Lp @ Lp.mT)
            for mx, my, plus_eye in itertools.product((1, 2), (0, 1, 2), (False, True)):
                X = members(N, d, mx)
                Y = _randn(gen, N, d, my).to(dtype) if my else None
                L, Lp = bc.batch_chol_gram(X, Y, plus_eye), bc.chol_gram_plain(X, Y, plus_eye)
                if plus_eye:
                    acc("chol_gram", "factor", L, Lp)
                acc("chol_gram", "factor" if plus_eye else "rankdef", L @ L.mT, Lp @ Lp.mT)
        B = _randn(gen, 1, 3, 3).to(dtype)
        acc("lq", "factor", bq.batch_tria(B), bq.tria_plain(B))
        for (name, kind), (rel, ab) in worst.items():
            report(name, kind, rel, ab, dtype, f"[{N}] d <= 2 shapes, worst {kind} error of all")
    routes = build.route_counts()
    if any(r["block"] for r in routes.values()):
        raise AssertionError(f"kernels at d <= 2: a block kernel ran: {routes}")
    print(f"[kernels] d <= 2 {str(dtype)[6:]}: launches {build.launch_counts()}, all on the warp kernels")


def _time_kernels(gen):
    """Kernel, plain and library ms at the main path's shapes, float32,
    interleaved plain, kernel, library, library, kernel, plain; the bound is
    the larger of bytes over the memory rate and flops over the float32
    rate."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq

    f32 = torch.float32
    A = _randn(gen, N_MAIN, D, D).to(f32)
    B = _randn(gen, N_MAIN, D, D).to(f32)
    S = _spd(gen, N_MAIN, D, f32)
    rhs = _randn(gen, N_MAIN, D, 2 * D + 1).to(f32)
    eye = torch.eye(D, device="cuda").expand(N_MAIN, D, D)
    pre = _randn(gen, N_MAIN, D, 2 * D).to(f32)
    P = _spd(gen, N_LML, D, f32)
    X, Y = pre[..., :D], pre[..., D:]
    n, d, r, m = N_MAIN, D, 2 * D + 1, 2 * D
    timed = {  # kernel, plain, library (or None), label, bytes, flops
        "bmm": (lambda: bl.batch_bmm(A, B, False, True), lambda: bl.bmm_plain(A, B, False, True),
                lambda: torch.matmul(A, B.transpose(-1, -2)), "torch.matmul",
                "[25000,32,32] @ [25000,32,32]^T", _nbytes(A, B) + 4 * n * d * d, 2 * n * d ** 3),
        "gj_solve": (lambda: bl.batch_solve(S, rhs), lambda: bl.gj_solve_plain(S, rhs),
                     lambda: torch.linalg.solve(S, rhs), "torch.linalg.solve",
                     "[25000,32,32] r=65", _nbytes(S, rhs) + 4 * n * d * r,
                     n * (2 * d ** 3 // 3 + 2 * d * d * r)),
        "gj_solve_logdet": (lambda: bl.batch_solve_logdet(S, eye),
                            lambda: bl.gj_solve_logdet_plain(S, eye), None, None,
                            "[25000,32,32] r=32 (broadcast I)",
                            _nbytes(S, eye) + 4 * n * (d * d + 1), n * (2 * d ** 3 // 3 + 2 * d ** 3)),
        "lq": (lambda: bq.batch_tria(pre), lambda: bq.tria_plain(pre),
               lambda: torch.linalg.qr(pre.transpose(-1, -2), mode="r"),
               "torch.linalg.qr(B^T, mode='r')", "[25000,32,64]",
               _nbytes(pre) + 4 * n * d * d, n * (2 * d * d * m - 2 * d ** 3 // 3)),
        # the Cholesky reads only the lower triangle of P: d (d + 1) / 2 words
        "chol": (lambda: bc.batch_cholesky(P), lambda: bc.cholesky_plain(P),
                 lambda: torch.linalg.cholesky(P), "torch.linalg.cholesky", "[100000,32,32]",
                 4 * N_LML * d * (d + 1) // 2 + 4 * N_LML * d * d, N_LML * d ** 3 // 3),
        "chol_gram": (lambda: bc.batch_chol_gram(X, Y), lambda: bc.chol_gram_plain(X, Y),
                      # X, Y are the halves of pre: X Xᵀ + Y Yᵀ = pre preᵀ
                      lambda: torch.linalg.cholesky(torch.bmm(pre, pre.mT)),
                      "two calls: torch.bmm + torch.linalg.cholesky",
                      "[25000,32,32] + [25000,32,32]", _nbytes(pre) + 4 * n * d * d,
                      n * (d * d * 2 * d + d ** 3 // 3)),
    }
    out = {}
    for name, (kern, plain, lib, lib_label, shape, nbytes, flops) in timed.items():
        kern(), plain()
        if lib is not None:
            lib()
        torch.cuda.synchronize()
        p1, k1 = _time(plain), _time(kern)
        l1 = _time(lib) if lib is not None else None
        l2 = _time(lib) if lib is not None else None
        k2, p2 = _time(kern), _time(plain)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "library_ms": None if lib is None else (l1 + l2) / 2,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "timing": "events"}
        out[name] = row
        lib_txt = "none" if lib is None else f"{row['library_ms']:.4f} ms ({lib_label})"
        print(f"[kernels] time {name} {shape} f32: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib_txt}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return out


def _time_dispatch(gen, n=2000):
    """Host us per call of `bmm` at the scans' [256, 32, 32], float32: the
    launch code called directly, the custom op through the dispatcher (as a
    traced program calls it) and the public wrapper (eager: the launch code
    after the wrapper's checks); n calls a run, host clock, one synchronise
    at the end (the kernel takes ~5 us, the host more), interleaved direct,
    op, wrapper, wrapper, op, direct."""
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl

    A = _randn(gen, N_SCAN, D, D)
    B = _randn(gen, N_SCAN, D, D)
    calls = {"direct": lambda: bl.bmm_op.cuda(A, B, False, True),
             "op": lambda: torch.ops.physs_gp.bmm(A, B, False, True),
             "wrapper": lambda: bl.batch_bmm(A, B, False, True)}
    runs = {k: [] for k in calls}
    for key in ("direct", "op", "wrapper", "wrapper", "op", "direct"):
        fn = calls[key]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        runs[key].append((time.perf_counter() - t0) / n * 1e6)
    out = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"[kernels] host us per bmm call at [{N_SCAN},{D},{D}] f32: direct {out['direct']:.2f} "
          f"{runs['direct']}, op {out['op']:.2f} {runs['op']}, wrapper {out['wrapper']:.2f} "
          f"{runs['wrapper']}; the dispatcher adds {out['op'] - out['direct']:.2f} us a call")
    return out


def _time_device(fn, n=200):
    """ms of device time per call for a kernel that runs shorter than its own
    launch path takes on the host: n calls are enqueued while the device is
    busy with large products, so that they run back to back between the two
    events."""
    blocker = torch.randn(8192, 8192, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    for products in (3, 12):
        torch.cuda.synchronize()
        for _ in range(products):
            blocker @ blocker
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()  # the device had not reached the first call yet
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
    raise AssertionError("the host could not enqueue the calls ahead of the device")


def _time_scan_batch(gen):
    """The product, the Gram + Cholesky, the solve and the LQ, float32, at
    the blocked scans' batches, where nearly all their launches of a step
    run: [256, 32, 32] (the solve: the covariance scan's inverse, a
    stride-0 identity on the right; also the square-root scan's
    [512, 32, 32] with r = 64), the LQ at [512, 32, 64] (the stacked Xi/Lam
    pre-arrays) and [256, 32, 64]. Device time back to back for the kernels
    and for library calls that can be queued (the calls run shorter than
    their launch path takes on the host), operands warm in L2 as the scan
    leaves them. The library Cholesky and solve read their status back on
    the host and cannot be queued: their time is per call as the host sends
    them (CUDA events around a run of calls), and is labelled so. Returns
    {kernel: [row per shape]}."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq

    f32, n, d = torch.float32, N_SCAN, D
    A = _randn(gen, n, d, d).to(f32)
    B = _randn(gen, n, d, d).to(f32)
    pre = _randn(gen, n, d, 2 * d).to(f32)
    X, Y = pre[..., :d], pre[..., d:]
    S = _spd(gen, n, d, f32)
    eye = torch.eye(d, device="cuda").expand(n, d, d)
    S2 = _spd(gen, 2 * n, d, f32)
    R2 = _randn(gen, 2 * n, d, 2 * d).to(f32)
    pre2 = _randn(gen, 2 * n, d, 2 * d).to(f32)
    host = "as the host sends them"
    timed = [  # kernel, shape, call, library call, its label, its clock, bytes, flops
        ("bmm", f"[{n},{d},{d}]", lambda: bl.batch_bmm(A, B, False, True), lambda: torch.matmul(A, B.mT),
         "torch.matmul, device time back to back", _time_device,
         _nbytes(A, B) + 4 * n * d * d, 2 * n * d ** 3),
        ("chol_gram", f"[{n},{d},{d}]", lambda: bc.batch_chol_gram(X, Y),
         lambda: torch.linalg.cholesky(torch.bmm(pre, pre.mT)),
         f"two calls: torch.bmm + torch.linalg.cholesky, {host}",
         _time, _nbytes(pre) + 4 * n * d * d, n * (d * d * 2 * d + d ** 3 // 3)),
        ("gj_solve", f"[{n},{d},{d}] r={d} (stride-0 I)", lambda: bl.batch_solve(S, eye),
         lambda: torch.linalg.solve(S, eye), f"torch.linalg.solve, {host}", _time,
         _nbytes(S, eye) + 4 * n * d * d, n * (2 * d ** 3 // 3 + 2 * d ** 3)),
        ("gj_solve", f"[{2 * n},{d},{d}] r={2 * d}", lambda: bl.batch_solve(S2, R2),
         lambda: torch.linalg.solve(S2, R2), f"torch.linalg.solve, {host}", _time,
         _nbytes(S2, R2) + 4 * 2 * n * d * 2 * d, 2 * n * (2 * d ** 3 // 3 + 4 * d ** 3)),
        ("lq", f"[{2 * n},{d},{2 * d}]", lambda: bq.batch_tria(pre2),
         lambda: torch.linalg.qr(pre2.mT, mode="r"),
         "torch.linalg.qr(B^T, mode='r'), device time back to back", _time_device,
         _nbytes(pre2) + 4 * 2 * n * d * d, 2 * n * (4 * d ** 3 - 2 * d ** 3 // 3)),
        ("lq", f"[{n},{d},{2 * d}]", lambda: bq.batch_tria(pre),
         lambda: torch.linalg.qr(pre.mT, mode="r"),
         "torch.linalg.qr(B^T, mode='r'), device time back to back", _time_device,
         _nbytes(pre) + 4 * n * d * d, n * (4 * d ** 3 - 2 * d ** 3 // 3)),
    ]
    out = {}
    for name, shape, kern, lib, lib_label, lib_clock, nbytes, flops in timed:
        kern(), lib()
        torch.cuda.synchronize()
        k1, l1 = _time_device(kern), lib_clock(lib)
        l2, k2 = lib_clock(lib), _time_device(kern)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {"shape": shape, "ms": (k1 + k2) / 2, "library_ms": (l1 + l2) / 2,
               "library": lib_label, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "timing": "device_back_to_back"}
        out.setdefault(name, []).append(row)
        print(f"[kernels] time {name} {shape} f32: kernel {row['ms']:.4f} ms device time "
              f"back to back, library {row['library_ms']:.4f} ms ({lib_label}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)")
    return out


def _time_fused(gen):
    """The two fused combines at the scans' batches, [256, 32, 32] (the
    sequential pass) and [128, 32, 32] (the Sklansky levels), where all
    their launches of a step run: device time back to back, operands warm
    in L2 as the scan leaves them, float32 and float64; and at
    [25000, 32, 32], float32, CUDA events around a run of calls like the
    other kernels. No single PyTorch call computes either combine: the
    unfused route's time for the same operands (its own launches of bmm and
    gj_solve and PyTorch's ops, as the host sends them) is printed beside
    them, labelled. Returns each kernel's float32 [256] row, with every scan
    batch row under `at_scan_batch`."""
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc

    f32, f64, d = torch.float32, torch.float64, D
    out, rows = {}, {name: [] for name in FUSED}
    for dtype, N in ((f32, N_SCAN), (f32, N_SCAN // 2), (f32, N_MAIN), (f64, N_SCAN), (f64, N_SCAN // 2)):
        es, scan = torch.empty((), dtype=dtype).element_size(), N != N_MAIN
        ei, ej = _filter_elems(gen, N, d, dtype), _filter_elems(gen, N, d, dtype, first=2)
        sj, si = _smoother_elems(gen, N, d, dtype), _smoother_elems(gen, N, d, dtype, last=2)
        timed = {  # kernel, plain, unfused route, bytes, flops
            "fused_filter": (lambda: fc.fused_filtering_combine(ei, ej),
                             lambda: fc.fused_filter_plain(ei, ej),
                             lambda: pk._filtering_operator_unfused(ei, ej),
                             _nbytes(*ei, *ej) + es * N * (3 * d * d + 2 * d),
                             # eight products, the inverse's d steps on d live columns, five mat-vecs
                             N * (18 * d ** 3 + 10 * d * d)),
            "fused_smooth": (lambda: fc.fused_smoothing_combine(sj, si),
                             lambda: fc.fused_smooth_plain(sj, si),
                             lambda: pk._smoothing_operator_unfused(sj, si),
                             _nbytes(*sj, *si) + es * N * (2 * d * d + d),
                             N * (6 * d ** 3 + 2 * d * d)),
        }
        peak = FP32_FLOPS_PER_S if dtype == f32 else FP64_FLOPS_PER_S
        for name, (kern, plain, unfused, nbytes, flops) in timed.items():
            kern(), plain(), unfused()
            torch.cuda.synchronize()
            p1, u1, k1 = _time(plain), _time(unfused), _time(kern)
            dev = _time_device(kern) if scan else None
            k2, u2, p2 = _time(kern), _time(unfused), _time(plain)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
            row = {"shape": f"[{N},{d},{d}]", "dtype": str(dtype)[6:],
                   "ms": dev if scan else (k1 + k2) / 2, "per_call_ms": (k1 + k2) / 2,
                   "plain_ms": (p1 + p2) / 2, "unfused_ms": (u1 + u2) / 2, "library_ms": None,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "timing": "device_back_to_back" if scan else "events"}
            how = f" device time back to back ({row['per_call_ms']:.4f} ms per call as the host sends them)" \
                if scan else ""
            print(f"[kernels] time {name} {row['shape']} {row['dtype']}: kernel {row['ms']:.4f} ms{how}, "
                  f"plain {row['plain_ms']:.4f} ms, library none, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            print(f"[kernels] time {name} {row['shape']} {row['dtype']}: the unfused route "
                  f"(its own launches of bmm and gj_solve, as the host sends them) {row['unfused_ms']:.4f} ms")
            if scan:
                rows[name].append(row)
            if dtype == f32 and N == N_SCAN:
                out[name] = dict(row)
    for name in FUSED:
        out[name]["at_scan_batch"] = rows[name]
    return out


def _time_temporal(gen):
    """The kernels the temporal model launches, float32, at the shapes where
    its launches run (`scripts/port/launch_census.py`): the square-root
    scan's batches ([1024] blocks, [2048] stacked pre-arrays), device time
    back to back, and the full widths (a chunk of 50 000, the series of
    100 000), CUDA events around a run of calls. Each row has the kernel's,
    the plain version's and the library call's time beside the bound from
    bytes and operations. The library solve and Cholesky read their status
    back on the host: their times are per call as the host sends them.
    Returns {kernel: [row per shape]}."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq

    f32, nb, nc, nt = torch.float32, TEMPORAL_BLOCKS, TEMPORAL_CHUNK, N_TEMPORAL

    def r(*shape):
        return _randn(gen, *shape).to(f32)

    def bmm_case(N, m, k, n, clock):
        A, B = r(N, m, k), r(N, k, n)
        return ("bmm", f"[{N},{m},{k}] @ [{N},{k},{n}]", lambda: bl.batch_bmm(A, B),
                lambda: bl.bmm_plain(A, B), lambda: torch.matmul(A, B), "torch.matmul", clock,
                4 * N * (m * k + k * n + m * n), 2 * N * m * n * k)

    def solve_case(N, d, r_, clock):
        M, R = _spd(gen, N, d, f32), r(N, d, r_)
        return ("gj_solve", f"[{N},{d},{d}] r={r_}", lambda: bl.batch_solve(M, R),
                lambda: bl.gj_solve_plain(M, R), lambda: torch.linalg.solve(M, R),
                "torch.linalg.solve", clock, 4 * N * (d * d + 2 * d * r_),
                N * (2 * d ** 3 // 3 + 2 * d * d * r_))

    def lq_case(N, d, m, clock):
        B = r(N, d, m)
        return ("lq", f"[{N},{d},{m}]", lambda: bq.batch_tria(B), lambda: bq.tria_plain(B),
                lambda: torch.linalg.qr(B.mT, mode="r"), "torch.linalg.qr(B^T, mode='r')", clock,
                4 * N * (d * m + d * d), N * (2 * d * d * m - 2 * d ** 3 // 3))

    def gram_case(N, d, clock):
        X, Y = r(N, d, d), r(N, d, d)
        XY = torch.cat([X, Y], -1)
        return ("chol_gram", f"[{N},{d},{d}] + [{N},{d},{d}]", lambda: bc.batch_chol_gram(X, Y),
                lambda: bc.chol_gram_plain(X, Y), lambda: torch.linalg.cholesky(torch.bmm(XY, XY.mT)),
                "two calls: torch.bmm + torch.linalg.cholesky", _time, 4 * N * 3 * d * d,
                N * (2 * d ** 3 + d ** 3 // 3))

    M1, R1 = _spd(gen, nt, 1, f32), r(nt, 1, 1)
    cases = [
        bmm_case(nb, 2, 2, 2, _time_device), bmm_case(nt, 2, 2, 2, _time), bmm_case(nc, 1, 2, 2, _time),
        solve_case(2 * nb, 2, 4, _time), solve_case(nc, 1, 5, _time), solve_case(nt, 2, 2, _time),
        ("gj_solve_logdet", f"[{nt},1,1] r=1", lambda: bl.batch_solve_logdet(M1, R1),
         lambda: bl.gj_solve_logdet_plain(M1, R1), None, None, None, 4 * nt * 4, nt * 3),
        lq_case(2 * nb, 2, 4, _time_device), lq_case(nb, 2, 4, _time_device), lq_case(nc, 1, 3, _time),
        gram_case(nb, 2, _time), gram_case(nt, 2, _time),
    ]
    out = {}
    for name, shape, kern, plain, lib, lib_label, lib_clock, nbytes, flops in cases:
        scan = shape.startswith(f"[{nb},") or shape.startswith(f"[{2 * nb},")
        clock = _time_device if scan else _time
        kern(), plain()
        if lib is not None:
            lib()
        torch.cuda.synchronize()
        p1, k1 = _time(plain), clock(kern)
        l1 = lib_clock(lib) if lib is not None else None
        l2 = lib_clock(lib) if lib is not None else None
        k2, p2 = clock(kern), _time(plain)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {"shape": shape, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "library_ms": None if lib is None else (l1 + l2) / 2, "library": lib_label,
               "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "timing": "device_back_to_back" if scan else "events"}
        out.setdefault(name, []).append(row)
        lib_txt = "none" if lib is None else f"{row['library_ms']:.4f} ms ({lib_label}" + (
            ", as the host sends them)" if lib_clock is _time and scan else ")")
        how = "device time back to back" if scan else "events"
        print(f"[kernels] time temporal {name} {shape} f32: kernel {row['ms']:.4f} ms ({how}), plain "
              f"{row['plain_ms']:.4f} ms, library {lib_txt}, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    return out


def _run_slice(T, chunk, dtype, steps, nan_guard, sqrt, temporal=False):
    """`steps` CVI steps of `build_config5` (or `build_temporal`) at lr 0.5;
    returns (model, ELBOs, step wall times)."""
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    model = (build_temporal if temporal else build_config5)(T, chunk, dtype=dtype, sqrt=sqrt)
    torch.cuda.synchronize()
    walls, elbos = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, e = natgrad_scan(model, 0.5, n_steps=1, nan_guard=nan_guard)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        elbos.append(float(e[0]))
    return model, np.array(elbos), walls


def _check_moments(tag, got, tol):
    """max |val - ref| / max |ref| of each tensor against its numpy reference."""
    for key, (val, ref) in got.items():
        r = float(np.max(np.abs(val.cpu().numpy() - ref)) / np.max(np.abs(ref)))
        print(f"[{tag}] {key} max rel {r:.3e} (tol {tol:g})")
        if not r <= tol:
            raise AssertionError(f"{tag}: {key} disagrees with the JAX reference")


def phase_slice_anchor(sqrt, fused=False):
    """`fused` sets the knob; it acts on the covariance-form scans only, so
    the square-root slice must launch neither fused combine with it set.
    Without the knob the fitted model also predicts at new times
    (`predict_f` on a grid that the runner pads), held to the prediction
    golden file."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    tag, golden = ("anchor sqrt", GOLDEN_SQRT) if sqrt else ("anchor", GOLDEN)
    env = {"PHYSS_SCAN_BLOCKS": "8"}
    if fused:
        tag, env["PHYSS_FUSED_COMBINE"] = tag + (" knob on" if sqrt else " fused"), "1"
    os.environ.update(env)
    kernels.reset_launch_counts(*FUSED)
    try:
        model, elbos, _ = _run_slice(256, 64, torch.float64, 3, nan_guard=True, sqrt=sqrt)
        post = model.posterior()
        if not fused:
            form = "sqrt" if sqrt else "cov"
            gp = np.load(GOLDEN_PREDICT)
            f = model.predict_f(torch.as_tensor(gp["t5_new"], dtype=torch.float64, device="cuda"))
            _check_moments(f"{tag} predict_f", {
                "mean": (f.mean, gp[f"c5_{form}_f_mean"]), "var": (f.var, gp[f"c5_{form}_f_var"])}, 1e-7)
    finally:
        for key in env:
            del os.environ[key]
    counts = kernels.launch_counts(*FUSED)
    print(f"[{tag}] launches of the fused combines: {counts}")
    if any((n > 0) != (fused and not sqrt) for n in counts.values()):
        raise AssertionError(f"{tag}: the fused combines ran {counts} with fused={fused}")
    gold = np.load(golden)
    rel = np.abs(elbos - gold["elbos"]) / np.abs(gold["elbos"])
    print(f"[{tag}] ELBOs {elbos.tolist()}")
    print(f"[{tag}] golden {gold['elbos'].tolist()} max rel {rel.max():.3e} (tol 1e-9)")
    if not rel.max() <= 1e-9:
        raise AssertionError(f"float64 {tag} slice on the card disagrees with the JAX reference")
    got = {
        "site_Y": model.sites.Y, "site_V_diag": torch.diagonal(model.sites.V, dim1=-2, dim2=-1),
        "post_mean": post.mean, "post_var": post.var,
    }
    for key, val in got.items():
        ref = gold[key]
        r = np.max(np.abs(val.cpu().numpy() - ref)) / np.max(np.abs(ref))
        print(f"[{tag}] {key} max rel {r:.3e} (tol 1e-7)")
        if not r <= 1e-7:
            raise AssertionError(f"{tag}: {key} disagrees with the JAX reference")
    return model


def phase_oracle():
    """One float64 config-5 filter + smoother pass at T = 2048 (chunk 512,
    sites after one CVI step) through the fused scans, against the port's
    sequential Kalman filter and RTS smoother on the card, which share no
    kernel and no schedule with the scans."""
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.ops.lgssm import build_lgssm
    from physs_gp_tpu_torch.ops.runner import run_filter_smoother

    os.environ["PHYSS_FUSED_COMBINE"] = "1"
    try:
        model, _, _ = _run_slice(2048, 512, torch.float64, 1, nan_guard=True, sqrt=False)
        with torch.no_grad():
            ssm = build_lgssm(model.kernel, model.t)._replace(H=model.observation.H(model.kernel))
            R, Y = model.sites.V, model.sites.Y
            kernels.reset_launch_counts(*FUSED)
            f, s = run_filter_smoother(ssm, R, Y, parallel=True, chunk_size=512)
            counts = kernels.launch_counts(*FUSED)
    finally:
        del os.environ["PHYSS_FUSED_COMBINE"]
    t0 = time.perf_counter()
    with torch.no_grad():
        fo, so = run_filter_smoother(ssm, R, Y, parallel=False)
    torch.cuda.synchronize()
    print(f"[oracle] fused launches {counts}; sequential pass {time.perf_counter() - t0:.2f} s")
    if not all(counts.values()):
        raise AssertionError("oracle: the scans did not run the fused combines")
    _compare_passes("oracle", (f, s), (fo, so), "fused scans vs sequential pass")


def phase_temporal_anchor(sqrt, fused=False):
    """The float64 temporal slice at T = 256 (chunk 64, 8 blocks, 3 steps)
    against tests/data/temporal_T256_golden.npz, then its predict_f,
    predict_y and nlpd at 50 new times (a grid of 306 steps, which the
    runner pads) against tests/data/predict_T256_golden.npz. `fused` sets
    PHYSS_FUSED_COMBINE=1: no fused combine may launch at d = 2. Returns the
    ELBOs."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    form = "sqrt" if sqrt else "cov"
    tag = f"anchor temporal {form}" + (" knob on" if fused else "")
    env = {"PHYSS_SCAN_BLOCKS": "8"}
    if fused:
        env["PHYSS_FUSED_COMBINE"] = "1"
    os.environ.update(env)
    kernels.reset_launch_counts(*FUSED)
    gp = np.load(GOLDEN_PREDICT)
    t_new, y_new = (torch.as_tensor(gp[k], dtype=torch.float64, device="cuda") for k in ("t_new", "y_new"))
    try:
        model, elbos, _ = _run_slice(256, 64, torch.float64, 3, nan_guard=True, sqrt=sqrt, temporal=True)
        post = model.posterior()
        f, y, nlpd = model.predict_f(t_new), model.predict_y(t_new), float(model.nlpd(t_new, y_new))
    finally:
        for key in env:
            del os.environ[key]
    counts = kernels.launch_counts(*FUSED)
    if any(counts.values()):
        raise AssertionError(f"{tag}: a fused combine ran at d = 2: {counts}")
    gold = np.load(GOLDEN_TEMPORAL)
    ref = gold[f"{form}_elbos"]
    rel = np.abs(elbos - ref) / np.abs(ref)
    print(f"[{tag}] ELBOs {elbos.tolist()}")
    print(f"[{tag}] golden {ref.tolist()} max rel {rel.max():.3e} (tol 1e-9)")
    if not rel.max() <= 1e-9:
        raise AssertionError(f"float64 {tag} slice on the card disagrees with the JAX reference")
    _check_moments(tag, {
        "site_Y": (model.sites.Y, gold[f"{form}_site_Y"]),
        "site_V_diag": (torch.diagonal(model.sites.V, dim1=-2, dim2=-1), gold[f"{form}_site_V_diag"]),
        "post_mean": (post.mean, gold[f"{form}_post_mean"]), "post_var": (post.var, gold[f"{form}_post_var"]),
        "predict_f mean": (f.mean, gp[f"{form}_f_mean"]), "predict_f var": (f.var, gp[f"{form}_f_var"]),
        "predict_y mean": (y.mean, gp[f"{form}_y_mean"]), "predict_y var": (y.var, gp[f"{form}_y_var"]),
    }, 1e-7)
    r = abs(nlpd - float(gp[f"{form}_nlpd"])) / abs(float(gp[f"{form}_nlpd"]))
    print(f"[{tag}] nlpd {nlpd!r} rel {r:.3e} (tol 1e-9)")
    if not r <= 1e-9:
        raise AssertionError(f"{tag}: nlpd disagrees with the JAX reference")
    return elbos


def _compare_passes(tag, a, b, names):
    """lml (tol 1e-9) and moments (max err over scale, tol 1e-7) of two
    (filter, smoother) passes."""
    (fa, sa), (fb, sb) = a, b
    got = {"lml": (fa.lml, fb.lml, 1e-9), "filtered means": (fa.ms, fb.ms, 1e-7),
           "filtered covariances": (fa.Ps, fb.Ps, 1e-7), "smoothed means": (sa.ms, sb.ms, 1e-7),
           "smoothed covariances": (sa.Ps, sb.Ps, 1e-7)}
    if sa.Ls is not None and sb.Ls is not None:
        got["smoothed factors' L Lᵀ"] = (sa.Ls @ sa.Ls.mT, sb.Ls @ sb.Ls.mT, 1e-7)
    for key, (val, ref, tol) in got.items():
        r = float((val - ref).abs().max() / ref.abs().max())
        print(f"[{tag}] {names}: {key} max err / scale {r:.3e} (tol {tol:g})")
        if not r <= tol:
            raise AssertionError(f"{tag}: {key} of the {names} disagree")


def phase_temporal_oracle():
    """One float64 filter + smoother pass of the temporal model at T = 2048
    (chunk 512, sites after one CVI step): the flat d = 2 scans against the
    sequential covariance filter and smoother, and the parallel square-root
    scans against the sequential square-root filter and smoother (the LQ
    kernel at batch 1 each step)."""
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.ops.lgssm import build_lgssm
    from physs_gp_tpu_torch.ops.runner import run_filter_smoother

    model, _, _ = _run_slice(2048, 512, torch.float64, 1, nan_guard=True, sqrt=False, temporal=True)
    ssm = build_lgssm(model.kernel, model.t)
    R, Y = model.sites.V, model.sites.Y
    passes, launches = {}, {}
    with torch.no_grad():
        for key, kw in {"flat": dict(parallel=True, chunk_size=512), "sequential": dict(parallel=False),
                        "parallel sqrt": dict(parallel=True, sqrt=True, chunk_size=512),
                        "sequential sqrt": dict(parallel=False, sqrt=True)}.items():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            passes[key] = run_filter_smoother(ssm, R, Y, **kw)
            torch.cuda.synchronize()
            launches[key] = {k: v for k, v in kernels.launch_counts().items() if v}
            print(f"[oracle temporal] {key} pass {time.perf_counter() - t0:.2f} s, launches {launches[key]}")
    if launches["sequential sqrt"].get("lq", 0) < 3 * 2047:
        raise AssertionError("oracle temporal: the sequential square-root pass did not run the LQ per step")
    _compare_passes("oracle temporal", passes["flat"], passes["sequential"],
                    "flat d = 2 scans vs sequential covariance pass")
    _compare_passes("oracle temporal", passes["parallel sqrt"], passes["sequential sqrt"],
                    "parallel vs sequential square-root pass")


def _path_check(tag, counts, routes, path_kernels):
    """Every kernel of the path launched, none on a block-per-matrix route,
    no fused combine unless the path has them."""
    print(f"[{tag}] launches: {counts}")
    print(f"[{tag}] launches by route: {routes}")
    if not all(counts[k] > 0 for k in path_kernels):
        raise AssertionError(f"{tag}: a kernel of the path was never launched")
    if any(r["block"] for r in routes.values()):
        raise AssertionError(f"{tag}: a block-per-matrix kernel ran on the path")
    if any(counts[k] for k in FUSED if k not in path_kernels):
        raise AssertionError(f"{tag}: a fused combine ran with its knob unset")


def phase_temporal_full():
    """The temporal Poisson fit at the bench's settings (T = 100 000, chunk
    50 000, 1024 blocks; 3 steps at lr 0.5) in covariance and square-root
    form, float32 and float64, each fitted model then predicting at 1000 new
    times over [0, 1000] (predict_f, predict_y, nlpd with seeded Poisson
    targets). Launch counters are reset just before each float32 fit and
    each float32 prediction and read just after. In float64 the two forms
    must agree on the ELBOs and predict_f to rtol 1e-6. Returns the paths'
    launch counts and launches by route."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    rng = np.random.default_rng(20)
    t_new = np.sort(rng.uniform(0, 1000, 1000))
    y_new = np.random.default_rng(21).poisson(np.exp(1.2 * np.sin(0.1 * t_new)))[:, None]
    path_kernels = {
        "temporal cov f32": ("bmm", "gj_solve", "gj_solve_logdet"),
        "temporal cov predict f32": ("bmm", "gj_solve", "gj_solve_logdet"),
        "temporal sqrt f32": ("bmm", "gj_solve", "gj_solve_logdet", "lq", "chol_gram"),
        "temporal sqrt predict f32": ("bmm", "gj_solve", "lq", "chol_gram"),
    }
    counts, routes, res = {}, {}, {}
    os.environ["PHYSS_SCAN_BLOCKS"] = str(TEMPORAL_BLOCKS)
    try:
        for form in ("cov", "sqrt"):
            for dtype in (torch.float32, torch.float64):
                dt = str(dtype)[6:]
                f32 = dtype == torch.float32
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                if f32:
                    kernels.reset_launch_counts()
                model, elbos, walls = _run_slice(N_TEMPORAL, TEMPORAL_CHUNK, dtype, 3, nan_guard=False,
                                                 sqrt=form == "sqrt", temporal=True)
                if f32:
                    counts[f"temporal {form} f32"] = kernels.launch_counts()
                    routes[f"temporal {form} f32"] = kernels.route_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
                tn = torch.as_tensor(t_new, dtype=dtype, device="cuda")
                yn = torch.as_tensor(y_new, dtype=dtype, device="cuda")
                torch.cuda.reset_peak_memory_stats()
                if f32:
                    kernels.reset_launch_counts()
                t0 = time.perf_counter()
                f, y, nlpd = model.predict_f(tn), model.predict_y(tn), model.nlpd(tn, yn)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if f32:
                    counts[f"temporal {form} predict f32"] = kernels.launch_counts()
                    routes[f"temporal {form} predict f32"] = kernels.route_counts()
                peak_pred = torch.cuda.max_memory_allocated() / 2**30
                finite = bool(np.all(np.isfinite(elbos)) and torch.isfinite(model.sites.V).all()
                              and torch.isfinite(model.sites.Y).all()
                              and all(torch.isfinite(x).all() for x in (*f, *y, nlpd)))
                print(f"[full temporal {form}] {dt} ELBOs {elbos.tolist()}")
                print(f"[full temporal {form}] {dt} step wall s {[round(w, 4) for w in walls]} "
                      f"peak {peak:.2f} GiB finite {finite}")
                print(f"[full temporal {form}] {dt} predict_f + predict_y + nlpd at 1000 new times "
                      f"{wall:.4f} s, peak {peak_pred:.2f} GiB, nlpd {float(nlpd)!r}")
                if not finite or f.mean.shape != (1000, 1):
                    raise AssertionError(f"full temporal {form}: non-finite or misshapen result in {dt}")
                res[form, dtype] = (elbos, f)
                del model
    finally:
        del os.environ["PHYSS_SCAN_BLOCKS"]
    for path, kern in path_kernels.items():
        _path_check(f"full {path}", counts[path], routes[path], kern)
    f64, f32 = torch.float64, torch.float32
    for form in ("cov", "sqrt"):
        gap = np.abs(res[form, f32][0] - res[form, f64][0]) / np.abs(res[form, f64][0])
        print(f"[full temporal {form}] float32 vs float64 ELBO rel gap {gap.tolist()}")
    gap = np.abs(res["sqrt", f64][0] - res["cov", f64][0]) / np.abs(res["cov", f64][0])
    fc, fs = res["cov", f64][1], res["sqrt", f64][1]
    gaps = {"ELBO": gap.max(), "predict_f mean": float((fs.mean - fc.mean).abs().max() / fc.mean.abs().max()),
            "predict_f var": float((fs.var - fc.var).abs().max() / fc.var.abs().max())}
    print(f"[full temporal] float64 square-root vs covariance: ELBO rel gap {gap.tolist()}, "
          f"predict_f mean {gaps['predict_f mean']:.3e}, var {gaps['predict_f var']:.3e} (tol 1e-6)")
    if not max(gaps.values()) <= 1e-6:
        raise AssertionError("full temporal: the two forms disagree in float64")
    return counts, routes


def _full(sqrt, path_kernels, fused=False):
    """f32 then f64 at T = 100 000; returns (ELBOs by dtype, f32 launch
    counts, f32 launches by route, prediction's (counts, routes) or None).
    Every launch of the solve, the LQ and the Cholesky kernels on the main
    path (d = 32, m <= 64) must take the warp-per-matrix kernels, every
    fused launch the tiled kernels. Without the fused knob the float32 model
    then predicts at 1000 new times (`predict_f` on a grid of 101 000 steps,
    which the runner pads), with the counters reset just before it and read
    just after."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    tag = "full sqrt" if sqrt else "full fused" if fused else "full"
    out, predict = {}, None
    for dtype in (torch.float32, torch.float64):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if dtype == torch.float32:
            kernels.reset_launch_counts()
        model, elbos, walls = _run_slice(100_000, 25_000, dtype, 3, nan_guard=False, sqrt=sqrt)
        if dtype == torch.float32:
            counts, routes = kernels.launch_counts(), kernels.route_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(np.all(np.isfinite(elbos))
                      and torch.isfinite(model.sites.V).all()
                      and torch.isfinite(model.sites.Y).all())
        print(f"[{tag}] {str(dtype)[6:]} ELBOs {elbos.tolist()}")
        print(f"[{tag}] {str(dtype)[6:]} step wall s {[round(w, 4) for w in walls]} "
              f"peak {peak:.2f} GiB finite {finite}")
        if not finite:
            raise AssertionError(f"{tag}: non-finite ELBO or sites in {dtype}")
        out[dtype] = elbos
        form = "sqrt" if sqrt else "fused" if fused else "cov"
        SLICE_ELBOS[(form, str(dtype)[6:])] = elbos
        SLICE_PEAKS[(form, str(dtype)[6:])] = peak
        if dtype == torch.float32 and not fused:
            t_new = torch.as_tensor(np.sort(np.random.default_rng(22).uniform(0, 100, 1000)),
                                    dtype=dtype, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            f = model.predict_f(t_new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            predict = (kernels.launch_counts(), kernels.route_counts())
            ok = f.mean.shape == (1000, 32) and bool(torch.isfinite(f.mean).all() & torch.isfinite(f.var).all())
            print(f"[{tag}] float32 predict_f at 1000 new times {wall:.4f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, finite and [1000, 32] {ok}")
            if not ok:
                raise AssertionError(f"{tag}: predict_f gave a non-finite or misshapen result")
        del model
    _path_check(f"{tag} float32", counts, routes, path_kernels)
    # Step 0 starts from the broad initial sites, where the fp32 projection
    # H P H^T of the stiff collocation heads loses digits in the reference
    # algorithm itself (the JAX package's own float32 and float64 step-0
    # ELBOs differ by 2 % at T = 4000 on the CPU); the bound applies to the
    # steps after it.
    gap = np.abs(out[torch.float32] - out[torch.float64]) / np.abs(out[torch.float64])
    print(f"[{tag}] float32 vs float64 ELBO rel gap {gap.tolist()} "
          f"(bound 1e-2 on steps 1 and 2; step 0 reported)")
    if not gap[1:].max() <= 1e-2:
        raise AssertionError(f"{tag}: float32 and float64 ELBOs disagree")
    return out, counts, routes, predict


def phase_slice_full():
    """The three full-width paths; returns each path's float32 launch counts
    and launches by route."""
    os.environ["PHYSS_KZZ_JITTER"] = "1e-4"
    cov = ("bmm", "gj_solve", "gj_solve_logdet")
    cov_elbos, cov_counts, cov_routes, cov_predict = _full(False, cov)
    os.environ["PHYSS_FUSED_COMBINE"] = "1"
    try:
        fused_elbos, fused_counts, fused_routes, _ = _full(False, cov + FUSED, fused=True)
    finally:
        del os.environ["PHYSS_FUSED_COMBINE"]
    # fused and unfused are one function: float64 to rounding on every step,
    # float32 within its own error after the broad step 0
    for dtype, tol, steps in ((torch.float64, 1e-9, slice(0, None)), (torch.float32, 1e-3, slice(1, None))):
        gap = np.abs(fused_elbos[dtype] - cov_elbos[dtype]) / np.abs(cov_elbos[dtype])
        print(f"[full fused] {str(dtype)[6:]} fused vs unfused ELBO rel gap {gap.tolist()} "
              f"(bound {tol:g}{'' if steps.start == 0 else ' on steps 1 and 2'})")
        if not gap[steps].max() <= tol:
            raise AssertionError(f"full fused: {dtype} fused and unfused ELBOs disagree")
    sqrt_kernels = tuple(k for k in SOURCES if k not in FUSED)
    sqrt_elbos, counts, routes, sqrt_predict = _full(True, sqrt_kernels)
    gap = np.abs(sqrt_elbos[torch.float32] - cov_elbos[torch.float32]) / np.abs(cov_elbos[torch.float32])
    print(f"[full sqrt] float32 square-root vs covariance ELBO rel gap {gap.tolist()}")
    _path_check("full config5 cov predict f32", *cov_predict, cov)
    # prediction runs no site ELL, so no solve + logdet in square-root form
    _path_check("full config5 sqrt predict f32", *sqrt_predict,
                tuple(k for k in sqrt_kernels if k != "gj_solve_logdet"))
    return ({"cov f32": cov_counts, "cov fused f32": fused_counts, "sqrt f32": counts,
             "config5 cov predict f32": cov_predict[0], "config5 sqrt predict f32": sqrt_predict[0]},
            {"cov f32": cov_routes, "cov fused f32": fused_routes, "sqrt f32": routes,
             "config5 cov predict f32": cov_predict[1], "config5 sqrt predict f32": sqrt_predict[1]})


# ---------------------------------------------------------------------------
# AOT serving: config-5 `predict_f` exported, reloaded and served
# ---------------------------------------------------------------------------


def _exported(model, ts):
    """`export_predictor(model, ts)` and `load_predictor` of its bytes: (the
    loaded program, export s, load s, bytes, nodes of the loaded program
    over all its submodules)."""
    from physs_gp_tpu_torch.utils import serving

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = serving.export_predictor(model, ts)
    t1 = time.perf_counter()
    serve = serving.load_predictor(blob)
    t2 = time.perf_counter()
    nodes = sum(len(m.graph.nodes) for m in serve.modules()
                if isinstance(m, torch.fx.GraphModule))
    return serve, t1 - t0, t2 - t1, len(blob), nodes


def _served(serve, ts):
    """One call of a loaded program: (mean, var, launches, launches by
    route, peak GiB)."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with torch.no_grad():
        mean, var = serve(ts)
    torch.cuda.synchronize()
    return (mean, var, kernels.launch_counts(), kernels.route_counts(),
            torch.cuda.max_memory_allocated() / 2**30)


def phase_export_anchor(models):
    """The float64 T = 256 config-5 models of the anchors (covariance with
    the fused knob on, square-root), each `predict_f` at the golden's 40
    new times exported and reloaded on the card, the loaded program held to
    tests/data/predict_T256_golden.npz at the live anchors' tolerance;
    together the two programs launch all eight kernels. (The knob-off
    covariance program is not exported: its kernels are among these, and
    `phase_export_full` holds a loaded knob-off program to the live call at
    full width.) The
    export predicts in one chunk with EXPORT_ANCHOR_BLOCKS blocks (the live
    anchors: chunk 64, 8 blocks): the same function, with fewer scan levels
    to trace."""
    gp = np.load(GOLDEN_PREDICT)
    ts = torch.as_tensor(gp["t5_new"], dtype=torch.float64, device="cuda")
    launched = set()
    for (form, fused), model in models.items():
        tag = f"export anchor {form}{' knob on' if fused else ''}"
        model.chunk_size = EXPORT_ANCHOR_CHUNK
        env = {"PHYSS_SCAN_BLOCKS": EXPORT_ANCHOR_BLOCKS,
               **({"PHYSS_FUSED_COMBINE": "1"} if fused else {})}
        os.environ.update(env)
        try:
            serve, t_export, t_load, nbytes, nodes = _exported(model, ts)
        finally:
            for key in env:
                del os.environ[key]
        mean, var, counts, _, _ = _served(serve, ts)
        ran = {k: n for k, n in counts.items() if n}
        print(f"[{tag}] export {t_export:.1f} s, load {t_load:.1f} s, {nodes} nodes, "
              f"{nbytes} bytes; one loaded call launched {ran}")
        _check_moments(f"{tag} predict_f", {
            "mean": (mean, gp[f"c5_{form}_f_mean"]), "var": (var, gp[f"c5_{form}_f_var"])}, 1e-7)
        want = EXPORT_KERNELS[form] + (FUSED if fused else ())
        if set(ran) != set(want):
            raise AssertionError(f"{tag}: launched {sorted(ran)}, expected {sorted(want)}")
        launched |= set(ran)
    if launched != set(SOURCES):
        raise AssertionError(f"export anchors: {sorted(set(SOURCES) - launched)} never launched")
    print(f"[export anchor] the two programs launched all eight kernels: {sorted(launched)}")


def phase_export_full():
    """The float32 covariance model of the full-width run at EXPORT_T steps
    (chunk EXPORT_CHUNK, 256 blocks, after 3 natural-gradient steps), `predict_f`
    at the full run's 1000 new times exported on the card and reloaded: the
    loaded program against the live call: max abs difference (the same
    kernels in the same order: fails above rtol 1e-6), launches per kernel
    (fail unless equal), then p50 / p99 of EXPORT_CALLS loaded and live
    calls, interleaved, and the peak device memory of a loaded call.
    Returns the loaded call's launches."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    t_start = time.perf_counter()
    model, _, _ = _run_slice(EXPORT_T, EXPORT_CHUNK, torch.float32, 3, nan_guard=False, sqrt=False)
    ts = torch.as_tensor(np.sort(np.random.default_rng(22).uniform(0, 100, 1000)),
                         dtype=torch.float32, device="cuda")
    kernels.reset_launch_counts()
    live = model.predict_f(ts)
    torch.cuda.synchronize()
    live_counts = kernels.launch_counts()
    serve, t_export, t_load, nbytes, nodes = _exported(model, ts)
    print(f"[export full] config-5 cov f32 T={EXPORT_T} chunk={EXPORT_CHUNK} predict_f at {ts.shape[0]} new "
          f"times: export {t_export:.1f} s (trace and save), {nodes} nodes, {nbytes} bytes "
          f"({nbytes / 2**30:.3f} GiB), load {t_load:.1f} s")
    mean, var, counts, routes, peak = _served(serve, ts)
    err = max(float((mean - live.mean).abs().max()), float((var - live.var).abs().max()))
    scale = max(float(live.mean.abs().max()), float(live.var.abs().max()))
    print(f"[export full] loaded vs live: max abs diff {err:.3e} (rel {err / scale:.3e}, "
          f"tol 1e-6); peak of a loaded call {peak:.2f} GiB")
    print(f"[export full] launches: loaded {counts}, live {live_counts}")
    if not err <= 1e-6 * scale:
        raise AssertionError("export full: the loaded program disagrees with the live predict_f")
    if counts != live_counts:
        raise AssertionError("export full: the loaded program launched other kernels than live")
    _path_check("export full loaded f32", counts, routes, EXPORT_KERNELS["cov"])
    walls = {"loaded": [], "live": []}
    for _ in range(EXPORT_CALLS):
        for key, fn in (("live", lambda: model.predict_f(ts)), ("loaded", lambda: serve(ts))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    for key, w in walls.items():
        print(f"[export full] {key} predict_f, {EXPORT_CALLS} calls: "
              f"p50 {np.percentile(w, 50):.4f} s, p99 {np.percentile(w, 99):.4f} s")
    print(f"[phase_export_full] {time.perf_counter() - t_start:.1f} s")
    return counts


SERVING_GOLDEN = os.path.join(REPO, "tests", "data", "serving_T256_golden.npz")
SERVING_SEGMENTS = ((0, 100), (100, 200), (200, 256))  # the golden file's
# full-width streaming: B + 1 <= chunk rows a segment (the dummy carry row
# comes first), so no segment is padded to two chunks
N_SEG = 24_999
N_REQUESTS, REQUEST_ROWS, REQUEST_FORECAST = 50, 256, 64


def _hold(tag, got, tol=1e-9):
    """max |val - ref| / max |ref| of each (tensor, numpy) pair, NaN patterns
    equal; fails above tol."""
    for key, (val, ref) in got.items():
        ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
        r = _rel_np(val, ref)
        print(f"[{tag}] {key} max rel {r:.3e} (tol {tol:g})")
        if not r <= tol:
            raise AssertionError(f"{tag}: {key} disagrees with the JAX reference")


def _advection_config5(c5, chunk):
    """`advection_diffusion_gp` at config-5's geometry on c5's data: the 4x4
    grid, collocation at Z + dx/2, diffusivity 0.1, velocity (0.2, 0.1),
    `build_config5`'s kernels and noise, parallel."""
    from physs_gp_tpu_torch.kernels.matern import Matern32
    from physs_gp_tpu_torch.kernels.rbf import RBF
    from physs_gp_tpu_torch.utils.params import positive_param
    from physs_gp_tpu_torch.zoo.spatio_temporal import advection_diffusion_gp

    kw = dict(dtype=c5.t.dtype, device=c5.t.device)
    gx = np.linspace(0, 1, 4)
    Z = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2).astype(np.float32)
    coll = Z + 0.5 * (gx[1] - gx[0])
    return advection_diffusion_gp(
        c5.t, c5.Y[:, :16], Z, coll, diffusivity=0.1, velocity=(0.2, 0.1),
        k_time=Matern32(lengthscale=5.0, variance=1.0, **kw),
        k_space=RBF(lengthscales=positive_param(0.5, **kw), variance=positive_param(1.0, **kw)),
        noise=0.1, coll_noise=1e-3, parallel=True, chunk_size=chunk, **kw,
    )


def _c5_gp(c5, chunk):
    """config-5's kernel, heads and `IndependentGaussian` as an exact
    `StateSpaceGP` and a `StreamingGP` (parallel, chunked)."""
    from physs_gp_tpu_torch.models import StateSpaceGP, StreamingGP

    kw = dict(kernel=c5.kernel, likelihood=c5.likelihood, observation=c5.observation,
              parallel=True, chunk_size=chunk)
    return StateSpaceGP(t=c5.t, Y=c5.Y, **kw), StreamingGP(**kw)


def phase_serving_anchor():
    """The serving path in float64 at T = 256 (chunk 64, 8 blocks) against
    tests/data/serving_T256_golden.npz, rtol 1e-9 of each output's largest
    magnitude: `CVIGP.sample_f` of config-5 after 2 natural-gradient steps,
    fed the JAX draws, in covariance, square-root and fused form (the fused
    kernels must launch with the knob, and only then); `StreamingGP` over
    config-5's data in three segments (carried states, the last segment's
    moments, forecast, predict_y, the batch lml); `StreamingCVI` on config-5
    (lr 1, 2 iterations) and on the temporal Poisson data (lr 0.5, 3
    iterations, with a forecast); `advection_diffusion_gp` at config-5's
    geometry (lml, which must also equal config-5's `StateSpaceGP` lml, and
    `predict_grid` at the training times and at new times)."""
    from physs_gp_tpu_torch.models import StreamingCVI, StreamState
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    gold = np.load(SERVING_GOLDEN)

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device="cuda")

    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    try:
        for form in ("cov", "sqrt", "fused"):
            if form == "fused":
                os.environ["PHYSS_FUSED_COMBINE"] = "1"
            kernels.reset_launch_counts(*FUSED)
            try:
                model = build_config5(256, 64, dtype=torch.float64, sqrt=form == "sqrt")
                model, elbos = natgrad_scan(model, 0.5, n_steps=2)
                f = model.sample_f_given(dev(gold["eps_x"]), dev(gold["eps_y"]), t_new=dev(gold["t_new"]))
            finally:
                os.environ.pop("PHYSS_FUSED_COMBINE", None)
            counts = kernels.launch_counts(*FUSED)
            print(f"[anchor sample {form}] launches of the fused combines: {counts}")
            if any((n > 0) != (form == "fused") for n in counts.values()):
                raise AssertionError(f"anchor sample {form}: the fused combines ran {counts}")
            _hold(f"anchor sample {form}", {"ELBOs": (elbos, gold[f"{form}_elbos"]),
                                            "sample_f": (f, gold[f"{form}_f"])})
        c5 = build_config5(256, 64, dtype=torch.float64)
        gp, s = _c5_gp(c5, 64)
        with torch.no_grad():
            got = {"batch lml": (gp.log_marginal_likelihood(), gold["gp_batch_lml"])}
            st = s.init_state(t0=c5.t[0])
            for k, (lo, hi) in enumerate(SERVING_SEGMENTS):
                st, seg = s.update(st, c5.t[lo:hi], c5.Y[lo:hi])
                got.update({f"segment {k} {n}": (getattr(st, n), gold[f"gp_{n}"][k])
                            for n in StreamState._fields})
            fc, py = s.forecast(st, dev(gold["t_fc"])), s.predict_y(st, dev(gold["t_fc"]))
        got.update({"last segment f_mean": (seg.f_mean, gold["gp_seg_mean"]),
                    "last segment f_var": (seg.f_var, gold["gp_seg_var"]),
                    "last segment lml": (seg.lml, gold["gp_seg_lml"]),
                    "forecast mean": (fc.mean, gold["gp_fc_mean"]),
                    "forecast var": (fc.var, gold["gp_fc_var"]), "predict_y var": (py.var, gold["gp_py_var"])})
        _hold("anchor streaming gp", got)
        tm = build_temporal(256, 64, dtype=torch.float64)
        for tag, model, kw, bounds in (
                ("c5cvi", c5, dict(observation=c5.observation, lr=1.0, n_iters=2), SERVING_SEGMENTS),
                ("tcvi", tm, dict(lr=0.5, n_iters=3), ((0, 128), (128, 256)))):
            sc = StreamingCVI(kernel=model.kernel, likelihood=model.likelihood, parallel=True,
                              chunk_size=64, **kw)
            st, got = sc.init_state(t0=model.t[0]), {}
            for k, (lo, hi) in enumerate(bounds):
                st, seg = sc.update(st, model.t[lo:hi], model.Y[lo:hi])
                got.update({f"segment {k} {n}": (getattr(st, n), gold[f"{tag}_{n}"][k])
                            for n in StreamState._fields})
            if tag == "tcvi":
                fc = sc.forecast(st, dev(gold["t_fc_temporal"]))
                got.update({"last segment posterior mean": (seg.posterior().mean, gold["tcvi_seg_post_mean"]),
                            "forecast mean": (fc.mean, gold["tcvi_fc_mean"]),
                            "forecast var": (fc.var, gold["tcvi_fc_var"])})
            _hold(f"anchor streaming cvi {'config5' if tag == 'c5cvi' else 'temporal'}", got)
        ad = _advection_config5(c5, 64)
        with torch.no_grad():
            lml = ad.log_marginal_likelihood()
            g = ad.predict_grid(dev(gold["s_new"]))
            gn = ad.predict_grid(dev(gold["s_new"]), t_new=dev(gold["t_grid_new"]))
            _hold("anchor predict_grid", {
                "lml": (lml, gold["grid_lml"]), "lml vs config-5's StateSpaceGP": (lml, gp.log_marginal_likelihood()),
                "mean": (g.mean, gold["grid_mean"]), "var": (g.var, gold["grid_var"]),
                "mean at new times": (gn.mean, gold["grid_new_mean"]),
                "var at new times": (gn.var, gold["grid_new_var"])})
    finally:
        del os.environ["PHYSS_SCAN_BLOCKS"]


def _peak():
    return torch.cuda.max_memory_allocated() / 2**30


def phase_sampling_full():
    """F1: config-5 at T = 100 000 (chunk 25 000) after 2 natural-gradient
    steps at lr 0.5, float32: `CVIGP.sample_f` of 16 paths at 1000 new times
    in covariance form and of 4 in square-root form, drawn from a seeded
    generator on the card, each timed with its peak memory and launches
    (counters reset just before `sample_f`, read just after). The draws are
    held to `predict_f` at the same times: z = (f - mean) / sd, pooled over
    samples, times and heads, must have |mean z| < 0.15 and var z in
    [0.8, 1.2]. Returns the paths' (counts, routes)."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    t_new = torch.as_tensor(np.sort(np.random.default_rng(23).uniform(0, 100, 1000)),
                            dtype=torch.float32, device="cuda")
    counts, routes = {}, {}
    for form, sqrt, S, kern in (("cov", False, 16, ("bmm", "gj_solve", "gj_solve_logdet", "chol")),
                                ("sqrt", True, 4, ("bmm", "gj_solve", "lq", "chol", "chol_gram"))):
        tag, path = f"full sample {form}", f"config5 {'sqrt ' if sqrt else ''}sample f32"
        torch.cuda.empty_cache()
        model, elbos, _ = _run_slice(100_000, 25_000, torch.float32, 2, nan_guard=False, sqrt=sqrt)
        gen = torch.Generator(device="cuda").manual_seed(24)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fs = model.sample_f(gen, S, t_new=t_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[path], routes[path] = kernels.launch_counts(), kernels.route_counts()
        peak = _peak()
        pf = model.predict_f(t_new)
        z = (fs - pf.mean) / torch.sqrt(pf.var)
        mz, vz = float(z.mean()), float(z.var())
        ok = fs.shape == (S, 1000, 32) and bool(torch.isfinite(fs).all())
        print(f"[{tag}] ELBOs after 2 steps {elbos.tolist()}")
        print(f"[{tag}] sample_f({S}) at 1000 new times: {wall:.4f} s, peak {peak:.2f} GiB, "
              f"finite and [{S}, 1000, 32] {ok}; z against predict_f: mean {mz:.4f} (bound 0.15), "
              f"var {vz:.4f} (bounds 0.8, 1.2); grid heads: mean {float(z[..., :16].mean()):.4f}, "
              f"var {float(z[..., :16].var()):.4f}; collocation heads: mean "
              f"{float(z[..., 16:].mean()):.4f}, var {float(z[..., 16:].var()):.4f}")
        if not (ok and abs(mz) < 0.15 and 0.8 <= vz <= 1.2):
            raise AssertionError(f"{tag}: the draws disagree with predict_f")
        _path_check(tag, counts[path], routes[path], kern)
        del model, fs, pf, z
    return counts, routes


def phase_streaming_full():
    """F2-F5 at config-5 width (T = 100 000, chunk 25 000, segments of 24 999
    rows and a last one of 4). F2: `StreamingGP` over config-5's kernel,
    heads and `IndependentGaussian`: float64 assimilation timed, its
    summed lml held to the batch `log_marginal_likelihood()` (rtol 1e-8)
    and the carried (m, P) to the batch filter's last row (1e-8); then
    float32 assimilation and 50 requests, each an `update` of 256 rows past
    t_last and a `forecast` at 64 later times, timed one by one (p50, p99).
    F3: `StreamingCVI` on config-5 (lr 1, 2 iterations), float64, the same
    segments: the segment ELBOs sum to the batch lml (rtol 1e-8), time per
    segment. F4: `StreamingCVI` on the temporal Poisson data (10 segments of
    10 000, 8 iterations, lr 0.5, float32): finite lml, `forecast` at 1000
    later times finite with positive variance, RMSE of the online against
    the batch (8 natural-gradient steps) posterior mean below 0.35. F5:
    `advection_diffusion_gp` at config-5's geometry, float64: lml equal to
    F2's (rtol 1e-9), `predict_grid` at 64 new sites at the training times
    and at 1000 new times, timed with peak memory. Launch counters are reset
    just before each path and read just after. Returns (counts, routes)."""
    from physs_gp_tpu_torch.models import CVIGP, StreamingCVI
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.ops.runner import run_filter
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    T, chunk = 100_000, 25_000
    segments = [(lo, min(lo + N_SEG, T)) for lo in range(0, T, N_SEG)]
    cov = ("bmm", "gj_solve", "gj_solve_logdet")
    counts, routes = {}, {}

    def start():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        return time.perf_counter()

    def read(path, kern):
        torch.cuda.synchronize()
        counts[path], routes[path] = kernels.launch_counts(), kernels.route_counts()
        _path_check(path, counts[path], routes[path], kern)

    # F2, float64: assimilation against the batch filter
    torch.cuda.empty_cache()
    c5 = build_config5(T, chunk, dtype=torch.float64)
    gp, s = _c5_gp(c5, chunk)
    with torch.no_grad():
        t0 = start()
        st = s.init_state(t0=c5.t[0])
        for lo, hi in segments:
            st, _ = s.update(st, c5.t[lo:hi], c5.Y[lo:hi])
        torch.cuda.synchronize()
        wall, peak = time.perf_counter() - t0, _peak()
        ssm, R = gp._filter_inputs()
        f = run_filter(ssm, R, gp.Y, parallel=True, chunk_size=chunk)[0]
    batch_lml = float(f.lml)
    gaps = {"lml": abs(float(st.lml) - batch_lml) / abs(batch_lml),
            "m": _rel_np(st.m, f.ms[-1].cpu().numpy()), "P": _rel_np(st.P, f.Ps[-1].cpu().numpy())}
    print(f"[full stream gp] float64 assimilation of {T} rows in {len(segments)} segments: "
          f"{wall:.4f} s, peak {peak:.2f} GiB; against the batch filter: "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in gaps.items()) + " (tol 1e-8)")
    if not max(gaps.values()) <= 1e-8:
        raise AssertionError("full stream gp: streaming disagrees with the batch filter")
    del f, ssm, R

    # F3, float64: StreamingCVI on config-5
    sc = StreamingCVI(kernel=c5.kernel, likelihood=c5.likelihood, observation=c5.observation,
                      parallel=True, chunk_size=chunk, lr=1.0, n_iters=2)
    t0 = start()
    st, walls = sc.init_state(t0=c5.t[0]), []
    for lo, hi in segments:
        t1 = time.perf_counter()
        st, _ = sc.update(st, c5.t[lo:hi], c5.Y[lo:hi])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    peak = _peak()
    read("stream cvi config5 f64", cov)
    gap = abs(float(st.lml) - batch_lml) / abs(batch_lml)
    print(f"[full stream cvi config5] float64 segment wall s {[round(w, 4) for w in walls]}, "
          f"peak {peak:.2f} GiB; summed segment ELBOs {float(st.lml)!r} vs batch lml {batch_lml!r}: "
          f"rel {gap:.3e} (tol 1e-8)")
    if not gap <= 1e-8:
        raise AssertionError("full stream cvi config5: the segment ELBOs do not sum to the batch lml")

    # F5, float64: the same model as a SpatioTemporalGP
    ad = _advection_config5(c5, chunk)
    s_new = torch.as_tensor(np.random.default_rng(26).uniform(0, 1, (64, 2)), dtype=torch.float64,
                            device="cuda")
    t_new = torch.as_tensor(np.sort(np.random.default_rng(27).uniform(0, 100, 1000)),
                            dtype=torch.float64, device="cuda")
    with torch.no_grad():
        lml = float(ad.log_marginal_likelihood())
        t0 = start()
        g = ad.predict_grid(s_new)
        torch.cuda.synchronize()
        wall, peak = time.perf_counter() - t0, _peak()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        gn = ad.predict_grid(s_new, t_new=t_new)
        torch.cuda.synchronize()
        wall_new, peak_new = time.perf_counter() - t1, _peak()
    read("st predict_grid f64", cov)
    gap = abs(lml - batch_lml) / abs(batch_lml)
    ok = (g.mean.shape == (T, 64) and gn.mean.shape == (1000, 64)
          and all(bool(torch.isfinite(x).all()) for x in (*g, *gn))
          and bool((g.var > 0).all() and (gn.var > 0).all()))
    print(f"[full st] lml {lml!r} vs config-5's StateSpaceGP {batch_lml!r}: rel {gap:.3e} (tol 1e-9)")
    print(f"[full st] predict_grid at 64 sites: training times {wall:.4f} s, peak {peak:.2f} GiB; "
          f"1000 new times {wall_new:.4f} s, peak {peak_new:.2f} GiB; finite, positive var, shapes {ok}")
    if not (gap <= 1e-9 and ok):
        raise AssertionError("full st: the SpatioTemporalGP disagrees with config-5's StateSpaceGP")
    del c5, gp, s, sc, ad, g, gn, st

    # F2, float32: assimilation, then 50 requests
    torch.cuda.empty_cache()
    c5 = build_config5(T, chunk, dtype=torch.float32)
    _, s = _c5_gp(c5, chunk)
    rng = np.random.default_rng(25)
    with torch.no_grad():
        t0 = start()
        st = s.init_state(t0=c5.t[0])
        for lo, hi in segments:
            st, _ = s.update(st, c5.t[lo:hi], c5.Y[lo:hi])
        torch.cuda.synchronize()
        wall, peak = time.perf_counter() - t0, _peak()
        t_cur, lat = float(c5.t[-1]), []
        t0 = start()
        for _ in range(N_REQUESTS):
            tb = t_cur + np.sort(rng.uniform(0, 0.256, REQUEST_ROWS))
            yb = np.concatenate([rng.normal(size=(REQUEST_ROWS, 16)), np.zeros((REQUEST_ROWS, 16))], 1)
            tq = tb[-1] + np.sort(rng.uniform(0, 0.064, REQUEST_FORECAST))
            t1 = time.perf_counter()
            st, _ = s.update(st, torch.as_tensor(tb, dtype=torch.float32, device="cuda"),
                             torch.as_tensor(yb, dtype=torch.float32, device="cuda"))
            fc = s.forecast(st, torch.as_tensor(tq, dtype=torch.float32, device="cuda"))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            t_cur = float(tb[-1])
        peak_serve = _peak()
    read("stream gp serve f32", cov)
    p50, p99 = np.percentile(lat, [50, 99])
    ok = bool(torch.isfinite(st.lml) & torch.isfinite(fc.mean).all() & (fc.var > 0).all())
    print(f"[full stream gp] float32 assimilation {wall:.4f} s, peak {peak:.2f} GiB; {N_REQUESTS} requests "
          f"({REQUEST_ROWS} rows + forecast at {REQUEST_FORECAST} times): p50 {p50 * 1e3:.2f} ms, "
          f"p99 {p99 * 1e3:.2f} ms, max {max(lat) * 1e3:.2f} ms, peak {peak_serve:.2f} GiB; "
          f"lml finite and forecast finite with positive var {ok}")
    if not ok:
        raise AssertionError("full stream gp: float32 serving gave a non-finite result")
    del c5, s, st, fc

    # F4, float32: StreamingCVI on the temporal Poisson data
    torch.cuda.empty_cache()
    tm = build_temporal(T, chunk)
    sc = StreamingCVI(kernel=tm.kernel, likelihood=tm.likelihood, parallel=True, chunk_size=chunk,
                      lr=0.5, n_iters=8)
    t0 = start()
    st, walls, means = sc.init_state(t0=tm.t[0]), [], []
    for lo in range(0, T, 10_000):
        t1 = time.perf_counter()
        st, seg = sc.update(st, tm.t[lo:lo + 10_000], tm.Y[lo:lo + 10_000])
        means.append(seg.posterior().mean[1:])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    peak = _peak()
    read("stream cvi temporal f32", cov)
    t_fc = torch.as_tensor(1000.0 + np.sort(np.random.default_rng(28).uniform(0, 100, 1000)),
                           dtype=torch.float32, device="cuda")
    fc = sc.forecast(st, t_fc)
    batch = CVIGP.init(tm.t, tm.Y, tm.kernel, tm.likelihood, parallel=True, chunk_size=chunk)
    batch, _ = natgrad_scan(batch, 0.5, n_steps=8, nan_guard=False)
    with torch.no_grad():
        rmse = float(torch.sqrt(torch.mean((torch.cat(means) - batch.posterior().mean) ** 2)))
    ok = bool(torch.isfinite(st.lml) & torch.isfinite(fc.mean).all() & (fc.var > 0).all())
    print(f"[full stream cvi temporal] float32 segment wall s {[round(w, 4) for w in walls]}, "
          f"peak {peak:.2f} GiB; lml {float(st.lml)!r}; forecast at 1000 later times finite with "
          f"positive var {ok}; RMSE online vs batch posterior mean {rmse:.4f} (bound 0.35)")
    if not (ok and rmse < 0.35):
        raise AssertionError("full stream cvi temporal: non-finite or drifted online fit")
    return counts, routes


def _ct(gen, out, layout):
    """A cotangent for `out` as autograd may hand it over: contiguous,
    expanded (every stride 0, as `out.sum()` gives) or a transposed view."""
    if layout == "expanded":
        return _randn(gen, 1).to(out.dtype).reshape([1] * out.dim()).expand(out.shape)
    if layout == "transposed" and out.dim() >= 2:
        return _randn(gen, *out.shape[:-2], out.shape[-1], out.shape[-2]).to(out.dtype).mT
    return _randn(gen, *out.shape).to(out.dtype)


@contextlib.contextmanager
def _plain_on_card():
    """Every kernel wrapper takes its plain version, on whatever device its
    operands lie (the plain versions are PyTorch operations, device-agnostic),
    and fails if a kernel launches: the check-side reference of
    `phase_backward`, which runs on the card's own tensors."""
    from physs_gp_tpu_torch.ops.cuda import build

    call = build.KernelOp.__call__
    before = dict(build.launch_counts())
    build.KernelOp.__call__ = lambda self, cpu, *args: self.plain(*args)
    try:
        yield
    finally:
        build.KernelOp.__call__ = call
    if build.launch_counts() != before:
        raise AssertionError("a kernel launched under _plain_on_card")


def phase_backward():
    """The backward of every kernel wrapper on the training path, on the
    card against the same call with every wrapper on its plain version
    (`_plain_on_card`, on the same card tensors), float64 then float32 at
    the TOL table's values: `bmm` with every (ta, tb), `psd_solve`,
    `psd_solve_logdet` (the solve on [ct | I], r + d columns), `gen_solve`
    (the solve on Aᵀ), `_cholesky_any(..., assume_psd=True)`, `tria`,
    `tria_sum` and both fused combines, at the scans' batches ([256], [512];
    [1024], [2048] at d = 2) and at full width, with cotangents contiguous,
    expanded (stride 0) and transposed; every batch member is compared.
    Every kernel must launch in these checks, none on a block route.
    Returns `_time_backward`'s rows."""
    from physs_gp_tpu_torch.ops import matrix as mx
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.ops import sqrt_kalman as sk
    from physs_gp_tpu_torch.ops.cuda import build

    gen = torch.Generator(device="cuda").manual_seed(11)
    layouts = ("contiguous", "expanded", "transposed")
    launched = {}

    def grads(fn, xs, cts_of):
        xs = [x.detach().requires_grad_(True) for x in xs]
        outs = fn(*xs)
        outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
        cts = cts_of(outs)
        return torch.autograd.grad(outs, xs, cts), cts

    def check_grad(name, kind, fn, xs, dtype, label, layout):
        build.reset_launch_counts()
        g, cts = grads(fn, xs, lambda outs: [_ct(gen, o, layout) for o in outs])
        torch.cuda.synchronize()
        for k, v in build.launch_counts().items():
            launched[k] = launched.get(k, 0) + v
        routes = build.route_counts()
        if any(r["block"] for r in routes.values()):
            raise AssertionError(f"backward {name} {label}: a block kernel ran: {routes}")
        with _plain_on_card():
            gp, _ = grads(fn, xs, lambda outs: cts)
        for i, (a, b) in enumerate(zip(g, gp)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"backward {name} {label}: non-finite gradient")
            rel, ab = _rel(a, b)
            ok = rel <= TOL[dtype][kind]
            print(f"[backward] {name} {label} ct {layout} d(input {i}) {str(dtype)[6:]}: max_abs_err "
                  f"{ab:.3e} rel {rel:.3e} (tol {TOL[dtype][kind]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"backward {name} {label}: the gradient disagrees with the plain version")

    for dtype in (torch.float64, torch.float32):
        def r(*shape):
            return _randn(gen, *shape).to(dtype)

        # products: every (ta, tb) at the scans' batches and full width
        for N, d in ((N_SCAN, D), (2 * N_SCAN, D), (N_MAIN, D), (1024, 2), (2048, 2), (N_TEMPORAL, 2)):
            for ta, tb in itertools.product((False, True), repeat=2):
                A, B = r(N, d, d), r(N, d, d)
                for layout in (layouts if N == N_SCAN else ("contiguous",)):
                    check_grad("bmm", "bmm", lambda a, b: mx.bmm(a, b, ta, tb), [A, B], dtype,
                               f"[{N},{d},{d}] ta={ta:d} tb={tb:d}", layout)
        # solves: psd_solve, psd_solve_logdet (its backward solves [ct | I]),
        # gen_solve (its backward solves on A^T)
        for N, d, rr in ((N_SCAN, D, D), (N_SCAN, D, 1), (2 * N_SCAN, D, 2 * D), (N_MAIN, D, 1),
                         (2048, 2, 2), (N_TEMPORAL, 1, 1)):
            S, R = _spd(gen, N, d, dtype), r(N, d, rr)
            M = _icj(gen, N, d, dtype)
            for layout in (layouts if N == N_SCAN else ("contiguous",)):
                label = f"[{N},{d},{d}] r={rr}"
                check_grad("psd_solve", "solve", mx.psd_solve, [S, R], dtype, label, layout)
                check_grad("psd_solve_logdet", "solve", mx.psd_solve_logdet, [S, R], dtype,
                           f"{label} (backward r + d = {rr + d})", layout)
                check_grad("gen_solve", "solve", mx.gen_solve, [M, R], dtype, f"{label} (backward on A^T)",
                           layout)
        # factorisations: the Cholesky (backward: the library Cholesky), the
        # LQ and the Gram + Cholesky (backward: the library QR; tria_sum's
        # recomputes through tria's backward reference, with no LQ launch)
        for N, d in ((N_SCAN, D), (N_MAIN, D)):
            A = _spd(gen, N, d, dtype)
            for layout in (("contiguous", "expanded") if N == N_SCAN else ("contiguous",)):
                check_grad("cholesky", "factor", lambda a: mx._cholesky_any(a, assume_psd=True), [A], dtype,
                           f"[{N},{d},{d}]", layout)
        for N, d, m in ((2 * N_SCAN, D, 2 * D), (N_SCAN, D, 2 * D), (N_MAIN, D, 2 * D), (2048, 2, 4),
                        (1024, 2, 4)):
            B = r(N, d, m)
            for layout in (layouts if N == N_SCAN else ("contiguous",)):
                check_grad("tria", "factor", sk.tria, [B], dtype, f"[{N},{d},{m}]", layout)
        for N, d, plus_eye in ((N_SCAN, D, False), (N_SCAN, D, True), (N_MAIN, D, False), (1024, 2, False)):
            # the path's sums X Xᵀ + Y Yᵀ, and X Xᵀ + I (whose backward's
            # pre-array [X, I] stays on the warp LQ)
            xs = [r(N, d, d)] + ([] if plus_eye else [r(N, d, d)])
            for layout in (layouts if N == N_SCAN else ("contiguous",)):
                check_grad("tria_sum", "factor", lambda x, y=None: sk.tria_sum(x, y, plus_eye), xs, dtype,
                           f"[{N},{d},{d}]" + (" + I" if plus_eye else f" + [{N},{d},{d}]"), layout)
        # the fused combines (backward: the unfused combine, bmm and gj_solve)
        os.environ["PHYSS_FUSED_COMBINE"] = "1"
        try:
            for N in (N_SCAN // 2, N_SCAN, N_MAIN):
                ei, ej = _filter_elems(gen, N, D, dtype), _filter_elems(gen, N, D, dtype, first=2)
                sj, si = _smoother_elems(gen, N, D, dtype), _smoother_elems(gen, N, D, dtype, last=2)
                for layout in (("contiguous", "expanded") if N == N_SCAN else ("contiguous",)):
                    build.reset_launch_counts(*FUSED)
                    check_grad("fused_filter", "fused",
                               lambda *x: pk._filtering_operator(pk._FilterElems(*x[:5]), pk._FilterElems(*x[5:])),
                               [*ei, *ej], dtype, f"[{N},{D},{D}]", layout)
                    check_grad("fused_smooth", "fused",
                               lambda *x: pk._smoothing_operator(pk._SmootherElems(*x[:3]), pk._SmootherElems(*x[3:])),
                               [*sj, *si], dtype, f"[{N},{D},{D}]", layout)
        finally:
            del os.environ["PHYSS_FUSED_COMBINE"]
    launched = {k: v for k, v in launched.items() if v}
    print(f"[backward] launches of the checks above (forward and backward): {launched}")
    for k in ("bmm", "gj_solve", "gj_solve_logdet", "lq", "chol", "chol_gram", *FUSED):
        if not launched.get(k):
            raise AssertionError(f"backward: the checks never launched {k}")
    return _time_backward(gen)


def _time_backward(gen):
    """The kernel calls that only the backward makes, float32, device time
    back to back beside the plain version, the library call and the bound:
    `bmm` with (ta, tb) = (T, T) and (T, F) at [256, 32, 32]; the solve at
    r + d (psd_solve_logdet's [ct | I] for the lml's innovations,
    [100 000, 32, 32], r = 1 + 32; CUDA events around a run of calls) and
    on Aᵀ (gen_solve's in the scans' combines, made contiguous,
    [256, 32, 32], r = 32). Returns {kernel: [rows]}."""
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl

    f32, n, d = torch.float32, N_SCAN, D
    A, B = _randn(gen, n, d, d).to(f32), _randn(gen, n, d, d).to(f32)
    nl = N_LML
    S = _spd(gen, nl, d, f32)
    ctI = torch.cat([_randn(gen, nl, d, 1).to(f32), torch.eye(d, device="cuda").expand(nl, d, d)], -1)
    At = _icj(gen, n, d, f32).mT.contiguous()
    Rt = _randn(gen, n, d, d).to(f32)
    host = "as the host sends them"
    timed = [
        ("bmm", f"[{n},{d},{d}]^T @ [{n},{d},{d}]^T", lambda: bl.batch_bmm(A, B, True, True),
         lambda: bl.bmm_plain(A, B, True, True), lambda: torch.matmul(A.mT, B.mT),
         "torch.matmul, device time back to back", _time_device, _nbytes(A, B) + 4 * n * d * d, 2 * n * d ** 3),
        ("bmm", f"[{n},{d},{d}]^T @ [{n},{d},{d}]", lambda: bl.batch_bmm(A, B, True, False),
         lambda: bl.bmm_plain(A, B, True, False), lambda: torch.matmul(A.mT, B),
         "torch.matmul, device time back to back", _time_device, _nbytes(A, B) + 4 * n * d * d, 2 * n * d ** 3),
        ("gj_solve", f"[{nl},{d},{d}] r={d + 1} ([ct | I])", lambda: bl.batch_solve(S, ctI),
         lambda: bl.gj_solve_plain(S, ctI), lambda: torch.linalg.solve(S, ctI), "torch.linalg.solve",
         _time, _nbytes(S, ctI) + 4 * nl * d * (d + 1), nl * (2 * d ** 3 // 3 + 2 * d * d * (d + 1))),
        ("gj_solve", f"[{n},{d},{d}] r={d} (A^T)", lambda: bl.batch_solve(At, Rt),
         lambda: bl.gj_solve_plain(At, Rt), lambda: torch.linalg.solve(At, Rt), f"torch.linalg.solve, {host}",
         _time, _nbytes(At, Rt) + 4 * n * d * d, n * (2 * d ** 3 // 3 + 2 * d ** 3)),
    ]
    out = {}
    for name, shape, kern, plain, lib, lib_label, lib_clock, nbytes, flops in timed:
        kern(), plain(), lib()
        torch.cuda.synchronize()
        clock = _time if lib_clock is _time and not shape.startswith(f"[{n},") else _time_device
        p1, k1, l1 = _time(plain), clock(kern), lib_clock(lib)
        l2, k2, p2 = lib_clock(lib), clock(kern), _time(plain)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {"shape": shape, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2,
               "library": lib_label, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "timing": "events" if clock is _time else "device_back_to_back"}
        out.setdefault(name, []).append(row)
        print(f"[backward] time {name} {shape} f32: kernel {row['ms']:.4f} ms ({row['timing']}), "
              f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms ({lib_label}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return out


TRAIN_GOLDEN = os.path.join(REPO, "tests", "data", "train_T256_golden.npz")
ADAM_LR, NG_LR = 0.05, 0.5


def _jax_key(name):
    """A parameter name as the JAX key path of the golden file."""
    return "".join(f"[{p}]" if p.isdigit() else f".{p}" for p in name.split("."))


def _rel_np(val, ref):
    val = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
    ok = np.isfinite(ref)
    if not np.array_equal(np.isfinite(val), ok):
        return float("inf")
    return float(np.max(np.abs(val[ok] - ref[ok])) / np.max(np.abs(ref[ok])))


def phase_train_anchor(form, fused=False):
    """The training anchor against tests/data/train_T256_golden.npz (made by
    scripts/port/make_train_golden.py from the JAX package), float64,
    T = 256, chunk 64, 8 blocks: 2 natgrad_scan steps at lr 0.5, then
    get_objective() and its gradient with respect to every trainable raw
    (rtol 1e-9), then 3 iterations of vb_ng_adam_scan(adam_lr=0.05,
    ng_lr=0.5): ELBOs and raws at 1e-9, sites and posterior at 1e-7. `fused`
    sets PHYSS_FUSED_COMBINE=1 (the covariance form, same numbers)."""
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.trainers import natgrad_scan, vb_ng_adam_scan
    from physs_gp_tpu_torch.utils.training import trainable_parameters
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    tag = f"train anchor {form}" + (" fused" if fused else "")
    env = {"PHYSS_SCAN_BLOCKS": "8", **({"PHYSS_FUSED_COMBINE": "1"} if fused else {})}
    os.environ.update(env)
    kernels.reset_launch_counts(*FUSED)
    try:
        build = build_temporal if form.startswith("t_") else build_config5
        model = build(256, 64, dtype=torch.float64, sqrt=form.endswith("sqrt"))
        model, _ = natgrad_scan(model, NG_LR, n_steps=2)
        obj = model.get_objective()
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        grads = torch.autograd.grad(obj, trainable_parameters(model))
        model, elbos = vb_ng_adam_scan(model, 3, adam_lr=ADAM_LR, ng_lr=NG_LR)
        post = model.posterior()
    finally:
        for key in env:
            del os.environ[key]
    fused_launches = kernels.launch_counts(*FUSED)
    if any((n > 0) != fused for n in fused_launches.values()):
        raise AssertionError(f"{tag}: fused launches {fused_launches} with fused={fused}")
    gold = np.load(TRAIN_GOLDEN)
    worst = {"objective": _rel_np(obj, gold[f"{form}:objective"]),
             "gradient": max(_rel_np(g, gold[f"{form}:grad:{_jax_key(n)}"]) for n, g in zip(names, grads)),
             "elbos": _rel_np(elbos, gold[f"{form}:elbos"]),
             "raws": max(_rel_np(p, gold[f"{form}:raw:{_jax_key(n)}"]) for n, p in model.named_parameters())}
    if len(names) != sum(k.startswith(f"{form}:grad:") for k in gold.files):
        raise AssertionError(f"{tag}: {len(names)} trainable raws, the golden file has others")
    tight = dict(worst)
    worst.update({"site_Y": _rel_np(model.sites.Y, gold[f"{form}:site_Y"]),
                  "site_V_diag": _rel_np(torch.diagonal(model.sites.V, dim1=-2, dim2=-1),
                                         gold[f"{form}:site_V_diag"]),
                  "post_mean": _rel_np(post.mean, gold[f"{form}:post_mean"]),
                  "post_var": _rel_np(post.var, gold[f"{form}:post_var"])})
    print(f"[{tag}] objective {obj.item()!r}, {len(names)} trainable raws, ELBOs {elbos.tolist()}")
    print(f"[{tag}] max rel: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + " (tol 1e-9 objective, gradient, ELBOs, raws; 1e-7 sites, posterior)")
    if not (max(tight.values()) <= 1e-9 and max(worst.values()) <= 1e-7):
        raise AssertionError(f"{tag}: the float64 training run disagrees with the JAX reference")


class _TrainProbe:
    """Instrument one training run through the entry point a user calls:
    synchronise around the model's `natural_gradient_update` and
    `get_objective` and around every optimiser step (PyTorch's global step
    hooks), so each iteration splits into the natural-gradient half and the
    Adam half's forward, backward and update, each with its wall time, its
    launches per kernel and route, and the iteration's peak memory and
    whether every gradient is finite."""

    def __init__(self, model):
        self.model, self.iters, self._hooks = model, [], []

    def _close(self, nxt):
        from physs_gp_tpu_torch.ops import cuda as kernels

        torch.cuda.synchronize()
        now, rec = time.perf_counter(), self.iters[-1]
        rec["wall"][self._part] = now - self._t
        rec["launches"][self._part] = kernels.launch_counts()
        rec["routes"][self._part] = kernels.route_counts()
        kernels.reset_launch_counts()
        self._part, self._t = nxt, time.perf_counter()

    def __enter__(self):
        from torch.optim import optimizer

        from physs_gp_tpu_torch.ops import cuda as kernels

        model = self.model
        ng, objective = model.natural_gradient_update, model.get_objective

        def natural_gradient_update(*a, **k):
            if not self.iters or "update" in self.iters[-1]["wall"]:  # a retry stays in its iteration
                torch.cuda.synchronize()
                self.iters.append({"wall": {}, "launches": {}, "routes": {}})
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                self._part, self._t = "ng", time.perf_counter()
            return ng(*a, **k)

        def get_objective(*a, **k):
            self._close("forward")
            loss = objective(*a, **k)
            self._close("backward")
            return loss

        def pre_step(opt, args, kwargs):
            self._close("update")
            params = [p for group in opt.param_groups for p in group["params"]]
            self.iters[-1]["grad_finite"] = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                                                for p in params)
            self._t = time.perf_counter()

        def post_step(opt, args, kwargs):
            self._close(None)
            self.iters[-1]["peak"] = torch.cuda.max_memory_allocated()
            self.iters[-1]["kept"] = torch.cuda.memory_allocated()

        model.natural_gradient_update, model.get_objective = natural_gradient_update, get_objective
        self._hooks = [optimizer.register_optimizer_step_pre_hook(pre_step),
                       optimizer.register_optimizer_step_post_hook(post_step)]
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        del self.model.natural_gradient_update, self.model.get_objective

    def total(self, part):
        """Launches per kernel in `part` over all iterations."""
        out = {}
        for rec in self.iters:
            for k, v in rec["launches"][part].items():
                out[k] = out.get(k, 0) + v
        return out

    def routes(self, part):
        out = {}
        for rec in self.iters:
            for k, r in rec["routes"][part].items():
                for route, v in r.items():
                    out.setdefault(k, {}).setdefault(route, 0)
                    out[k][route] += v
        return out


def _train_full(tag, temporal, sqrt, dtype, path_kernels, fused=False):
    """3 iterations at full width through the entry point a user calls:
    `vb_ng_adam_scan` on config-5 (T = 100 000, chunk 25 000), `VB_NG_Adam`
    on the temporal model (T = 100 000, chunk 50 000; the caller sets 1024
    blocks), adam_lr 0.05, ng_lr 0.5. Prints each iteration's parts, peak
    memory, the forward's and the backward's launches per kernel and route;
    fails unless the ELBOs and every gradient are finite, the peak does not
    grow from iteration 2 to 3, every launch takes a warp or tiled kernel,
    every kernel of the path launches in the forward and `bmm` and
    `gj_solve` in the backward. Returns (model, {part: launches})."""
    from physs_gp_tpu_torch.trainers import VB_NG_Adam, vb_ng_adam_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    dt = str(dtype)[6:]
    torch.cuda.empty_cache()
    if temporal:
        model = build_temporal(N_TEMPORAL, TEMPORAL_CHUNK, dtype=dtype, sqrt=sqrt)
    else:
        model = build_config5(100_000, 25_000, dtype=dtype, sqrt=sqrt)
    torch.cuda.synchronize()
    with _TrainProbe(model) as probe:
        if temporal:
            model, losses = VB_NG_Adam(model, adam_lr=ADAM_LR, ng_lr=NG_LR).train(model, 3)
            elbos = -np.array(losses)
        else:
            model, elbos = vb_ng_adam_scan(model, 3, adam_lr=ADAM_LR, ng_lr=NG_LR)
            elbos = elbos.cpu().numpy()
    print(f"[{tag}] {dt} ELBOs {elbos.tolist()}")
    for i, rec in enumerate(probe.iters):
        w = rec["wall"]
        print(f"[{tag}] {dt} iteration {i}: natural-gradient half {w['ng']:.4f} s, Adam half "
              f"{w['forward'] + w['backward'] + w['update']:.4f} s (forward {w['forward']:.4f}, backward "
              f"{w['backward']:.4f}, update {w['update']:.4f}), peak {rec['peak']} B "
              f"({rec['peak'] / 2**30:.2f} GiB), kept after it {rec['kept']} B, "
              f"gradient finite {rec['grad_finite']}")
    parts = {part: probe.total(part) for part in ("ng", "forward", "backward", "update")}
    routes = {part: probe.routes(part) for part in parts}
    for part in ("forward", "backward"):
        print(f"[{tag}] {dt} {part} launches (3 iterations): {parts[part]}; by route: {routes[part]}")
    if len(probe.iters) != 3 or not all(rec["grad_finite"] for rec in probe.iters) \
            or not np.all(np.isfinite(elbos)):
        raise AssertionError(f"{tag} {dt}: non-finite ELBO or gradient")
    # A graph or a site kept across iterations would add a step's saved
    # tensors (GiB) to the peak and to what an iteration leaves allocated.
    # The caching allocator does not split a cached large block whose
    # remainder would be 1 MiB or less and counts it whole, so the same work
    # reads a few MiB apart from one iteration to the next: 0.1 % is the
    # bound for "does not grow".
    for key in ("peak", "kept"):
        a, b = probe.iters[1][key], probe.iters[2][key]
        if b > a * 1.001:
            raise AssertionError(f"{tag} {dt}: {key} memory grew from iteration 2 to 3: {a} -> {b} B")
    if any(r.get("block") for part in routes.values() for r in part.values()):
        raise AssertionError(f"{tag} {dt}: a block-per-matrix kernel ran: {routes}")
    if not all(parts["forward"].get(k) for k in path_kernels):
        raise AssertionError(f"{tag} {dt}: a kernel of the path never launched in the forward")
    if not (parts["backward"].get("bmm") and parts["backward"].get("gj_solve")):
        raise AssertionError(f"{tag} {dt}: the backward launched no bmm or no gj_solve")
    if any(v for part in parts.values() for k, v in part.items() if k in FUSED and not fused):
        raise AssertionError(f"{tag} {dt}: a fused combine ran with its knob unset")
    return model, parts


def _grad_gap(tag, model64, build):
    """The float32 gradient at the float64 model's parameters and sites,
    cast to float32, against the float64 gradient: normwise relative gap
    over every trainable raw, bound 1e-2."""
    from physs_gp_tpu_torch.utils.training import trainable_parameters

    def flat_grad(model):
        g = torch.autograd.grad(model.get_objective(), trainable_parameters(model))
        return torch.cat([x.reshape(-1) for x in g]).double()

    g64 = flat_grad(model64)
    model32 = build(torch.float32)
    model32.load_state_dict(model64.state_dict())
    g32 = flat_grad(model32)
    gap = float((g32 - g64).abs().max() / g64.abs().max())
    print(f"[{tag}] float32 vs float64 gradient at the float64 state: normwise rel gap {gap:.3e} (bound 1e-2); "
          f"per raw {((g32 - g64).abs() / g64.abs()).cpu().numpy().round(5).tolist()}")
    if not gap <= 1e-2:
        raise AssertionError(f"{tag}: the float32 gradient misses the float64 one")


def phase_train_full():
    """Full-width training: config-5 float32 in covariance, covariance with
    PHYSS_FUSED_COMBINE=1 and square-root form, and float64 in covariance
    form (square-root float64 is not run: its saved tensors would not fit),
    3 iterations of vb_ng_adam_scan each; the temporal model in both forms
    and types, 3 iterations of VB_NG_Adam each. After each float64 run
    (config-5 covariance, temporal both forms) the float32 gradient at its
    state is held to the float64 one. Returns {path: launches per kernel}."""
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    cov = ("bmm", "gj_solve", "gj_solve_logdet")
    sqrt_kernels = tuple(k for k in SOURCES if k not in FUSED)
    paths = {}
    os.environ["PHYSS_KZZ_JITTER"] = "1e-4"
    for form, sqrt, fused, kern in (("cov", False, False, cov), ("cov fused", False, True, cov + FUSED),
                                    ("sqrt", True, False, sqrt_kernels)):
        if fused:
            os.environ["PHYSS_FUSED_COMBINE"] = "1"
        try:
            model, parts = _train_full(f"train {form}", False, sqrt, torch.float32, kern, fused)
        finally:
            os.environ.pop("PHYSS_FUSED_COMBINE", None)
        del model
        for part in ("forward", "backward"):
            paths[f"train {form} f32 {part}"] = parts[part]
    model, _ = _train_full("train cov", False, False, torch.float64, cov)
    _grad_gap("train cov", model, lambda dt: build_config5(100_000, 25_000, dtype=dt))
    del model
    os.environ["PHYSS_SCAN_BLOCKS"] = str(TEMPORAL_BLOCKS)
    try:
        for form, sqrt in (("cov", False), ("sqrt", True)):
            kern = ("bmm", "gj_solve", "gj_solve_logdet") + (("lq", "chol_gram") if sqrt else ())
            model, parts = _train_full(f"train temporal {form}", True, sqrt, torch.float32, kern)
            del model
            for part in ("forward", "backward"):
                paths[f"train temporal {form} f32 {part}"] = parts[part]
            model, _ = _train_full(f"train temporal {form}", True, sqrt, torch.float64, kern)
            _grad_gap(f"train temporal {form}", model,
                      lambda dt, sqrt=sqrt: build_temporal(N_TEMPORAL, TEMPORAL_CHUNK, dtype=dt, sqrt=sqrt))
            del model
    finally:
        del os.environ["PHYSS_SCAN_BLOCKS"]
    return paths


# ---------------------------------------------------------------------------
# The physics-informed path: Allen-Cahn, the pendulum, the monotonic model
# and ode_gp (slice 5b)
# ---------------------------------------------------------------------------

PHYSICS_GOLDEN = os.path.join(REPO, "tests", "data", "physics_golden.npz")
PHYSICS_PATH = "physics ac sqrt f32"
# every kernel the Allen-Cahn path launches (no bmm: its sequential filters
# and site ELL multiply in PyTorch's own ops), and the block-per-matrix
# routes its d > 32 shapes take: the [1, 64, 64] update and smoother
# pre-arrays (lq), the [56, 34, 34] site inverses (the two solves) and the
# site factors R^1/2 [56, 34, 34] (chol)
PHYSICS_KERNELS = ("gj_solve", "gj_solve_logdet", "lq", "chol")
PHYSICS_BLOCK_ROUTES = ("gj_solve", "gj_solve_logdet", "lq", "chol")
PHYSICS_ITERS = 20
# The outcome gate (physics on against off, 300 iterations each) runs in
# experiments_torch/ac.py --quick, not here: its two trainings take ~115 s
# on one H100.
# Allen-Cahn anchors: 10 x the JAX package's largest gap between its CPU
# branch and its Gauss-Jordan / Pallas-Cholesky branch on the same anchor
# (`scripts/port/make_physics_golden.py --self-gap`: ELBOs 3.344e-08, sites
# Y 9.444e-08, site variances 5.848e-09, posterior mean 5.522e-08, var
# 1.707e-07): the samples' block covariance S is numerically singular, so
# its Cholesky factor is fixed only up to rounding in the near-null
# directions, which the collocation noise 1e-5 amplifies
AC_TOL = {"elbos": 3.3e-7, "sites Y": 9.4e-7, "sites V diag": 5.8e-8, "posterior mean": 5.5e-7,
          "posterior var": 1.7e-6}
PHYSICS_TOL = {"elbos": 1e-9, "sites Y": 1e-7, "sites V diag": 1e-7, "posterior mean": 1e-7,
               "posterior var": 1e-7}


def _allen_cahn():
    """experiments_torch/ac.py: the Allen-Cahn driver's inputs and model."""
    from experiments_torch import ac

    return ac


@contextlib.contextmanager
def _kzz_jitter(value):
    """PHYSS_KZZ_JITTER set to `value` (None: unset) for the block."""
    old = os.environ.pop("PHYSS_KZZ_JITTER", None)
    if value is not None:
        os.environ["PHYSS_KZZ_JITTER"] = value
    try:
        yield
    finally:
        os.environ.pop("PHYSS_KZZ_JITTER", None)
        if old is not None:
            os.environ["PHYSS_KZZ_JITTER"] = old


def _check_physics_shapes(gen, dtype, report):
    """The kernels at the Allen-Cahn path's shapes (T = 56, p = 34, d = 30):
    the site inverse and solve + logdet [56, 34, 34] with a stride-0
    identity (block route), the LQ of the update pre-array [1, 64, 64]
    (block) and of the prediction's [1, 30, 60] and the smoother's
    [1, 60, 60], the Cholesky of the site blocks [56, 34, 34] (block) and of
    Q [56, 30, 30]. Each launch's route is asserted."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import build

    T, p, d = 56, 34, 30
    build.reset_launch_counts()
    S = _spd(gen, T, p, dtype)
    eye = torch.eye(p, dtype=dtype, device="cuda").expand(T, p, p)
    report("gj_solve", "solve", *_rel(bl.batch_solve(S, eye), bl.gj_solve_plain(S, eye)), dtype,
           f"[{T},{p},{p}] r={p} stride-0 I (physics)")
    X, ld = bl.batch_solve_logdet(S, eye)
    Xp, ldp = bl.gj_solve_logdet_plain(S, eye)
    report("gj_solve_logdet", "solve", *_rel(X, Xp), dtype, f"[{T},{p},{p}] r={p} (physics)")
    report("gj_solve_logdet", "logdet", *_rel(ld, ldp), dtype, f"[{T},{p},{p}] r={p} (physics)")
    for dd, m in ((p + d, p + d), (d, 2 * d), (2 * d, 2 * d)):
        B = _randn(gen, 1, dd, m).to(dtype)
        L, Lp = bq.batch_tria(B), bq.tria_plain(B)
        report("lq", "factor", *_rel(L @ L.mT, Lp @ Lp.mT), dtype, f"[1,{dd},{m}] L L^T (physics)")
    for n in (p, d):
        A = _spd(gen, T, n, dtype)
        L, Lp = bc.batch_cholesky(A), bc.cholesky_plain(A)
        report("chol", "factor", *_rel(L, Lp), dtype, f"[{T},{n},{n}] (physics)")
    routes = build.route_counts()
    want = {"gj_solve": (0, 1), "gj_solve_logdet": (0, 1), "lq": (1, 2), "chol": (1, 1)}
    got = {k: (routes[k]["warp"], routes[k]["block"]) for k in want}
    if got != want:
        raise AssertionError(f"physics shapes: routes {got}, expected (warp, block) {want}")
    print(f"[kernels] physics shapes {str(dtype)[6:]}: routes (warp, block) {got}")


def _check_batch_shapes(gen, dtype, report):
    """The Cholesky kernel at the batch family's shapes: its 2-D factors of
    n <= 80 run as a batch of one, [1, 10, 10] (SVGP's inducing Gram) and
    [1, 24, 24] (the joint covariance of `deriv_gp`'s samples) on the warp
    route, [1, 60, 60] (the monotonic arm's M·P) and [1, 80, 80] (the
    curl-free and Helmholtz Grams at N = 40) on the block route. Each
    launch's route is asserted."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import build

    build.reset_launch_counts()
    for n in BATCH_CHOL_N:
        A = _spd(gen, 1, n, dtype)
        report("chol", "factor", *_rel(bc.batch_cholesky(A), bc.cholesky_plain(A)), dtype,
               f"[1,{n},{n}] (batch)")
    got = {k: build.route_counts()["chol"][k] for k in ("warp", "block")}
    if got != {"warp": 2, "block": 2}:
        raise AssertionError(f"batch shapes: chol routes {got}, expected 2 warp and 2 block")
    print(f"[kernels] batch shapes {str(dtype)[6:]}: chol routes {got}")


# (N, d, p) of the dynamics path's scans: the Lorenz iterated smoother's
# chunk at T = 20 000 (state d = 3, one observation) and the dynamic
# correlation model at P = 5 over T = 2520 (d = 2Q = 20, p = 5)
DYN_SHAPES = ((5000, 3, 1), (2520, 20, 5))


def _check_dynamics_shapes(gen, dtype, report):
    """The kernels at the dynamics path's shapes (DYN_SHAPES), each against
    its plain version at TOL: the [d, d] products in all four transposes, the
    filter elements' [p, d] products, the affine offsets' [1, d] x [d, d]^T;
    the combine's inverse (stride-0 identity, r = d), the smoother's gain
    solve (r = d), the filter elements' S^-1 [HP | v | H] (r = 2d + 1); the
    solve with log-determinant of S and of a [d, d] system (r = 1); in
    float64 the sequential EKS smoother's [1, 3, 3] Cholesky. Every launch
    must take the warp kernel."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import build

    build.reset_launch_counts()
    for N, d, p in DYN_SHAPES:
        tag = f"(dynamics d={d})"
        cases = [((d, d), (d, d), ta, tb) for ta in (False, True) for tb in (False, True)]
        cases += [((p, d), (d, d), False, False), ((p, d), (p, d), False, True),
                  ((p, d), (p, d), True, False), ((1, d), (d, d), False, True)]
        for a, b, ta, tb in cases:
            A, B = _randn(gen, N, *a).to(dtype), _randn(gen, N, *b).to(dtype)
            report("bmm", "bmm", *_rel(bl.batch_bmm(A, B, ta, tb), bl.bmm_plain(A, B, ta, tb)), dtype,
                   f"[{N},{a[0]},{a[1]}]{'^T' * ta} x [{N},{b[0]},{b[1]}]{'^T' * tb} {tag}")
        eye = torch.eye(d, dtype=dtype, device="cuda").expand(N, d, d)
        for M, R, label in ((_icj(gen, N, d, dtype), eye, "stride-0 I"),
                            (_spd(gen, N, d, dtype), _randn(gen, N, d, d).to(dtype), "dense"),
                            (_spd(gen, N, p, dtype), _randn(gen, N, p, 2 * d + 1).to(dtype), "dense")):
            report("gj_solve", "solve", *_rel(bl.batch_solve(M, R), bl.gj_solve_plain(M, R)), dtype,
                   f"[{N},{M.shape[-1]},{M.shape[-1]}] r={R.shape[-1]} {label} {tag}")
        for n in (p, d):
            M, R = _spd(gen, N, n, dtype), _randn(gen, N, n, 1).to(dtype)
            (X, ld), (Xp, ldp) = bl.batch_solve_logdet(M, R), bl.gj_solve_logdet_plain(M, R)
            report("gj_solve_logdet", "solve", *_rel(X, Xp), dtype, f"[{N},{n},{n}] r=1 X {tag}")
            report("gj_solve_logdet", "logdet", *_rel(ld, ldp), dtype, f"[{N},{n},{n}] r=1 logdet {tag}")
    if dtype == torch.float64:
        A = _spd(gen, 1, 3, dtype)
        report("chol", "factor", *_rel(bc.batch_cholesky(A), bc.cholesky_plain(A)), dtype,
               "[1,3,3] (dynamics EKS smoother)")
    routes = build.route_counts()
    if any(r.get("block") for r in routes.values()) or \
            not all(routes.get(k, {}).get("warp") for k in ("gj_solve", "gj_solve_logdet")):
        raise AssertionError(f"dynamics shapes: expected every launch on the warp kernels: {routes}")
    print(f"[kernels] dynamics shapes {str(dtype)[6:]}: launches {build.launch_counts()}, "
          f"all on the warp kernels")


def _time_physics(gen):
    """Kernel, plain and library time at the Allen-Cahn path's block-route
    shapes, float32: the LQ of [1, 64, 64] (kernel: device time back to
    back) against `torch.linalg.qr`; the solve and solve + logdet of
    [56, 34, 34] with r = 34 (the site inverses) against
    `torch.linalg.solve`; the Cholesky of the site blocks [56, 34, 34]
    against `torch.linalg.cholesky`. The library calls take longer on the
    host than on the device and cannot be queued: CUDA events around a run
    of calls, as the host sends them. Returns {kernel: [row]}."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq

    f32, T, p = torch.float32, 56, 34
    S = _spd(gen, T, p, f32)
    eye = torch.eye(p, device="cuda").expand(T, p, p)
    pre = _randn(gen, 1, 64, 64).to(f32)
    host = "as the host sends them"
    solve_flops = T * (2 * p ** 3 // 3 + 2 * p ** 3)
    timed = [  # kernel, shape, call, plain, library, label, clock, bytes, flops
        ("lq", "[1,64,64]", lambda: bq.batch_tria(pre), lambda: bq.tria_plain(pre),
         lambda: torch.linalg.qr(pre.mT, mode="r"), f"torch.linalg.qr(B^T, mode='r'), {host}",
         _time_device,
         _nbytes(pre) + 4 * 64 * 64, 2 * 64 ** 3 - 2 * 64 ** 3 // 3),
        ("gj_solve", f"[{T},{p},{p}] r={p} (stride-0 I)", lambda: bl.batch_solve(S, eye),
         lambda: bl.gj_solve_plain(S, eye), lambda: torch.linalg.solve(S, eye),
         f"torch.linalg.solve, {host}", _time, _nbytes(S, eye) + 4 * T * p * p, solve_flops),
        ("gj_solve_logdet", f"[{T},{p},{p}] r={p} (stride-0 I)", lambda: bl.batch_solve_logdet(S, eye),
         lambda: bl.gj_solve_logdet_plain(S, eye), None, None, _time,
         _nbytes(S, eye) + 4 * T * (p * p + 1), solve_flops),
        # the Cholesky reads only the lower triangle: p (p + 1) / 2 words
        ("chol", f"[{T},{p},{p}]", lambda: bc.batch_cholesky(S), lambda: bc.cholesky_plain(S),
         lambda: torch.linalg.cholesky(S), f"torch.linalg.cholesky, {host}", _time,
         4 * T * p * (p + 1) // 2 + 4 * T * p * p, T * p ** 3 // 3),
    ]
    out = {}
    for name, shape, kern, plain, lib, lib_label, clock, nbytes, flops in timed:
        kern(), plain()
        if lib is not None:
            lib()
        torch.cuda.synchronize()
        p1, k1 = _time(plain), clock(kern)
        l1 = _time(lib) if lib is not None else None
        l2 = _time(lib) if lib is not None else None
        k2, p2 = clock(kern), _time(plain)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {"shape": shape, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "library_ms": None if lib is None else (l1 + l2) / 2, "library": lib_label,
               "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "timing": "device_back_to_back" if clock is _time_device else "events"}
        out.setdefault(name, []).append(row)
        lib_txt = "none" if lib is None else f"{row['library_ms']:.4f} ms ({lib_label})"
        print(f"[kernels] time {name} {shape} f32 (physics, block route): kernel {row['ms']:.4f} ms "
              f"({row['timing']}), plain {row['plain_ms']:.4f} ms, library {lib_txt}, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP)")
    return out


def _hold_elbos(tag, elbos, ref, tol=1e-9):
    r = float(np.max(np.abs(np.asarray(elbos) - ref) / np.abs(ref)))
    print(f"[{tag}] ELBOs {elbos} max rel {r:.3e} (tol {tol:g})")
    if not r <= tol:
        raise AssertionError(f"{tag}: ELBOs disagree with the JAX reference")


def _hold_cvi(tag, model, elbos, g, key, tol=PHYSICS_TOL):
    """ELBOs, sites and posterior moments against the golden `key_*`."""
    _hold_elbos(tag, elbos, g[f"{key}_elbos"], tol["elbos"])
    post = model.posterior()
    got = {"sites Y": (model.sites.Y, g[f"{key}_sites_Y"]),
           "sites V diag": (torch.diagonal(model.sites.V, dim1=-2, dim2=-1), g[f"{key}_sites_Vdiag"]),
           "posterior mean": (post.mean, g[f"{key}_mean"]),
           "posterior var": (post.var, g[f"{key}_var"])}
    for q, pair in got.items():
        _hold(tag, {q: pair}, tol[q])


def phase_physics_anchor():
    """Float64 anchors against tests/data/physics_golden.npz (made by
    scripts/port/make_physics_golden.py from the JAX package on the CPU):
    Allen-Cahn at the experiment's full width (T = 56, Ns = 10, Nc = 12,
    n_mc = 32), 3 Gauss-Newton steps at lr 0.3 fed the JAX draws, in
    sequential covariance and square-root form; the pendulum (40 data, 80
    collocation points, n_mc = 16) likewise; the monotonic model (30 data,
    100 collocation points), 3 exact steps at lr 0.5; `ode_gp`'s lml and
    `predict_f`. Then the experiment's hardware gate on the JAX-trained
    Allen-Cahn sites: the float64 covariance posterior to 1e-7, and the
    float32 square-root posterior (PHYSS_KZZ_JITTER=1e-4 on both sides)
    within max |Δmean| < 0.02 on the grid heads over the extrapolation
    window of the JAX CPU float32 one."""
    from physs_gp_tpu_torch.approx.cvi import Sites
    from physs_gp_tpu_torch.kernels.matern import Matern72
    from physs_gp_tpu_torch.zoo.physics import monotonic_cvi_gp, nonlinear_ode_cvi_gp, ode_gp

    ac = _allen_cahn()
    g = np.load(PHYSICS_GOLDEN)
    f64 = torch.float64

    def dev(x, dtype=f64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    ac_in = (g["ac_t"], g["ac_Y"], g["ac_Z"], g["ac_coll"])
    with _kzz_jitter(None):
        for form in ("cov", "sqrt"):
            tag = f"anchor physics ac {form}"
            m = ac.build(*ac_in, ac.FULL["n_mc"], f64, form == "sqrt", "cuda")
            elbos = [float(m.step_with_elbo(0.3, hessian="gauss_newton", draws=dev(d))[1])
                     for d in g["ac_draws"]]
            _hold_cvi(tag, m, elbos, g, f"ac_{form}", AC_TOL)
        m = nonlinear_ode_cvi_gp(
            g["pend_t_data"], g["pend_y_data"], g["pend_t_coll"],
            lambda f: f[..., 2] + 0.3 * f[..., 1] + 9.0 * torch.sin(f[..., 0]), n_heads=3,
            kernel=Matern72(1.0, 1.0, dtype=f64, device="cuda"), noise=0.03**2, coll_noise=1e-4,
            n_mc=16, device="cuda")
        elbos = [float(m.step_with_elbo(0.3, hessian="gauss_newton", draws=dev(d))[1])
                 for d in g["pend_draws"]]
        _hold_cvi("anchor physics pendulum", m, elbos, g, "pend")
        m = monotonic_cvi_gp(g["mono_t_data"], g["mono_y_data"], g["mono_t_coll"], noise=0.15**2,
                             device="cuda")
        elbos = [float(m.step_with_elbo(0.5)[1]) for _ in range(3)]
        _hold_cvi("anchor physics monotonic", m, elbos, g, "mono")
        m = ode_gp(g["ode_t_data"], g["ode_y_data"], g["ode_t_coll"], [4.0, 0.4, 1.0],
                   kernel=Matern72(1.5, 1.0, dtype=f64, device="cuda"), noise=0.05**2, coll_noise=1e-6,
                   device="cuda")
        with torch.no_grad():
            lml = float(m.log_marginal_likelihood())
            f = m.predict_f(dev(g["ode_t_test"]))
        _hold_elbos("anchor physics ode_gp", [lml], np.asarray([g["ode_lml"]]))
        _hold("anchor physics ode_gp", {"predict_f mean": (f.mean, g["ode_f_mean"]),
                                        "predict_f var": (f.var, g["ode_f_var"])}, 1e-7)
        m = ac.build(*ac_in, ac.FULL["n_mc"], f64, False, "cuda")
        m.sites = Sites(dev(g["ac_trained_sites_Y"]), dev(g["ac_trained_sites_V"]))
        post = m.posterior()
        _hold("hardware gate f64", {"posterior mean": (post.mean, g["ac_trained_f64_mean"]),
                                    "posterior var": (post.var, g["ac_trained_f64_var"])}, 1e-7)
    with _kzz_jitter("1e-4"):
        f32 = torch.float32
        m = ac.build(*ac_in, ac.FULL["n_mc"], f32, True, "cuda")
        m.sites = Sites(dev(g["ac_trained_sites_Y"], f32), dev(g["ac_trained_sites_V"], f32))
        mean = m.posterior().mean.double().cpu().numpy()
    later, Ns = ac.extrapolation_rows(g["ac_t"]), g["ac_Z"].shape[0]
    dm = float(np.max(np.abs(mean[later][:, :Ns] - g["ac_trained_f32_mean"][later][:, :Ns])))
    dm_all = float(np.max(np.abs(mean - g["ac_trained_f32_mean"])))
    print(f"[hardware gate f32] sequential square-root posterior from the JAX-trained sites: "
          f"max |Δmean| {dm:.3e} on the grid heads over the extrapolation window (tol "
          f"{ac.TOL_HARDWARE}), {dm_all:.3e} over every head and step")
    if not dm < ac.TOL_HARDWARE:
        raise AssertionError("hardware gate: the float32 posterior disagrees with the JAX CPU one")


def phase_physics_full():
    """Allen-Cahn at the experiment's full width, float32, sequential
    square-root (its accelerator arm): 20 Gauss-Newton natural-gradient
    iterations at lr 0.3, fresh draws from one seeded generator each
    iteration, then `nlpd` on the extrapolation window (truth at the grid
    heads). Launch counters are reset just before the iterations and read
    after them and after `nlpd`; the path must take the block routes of
    PHYSICS_BLOCK_ROUTES. Prints each iteration's wall time, peak memory
    and the device's busy share over one more, profiled, iteration."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    ac = _allen_cahn()
    cfg, f32 = ac.FULL, torch.float32
    t, Y, Z, coll, F = ac.inputs(cfg["T"], cfg["Ns"], cfg["Nc"])
    with _kzz_jitter(None):
        model = ac.build(t, Y, Z, coll, cfg["n_mc"], f32, True, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        walls, elbos = [], []
        for _ in range(PHYSICS_ITERS):
            t0 = time.perf_counter()
            model, elbo = model.step_with_elbo(ac.LR, hessian="gauss_newton", generator=gen)
            elbos.append(float(elbo))
            walls.append(time.perf_counter() - t0)
        train_counts = kernels.launch_counts()
        later = ac.extrapolation_rows(t)
        y_nlpd = np.full((int(later.sum()), cfg["Ns"] + 2 * cfg["Nc"]), np.nan)
        y_nlpd[:, :cfg["Ns"]] = F[later]
        t0 = time.perf_counter()
        nlpd = float(model.nlpd(torch.as_tensor(t[later], dtype=f32, device="cuda"),
                                torch.as_tensor(y_nlpd, dtype=f32, device="cuda")))
        wall_nlpd = time.perf_counter() - t0
        counts, routes = kernels.launch_counts(), kernels.route_counts()
        peak = _peak()
        post = model.posterior()
        wall_prof, dev_us, ours = _profiled(
            lambda: model.step_with_elbo(ac.LR, hessian="gauss_newton", generator=gen))
    finite = bool(np.all(np.isfinite(elbos)) and torch.isfinite(post.mean).all()
                  and torch.isfinite(post.var).all() and np.isfinite(nlpd))
    rmse = float(np.sqrt(np.mean((post.mean[:, :cfg["Ns"]].double().cpu().numpy()[later] - F[later]) ** 2)))
    print(f"[full physics ac] T={cfg['T']} Ns={cfg['Ns']} Nc={cfg['Nc']} n_mc={cfg['n_mc']} "
          f"(state d = {3 * cfg['Ns']}, p = {cfg['Ns'] + 2 * cfg['Nc']}), float32 sequential square-root")
    print(f"[full physics ac] ELBOs {elbos}")
    print(f"[full physics ac] iteration wall s {[round(w, 4) for w in walls]}; median after the first "
          f"{float(np.median(walls[1:])):.4f} s; nlpd {nlpd!r} in {wall_nlpd:.4f} s; peak {peak:.3f} GiB; "
          f"extrapolation RMSE after {PHYSICS_ITERS} iterations {rmse:.4f}; finite {finite}")
    _print_profile("full physics ac", "profiled iteration", wall_prof, dev_us, ours)
    print(f"[full physics ac] launches per iteration: "
          f"{ {k: v / PHYSICS_ITERS for k, v in train_counts.items()} }")
    if not finite:
        raise AssertionError("full physics ac: a non-finite ELBO, posterior or nlpd")
    _path_check_physics(PHYSICS_PATH, counts, routes)
    return {PHYSICS_PATH: counts}, {PHYSICS_PATH: routes}


def _profiled(fn):
    """(wall s, device busy us, {hand-written kernel: (us, launches)}) of one
    call of fn under `torch.profiler`, ending in a synchronise."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {}
    for e in events:
        m = re.match(r"void \(anonymous namespace\)::(\w+_kernel<[^(]*>)\(", e.key)
        if m:
            us, n = ours.get(m.group(1), (0.0, 0))
            ours[m.group(1)] = (us + e.self_device_time_total, n + e.count)
    return wall, sum(e.self_device_time_total for e in events), ours


def _print_profile(tag, what, wall, dev_us, ours):
    ours_us = sum(us for us, _ in ours.values())
    print(f"[{tag}] {what}: wall {wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / 1e3 / (wall * 1e3):.1f} % of wall): hand-written kernels "
          f"{ours_us / 1e3:.2f} ms, PyTorch's own {(dev_us - ours_us) / 1e3:.2f} ms")
    for name, (us, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}] {what}: {name} {us / 1e3:.3f} ms in {n} launches")


def _path_check_physics(tag, counts, routes):
    """Every kernel of the path launched, each block route it must take
    taken, no fused combine."""
    print(f"[{tag}] launches: {counts}")
    print(f"[{tag}] launches by route: {routes}")
    if not all(counts[k] > 0 for k in PHYSICS_KERNELS):
        raise AssertionError(f"{tag}: a kernel of the path was never launched")
    if not all(routes[k]["block"] > 0 for k in PHYSICS_BLOCK_ROUTES):
        raise AssertionError(f"{tag}: a block route the path takes was never taken")
    if any(counts[k] for k in FUSED):
        raise AssertionError(f"{tag}: a fused combine ran with its knob unset")
    print(f"[{tag}] block routes taken: { {k: routes[k]['block'] for k in PHYSICS_BLOCK_ROUTES} }")


# ---------------------------------------------------------------------------
# The scattered-sensor and vector-field paths: sparse and scattered ST,
# Helmholtz, magnetic field, state-space LMC (slice 5d's vector-field part)
# ---------------------------------------------------------------------------

# Phase B: the scattered experiment's field, noise, kernels and 12 inducing
# sites at its sampling density (25 times per unit) over 100 000 times
SCATTERED_T, SCATTERED_END, SCATTERED_CHUNK = 100_000, 4000.0, 25_000
# every kernel each form launches: the Kzz factor takes `chol` in both
# (the square-root lml reads its log-determinant off the LQ factor: no
# solve + logdet)
SCATTERED_KERNELS = {"cov": ("bmm", "gj_solve", "gj_solve_logdet", "chol"),
                     "sqrt": ("bmm", "gj_solve", "lq", "chol", "chol_gram")}
# float32 against float64 lml, relative, either form: 3.6 x the larger of
# the readings it was set from (covariance 8.68e-5, square-root 1.37e-4 on
# one H100; PERF.md, section 6)
SCATTERED_LML_GAP = 5e-4
# The kernels' operand shapes on that path (state d = 24, p = Ng = 4 rows a
# step, Kzz [12, 12]), as `launch_census.py --model scattered --T 100000
# --chunk 25000 --blocks 256 [--sqrt]` lists them. Batches: 128, 256, 512
# (the blocked scan's sequential pass and levels), a chunk, a chunk padded to
# 256 blocks of 98, the 93 690 training times padded to four chunks, and 1.
SC_D, SC_P, SC_KZZ = 24, 4, 12
SC_CHUNK_PAD, SC_T_PAD = 25_088, 100_000
# bmm: (batch, A's [rows, cols], B's [rows, cols], ta, tb); a dimension of
# size SC_P is a step's rows, masked as the filter masks them
SC_BMM = (
    [(N, (24, 24), (24, 24), ta, tb) for N in (128, 256) for ta in (0, 1) for tb in (0, 1)]
    + [(SCATTERED_CHUNK, a, b, ta, tb) for a, b, ta, tb in [
        ((24, 24), (24, 24), 0, 0), ((24, 24), (24, 24), 1, 0), ((4, 24), (4, 24), 1, 0),
        ((4, 24), (24, 24), 0, 0), ((4, 24), (4, 24), 0, 1), ((24, 24), (4, 24), 0, 1),
        ((24, 4), (4, 24), 0, 0), ((24, 4), (4, 4), 0, 0), ((24, 24), (4, 24), 1, 1)]]
    + [(SC_CHUNK_PAD, (24, 24), (24, 24), ta, tb) for ta, tb in ((0, 0), (0, 1), (1, 0))]
    + [(SC_T_PAD, a, b, ta, tb) for a, b, ta, tb in [
        ((24, 24), (24, 24), 0, 0), ((24, 24), (24, 24), 0, 1), ((24, 24), (24, 24), 1, 0),
        ((4, 24), (24, 24), 0, 0), ((4, 24), (4, 24), 0, 1)]]
)
# solves: (batch, d, r); d = 4 is a step's masked innovation covariance S
SC_SOLVE = [(128, 24, 24), (256, 24, 24), (256, 24, 48), (512, 24, 48), (SCATTERED_CHUNK, 4, 49),
            (SCATTERED_CHUNK, 4, 53), (SC_CHUNK_PAD, 24, 24), (SC_CHUNK_PAD, 24, 25),
            (SC_T_PAD, 24, 24), (SC_T_PAD, 4, 1)]
SC_SOLVE_LOGDET = [(SC_T_PAD, 4, 1)]
SC_CHOL = [(1, SC_KZZ), (1, 24), (SC_T_PAD, 24), (SC_T_PAD, 4)]
SC_CHOL_GRAM = [(128, 24), (256, 24), (SCATTERED_CHUNK, 4), (SC_CHUNK_PAD, 24), (SC_T_PAD, 24)]  # (batch, Y's cols)
SC_LQ = [(128, 24, 48), (256, 24, 48), (512, 24, 48), (1, 24, 48), (SCATTERED_CHUNK, 4, 28),
         (SCATTERED_CHUNK, 24, 24), (SC_CHUNK_PAD, 24, 48), (SC_T_PAD, 4, 28)]


def _vector_field():
    """scripts/port/vector_field_outcome.py: the inputs, models, anchors and
    outcome gates of these paths."""
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import vector_field_outcome

    return vector_field_outcome


def _check_subnormal_tails():
    """Both LQ kernels on a row whose Householder tail has a subnormal vᵀv
    (it reflects nothing; 2 / vᵀv would overflow and turn the rows below
    NaN): the scattered square-root scans reach such tails in their
    rank-deficient information factors. L Lᵀ against B Bᵀ and against the
    plain version's."""
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq

    rng = np.random.default_rng(0)
    for dtype, tiny in ((torch.float64, 1e-160), (torch.float32, 1e-20)):
        for d, m in ((24, 48), (40, 50)):
            B = rng.normal(size=(3, d, m))
            B[:, 0] = 0.0
            B[:, 0, 0] = 2.0
            B[:, 1, 1:] = tiny * rng.normal(size=(3, m - 1))
            B = torch.as_tensor(B, dtype=dtype, device="cuda")
            L, Lp = bq.batch_tria(B), bq.tria_plain(B)
            gram = B @ B.transpose(-1, -2)
            err = float((L @ L.transpose(-1, -2) - gram).abs().max() / gram.abs().max())
            err_plain = _rel(L @ L.transpose(-1, -2), Lp @ Lp.transpose(-1, -2))[0]
            ok = bool(torch.isfinite(L).all()) and max(err, err_plain) <= TOL[dtype]["factor"]
            print(f"[kernels lq subnormal tail] {str(dtype)[6:]} [3, {d}, {m}] finite "
                  f"{bool(torch.isfinite(L).all())}, L Lᵀ rel err {err:.2e} (against B Bᵀ), "
                  f"{err_plain:.2e} (against the plain version)")
            if not ok:
                raise AssertionError("lq: a subnormal Householder tail broke the factor")


def _check_scattered_shapes(gen, dtype, report):
    """The kernels at the scattered path's shapes (the SC_* tables), each
    against its plain version at TOL: the products, the solves (L and the
    log-determinant), the Choleskys and the LQ (L and L Lᵀ). Operands at the
    scan's batches (<= 512) are strided views of [N, 3, ...], as the blocked
    scan's sequential pass hands them over; a step's p = 4 rows carry the
    filler rows of a step with 1-3 sensors as the filter builds them: zero
    rows of H, a unit diagonal in S (`mask_covariance`), a unit noise entry
    in the LQ's [H, R^1/2] pre-array. Every launch must take the warp
    kernel."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import build
    from physs_gp_tpu_torch.ops.gaussian import mask_covariance

    p = SC_P

    def view(x):
        """x as the scan hands it over at its batches: x[:, 1] of [N, 3, ...]."""
        if x.shape[0] > 512:
            return x
        y = torch.zeros((x.shape[0], 3) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        y[:, 1] = x
        return y[:, 1]

    def observed(N):
        """[N, p]: 1 for a step's sensors (1-4 of them), 0 for its filler rows."""
        k = torch.randint(1, p + 1, (N, 1), generator=gen, device="cuda")
        return (torch.arange(p, device="cuda") < k).to(torch.float64)

    def operand(N, shape, obs):
        x = _randn(gen, N, *shape)
        if shape[0] == p:
            x = x * obs[:, :, None]
        if shape[1] == p:
            x = x * obs[:, None, :]
        return view(x.to(dtype))

    def matrix(N, d):
        """An SPD system at d = 24 (the scan's I + C J at the scan's batches),
        the masked S at d = p."""
        if d == p:
            return mask_covariance(_spd(gen, N, p, torch.float64), observed(N)).to(dtype)
        return view(_icj(gen, N, d, dtype) if N <= 512 else _spd(gen, N, d, dtype))

    def factor(name, L, Lp, label):
        if not torch.isfinite(L).all():
            raise AssertionError(f"{name} {label} (scattered): non-finite factor")
        report(name, "factor", *_rel(L, Lp), dtype, f"{label} L (scattered)")
        report(name, "factor", *_rel(L @ L.mT, Lp @ Lp.mT), dtype, f"{label} L L^T (scattered)")

    build.reset_launch_counts()
    for N, a, b, ta, tb in SC_BMM:
        obs = observed(N)
        A, B = operand(N, a, obs), operand(N, b, obs)
        report("bmm", "bmm", *_rel(bl.batch_bmm(A, B, bool(ta), bool(tb)), bl.bmm_plain(A, B, bool(ta), bool(tb))),
               dtype, f"[{N},{a[0]},{a[1]}]{'^T' * ta} x [{N},{b[0]},{b[1]}]{'^T' * tb} (scattered)")
    for name, cases in (("gj_solve", SC_SOLVE), ("gj_solve_logdet", SC_SOLVE_LOGDET)):
        for N, d, r in cases:
            M, R = matrix(N, d), view(_randn(gen, N, d, r).to(dtype))
            label = f"[{N},{d},{d}] r={r}"
            if name == "gj_solve":
                report(name, "solve", *_rel(bl.batch_solve(M, R), bl.gj_solve_plain(M, R)), dtype,
                       f"{label} (scattered)")
                continue
            (X, ld), (Xp, ldp) = bl.batch_solve_logdet(M, R), bl.gj_solve_logdet_plain(M, R)
            report(name, "solve", *_rel(X, Xp), dtype, f"{label} X (scattered)")
            report(name, "logdet", *_rel(ld, ldp), dtype, f"{label} logdet (scattered)")
    for N, d in SC_CHOL:
        A = matrix(N, d) if d == p else _spd(gen, N, d, dtype)
        factor("chol", bc.batch_cholesky(A), bc.cholesky_plain(A), f"[{N},{d},{d}]")
    for N, my in SC_CHOL_GRAM:
        d = SC_D
        # a predicted covariance's factor beside a step's masked rows (my = p),
        # or two [d, d] factors of the scan's combine
        X = view(torch.linalg.cholesky(_spd(gen, N, d, torch.float64)).to(dtype).contiguous()) if my == p \
            else operand(N, (d, d), None)
        Y = operand(N, (d, my), observed(N))
        factor("chol_gram", bc.batch_chol_gram(X, Y), bc.chol_gram_plain(X, Y), f"[{N},{d},{d}]+[{N},{d},{my}]")
    for N, d, m in SC_LQ:
        if d == p:  # [H P^1/2 | R^1/2] with a filler row's unit noise
            obs = observed(N)
            B = torch.cat([_randn(gen, N, p, m - p) * obs[:, :, None],
                           torch.diag_embed(0.1 * obs + (1.0 - obs))], -1).to(dtype)
        else:
            B = operand(N, (d, m), None)
        factor("lq", bq.batch_tria(B), bq.tria_plain(B), f"[{N},{d},{m}]")
    routes = build.route_counts()
    if any(r["block"] for r in routes.values()):
        raise AssertionError(f"scattered shapes: a block kernel ran: {routes}")
    print(f"[kernels] scattered shapes {str(dtype)[6:]}: launches {build.launch_counts()}, "
          f"all on the warp kernels")


def phase_vector_field_anchor():
    """Phase A, float64 anchors against tests/data/vector_field_golden.npz
    (made by scripts/port/make_vector_field_golden.py from the JAX package
    on the CPU): the scattered experiment's full configuration (200 times,
    516 rows, 12 k-means sites, d = 24, Ng = 4; chunk 64, padded) in
    parallel covariance form, square-root form and with
    PHYSS_FUSED_COMBINE=1 (lml, the posterior through `unsort`,
    `scattered_st_predict` at the 120 held-out rows); `sparse_st_gp` (lml
    and its gradient by every raw, Z among them); Helmholtz at the quick
    configuration (T = 16, Ns = 25, D = 100; lml and `helmholtz_st_predict`
    in sequential covariance and square-root form, one CVI step's ELBO and
    prediction); the magnetic field with and without the potential block,
    sequential and parallel; `lmc_markov_gp` (lml, two Poisson CVI steps'
    ELBOs). lml, ELBO, means and gradients rtol 1e-9, variances 1e-7. The
    fused anchor must launch the fused combines (d = 24 is eligible)."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    vf = _vector_field()
    _check_subnormal_tails()
    kernels.reset_launch_counts()
    with _kzz_jitter(None):
        res = vf.anchors(np.load(vf.GOLDEN), "cuda")
    counts, routes = kernels.launch_counts(), kernels.route_counts()
    for name, outs in res.items():
        for key, (got, want, tol) in outs.items():
            r = vf.relerr(got, want)
            print(f"[anchor {name}] {key} max rel {r:.3e} (tol {tol:g})")
            if not (got.shape == want.shape and np.all(np.isfinite(got)) and r <= tol):
                raise AssertionError(f"anchor {name}: {key} disagrees with the JAX reference")
    print(f"[anchor vector field] launches: {counts}; routes: {routes}")
    if not all(counts[k] > 0 for k in FUSED):
        raise AssertionError("anchor scattered fused: the fused combines never ran")
    # the Helmholtz square-root anchor's [100, 200] pre-arrays exceed `lq_fits`
    if not routes.get("lq", {}).get("library"):
        raise AssertionError("anchor Helmholtz square-root: no tria took the library QR")


def phase_scattered_full():
    """Phase B, the scattered model at full length, float32: the
    experiment's field, noise, kernels and 12 inducing sites at its sampling
    density over SCATTERED_T times (1-4 sensors each, about 250 000 rows, 20 %
    held out), parallel scans at chunk 25 000, covariance and square-root
    form: the wall time of `log_marginal_likelihood`, `posterior` and
    `scattered_st_predict` at the held-out rows, peak memory, and the
    launches by kernel and route (counters reset just before the three calls
    and read just after; every kernel of the form launched, no block
    route), and one more `posterior` under `torch.profiler` (device busy
    share, device time by kernel). Then the float64 covariance lml beside
    the float32 one
    (PHYSS_KZZ_JITTER=1e-4 on both), and the outcome gates of both
    experiments (`vector_field_outcome.outcome`: the drivers' `run` and
    `gates`)."""
    from experiments_torch import helmholtz as hz
    from experiments_torch import scattered_st as sc
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.zoo.spatio_temporal import scattered_st_predict

    vf = _vector_field()
    Z = np.load(vf.GOLDEN)["sc::in::Z"]
    train, test = vf.scattered_rows_long(SCATTERED_T, SCATTERED_END)
    counts, routes, lml = {}, {}, {}
    with _kzz_jitter("1e-4"):
        for form in ("cov", "sqrt"):
            tag = f"scattered {form} f32"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, data = sc.build(train, Z, torch.float32, "cuda", sqrt=form == "sqrt",
                                             chunk_size=SCATTERED_CHUNK)
            torch.cuda.synchronize()
            walls, out = {"build": time.perf_counter() - t0}, {}
            kernels.reset_launch_counts()
            with torch.no_grad():
                for part, run in (("lml", model.log_marginal_likelihood), ("posterior", model.posterior),
                                  ("predict", lambda: scattered_st_predict(model, data, test[:, :3]))):
                    t0 = time.perf_counter()
                    out[part] = run()
                    torch.cuda.synchronize()
                    walls[part] = time.perf_counter() - t0
            counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
            post, pred = out["posterior"], out["predict"]
            lml[form] = float(out["lml"])
            finite = bool(np.isfinite(lml[form]) and all(torch.isfinite(x).all() for x in (*post, *pred)))
            shapes = post.mean.shape == (data.Nt, data.Ng) and pred.mean.shape == (test.shape[0], 1)
            rmse = vf.rmse(vf.numpy(pred.mean)[:, 0], test[:, 3])
            if form == "cov":
                print(f"[full scattered] T = {data.Nt} times, {train.shape[0]} training rows, "
                      f"{test.shape[0]} held out, Ng = {data.Ng}, d = {model.kernel.state_dim}, "
                      f"chunk {SCATTERED_CHUNK}")
            print(f"[full {tag}] lml {lml[form]!r}; wall s: build {walls['build']:.4f}, lml "
                  f"{walls['lml']:.4f}, posterior {walls['posterior']:.4f}, scattered_st_predict "
                  f"{walls['predict']:.4f}; peak {_peak():.3f} GiB; held-out RMSE {rmse:.4f}; "
                  f"finite {finite}")
            if not (finite and shapes):
                raise AssertionError(f"full {tag}: a non-finite or misshapen result")
            _path_check(f"full {tag}", counts[tag], routes[tag], SCATTERED_KERNELS[form])
            with torch.no_grad():
                _print_profile(f"full {tag}", "profiled posterior",
                               *_profiled(lambda: model.posterior()))
            del model, data, out, post, pred
        torch.cuda.empty_cache()
        model, _ = sc.build(train, Z, torch.float64, "cuda", chunk_size=SCATTERED_CHUNK)
        t0 = time.perf_counter()
        with torch.no_grad():
            lml64 = float(model.log_marginal_likelihood())
        wall = time.perf_counter() - t0
        del model
    gaps = {form: abs(v - lml64) / abs(lml64) for form, v in lml.items()}
    print(f"[full scattered] float64 covariance lml {lml64!r} ({wall:.4f} s); float32 rel gap: "
          f"covariance {gaps['cov']:.3e}, square-root {gaps['sqrt']:.3e} (limit {SCATTERED_LML_GAP:g})")
    if not np.isfinite(lml64):
        raise AssertionError("full scattered: non-finite float64 lml")
    if not all(g <= SCATTERED_LML_GAP for g in gaps.values()):
        raise AssertionError("full scattered: the float32 lml is too far from the float64 one")
    res = vf.outcome("cuda")
    print(f"[outcome vector field] {json.dumps(res)}")
    print(f"[outcome scattered] float32 parallel covariance: rmse_test {res['scattered']['rmse_test']:.5f} "
          f"(JAX CPU float64 {sc.REFERENCE['rmse_test']:.5f}), nlpd_test "
          f"{res['scattered']['nlpd_test']:.5f} ({sc.REFERENCE['nlpd_test']:.5f}); within 5 %: "
          f"{res['scattered']['ok']}")
    print(f"[outcome helmholtz] T = {hz.T_FULL}, float32 sequential: rmse_v_reconstructed "
          f"{res['helmholtz_full']['rmse_v_reconstructed']:.5f} < 0.35 x rms_v_truth "
          f"{res['helmholtz_full']['rms_v_truth']:.5f}: {res['helmholtz_full']['ok']}; quick "
          f"configuration {res['helmholtz_quick']} beside {vf.HZ_RESULTS}; {res['seconds']:.1f} s")
    if not res["ok"]:
        raise AssertionError("outcome gate of the scattered or the Helmholtz experiment failed")
    return counts, routes


# ---------------------------------------------------------------------------
# The batch (dense) GP family: BatchGP (Cholesky and CG), SVGP, the
# curl-free / Helmholtz / derivative recipes, the batch LMC
# ---------------------------------------------------------------------------

BATCH_PATH = "batch anchors f64"
BATCH_CHOL_N = (10, 24, 60, 80)  # the batch family's 2-D factors on the Cholesky kernel


def _batch():
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import batch_outcome

    return batch_outcome


def phase_batch_anchor():
    """Float64 anchors against tests/data/batch_golden.npz (made by
    scripts/port/make_batch_golden.py from the JAX package on the CPU):
    `curl_free_gp` and `helmholtz_gp` at N = 40, `deriv_gp` with NaNs and
    joint samples, `BatchGP(solver="cg")` fed the JAX probes, SVGP whitened
    and unwhitened with one natural-gradient step at lr 1, the monotonic
    batch-VI arm (`deriv_vgp`, Z = 30, M·P = 60) after 5 steps at lr 0.5,
    and a batch LMC with a constant mean: lml, gradients, ELBOs and
    predictions rtol 1e-9, CG 1e-8. Counters are reset before each
    configuration and read after it; each must take the Cholesky kernel's
    routes of `batch_outcome.CHOL_ROUTES` (its factors of n <= 80: the warp
    kernel at M = 10 and the joint covariance of 24, the block kernel at
    60-80). Returns the summed (counts, routes) under BATCH_PATH."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    bo = _batch()
    gold = np.load(bo.GOLDEN)
    total = {k: 0 for k in SOURCES}
    chol = {"warp": 0, "block": 0}
    for cfg in bo.CONFIGS:
        kernels.reset_launch_counts()
        res = bo.anchor(gold, cfg, "cuda")
        counts, routes = kernels.launch_counts(), kernels.route_counts()
        for key, (got, want, tol) in res.items():
            r = bo.relerr(got, want)
            print(f"[anchor batch {cfg}] {key} max rel {r:.3e} (tol {tol:g})")
            if not (np.all(np.isfinite(got)) and r <= tol):
                raise AssertionError(f"anchor batch {cfg}: {key} disagrees with the JAX reference")
        cr = routes.get("chol", {})
        print(f"[anchor batch {cfg}] chol launches {counts['chol']}, routes {cr}; other launches "
              f"{ {k: v for k, v in counts.items() if v and k != 'chol'} }")
        if not all(cr.get(r) for r in bo.CHOL_ROUTES[cfg]):
            raise AssertionError(f"anchor batch {cfg}: the chol kernel did not take its "
                                 f"{bo.CHOL_ROUTES[cfg]} route")
        for k, v in counts.items():
            total[k] += v
        for r in chol:
            chol[r] += cr.get(r, 0)
    print(f"[anchor batch] launches {total}; chol routes {chol}")
    return {BATCH_PATH: total}, {BATCH_PATH: {"chol": chol}}


def phase_batch_full():
    """The batch family at full size. The curl-free experiment (120
    training, 200 test points, float32) against its independent-RBF
    baseline; the monotonic batch-VI arm (float64, Z = 50, M·P = 100, 300
    natural-gradient steps at lr 0.5): no violation, the ELBO within 1e-4
    and `rmse_gap_vgp` within 10 % of each JAX float64 run in the golden
    file that has locked into its limit cycle (`batch_outcome.locked_runs`;
    results/monotonic.json's run has not); `BatchGP` with RBF at n = 2048,
    4096, 8192 (scripts/profile/bench_cg.py's model, float32): the lml and
    the lml with its gradient by Cholesky and by CG (wall, peak, the CG
    steps run), CG's lml within DENSE_GAP of Cholesky's; the SLQ's batched
    `eigh` of [32, 48, 48] timed on the card; a curl-free Gram at N = 4096
    ([8192, 8192]): its build's wall and peak, then the lml and its
    gradient. Each run's launches are read, reset just before it; none of
    these factors is small enough for the Cholesky kernel."""
    from experiments_torch import curl_free
    from physs_gp_tpu_torch.ops import cuda as kernels

    bo = _batch()
    counts, routes = {}, {}

    def run(tag, fn):
        kernels.reset_launch_counts()
        out = fn()
        counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
        print(f"[full batch {tag}] chol launches {counts[tag]['chol']}, routes {routes[tag]}")
        return out

    cf, cf_s = run("curl_free f32", lambda: curl_free.run("cuda", torch.float32))
    cf_ok = all(curl_free.gates(cf).values())
    print(f"[outcome curl_free] float32, 120 / 200 points: rmse {cf['rmse']:.5f} against the "
          f"independent-RBF baseline's {cf['rmse_independent_gp']:.5f} (JAX CPU quick: "
          f"{bo.CF_RESULTS}); nlpd {cf['nlpd']:.5f}; {cf_s:.2f} s; ok {cf_ok}")
    mv = run("monotonic vgp f64", lambda: bo.monotonic_outcome("cuda"))
    print(f"[outcome monotonic vgp] float64, M·P = {mv['M']}, {mv['steps']} steps: rmse_gap_vgp "
          f"{mv['rmse_gap_vgp']:.5f}, ELBO {mv['elbo']:.5f}, violation rate "
          f"{mv['deriv_violation_rate_vgp']}; the JAX package's float64 runs (q_mu's start moved by "
          f"{bo.MV_PERTURB}): rmse_gap_vgp {mv['jax_rmse_gap_vgp']}, ELBO {mv['jax_elbo']}, locked "
          f"{mv['jax_locked']} (the first is results/monotonic.json's "
          f"{bo.MV_RESULTS['rmse_gap_vgp']:.5f}); "
          f"{mv['seconds']:.2f} s ({1e3 * mv['seconds'] / mv['steps']:.2f} ms a step); ok {mv['ok']}")
    if not (cf_ok and mv["ok"]):
        raise AssertionError("outcome gate of the curl-free or the monotonic batch-VI arm failed")
    rows = run("dense scale f32", lambda: bo.dense_scale("cuda"))
    for row in rows:
        print(f"[full batch dense] {json.dumps(row)}")
        if not (row["cholesky_finite"] and row["cg_finite"] and row["lml_rel_gap"] <= bo.DENSE_GAP):
            raise AssertionError(f"dense n = {row['n']}: non-finite, or CG's lml more than "
                                 f"{bo.DENSE_GAP:g} from Cholesky's")
    T = torch.randn(32, 48, 48, device="cuda")
    T = T + T.transpose(-1, -2)
    us = {}
    for where, A in (("card", T), ("host", T.cpu())):
        torch.linalg.eigh(A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            torch.linalg.eigh(A)
        torch.cuda.synchronize()
        us[where] = (time.perf_counter() - t0) / 50 * 1e6
    print(f"[full batch dense] SLQ tridiagonal eigh [32, 48, 48] float32, wall a call: card "
          f"{us['card']:.1f} us, host CPU {us['host']:.1f} us")
    gram = run("curl_free gram f32", lambda: bo.curl_free_gram("cuda"))
    print(f"[full batch curl_free gram] {json.dumps(gram)}")
    if not gram["finite"]:
        raise AssertionError("curl-free Gram at N = 4096: a non-finite lml or gradient")
    return counts, routes


# ---------------------------------------------------------------------------
# The nonlinear-dynamics and volatility path: EKF / EKS and the iterated
# parallel EKS (NonlinearSSGP), the dynamics zoo, DynamicCovarianceGaussian,
# HetGaussian, CorrelationMixing, the L-BFGS trainers
# ---------------------------------------------------------------------------

DYNAMICS_PATH = "dynamics anchors f64"
# the runs that must reach the product and solve kernels (d = 3, 20, config-5)
DYNAMICS_KERNEL_PATHS = ("lorenz ieks T=20000 f32", "lorenz ieks T=20000 f64",
                         "dynamic covariance P=5 f64", "config5 vb_ng_lbfgs f32")


def _dynamics():
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import dynamics_outcome

    return dynamics_outcome


def _hold_anchor(tag, res):
    do = _dynamics()
    for key, (got, want, tol) in res.items():
        r = do.relerr(got, want)
        print(f"[anchor dynamics {tag}] {key} max rel {r:.3e} (tol {tol:g})")
        if not (np.all(np.isfinite(got)) and r <= tol):
            raise AssertionError(f"anchor dynamics {tag}: {key} disagrees with the JAX reference")


def phase_dynamics_anchor():
    """Float64 anchors against tests/data/dynamics_golden.npz (made by
    scripts/port/make_dynamics_golden.py from the JAX package on the CPU),
    blocked scans of 8 blocks as there: the pendulum `NonlinearSSGP` at
    T = 256 (EKF / EKS moments and lml, the EKF lml's gradient by the
    damping, 8 iterated parallel EKS passes on the flat d = 2 combines
    without grad mode: the CPU tests hold their gradient), `lorenz_gp`
    at T = 256 (sequential, whose smoother factors each [3, 3] predicted
    covariance on the `chol` kernel, and 8 parallel passes on `bmm` and the
    solves; the parallel passes alone again with PHYSS_FUSED_COMBINE=1,
    which must launch the fused combines), `lotka_volterra_gp` and
    `latent_force_gp` (T = 128), `euler_maruyama_sample_given` on the
    replayed JAX draws, `correlation_cholesky`, a `BatchGP` over
    `LMC.init_drd`, `HetGaussian`'s ELLs, `dynamic_covariance_gp` (P = 2,
    T = 64, 5 Gauss-Newton steps on the two JAX draw sets): rtol 1e-9;
    `LBFGSTrainer` (10 iterations on `_model()`), `VB_NG_LBFGS` (3 epochs on
    the Poisson CVIGP, 2 on config-5 at T = 256): rtol 1e-8. Counters are
    reset before each configuration. Returns {DYNAMICS_PATH: the summed
    launches}."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    do = _dynamics()
    gold = np.load(do.GOLDEN)
    total = {k: 0 for k in SOURCES}
    # the pendulum in two parts, its iterated smoother without grad mode
    for cfg in ("pend::ekf", "pend::ieks") + tuple(c for c in do.CONFIGS if c != "pend"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = do.anchors(gold, "cuda", (cfg,))[cfg]
        counts = kernels.launch_counts()
        _hold_anchor(cfg, res)
        print(f"[anchor dynamics {cfg}] {time.perf_counter() - t0:.2f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if cfg == "lorenz" and not (counts["bmm"] and counts["gj_solve"] and counts["chol"]):
            raise AssertionError(f"anchor dynamics lorenz: no bmm, gj_solve or chol launch: {counts}")
        for k, v in counts.items():
            total[k] += v
    kernels.reset_launch_counts()
    os.environ["PHYSS_FUSED_COMBINE"] = "1"
    try:
        res = do.anchors(gold, "cuda", ("lorenz::ieks",))["lorenz::ieks"]
    finally:
        del os.environ["PHYSS_FUSED_COMBINE"]
    counts = kernels.launch_counts()
    _hold_anchor("lorenz knob on", res)
    print(f"[anchor dynamics lorenz knob on] launches { {k: v for k, v in counts.items() if v} }")
    if not (counts["fused_filter"] and counts["fused_smooth"]):
        raise AssertionError("anchor dynamics lorenz knob on: the fused combines did not run")
    for k, v in counts.items():
        total[k] += v
    print(f"[anchor dynamics] launches {total}")
    return {DYNAMICS_PATH: total}


def phase_dynamics_full():
    """The JAX tests' outcome gates on their own data, float64 (the recipes'
    default), each figure beside the JAX package's on the same data
    (golden file): Lotka-Volterra (T = 500) state RMSE < 0.2, Lorenz
    (T = 2000) hidden y and z correlations > 0.95 by the sequential EKS and
    by the iterated parallel EKS, the latent force (T = 400) correlation
    > 0.95, the dynamic-correlation path (P = 2, T = 200, 150 steps, the
    parallel scans) corr > 0.9 and RMSE < 0.25. Then at length: `lorenz_gp`
    at T = 20 000 (dt 0.0002: over 40 time units the iterated smoother
    diverges in both packages, ROADMAP queue 3 item 14; chunk 5000, 5
    passes) in float32 and float64 (wall split into the first propagation
    and the passes, peak, the largest change of the smoothed means between
    the last two passes; the lml must be finite);
    `dynamic_covariance_gp` at P = 5 (d = 20) over T = 2520, parallel, 20
    steps (wall per step, peak; the ELBO must stay finite); `VB_NG_LBFGS` on
    config-5 at T = 100 000 (chunk 25 000), float32, 2 epochs of its
    `train` (wall per epoch, line-search trials, peak; finite, and the last loss
    no higher than the first). Counters are reset just before each run and
    read just after; the runs of DYNAMICS_KERNEL_PATHS must launch `bmm` and
    `gj_solve`. Returns the runs' (counts, routes)."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    do = _dynamics()
    gold = np.load(do.GOLDEN)
    counts, routes = {}, {}

    def run(tag, fn):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
        print(f"[full dynamics {tag}] {wall:.2f} s, launches "
              f"{ {k: v for k, v in counts[tag].items() if v} }, routes {routes[tag]}")
        return out

    for name in do.OUTCOMES:
        res = run(f"outcome {name} f64", lambda: do.outcome("cuda", (name,))[name])
        jax_figs = {k.split("::")[2]: float(gold[k]) for k in gold.files
                    if k.startswith(f"out::{name}::")}
        print(f"[outcome dynamics {name}] {json.dumps(res)}; the JAX package on the same data: "
              f"{json.dumps(jax_figs)}")
        if not res["ok"]:
            raise AssertionError(f"outcome gate of {name} failed: {res}")
    for dtype in (torch.float32, torch.float64):
        tag = f"lorenz ieks T=20000 {str(dtype).split('.')[-1].replace('float', 'f')}"
        res = run(tag, lambda: do.ieks_at_length("cuda", dtype))
        print(f"[full dynamics {tag}] {json.dumps(res)}")
        if not res["finite"]:
            raise AssertionError(f"{tag}: the lml is not finite")
    res = run("dynamic covariance P=5 f64", lambda: do.dynamic_covariance_wide("cuda"))
    print(f"[full dynamics dynamic covariance P=5] {json.dumps(res)}")
    if not res["finite"]:
        raise AssertionError("dynamic covariance at P = 5: a non-finite ELBO")
    res = run("config5 vb_ng_lbfgs f32", lambda: do.config5_vb_ng_lbfgs("cuda"))
    print(f"[full dynamics config5 vb_ng_lbfgs] {json.dumps(res)}")
    if not res["ok"]:
        raise AssertionError(f"config-5 VB_NG_LBFGS: non-finite, or the loss rose: {res['losses']}")
    for tag in DYNAMICS_KERNEL_PATHS:
        if not (counts[tag]["bmm"] and counts[tag]["gj_solve"]):
            raise AssertionError(f"{tag}: launched no bmm or no gj_solve: {counts[tag]}")
    return counts, routes


# ---------------------------------------------------------------------------
# The Markov-kernel zoo and the prior mean: Sum / Product state spaces,
# Periodic, the Wiener family, means in the state-space models, flows,
# uncertain inputs, the misc and aggregated batch kernels
# ---------------------------------------------------------------------------

MARKOV_PATH = "markov anchors f64"
# the kernels each form of the d = 30 model launches
MARKOV_KERNELS = {"cov": ("bmm", "gj_solve", "gj_solve_logdet"),
                  "sqrt": ("lq", "chol_gram", "chol", "bmm", "gj_solve"),
                  "fused": ("fused_filter", "fused_smooth")}
MARKOV_LML_RTOL = 1e-6  # the two float64 forms, as the temporal phase holds its forms
MARKOV_F32_GAP = 1e-2  # float32 against float64, the repo's float32 rule


def _markov():
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import markov_outcome

    return markov_outcome


def _check_markov_shapes(gen, dtype, report):
    """The kernels at the trend + quasi-periodic path's shapes
    (`markov_outcome.kernel_cases`: d = 30, p = 1; the scans' batches 128 /
    256 / 512 as strided views, chunk and series widths; the square-root
    pre-arrays [30, 60]; the noise factors of the model's Q and of the
    bare-Periodic sum's Q, whose Periodic block is exactly zero, through
    `chol`), each against its plain version at TOL. Every launch must take
    the warp kernels."""
    from physs_gp_tpu_torch.ops.cuda import build

    mo = _markov()
    build.reset_launch_counts()
    for name, kind, got, plain, label in mo.kernel_cases(gen, dtype):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label} (markov): non-finite result")
        report(name, kind, *_rel(got, plain), dtype, f"{label} (markov)")
    routes = build.route_counts()
    if any(r["block"] for r in routes.values()):
        raise AssertionError(f"markov shapes: a block kernel ran: {routes}")
    counts = build.launch_counts()
    if not all(counts[k] for k in set(MARKOV_KERNELS["cov"] + MARKOV_KERNELS["sqrt"])):
        raise AssertionError(f"markov shapes: a kernel of the path was not checked: {counts}")
    print(f"[kernels] markov shapes {str(dtype)[6:]}: launches {counts}, all on the warp kernels")


def phase_markov_anchor():
    """Float64 anchors against tests/data/markov_golden.npz (made by
    scripts/port/make_markov_golden.py from the JAX package on the CPU) on
    the blocked scan schedule of 8 blocks: a bare `Periodic`, `Matern32 +
    Periodic` (a zero Q block) and the d = 30 quasi-periodic model with a
    `LinearMean` (its leaves loaded by key path) in covariance and
    square-root form at T = 256 (lml, smoothed and predicted moments, new
    times before, inside and after the data), the four Wiener kinds,
    `StreamingGP` on `WienerVelocity` with a mean, a `ConstantMean`, 3
    Poisson `CVIGP` steps with a mean, every flow, 3 uncertain-input CVI
    steps, `BatchGP` on the misc and aggregated kernels: lml, ELBO and
    means rtol 1e-9, variances 1e-7. Counters are reset before each
    configuration; returns {MARKOV_PATH: the summed launches}."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    mo = _markov()
    gold = np.load(mo.GOLDEN)
    total = {k: 0 for k in SOURCES}
    for cfg in mo.CONFIGS:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = mo.anchors(gold, "cuda", (cfg,))[cfg]
        counts, routes = kernels.launch_counts(), kernels.route_counts()
        worst = max(res, key=lambda k: mo.relerr(*res[k][:2]) / res[k][2])
        for key, (got, want, tol) in res.items():
            r = mo.relerr(got, want)
            if not (np.all(np.isfinite(got) | np.isnan(want)) and r <= tol):
                raise AssertionError(f"anchor markov {cfg}: {key} disagrees with the JAX reference "
                                     f"(rel {r:.3e}, tol {tol:g})")
        print(f"[anchor markov {cfg}] {len(res)} outputs within tolerance, worst {worst} rel "
              f"{mo.relerr(*res[worst][:2]):.3e} (tol {res[worst][2]:g}); "
              f"{time.perf_counter() - t0:.2f} s, launches { {k: v for k, v in counts.items() if v} }")
        if any(r["block"] for r in routes.values()):
            raise AssertionError(f"anchor markov {cfg}: a block kernel ran: {routes}")
        for k, v in counts.items():
            total[k] += v
    print(f"[anchor markov] launches {total}")
    return {MARKOV_PATH: total}


def phase_markov_full():
    """The trend + quasi-periodic model at full length
    (`markov_outcome.full_run`: T = 100 000 hours, 2 % missing, d = 30, a
    `LinearMean`, fitted on the log of the data, chunk 25 000): lml + the
    log-Jacobian correction, `predict_f` at 1000 new times (200 past the
    data) and `to_data_space`, timed, with the peak memory, in covariance
    and square-root form, float32 and float64, and the covariance form
    again with PHYSS_FUSED_COMBINE=1 (float32); then a Poisson `CVIGP` with
    a `ConstantMean` on counts of the same structure, 3 natural-gradient
    steps, float32, covariance form. Counters are reset just before each
    run and read just after; every kernel of the form must launch, each on
    its warp or tiled route. Gates: the float64 forms' lml within rtol
    MARKOV_LML_RTOL, each float32 lml within MARKOV_F32_GAP of its float64
    one. Returns the runs' (counts, routes)."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    mo = _markov()
    counts, routes, lml = {}, {}, {}
    runs = [("cov", torch.float32, False), ("cov", torch.float64, False), ("sqrt", torch.float32, False),
            ("sqrt", torch.float64, False), ("cov", torch.float32, True)]
    for form, dtype, fused in runs:
        tag = f"markov {'cov fused' if fused else form} {str(dtype)[6:].replace('float', 'f')}"
        torch.cuda.empty_cache()
        if fused:
            os.environ["PHYSS_FUSED_COMBINE"] = "1"
        try:
            kernels.reset_launch_counts()
            res = mo.full_run("cuda", dtype, form == "sqrt")
            counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
        finally:
            os.environ.pop("PHYSS_FUSED_COMBINE", None)
        print(f"[full {tag}] {json.dumps(res)}")
        if not (res["finite"] and res["state_dim"] == 30 and res["pred_shape"] == [1000, 1]):
            raise AssertionError(f"{tag}: non-finite or misshapen result: {res}")
        _path_check(f"full {tag}", counts[tag], routes[tag],
                    MARKOV_KERNELS["fused"] if fused else MARKOV_KERNELS[form])
        lml[tag] = res["lml"]
    gap = abs(lml["markov cov f64"] - lml["markov sqrt f64"]) / abs(lml["markov cov f64"])
    print(f"[full markov] float64 lml covariance {lml['markov cov f64']!r}, square-root "
          f"{lml['markov sqrt f64']!r}: rel gap {gap:.3e} (tol {MARKOV_LML_RTOL:g})")
    if not gap <= MARKOV_LML_RTOL:
        raise AssertionError("full markov: the float64 forms disagree on the lml")
    for tag32, tag64 in (("markov cov f32", "markov cov f64"), ("markov cov fused f32", "markov cov f64"),
                         ("markov sqrt f32", "markov sqrt f64")):
        gap = abs(lml[tag32] - lml[tag64]) / abs(lml[tag64])
        print(f"[full markov] {tag32} lml {lml[tag32]!r} against {tag64}: rel gap {gap:.3e} "
              f"(bound {MARKOV_F32_GAP:g})")
        if not gap <= MARKOV_F32_GAP:
            raise AssertionError(f"full markov: {tag32} is more than {MARKOV_F32_GAP} from float64")
    tag = "markov cvi poisson f32"
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    res = mo.cvi_full("cuda")
    counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
    print(f"[full {tag}] {json.dumps(res)}")
    if not res["finite"]:
        raise AssertionError(f"{tag}: a non-finite ELBO")
    _path_check(f"full {tag}", counts[tag], routes[tag], MARKOV_KERNELS["cov"])
    return counts, routes


VECCHIA_PATH = "vecchia anchors f64"
VECCHIA_SOLVE = (100_000, 16, 2)  # Vecchia's conditionals at N = 100 000, m = 16: [N, m, m], r = 2
GPRN_CHOL = 64  # GPRN's inducing Grams at M = 64: the block route of `chol`


def _vecchia():
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import vecchia_outcome

    return vecchia_outcome


def _vecchia_operands(gen, dtype):
    """Vecchia's [N, m, m] conditioning covariances (RBF-like SPD blocks
    plus noise), masked as `mask_covariance` masks them (row i keeps its
    first min(i, m) neighbours, the rest padded to the identity), and the
    [N, m, 2] right-hand sides with zeros in the padding."""
    from physs_gp_tpu_torch.ops.gaussian import mask_covariance

    n, m, r = VECCHIA_SOLVE
    A = _randn(gen, n, m, 2 * m)
    C = A @ A.transpose(-1, -2) / (2 * m) + 0.01 * torch.eye(m, dtype=torch.float64, device="cuda")
    idx = torch.arange(n, device="cuda")
    w = (torch.arange(m, device="cuda")[None, :] < idx[:, None]).to(torch.float64)
    B = _randn(gen, n, m, r) * w[..., None]
    return mask_covariance(C, w).to(dtype), B.to(dtype)


def _check_vecchia_shapes(gen, dtype, report):
    """The solve at Vecchia's full shape [100 000, 16, 16] with r = 2 (the
    first 16 rows padded to the identity, the first wholly), on the warp
    route, and the Cholesky of GPRN's [1, 64, 64] inducing Gram, on the
    block route, each against its plain version. Each launch's route is
    asserted."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import build

    build.reset_launch_counts()
    C, B = _vecchia_operands(gen, dtype)
    report("gj_solve", "solve", *_rel(bl.batch_solve(C, B), bl.gj_solve_plain(C, B)), dtype,
           f"{list(C.shape)} r={B.shape[-1]} (vecchia, identity-padded rows)")
    K = _spd(gen, 1, GPRN_CHOL, dtype)
    report("chol", "factor", *_rel(bc.batch_cholesky(K), bc.cholesky_plain(K)), dtype,
           f"[1,{GPRN_CHOL},{GPRN_CHOL}] (gprn)")
    routes = build.route_counts()
    got = (routes["gj_solve"]["warp"], routes["gj_solve"]["block"], routes["chol"]["warp"],
           routes["chol"]["block"])
    if got != (1, 0, 0, 1):
        raise AssertionError(f"vecchia / gprn shapes: routes {routes}")
    print(f"[kernels] vecchia / gprn shapes {str(dtype)[6:]}: gj_solve on the warp route, chol on the "
          f"block route")


def _time_vecchia(gen):
    """Kernel, plain and library time at the slice's shapes, float32 and
    float64: the solve at [100 000, 16, 16] with r = 2 against
    `torch.linalg.solve` (CUDA events over a run of calls); the Cholesky of
    [1, 64, 64] (kernel: device time back to back) against
    `torch.linalg.cholesky` (events, as the host sends the calls). The
    bound is the larger of bytes over the memory rate and flops over the
    type's rate. Returns {kernel: [row]}."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl

    out = {}
    n, m, r = VECCHIA_SOLVE
    M = GPRN_CHOL
    for dtype in (torch.float32, torch.float64):
        C, B = _vecchia_operands(gen, dtype)
        K = _spd(gen, 1, M, dtype)
        size = C.element_size()
        rate = FP32_FLOPS_PER_S if dtype == torch.float32 else FP64_FLOPS_PER_S
        host = "as the host sends them"
        timed = [  # kernel, shape, call, plain, library, label, clock, bytes, flops
            ("gj_solve", f"[{n},{m},{m}] r={r}", lambda: bl.batch_solve(C, B),
             lambda: bl.gj_solve_plain(C, B), lambda: torch.linalg.solve(C, B), "torch.linalg.solve",
             _time, _nbytes(C, B) + size * n * m * r, n * (2 * m ** 3 // 3 + 2 * m * m * r)),
            # the Cholesky reads only the lower triangle: M (M + 1) / 2 words
            ("chol", f"[1,{M},{M}]", lambda: bc.batch_cholesky(K), lambda: bc.cholesky_plain(K),
             lambda: torch.linalg.cholesky(K), f"torch.linalg.cholesky, {host}", _time_device,
             size * M * (M + 1) // 2 + size * M * M, M ** 3 // 3),
        ]
        for name, shape, kern, plain, lib, lib_label, clock, nbytes, flops in timed:
            kern(), plain(), lib()
            torch.cuda.synchronize()
            p1, k1, l1 = _time(plain), clock(kern), _time(lib)
            l2, k2, p2 = _time(lib), clock(kern), _time(plain)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
            row = {"shape": shape, "dtype": str(dtype)[6:], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                   "library_ms": (l1 + l2) / 2, "library": lib_label, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "timing": "device_back_to_back" if clock is _time_device else "events"}
            out.setdefault(name, []).append(row)
            print(f"[kernels] time {name} {shape} {row['dtype']} (vecchia / gprn): kernel {row['ms']:.4f} ms "
                  f"({row['timing']}), plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
                  f"({lib_label}), bound {row['bound_ms']:.5f} ms ({row['bound_by']}: "
                  f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP)")
        del C, B
    return out


def _hold_vecchia(tag, res, vo):
    worst = max(res, key=lambda k: vo.relerr(*res[k][:2]) / res[k][2])
    for key, (got, want, tol) in res.items():
        r = vo.relerr(got, want)
        if not (np.all(np.isfinite(got)) and r <= tol):
            raise AssertionError(f"{tag}: {key} disagrees with the JAX reference (rel {r:.3e}, tol {tol:g})")
    return worst, vo.relerr(*res[worst][:2]), res[worst][2]


def phase_vecchia_gprn_anchor():
    """Float64 anchors against tests/data/vecchia_golden.npz (made by
    scripts/port/make_vecchia_golden.py from the JAX package on the CPU):
    `VecchiaGP` at N = 200, m = 12 (lml, gradient by raw, `predict_f` with
    and without `m_predict`, `predict_y`, `nlpd`), again with every 5th y
    missing and a `ConstantMean`; `GPRN` in each mixing on the JAX draws
    (ELBO, KL, gradient, `predict_f`); `LatentVariableGP` in both modes
    (objective, gradient, `predict_f` with and without W_new): lml, ELBO,
    objective, gradients and means rtol 1e-9, variances 1e-7. Counters are
    reset before each configuration; the Vecchia ones must launch
    `gj_solve`, the GPRN ones `chol`. Returns {VECCHIA_PATH: the summed
    launches}."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    vo = _vecchia()
    gold = np.load(vo.GOLDEN)
    total = {k: 0 for k in SOURCES}
    for cfg in vo.CONFIGS:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = vo.anchors(gold, "cuda", (cfg,))[cfg]
        counts = kernels.launch_counts()
        key, rel, tol = _hold_vecchia(f"anchor {cfg}", res, vo)
        print(f"[anchor {cfg}] {len(res)} outputs within tolerance, worst {key} rel {rel:.3e} (tol {tol:g}); "
              f"{time.perf_counter() - t0:.2f} s, launches { {k: v for k, v in counts.items() if v} }")
        need = "gj_solve" if cfg.startswith("vec") else "chol" if cfg.startswith("gprn") else None
        if need and not counts[need]:
            raise AssertionError(f"anchor {cfg}: {need} was never launched")
        for k, v in counts.items():
            total[k] += v
    print(f"[anchor vecchia / gprn / lvgp] launches {total}")
    return {VECCHIA_PATH: total}


def phase_vecchia_gprn_full():
    """The slice at full size (`scripts/port/vecchia_outcome.py`):

    - the card's maximin neighbour sets at N = 5 000 against the CPU's;
    - `VecchiaGP` at N = 100 000 on [0, 10]^2, m = 16, RBF, Gaussian noise:
      the ordering and the neighbour sets on the card, timed apart; then in
      float32 and float64 (the float32 model a copy of the float64 one) the
      lml, the gradient of the objective, 20 Adam steps and `predict_f` /
      `predict_y` / `nlpd` at 1 000 new points, each timed, with the peak
      memory; counters reset just before each type's run and read just
      after: `gj_solve` must launch, on the warp route only; the float32
      lml within V_F32_GAP of float64's;
    - at N = 8 192 the Vecchia lml for m = 5, 12, 16, 30 against the exact
      `BatchGP` lml: the gap must fall as m grows; the m = 16 gap is
      printed beside the JAX test's 2 % bound;
    - `GPRN` at N = 20 000, P = L = 3, M = 64, n_mc = 16, each mixing in
      float32 and float64: ELBO and gradient, 50 Adam steps with a
      generator, `predict_f` at 1 000 points; `chol` must launch, on the
      block route; then the sign-dependent fit (float64, must pass);
    - `LatentVariableGP` at N = 4 096 in both modes (float64): objective and
      gradient, 50 Adam steps; then the two-branch separation (must pass).

    Returns the runs' (counts, routes)."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    vo = _vecchia()
    counts, routes = {}, {}
    t0 = time.perf_counter()
    same = vo.neighbours_agree("cuda")
    print(f"[full vecchia] neighbour sets at N = {vo.V_NB_CHECK_N}, m = {vo.FULL_V['m']}: the card's "
          f"{'equal' if same else 'DIFFER FROM'} the CPU's ({time.perf_counter() - t0:.2f} s)")
    if not same:
        raise AssertionError("full vecchia: the card's neighbour sets differ from the CPU's")
    N = vo.FULL_V["N"]
    torch.cuda.empty_cache()
    model, t_order, t_nbrs, test = vo.vecchia_build("cuda")
    print(f"[full vecchia N={N}] maximin ordering {t_order:.2f} s, neighbour sets (m = {vo.FULL_V['m']}) "
          f"{t_nbrs:.2f} s on the card")
    lml = {}
    for dtype, m in ((torch.float32, vo.vecchia_f32(model)), (torch.float64, model)):
        tag = f"vecchia N={N} {str(dtype)[6:].replace('float', 'f')}"
        kernels.reset_launch_counts()
        res = vo.vecchia_run(m, "cuda", test)
        counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
        print(f"[full {tag}] {json.dumps(res)}")
        print(f"[full {tag}] launches: { {k: v for k, v in counts[tag].items() if v} }, routes "
              f"{ {k: v for k, v in routes[tag].items() if v['warp'] or v['block']} }")
        if not (res["finite"] and res["pred_shape"] == [vo.FULL_V["n_new"], 1]):
            raise AssertionError(f"{tag}: non-finite or misshapen result")
        if not counts[tag]["gj_solve"] or any(r["block"] for r in routes[tag].values()):
            raise AssertionError(f"{tag}: gj_solve did not run, or a block kernel ran: {routes[tag]}")
        lml[dtype] = res["lml"]
        del m
    del model
    gap = abs(lml[torch.float32] - lml[torch.float64]) / abs(lml[torch.float64])
    print(f"[full vecchia] float32 lml {lml[torch.float32]!r} against float64 {lml[torch.float64]!r}: "
          f"rel gap {gap:.3e} (bound {vo.V_F32_GAP:g})")
    if not gap <= vo.V_F32_GAP:
        raise AssertionError("full vecchia: the float32 lml is too far from float64's")
    torch.cuda.empty_cache()
    ex = vo.vecchia_vs_exact("cuda")
    print(f"[full vecchia] N = {vo.V_EXACT['N']} against the exact lml {ex['exact']!r}: rel gap by m "
          f"{ex['rel_gap']}; m = 16 {'within' if ex['rel_gap'][16] <= ex['bound_at_16'] else 'outside'} "
          f"the JAX test's {ex['bound_at_16']:g}; falls as m grows: {ex['monotone']}")
    if not ex["monotone"]:
        raise AssertionError("full vecchia: the gap to the exact lml does not fall as m grows")
    for mixing in vo.MIXINGS:
        for dtype in (torch.float32, torch.float64):
            tag = f"gprn {mixing} {str(dtype)[6:].replace('float', 'f')}"
            torch.cuda.empty_cache()
            kernels.reset_launch_counts()
            res = vo.gprn_full("cuda", dtype, mixing)
            counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
            chol = routes[tag].get("chol", {"warp": 0, "block": 0})
            print(f"[full {tag}] {json.dumps(res)}; launches "
                  f"{ {k: v for k, v in counts[tag].items() if v} }, chol routes {chol}")
            if not (res["finite"] and res["pred_shape"] == [vo.FULL_G["n_new"], vo.FULL_G["P"]]):
                raise AssertionError(f"{tag}: non-finite or misshapen result")
            if not chol["block"]:
                raise AssertionError(f"{tag}: chol did not take its block route")
    res = vo.gprn_fit("cuda")
    print(f"[full gprn fit] {json.dumps(res)} (tests/test_svgp_lmc.py:143)")
    if not res["ok"]:
        raise AssertionError("full gprn: the sign-dependent fit failed")
    for mode in vo.MODES:
        tag = f"lvgp {mode} f64"
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        res = vo.lvgp_full("cuda", torch.float64, mode)
        counts[tag], routes[tag] = kernels.launch_counts(), kernels.route_counts()
        print(f"[full {tag}] {json.dumps(res)}; launches { {k: v for k, v in counts[tag].items() if v} }")
        if not res["finite"]:
            raise AssertionError(f"{tag}: a non-finite result")
    res = vo.lvgp_separation("cuda", np.load(vo.GOLDEN))
    print(f"[full lvgp separation] {json.dumps(res)} (tests/test_input_transforms.py:78)")
    if not res["ok"]:
        raise AssertionError("full lvgp: the latents did not separate the branches")
    return counts, routes


# ---------------------------------------------------------------------------
# Time-axis sharding (`parallel/sharded.py`): spawned ranks on one card
# ---------------------------------------------------------------------------

SHARDED_ANCHORS = (("config5 cov", False, False), ("config5 sqrt", False, True),
                   ("temporal cov", True, False), ("temporal sqrt", True, True))
SHARDED_ANCHOR_NS = (1, 2, 4)  # n = 1 runs under NCCL, more ranks under gloo
# (form, type, T of the lml gradient) of the full-width runs, each of which
# also takes SHARDED_FULL_STEPS natural-gradient steps at T = 100 000. A rank
# builds and holds its segment alone (its gradient's peak ~0.25 of the
# unsharded run's), but the square-root float64 gradient at T = 100 000
# still does not fit on one card for 4 ranks: the unsharded one peaks at
# ~63 GiB, so the ranks' tensors take ~64 GiB and the five processes' CUDA
# memory the rest of the card's 79 GiB (phase_sharded_full measures and
# prints both); it runs at T = 50 000.
SHARDED_FULL_T = 100_000
SHARDED_FULL = tuple((form, dtype, 50_000 if (form, dtype) == ("sqrt", "float64") else SHARDED_FULL_T)
                     for form in ("cov", "fused", "sqrt") for dtype in ("float32", "float64"))
# a rank's peak memory against the unsharded run's, same form, type and T
SHARDED_PEAK_SHARE = 0.4
SHARDED_FULL_N, SHARDED_FULL_STEPS = 4, 2
SHARDED_TIMEOUT_S = 420.0
# ELBOs of phase_slice_full's float32 and float64 runs at T = 100 000, by form
SLICE_ELBOS = {}
# peak memory (GiB) of phase_slice_full's runs (build and steps), by form and type
SLICE_PEAKS = {}


def _surrogate_lml_grad(model):
    """The surrogate lml and its gradient with respect to the kernel's
    trainable raws (numpy)."""
    from physs_gp_tpu_torch.utils.training import trainable_parameters

    sur = model.surrogate_model()
    lml = sur.log_marginal_likelihood()
    grads = torch.autograd.grad(lml, trainable_parameters(sur))
    return float(lml.detach()), torch.cat([g.reshape(-1) for g in grads]).cpu().numpy()


def _sharded_anchor_rank(rank, n):
    """One rank of phase_sharded_anchor: each anchor model (float64, T = 256,
    chunk 64, 8 blocks, 3 natural-gradient steps) through the ("t",) mesh of
    n ranks and without it; then the dryrun's checks (`parallel/dryrun`)."""
    import physs_gp_tpu_torch.ops.matrix  # noqa: F401  (TF32 off)
    from physs_gp_tpu_torch.parallel.dryrun import dryrun_rank
    from physs_gp_tpu_torch.parallel.ranks import make_mesh
    from physs_gp_tpu_torch.parallel.sharded import gather_time
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    mesh = make_mesh((n,), ("t",), "cuda")
    out, t0 = {}, time.perf_counter()
    for name, temporal, sqrt in SHARDED_ANCHORS:
        for tag, m in (("sharded", mesh), ("single", None)):
            model = (build_temporal if temporal else build_config5)(256, 64, dtype=torch.float64,
                                                                    sqrt=sqrt, device="cuda", mesh=m)
            model, elbos = natgrad_scan(model, 0.5, n_steps=3, nan_guard=True)
            post = model.posterior()
            with torch.no_grad():
                lml = float(model.surrogate_model().log_marginal_likelihood())
            # the rank holds its segment's sites: the whole series' for the goldens
            sites = torch.cat([model.sites.Y, torch.diagonal(model.sites.V, dim1=-2, dim2=-1)], -1)
            rows = sites.shape[0]
            if m is not None:
                sites = gather_time(sites, m, model._seg())
            site_Y, site_V_diag = sites.cpu().numpy().reshape(sites.shape[0], 2, -1).swapaxes(0, 1)
            out[(name, tag)] = {
                "elbos": elbos.cpu().numpy(), "lml": lml, "site_Y": site_Y,
                "site_V_diag": site_V_diag, "rows": rows,
                "post_mean": post.mean.cpu().numpy(), "post_var": post.var.cpu().numpy()}
    out["dryrun"] = dryrun_rank(rank, n, "cuda")
    out["wall"] = time.perf_counter() - t0
    return out


def phase_sharded_anchor():
    """Time-axis sharding on the card against the same process's unsharded
    run and the JAX golden files, float64: n = 1 (NCCL), 2 and 4 ranks
    (gloo) share cuda:0, the three spawns side by side. On every rank, each
    anchor model's lml and ELBOs (rtol 1e-9), posterior means, variances
    and sites (1e-7) equal its unsharded run's, and the ELBOs, sites and
    posterior moments the golden files' (1e-9, 1e-7); the dryrun's checks
    (value and gradient of `f.lml + s.ms[-1].sum()`, a Poisson CVI step,
    3 `natgrad_scan` steps, a config-5 step, at n = 4 the composite dp x t
    value and gradient on a 2 x 2 mesh) equal their unsharded runs to rtol
    1e-8."""
    from physs_gp_tpu_torch.parallel.dryrun import RTOL
    from physs_gp_tpu_torch.parallel.ranks import start_ranks

    golden = {"config5 cov": (np.load(GOLDEN), ""), "config5 sqrt": (np.load(GOLDEN_SQRT), ""),
              "temporal cov": (np.load(GOLDEN_TEMPORAL), "cov_"),
              "temporal sqrt": (np.load(GOLDEN_TEMPORAL), "sqrt_")}
    torch.cuda.empty_cache()
    spawns = {n: start_ranks(_sharded_anchor_rank, n, device="cuda",
                             timeout=SHARDED_TIMEOUT_S) for n in SHARDED_ANCHOR_NS}
    worst = {}
    for n, ranks in spawns.items():
        for rank, out in enumerate(ranks.wait()):
            tag = f"sharded anchor n={n} rank {rank}"
            for name, _, _ in SHARDED_ANCHORS:
                got, ref = out[(name, "sharded")], out[(name, "single")]
                gold, pre = golden[name]
                checks = {"lml": (got["lml"], ref["lml"], 1e-9),
                          "ELBOs": (got["elbos"], ref["elbos"], 1e-9),
                          "golden ELBOs": (got["elbos"], gold[pre + "elbos"], 1e-9)}
                for key in ("site_Y", "site_V_diag", "post_mean", "post_var"):
                    checks[key] = (got[key], ref[key], 1e-7)
                    checks["golden " + key] = (got[key], gold[pre + key], 1e-7)
                for key, (val, want, tol) in checks.items():
                    r = _rel_np(val, np.asarray(want))
                    worst[(name, key)] = max(worst.get((name, key), 0.0), r)
                    if not r <= tol:
                        raise AssertionError(f"{tag}: {name} {key} rel {r:.3e} (tol {tol:g})")
            if not {"dp-vmap elbos", "dp-vmap total"} <= set(out["dryrun"]):
                raise AssertionError(f"{tag}: the dryrun returned no part 2: {sorted(out['dryrun'])}")
            for key, (val, want) in out["dryrun"].items():
                r = _rel_np(val, np.asarray(want))
                worst[("dryrun", key)] = max(worst.get(("dryrun", key), 0.0), r)
                if not (np.all(np.isfinite(val)) and np.allclose(val, want, rtol=RTOL,
                                                                 atol=0)):
                    raise AssertionError(f"{tag}: dryrun {key} {val} against unsharded {want}")
            print(f"[{tag}] every check passed; rank wall {out['wall']:.1f} s")
        print(f"[sharded anchor n={n}] dryrun part 2 (dp-vmap: {2 * n} Poisson series stacked "
              f"over a ('dp',) mesh, the summed ELBO all-reduced) passed on every rank")
    for (name, key), r in worst.items():
        print(f"[sharded anchor] {name} {key}: worst rel over ranks and n {r:.3e}")


@contextlib.contextmanager
def _card_memory_sampler(every_s=0.5):
    """A list that fills with the card's memory in use (bytes, every
    process's) every `every_s` seconds while the block runs."""
    import threading

    used, stop = [0], threading.Event()

    def sample():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            used.append(total - free)
            stop.wait(every_s)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield used
    finally:
        stop.set()
        thread.join()


def _sharded_full_rank(rank, n, runs):
    """One rank of phase_sharded_full, for each (form, type, T of the
    gradient): the surrogate lml of config-5 (chunk 25 000) and its gradient
    through the ("t",) mesh of n ranks, then SHARDED_FULL_STEPS
    natural-gradient steps at T = 100 000. The launch counters, the exchange
    statistics and the peak memory are reset after each model is built,
    just before the gradient and just before the steps, and read just after
    each."""
    import physs_gp_tpu_torch.ops.matrix  # noqa: F401  (TF32 off)
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.parallel import sharded
    from physs_gp_tpu_torch.parallel.ranks import make_mesh
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    mesh = make_mesh((n,), ("t",), "cuda")

    def counted():
        return {"exchange": sharded.exchange_stats(), "launches": kernels.launch_counts(),
                "routes": kernels.route_counts(),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    def reset():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        sharded.reset_exchange_stats()
        torch.cuda.reset_peak_memory_stats()

    out = {}
    for form, dtype_name, grad_T in runs:
        if form == "fused":
            os.environ["PHYSS_FUSED_COMBINE"] = "1"
        dtype = getattr(torch, dtype_name)
        torch.cuda.empty_cache()
        model = build_config5(grad_T, 25_000, dtype=dtype, sqrt=form == "sqrt", device="cuda",
                              mesh=mesh)
        reset()
        t0 = time.perf_counter()
        lml, grad = _surrogate_lml_grad(model)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grad_counts = counted()
        if grad_T != SHARDED_FULL_T:
            del model
            torch.cuda.empty_cache()
            model = build_config5(SHARDED_FULL_T, 25_000, dtype=dtype, sqrt=form == "sqrt",
                                  device="cuda", mesh=mesh)
        reset()
        t2 = time.perf_counter()
        model, elbos = natgrad_scan(model, 0.5, n_steps=SHARDED_FULL_STEPS, nan_guard=False)
        elbos = elbos.cpu().numpy()
        t3 = time.perf_counter()
        out[(form, dtype_name)] = {
            "lml": lml, "grad": grad, "grad_T": grad_T, "elbos": elbos, "grad_wall_s": t1 - t0,
            "steps_wall_s": t3 - t2, "site_rows": model.sites.V.shape[0],
            "runs": {"lml + gradient": grad_counts, "steps": counted()},
            "finite": bool(np.all(np.isfinite(elbos)) and np.all(np.isfinite(grad))
                           and torch.isfinite(model.sites.V).all())}
        os.environ.pop("PHYSS_FUSED_COMBINE", None)
        del model
    return out


def phase_sharded_full():
    """Config-5 (chunk 25 000) on 4 ranks that share the card (gloo), in
    covariance, fused and square-root form, float32 and float64: the
    surrogate lml and its gradient at T = 100 000 (each rank builds, holds
    and updates its 25 000-step segment alone; the square-root float64 one
    at T = 50 000, SHARDED_FULL, with the unsharded peak at 100 000 that
    keeps it there printed), then SHARDED_FULL_STEPS natural-gradient steps
    at T = 100 000. In float64 the lml and gradient equal this
    process's unsharded ones and the ELBOs phase_slice_full's (rtol 1e-9);
    in float32 step 1's ELBO is within 1e-2 of the float64 one (step 0
    reported, as in phase_slice_full) and the ELBOs' gaps to
    phase_slice_full's are printed. A rank's peak memory over the gradient
    and over the steps must stay within SHARDED_PEAK_SHARE of the unsharded
    run's (this process's gradient; phase_slice_full's steps), and neither
    run may gather results over the full T ("results" bytes 0). Prints per
    rank the walls, the exchanges' calls, bytes and time by kind, the peaks
    and the launches by kernel and route, and the card's memory in use by
    all processes. These are no speed-up figures: the ranks share one card.
    Returns the runs' launches by path and their routes."""
    import gc

    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.parallel.ranks import start_ranks
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    single = {}
    for form, dtype_name, grad_T in SHARDED_FULL:
        if form == "fused":
            os.environ["PHYSS_FUSED_COMBINE"] = "1"
        torch.cuda.empty_cache()
        model = build_config5(grad_T, 25_000, dtype=getattr(torch, dtype_name),
                              sqrt=form == "sqrt", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lml, grad = _surrogate_lml_grad(model)
        peak = torch.cuda.max_memory_allocated() / 2**30
        single[(form, dtype_name)] = lml, grad, peak
        print(f"[sharded full] unsharded {form} {dtype_name} lml + gradient at T = {grad_T}: "
              f"{time.perf_counter() - t0:.3f} s, peak {peak:.2f} GiB; steps at T = {SHARDED_FULL_T} "
              f"(phase_slice_full) peak {SLICE_PEAKS[(form, dtype_name)]:.2f} GiB")
        os.environ.pop("PHYSS_FUSED_COMBINE", None)
        del model
        if grad_T != SHARDED_FULL_T:  # the peak that keeps the ranks' gradient from SHARDED_FULL_T
            torch.cuda.empty_cache()
            model = build_config5(SHARDED_FULL_T, 25_000, dtype=getattr(torch, dtype_name),
                                  sqrt=form == "sqrt", device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _surrogate_lml_grad(model)
            single[(form, dtype_name, SHARDED_FULL_T)] = torch.cuda.max_memory_allocated() / 2**30
            del model
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[sharded full] before the ranks: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB, the card {(total - free) / 2**30:.2f} GiB in use")
    t0 = time.perf_counter()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # the ranks' allocators
    try:
        with _card_memory_sampler() as used:
            ranks = start_ranks(_sharded_full_rank, SHARDED_FULL_N, args=(SHARDED_FULL,),
                              device="cuda", timeout=SHARDED_TIMEOUT_S).wait()
    finally:
        del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    print(f"[sharded full] {SHARDED_FULL_N} ranks on one card: {time.perf_counter() - t0:.1f} s "
          f"(no speed-up figure: the ranks share one card); the card's memory in use at most "
          f"{max(used) / 2**30:.2f} GiB of {total / 2**30:.2f} (all processes, sampled every 0.5 s)")
    for form, dtype_name, grad_T in SHARDED_FULL:
        if grad_T != SHARDED_FULL_T:
            share = max(out[(form, dtype_name)]["runs"]["lml + gradient"]["peak_gib"]
                        for out in ranks) / single[(form, dtype_name)][2]
            peak = single[(form, dtype_name, SHARDED_FULL_T)]
            print(f"[sharded full] {form} {dtype_name} gradient at T = {grad_T}, not {SHARDED_FULL_T}: the "
                  f"unsharded one peaks at {peak:.2f} GiB there, so {SHARDED_FULL_N} ranks at the "
                  f"share {share:.3f} measured at T = {grad_T} need {SHARDED_FULL_N * share * peak:.2f} "
                  f"GiB of tensors, beside this process's {(total - free) / 2**30:.2f} GiB and each "
                  f"rank's CUDA memory, on a card of {total / 2**30:.2f} GiB")
    counts, routes = {}, {}
    kernels_of = {"cov": ("bmm", "gj_solve", "gj_solve_logdet"),
                  "fused": ("bmm", "gj_solve", "gj_solve_logdet") + FUSED,
                  "sqrt": tuple(k for k in SOURCES if k not in FUSED)}
    for rank, out in enumerate(ranks):
        for (form, dtype_name), res in out.items():
            tag = f"sharded {form} {dtype_name.replace('float', 'f')} rank {rank}"
            lml1, grad1, grad_peak1 = single[(form, dtype_name)]
            unsharded = {"lml + gradient": grad_peak1, "steps": SLICE_PEAKS[(form, dtype_name)]}
            print(f"[{tag}] lml + gradient at T = {res['grad_T']} {res['grad_wall_s']:.3f} s, "
                  f"{SHARDED_FULL_STEPS} steps at T = {SHARDED_FULL_T} {res['steps_wall_s']:.3f} s; "
                  f"sites {res['site_rows']} rows")
            if res["site_rows"] != SHARDED_FULL_T // SHARDED_FULL_N:
                raise AssertionError(f"{tag}: the rank holds {res['site_rows']} rows of sites")
            launched = dict.fromkeys(SOURCES, 0)
            for run, got in res["runs"].items():
                ex = got["exchange"]
                share = got["peak_gib"] / unsharded[run]
                print(f"[{tag}] {run}: peak {got['peak_gib']:.2f} GiB against the unsharded "
                      f"{unsharded[run]:.2f} GiB: {share:.3f} (bound {SHARDED_PEAK_SHARE}); exchanges "
                      + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e6:.3f} MB {v['seconds']:.4f} s"
                                  for k, v in sorted(ex.items())))
                counts[f"{tag} {run}"], routes[f"{tag} {run}"] = got["launches"], got["routes"]
                print(f"[{tag}] {run}: launches { {k: v for k, v in got['launches'].items() if v} }, "
                      f"routes { {k: v for k, v in got['routes'].items() if v.get('warp') or v.get('block')} }")
                for k, v in got["launches"].items():
                    launched[k] += v
                if ex.get("results", {"bytes": 0})["bytes"]:
                    raise AssertionError(f"{tag}: {run} gathered results over the full T")
                if not share <= SHARDED_PEAK_SHARE:
                    raise AssertionError(f"{tag}: {run} peak {share:.3f} of the unsharded run's")
            if not res["finite"]:
                raise AssertionError(f"{tag}: non-finite ELBO, gradient or sites")
            if not all(launched[k] for k in kernels_of[form]):
                raise AssertionError(f"{tag}: a kernel of the form was never launched")
            if form != "fused" and any(launched[k] for k in FUSED):
                raise AssertionError(f"{tag}: a fused combine ran with its knob unset")
            ref = SLICE_ELBOS[(form, dtype_name)][:SHARDED_FULL_STEPS]
            r_elbo = np.abs(res["elbos"] - ref) / np.abs(ref)
            line = f"[{tag}] ELBOs rel {r_elbo.tolist()} against phase_slice_full's"
            if dtype_name == "float64":
                r_lml, r_grad = abs(res["lml"] - lml1) / abs(lml1), _rel_np(res["grad"], grad1)
                print(f"{line}; lml rel {r_lml:.3e}, gradient rel {r_grad:.3e} against unsharded")
                if not max(r_lml, r_grad, r_elbo.max()) <= 1e-9:
                    raise AssertionError(f"{tag}: the sharded float64 run differs from the unsharded one")
            else:
                print(f"{line} (float32, reported)")
        for form in ("cov", "fused", "sqrt"):
            e32, e64 = out[(form, "float32")]["elbos"], out[(form, "float64")]["elbos"]
            gap = np.abs(e32 - e64) / np.abs(e64)
            print(f"[sharded {form} rank {rank}] float32 vs float64 ELBO rel gap {gap.tolist()} "
                  "(bound 1e-2 on step 1; step 0 reported)")
            if not gap[1:].max() <= 1e-2:
                raise AssertionError(f"sharded {form} rank {rank}: float32 and float64 ELBOs disagree")
    return counts, routes

# ---------------------------------------------------------------------------
# Independent models stacked under torch.func.vmap (`models/stacked.py`)
# ---------------------------------------------------------------------------

# (model, form, B) of the float64 anchors at T = 256, chunk 64, 8 blocks
STACKED_ANCHORS = (("temporal", "cov", 8), ("temporal", "sqrt", 8), ("config5", "cov", 2),
                   ("config5", "fused", 2), ("config5", "sqrt", 2))
STACKED_ANCHOR_STEPS = 2
# (model, form, B, T, chunk) of the float32 stacks at full size: a thousand
# hourly count series of the temporal model, and config-5 as four series of
# 25 000 steps (the state count of its T = 100 000 step)
STACKED_FULL = (("temporal", "cov", 1024, 1000, 1000), ("temporal", "sqrt", 1024, 1000, 1000),
                ("config5", "cov", 4, 25_000, 25_000), ("config5", "fused", 4, 25_000, 25_000),
                ("config5", "sqrt", 4, 25_000, 25_000))
STACKED_HELD = 8  # series of a full-size stack held to their own single-model steps
STACKED_F32_RTOL = 1e-5
# the kernels each config-5 form launches (the temporal model's: whatever one
# series' step launches)
STACKED_PATH_KERNELS = {"cov": ("bmm", "gj_solve", "gj_solve_logdet"),
                        "fused": ("bmm", "gj_solve", "gj_solve_logdet") + FUSED,
                        "sqrt": tuple(k for k in SOURCES if k not in FUSED)}
# launches of one stacked step per kernel, by full-size stack (the summary's
# `launches_per_stacked_step`)
STACKED_LAUNCHES = {}


def _stacked_members(which, form, B, T, chunk, dtype, seed):
    """B models of `which` (`build_temporal` or `build_config5`) on the card,
    each with its own data and parameters: the temporal model's own times on
    [0, 1000] and Poisson counts of 1.2 sin(0.1 t + phase); config-5's counts
    plus Poisson(0.5) noise where observed; every trainable raw scaled by a
    factor drawn from [0.95, 1.05]."""
    import copy

    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    rng = np.random.default_rng(seed)
    build = build_temporal if which == "temporal" else build_config5
    base = build(T, chunk, dtype=dtype, sqrt=form == "sqrt", device="cuda")
    kw = dict(dtype=dtype, device="cuda")
    models = []
    for _ in range(B):
        m = copy.deepcopy(base)
        with torch.no_grad():
            if which == "temporal":
                t = np.sort(rng.uniform(0, 1000, T))
                y = rng.poisson(np.exp(1.2 * np.sin(0.1 * t + rng.uniform(0, 2 * np.pi))))
                m.t, m.Y = torch.as_tensor(t, **kw), torch.as_tensor(y[:, None], **kw)
            else:
                noise = torch.as_tensor(rng.poisson(0.5, tuple(m.Y.shape)), **kw)
                m.Y = torch.where(torch.isfinite(m.Y), m.Y + noise, m.Y)
            for p in m.parameters():
                p.mul_(float(rng.uniform(0.95, 1.05)))
        models.append(m)
    return models


@contextlib.contextmanager
def _knob(form):
    """PHYSS_FUSED_COMBINE=1 for the fused form, unset otherwise."""
    old = os.environ.pop("PHYSS_FUSED_COMBINE", None)
    if form == "fused":
        os.environ["PHYSS_FUSED_COMBINE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PHYSS_FUSED_COMBINE", None)
        if old is not None:
            os.environ["PHYSS_FUSED_COMBINE"] = old


def _vmapped_op_cases(gen, B, N, d, dtype):
    """{kernel: (wrapper call, operands with a leading B)} at [B, N, d, .]."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc
    from physs_gp_tpu_torch.ops.parallel_kalman import _FilterElems, _SmootherElems

    def lead(x):
        return x.reshape((B, N) + tuple(x.shape[1:]))

    def spd():
        return lead(_spd(gen, B * N, d, dtype))

    def rnd(*shape):
        return lead(_randn(gen, B * N, *shape).to(dtype))

    cases = {
        "bmm": (lambda A, C: bl.batch_bmm(A, C, False, True), (rnd(d, d), rnd(d, d))),
        "gj_solve": (bl.batch_solve, (spd(), rnd(d, d))),
        "gj_solve_logdet": (bl.batch_solve_logdet, (spd(), rnd(d, 1))),
        "lq": (bq.batch_tria, (rnd(d, 2 * d),)),
        "chol": (bc.batch_cholesky, (spd(),)),
        "chol_gram": (lambda X, Y: bc.batch_chol_gram(X, Y, plus_eye=True), (rnd(d, d), rnd(d, d))),
    }
    if d >= 3:
        f1, f2 = (tuple(lead(x) for x in _filter_elems(gen, B * N, d, dtype)) for _ in range(2))
        s1, s2 = (tuple(lead(x) for x in _smoother_elems(gen, B * N, d, dtype)) for _ in range(2))
        cases["fused_filter"] = (lambda a, b: tuple(fc.fused_filtering_combine(
            _FilterElems(*a), _FilterElems(*b))), (f1, f2))
        cases["fused_smooth"] = (lambda a, b: tuple(fc.fused_smoothing_combine(
            _SmootherElems(*a), _SmootherElems(*b))), (s1, s2))
    return cases


def _check_vmapped_ops(gen):
    """Each kernel wrapper under `torch.func.vmap` (B members folded into the
    kernel's batch: one launch) against a loop over the members (B
    launches), float64, at config-5's d = 32 (N = 256) and the temporal
    model's d = 2 (N = 1000): rel 1e-12; prints whether bit for bit."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    tree = torch.utils._pytree
    B = 4
    for N, d in ((256, 32), (1000, 2)):
        for name, (fn, args) in _vmapped_op_cases(gen, B, N, d, torch.float64).items():
            kernels.reset_launch_counts()
            got = torch.func.vmap(fn)(*args)
            torch.cuda.synchronize()
            once = kernels.launch_counts()[name]
            kernels.reset_launch_counts()
            loop = [fn(*tree.tree_map(lambda x: x[b], args)) for b in range(B)]
            torch.cuda.synchronize()
            per_member = kernels.launch_counts()[name]
            want = tree.tree_map(lambda *xs: torch.stack(xs), *loop)
            pairs = list(zip(tree.tree_leaves(got), tree.tree_leaves(want)))
            err = max(_rel(g, w)[0] for g, w in pairs)
            bits = all(torch.equal(g, w) for g, w in pairs)
            print(f"[stacked vmap op] {name} [{B}, {N}, {d}] f64: rel {err:.3e} to the loop, "
                  f"bit for bit {bits}; launches {once} vmapped, {per_member} looped")
            if not (err <= 1e-12 and once == 1 and per_member == B):
                raise AssertionError(f"stacked vmap op {name} d={d}: rel {err:.3e}, "
                                     f"launches {once} / {per_member}")


def phase_stacked_anchor():
    """Stacked models against their own single-model runs, float64, T = 256,
    chunk 64, 8 blocks: B = 8 temporal series in both forms and B = 2
    config-5 series in covariance, fused and square-root form, each with its
    own data and parameters, 2 `natgrad_scan` steps of the stack against 2
    of each member alone (ELBOs rtol 1e-9, sites and posterior moments
    1e-7); then every kernel wrapper under `vmap` against a loop over the
    members (`_check_vmapped_ops`)."""
    from physs_gp_tpu_torch.models.stacked import StackedCVIGP
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan

    old = os.environ.get("PHYSS_SCAN_BLOCKS")
    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    try:
        for seed, (which, form, B) in enumerate(STACKED_ANCHORS):
            tag = f"stacked anchor {which} {form} B={B} f64"
            with _knob(form):
                models = _stacked_members(which, form, B, 256, 64, torch.float64, seed)
                st, elbos = natgrad_scan(StackedCVIGP(models), 0.5, n_steps=STACKED_ANCHOR_STEPS)
                post = st.posterior()
                worst, bits = {}, True
                for b, m in enumerate(models):
                    m, e = natgrad_scan(m, 0.5, n_steps=STACKED_ANCHOR_STEPS)
                    p = m.posterior()
                    for key, got, want, tol in (
                            ("ELBOs", elbos[:, b], e, 1e-9), ("sites Y", st.sites.Y[b], m.sites.Y, 1e-7),
                            ("sites V", st.sites.V[b], m.sites.V, 1e-7),
                            ("posterior mean", post.mean[b], p.mean, 1e-7),
                            ("posterior var", post.var[b], p.var, 1e-7)):
                        ref = want.detach().cpu().numpy()
                        r = _rel_np(got, ref)
                        worst[key] = max(worst.get(key, 0.0), r)
                        bits = bits and np.array_equal(got.cpu().numpy(), ref, equal_nan=True)
                        if not r <= tol:
                            raise AssertionError(f"{tag}: member {b} {key} rel {r:.3e} (tol {tol:g})")
            print(f"[{tag}] every member equals its own run; worst rel "
                  f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }, bit for bit {bits}")
    finally:
        if old is None:
            os.environ.pop("PHYSS_SCAN_BLOCKS", None)
        else:
            os.environ["PHYSS_SCAN_BLOCKS"] = old
    _check_vmapped_ops(torch.Generator(device="cuda").manual_seed(31))


def _rel_members(val, ref):
    """The worst over the members (leading dimension) of each member's
    max |val - ref| / max |ref| (`_rel_np`)."""
    return max(_rel_np(v, r) for v, r in zip(val, ref.detach().cpu().numpy()))


def phase_stacked_full():
    """The stacks at full size, float32 (`STACKED_FULL`): one warm-up step,
    then one `step_with_elbo` of the stack with its wall, its peak memory
    and its launches by kernel and route (counters reset just before it and
    read just after). That step once more, from the same stack, with every
    kernel wrapper on its plain version (`_plain_on_card`, at the folded
    shapes the stack gives each kernel): every member's ELBO and new sites
    equal the kernels' at rtol STACKED_F32_RTOL. The same two steps
    of STACKED_HELD series alone, spread over the stack from the first to
    the last (the first one's second step timed and counted): each one's
    two ELBOs equal the stack's at rtol STACKED_F32_RTOL. The stack's step
    launches every kernel exactly as often as one series' step (a count
    that grows with B fails), every config-5 form its path's kernels, all
    on the warp and tiled routes. Returns the stacks' launch counts and
    routes."""
    import copy

    from physs_gp_tpu_torch.models.stacked import StackedCVIGP
    from physs_gp_tpu_torch.ops import cuda as kernels

    paths, routes = {}, {}
    for seed, (which, form, B, T, chunk) in enumerate(STACKED_FULL):
        tag = f"stacked {which} {form} B={B} T={T} f32"
        with _knob(form):
            models = _stacked_members(which, form, B, T, chunk, torch.float32, 100 + seed)
            idx = np.unique(np.linspace(0, B - 1, min(STACKED_HELD, B)).round().astype(int))
            held = [copy.deepcopy(models[i]) for i in idx]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st = StackedCVIGP(models)
            del models
            torch.cuda.synchronize()
            t_stack = time.perf_counter() - t0
            t0 = time.perf_counter()
            st, e0 = st.step_with_elbo(0.5)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            plain = copy.copy(st)  # the stack after the warm-up step
            plain.state = dict(st.state)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            st, e1 = st.step_with_elbo(0.5)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, route = kernels.launch_counts(), kernels.route_counts()
            peak = _peak()
            finite = bool(torch.isfinite(e1).all() & torch.isfinite(st.sites.V).all())
            t0 = time.perf_counter()
            with _plain_on_card():
                plain, p1 = plain.step_with_elbo(0.5)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
            vs_plain = {"ELBOs": _rel_members(e1[:, None], p1[:, None]),
                        "sites Y": _rel_members(st.sites.Y, plain.sites.Y),
                        "sites V": _rel_members(st.sites.V, plain.sites.V)}
            del st, plain
            stacked = torch.stack([e0, e1], 1).cpu().numpy()
            worst, one_wall, one_counts = 0.0, None, None
            for i, m in zip(idx, held):
                m, h0 = m.step_with_elbo(0.5)
                if one_wall is None:
                    torch.cuda.synchronize()
                    kernels.reset_launch_counts()
                    t0 = time.perf_counter()
                m, h1 = m.step_with_elbo(0.5)
                if one_wall is None:
                    torch.cuda.synchronize()
                    one_wall = time.perf_counter() - t0
                    one_counts = kernels.launch_counts()
                worst = max(worst, _rel_np(torch.stack([h0, h1]), stacked[i]))
            del held
        print(f"[{tag}] stack built in {t_stack:.3f} s; step wall {wall:.4f} s (first {t_first:.4f} s), "
              f"{wall / B * 1e3:.4f} ms a series; one series' step {one_wall:.4f} s; peak "
              f"{peak:.2f} GiB; finite {finite}")
        print(f"[{tag}] every member's second step against the plain versions on the card "
              f"({t_plain:.2f} s): worst rel { {k: float(f'{v:.3e}') for k, v in vs_plain.items()} } "
              f"(tol {STACKED_F32_RTOL:g})")
        print(f"[{tag}] series {idx.tolist()} alone: ELBOs against the stack's, worst rel "
              f"{worst:.3e} (tol {STACKED_F32_RTOL:g})")
        print(f"[{tag}] launches per stacked step {counts}; per series step {one_counts}")
        print(f"[{tag}] launches by route: {route}")
        if not finite:
            raise AssertionError(f"{tag}: non-finite ELBO or sites")
        if not all(r <= STACKED_F32_RTOL for r in vs_plain.values()):
            raise AssertionError(f"{tag}: the stack disagrees with its plain versions: {vs_plain}")
        if not worst <= STACKED_F32_RTOL:
            raise AssertionError(f"{tag}: a held series' ELBO differs from its own run")
        if counts != one_counts or not any(counts.values()):
            raise AssertionError(f"{tag}: the stacked step's launches {counts} are not one "
                                 f"series' {one_counts}")
        need = STACKED_PATH_KERNELS[form] if which == "config5" else ()
        if not all(counts[k] for k in need) or any(r["block"] for r in route.values()):
            raise AssertionError(f"{tag}: a path kernel never launched or a block route ran")
        paths[tag], routes[tag] = counts, route
        STACKED_LAUNCHES[tag] = counts
    return paths, routes



def _timed(phase, *args):
    """phase(*args), its wall printed as "[name] s"."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    return out


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import physs_gp_tpu_torch.ops.matrix  # noqa: F401  (sets TF32 off)

    _timed(phase_device)
    _timed(phase_build)
    worst, times = _timed(phase_kernels)
    for name, rows in _timed(phase_backward).items():
        times[name]["at_backward"] = rows
    t0 = time.perf_counter()
    phase_slice_anchor(sqrt=False)
    anchored = {("cov", True): phase_slice_anchor(sqrt=False, fused=True),
                ("sqrt", False): phase_slice_anchor(sqrt=True)}
    phase_slice_anchor(sqrt=True, fused=True)
    print(f"[phase_slice_anchor] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_export_anchor(anchored)
    del anchored
    print(f"[phase_export_anchor] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for form in ("c5_cov", "c5_sqrt", "t_cov", "t_sqrt"):
        phase_train_anchor(form)
    phase_train_anchor("c5_cov", fused=True)
    print(f"[phase_train_anchor] {time.perf_counter() - t0:.1f} s")
    _timed(phase_oracle)
    t0 = time.perf_counter()
    knob_off = phase_temporal_anchor(False)
    phase_temporal_anchor(True)
    if not np.array_equal(phase_temporal_anchor(False, fused=True), knob_off):
        raise AssertionError("anchor temporal: PHYSS_FUSED_COMBINE=1 changed the d = 2 ELBOs")
    print("[anchor temporal cov knob on] ELBOs equal, bit for bit, to the knob-off run")
    print(f"[phase_temporal_anchor] {time.perf_counter() - t0:.1f} s")
    _timed(phase_temporal_oracle)
    _timed(phase_serving_anchor)
    for phase in (phase_physics_anchor, phase_vector_field_anchor):
        t0 = time.perf_counter()
        phase()
        print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batch_paths, batch_routes = phase_batch_anchor()
    print(f"[phase_batch_anchor] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dynamics_paths = phase_dynamics_anchor()
    print(f"[phase_dynamics_anchor] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    markov_paths = phase_markov_anchor()
    print(f"[phase_markov_anchor] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vecchia_paths = phase_vecchia_gprn_anchor()
    print(f"[phase_vecchia_gprn_anchor] {time.perf_counter() - t0:.1f} s")
    _timed(phase_sharded_anchor)
    _timed(phase_stacked_anchor)
    paths, routes = _timed(phase_slice_full)
    sharded_paths, sharded_routes = _timed(phase_sharded_full)
    paths.update(sharded_paths)
    routes.update(sharded_routes)
    paths["export"] = _timed(phase_export_full)
    paths.update(batch_paths)
    paths.update(dynamics_paths)
    paths.update(markov_paths)
    paths.update(vecchia_paths)
    routes.update(batch_routes)
    for phase in (phase_temporal_full, phase_sampling_full, phase_streaming_full, phase_physics_full,
                  phase_scattered_full, phase_batch_full, phase_dynamics_full, phase_markov_full,
                  phase_vecchia_gprn_full, phase_stacked_full):
        t0 = time.perf_counter()
        more_paths, more_routes = phase()
        print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
        paths.update(more_paths)
        routes.update(more_routes)
    paths.update(_timed(phase_train_full))
    # `launches` of the fused combines from the fused covariance run, of the
    # others from the square-root run; `launches_by_path` has every run's,
    # `launches_by_kernel` the split between the warp- and block-per-matrix
    # kernels, where a wrapper has both, of that run's launches and of the
    # physics path's where it took a block route
    def by_kernel(name):
        split = {p: routes[p][name] for p in (LAUNCHES_PATH[name], PHYSICS_PATH)
                 if name in routes[p] and (p != PHYSICS_PATH or routes[p][name]["block"])}
        return {"launches_by_kernel": split} if split else {}

    kernels = [
        {"name": name, "route": "cuda", "source": f"physs_gp_tpu_torch/csrc/{SOURCES[name]}.cu",
         "replaces": REPLACES[name],
         "launches": paths[LAUNCHES_PATH[name]][name], "launches_path": LAUNCHES_PATH[name],
         "launches_by_path": {path: counts[name] for path, counts in paths.items()},
         "launches_per_stacked_step": {tag: counts[name] for tag, counts in STACKED_LAUNCHES.items()},
         **by_kernel(name), "max_abs_err": worst[name], **times[name]}
        for name in SOURCES
    ]
    print(f"[total] {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
