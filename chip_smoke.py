#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`madaiemulator_tpu_torch`) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
nvcc:

    python3 chip_smoke.py [--seed 0]

It imports no jax. Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the nvidia-smi name / power-limit line;
               assert the full-FP32 matmul flags (TF32 off).
  2. build   — compile the Hopper kernels from csrc/ (nvcc, first use).
  3. kernels — K1 (pairwise covariance), K2 (batched Cholesky) and K3
               (panel factor + inverse, b in {128, 512, 1024}) on the card
               against their plain-PyTorch versions, K2 and K3 also against
               a float64 factor, K3's |Linv L - I|; NaN on a non-SPD input;
               K1 at every main-path shape (config 4's Grams at N=16,384 by
               bands of rows and full bitwise symmetry), for all three 20
               bitwise-equal repeats and a call on a non-default stream; for
               K2 and K3 (one cluster launch per call) the chosen cluster
               sizes and batches of more clusters than the card holds at
               once; the test-only skewed build of K2 and K3 (every CTA but
               rank 0 waits before each diagonal-block load; built beside
               phase 2) bitwise equal to the production build at cluster
               sizes 1, 2, 4, 8 and 16; 500 / 500 / 200 calls at (4,512),
               (1,512), (16,512) bitwise equal while a second process runs
               K1 in a loop; kernel, plain and library (K1: a library
               composite) times, each kernel's bound, and K1's host time
               per call.
  4. goldens — serve tests/golden/*/state.txt on the card: float64 (library
               path) against expected.txt at rtol 1e-6; float32 (kernel
               path) against the float32 plain-kernel path on the CPU.
  5. slice   — a synthetic snapshot at the width of the flagship multivariate
               emulator (N=512, d=6, t=15, r=4 after PCA), served in-process
               on the kernels (launch counters reset before, read after)
               against float64, then through `interactive_mode` as a
               subprocess; the same on the GEMM-only fast route
               (`--serve_method fast`); precompute, predict-1024 and
               predict-1 times and profiles.
  6. config4 — BASELINE config 4 at full width (N=16,384, d=8, power-
               exponential alpha=2, regression_order=1; data as
               bench/bench_large_n.py draws it): left_cholesky on both
               panel routes at blocks 512 / 1024 (residual gate on the
               bench's SPD matrix, float64 comparison on the Gram), the
               one-pass TF32 tier ("default") as the control the float32
               gates must reject, the update-tier table (N=4,096 at cond
               1e3 .. 1e7: each tier's factor and likelihood error against
               float64, and the "high" threshold held to it), the float32
               LML on each Gram x factorization route (not gated); then the
               main path through the entry points: the LML value and
               closed-form gradient, a 3-step 2-restart fit_gp_host, and
               serving 8,192 queries, each against float64; the fast
               (GEMM-only) serve of the same queries; each tier's factor,
               value+grad and Cinv GEMM at a theta where "auto" picks
               "high"; the blocked route (cholesky_method="blocked",
               right-looking, library math) at "highest" under the K3
               route's factor gates and at "high" under the tier gate, one
               LML value+grad on it against float64, its factor timed
               beside the K3 route and cholesky_ex; times, the value+grad
               memory peak and profiles.
  7. config3 — BASELINE config 3 at full width (N=512, d=6, t=15, PCA 0.99
               -> r components, regression_order=1, power-exponential
               alpha=2, 4 restarts x 40 LBFGS steps; data as
               bench/bench_multivariate.py draws it from --seed): the model
               file written and read, `fit_multivariate` at float32 on K1 +
               K2 (one lock-step LBFGS over r x 4 lanes), against the same
               fit at float64 (library) from the same restarts and against
               a float64 emulator at the same thetas; the CLI as a user runs
               it (estimate_thetas --dtype float32, print_thetas,
               interactive_mode on the new snapshot); the fit's times, its
               objective evaluations per step, one value+grad's wall and
               profile, K2 at the lane batch against its plain version,
               float64 and cholesky_ex; then
               BASELINE configs 1 and 2 estimated at float64 beside their
               golden thetas (reported, not gated).
  8. config5 — BASELINE config 5 at full width (E=2048 members of N=64
               points in d=4, power-exponential alpha=2, regression_order=1,
               4 restarts x 30 L-BFGS steps, 256 queries a member; data as
               bench/bench_ensemble.py draws it from --seed): fit_ensemble
               at float32 on K1 + K2 (one lock-step L-BFGS over the 8,192
               lanes) and predict_ensemble; K1 and K2 against their plain
               versions at the path's shapes on its own operands, timed
               beside the library calls; the float32 fit against a float64
               fit of the first 256 members from the same starts, serving
               against float64, member 0 against a fit of it alone.
  9. gradient — a gradient-enhanced emulator at config 3's width (N=512,
               d=6, t=15 -> r PCs, power-exponential alpha=2,
               regression_order=1, float32) fitted on values, their
               closed-form gradients and per-point noise (4 restarts x 10
               steps: config 3 takes 40), then values and gradients served;
               the joint Gram (3,584 rows, 7 panels of 512) puts K3 at
               (16,512,512), held against its plain version on the path's
               own panels and timed; the float32 fit scored by float64; the
               v3 snapshot served at float32 against float64; the CLI
               (estimate_thetas --noise_file --gradients_file, then
               interactive_mode on the version-3 snapshot); that snapshot
               read and served in process 20 times while a second process
               loads the card, bitwise equal.
 10. iterative — the matrix-free GP (models/iterative.py) at
               bench/capability_64k.py's full width: N=65,536 in d=8,
               float32, y = a smooth truth + 0.05 noise, rank 64, 8 probes,
               mBCG, cg_tol 1e-4, 200 iterations (the fit, the CLI fit
               and the value+grad's profile cut to 50), row chunk 2,048.
               K1 at
               the path's shapes ((1,2048,65536) tiles, (1,65536,1) pivot
               columns, (1,65536,256) serve chunks) against its plain
               version, timed beside the library composite; the main path
               (one value+grad at amp 1, nugget 0.1, ls 0.35; a 1-restart
               x 2-step fit, the bench runs 2 x 12; the serving cache;
               2,048 "precond" and 64 "exact" variances); the float32
               value+grad against float64 with the same probes; the served
               mean's rmse against the truth; "precond" <= "exact" where
               P's ridge is the plain diagonal; the matvec's and the
               value+grad's profiles; the CLI (estimate_thetas
               --fit_method=iterative at config 3's recipe, N=2,048 ->
               interactive_mode --serve_method=iterative over the pipe).
 11. sparse  — SGPR (models/sparse.py) at bench/capability_1m.py's full
               width: N=1,000,000 in d=4 drawn on the card, float32, m=512
               greedy-maximin inducing points, row chunks of 65,536 (each
               checkpointed); K1 at the path's shapes ((1,512,65536),
               (1,512,512), (1,512,4096)) against its plain version; the
               main path (select_inducing, fit_sgpr_host 3 restarts x 12
               steps, the bench runs 40, and 4,096 queries served) with K1
               launched exactly as the code implies and K2 = K3 = 0; the
               float32 ELBO value+grad against float64 with the same Z; the
               served mean against the truth; the snapshot as text and
               .npz read back and served; the CLI (estimate_thetas
               --inducing at config 3's recipe, N=4,096 -> interactive_mode
               over the pipe -> validate --model_file).
 12. diagnostics — models/diagnostics.py and `validate` on the card: phase
               7's snapshot (LOO on its states, 256 joint draws at 1,024
               queries, the covariance's diagonal against the served
               variance), LOO at config 4's width on the K3 route, both at
               float32 against float64; the matrix-free holdout of 128 of
               phase 10's 65,536 points and the matrix-free covariance of 64
               queries at its fitted thetas; K2 on config 3's state Grams
               and K3 on config 4's first panel against their plain
               versions; `validate` over the CLI with and without
               --model_file and --output, and --matrix_free --holdout on
               phase 10's N=2,048 snapshot.
 13. multifidelity — AR(1) co-kriging (models/multifidelity.py): the
               Forrester acceptance case at float64 (21 cheap + 4 expensive
               points, rmse >= 3x better than single fidelity); config 3's
               width with a cheap level: MF_N0=2,048 runs of a biased copy
               of phase 7's simulator (non-nested) and phase 7's 512 runs,
               d=6, t=15, pooled PCA, 4 restarts x 40 steps a level at
               float32 (the cheap level on the K3 route, the expensive on
               K2), each level's fit wall, rho per component, the served
               rmse on 1,024 held-out expensive runs against phase 7's
               single-fidelity snapshot; the text and .npz snapshots read
               back and served, the text one also by native/'s
               madai_query (built in the background from the start of the
               run), and the cause of the text one's float32 gap shown (its
               log-parameters put back, and both read at float64); every
               kernel on the operands the path handed it (K1's Grams and
               crosses on both levels, K2 on the expensive level's Grams,
               K3 on the cheap level's panels); the per-level LOO; the CLI
               (estimate_thetas on a MULTIFIDELITY model file,
               interactive_mode, validate).
 14. calibrate — in-process MCMC (models/calibrate.py) on phase 7's snapshot at
               float32: bench/bench_calibrate.py's run (128 walkers x 2,000
               emcee steps, y_exp = the simulator at a known theta + 0.05
               noise): steps/s, evaluations/s, the busy share of 10 steps,
               acceptance, R-hat, ESS, the posterior mean against the true
               theta; pt and rwm (500 steps each) and hmc (100); phase 13's
               emulator, phase 11's sparse snapshot and phase 10's matrix-free
               emulator on its serving cache; the float32 log-posterior against
               float64 at the same walker positions; K1 on one half-move's
               operands for each emulator kind; the CLI's calibrate with an
               experiment file.
 15. design  — sequential design and Sobol sensitivity
               (models/design.py, models/sensitivity.py) on phase 7's
               snapshot at float32: active_variance_design (pool 4,096,
               8 picks), nroy_wave_design against phase 14's experiment
               file (pool 8,192, threshold 3), sobol_indices (n=4,096:
               32,768 evaluations) and main_effects (33 x 2,048 x 6:
               405,504 evaluations); the acquisition weights, picks,
               viable fraction and Sobol indices against a float64
               emulator on the same pool and draws; the Sobol indices
               against the simulator's own within their Monte Carlo error,
               Ishigami against its closed forms, every NROY pick's float64
               implausibility; active_variance_design on phase 13's
               multi-fidelity emulator, phase 11's sparse snapshot and
               phase 10's matrix-free emulator on its serving cache, and
               sobol_indices on the first two; K1 on each path's operands;
               the CLI's design (both methods, and --matrix_free on phase
               10's CLI snapshot) and sensitivity --main_effects against
               the in-process calls; compat's 1-D sin at float64 and
               float32; times by utils.profiling.timed and profiles.
 16. mesh    — the multi-device paths (parallel/, `mesh=`) over a virtual mesh
               of 4 shards on cuda:0, then over a real mesh of up to 4 cards
               where two or more are visible (else one line says it did not
               run), each against the unsharded call on the same data and timed
               beside it: (a) config 5 (phase 8's data at full width, 10 of its
               30 L-BFGS steps) by fit_ensemble and predict_ensemble over an
               (ensemble) mesh, the batched LML value+grad at the fit's params
               against one batch, the fit's per-member LML against the
               unsharded fit's; (b) predict_queries_sharded of phase 7's
               snapshot over 8,192 and 8,190 queries; (c) sharded_gram_matvec
               at N=65,536 and 65,533 (phase 10's data) and
               lml_iterative(mesh=) against phase 10's own value+grad; (d)
               elbo_sharded at phase 11's N=10^6; (e) left_cholesky_sharded of
               phase 6's Gram against float64; (f) emcee with the walkers
               sharded on phase 7's snapshot. Float32 (the kernels, counted)
               and float64 (library math, where float32 rounds apart by more
               than the tight gates) as the MESH_* constants say.

The launch counters are set to 0 just before each main path (phase 5's
serve, phase 6's value+grad -> fit -> serve, phase 7's fit_multivariate,
phase 8's fit_ensemble -> predict_ensemble, and the new paths: phase 5's
fast serve, phase 6's fast serve and tier runs, phase 9's fit -> serve,
phase 10's value+grad -> fit -> serve, phase 11's fit -> serve, phase
12's config 3 / config 4 / matrix-free diagnostics, phase 13's fit ->
serve, phase 14's emcee chain, phase 6's blocked value+grad, phase 15's
design and sensitivity calls and each sharded call of phase 16) and read
just after it. Phase 5
fails if a kernel of its path never launched, and requires K1 = 2 and K2 =
1 on its fast path; phase 6 requires K3 to launch
exactly once per diagonal panel of every factorization the path makes, and
K1 once per Gram and per query chunk; phase 7 requires K1 and K2 to launch
exactly once per objective evaluation the fit reports, plus once each for
the serve precompute; phase 8 likewise, plus two K1 (Gram, cross) and one
K2 for predict_ensemble; phase 9 requires K1 = K2 = 0 (the joint Gram and
its cross covariances are library math, as in the JAX package) and K3 =
7 panels x (objective evaluations + 1); phase 10 requires K1 > 0 and K2 =
K3 = 0 (its only factorization, the 64 x 64 Woodbury capacitance, is
library math); phase 11 requires K1 = restarts x (value+grad calls x
(1 + 2C) + value calls x (1 + C)) + (1 + C) + 1 for C row chunks and
K2 = K3 = 0; phase 12 requires K1 = K2 + 2 and K3 = 0 on config 3, one
K1 and K3 once per panel on config 4, K1 > 0 and K2 = K3 = 0 on the
matrix-free path; phase 13 requires K1 = (e0 + 1) + 1 + (e1 + 1) + 2, K2 =
e1 + 1 and K3 = 4 (e0 + 1) for e0 and e1 objective evaluations of the cheap
and the expensive level (a state build each, the expensive level's column,
two serve crosses; 4 panels of the cheap level's Gram); phase 14 requires
K1 = 2 x steps + 1 and K2 = K3 = 0 for the emcee chain; phase 6's blocked
route K1 = 1 and K2 = K3 = 0; phase 15 K1 = one cross covariance a predict
(a design pool; a query chunk of Sobol or main effects; one a level on the
multi-fidelity emulator, one a chunk of 1,024 on the matrix-free one) and
K2 = K3 = 0; phase 16 the counts derived from its shards: K1 = K2 + S =
the shards' objective evaluations + 2 S for config 5 over S shards
(predict: 2 K1 + 1 K2 a shard), K1 = S for a sharded serve, K1 = the
shards' whole row chunks for a matvec and phase 10's count for the
sharded value+grad, K1 = 1 + 2 x the shards' row chunks for the sharded
ELBO, no launch for the sharded factor (library panels, as in JAX) and K1
= S (2 steps + 1) for the sharded emcee, K2 = K3 = 0 where not named. It
prints the whole run's wall, then one JSON line with
each kernel's launches (`launches_by_path`: each path's own count;
`launches`: config 5's where that path runs the kernel, else config 3's
fit's, else config 4's, else the serve path's), its error against the plain
version (the largest over the shapes checked), its time, the plain
version's, the library call's (null where no single PyTorch call computes
the function) and its bound (K2 also its error, time and cluster size at
config 3's lane batch, `fit_batch`; K1 and K2 their config-5 shapes,
`config5`; K3 its gradient path's lane batch, `gradient_batch`; K1 the
matrix-free path's shapes, `iterative`, and the sparse path's, `sparse`;
K2 and K3 the diagnostics' operands, `diagnostics`; each kernel the
operands of phases 13, 14 and 15, `multifidelity`, `calibrate` and
`design`); the last
line is
{"ok": true,
"device": ...}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# K1 against its plain version: the distance uses the same fp32 operations in
# the same order, so only expf may differ, by a few ulp of values <= ~1.3.
K1_ATOL = 2e-6
# K2 against the plain version and a float64 factor, relative to max |L|:
# float32 factorizations of Grams with condition number <= ~1e4.
K2_RTOL = 1e-4
# Goldens at float32, kernel path on the card vs plain path on the CPU: two
# float32 evaluations of a nugget ~1e-9 emulator differ by ~1e-4 of the mean
# scale (measured on the CPU between the two float32 paths); variances are
# compared at the scale of the prior variance they cancel against.
GOLDEN_F32_TOL = 1e-3
# Slice: float32 kernel path vs float64 library path (the CPU plain path
# differs from float64 by ~1e-4 of the mean scale and of the prior variance).
SLICE_F32_TOL = 1e-3
# Server answers vs the in-process float32 answers: the states are built by
# the same deterministic kernels; only the batch split of the solves differs.
SERVER_TOL = 1e-5
# K3: |Linv L - I| of a float32 panel inverse, the JAX package's bound
# (tests/test_pallas.py:116).
K3_INV_TOL = 1e-4
# Config 4 (bench/bench_large_n.py): N training points in d, M queries.
C4_N, C4_D, C4_M = 16384, 8, 8192
# The JAX bench's factor gate (bench.py:110-122): max|LL^T - M| / max|M|.
C4_RESIDUAL = 1e-5
# Config 4 at theta (amp 1, nugget 1e-2, length scales 0.5; cond ~1e5):
# float32 factor of the Gram vs the float64 factor of the same matrix,
# relative to max|L|. On the H100 each panel's history product as one
# float32 GEMM over k up to N gave 1.0e-4 to 1.18e-4, in k-chunks of 2048
# 3.2e-5 to 3.6e-5, formed in float64 and rounded once (the "highest" tier
# now) 5.6e-6 (`tools/f32_factor_error.py`); the gate is ~10x that, and the
# one-pass TF32 tier ("default") must exceed it.
C4_GRAM_FACTOR_RTOL = 5e-5
# LML float32 (kernels) vs float64 (library) at theta: value relative to
# |ll64|, gradient relative to max|g64|. The value: 9.9e-5 with the one-GEMM
# history, 7.8e-6 in k-chunks, 5.7e-7 with the float64 history product
# (the float64 factor of the same float32 Gram is 5e-7 from ll64); the gate
# is ~10x that, and the "default" tier must exceed it.
C4_LML_RTOL = 5e-6
# The gradient: 3.2e-4 to 3.6e-4 with the chunked history and 3.2e-4 with
# the float64 one (its amp entry; the others <= 2e-6), from the backward's
# k = N Cinv SGEMM: the gate is ~3x that.
C4_GRAD_RTOL = 1e-3
# Serving at theta, float32 vs float64: mean scale and prior variance.
C4_SERVE_TOL = 1e-3
# Config 3 (bench/bench_multivariate.py:57-75): N=512 heavy-ion-like runs in
# d=6, t=15 observables, PCA at 0.99, regression_order=1, power-exponential
# alpha=2, R=4 restarts x 40 LBFGS steps; C3_M queries for the serve gate.
C3_N, C3_D, C3_T, C3_PCA, C3_R, C3_STEPS, C3_M = 512, 6, 15, 0.99, 4, 40, 1024
# The float32 fit (kernels) against the float64 fit (library) of the same
# function (the float32 jitter floor set on both) from the same restarts:
# each component's float32 best thetas, scored by the float64 LML, fall
# short of the float64 fit's best LML by at most this fraction of |best|.
# Measured on the H100: 0.0-3.0e-3 short. The float32 LML itself sits up
# to 4.1e-3 of the value from the float64 LML at those thetas (nugget at
# ~1e-8 x amp, under the 3.2e-5 x amp jitter floor: cond ~1.6e7), and from
# step ~16 on most of the float32 fit's zoom linesearches end at their
# 20-evaluation cap: the float32 optimizer stops at its objective's
# resolution.
C3_LL_RTOL = 5e-3
# Serving at the fitted thetas, float32 vs float64: mean relative to the
# mean scale, variance relative to the prior variance. Two components fit a
# nugget of ~1e-8 x amp, under the 3.2e-5 x amp float32 jitter floor (set on
# both sides), so the serve factorizations sit at cond ~1.6e7: measured on
# the H100, the kernel path's mean is 1.6e-3 of the mean scale from float64,
# the float32 library route's 1.8e-3, and the two float32 routes 1.9e-3
# apart; the variances 2.7e-6 and 3.9e-6. The mean gate is 2.5e-3, the
# variance gate phase 5's SLICE_F32_TOL.
C3_SERVE_MEAN_TOL = 2.5e-3
# Config 5 (bench/bench_ensemble.py:17-97): E members of N points in d,
# power-exponential alpha=2, regression_order=1, R restarts x C5_STEPS
# L-BFGS steps (zoom), float32; C5_M queries per member. C5_CHECK members are
# fitted again at float64 from the same starts.
C5_E, C5_N, C5_D, C5_R, C5_STEPS, C5_M = 2048, 64, 4, 4, 30, 256
C5_CHECK = 256
# Every member's best LML finite (measured: all 2,048 on the H100).
C5_FINITE = 1.0
# K2 on the path's own Grams, which the fit leaves at nuggets down to
# ~1e-8 x amp: the backward error max|LL^T - A| / max|A| of the factor,
# which conditioning does not inflate (measured 1.0e-6 on the fit's lanes
# and 7.5e-7 on the members' best thetas, the plain version the same; the
# forward distance of any two float32 factors there, up to 5e-3 x max|L|,
# is printed, not gated).
C5_K2_RESIDUAL = 1e-5
# The float32 fit's best thetas scored by the float64 LML, short of a
# float64 fit from the same starts (the float32 jitter floor on both), over
# max(1, |best|), on C5_CHECK members. Measured on the H100: median 6.9e-5,
# 99th percentile 5.2e-3, max 1.25e-2 (5 of 256 members over 1e-3: float32
# stalls its zoom linesearch earlier; the float32 library route from the
# same starts shows the same, median 6.2e-5, max 1.34e-2).
C5_LL_MEDIAN_RTOL = 5e-4
C5_LL_RTOL = 5e-2
# Serving at the float32 fit's thetas, float32 vs float64, per member over
# its mean scale and its prior variance: measured 2.2e-4 and 2.4e-5.
C5_SERVE_TOL = 1e-3
# Member 0 of the float64 ensemble against fit_one_start on member 0 alone
# (its restart LMLs, relative): measured 3.6e-12.
C5_MEMBER_RTOL = 1e-9
# The gradient path (phase 9): config 3's width (N=512 in d=6, t=15, PCA
# 0.99, power-exponential alpha=2, regression_order=1) trained on values,
# their gradients and noise at float32; G_R restarts x G_STEPS L-BFGS steps
# (config 3 takes 40 steps: cut in depth), G_M queries served. The joint
# Gram has N(1+d) = 3,584 rows, 7 panels of 512.
G_N, G_D, G_T, G_PCA, G_R, G_STEPS, G_M = 512, 6, 15, 0.99, 4, 10, 1024
# K3 on the path's own panels: backward error (which the panels' condition
# does not inflate; measured 6.3e-7 on the H100), forward distance from the
# plain version relative to max|L| (1.15e-4: conditioning, the plain
# version sums in another order), and |Linv L - I| (1.4e-4).
G_K3_RESIDUAL, G_K3_RTOL, G_K3_INV = 1e-5, 5e-4, 1e-3
# The float32 fit's best thetas scored by the float64 LML, short of a
# float64 fit from the same starts, over max(1, |best|): measured -1.5e-2
# to 3.5e-3 (the float32 fit ahead on one component).
G_LL_RTOL = 1e-2
# The CLI's v3 snapshot read and served in process this many times while a
# second process loads the card: every serve bitwise equal to the first.
G_LOAD_REPEATS = 20
# Serving the v3 snapshot, float32 vs float64 (the float32 jitter floor on
# both): means over their scale, measured 8.4e-4 (values) and 5.2e-4
# (gradients); variances over their prior variance, 1.1e-6 and 8.6e-6.
G_SERVE_MEAN_TOL, G_SERVE_VAR_TOL = 2.5e-3, 1e-4
# The matrix-free path (phase 10): bench/capability_64k.py's data recipe at
# full width, N=65,536 points in d=8, y = truth + I_NOISE noise, float32;
# its rank, probes, Lanczos length, CG tolerance and budget, row chunk and
# mBCG logdet; the check theta of bench/bench_iterative.py:37-45 (amp 1,
# nugget 0.1, length scales 0.35); the fit at I_R restarts x I_STEPS steps
# (the bench runs 2 x 12: cut in depth; 3 steps took 39 s and the phase
# 259 s, so the steps were cut to 2); I_M queries served with "precond"
# variances in chunks of I_QC, the first I_M_EXACT also with "exact" ones.
# The CLI runs config 3's data recipe at N=I_CLI_N. The fit, the CLI fit
# and the value+grad's profile stop the likelihood's PCG at I_FIT_ITERS
# iterations, cut in depth from the I_ITERS that the gated value+grads and
# the serving solves keep (NVIDIA H100 80GB HBM3, 700 W): at 200 both
# value+grads ran to the cap (worst solve residual 4.4e-4), the phase took
# 254.2 s, the fit 27.8 s and the profile 87.1 s of it; the gated
# float32-vs-float64 comparison needs the 200 (its gradient read 6.9e-6 x
# max|g64| there, 1.04e-4 at 150 against the 1e-4 gate, and at 50 the
# solves stayed 0.224 from converged, over `lml_iterative`'s 1e-2
# feasibility gate: -inf), while the fit at 50 still served at rmse 0.0543
# (gate 0.075).
I_N, I_D, I_NOISE = 65536, 8, 0.05
I_RANK, I_PROBES, I_LANCZOS, I_ROW_CHUNK = 64, 8, 20, 2048
I_TOL, I_ITERS, I_SERVE_TOL = 1e-4, 200, 1e-5
I_FIT_ITERS = 50
I_AMP, I_NUGGET, I_LS = 1.0, 0.1, 0.35
I_R, I_STEPS = 1, 2
I_M, I_M_EXACT, I_QC = 2048, 64, 256
I_CLI_N = 2048
# K1 at the path's shapes: a row-chunk tile of the matvec, a pivot column,
# a serving cross-covariance chunk (batch, rows, columns), all at d = 8.
I_K1_SHAPES = ((1, I_ROW_CHUNK, I_N), (1, I_N, 1), (1, I_N, I_QC))
# Gates, each set from the readings beside it (NVIDIA H100 80GB HBM3, 700
# W). The float32 value+grad against float64 at the check theta, the same
# probes and jitter floor: both solves stop at the 200-iteration cap
# (float32 residual 4.4e-4), and the LML, ~570 nats after cancelling terms
# of ~1e5, differs by 7.8 nats, 1.2e-4 nats a point: the gate is 1e-3 nats
# a point. The gradient differs by 6.9e-6 x max|g64|: the gate is 1e-4.
I_LL_PER_POINT, I_GRAD_RTOL = 1e-3, 1e-4
# The served mean after the fit against the noiseless truth: measured rmse
# 0.0443 under the 0.05 noise floor after 3 steps; the gate is 1.5 x the
# noise floor.
I_RMSE_MAX = 1.5 * I_NOISE
# The sparse path (phase 11): bench/capability_1m.py's recipe at full width,
# N=1,000,000 points in d=4 drawn on the card, y = sin(4 x0) + 0.5 cos(3 x1)
# + x2 x3 + S_NOISE noise, float32; m=512 greedy-maximin inducing points,
# row chunks of 65,536 (16 chunks, the last padded), the host-loop fit with
# backtracking at S_R restarts x S_STEPS steps and vg_batch 1, its
# linesearch on values as at the bench's 40 steps (cut in depth: 3 x 40
# took 89.9 s, 274 value rounds); S_Q queries served. The float32 ELBO
# value+grad is held against float64 (the same Z) at a well-conditioned
# check theta. The CLI runs config 3's recipe at N=S_CLI_N with S_CLI_M
# inducing points, at float64 (see phase_sparse).
S_N, S_D, S_NOISE = 1_000_000, 4, 0.05
S_M, S_ROW_CHUNK, S_R, S_STEPS, S_Q = 512, 65536, 3, 12, 4096
S_AMP, S_NUGGET, S_LS = 1.0, 1e-2, 0.3
# (config 3 runs 40 steps; 40 took 32-38 s with the process start on an
# NVIDIA H100 80GB HBM3, so the CLI fit is cut to 15)
S_CLI_N, S_CLI_M, S_CLI_ROW_CHUNK, S_CLI_STEPS = 4096, 256, 1024, 15
# K1 at the path's shapes: a row chunk's k(Z, X_c), k(Z, Z), the serve
# cross-covariance (batch, rows, columns), all at d = 4.
S_K1_SHAPES = ((1, S_M, S_ROW_CHUNK), (1, S_M, S_M), (1, S_M, S_Q))
S_RMSE_MAX = 1.5 * S_NOISE
# The sparse snapshot read back and served: the .npz holds the float32
# state and log-parameters exactly (its serve equal to SERVER_TOL, read 0);
# the text grammar stores the natural-space thetas, so a log-parameter comes
# back within an ulp of float32, and the serve's K(Z, x) through Lm^-1
# amplifies that (read 1.6e-4 of the mean scale on an NVIDIA H100 80GB
# HBM3, 700 W): text is held at 1e-3.
S_TEXT_SERVE_TOL = 1e-3
# The float32 ELBO value+grad against float64 at the check theta, the same
# Z: the value held per point (the ELBO's quadratic term cancels sums of
# ~1e7 nats), the gradient relative to max|g64|. Measured on an NVIDIA
# H100 80GB HBM3 (700 W): 5.2e-4 nats a point (4.5e-4 x |ll64|; the
# float32 summaries, as in the JAX package; a CPU run at N=20,000 reads
# 2e-4) and 2.0e-3 x max|g64|; the gates are ~4x and 5x those.
S_LL_PER_POINT, S_GRAD_RTOL = 2e-3, 1e-2
# The diagnostics (phase 12): phase 7's config-3 snapshot (its CLI fit) at
# float32 on the card: LOO, D_S joint draws at D_Q queries; config 4's
# width (N=16,384, the K3 route) for LOO at phase 6's check theta; phase
# 10's N=65,536 data at its fitted thetas for the matrix-free holdout of
# D_HOLD points and the matrix-free covariance of D_COV queries.
D_Q, D_S, D_HOLD, D_COV = 1024, 256, 128, 64
# LOO at float32 against float64 (the float32 jitter floor on both), means
# over the mean scale and variances over the largest float64 variance:
# config 3 at a well-conditioned theta (amp 1, nugget 1e-2 x amp, ls 0.5;
# at the fitted thetas the reading is printed, not gated) and config 4 at
# phase 6's check theta.
# Measured on an NVIDIA H100 80GB HBM3 (700 W): config 3 3.9e-6 / 3.3e-6
# at the check theta (1.7e-3 at the fitted nuggets of ~1e-8 x amp),
# config 4 4.2e-6 / 9.4e-6; the gates are ~10x those.
D_C3_AMP, D_C3_NUGGET, D_C3_LS = 1.0, 1e-2, 0.5
D_LOO_TOL, D_C4_LOO_TOL = 5e-5, 1e-4
# The joint draws: the covariance's diagonal against the served variance
# (the same float32 factors, another order of operations; measured 3.8e-5
# of a prior variance of 12.3), over the prior variance; the draws' mean
# within D_Z_MAX standard errors of the served mean at every query and
# observable (D_Q x t values; a standard normal passes 6 with probability
# 1 - 3e-5 at that count).
D_DIAG_TOL, D_Z_MAX = 1e-4, 6.0
# The matrix-free covariance's diagonal against the "exact" served variance
# of the same queries (the same PCG on the same right-hand sides), over the
# amplitude.
D_ITER_DIAG_TOL = 1e-4
# The update-tier table: left_cholesky on float32 SPD matrices of size
# TIER_N at these condition numbers (the last, 1e7, near float32's 1/eps),
# each tier against the float64 factor of the same matrix; TIER_GATE is the
# "highest" tier's accuracy, which the JAX package's choice of "high" (kappa
# <= 2e4) is held to.
TIER_N, TIER_CONDS = 4096, (1e3, 1e4, 2e4, 1e5, 1e7)
TIER_GATE = 5e-4
# Multi-fidelity (phase 13). (a) The Forrester pair (tests/test_multifidelity
# .py's acceptance case, README.md's claim) at float64: 21 cheap points and
# 4 expensive ones; the 2-level emulator's rmse against the true
# high-fidelity curve at least MF_GAIN_MIN times better than a 4-point
# single-fidelity GP's. (b) Config 3's width with a cheap level: the
# expensive level is phase 7's data (N=512 runs of
# bench/bench_multivariate.py's heavy-ion-like simulator from --seed), the
# cheap level MF_N0 runs of a biased copy (0.8 x the simulator + a smooth
# bias + noise) on a design of its own (non-nested), PCA over the pooled
# levels at C3_PCA, C3_R restarts x C3_STEPS steps a level at float32; MF_M
# held-out expensive runs (the noiseless simulator) served against phase 7's
# single-fidelity snapshot. The CLI's MULTIFIDELITY fit runs MF_CLI_R x
# MF_CLI_STEPS (cut in depth: the library fit above runs the full depth;
# 2 x 10 took 19.7 s with the process start on an NVIDIA H100 80GB HBM3).
MF_N0, MF_M = 2048, 1024
MF_GAIN_MIN = 3.0
MF_CLI_R, MF_CLI_STEPS = 1, 3
# The multivariate MF snapshot served by native/'s madai_query against the
# port's float64 serve of the same text snapshot on the card: means over
# their scale, variances over the largest variance.
MF_NATIVE_TOL = 1e-6
# The text snapshot read back at float32 and served, over the mean scale
# and the top level's prior variance: the grammar stores natural-space
# thetas, so the log-parameters come back a few float32 ulp off, and the
# float32 serve at the fitted nuggets (cond ~1e7) amplifies that; measured
# 3.8e-3 of the mean scale on an NVIDIA H100 80GB HBM3, 700 W (the
# variance 0.15 of the largest served variance, which the fitted nuggets
# make tiny: hence the prior scale). `_text_gap_cause` shows it there: 10
# ulp at most; with the log-parameters put back the gap is 0; at float64
# the text and the .npz serve 7.8e-10 of the scale apart. The .npz, which
# holds the float32 arrays, serves equal.
MF_TEXT_SERVE_TOL = 1e-2
# Calibration (phase 14): bench/bench_calibrate.py's defaults (128 walkers x
# 2,000 emcee steps, y_exp = the simulator at a known theta + 0.05 noise,
# experimental variance 0.05^2 on every observable) on phase 7's config-3
# snapshot at float32, the first CAL_BURN steps discarded; pt, rwm and hmc
# CAL_OTHER_STEPS each; phase 13's MF emulator (CAL_OTHER_STEPS of emcee),
# phase 11's N=10^6 sparse snapshot and phase 10's N=65,536 matrix-free
# emulator on its serving cache ("precond" variances), CAL_SMALL_W walkers x
# CAL_SMALL_STEPS each; the CLI's calibrate over phase 7's snapshot
# (CAL_CLI_STEPS; 500 took 20.3 s with the process start). HMC runs
# CAL_HMC_STEPS: 8 leapfrog value+grads a step made 500 steps 45.1 s on the
# slowest host seen (11.1 steps/s, an NVIDIA H100 80GB HBM3 at 700 W), so
# its depth is cut to keep the script inside its time limit.
CAL_W, CAL_STEPS, CAL_BURN, CAL_NOISE = 128, 2000, 500, 0.05
CAL_OTHER_STEPS, CAL_SMALL_W, CAL_SMALL_STEPS = 500, 64, 200
CAL_HMC_STEPS = 100
CAL_CLI_STEPS = 200
# The posterior mean of every parameter within CAL_Z_MAX posterior standard
# deviations of the true theta.
CAL_Z_MAX = 3.0
# The float32 log-posterior against float64 (phase 7's snapshot's arrays at
# both precisions, the float32 jitter floor on both, the same 2,688 walker
# positions), the largest difference over the C3_T observables, in nats a
# observable: measured 0.8328 nats in all, 0.0555 a observable, at |lp64|
# from 0.40 to 26.1, in two runs on an NVIDIA H100 80GB HBM3, 700 W (the
# float32 serve's mean sits ~1.6e-3 of its scale from float64 at the
# fitted nuggets, phase 7). A mean error of delta
# experimental sds on each observable moves the log-posterior of a walker
# within the posterior by ~delta nats a observable: the gate holds the
# float32 serve to ~0.1 sd.
CAL_F32_NATS_PER_OBS = 0.1
# Design and sensitivity (phase 15) on phase 7's config-3 snapshot at
# float32: an active-variance batch of DES_NEW from a DES_POOL-point pool,
# an NROY wave from a DES_NROY_POOL-point pool at implausibility
# DES_THRESHOLD against phase 14's experiment file, Sobol indices at
# n=SOB_N ((d + 2) n evaluations) and main effects on a ME_GRID-point grid
# of ME_N samples (d grid n evaluations), in query chunks of SEN_QC; the
# other emulator kinds at the same sizes. Each pool of 4,096 or 8,192
# queries against N=512 stays under the serve's auto query chunk (N m <=
# 2^26), so each predict is one K1 cross covariance (two on the two-level
# multi-fidelity emulator; the matrix-free serve takes query chunks of
# 1,024).
DES_NEW, DES_POOL, DES_NROY_POOL, DES_THRESHOLD = 8, 4096, 8192, 3.0
SOB_N, ME_GRID, ME_N, SEN_QC = 4096, 33, 2048, 4096
# Gates against float64 (the same snapshot's arrays, the float32 jitter
# floor on both, the same pool and draws), each ~3-4x its reading on an
# NVIDIA H100 80GB HBM3 (700 W): the acquisition weights over the pool
# relative to the largest (read 1.5e-2: each weight sums variances that
# cancel kss - k^T C^-1 k at the fitted nuggets, cond ~1.6e7, where the
# float32 serve's variance is ~3e-6 of the prior variance off, phase 7; the
# picks then split only at near-ties, 1.1e-4 apart), and the Sobol indices
# (absolute; read 4.6e-4).
DES_WEIGHT_RTOL, SOB_F32_ATOL = 5e-2, 2e-3
# The emulator's Sobol indices against the simulator's on the same A and B:
# within 3 Monte Carlo standard errors of the simulator's estimate, plus
# SOB_TRUTH_ATOL (an input the simulator ignores has zero standard error).
SOB_TRUTH_ATOL = 1e-3
# Ishigami (tests/test_sensitivity.py:28-44): n=32,768 at float64, the
# indices within 0.02 of the closed forms, the variance within 5%.
ISHIGAMI_N, ISHIGAMI_ATOL = 32768, 0.02
# compat (tests/test_compat.py:9-20): the served 1-D sin's rmse.
COMPAT_RMSE = 1e-2
# The multi-device paths (phase 16) over a virtual mesh of MESH_SHARDS shards
# on cuda:0 (the counterpart of the JAX tests' 8 virtual CPU devices), then
# over a real mesh of up to MESH_SHARDS cards where two or more are visible.
# Each step is held against the unsharded call on the same data. Where
# float32 rounds apart by more than the tight gates (a batched GEMM, trsm or
# reduction of another size sums in another order, and the fitted Grams at
# cond ~1e7 amplify it: measured on an NVIDIA H100 80GB HBM3, 700 W, config
# 5's value+grad at the fitted params 1.9e-5 relative, config 3's served mean
# 1.2e-3 of its scale, the ELBO 1.5e-5, and the emcee chains apart after a
# flipped accept), the tight gate is held at float64 (library math, the same
# sharding) and the float32 path, whose launches are counted, is held to its
# phase's float32-vs-float64 gate, its distance from the unsharded float32
# call printed. Gates: (a) config 5's batched LML value+grad at the fit's
# params at float64, relative; the float32 fit's per-member best LML is
# reported against the unsharded fit's from the same starts, its "equal" at
# MESH_FIT_RTOL; (b) serving at float64 against the unsharded float64 serve,
# relative to the mean scale and the prior variance, and at float32 against
# phase 7's float64 reference under phase 7's gates; (c) the matvec relative
# to max|C V| (bitwise: each shard's 16,384 rows are 8 whole chunks), the
# float32 value+grad against phase 10's own reading, the value relative, the
# gradient relative to max|g|; (d) the SGPR value+grad at float64 against
# unsharded, and at float32 against float64 under phase 11's gates; (e) the
# sharded factor under phase 6's factor gate; (f) emcee, CAL_W walkers: at
# float64 over MESH_CAL_F64_STEPS steps, the chains at the JAX test's
# tolerances (tests/test_calibrate.py:643-644) and the acceptance equal; at
# float32 over MESH_CAL_STEPS (cut from phase 14's 2,000) for the launches
# and steps/s.
MESH_SHARDS = 4
# Config 5 over the mesh runs MESH_C5_STEPS of its 30 L-BFGS steps (and the
# unsharded fit it is compared with the same): the shards of a virtual mesh
# run in turn, each evaluation host-bound at ~20 ms whatever its lanes, so
# the 30-step fit took 61.7 s on the slowest host seen (NVIDIA H100 80GB
# HBM3, 700 W), 3.8x the unsharded one.
MESH_C5_STEPS = 10
MESH_LML_RTOL, MESH_FIT_RTOL = 1e-6, 1e-4
MESH_SERVE_TOL = 1e-6
MESH_MATVEC_RTOL, MESH_MATVEC_COLS = 1e-6, 18
MESH_ITER_LL_RTOL, MESH_ITER_GRAD_RTOL = 1e-6, 1e-5
MESH_ELBO_RTOL, MESH_ELBO_GRAD_RTOL = 1e-5, 1e-4
MESH_FACTOR_BLOCK = 512
MESH_CAL_STEPS, MESH_CAL_F64_STEPS = 200, 100
MESH_CHAIN_RTOL, MESH_CHAIN_ATOL = 2e-5, 1e-6
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate and FP32 outside the
# tensor cores (the kernels run full FP32 FFMA; TF32 is off).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, iters: int = 5) -> float:
    """Mean wall time of fn() in ms, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    require(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 on")
    require(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 on")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision is not 'highest'")
    return smi


def phase_build() -> None:
    from madaiemulator_tpu_torch.ops.hopper import build

    t0 = time.perf_counter()
    build.load()
    took = time.perf_counter() - t0
    how = ("nvcc %.1f s" % build.build_seconds
           if build.build_seconds is not None else "already built")
    print(f"build: {build.library_path().name} in {took:.2f} s ({how})")


def _points(rng, b, n, d, ls, dev):
    """(b, n, d) uniform points divided by per-dimension length scales."""
    x = rng.uniform(size=(b, n, d)) / np.asarray(ls)
    return torch.tensor(x, dtype=torch.float32, device=dev)


def bound_ms(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: the larger of bytes over the memory
    rate and FP32 operations over the FP32 peak (no tensor cores: TF32 is
    off). Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gram_batch(rng, B, n, nugget, dev, d=6, ls=0.3):
    """(B, n, n) power-exponential Grams of uniform points: SPD test input."""
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1

    U = _points(rng, B, n, d, [ls] * d, dev)
    return k1.pairwise_covariance_plain(
        U, U, torch.ones(B, device=dev), torch.full((B,), nugget, device=dev),
        "power_exponential", True,
    )


def _cluster_checks(dev, rng) -> None:
    """K2 and K3 as cluster kernels: the cluster size chosen per shape, then
    what one launch of co-operating CTAs can get wrong: a race (run-to-run
    difference), clusters queued behind a full card, a foreign stream."""
    from madaiemulator_tpu_torch.ops.hopper import build
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    lib = build.load()
    main_path = [(4, 512), (1, 512), (2, 512), (1, 1024)]
    sizes = {f"({B},{n})": lib.madai_cluster_size(B, n)
             for B, n in main_path + [(32, 512), (4, 500), (40, 256),
                                      (300, 128), (4, 100), (4, 33)]}
    require(all(sizes[f"({B},{n})"] > 1 for B, n in main_path),
            f"a main-path shape runs on a single CTA: {sizes}")
    held = {c: lib.madai_cholesky_max_active_clusters(c)
            for c in (1, 2, 4, 8, 16)}
    require(all(v > 0 for v in held.values()),
            f"a cluster size cannot be scheduled: {held}")
    print(f"K2/K3 cluster size (CTAs per matrix) by (batch, n): {sizes}; "
          f"clusters of that size the card holds at once: {held}")

    def both(A):
        return (k2.cholesky(A),) + (k3.panel_factor(A)
                                    if A.shape[-1] % 32 == 0 else ())

    # (a) 20 calls on one input give bitwise-equal outputs
    for B, n in ((4, 512), (1, 1024), (4, 500), (2, 480)):
        A = _gram_batch(rng, B, n, 0.1, dev)
        first = both(A)
        for _ in range(19):
            again = both(A)
            require(all(torch.equal(x, y) for x, y in zip(first, again)),
                    f"K2/K3 ({B},{n},{n}): outputs differ between calls")
    print("K2/K3 repeat: 20 calls bitwise equal at (4,512,512), "
          "(1,1024,1024), (2,480,480) and K2 at the ragged (4,500,500)")
    # (b) more clusters than the card holds at once
    for B, n in ((40, 256), (300, 128)):
        A = _gram_batch(rng, B, n, 0.1, dev)
        L, (L3, Linv) = k2.cholesky(A), k3.panel_factor(A)
        L64 = torch.linalg.cholesky(A.double())
        torch.cuda.synchronize()
        scale = L64.abs().max().item()
        e2 = (L.double() - L64).abs().max().item()
        e3 = (L3.double() - L64).abs().max().item()
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        einv = (Linv.double() @ L3.double() - eye).abs().max().item()
        require(e2 <= K2_RTOL * scale and e3 <= K2_RTOL * scale
                and einv <= K3_INV_TOL,
                f"large batch ({B},{n}): K2 {e2:.3g}, K3 {e3:.3g}, "
                f"|Linv L - I| {einv:.3g}")
        print(f"K2/K3 large batch ({B},{n},{n}), cluster size "
              f"{lib.madai_cluster_size(B, n)}: vs float64 K2 {e2:.3g}, K3 "
              f"{e3:.3g} (tol {K2_RTOL} x max|L| {scale:.3g}); "
              f"max|Linv L - I| {einv:.3g}")
    # (c) a non-default stream
    A = _gram_batch(rng, 4, 512, 0.1, dev)
    want = both(A)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        got = both(A)
    side.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(want, got)),
            "K2/K3 on a non-default stream differ from the default stream")
    print("K2/K3 on a non-default torch.cuda.Stream: bitwise equal to the "
          "default stream's")


def _race_checks(dev, skew_build) -> dict:
    """A cross-CTA race in K2 and K3 looked for two more ways: the skewed
    build (every CTA but rank 0 waits before each diagonal-block load)
    against the production build at every cluster size the main paths use,
    bitwise; and the production kernels called 500 / 500 / 200 times while
    a second process runs K1 in a loop on the card, each call bitwise equal
    to the first. Returns the readings for the kernels line."""
    from madaiemulator_tpu_torch.ops.hopper import build
    from madaiemulator_tpu_torch.tools import cluster_skew

    t0 = time.perf_counter()
    load = cluster_skew.CardLoad()  # sets itself up during the skew check
    try:
        skew_s = skew_build.result()
        skew = {}
        for B, n in cluster_skew.SHAPES:
            r = cluster_skew.compare(cluster_skew.gram(B, n, B * n, dev))
            skew[f"({B},{n})"] = r
            outs = ("K2 L", "K3 L", "K3 Linv")
            require(all(r[o]["equal"] for o in outs),
                    f"K2/K3 ({B},{n},{n}) C={r['C']}: the skewed build "
                    f"differs from the production build: "
                    f"{ {o: r[o] for o in outs} }")
        sizes = sorted({r["C"] for r in skew.values()})
        require(sizes == [1, 2, 4, 8, 16], f"skew check cluster sizes {sizes}")
        print(f"K2/K3 skewed build ({build.SKEW_NS} ns before each "
              f"diagonal-block load on every CTA but rank 0; built beside "
              f"phase 2 in {skew_s:.1f} s): L and Linv bitwise equal to the "
              f"production build at " + ", ".join(
                  f"{k} C={r['C']}" for k, r in skew.items()))
        rep = cluster_skew.repeat_under_load(dev, load)
    finally:
        load.stop()
    require(all(r["equal"] for r in rep.values()),
            f"K2/K3 under a card load: calls differ: {rep}")
    print("K2/K3 under a card load (K1 in a loop in a second process): "
          + ", ".join(f"{r['calls']} calls at {k} C={r['C']}"
                      for k, r in rep.items())
          + f", each bitwise equal to the first; skew and load checks "
          f"{time.perf_counter() - t0:.1f} s")
    return {"skew_ns": build.SKEW_NS,
            "skew_equal": {k: r["C"] for k, r in skew.items()},
            "repeat_under_load": rep}


# K1 at the main paths' shapes, (route, B, n1, n2, d): config 4's Gram at
# one theta and at the fit's 2 restarts, its 1,024-query chunk; the slice's
# Gram, predict-1024 cross and one-query cross; config 3's fit Gram (4
# components x 4 restarts).
K1_SHAPES = (
    ("gram", 1, 16384, 16384, 8), ("gram", 2, 16384, 16384, 8),
    ("cross", 1, 16384, 1024, 8),
    ("gram", 4, 512, 512, 6), ("cross", 4, 512, 1024, 6),
    ("cross", 4, 512, 1, 6), ("gram", 16, 512, 512, 6),
)
K1_BAND = 256  # rows at the top and the bottom of a large Gram checked
K1_FULL_CHECK_MAX = 1 << 25  # outputs up to which the plain version runs whole


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of fn() in ms: `iters` calls captured in one CUDA graph,
    replayed, timed by CUDA events (no host time between the launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    t = cuda_ms(g.replay, iters=5, warmup=1) / iters
    del g
    return t


def host_us(fn, calls: int = 1000, rounds: int = 5) -> float:
    """Median over `rounds` of the host wall time per call, in us, of
    `calls` back-to-back calls with no synchronize between them."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return float(np.median(per))


def _k1_composite(U, V, amp, g, gram):
    """The library yardstick for the power-exponential K1 (several calls,
    never used by the port): cdist, squared, then the epilogue in place."""
    out = torch.cdist(U, V).square_().mul_(-0.5).exp_().mul_(amp[:, None, None])
    if gram:
        out.diagonal(dim1=1, dim2=2).add_(g[:, None])
    return out


def _k1_gram_band_err(k1, U, amp, g, G) -> float:
    """Rows [0, K1_BAND) and [N - K1_BAND, N) of the kernel's Gram G against
    the plain version on those rows (diag_add at the true diagonal): a check
    at N = 16,384 without the plain version's N^2 temporaries."""
    N = U.shape[1]
    idx = torch.arange(K1_BAND, device=U.device)
    err = 0.0
    for r0 in (0, N - K1_BAND):
        want = k1.pairwise_covariance_plain(
            U[:, r0:r0 + K1_BAND].contiguous(), U, amp, None,
            "power_exponential")
        want[:, idx, r0 + idx] = want[:, idx, r0 + idx] + g[:, None]
        err = max(err, (G[:, r0:r0 + K1_BAND] - want).abs().max().item())
    return err


def _k1_main_shapes(dev, rng, err_so_far: float) -> dict:
    """K1 at the main paths' shapes (K1_SHAPES): against the plain version
    (a band of rows and full bitwise symmetry at N = 16,384), 20 bitwise-equal
    calls, a non-default stream; the kernel's time (CUDA events over
    back-to-back calls; for the serve shapes also the device time from a CUDA
    graph), the plain version's, the library composite's and the bound; the
    host time per call of the wrapper and of `cross_covariance` at the serve
    path's query shapes. Returns K1's entry of the kernels JSON line."""
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.utils.config import GPConfig

    fam = "power_exponential"
    k1_err = err_so_far
    by_shape = {}
    for route, B, n1, n2, d in K1_SHAPES:
        gram = route == "gram"
        label = f"{route}({B},{n1},{n2})d{d}"
        ls = [0.5 if d == 8 else 0.3] * d
        U = _points(rng, B, n1, d, ls, dev)
        V = U if gram else _points(rng, B, n2, d, ls, dev)
        amp = torch.tensor(rng.uniform(0.5, 2.0, B), dtype=torch.float32,
                           device=dev)
        g = torch.tensor(rng.uniform(1e-3, 0.3, B), dtype=torch.float32,
                         device=dev)

        def kern(U=U, V=V, amp=amp, g=g, gram=gram):
            return k1.pairwise_covariance(U, V, amp, g, fam, gram)

        def plain(U=U, V=V, amp=amp, g=g, gram=gram):
            return k1.pairwise_covariance_plain(U, V, amp, g, fam, gram)

        large = B * n1 * n2 > K1_FULL_CHECK_MAX
        got = kern()
        torch.cuda.synchronize()
        require(got.shape == (B, n1, n2), f"K1 {label} shape")
        if large and gram:
            err = _k1_gram_band_err(k1, U, amp, g, got)
        else:
            err = (got - plain()).abs().max().item()
        require(err <= K1_ATOL, f"K1 {label} err {err:.3g}")
        if gram:
            require(torch.equal(got, got.mT), f"K1 {label} not symmetric")
        for _ in range(19):
            require(torch.equal(kern(), got), f"K1 {label}: calls differ")
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            again = kern()
        side.synchronize()
        require(torch.equal(again, got), f"K1 {label}: side stream differs")
        k1_err = max(k1_err, err)
        del got, again
        it = 5 if large else 50
        t = {"ms": cuda_ms(kern, iters=it),
             "graph_ms": None if large else graph_ms(kern),
             "plain_ms": cuda_ms(plain, iters=2 if large else 20,
                                 warmup=1),
             "composite_ms": cuda_ms(lambda: _k1_composite(U, V, amp, g, gram),
                                     iters=it)}
        reads = B * n1 * d + (0 if gram else B * n2 * d) + 2 * B
        pairs = B * n1 * (n1 + 1) // 2 if gram else B * n1 * n2
        t["bound_ms"], t["bound_by"] = bound_ms(4 * (reads + B * n1 * n2),
                                                pairs * (3 * d + 3))
        t["max_abs_err"] = err
        by_shape[label] = t
        print(f"K1 {label}: max_abs_err vs plain {err:.3g} <= {K1_ATOL}"
              f"{f' (rows 0-{K1_BAND - 1} and the last {K1_BAND})' if large and gram else ''}"
              f"{'; bitwise symmetric' if gram else ''}; 20 calls bitwise "
              f"equal; side stream equal; kernel {t['ms']:.4f} ms"
              f"{'' if t['graph_ms'] is None else ' (device, CUDA graph: %.4f ms)' % t['graph_ms']}"
              f", plain {t['plain_ms']:.4f} ms, library composite cdist + "
              f"epilogue {t['composite_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4g} ms ({t['bound_by']}); "
              f"{t['bound_ms'] / (t['graph_ms'] or t['ms']):.2f} of the bound")
        del U, V
        torch.cuda.empty_cache()

    # host time per call at the serve path's query shapes: the wrapper, and
    # cross_covariance (the layer above it, from the raw query points)
    cfg = GPConfig(nparams=6, regression_order=1)
    host = {}
    for B, n1, n2, d in ((4, 512, 1, 6), (4, 512, 1024, 6)):
        X1 = torch.tensor(rng.uniform(size=(n1, d)), dtype=torch.float32,
                          device=dev)
        X2 = torch.tensor(rng.uniform(size=(n2, d)), dtype=torch.float32,
                          device=dev)
        params = kernels.GPParams(
            log_amp=torch.zeros(B, device=dev),
            log_nugget=torch.full((B,), -7.0, device=dev),
            log_ls=torch.full((B, d), float(np.log(0.3)), device=dev))
        U = kernels._scaled(X1, params, cfg)
        V = kernels._scaled(X2, params, cfg)
        amp = torch.exp(params.log_amp)
        shape = f"({B},{n1},{n2})"
        host[f"wrapper{shape}"] = host_us(
            lambda: k1.pairwise_covariance(U, V, amp, None, fam))
        host[f"cross_covariance{shape}"] = host_us(
            lambda: kernels.cross_covariance(X1, X2, params, cfg))
    print("K1 host time per call, us (median of 5 x 1,000 calls, no "
          "synchronize): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

    main = by_shape["gram(1,16384,16384)d8"]
    return {"name": "pairwise_covariance", "route": "cuda",
            "source": "madaiemulator_tpu_torch/csrc/pairwise.cu",
            "replaces": "madaiemulator_tpu/ops/pallas/pairwise.py:90",
            "max_abs_err": k1_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "composite_ms": main["composite_ms"], "by_shape": by_shape,
            "host_us": host}


def phase_kernels(dev, rng, k1_rng, skew_build) -> list:
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    B, n, m, d = 4, 512, 1024, 6
    amp = torch.tensor([1.0, 0.5, 1.3, 2.0], device=dev)
    nug = torch.tensor([1e-3, 1e-2, 0.1, 0.25], device=dev)
    iso = [0.3] * d
    ard = [0.2, 0.3, 0.4, 0.5, 0.6, 0.7]
    k1_err = 0.0
    cases = []
    for fam in k1.FAMILIES:
        cases.append((fam, n, n, d, iso))
        cases.append((fam, n, m, d, iso))
        cases.append((fam, 500, 37, d, iso))
    cases += [("matern32", n, n, d, ard), ("matern52", n, m, d, ard)]
    for fam, n1, n2, dd, ls in cases:
        U = _points(rng, B, n1, dd, ls, dev)
        V = U if n1 == n2 else _points(rng, B, n2, dd, ls, dev)
        gram = n1 == n2
        got = k1.pairwise_covariance(U, V, amp, nug, fam, gram)
        want = k1.pairwise_covariance_plain(U, V, amp, nug, fam, gram)
        torch.cuda.synchronize()
        require(got.shape == (B, n1, n2), f"K1 shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        require(err <= K1_ATOL, f"K1 {fam} ({n1},{n2}) err {err:.3g}")
        if gram:
            require(torch.equal(got, got.mT), f"K1 {fam} Gram not symmetric")
        k1_err = max(k1_err, err)
    print(f"K1 pairwise: {len(cases)} cases (3 families + ARD Matérn; Gram "
          f"{n}x{n}, cross {n}x{m}, ragged 500x37; batch {B}) max_abs_err "
          f"{k1_err:.3g} <= {K1_ATOL}; Grams bitwise symmetric")

    Uq = _points(rng, B, n, d, iso, dev)
    # a (B, m, d) draw, kept so that the later phases' data stay those of
    # earlier runs of this script
    _points(rng, B, m, d, iso, dev)
    k1_entry = _k1_main_shapes(dev, k1_rng, k1_err)

    k2_err = 0.0
    for nn in (64, 128, 500, 512, 1024):
        U = _points(rng, B, nn, d, iso, dev)
        A = k1.pairwise_covariance_plain(
            U, U, torch.ones(B, device=dev), torch.full((B,), 0.1, device=dev),
            "power_exponential", True,
        )
        L = k2.cholesky(A)
        Lp = k2.cholesky_plain(A)
        L64 = torch.linalg.cholesky(A.double())
        torch.cuda.synchronize()
        scale = L64.abs().max().item()
        require(torch.equal(L, torch.tril(L)), f"K2 n={nn} not lower")
        e64 = (L.double() - L64).abs().max().item()
        ep = (L - Lp).abs().max().item()
        require(e64 <= K2_RTOL * scale, f"K2 n={nn} vs f64 {e64:.3g}")
        require(ep <= K2_RTOL * scale, f"K2 n={nn} vs plain {ep:.3g}")
        k2_err = max(k2_err, ep)
        print(f"K2 cholesky n={nn} batch {B}: max_abs_err vs plain {ep:.3g}, "
              f"vs float64 {e64:.3g} (max|L| {scale:.3g}, tol "
              f"{K2_RTOL} x max|L|)")
    bad = A.clone()
    bad[1] -= 5.0 * torch.eye(A.shape[-1], device=dev)
    Lbad = k2.cholesky(bad)
    torch.cuda.synchronize()
    finite = torch.isfinite(Lbad).flatten(1).all(1).tolist()
    require(finite == [True, False, True, True], f"K2 non-SPD finite {finite}")
    require(bool(torch.isnan(Lbad[1]).any()), "K2 non-SPD gave no NaN")
    print("K2 non-SPD input: NaN in the failed member only")

    A512 = k1.pairwise_covariance_plain(
        Uq, Uq, torch.ones(B, device=dev), torch.full((B,), 1e-3, device=dev),
        "power_exponential", True,
    )
    t2 = cuda_ms(lambda: k2.cholesky(A512))
    t2p = cuda_ms(lambda: k2.cholesky_plain(A512), iters=5)
    t2lib = cuda_ms(lambda: torch.linalg.cholesky_ex(A512))
    k2_bound = bound_ms(4 * (B * n * (n + 1) / 2 + B * n * n), B * n ** 3 / 3)
    print(f"K2 time ({B},{n},{n}): kernel {t2:.4f} ms, plain {t2p:.4f} ms, "
          f"torch.linalg.cholesky_ex {t2lib:.4f} ms, bound "
          f"{k2_bound[0]:.5f} ms ({k2_bound[1]})")
    # one large matrix, and a fit-loop batch (restarts x components)
    for bb, nn in ((1, 1024), (32, 512)):
        Ab = _gram_batch(rng, bb, nn, 1e-3, dev)
        tb = bound_ms(4 * (bb * nn * (nn + 1) / 2 + bb * nn * nn),
                      bb * nn ** 3 / 3)
        print(f"K2 time ({bb},{nn},{nn}): kernel "
              f"{cuda_ms(lambda: k2.cholesky(Ab)):.4f} ms, "
              f"torch.linalg.cholesky_ex "
              f"{cuda_ms(lambda: torch.linalg.cholesky_ex(Ab)):.4f} ms, "
              f"bound {tb[0]:.5f} ms ({tb[1]})")
        del Ab

    k3_err = 0.0
    Bp = 2
    for b in (128, 512, 1024):
        U = _points(rng, Bp, b, d, iso, dev)
        A = k1.pairwise_covariance_plain(
            U, U, torch.ones(Bp, device=dev),
            torch.full((Bp,), 0.1, device=dev), "power_exponential", True,
        )
        L, Linv = k3.panel_factor(A)
        Lp, Linvp = k3.panel_factor_plain(A)
        L64 = torch.linalg.cholesky(A.double())
        torch.cuda.synchronize()
        scale = L64.abs().max().item()
        require(torch.equal(L, torch.tril(L))
                and torch.equal(Linv, torch.tril(Linv)),
                f"K3 b={b}: nonzero above the diagonal")
        e64 = (L.double() - L64).abs().max().item()
        ep = (L - Lp).abs().max().item()
        eye = torch.eye(b, dtype=torch.float64, device=dev)
        einv = (Linv.double() @ L.double() - eye).abs().max().item()
        require(e64 <= K2_RTOL * scale, f"K3 b={b} L vs f64 {e64:.3g}")
        require(ep <= K2_RTOL * scale, f"K3 b={b} L vs plain {ep:.3g}")
        require(einv <= K3_INV_TOL, f"K3 b={b} |Linv L - I| {einv:.3g}")
        k3_err = max(k3_err, ep)
        print(f"K3 panel_factor b={b} batch {Bp}: L max_abs_err vs plain "
              f"{ep:.3g}, vs float64 {e64:.3g} (max|L| {scale:.3g}, tol "
              f"{K2_RTOL} x max|L|); max|Linv L - I| {einv:.3g} <= "
              f"{K3_INV_TOL}; Linv vs plain "
              f"{(Linv - Linvp).abs().max().item():.3g}")
    bad = A.clone()
    bad[1] -= 5.0 * torch.eye(A.shape[-1], device=dev)
    Lbad, Linvbad = k3.panel_factor(bad)
    torch.cuda.synchronize()
    for what, out in (("L", Lbad), ("Linv", Linvbad)):
        finite = torch.isfinite(out).flatten(1).all(1).tolist()
        require(finite == [True, False], f"K3 non-SPD {what} finite {finite}")
        require(bool(torch.isnan(out[1]).any()), f"K3 non-SPD {what} no NaN")
    print("K3 non-SPD input: NaN in the failed member's L and Linv only")
    _cluster_checks(dev, rng)
    cluster = _race_checks(dev, skew_build)

    k3_times, k3_bounds = {}, {}
    for bb, b in ((2, 512), (1, 512), (1, 1024)):
        U = _points(rng, bb, b, d, iso, dev)
        A = k1.pairwise_covariance_plain(
            U, U, torch.ones(bb, device=dev),
            torch.full((bb,), 1e-3, device=dev), "power_exponential", True,
        )
        eye = torch.eye(b, device=dev).expand(bb, b, b)

        def library_pair(A=A, eye=eye):
            L, _ = torch.linalg.cholesky_ex(A)
            return torch.linalg.solve_triangular(L, eye, upper=False)

        k3_times[(bb, b)] = (
            cuda_ms(lambda: k3.panel_factor(A)),
            cuda_ms(lambda: k3.panel_factor_plain(A), iters=2, warmup=1),
            cuda_ms(library_pair),
        )
        t3, t3p, t3lib = k3_times[(bb, b)]
        # the lower triangle of A in, L and L^-1 out; b^3/3 flops each stage
        t3b = k3_bounds[(bb, b)] = bound_ms(
            4 * (bb * b * (b + 1) / 2 + 2 * bb * b * b), 2 * bb * b ** 3 / 3)
        print(f"K3 time ({bb},{b},{b}): kernel {t3:.4f} ms, plain "
              f"{t3p:.4f} ms, library pair cholesky_ex + "
              f"solve_triangular(L, I) {t3lib:.4f} ms, bound {t3b[0]:.5f} "
              f"ms ({t3b[1]})")

    # bounds at the timed shapes: K2 (4, 512, 512) and K3 (2, 512, 512)
    b3 = 512
    k3_bound = k3_bounds[(Bp, b3)]
    return [
        k1_entry,
        {"name": "cholesky", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/cholesky.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/cholesky.py:210",
         "max_abs_err": k2_err, "ms": t2, "plain_ms": t2p,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": t2lib, "cluster_checks": cluster},
        {"name": "panel_factor", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/panel_factor.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/cholesky.py:179",
         "max_abs_err": k3_err, "ms": k3_times[(Bp, b3)][0],
         "plain_ms": k3_times[(Bp, b3)][1], "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None,
         "cluster_checks": cluster},
    ]


def _prior_var(emu, kss=None) -> float:
    """Largest observable prior variance: the scale a predictive variance
    cancels against. kss, each component's prior variance, is amp + nugget
    of the emulator's own parameters unless the caller passes it (a
    multi-fidelity emulator's recursion)."""
    from madaiemulator_tpu_torch.models.multivariate import (
        reconstruct_observables,
    )

    if kss is None:
        kss = torch.exp(emu.params.log_amp) + torch.exp(emu.params.log_nugget)
    _, v = reconstruct_observables(torch.zeros_like(kss[:, None]),
                                   kss[:, None], emu.pca)
    return v.max().item()


def phase_goldens(dev) -> None:
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models.multivariate import predict_multivariate

    cases = sorted(p for p in (ROOT / "tests" / "golden").iterdir()
                   if p.is_dir())
    require(len(cases) > 0, "no golden fixtures")
    for case in cases:
        q = np.loadtxt(case / "queries.txt", ndmin=2)
        e = np.loadtxt(case / "expected.txt", ndmin=2)
        emu, _, _ = read_snapshot(str(case / "state.txt"), device=dev,
                                  dtype=torch.float64)
        t = emu.n_outputs
        mean, var = (x.cpu().numpy() for x in predict_multivariate(emu, q))
        scale = max(1.0, float(np.abs(e[:, :t]).max()))
        np.testing.assert_allclose(mean, e[:, :t], rtol=1e-6, atol=1e-6 * scale)
        np.testing.assert_allclose(var, e[:, t:], rtol=1e-6, atol=1e-12)
        emu32, _, _ = read_snapshot(str(case / "state.txt"), device=dev,
                                    dtype=torch.float32)
        cpu32, _, _ = read_snapshot(str(case / "state.txt"), device="cpu",
                                    dtype=torch.float32)
        m32, v32 = (x.cpu().double().numpy()
                    for x in predict_multivariate(emu32, q))
        mc, vc = (x.double().numpy() for x in predict_multivariate(cpu32, q))
        pv = _prior_var(cpu32)
        dm = np.abs(m32 - mc).max() / scale
        dv = np.abs(v32 - vc).max() / pv
        require(dm <= GOLDEN_F32_TOL and dv <= GOLDEN_F32_TOL,
                f"golden {case.name} float32 card vs CPU: mean {dm:.3g}, "
                f"var {dv:.3g}")
        print(f"golden {case.name}: float64 matches expected at rtol 1e-6; "
              f"float32 card vs CPU plain: mean {dm:.3g} x scale, var "
              f"{dv:.3g} x prior var; float32 vs expected (not gated): mean "
              f"{np.abs(m32 - e[:, :t]).max() / scale:.3g} x scale")


def _latin_hypercube(rng, n, d):
    perms = np.stack([rng.permutation(n) for _ in range(d)], axis=1)
    return (perms + rng.uniform(size=(n, d))) / n


def _slice_snapshot(path: str, rng) -> tuple:
    """Write a synthetic snapshot at the flagship multivariate width with the
    port's own code: N=512 Latin-hypercube points in d=6, t=15 observables
    mixed from 4 smooth latent functions, PCA at 0.99, fixed thetas
    (power-exponential, amp 1, nugget 1e-3, length scales 0.3,
    regression_order=1). Returns (natural-unit queries (1024, d), names)."""
    from madaiemulator_tpu_torch.io.snapshot import write_snapshot
    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
        pca_decompose,
    )
    from madaiemulator_tpu_torch.utils.config import GPConfig

    N, d, t = 512, 6, 15
    x = _latin_hypercube(rng, N, d)
    lo = rng.uniform(-1.0, 0.0, d)
    span = rng.uniform(0.5, 2.0, d)
    latent = np.stack([
        np.sin(2 * np.pi * x[:, 0] + x[:, 1]),
        np.exp(-2.0 * ((x[:, :3] - 0.5) ** 2).sum(1)),
        x[:, 3] * x[:, 4] + 0.5 * x[:, 5] ** 2,
        np.cos(3.0 * x[:, 2]) * x[:, 1],
    ], axis=1)
    Y = latent @ rng.standard_normal((4, t)) + 1e-3 * rng.standard_normal((N, t))
    pca, Z = pca_decompose(Y, 0.99)
    r = Z.shape[1]
    arrays = dict(
        mins=lo, ranges=span, X=x, Z=Z, ymean=pca.ymean, ystd=pca.ystd,
        eigenvalues=pca.eigenvalues, U=pca.U, log_amp=np.zeros(r),
        log_nugget=np.full(r, np.log(1e-3)),
        log_ls=np.full((r, d), np.log(0.3)),
    )
    emu = emulator_from_numpy(arrays, GPConfig(nparams=d, regression_order=1),
                              device="cpu", dtype=torch.float64)
    pnames = [f"p{i}" for i in range(d)]
    onames = [f"obs{j}" for j in range(t)]
    write_snapshot(path, emu, pnames, onames)
    queries = lo + span * rng.uniform(size=(1024, d))
    return queries, pnames, onames, r


def _serve_over_pipe(path, batches, d, t, header, extra=()):
    """Drive `interactive_mode` on the card with one request batch at a
    time; returns the answers, (sum of batch sizes, 2t)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "madaiemulator_tpu_torch.cli",
         "interactive_mode", path, "--device", "cuda", "--dtype", "float32",
         *extra],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        got_header = [proc.stdout.readline() for _ in range(len(header))]
        if got_header != header:
            proc.kill()
            raise RuntimeError(f"chip_smoke: server header {got_header[:4]}"
                               f"...; stderr: {proc.stderr.read()}")
        answers = []
        for pts in batches:
            req = "".join(" ".join(f"{v:.17g}" for v in p) + "\n" for p in pts)
            # write from a thread: a large batch can fill both pipes at once
            w = threading.Thread(target=lambda s=req: (proc.stdin.write(s),
                                                       proc.stdin.flush()))
            w.start()
            vals = [float(proc.stdout.readline())
                    for _ in range(2 * t * len(pts))]
            w.join()
            answers.append(np.asarray(vals).reshape(len(pts), 2 * t))
        proc.stdin.close()
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(rc == 0, f"server exit {rc}: {err}")
    require(proc.stdout.read() == "", "server wrote past its answers")
    return np.concatenate(answers, axis=0)


def phase_slice(dev, rng, smi) -> tuple:
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models.multivariate import (
        _vmapped_states,
        precompute_fast_multivariate,
        predict_multivariate,
        predict_multivariate_fast,
    )
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1

    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "state.txt")
        queries, pnames, onames, r = _slice_snapshot(path, rng)
        d, t = len(pnames), len(onames)
        print(f"slice: N=512 d={d} t={t} -> r={r} components (PCA 0.99)")

        # the main path, in-process: load (serve states) + predict 1024 points
        k1.launches = 0
        k2.launches = 0
        emu, _, _ = read_snapshot(path, device=dev, dtype=torch.float32)
        mean, var = predict_multivariate(emu, queries)
        torch.cuda.synchronize()
        launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches}
        require(all(v > 0 for v in launches.values()),
                f"main path skipped a kernel: {launches}")
        require(bool(emu.states.ok.all()), "slice serve state not SPD")
        require(mean.shape == (1024, t) and var.shape == (1024, t),
                "slice output shape")
        require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                "slice output not finite")
        emu64, _, _ = read_snapshot(path, device=dev, dtype=torch.float64)
        m64, v64 = predict_multivariate(emu64, queries)
        scale = max(1.0, m64.abs().max().item())
        pv = _prior_var(emu64)
        dm = (mean.double() - m64).abs().max().item() / scale
        dv = (var.double() - v64).abs().max().item() / pv
        require(dm <= SLICE_F32_TOL and dv <= SLICE_F32_TOL,
                f"slice float32 vs float64: mean {dm:.3g}, var {dv:.3g}")
        print(f"slice in-process float32 (kernels: {launches}) vs float64: "
              f"mean {dm:.3g} x scale, var {dv:.3g} x prior var (tol "
              f"{SLICE_F32_TOL})")

        # served over the pipe, batch by batch
        batches = [queries[:1], queries[1:8], queries[8:72], queries]
        sizes = tuple(len(b) for b in batches)
        header = ([f"{d}\n"] + [f"{s}\n" for s in pnames] + [f"{2 * t}\n"]
                  + [f"mean_{s}\n" for s in onames]
                  + [f"variance_{s}\n" for s in onames])
        served = _serve_over_pipe(path, batches, d, t, header)
        ref = [predict_multivariate(emu, b) for b in batches]
        ref = np.concatenate(
            [torch.cat(mv, dim=1).cpu().double().numpy() for mv in ref])
        sm = np.abs(served[:, :t] - ref[:, :t]).max() / scale
        sv = np.abs(served[:, t:] - ref[:, t:]).max() / pv
        require(sm <= SERVER_TOL and sv <= SERVER_TOL,
                f"server vs in-process: mean {sm:.3g}, var {sv:.3g}")
        print(f"slice served over interactive_mode (batches {sizes}): header "
              f"ok; vs in-process float32 mean {sm:.3g} x scale, var "
              f"{sv:.3g} x prior var (tol {SERVER_TOL})")

        # GEMM-only serving, its own path: the counts set to 0 just before
        # the load + fast precompute + predict 1024, read just after
        k1.launches = k2.launches = 0
        emu_f, _, _ = read_snapshot(path, device=dev, dtype=torch.float32)
        fast = precompute_fast_multivariate(emu_f)
        fmean, fvar = predict_multivariate_fast(emu_f, fast, queries)
        torch.cuda.synchronize()
        launches_fast = {"pairwise_covariance": k1.launches,
                         "cholesky": k2.launches}
        require(launches_fast == {"pairwise_covariance": 2, "cholesky": 1},
                f"slice fast path launches {launches_fast}: K1 = Gram + one "
                f"query cross, K2 = one factorization")
        fm = (fmean.double() - m64).abs().max().item() / scale
        fv = (fvar.double() - v64).abs().max().item() / pv
        require(fm <= SLICE_F32_TOL and fv <= SLICE_F32_TOL,
                f"slice fast float32 vs float64: mean {fm:.3g}, var {fv:.3g}")
        served = _serve_over_pipe(path, batches, d, t, header,
                                  ("--serve_method", "fast"))
        ref = np.concatenate([
            torch.cat(predict_multivariate_fast(emu_f, fast, b), dim=1)
            .cpu().double().numpy() for b in batches])
        sm = np.abs(served[:, :t] - ref[:, :t]).max() / scale
        sv = np.abs(served[:, t:] - ref[:, t:]).max() / pv
        require(sm <= SERVER_TOL and sv <= SERVER_TOL,
                f"fast server vs in-process: mean {sm:.3g}, var {sv:.3g}")
        print(f"slice fast (GEMM-only) in-process float32 (kernels: "
              f"{launches_fast}) vs float64: mean {fm:.3g} x scale, var "
              f"{fv:.3g} x prior var (tol {SLICE_F32_TOL}); vs the dense "
              f"float32 route: mean "
              f"{(fmean - mean).abs().max().item() / scale:.3g}, var "
              f"{(fvar - var).abs().max().item() / pv:.3g}; served over "
              f"interactive_mode --serve_method fast vs in-process: mean "
              f"{sm:.3g}, var {sv:.3g} (tol {SERVER_TOL})")

        # times at the slice width, kernel path and library path
        times = {}
        for label, cfg in (
            ("kernels", emu.config),
            ("library", dataclasses.replace(emu.config, gram_method="xla",
                                            cholesky_method="xla")),
        ):
            e = emu._replace(config=cfg)
            times[label] = (
                host_ms(lambda: _vmapped_states(e.params, e.X, e.Z, cfg)),
                host_ms(lambda: predict_multivariate(e, queries)),
                host_ms(lambda: predict_multivariate(e, queries[:1]),
                        iters=50),
            )
            print(f"slice times ({label}, float32, {smi}): serve-state "
                  f"precompute (Gram + Cholesky + GLS, r={r}) "
                  f"{times[label][0]:.3f} ms; predict 1024 queries "
                  f"{times[label][1]:.3f} ms; predict 1 query "
                  f"{times[label][2]:.3f} ms")
        profile_once("precompute", lambda: _vmapped_states(
            emu.params, emu.X, emu.Z, emu.config), times["kernels"][0], smi,
            cell="slice")
        profile_once("predict_1024", lambda: predict_multivariate(
            emu, queries), times["kernels"][1], smi, cell="slice")
        tf = (host_ms(lambda: precompute_fast_multivariate(emu_f)),
              host_ms(lambda: predict_multivariate_fast(emu_f, fast,
                                                        queries)),
              host_ms(lambda: predict_multivariate_fast(emu_f, fast,
                                                        queries[:1]),
                      iters=50))
        print(f"slice times (fast, float32, {smi}): explicit inverses on "
              f"top of the serve states {tf[0]:.3f} ms; predict 1024 "
              f"queries {tf[1]:.3f} ms; predict 1 query {tf[2]:.3f} ms")
        profile_once("predict_1024_fast", lambda: predict_multivariate_fast(
            emu_f, fast, queries), tf[1], smi, cell="slice")
    return launches, launches_fast


def profile_once(what: str, fn, wall_ms: float, smi: str,
                 top: int = 8, cell: str = "config4",
                 warm: bool = True) -> None:
    """Run fn() once under torch.profiler (after one unprofiled call unless
    warm is False: the caller has just run it); print the device time of
    its kernels, their count, the busy share (device time over `wall_ms`,
    the call's wall time measured without the profiler) and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kern)
    n = sum(e.count for e in kern)
    rows = sorted(kern, key=dev_us, reverse=True)[:top]
    print(f"{cell} profile {what}: kernels {total / 1e3:.3f} ms device in "
          f"{n} launches, busy {total / 1e3 / wall_ms:.2f} of {wall_ms:.3f} "
          f"ms wall ({smi}); top: " + "; ".join(
              f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
              for e in rows))


def _c4_data(seed: int, dev):
    """BASELINE config 4 as bench/bench_large_n.py:38-43 draws it: X uniform
    in [0, 1]^8 (N = 16,384), y = sin(3 x0) + x1^2, then 8,192 uniform
    queries, all float32, from numpy with `seed`."""
    from madaiemulator_tpu_torch.models.gp import GPData

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(C4_N, C4_D)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    Xs = rng.uniform(size=(C4_M, C4_D)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return GPData(X=t(X), y=t(y)), t(Xs)


def phase_config4(dev, seed: int, smi: str) -> dict:
    """BASELINE config 4 (N=16,384, d=8, power-exponential alpha = 2,
    regression_order=1) through the port's entry points on the kernels:
    factor, LML value + gradient, fit_gp_host, serve. Every check is made
    and printed; the phase fails at its end if any did not pass."""
    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils.config import GPConfig

    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"config4 check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    data, Xs = _c4_data(seed, dev)
    cfg = GPConfig(nparams=C4_D, regression_order=1, cholesky_block=512,
                   predict_query_chunk=1024)
    # the float64 reference evaluates the same function: the float32 jitter
    # floor is set explicitly on both sides
    jit32 = kernels.effective_jitter_frac(C4_N, torch.float32, cfg)
    cfg = dataclasses.replace(cfg, jitter=jit32)
    theta = kernels.GPParams(
        log_amp=torch.zeros((), device=dev),
        log_nugget=torch.log(torch.tensor(1e-2, device=dev)),
        log_ls=torch.log(torch.full((C4_D,), 0.5, device=dev)),
    )
    theta64 = kernels.GPParams(*(a.double() for a in theta))
    data64 = gp.GPData(X=data.X.double(), y=data.y.double())
    print(f"config4: N={C4_N} d={C4_D} power-exponential alpha=2, "
          f"regression_order=1, cholesky_block=512, predict_query_chunk=1024,"
          f" jitter {jit32:.3g} x amp on both dtypes ({smi})")

    # 1. the large-N factorization, both panel routes, two block sizes
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(C4_N, C4_N, generator=gen, device=dev) / C4_N ** 0.5
    M = 4.0 * torch.eye(C4_N, device=dev) + A @ A.mT
    del A
    mmax = M.abs().max().item()
    C = kernels.gram_matrix(data.X, theta, cfg)
    t_gram = cuda_ms(lambda: kernels.gram_matrix(data.X, theta, cfg), iters=5)
    L64 = torch.linalg.cholesky(C.double())
    l64max = L64.abs().max().item()
    times = {"gram": t_gram}
    for block in (512, 1024):
        for diag in ("pallas", "xla"):
            L = linalg.left_cholesky(M, block=block, diag=diag)
            r = (M - L @ L.mT).abs().max().item() / mmax
            check(r < C4_RESIDUAL,
                  f"SPD 4I+AA^T/N block {block} diag={diag}: residual "
                  f"max|LL^T-M|/max|M| {r:.3g} < {C4_RESIDUAL}")
            del L
            L = linalg.left_cholesky(C, block=block, diag=diag)
            e = (L.double() - L64).abs().max().item() / l64max
            check(e <= C4_GRAM_FACTOR_RTOL,
                  f"Gram block {block} diag={diag}: factor vs float64 "
                  f"{e:.3g} x max|L| <= {C4_GRAM_FACTOR_RTOL}")
            del L
            times[f"factor_{diag}_{block}"] = host_ms(
                lambda b=block, g=diag: linalg.left_cholesky(
                    M, block=b, diag=g), iters=2)
    # the blocked route (cholesky_method="blocked": right-looking, one
    # trailing GEMM per block column, library math as in the JAX package)
    # at block 512, under the K3 route's gates at "highest"; "high" is held
    # at nugget 2 (`_config4_tiers`), its reading here printed
    for tier in ("highest", "high"):
        L = linalg.blocked_cholesky_opt(M, block=512, update_precision=tier)
        r = (M - L @ L.mT).abs().max().item() / mmax
        del L
        L = linalg.blocked_cholesky_opt(C, block=512, update_precision=tier)
        e = (L.double() - L64).abs().max().item() / l64max
        del L
        times[f"factor_blocked_{tier}"] = host_ms(
            lambda t=tier: linalg.blocked_cholesky_opt(
                M, block=512, update_precision=t), iters=2)
        what = (f"blocked {tier!r} block 512: SPD 4I+AA^T/N residual "
                f"{r:.3g}, Gram factor vs float64 {e:.3g} x max|L|")
        if tier == "highest":
            check(r < C4_RESIDUAL and e <= C4_GRAM_FACTOR_RTOL,
                  f"{what} (gates {C4_RESIDUAL}, {C4_GRAM_FACTOR_RTOL})")
        else:
            print(f"config4 {what} (not gated at this theta: 'high' is "
                  f"held at nugget 2)")
    times["factor_cholesky_ex"] = host_ms(
        lambda: torch.linalg.cholesky_ex(M), iters=2)
    del M
    # the one-pass TF32 tier ("default") on the same Gram must fail the
    # gate, or the gate could not tell full FP32 from a lower precision
    for diag in ("pallas", "xla"):
        L = linalg.left_cholesky(C, block=512, update_precision="default",
                                 diag=diag)
        e = (L.double() - L64).abs().max().item() / l64max
        # NaN (the factorization failed) is a rejection too
        check(not e <= C4_GRAM_FACTOR_RTOL,
              f"tier 'default' (one TF32 pass), Gram block 512 diag={diag}:"
              f" factor vs float64 {e:.3g} x max|L|, not <= "
              f"{C4_GRAM_FACTOR_RTOL} (the gate rejects one TF32 pass)")
        del L
    del C, L64
    _tier_table(dev, seed, smi, check)

    # where the float32 LML's distance from float64 comes from (not gated):
    # each float32 Gram against the float64 Gram, and the LML value on each
    # Gram x factorization route
    C64 = kernels.gram_matrix(data64.X, theta64, cfg)
    c64max = C64.abs().max().item()
    with torch.no_grad():
        ll64 = gp.log_marginal_likelihood(theta64, data64, cfg).item()
    grams = {"pallas": "K1", "xla": "library"}
    chols = {"pallas": "K3 panels", "left": "library panels",
             "xla": "cholesky_ex whole"}
    for gram, gname in grams.items():
        cg = dataclasses.replace(cfg, gram_method=gram)
        dC = kernels.gram_matrix(data.X, theta, cg).double() - C64
        print(f"config4 Gram {gname} float32 vs float64: max|dC| "
              f"{dC.abs().max().item() / c64max:.3g} x max|C64|, mean dC "
              f"{dC.mean().item():.3g}, mean diag dC "
              f"{dC.diagonal().mean().item():.3g}")
        del dC
        for chol, cname in chols.items():
            c = dataclasses.replace(cg, cholesky_method=chol)
            with torch.no_grad():
                v = gp.log_marginal_likelihood(theta, data, c).item()
            print(f"config4 LML float32, Gram {gname}, factor {cname}: "
                  f"{v:.8g}, {abs(v - ll64) / abs(ll64):.3g} x |ll64| "
                  f"(ll64 {ll64:.8g})")
    del C64

    def value_and_grad(p, d, c=cfg):
        p = kernels.GPParams(*(a.detach().requires_grad_() for a in p))
        ll = gp.log_marginal_likelihood(p, d, c)
        return ll, torch.autograd.grad(ll, p)

    def flat(g):
        return torch.cat([a.reshape(-1).double() for a in g])

    def run_fit(steps):
        res = fit.fit_gp_host(torch.Generator().manual_seed(seed), data, cfg,
                              n_restarts=2, max_steps=steps)
        torch.cuda.synchronize()
        return res

    # the LML value and gradient at the "default" tier (its factorization
    # one TF32 pass; its backward full FP32, as in the JAX package)
    ll_tf, g_tf = value_and_grad(theta, data, dataclasses.replace(
        cfg, cholesky_update_precision="default"))
    ll_tf = ll_tf.item()
    # [1] alone: the value tensor would keep the float64 factor alive
    g64 = flat(value_and_grad(theta64, data64)[1])
    g64max = g64.abs().max().item()
    ev = abs(ll_tf - ll64) / abs(ll64)
    check(not ev <= C4_LML_RTOL,
          f"tier 'default': LML {ll_tf:.8g} vs float64: {ev:.3g} x |ll64|, "
          f"not <= {C4_LML_RTOL} (the gate rejects one TF32 pass); gradient "
          f"{(flat(g_tf) - g64).abs().max().item() / g64max:.3g} x max|g64| "
          f"(not gated)")
    start = run_fit(0)  # the best of the starts, for the fit check

    # 2. the main path through the entry points, with the launch counts set
    # to 0 just before it and read just after: the LML value and closed-form
    # gradient, fit_gp_host (2 restarts x 3 steps), then serving 8,192
    # queries (precompute_predictor_safe + predict_from_precomputed)
    k1.launches = k2.launches = k3.launches = 0
    ll32, g32 = value_and_grad(theta, data)
    ll32 = ll32.detach()  # frees the factor the backward kept
    res = run_fit(3)
    st = gp.precompute_predictor_safe(theta, data, cfg)
    mean, var = gp.predict_from_precomputed(st, theta, data, Xs, cfg)
    torch.cuda.synchronize()
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    # each LML evaluation of the fit (one batch of both restarts) and the
    # serve precompute build one Gram by K1 and factor it with one K3 launch
    # per diagonal panel; predict runs K1 once per query chunk
    n_fact = 1 + res.stats["n_vg_calls"] + res.stats["n_v_calls"] + 1
    panels = -(-C4_N // cfg.cholesky_block)
    chunks = -(-C4_M // cfg.predict_query_chunk)
    check(k3.launches == panels * n_fact
          and k1.launches == n_fact + chunks,
          f"config-4 path (value+grad, fit, serve) launches {launches}: K3 "
          f"= {panels} panels x {n_fact} factorizations, K1 = {n_fact} Grams"
          f" + {chunks} query chunks")

    ll32 = ll32.item()
    g32 = flat(g32)
    ev = abs(ll32 - ll64) / abs(ll64)
    eg = (g32 - g64).abs().max().item() / g64max
    check(np.isfinite(ll32) and ev <= C4_LML_RTOL,
          f"LML float32 {ll32:.8g} vs float64 {ll64:.8g}: {ev:.3g} x |ll64| "
          f"<= {C4_LML_RTOL}")
    eg_each = ((g32 - g64).abs() / g64max).cpu().numpy()
    check(bool(torch.isfinite(g32).all()) and eg <= C4_GRAD_RTOL,
          f"LML gradient float32 vs float64: {eg:.3g} x max|g64| <= "
          f"{C4_GRAD_RTOL} (per entry [amp, nugget, ls...] "
          f"{np.array2string(eg_each, precision=3)}); g64 "
          f"{np.array2string(g64.cpu().numpy(), precision=4)}")
    best0, best3 = start.log_likelihood.item(), res.log_likelihood.item()
    check(np.isfinite(best3) and best3 >= best0,
          f"fit_gp_host 2 restarts x 3 steps: best logL {best3:.8g} >= best "
          f"start {best0:.8g}; stats {res.stats}")
    st64 = gp.precompute_predictor_safe(theta64, data64, cfg)
    m64, v64 = gp.predict_from_precomputed(st64, theta64, data64,
                                           Xs.double(), cfg)
    del st64
    scale = max(1.0, m64.abs().max().item())
    prior = 1.0 + 1e-2  # amp + nugget at theta
    dm = (mean.double() - m64).abs().max().item() / scale
    dv = (var.double() - v64).abs().max().item() / prior
    check(bool(st.ok) and mean.shape == (C4_M,)
          and bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
          and dm <= C4_SERVE_TOL and dv <= C4_SERVE_TOL,
          f"serve {C4_M} queries float32 vs float64: mean {dm:.3g} x scale, "
          f"var {dv:.3g} x prior var <= {C4_SERVE_TOL}")
    # and the fitted thetas, as a user would serve them
    stf = gp.precompute_predictor_safe(res.params, data, cfg)
    mf, vf = gp.predict_from_precomputed(stf, res.params, data, Xs, cfg)
    check(bool(torch.isfinite(mf).all() and torch.isfinite(vf).all()),
          f"serve the fitted thetas: {C4_M} finite means and variances "
          f"(ok={bool(stf.ok)})")
    del stf

    # GEMM-only serving of the same queries, its own path: the counts set
    # to 0 just before the fast precompute (factorization + the explicit
    # inverses) and predict_fast, read just after
    k1.launches = k2.launches = k3.launches = 0
    fp = gp.precompute_fast_predictor(theta, data, cfg)
    mfast, vfast = gp.predict_fast(fp, theta, data, Xs, cfg)
    torch.cuda.synchronize()
    launches_fast = {"pairwise_covariance": k1.launches,
                     "cholesky": k2.launches, "panel_factor": k3.launches}
    check(launches_fast == {"pairwise_covariance": 1 + chunks, "cholesky": 0,
                            "panel_factor": panels},
          f"config-4 fast path (precompute_fast_predictor, predict_fast) "
          f"launches {launches_fast}: K1 = 1 Gram + {chunks} query chunks, "
          f"K3 = {panels} panels")
    fm = (mfast.double() - m64).abs().max().item() / scale
    fv = (vfast.double() - v64).abs().max().item() / prior
    check(bool(torch.isfinite(mfast).all() and torch.isfinite(vfast).all())
          and fm <= C4_SERVE_TOL and fv <= C4_SERVE_TOL,
          f"fast serve {C4_M} queries float32 vs float64 dense: mean "
          f"{fm:.3g} x scale, var {fv:.3g} x prior var <= {C4_SERVE_TOL}; "
          f"vs the float32 dense route: mean "
          f"{(mfast - mean).abs().max().item() / scale:.3g}, var "
          f"{(vfast - var).abs().max().item() / prior:.3g}")
    # the LML value+grad on the blocked route, its own path: the counts set
    # to 0 just before and read just after (K1 builds the Gram; no K2 or K3:
    # the route is library math, as in the JAX package)
    cfg_b = dataclasses.replace(cfg, cholesky_method="blocked")
    k1.launches = k2.launches = k3.launches = 0
    ll_b, g_b = value_and_grad(theta, data, cfg_b)
    ll_b = ll_b.item()
    torch.cuda.synchronize()
    launches_blocked = {"pairwise_covariance": k1.launches,
                        "cholesky": k2.launches, "panel_factor": k3.launches}
    check(launches_blocked == {"pairwise_covariance": 1, "cholesky": 0,
                               "panel_factor": 0},
          f"config-4 blocked path (one value+grad) launches "
          f"{launches_blocked}: K1 = 1 Gram, no K2 / K3")
    evb = abs(ll_b - ll64) / abs(ll64)
    egb = (flat(g_b) - g64).abs().max().item() / g64max
    check(np.isfinite(ll_b) and evb <= C4_LML_RTOL and egb <= C4_GRAD_RTOL,
          f"blocked route: LML float32 {ll_b:.8g} vs float64: {evb:.3g} x "
          f"|ll64| <= {C4_LML_RTOL}; gradient {egb:.3g} x max|g64| <= "
          f"{C4_GRAD_RTOL}")
    del g_b
    times["value_grad_blocked"] = host_ms(
        lambda: value_and_grad(theta, data, cfg_b), iters=2)
    times["fast_inverse"] = host_ms(lambda: gp.fast_predictor_from_state(st),
                                    iters=2)
    times["fast_predict"] = host_ms(
        lambda: gp.predict_fast(fp, theta, data, Xs, cfg), iters=2)
    profile_once("predict_fast", lambda: gp.predict_fast(
        fp, theta, data, Xs, cfg), times["fast_predict"], smi)
    del fp, mfast, vfast
    launches_tiers = _config4_tiers(dev, data, data64, cfg, times, check, smi)

    # 3. times of the path's calls, after the counted run; the value+grad
    # memory peak with no serve state alive
    # one LBFGS step: the fit's wall after its first (start) evaluation,
    # which also pays the allocator's growth to the batch of 2 restarts
    times["fit_step"] = ((res.stats["fit_wall_s"] - res.stats["first_vg_wall_s"])
                         * 1e3 / max(1, res.stats["n_steps"]))
    times["predict"] = host_ms(
        lambda: gp.predict_from_precomputed(st, theta, data, Xs, cfg),
        iters=2)
    profile_once("predict", lambda: gp.predict_from_precomputed(
        st, theta, data, Xs, cfg), times["predict"], smi)
    del st
    times["precompute"] = host_ms(
        lambda: gp.precompute_predictor_safe(theta, data, cfg), iters=2)
    with torch.no_grad():
        times["value"] = host_ms(
            lambda: gp.log_marginal_likelihood(theta, data, cfg), iters=2)
    times["value_grad"] = host_ms(lambda: value_and_grad(theta, data),
                                  iters=2)
    torch.cuda.reset_peak_memory_stats(dev)
    value_and_grad(theta, data)
    torch.cuda.synchronize()
    vg_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for what, t in times.items():
        print(f"config4 time {what}: {t:.3f} ms ({smi})")
    gram_b = bound_ms(4 * (C4_N * C4_D + 2 + C4_N * C4_N),
                      C4_N * C4_N * (3 * C4_D + 3))
    fact_b = bound_ms(4 * (C4_N * (C4_N + 1) / 2 + C4_N * C4_N),
                      C4_N ** 3 / 3)
    print(f"config4 bounds: Gram {gram_b[0]:.4f} ms ({gram_b[1]}), "
          f"factorization {fact_b[0]:.3f} ms ({fact_b[1]})")
    print(f"config4 factor N={C4_N} block 512: blocked 'highest' "
          f"{times['factor_blocked_highest']:.3f} ms, 'high' "
          f"{times['factor_blocked_high']:.3f} ms; K3 route "
          f"{times['factor_pallas_512']:.3f} ms; cholesky_ex "
          f"{times['factor_cholesky_ex']:.3f} ms; bound {fact_b[0]:.3f} ms "
          f"({fact_b[1]}) ({smi})")
    print(f"config4 value+grad peak device memory {vg_peak_gib:.2f} GiB "
          f"({smi})")
    C = kernels.gram_matrix(data.X, theta, cfg)
    profile_once("factor_pallas_512", lambda: linalg.left_cholesky(
        C, block=512, diag="pallas"), times["factor_pallas_512"], smi)
    del C
    profile_once("value_grad", lambda: value_and_grad(theta, data),
                 times["value_grad"], smi)
    require(not failed, f"config4: {len(failed)} checks failed: {failed}")
    return launches, launches_fast, launches_tiers, launches_blocked


def _ll_from_factor(L: torch.Tensor, y: torch.Tensor) -> float:
    """-0.5 y^T A^-1 y - sum log diag L for A = L L^T, in float64: the
    likelihood's factor-dependent terms."""
    L = L.double()
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return (-0.5 * (z * z).sum() - torch.log(torch.diagonal(L)).sum()).item()


def _tier_table(dev, seed: int, smi: str, check) -> None:
    """left_cholesky (K3 panels, block 512) at each update tier on float32
    SPD matrices Q diag(lambda) Q^T of N=TIER_N with lambda log-spaced over
    [1, cond]: factor and likelihood-term error against the float64 factor
    of the same float32 matrix, and wall. The "high" tier at the largest
    condition bound `choose_update_precision` routes to it must stay inside
    the "highest" tier's accuracy gate."""
    from madaiemulator_tpu_torch.ops import linalg

    # each tier's GEMM on a sum of squares a a^T against float64: the max
    # error over max|a a^T| and the mean signed error of the diagonal (the
    # history product's own diagonal is such a sum) over its mean
    ga = torch.Generator(device=dev).manual_seed(seed + 1)
    for k in (512, 4096, 16384):
        a = torch.randn(512, k, generator=ga, device=dev)
        want = a.double() @ a.double().mT
        errs = []
        for tier in linalg.TIERS[::-1]:
            e = linalg.matmul_tier(a, a.mT, tier).double() - want
            errs.append(f"{tier!r} max {(e.abs().max() / want.abs().max()).item():.3g}"
                        f", mean diagonal {(e.diagonal().mean() / want.diagonal().mean()).item():.3g}")
        print(f"tier GEMM a a^T, a (512, {k}) float32, vs float64: "
              + "; ".join(errs) + f" ({smi})")
    gen = torch.Generator(device=dev).manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(TIER_N, TIER_N, generator=gen,
                                       device=dev, dtype=torch.float64))
    y = torch.randn(TIER_N, generator=gen, device=dev, dtype=torch.float64)
    for cond in TIER_CONDS:
        lam = torch.logspace(0.0, float(np.log10(cond)), TIER_N, device=dev,
                             dtype=torch.float64)
        A32 = ((Q * lam) @ Q.mT).float()
        A32 = 0.5 * (A32 + A32.mT)
        A64 = A32.double()
        ev = torch.linalg.eigvalsh(A64)
        L64 = torch.linalg.cholesky(A64)
        ll64 = _ll_from_factor(L64, y)
        l64max = L64.abs().max().item()
        for tier in linalg.TIERS[::-1]:
            L = linalg.left_cholesky(A32, block=512, update_precision=tier,
                                     diag="pallas")
            ef = (L.double() - L64).abs().max().item() / l64max
            el = abs(_ll_from_factor(L, y) - ll64) / abs(ll64)
            wall = host_ms(lambda t=tier: linalg.left_cholesky(
                A32, block=512, update_precision=t, diag="pallas"), iters=3)
            print(f"tier table N={TIER_N} cond {cond:.0e} (float32 matrix: "
                  f"{(ev[-1] / ev[0]).item():.3g}) tier {tier!r}: factor vs "
                  f"float64 {ef:.3g} x max|L|, likelihood terms "
                  f"{el:.3g} x |ll64|, wall {wall:.3f} ms ({smi})")
            if tier == "high" and cond <= linalg.HIGH_TIER_KAPPA_MAX:
                check(ef <= TIER_GATE,
                      f"tier 'high' (3xTF32) at cond {cond:.0e} <= the "
                      f"'high' threshold {linalg.HIGH_TIER_KAPPA_MAX:.0e}: "
                      f"factor {ef:.3g} x max|L| <= {TIER_GATE} (the "
                      f"threshold stands)")
            if tier == "highest" and cond <= 1e5:
                check(ef <= TIER_GATE,
                      f"tier 'highest' at cond {cond:.0e}: factor {ef:.3g} "
                      f"x max|L| <= {TIER_GATE}")
            del L
        del A32, A64, L64


def _config4_tiers(dev, data, data64, cfg, times: dict, check,
                   smi: str) -> dict:
    """Config 4 at each update tier, at a theta where "auto" picks "high"
    (amp 1, nugget 2, length scales 0.5: kappa bound ~8.2e3): the counted
    path (one LML value+grad a tier, the counts set to 0 just before and
    read just after), then each tier's factor and value+grad against
    float64, their walls, and the Cinv GEMM's share of the value+grad."""
    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    def at(dtype, nugget):
        return kernels.GPParams(
            log_amp=torch.zeros((), device=dev, dtype=dtype),
            log_nugget=torch.log(torch.tensor(nugget, device=dev,
                                              dtype=dtype)),
            log_ls=torch.log(torch.full((C4_D,), 0.5, device=dev,
                                        dtype=dtype)))

    auto = dataclasses.replace(cfg, cholesky_update_precision="auto")
    picks = {nug: gp.resolve_update_precision(at(torch.float32, nug), C4_N,
                                              auto).cholesky_update_precision
             for nug in (1e-2, 2.0)}
    check(picks == {1e-2: "highest", 2.0: "high"},
          f"'auto' at N={C4_N}: nugget 1e-2 (kappa bound "
          f"{linalg.gp_kappa_bound(C4_N, 1.0, 1e-2):.3g}) -> {picks[1e-2]!r},"
          f" nugget 2 (kappa bound {linalg.gp_kappa_bound(C4_N, 1.0, 2.0):.3g}"
          f") -> {picks[2.0]!r}; threshold {linalg.HIGH_TIER_KAPPA_MAX:.3g}")
    theta, theta64 = at(torch.float32, 2.0), at(torch.float64, 2.0)

    def value_and_grad(p, d, c):
        p = kernels.GPParams(*(a.detach().requires_grad_() for a in p))
        ll = gp.log_marginal_likelihood(p, d, c)
        return ll.detach(), torch.autograd.grad(ll, p)

    def flat(g):
        return torch.cat([a.reshape(-1).double() for a in g])

    cfgs = {t: dataclasses.replace(cfg, cholesky_update_precision=t)
            for t in linalg.TIERS}
    k1.launches = k2.launches = k3.launches = 0
    vg = {t: value_and_grad(theta, data, cfgs[t]) for t in cfgs}
    torch.cuda.synchronize()
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    panels = C4_N // cfg.cholesky_block
    check(launches == {"pairwise_covariance": 3, "cholesky": 0,
                       "panel_factor": 3 * panels},
          f"config-4 tier path (one value+grad at each of 3 tiers) launches "
          f"{launches}: K1 = 3 Grams, K3 = 3 x {panels} panels")
    ll64, g64 = value_and_grad(theta64, data64, cfg)
    ll64, g64 = ll64.item(), flat(g64)
    C = kernels.gram_matrix(data.X, theta, cfg)
    L64 = torch.linalg.cholesky(C.double())
    l64max = L64.abs().max().item()
    for t in linalg.TIERS[::-1]:
        L = linalg.left_cholesky(C, block=cfg.cholesky_block,
                                 update_precision=t, diag="pallas")
        ef = (L.double() - L64).abs().max().item() / l64max
        tf = host_ms(lambda: linalg.left_cholesky(
            C, block=cfg.cholesky_block, update_precision=t, diag="pallas"),
            iters=2)
        # the backward's Cinv GEMM at the tier the backward runs it
        bt = "high" if t == "high" else "highest"
        Linv = linalg.tri_inv_block(L, precision=bt)
        del L
        tc = host_ms(lambda: linalg.matmul_tier(Linv.mT, Linv, bt), iters=2)
        del Linv
        tv = host_ms(lambda: value_and_grad(theta, data, cfgs[t]), iters=2)
        ev = abs(vg[t][0].item() - ll64) / abs(ll64)
        eg = (flat(vg[t][1]) - g64).abs().max().item() / g64.abs().max().item()
        times[f"tier_{t}_factor"], times[f"tier_{t}_value_grad"] = tf, tv
        print(f"config4 tier {t!r} at nugget 2 (kappa bound "
              f"{linalg.gp_kappa_bound(C4_N, 1.0, 2.0):.3g}): factor "
              f"{tf:.3f} ms, vs float64 {ef:.3g} x max|L|; LML value+grad "
              f"{tv:.3f} ms, value {ev:.3g} x |ll64|, gradient {eg:.3g} x "
              f"max|g64|; Cinv GEMM ({bt}) {tc:.3f} ms = {tc / tv:.2f} of "
              f"the value+grad ({smi})")
        if t != "default":
            check(ef <= TIER_GATE and ev <= TIER_GATE,
                  f"tier {t!r} at nugget 2: factor {ef:.3g} x max|L|, LML "
                  f"{ev:.3g} x |ll64| <= {TIER_GATE}")
    for t in ("highest", "high"):
        L = linalg.blocked_cholesky_opt(C, block=cfg.cholesky_block,
                                        update_precision=t)
        ef = (L.double() - L64).abs().max().item() / l64max
        del L
        check(ef <= TIER_GATE,
              f"blocked route tier {t!r} at nugget 2: factor vs float64 "
              f"{ef:.3g} x max|L| <= {TIER_GATE} ({smi})")
    return launches


def _latents(X, k_lat: int = 4):
    """bench/bench_multivariate.py's latent response surfaces, (n, k_lat)."""
    d = X.shape[1]
    return np.stack(
        [np.sin(2.5 * X[:, i % d] + 0.7 * i) + (X[:, (i + 1) % d] - 0.4) ** 2
         for i in range(k_lat)], axis=1)


def _heavy_ion_like(rng, n, d, t, with_simulator=False):
    """bench/bench_multivariate.py:24-38: a few latent response surfaces
    mixed into t correlated observables; with_simulator also returns the
    noiseless simulator f(X) = latents(X) @ mix of this draw."""
    X = rng.uniform(size=(n, d))
    k_lat = 4
    mix = rng.standard_normal((k_lat, t)) * np.geomspace(1.0, 0.2, k_lat)[:, None]
    Y = _latents(X, k_lat) @ mix + 0.01 * rng.standard_normal((n, t))
    if with_simulator:
        return X, Y, lambda A: _latents(A, k_lat) @ mix
    return X, Y


def _workdir(work):
    """`work` (a directory that outlives the phase, so a later phase can
    read its files) as a context, or a temporary directory."""
    if work is None:
        return tempfile.TemporaryDirectory()
    pathlib.Path(work).mkdir(parents=True, exist_ok=True)
    return contextlib.nullcontext(str(work))


def _run_cli(args):
    return _run_clis({"cli": args})["cli"][:3]


def _run_clis(runs: dict) -> dict:
    """The CLI invocations of `runs` ({name: argv}) started together and
    each waited for: {name: (rc, stdout, stderr, wall seconds)}. A CLI
    process spends most of its wall starting (12-19 s each on the slowest
    host seen), so independent ones overlap."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "madaiemulator_tpu_torch.cli"] + argv,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in runs.items()}
    out = {}
    try:
        for name, proc in procs.items():
            so, se = proc.communicate(timeout=600)
            out[name] = (proc.returncode, so, se, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _goldens_estimate(dev) -> None:
    """BASELINE configs 1 and 2 (tools/make_goldens.py's settings) fitted at
    float64 on the card from the golden model files: each component's best
    logL beside the golden state.txt thetas scored by the port's float64
    LML (reported, not gated: other restarts than the golden fit's)."""
    from madaiemulator_tpu_torch.io.modelfile import read_model_file
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.models.multivariate import fit_multivariate
    from madaiemulator_tpu_torch.utils.config import CovarianceFamily, GPConfig

    cases = {
        "sin1d_powerexp": dict(covariance=CovarianceFamily.POWER_EXPONENTIAL,
                               n_restarts=4, max_opt_steps=80),
        "scalar4d_matern32": dict(covariance=CovarianceFamily.MATERN32,
                                  n_restarts=4, max_opt_steps=60),
    }
    for name, kw in cases.items():
        d = ROOT / "tests" / "golden" / name
        mf = read_model_file(str(d / "model.txt"))
        cfg = GPConfig(nparams=mf.nparams, regression_order=1, **kw)
        t0 = time.perf_counter()
        emu = fit_multivariate(
            torch.Generator().manual_seed(0),
            torch.tensor(mf.X, dtype=torch.float64, device=dev),
            torch.tensor(mf.Y, dtype=torch.float64, device=dev), cfg,
            pca_variance=0.99)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gold, _, _ = read_snapshot(str(d / "state.txt"), device=dev,
                                   dtype=torch.float64, build_states=False)
        with torch.no_grad():
            ll_gold = gp.log_marginal_likelihood(
                gold.params, gp.GPData(X=gold.X, y=gold.Z.mT), cfg)
        best = emu.restart_log_likelihoods.amax(dim=1)
        print(f"config {name}: estimate_thetas float64 on the card "
              f"({kw['n_restarts']} restarts x {kw['max_opt_steps']} steps, "
              f"{wall:.2f} s): best logL {best.tolist()} vs the golden "
              f"thetas' {ll_gold.tolist()} (port float64 LML)")


def phase_config3(dev, seed: int, smi: str, work=None) -> dict:
    """BASELINE config 3 at full width through estimate_thetas' path:
    model file -> scaling + PCA -> one lock-step LBFGS over (components x
    restarts) on K1 + K2 -> serve states; against a float64 fit from the
    same restarts; then the CLI (estimate_thetas, print_thetas,
    interactive_mode) as subprocesses; times and profiles."""
    from madaiemulator_tpu_torch.io.modelfile import (
        read_model_file,
        write_model_file,
    )
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
        fit_multivariate,
        predict_multivariate,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.utils.config import GPConfig

    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"config3 check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    rng = np.random.default_rng(seed)
    X, Y = _heavy_ion_like(rng, C3_N, C3_D, C3_T)
    cfg = GPConfig(nparams=C3_D, regression_order=1, n_restarts=C3_R,
                   max_opt_steps=C3_STEPS)
    with _workdir(work) as tmp:
        model = str(pathlib.Path(tmp) / "model.txt")
        write_model_file(model, X, Y)
        mf = read_model_file(model)
        pnames, onames = mf.param_names, mf.output_names

        def fit_at(dtype, config):
            t0 = time.perf_counter()
            emu = fit_multivariate(
                torch.Generator().manual_seed(seed),
                torch.tensor(mf.X, dtype=dtype, device=dev),
                torch.tensor(mf.Y, dtype=dtype, device=dev), config,
                pca_variance=C3_PCA)
            torch.cuda.synchronize()
            return emu, time.perf_counter() - t0

        # the main path, with the launch counts set to 0 just before it and
        # read just after: fit_multivariate at float32 on the kernels
        k1.launches = k2.launches = 0
        emu, wall = fit_at(torch.float32, cfg)
        launches = {"pairwise_covariance": k1.launches,
                    "cholesky": k2.launches}
        st = emu.fit_stats
        r = emu.n_components
        n_evals = st["n_vg_calls"] + st["n_v_calls"]
        print(f"config3: N={C3_N} d={C3_D} t={C3_T} -> r={r} components "
              f"(PCA {C3_PCA}), {C3_R} restarts x {C3_STEPS} steps = "
              f"{r * C3_R} lanes; fit_multivariate float32 {wall:.3f} s wall "
              f"({smi}); stats {st}")
        # each objective evaluation is one batched likelihood over the
        # lanes: one K1 Gram and one K2 factorization; the serve precompute
        # adds one of each
        check(launches == {"pairwise_covariance": n_evals + 1,
                           "cholesky": n_evals + 1},
              f"fit path launches {launches} = {n_evals} objective "
              f"evaluations ({st['n_vg_calls']} value+grad, "
              f"{st['n_v_calls']} value) + 1 serve precompute each")
        lls32 = emu.restart_log_likelihoods
        check(bool(torch.isfinite(lls32).all()) and bool(emu.states.ok.all()),
              f"float32 fit: every restart finite, serve states SPD; best "
              f"logL {lls32.amax(dim=1).tolist()}")

        # the same fit at float64 on the library path, same restarts, of the
        # same function: the float32 jitter floor set explicitly
        jit32 = kernels.effective_jitter_frac(C3_N, torch.float32, cfg)
        cfg64 = dataclasses.replace(cfg, jitter=jit32)
        emu64, wall64 = fit_at(torch.float64, cfg64)
        print(f"config3: fit_multivariate float64 (library) {wall64:.3f} s "
              f"wall; stats {emu64.fit_stats}")
        check(emu64.n_components == r, f"float64 PCA keeps r={r}")
        best64 = emu64.restart_log_likelihoods.amax(dim=1)
        p32 = kernels.GPParams(*(a.double() for a in emu.params))
        d64 = gp.GPData(X=emu64.X, y=emu64.Z.mT)
        with torch.no_grad():
            ll_at32 = gp.log_marginal_likelihood(p32, d64, cfg64)
        short = ((best64 - ll_at32) / best64.abs()).tolist()
        check(all(x <= C3_LL_RTOL for x in short),
              f"float32 best thetas scored by the float64 LML "
              f"{ll_at32.tolist()} vs the float64 fit's best "
              f"{best64.tolist()}: short by {short} x |best| <= {C3_LL_RTOL}"
              f"; the float32 LML at those thetas "
              f"{lls32.amax(dim=1).tolist()}")

        # serving: the float32 emulator against a float64 one at the same
        # thetas and data, with the float32 jitter floor on both; the
        # float32 library route beside it as the control
        arrays = dict(
            mins=emu.scaling.mins, ranges=emu.scaling.ranges, X=emu.X,
            Z=emu.Z, ymean=emu.pca.ymean, ystd=emu.pca.ystd,
            eigenvalues=emu.pca.eigenvalues, U=emu.pca.U,
            log_amp=emu.params.log_amp, log_nugget=emu.params.log_nugget,
            log_ls=emu.params.log_ls)
        arrays = {k: v.double().cpu().numpy() for k, v in arrays.items()}
        ref = emulator_from_numpy(arrays, cfg64, device=dev,
                                  dtype=torch.float64)
        lib32 = emulator_from_numpy(
            arrays, dataclasses.replace(cfg, gram_method="xla",
                                        cholesky_method="xla"),
            device=dev, dtype=torch.float32)
        lo, hi = X.min(0), X.max(0)
        queries = lo + (hi - lo) * rng.uniform(size=(C3_M, C3_D))
        mean, var = predict_multivariate(emu, queries)
        m64, v64 = predict_multivariate(ref, queries)
        ml, vl = predict_multivariate(lib32, queries)
        scale = max(1.0, m64.abs().max().item())
        pv = _prior_var(ref)
        dm = (mean.double() - m64).abs().max().item() / scale
        dv = (var.double() - v64).abs().max().item() / pv
        dml = (ml.double() - m64).abs().max().item() / scale
        dvl = (vl.double() - v64).abs().max().item() / pv
        print(f"config3 serve controls at the fitted thetas: float32 library "
              f"route vs float64 mean {dml:.3g} x scale, var {dvl:.3g} x "
              f"prior var; kernels vs library route (both float32) mean "
              f"{(mean - ml).abs().max().item() / scale:.3g} x scale; nugget "
              f"/ amp {(emu.params.log_nugget - emu.params.log_amp).exp().tolist()}")
        check(mean.shape == (C3_M, C3_T) and dm <= C3_SERVE_MEAN_TOL
              and dv <= SLICE_F32_TOL,
              f"predict {C3_M} queries float32 vs float64 at the same thetas "
              f"(jitter {jit32:.3g} x amp on both): mean {dm:.3g} x scale <= "
              f"{C3_SERVE_MEAN_TOL}, var {dv:.3g} x prior var <= "
              f"{SLICE_F32_TOL} (the float32 library route, not gated: "
              f"{dml:.3g}, {dvl:.3g})")

        # the CLI on the card, as a user runs it
        state = str(pathlib.Path(tmp) / "state.txt")
        t0 = time.perf_counter()
        rc, _, err = _run_cli(
            ["estimate_thetas", model, state, "--dtype", "float32",
             "--device", "cuda", "--regression_order", "1", "--restarts",
             str(C3_R), "--steps", str(C3_STEPS), "--pca_variance",
             str(C3_PCA), "--seed", str(seed)])
        cli_wall = time.perf_counter() - t0
        check(rc == 0 and pathlib.Path(state).exists(),
              f"CLI estimate_thetas --dtype float32 exit {rc} in "
              f"{cli_wall:.2f} s (process start included); stderr: "
              f"{err.strip()!r}")
        rc, out, err = _run_cli(["print_thetas", state])
        check(rc == 0 and out.startswith(f"# {r} component(s)")
              and len(out.splitlines()) == r + 1,
              f"CLI print_thetas exit {rc}: {out.splitlines()[:2]}")
        if pathlib.Path(state).exists():
            served_emu, _, _ = read_snapshot(state, device=dev,
                                             dtype=torch.float32)
            dtheta = max((a - b).abs().max().item() for a, b in
                         zip(served_emu.params, emu.params))
            print(f"config3: CLI fit vs in-process fit, max |d log theta| "
                  f"{dtheta:.3g} (not gated)")
            batches = [queries[:1], queries[1:64], queries]
            header = ([f"{C3_D}\n"] + [f"{x}\n" for x in pnames]
                      + [f"{2 * C3_T}\n"] + [f"mean_{x}\n" for x in onames]
                      + [f"variance_{x}\n" for x in onames])
            served = _serve_over_pipe(state, batches, C3_D, C3_T, header)
            want = np.concatenate(
                [torch.cat(predict_multivariate(served_emu, b), dim=1)
                 .cpu().double().numpy() for b in batches])
            sm = np.abs(served[:, :C3_T] - want[:, :C3_T]).max() / scale
            sv = np.abs(served[:, C3_T:] - want[:, C3_T:]).max() / pv
            check(sm <= SERVER_TOL and sv <= SERVER_TOL,
                  f"interactive_mode on the new snapshot vs in-process "
                  f"predictions: mean {sm:.3g} x scale, var {sv:.3g} x "
                  f"prior var <= {SERVER_TOL}")

    # times: the fit, one value+grad over the lanes, K2 at the lane batch
    print(f"config3 time fit_multivariate float32: {wall:.3f} s; "
          f"{n_evals / st['n_steps']:.2f} objective evaluations per LBFGS "
          f"step ({st['linesearch_evals']} linesearch evaluations over "
          f"{st['n_steps']} steps) ({smi})")
    lanes = r * C3_R
    lo_b, hi_b = fit._bounds_arrays(cfg, torch.float32, dev)
    y = emu.Z.mT[:, None, :].expand(r, C3_R, C3_N).reshape(lanes, C3_N)
    counts = fit._new_stats()
    vg, _ = fit._lane_objective(emu.X, y, None, cfg, lo_b, hi_b, counts)
    best_u = fit._params_to_u(emu.params, lo_b, hi_b)
    u = torch.cat([best_u.log_amp[:, None], best_u.log_nugget[:, None],
                   best_u.log_ls], 1).repeat_interleave(C3_R, 0)
    vg_ms = host_ms(lambda: vg(u), iters=10)
    print(f"config3 time value+grad over {lanes} lanes: {vg_ms:.3f} ms wall "
          f"({smi})")
    profile_once("value_grad", lambda: vg(u), vg_ms, smi, cell="config3")
    print(f"config3 fit wall split: {n_evals} objective evaluations x "
          f"{vg_ms:.3f} ms = {n_evals * vg_ms / 1e3:.3f} s of the "
          f"{wall:.3f} s fit; the rest is the lock-step optimizer's own "
          f"launches and syncs ({smi})")
    # K2 at the fit's lane batch (and the cluster size the fit runs it at)
    # against its plain version and float64 on the same input
    from madaiemulator_tpu_torch.ops.hopper import build

    A = _gram_batch(rng, lanes, C3_N, 1e-3, dev)
    L, Lp = k2.cholesky(A), k2.cholesky_plain(A)
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    scale = L64.abs().max().item()
    e64 = (L.double() - L64).abs().max().item()
    ep = (L - Lp).abs().max().item()
    csize = build.load().madai_cluster_size(lanes, C3_N)
    check(torch.equal(L, torch.tril(L)) and e64 <= K2_RTOL * scale
          and ep <= K2_RTOL * scale,
          f"K2 at the fit's ({lanes},{C3_N},{C3_N}), cluster size {csize}: "
          f"lower triangular; max_abs_err vs plain {ep:.3g}, vs float64 "
          f"{e64:.3g} <= {K2_RTOL} x max|L| {scale:.3g}")
    k2_fit = {"B": lanes, "n": C3_N, "cluster_size": csize,
              "max_abs_err": ep, "max_abs_err_f64": e64,
              "ms": cuda_ms(lambda: k2.cholesky(A)),
              "graph_ms": graph_ms(lambda: k2.cholesky(A)),
              "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(A)),
              "library_graph_ms": graph_ms(
                  lambda: torch.linalg.cholesky_ex(A))}
    k2_fit["bound_ms"], k2_fit["bound_by"] = bound_ms(
        4 * (lanes * C3_N * (C3_N + 1) / 2 + lanes * C3_N * C3_N),
        lanes * C3_N ** 3 / 3)
    print(f"config3 K2 ({lanes},{C3_N},{C3_N}): kernel {k2_fit['ms']:.4f} ms "
          f"(device, CUDA graph: {k2_fit['graph_ms']:.4f} ms), "
          f"torch.linalg.cholesky_ex {k2_fit['library_ms']:.4f} ms (graph "
          f"{k2_fit['library_graph_ms']:.4f} ms), bound "
          f"{k2_fit['bound_ms']:.5f} ms ({k2_fit['bound_by']}) ({smi})")
    _goldens_estimate(dev)
    require(not failed, f"config3: {len(failed)} checks failed: {failed}")
    return launches, k2_fit


def _c5_data(seed: int, dev):
    """BASELINE config 5 as bench/bench_ensemble.py:42-49 and :85 draw it:
    X uniform in [0, 1]^(E, N, d), one frequency per member from U(1, 4),
    y = sin(f x0) + x1^2, then the queries, all float32, from numpy."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(C5_E, C5_N, C5_D)).astype(np.float32)
    f = rng.uniform(1.0, 4.0, size=(C5_E, 1)).astype(np.float32)
    y = (np.sin(f * X[..., 0]) + X[..., 1] ** 2).astype(np.float32)
    Xs = rng.uniform(size=(C5_E, C5_M, C5_D)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return t(X), t(y), t(Xs)


def _c5_kernel(name, kern, plain, library, nbytes, flops, err, smi):
    """Times of one kernel call at a config-5 shape beside its plain
    version and the library call, and its bound: CUDA events over
    back-to-back calls, and the device time from a CUDA graph."""
    t = {"ms": cuda_ms(kern), "graph_ms": graph_ms(kern),
         "plain_ms": cuda_ms(plain, iters=3, warmup=1),
         "library_ms": cuda_ms(library),
         "library_graph_ms": graph_ms(library), "max_abs_err": err}
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
    print(f"config5 {name}: kernel {t['ms']:.4f} ms (device, CUDA graph: "
          f"{t['graph_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library "
          f"{t['library_ms']:.4f} ms (graph {t['library_graph_ms']:.4f} ms), "
          f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}); "
          f"{t['bound_ms'] / t['graph_ms']:.2f} of the bound ({smi})")
    return t


def phase_config5(dev, seed: int, smi: str) -> tuple:
    """BASELINE config 5 at full width through the ensemble entry points:
    fit_ensemble (E x R lanes in one lock-step L-BFGS on K1 + K2) and
    predict_ensemble, float32; K1 and K2 against their plain versions at
    the path's shapes on its own operands, with their times; the float32
    fit and serve against float64; member 0 against a fit of it alone."""
    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.ops.hopper import build
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.parallel import ensemble
    from madaiemulator_tpu_torch.utils.config import GPConfig

    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"config5 check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    E, N, d, R, M = C5_E, C5_N, C5_D, C5_R, C5_M
    X, y, Xs = _c5_data(seed, dev)
    cfg = GPConfig(nparams=d, regression_order=1, n_restarts=R,
                   max_opt_steps=C5_STEPS)

    # the main path, with the launch counts set to 0 just before it and
    # read just after: fit_ensemble, then predict_ensemble
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    res = ensemble.fit_ensemble(torch.Generator().manual_seed(seed), X, y,
                                cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, var = ensemble.predict_ensemble(res.params, X, y, Xs, cfg)
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches}
    st = res.stats
    n_evals = st["n_vg_calls"] + st["n_v_calls"]
    lls = res.log_likelihood
    finite = torch.isfinite(lls).double().mean().item()
    print(f"config5: E={E} members x N={N} in d={d}, power-exponential "
          f"alpha=2, regression_order=1, {R} restarts x {C5_STEPS} steps = "
          f"{E * R} lanes, float32 on K1 + K2; fit_ensemble {wall:.3f} s "
          f"wall = {E / wall:.1f} emulators/s; {n_evals / st['n_steps']:.2f} "
          f"objective evaluations per L-BFGS step ({n_evals}: "
          f"{st['n_vg_calls']} value+grad, {st['n_v_calls']} value; "
          f"{st['linesearch_evals']} linesearch evaluations); "
          f"finite_fraction {finite:.6g}; predict_ensemble {M} queries a "
          f"member {pred_wall * 1e3:.3f} ms = {E * M / pred_wall:.4g} pts/s "
          f"({smi})")
    by_step = st["linesearch_evals_by_step"]
    print(f"config5: linesearch evaluations by step {by_step}")
    # each objective evaluation is one batched likelihood over the E x R
    # lanes: one K1 Gram and one K2 factorization; predict_ensemble adds
    # one Gram + one cross-covariance by K1 and one K2 factorization
    check(launches == {"pairwise_covariance": n_evals + 2,
                       "cholesky": n_evals + 1},
          f"config-5 path launches {launches}: K1 = {n_evals} objective "
          f"evaluations + 2 (predict's Gram and cross), K2 = {n_evals} + 1")
    check(finite >= C5_FINITE and mean.shape == (E, M)
          and bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
          f"finite_fraction {finite:.6g} >= {C5_FINITE}; predictions "
          f"({E}, {M}) finite")

    # one lane-batch value+grad at the thetas each lane's fit ended on:
    # wall, device, busy
    lo, hi = fit._bounds_arrays(cfg, torch.float32, dev)
    Xl = X[:, None].expand(E, R, N, d).reshape(E * R, N, d)
    yl = y[:, None].expand(E, R, N).reshape(E * R, N)
    vg, _ = fit._lane_objective(Xl, yl, None, cfg, lo, hi, fit._new_stats())
    pl = kernels.GPParams(*(a.reshape((E * R,) + a.shape[2:])
                            for a in res.restart_params))
    u = fit._flatten_t(fit._params_to_u(pl, lo, hi))
    vg_ms = host_ms(lambda: vg(u), iters=10)
    print(f"config5 time value+grad over {E * R} lanes: {vg_ms:.3f} ms wall "
          f"({smi}); the fit's {n_evals} evaluations at that wall: "
          f"{n_evals * vg_ms / 1e3:.3f} s of the {wall:.3f} s fit")
    profile_once("value_grad", lambda: vg(u), vg_ms, smi, cell="config5")
    del vg

    # K1 and K2 at the path's shapes, on its own operands: the fit's
    # (E x R, N, N) Grams at the thetas each lane ended on, predict's
    # (E, N, N) Grams and (E, N, M) cross-covariances at each member's best
    fam = "power_exponential"
    jit32 = kernels.effective_jitter_frac(N, torch.float32, cfg)

    def operands(p, Xa):
        amp = torch.exp(p.log_amp)
        return (kernels._scaled(Xa, p, cfg).contiguous(), amp,
                torch.exp(p.log_nugget) + jit32 * amp)

    lib = build.load()
    k1_by, k2_by = {}, {}
    k1_err = k2_err = 0.0
    for label, p, Xa, fitted in (
            (f"({E * R},{N},{N})", pl, Xl,
             torch.isfinite(res.restart_log_likelihoods).reshape(-1)),
            (f"({E},{N},{N})", res.params, X,
             torch.isfinite(res.log_likelihood))):
        U, amp, g = operands(p, Xa)
        B = U.shape[0]
        A = k1.pairwise_covariance(U, U, amp, g, fam, True)
        err = (A - k1.pairwise_covariance_plain(U, U, amp, g, fam, True)
               ).abs().max().item()
        check(err <= K1_ATOL and torch.equal(A, A.mT),
              f"K1 Gram {label} d={d}: max_abs_err vs plain {err:.3g} <= "
              f"{K1_ATOL}; bitwise symmetric")
        k1_err = max(k1_err, err)
        k1_by[f"gram{label}d{d}"] = _c5_kernel(
            f"K1 Gram {label} d={d}",
            lambda: k1.pairwise_covariance(U, U, amp, g, fam, True),
            lambda: k1.pairwise_covariance_plain(U, U, amp, g, fam, True),
            lambda: _k1_composite(U, U, amp, g, True),
            4 * (B * N * d + 2 * B + B * N * N),
            B * N * (N + 1) // 2 * (3 * d + 3), err, smi)
        # K2 on the path's Grams: at the fitted thetas they are as
        # ill-conditioned as the fit made them, so the factors of any two
        # float32 orders differ by up to ~cond x eps (printed); the gate is
        # each factor's backward error max|L L^T - A| / max|A|. K2 factored
        # each of these Grams during the fit wherever the lane's LML was
        # finite; a lane whose fit never was may end on a Gram that is not
        # SPD at float32, and the errors are taken where all three factors
        # are finite.
        L, Lp = k2.cholesky(A), k2.cholesky_plain(A)
        L64 = linalg.xla_cholesky(A.double())
        ok = linalg.chol_ok(L)
        sel = ok & linalg.chol_ok(Lp) & linalg.chol_ok(L64)
        Ls, Lps, L64s, As = L[sel], Lp[sel], L64[sel], A[sel]
        scale = L64s.abs().max().item()
        ep = (Ls - Lps).abs().max().item()
        e64 = (Ls.double() - L64s).abs().max().item()
        res_k, res_p = (((F.double() @ F.double().mT - As.double()).abs()
                         .amax(dim=(1, 2)) / As.abs().amax(dim=(1, 2)))
                        .max().item() for F in (Ls, Lps))
        bits = L.view(torch.int32)
        repeat = all(torch.equal(k2.cholesky(A).view(torch.int32), bits)
                     for _ in range(19))
        csize = lib.madai_cluster_size(B, N)
        check(bool((ok | ~fitted).all()) and torch.equal(Ls, torch.tril(Ls))
              and res_k <= C5_K2_RESIDUAL and repeat,
              f"K2 {label} on the path's Grams, cluster size {csize}: every "
              f"Gram whose lane reached a finite LML factored "
              f"({int((~ok).sum())} not, {int((~fitted).sum())} lanes never "
              f"finite; {int(sel.sum())} compared); lower triangular; "
              f"backward error max|LL^T - A| / max|A| {res_k:.3g} <= "
              f"{C5_K2_RESIDUAL} (plain version {res_p:.3g}); 20 calls "
              f"bitwise equal; not gated (conditioning): vs plain {ep:.3g}, "
              f"vs float64 {e64:.3g} x max|L| {scale:.3g}")
        # and at the same shape on well-conditioned Grams (nugget 0.1)
        Aw = _gram_batch(np.random.default_rng([seed, B]), B, N, 0.1, dev,
                         d=d)
        Lw, Lwp = k2.cholesky(Aw), k2.cholesky_plain(Aw)
        Lw64 = torch.linalg.cholesky(Aw.double())
        wscale = Lw64.abs().max().item()
        ew = (Lw - Lwp).abs().max().item()
        ew64 = (Lw.double() - Lw64).abs().max().item()
        check(torch.equal(Lw, torch.tril(Lw)) and ew <= K2_RTOL * wscale
              and ew64 <= K2_RTOL * wscale,
              f"K2 {label} on well-conditioned Grams (nugget 0.1): "
              f"max_abs_err vs plain {ew:.3g}, vs float64 {ew64:.3g} <= "
              f"{K2_RTOL} x max|L| {wscale:.3g}")
        k2_err = max(k2_err, ew)
        k2_by[label] = _c5_kernel(
            f"K2 {label} (cluster size {csize})", lambda: k2.cholesky(A),
            lambda: k2.cholesky_plain(A),
            lambda: torch.linalg.cholesky_ex(A),
            4 * (B * N * (N + 1) / 2 + B * N * N), B * N ** 3 / 3, ew, smi)
        k2_by[label].update(
            cluster_size=csize, max_abs_err_f64=ew64,
            path_max_abs_err=ep, path_max_abs_err_f64=e64,
            path_residual=res_k, path_residual_plain=res_p)
        del A, L, Lp, L64, Ls, Lps, L64s, As, Aw, Lw, Lwp, Lw64
    U, amp, _ = operands(res.params, X)
    V = kernels._scaled(Xs, res.params, cfg).contiguous()
    K = k1.pairwise_covariance(U, V, amp, None, fam)
    err = (K - k1.pairwise_covariance_plain(U, V, amp, None, fam)
           ).abs().max().item()
    check(err <= K1_ATOL, f"K1 cross ({E},{N},{M}) d={d}: max_abs_err vs "
          f"plain {err:.3g} <= {K1_ATOL}")
    k1_err = max(k1_err, err)
    k1_by[f"cross({E},{N},{M})d{d}"] = _c5_kernel(
        f"K1 cross ({E},{N},{M}) d={d}",
        lambda: k1.pairwise_covariance(U, V, amp, None, fam),
        lambda: k1.pairwise_covariance_plain(U, V, amp, None, fam),
        lambda: _k1_composite(U, V, amp, None, False),
        4 * (E * N * d + E * M * d + E + E * N * M), E * N * M * (3 * d + 3),
        err, smi)
    del K, U, V

    # float32 against float64 on the first C5_CHECK members, with the
    # float32 jitter floor on the float64 side too: the float32 best thetas
    # scored by the float64 LML against a float64 fit from the same starts,
    # then serving at the float32 fit's thetas
    c = C5_CHECK
    cfg64 = dataclasses.replace(cfg, jitter=jit32)
    g = torch.Generator().manual_seed(seed)
    draws = [fit.sample_restarts(g, cfg, R, dtype=torch.float32)
             for _ in range(E)][:c]
    u0 = kernels.GPParams(*(torch.stack(a).double().to(dev)
                            for a in zip(*draws)))
    X64, y64 = X[:c].double(), y[:c].double()
    t0 = time.perf_counter()
    r64 = ensemble.fit_ensemble_from_starts(u0, X64, y64, cfg64, C5_STEPS)
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    best64 = r64.log_likelihood

    def score(p):
        """The float64 LML at the first c members' thetas p."""
        p = kernels.GPParams(*(a[:c].double() for a in p))
        with torch.no_grad():
            return gp.log_marginal_likelihood(p, gp.GPData(X=X64, y=y64),
                                              cfg64)

    def shortfall(ll):
        """The float64 fit's best minus ll, over max(1, |best|)."""
        return (best64 - ll) / best64.abs().clamp(min=1.0)

    p32 = kernels.GPParams(*(a[:c].double() for a in res.params))
    ll_at32 = score(p32)
    short = shortfall(ll_at32)
    q = torch.quantile(short, torch.tensor([0.5, 0.99], dtype=short.dtype,
                                           device=dev)).tolist()
    worst, w = short.max().item(), int(short.argmax())
    # control, not gated: the same float32 fit on the library route
    lib = dataclasses.replace(cfg, gram_method="xla", cholesky_method="xla")
    rlib = ensemble.fit_ensemble_from_starts(
        kernels.GPParams(*(a.float() for a in u0)), X[:c], y[:c], lib,
        C5_STEPS)
    slib = shortfall(score(rlib.params))
    over = int((short > 1e-3).sum())
    print(f"config5: float64 fit of the first {c} members from the same "
          f"starts (library) {wall64:.3f} s; best LML median "
          f"{best64.median().item():.6g}; float32 best thetas scored by "
          f"float64 short of it by median {q[0]:.3g}, 99th percentile "
          f"{q[1]:.3g}, max {worst:.3g} x max(1, |best|) ({over} members "
          f"over 1e-3); the float32 fit's own best LML - float64 "
          f"score there: max "
          f"{(lls[:c].double() - ll_at32).abs().max().item():.3g}; the "
          f"float32 library route's fit from the same starts (control): "
          f"median {slib.median().item():.3g}, max {slib.max().item():.3g}")
    def thetas(p):
        return torch.cat([a[w].reshape(-1) for a in p]).exp().tolist()

    print(f"config5: the worst member {w}: float32 best LML "
          f"{lls[w].item():.8g}, float64 LML at its thetas "
          f"{ll_at32[w].item():.8g}, float64 fit's best "
          f"{best64[w].item():.8g}; thetas float32 {thetas(res.params)}, "
          f"float64 {thetas(r64.params)}")
    check(q[0] <= C5_LL_MEDIAN_RTOL and worst <= C5_LL_RTOL,
          f"float32 fit vs float64 fit from the same starts ({c} members): "
          f"short by median {q[0]:.3g} <= {C5_LL_MEDIAN_RTOL}, at most "
          f"{worst:.3g} <= {C5_LL_RTOL} x max(1, |best|)")
    m64, v64 = ensemble.predict_ensemble(p32, X64, y64, Xs[:c].double(),
                                         cfg64)
    scale = m64.abs().amax(dim=1).clamp(min=1.0)
    prior = (p32.log_amp.exp() + p32.log_nugget.exp())
    dm = ((mean[:c].double() - m64).abs().amax(dim=1) / scale).max().item()
    dv = ((var[:c].double() - v64).abs().amax(dim=1) / prior).max().item()
    check(dm <= C5_SERVE_TOL and dv <= C5_SERVE_TOL,
          f"predict_ensemble float32 vs float64 at the float32 thetas ({c} "
          f"members x {M} queries): mean {dm:.3g} x the member's mean "
          f"scale, var {dv:.3g} x its prior variance <= {C5_SERVE_TOL}")

    # inside the port: member 0 of the float64 ensemble against
    # fit_one_start on member 0 alone from its own starts
    bu, bv = fit.fit_one_start(kernels.GPParams(*(a[0] for a in u0)),
                               X64[0], y64[0], cfg64, C5_STEPS)
    lo64, hi64 = fit._bounds_arrays(cfg64, torch.float64, dev)
    dll = ((-bv - r64.restart_log_likelihoods[0]).abs()
           / r64.restart_log_likelihoods[0].abs()).max().item()
    dp = max((a - b).abs().max().item() for a, b in zip(
        fit._u_to_params(bu, lo64, hi64),
        (t[0] for t in r64.restart_params)))
    check(dll <= C5_MEMBER_RTOL,
          f"member 0 of the float64 ensemble vs fit_one_start on member 0 "
          f"alone: restart LMLs {dll:.3g} x |LML| <= {C5_MEMBER_RTOL}; "
          f"max |d log theta| {dp:.3g}")
    require(not failed, f"config5: {len(failed)} checks failed: {failed}")
    return launches, {"pairwise_covariance": (k1_err, k1_by),
                      "cholesky": (k2_err, k2_by)}


def _gradient_data(rng):
    """Config 3's recipe (`_heavy_ion_like`) with its closed-form output
    gradients w.r.t. the raw inputs, (N, d, t), and per-point noise
    variances in [0.5e-4, 2e-4] (the recipe's 0.01 noise level) that the
    outputs carry."""
    n, d, t = G_N, G_D, G_T
    X = rng.uniform(size=(n, d))
    k_lat = 4
    mix = rng.standard_normal((k_lat, t)) * np.geomspace(1.0, 0.2,
                                                         k_lat)[:, None]
    lat = np.zeros((n, k_lat))
    dlat = np.zeros((n, d, k_lat))
    for i in range(k_lat):
        a, b = i % d, (i + 1) % d
        lat[:, i] = np.sin(2.5 * X[:, a] + 0.7 * i) + (X[:, b] - 0.4) ** 2
        dlat[:, a, i] += 2.5 * np.cos(2.5 * X[:, a] + 0.7 * i)
        dlat[:, b, i] += 2.0 * (X[:, b] - 0.4)
    noise = rng.uniform(0.5e-4, 2e-4, n)
    Y = lat @ mix + np.sqrt(noise)[:, None] * rng.standard_normal((n, t))
    return X, Y, np.einsum("nak,kt->nat", dlat, mix), noise


def _prior_grad_var(emu) -> float:
    """Largest prior variance of an observable's partial derivative w.r.t. a
    raw input: amp c_g / ell^2 per component, rotated and scaled back."""
    from madaiemulator_tpu_torch.ops import kernels

    p = emu.params
    d = emu.X.shape[1]
    cg = kernels.grad_prior_scale(emu.config)
    ell = kernels._ell_vec(p, emu.config, d)  # (r, d)
    comp = torch.exp(p.log_amp)[:, None] * cg / ell ** 2  # (r, d)
    pca = emu.pca
    w = pca.U ** 2 * pca.eigenvalues[None, :] * (pca.ystd ** 2)[:, None]
    v = torch.einsum("ra,tr->at", comp, w) / emu.scaling.ranges[:, None] ** 2
    return v.max().item()


def phase_gradient(dev, seed: int, smi: str) -> tuple:
    """A gradient-enhanced multivariate emulator at config 3's width
    (N=512 in d=6, t=15 -> r PCs, power-exponential alpha=2,
    regression_order=1, float32), trained on values, gradients and noise:
    the joint Gram has N(1+d) = 3,584 rows, 7 panels at block 512, so
    the fit's r x 4 lanes run K3 at (16, 512, 512) on 7 panels a
    factorization. The main path (fit_multivariate -> serve values and
    gradients) with exact launch counts; K3 against its plain version on
    the path's own panels, timed; the float32 fit scored by float64 against
    a float64 fit from the same restarts; serving against float64; the CLI
    (estimate_thetas --noise_file --gradients_file -> version-3 snapshot ->
    interactive_mode)."""
    from madaiemulator_tpu_torch.io.modelfile import write_model_file
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot, write_snapshot
    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.models.multivariate import (
        _component_batch,
        _vmapped_states,
        fit_multivariate,
        predict_multivariate,
        predict_multivariate_gradient,
    )
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.tools import cluster_skew
    from madaiemulator_tpu_torch.utils.config import GPConfig

    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"gradient check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    rng = np.random.default_rng([seed, 9])
    X, Y, G, noise = _gradient_data(rng)
    cfg = GPConfig(nparams=G_D, regression_order=1, n_restarts=G_R,
                   max_opt_steps=G_STEPS)
    lo, hi = X.min(0), X.max(0)
    queries = lo + (hi - lo) * rng.uniform(size=(G_M, G_D))

    def fit_at(dtype, config):
        t0 = time.perf_counter()
        emu = fit_multivariate(
            torch.Generator().manual_seed(seed),
            *(torch.tensor(a, dtype=dtype, device=dev) for a in (X, Y)),
            config, pca_variance=G_PCA,
            noise=torch.tensor(noise, dtype=dtype, device=dev),
            gradients=torch.tensor(G, dtype=dtype, device=dev))
        torch.cuda.synchronize()
        return emu, time.perf_counter() - t0

    # the main path, the counts set to 0 just before and read just after:
    # the float32 fit on values + gradients + noise, then values and
    # gradients served in-process at 1,024 queries. K3's inputs at the fit's
    # lane batch are kept, the last factorization's, for the K3 check below
    rows = G_N * (1 + G_D)
    panels = -(-rows // cfg.cholesky_block)
    by_batch = {}  # batch size -> the last `panels` K3 inputs of that size
    orig = linalg._panel_factor

    def record(P):
        q = by_batch.setdefault(P.shape[0], collections.deque(maxlen=panels))
        q.append(P.clone())
        return orig(P)

    k1.launches = k2.launches = k3.launches = 0
    linalg._panel_factor = record
    try:
        emu, wall = fit_at(torch.float32, cfg)
    finally:
        linalg._panel_factor = orig
    mean, var = predict_multivariate(emu, queries)
    gmean, gvar = predict_multivariate_gradient(emu, queries)
    torch.cuda.synchronize()
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    st = emu.fit_stats
    r = emu.n_components
    lanes = r * G_R
    n_evals = st["n_vg_calls"] + st["n_v_calls"]
    print(f"gradient: N={G_N} d={G_D} t={G_T} -> r={r} components (PCA "
          f"{G_PCA}), joint rows {rows} -> {panels} panels of "
          f"{cfg.cholesky_block}, {G_R} restarts x {G_STEPS} steps = {lanes} "
          f"lanes; fit_multivariate float32 {wall:.3f} s wall "
          f"({n_evals / st['n_steps']:.2f} objective evaluations per step) "
          f"({smi}); stats {st}")
    # every factorization (the fit's objective evaluations over the lanes,
    # and the serve precompute over the components) is one left-looking
    # factor with one K3 launch per panel; the joint Gram and cross
    # covariances are library math, so K1 and K2 never launch
    check(launches == {"pairwise_covariance": 0, "cholesky": 0,
                       "panel_factor": panels * (n_evals + 1)},
          f"gradient path launches {launches}: K1 = K2 = 0, K3 = {panels} "
          f"panels x ({n_evals} objective evaluations + 1 serve precompute)")
    lls32 = emu.restart_log_likelihoods
    check(bool(torch.isfinite(lls32).all()) and bool(emu.states.ok.all())
          and mean.shape == var.shape == (G_M, G_T)
          and gmean.shape == gvar.shape == (G_M, G_D, G_T)
          and all(bool(torch.isfinite(a).all())
                  for a in (mean, var, gmean, gvar)),
          f"float32 fit: every restart finite, serve states SPD, finite "
          f"values {tuple(mean.shape)} and gradients {tuple(gmean.shape)}; "
          f"best logL {lls32.amax(dim=1).tolist()}")

    # K3 on the path's own panels: those of the fit's last objective
    # evaluation over the lanes
    seen = list(by_batch.get(lanes, ()))
    del by_batch
    eb = ep = ea = ei = 0.0
    for P in seen:
        L, Linv = k3.panel_factor(P)
        Lp, _ = k3.panel_factor_plain(P)
        P64 = P.double()
        eb = max(eb, ((L.double() @ L.double().mT - P64).abs().amax((1, 2))
                      / P64.abs().amax((1, 2))).max().item())
        ep = max(ep, ((L - Lp).abs().amax((1, 2))
                      / Lp.abs().amax((1, 2))).max().item())
        ea = max(ea, (L - Lp).abs().max().item())
        eye = torch.eye(P.shape[-1], dtype=torch.float64, device=dev)
        ei = max(ei, (Linv.double() @ L.double() - eye).abs().max().item())
    check(len(seen) == panels and all(P.shape == (lanes, 512, 512)
                                      for P in seen)
          and eb <= G_K3_RESIDUAL and ep <= G_K3_RTOL and ei <= G_K3_INV,
          f"K3 on the path's {len(seen)} panels of ({lanes},512,512): "
          f"backward error max|LL^T - P| / max|P| {eb:.3g} <= "
          f"{G_K3_RESIDUAL}; vs plain {ep:.3g} x max|L| <= {G_K3_RTOL}; "
          f"max|Linv L - I| {ei:.3g} <= {G_K3_INV}")
    P = seen[0]
    eye = torch.eye(512, device=dev).expand(lanes, 512, 512)

    def library_pair():
        L, _ = torch.linalg.cholesky_ex(P)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    k3_grad = {"B": lanes, "n": 512, "max_abs_err": ea, "rel_err": ep,
               "backward_err": eb, "inv_err": ei,
               "ms": cuda_ms(lambda: k3.panel_factor(P)),
               "graph_ms": graph_ms(lambda: k3.panel_factor(P)),
               "plain_ms": cuda_ms(lambda: k3.panel_factor_plain(P), iters=2,
                                   warmup=1),
               "library_ms": cuda_ms(library_pair),
               "library_graph_ms": graph_ms(library_pair)}
    k3_grad["bound_ms"], k3_grad["bound_by"] = bound_ms(
        4 * (lanes * 512 * 513 / 2 + 2 * lanes * 512 * 512),
        2 * lanes * 512 ** 3 / 3)
    print(f"gradient K3 ({lanes},512,512) on the path's panel 0: kernel "
          f"{k3_grad['ms']:.4f} ms (device, CUDA graph: "
          f"{k3_grad['graph_ms']:.4f} ms), plain {k3_grad['plain_ms']:.4f} "
          f"ms, library pair cholesky_ex + solve_triangular(L, I) "
          f"{k3_grad['library_ms']:.4f} ms (graph "
          f"{k3_grad['library_graph_ms']:.4f} ms), bound "
          f"{k3_grad['bound_ms']:.5f} ms ({k3_grad['bound_by']}) ({smi})")
    del seen, P

    # one objective evaluation over the fit's lanes (value + closed-form
    # gradient, each lane at its component's best theta): wall and profile
    comp = _component_batch(emu.X, emu.Z, emu.noise, emu.dZ)
    lo_b, hi_b = fit._bounds_arrays(cfg, torch.float32, dev)
    vg, _ = fit._lane_objective(
        emu.X, comp.y.repeat_interleave(G_R, 0),
        comp.noise.repeat_interleave(G_R, 0), cfg, lo_b, hi_b,
        fit._new_stats(), dY=comp.dY.repeat_interleave(G_R, 0))
    u = fit._flatten_t(fit._params_to_u(emu.params, lo_b, hi_b))
    u = u.repeat_interleave(G_R, 0)
    vg_ms = host_ms(lambda: vg(u), iters=5)
    print(f"gradient time value+grad over {lanes} lanes: {vg_ms:.3f} ms wall "
          f"({smi})")
    profile_once("value_grad", lambda: vg(u), vg_ms, smi, cell="gradient")

    # the same fit at float64 (library panels) from the same restarts, of
    # the same function: the float32 jitter floor set on both
    jit32 = kernels.effective_jitter_frac(rows, torch.float32, cfg)
    cfg64 = dataclasses.replace(cfg, jitter=jit32)
    emu64, wall64 = fit_at(torch.float64, cfg64)
    check(emu64.n_components == r, f"float64 PCA keeps r={r}")
    best64 = emu64.restart_log_likelihoods.amax(dim=1)
    p32 = kernels.GPParams(*(a.double() for a in emu.params))
    d64 = _component_batch(emu64.X, emu64.Z, emu64.noise, emu64.dZ)
    with torch.no_grad():
        ll_at32 = gp.log_marginal_likelihood(p32, d64, cfg64)
    short = ((best64 - ll_at32) / best64.abs().clamp(min=1.0)).tolist()
    check(all(x <= G_LL_RTOL for x in short),
          f"float32 best thetas scored by the float64 LML {ll_at32.tolist()} "
          f"vs the float64 fit's best {best64.tolist()} ({wall64:.3f} s): "
          f"short by {short} x max(1, |best|) <= {G_LL_RTOL}")

    with tempfile.TemporaryDirectory() as tmp:
        # serving: the float32 emulator's v3 snapshot read at float32 and at
        # float64, values and gradients at the same queries
        state = str(pathlib.Path(tmp) / "state.txt")
        write_snapshot(state, emu)
        # the float32 read serves as a user would (its jitter floor is
        # jit32); the float64 one gets the same floor, the same function
        e32, _, _ = read_snapshot(state, device=dev, dtype=torch.float32)
        # a v3 snapshot has no stateless (matrix-free) form: read it dense
        # at float64, then rebuild the states with the float32 floor
        e64, _, _ = read_snapshot(state, device=dev, dtype=torch.float64)
        e64 = e64._replace(config=dataclasses.replace(e64.config,
                                                      jitter=jit32))
        e64 = e64._replace(states=_vmapped_states(
            e64.params, e64.X, e64.Z, e64.config, e64.noise, e64.dZ,
            e64.dZ_noise))
        m32, v32 = predict_multivariate(e32, queries)
        m64, v64 = predict_multivariate(e64, queries)
        g32, gv32 = predict_multivariate_gradient(e32, queries)
        g64, gv64 = predict_multivariate_gradient(e64, queries)
        scale = max(1.0, m64.abs().max().item())
        gscale = max(1.0, g64.abs().max().item())
        pv, pgv = _prior_var(e64), _prior_grad_var(e64)
        dm = (m32.double() - m64).abs().max().item() / scale
        dv = (v32.double() - v64).abs().max().item() / pv
        dg = (g32.double() - g64).abs().max().item() / gscale
        dgv = (gv32.double() - gv64).abs().max().item() / pgv
        check(max(dm, dg) <= G_SERVE_MEAN_TOL
              and max(dv, dgv) <= G_SERVE_VAR_TOL,
              f"serve the v3 snapshot, {G_M} queries, float32 vs float64 "
              f"(jitter {jit32:.3g} x amp on both): values mean {dm:.3g} x "
              f"scale, var {dv:.3g} x prior var; gradients mean {dg:.3g} x "
              f"scale, var {dgv:.3g} x prior var; means <= "
              f"{G_SERVE_MEAN_TOL}, variances <= {G_SERVE_VAR_TOL}")
        times = {"predict_values": host_ms(
            lambda: predict_multivariate(emu, queries)),
            "predict_gradients": host_ms(
            lambda: predict_multivariate_gradient(emu, queries))}
        print(f"gradient times: predict {G_M} values {times['predict_values']:.3f}"
              f" ms, {G_M} gradients {times['predict_gradients']:.3f} ms "
              f"({smi})")

        # the CLI: model, noise and gradients files -> a v3 snapshot ->
        # interactive_mode over the pipe
        model = str(pathlib.Path(tmp) / "model.txt")
        write_model_file(model, X, Y)
        nfile = str(pathlib.Path(tmp) / "noise.txt")
        np.savetxt(nfile, noise)
        gfile = str(pathlib.Path(tmp) / "grads.txt")
        np.savetxt(gfile, np.transpose(G, (0, 2, 1)).reshape(-1, G_D))
        cstate = str(pathlib.Path(tmp) / "cli_state.txt")
        # the second process that loads the card below sets itself up
        # during the CLI's fit
        load = cluster_skew.CardLoad()
        try:
            t0 = time.perf_counter()
            rc, _, err = _run_cli(
                ["estimate_thetas", model, cstate, "--dtype", "float32",
                 "--device", "cuda", "--regression_order", "1",
                 "--restarts", str(G_R), "--steps", str(G_STEPS),
                 "--pca_variance", str(G_PCA), "--seed", str(seed),
                 "--noise_file", nfile, "--gradients_file", gfile])
            cli_wall = time.perf_counter() - t0
            ok = rc == 0 and pathlib.Path(cstate).exists()
            check(ok and pathlib.Path(cstate).read_text().startswith(
                      "MADAIEMULATOR_TPU_SNAPSHOT 3\n"),
                  f"CLI estimate_thetas --noise_file --gradients_file "
                  f"--dtype float32 exit {rc} in {cli_wall:.2f} s (process "
                  f"start included), a version-3 snapshot; stderr: "
                  f"{err.strip()!r}")
            if ok:
                served_emu, pn, on = read_snapshot(cstate, device=dev,
                                                   dtype=torch.float32)
                batches = [queries[:1], queries[1:64], queries]
                header = ([f"{G_D}\n"] + [f"{x}\n" for x in pn]
                          + [f"{2 * G_T}\n"] + [f"mean_{x}\n" for x in on]
                          + [f"variance_{x}\n" for x in on])
                served = _serve_over_pipe(cstate, batches, G_D, G_T,
                                          header)
                want = np.concatenate(
                    [torch.cat(predict_multivariate(served_emu, b), dim=1)
                     .cpu().double().numpy() for b in batches])
                sm = np.abs(served[:, :G_T] - want[:, :G_T]).max() / scale
                sv = np.abs(served[:, G_T:] - want[:, G_T:]).max() / pv
                check(sm <= SERVER_TOL and sv <= SERVER_TOL,
                      f"interactive_mode on the CLI's v3 snapshot vs "
                      f"in-process: mean {sm:.3g} x scale, var {sv:.3g} x "
                      f"prior var <= {SERVER_TOL}")
                # the same file read and served in process G_LOAD_REPEATS
                # times while a second process runs K1 in a loop on the
                # card: each read factors the joint Gram again (K3 at
                # (r,512,512))
                t0 = time.perf_counter()
                with load:
                    reps = []
                    for _ in range(G_LOAD_REPEATS):
                        e, _, _ = read_snapshot(cstate, device=dev,
                                                dtype=torch.float32)
                        reps.append(torch.cat(predict_multivariate(e, queries),
                                              dim=1))
                same = sum(torch.equal(reps[0], x) for x in reps[1:])
                check(same == G_LOAD_REPEATS - 1,
                      f"read_snapshot of the CLI's v3 snapshot + serving its "
                      f"{G_M} queries, {G_LOAD_REPEATS} times under a card "
                      f"load (K1 in a second process): {same + 1} of "
                      f"{G_LOAD_REPEATS} bitwise equal to the first "
                      f"({time.perf_counter() - t0:.2f} s)")
        finally:
            load.stop()
    require(not failed, f"gradient: {len(failed)} checks failed: {failed}")
    return launches, k3_grad


def _truth64k(A):
    """bench/capability_64k.py's noiseless truth."""
    return np.sin(3 * A[:, 0]) + A[:, 1] ** 2 + 0.5 * np.cos(2 * A[:, 2])


def _iter_data(seed: int, dev):
    """bench/capability_64k.py's data at full width (I_N points in I_D,
    float32) and I_M queries, from numpy with [seed, 10]."""
    from madaiemulator_tpu_torch.models.gp import GPData

    rng = np.random.default_rng([seed, 10])
    Xh = rng.uniform(size=(I_N, I_D)).astype(np.float32)
    yh = (_truth64k(Xh) + I_NOISE * rng.standard_normal(I_N)).astype(
        np.float32)
    Xq = rng.uniform(size=(I_M, I_D)).astype(np.float32)
    return (GPData(X=torch.tensor(Xh, device=dev),
                   y=torch.tensor(yh, device=dev)),
            torch.tensor(Xq, device=dev))


def _iter_k1_checks(dev, X, smi) -> tuple:
    """K1 at the matrix-free path's own shapes (I_K1_SHAPES) on its own
    points scaled by the check length scale (`_k1_path_checks`)."""
    U_all = (X / I_LS)[None].contiguous()  # (1, N, d)
    amp = torch.full((1,), I_AMP, device=dev)
    pairs = []
    for B, n1, n2 in I_K1_SHAPES:
        U = U_all[:, :n1].contiguous()
        V = U_all[:, n1 - n2:n1].contiguous() if n2 < n1 else U_all
        pairs.append((f"cross({B},{n1},{n2})d{I_D}", U, V, amp))
    return _k1_path_checks(dev, pairs, smi, "iterative")


def phase_iterative(dev, seed: int, smi: str, work=None) -> tuple:
    """The matrix-free GP (models/iterative.py) at bench/capability_64k.py's
    full width: N=65,536 in d=8, float32, rank 64, 8 probes, mBCG, row
    chunk 2,048. K1 at the path's shapes against its plain version; the
    main path with the launch counts set to 0 just before and read just
    after: one value+grad at the check theta, a fit (I_R x I_STEPS), the
    serving cache and I_M queries ("precond") plus I_M_EXACT ("exact"); the
    float32 value+grad against float64 with the same probes; the served mean
    against the truth; "precond" <= "exact" where P's ridge is the plain
    diagonal; the CLI (estimate_thetas --fit_method=iterative ->
    interactive_mode --serve_method=iterative) at N=I_CLI_N. Every check is
    made and printed; the phase fails at its end if any did not pass."""
    from madaiemulator_tpu_torch.io.modelfile import write_model_file
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models import iterative
    from madaiemulator_tpu_torch.models.gp import GPData
    from madaiemulator_tpu_torch.models.multivariate import (
        precompute_iterative_multivariate,
        predict_multivariate_iterative,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils.config import GPConfig

    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"iterative check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    data, queries = _iter_data(seed, dev)
    Xq = queries.cpu().numpy()
    cfg = GPConfig(nparams=I_D, regression_order=1, n_restarts=I_R,
                   max_opt_steps=I_STEPS)
    theta = kernels.GPParams(
        log_amp=torch.tensor(math.log(I_AMP), device=dev),
        log_nugget=torch.tensor(math.log(I_NUGGET), device=dev),
        log_ls=torch.full((I_D,), math.log(I_LS), device=dev))
    kw = dict(seed=0, rank=I_RANK, probes=I_PROBES, lanczos_iters=I_LANCZOS,
              cg_tol=I_TOL, cg_max_iters=I_ITERS, logdet_method="mbcg",
              row_chunk=I_ROW_CHUNK)
    kw_fit = {**kw, "cg_max_iters": I_FIT_ITERS}

    k1_err, k1_shapes = _iter_k1_checks(dev, data.X, smi)

    def value_and_grad(params, d=data, config=cfg, opts=kw):
        leaves = [t.detach().clone().requires_grad_(True) for t in params]
        ll = iterative.lml_iterative(kernels.GPParams(*leaves), d, config,
                                     **opts)
        grads = torch.autograd.grad(ll, leaves)
        return ll.detach(), grads

    # the main path, the counts set to 0 just before and read just after
    k1.launches = k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ll32, g32 = value_and_grad(theta)
    torch.cuda.synchronize()
    vg_wall = time.perf_counter() - t0
    vg_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vg_k1 = k1.launches
    t0 = time.perf_counter()
    res = iterative.fit_gp_iterative(
        torch.Generator().manual_seed(seed), data, cfg, vg_batch=1,
        value_linesearch=True, **kw_fit)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_k1 = k1.launches - vg_k1
    t0 = time.perf_counter()
    state = iterative.precompute_iterative_predictor(
        res.params, data, cfg, rank=I_RANK, cg_tol=I_SERVE_TOL,
        cg_max_iters=I_ITERS, row_chunk=I_ROW_CHUNK)
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, var = iterative.predict_iterative_from_state(
        state, data, queries, query_chunk=I_QC, variance_method="precond",
        row_chunk=I_ROW_CHUNK)
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean_e, var_e = iterative.predict_iterative_from_state(
        state, data, queries[:I_M_EXACT], query_chunk=I_M_EXACT,
        variance_method="exact", row_chunk=I_ROW_CHUNK)
    torch.cuda.synchronize()
    exact_wall = time.perf_counter() - t0
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    st = res.stats
    print(f"iterative: N={I_N} d={I_D} float32, rank {I_RANK}, {I_PROBES} "
          f"probes, mBCG, cg_tol {I_TOL}, cg_max_iters {I_ITERS} ("
          f"{I_FIT_ITERS} in the fit and the profile), row_chunk "
          f"{I_ROW_CHUNK} ({smi})")
    print(f"iterative times: value+grad {vg_wall:.3f} s wall, peak "
          f"{vg_peak:.2f} GiB, K1 {vg_k1} launches; fit {I_R} x {I_STEPS} "
          f"{fit_wall:.3f} s ({st['n_vg_calls']} value+grad, "
          f"{st['n_v_calls']} value-only calls, first value+grad "
          f"{st['first_vg_wall_s']:.3f} s, K1 {fit_k1} launches), best logL "
          f"{res.log_likelihood.item():.6g} at amp "
          f"{math.exp(res.params.log_amp.item()):.4g}, nugget "
          f"{math.exp(res.params.log_nugget.item()):.4g}, ls "
          f"{[round(v, 4) for v in torch.exp(res.params.log_ls).tolist()]}; "
          f"precompute {pre_wall:.3f} s; predict {I_M} (precond, chunks of "
          f"{I_QC}) {pred_wall:.3f} s = {I_M / pred_wall:.1f} pts/s; "
          f"{I_M_EXACT} exact {exact_wall:.3f} s ({smi})")
    check(launches["pairwise_covariance"] > 0
          and launches["cholesky"] == launches["panel_factor"] == 0,
          f"iterative path launches {launches}: K1 > 0, K2 = K3 = 0")
    truth = _truth64k(Xq.astype(np.float64))
    rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - truth)
                                 ** 2)))
    check(bool(torch.isfinite(ll32)) and all(bool(torch.isfinite(g).all())
                                             for g in g32)
          and mean.shape == var.shape == (I_M,)
          and bool(torch.isfinite(mean).all() & torch.isfinite(var).all()
                   & (var >= 0).all())
          and rmse <= I_RMSE_MAX,
          f"value+grad finite (ll {ll32.item():.8g}); served {I_M} means "
          f"and variances finite, variances >= 0; rmse of the mean against "
          f"the truth {rmse:.4g} <= {I_RMSE_MAX} (noise floor {I_NOISE}); "
          f"mean posterior sd of the {I_M_EXACT} exact variances "
          f"{var_e.mean().sqrt().item():.4g}, of the precond ones "
          f"{var.mean().sqrt().item():.4g}")
    d_me = (mean_e - mean[:I_M_EXACT]).abs().max().item()
    check(d_me <= 1e-5 * max(1.0, mean.abs().max().item()),
          f"the exact serve's means equal the precond serve's: max diff "
          f"{d_me:.3g}")

    # the rest is outside the count: the PCG iterations of the value, the
    # device time of a value+grad and of one matvec, the float64 reference,
    # the bound check at the check theta, the CLI
    t0 = time.perf_counter()
    with torch.no_grad():
        _, _, _, _, info = iterative._lml_iterative_impl(
            theta, data, cfg, iterative._IterOptions(**kw))
    torch.cuda.synchronize()
    print(f"iterative value only: {time.perf_counter() - t0:.3f} s wall, "
          f"{info.cg_iters} PCG iterations of {I_ITERS} (worst solve "
          f"residual {info.solve_rel_residual.item():.3g})")
    t0 = time.perf_counter()
    value_and_grad(theta, opts=kw_fit)
    torch.cuda.synchronize()
    profile_once(f"value+grad (check theta, PCG at {I_FIT_ITERS})",
                 lambda: value_and_grad(theta, opts=kw_fit),
                 (time.perf_counter() - t0) * 1e3, smi, cell="iterative",
                 warm=False)
    V = torch.randn((I_N, 18), device=dev)
    mv_ms = host_ms(lambda: iterative.gram_matvec(
        data.X, theta, cfg, V, row_chunk=I_ROW_CHUNK), iters=5)
    mv_bound = bound_ms(4 * (I_N * I_N + 2 * 2 * I_N * 18), 2 * I_N * I_N * 18)
    print(f"iterative matvec (N={I_N}, 18 columns): {mv_ms:.3f} ms wall; "
          f"its tiles written and read back bound it at "
          f"{bound_ms(2 * 4 * I_N * I_N, 0)[0]:.3f} ms, the function at "
          f"{mv_bound[0]:.3f} ms ({mv_bound[1]}) ({smi})")
    profile_once("matvec (18 columns)", lambda: iterative.gram_matvec(
        data.X, theta, cfg, V, row_chunk=I_ROW_CHUNK), mv_ms, smi,
        cell="iterative")
    del V

    # float32 against float64, the same probes and the same jitter floor
    jf = kernels.effective_jitter_frac(I_N, torch.float32, cfg)
    cfg64 = dataclasses.replace(cfg, jitter=jf)
    d64 = GPData(X=data.X.double(), y=data.y.double())
    t0 = time.perf_counter()
    ll64, g64 = value_and_grad(kernels.GPParams(*(t.double() for t in theta)),
                               d64, cfg64)
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    dll = abs(ll32.item() - ll64.item()) / I_N
    gv32 = torch.cat([g.double().reshape(-1) for g in g32])
    gv64 = torch.cat([g.reshape(-1) for g in g64])
    dg = (gv32 - gv64).abs().max().item() / gv64.abs().max().item()
    check(dll <= I_LL_PER_POINT and dg <= I_GRAD_RTOL,
          f"value+grad float32 vs float64 (same probes, jitter {jf:.3g} x "
          f"amp on both; float64 {wall64:.2f} s): ll {ll32.item():.8g} vs "
          f"{ll64.item():.8g}, {dll:.3g} nats a point <= {I_LL_PER_POINT} "
          f"({abs(ll32.item() - ll64.item()) / abs(ll64.item()):.3g} x "
          f"|ll64|); gradient {dg:.3g} x max|g64| <= {I_GRAD_RTOL} (g32 "
          f"{[round(v, 3) for v in gv32.tolist()]}, g64 "
          f"{[round(v, 3) for v in gv64.tolist()]})")
    del d64

    # "precond" is a lower bound of "exact" where P's ridge is the plain
    # nugget + jitter diagonal: at the fitted thetas (the main path's
    # serves), or, when the conditioning floor raised the ridge there, at
    # the check theta
    for what, params in (("fitted", res.params), ("check theta", theta)):
        da = iterative._diag_add(I_N, params, cfg, torch.float32)
        if what == "fitted":
            st_b, vp, ve = state, var[:I_M_EXACT], var_e
        else:
            st_b = iterative.precompute_iterative_predictor(
                params, data, cfg, rank=I_RANK, cg_tol=I_SERVE_TOL,
                cg_max_iters=I_ITERS, row_chunk=I_ROW_CHUNK)
            q = queries[:I_M_EXACT]
            _, vp = iterative.predict_iterative_from_state(
                st_b, data, q, query_chunk=I_QC, variance_method="precond",
                row_chunk=I_ROW_CHUNK)
            _, ve = iterative.predict_iterative_from_state(
                st_b, data, q, query_chunk=I_M_EXACT,
                variance_method="exact", row_chunk=I_ROW_CHUNK)
        over = (vp - ve).max().item()
        msg = (f"{what}: P's ridge {st_b.pre.sigma2.item():.4g}, nugget + "
               f"jitter {da.item():.4g}; precond - exact variance max "
               f"{over:.3g}, mean precond / exact "
               f"{(vp.mean() / ve.mean()).item():.4f}")
        if bool(st_b.pre.sigma2 == da):
            check(over <= 1e-6 * ve.abs().max().item(),
                  f"precond <= exact on {I_M_EXACT} queries at the {msg}")
            break
        print(f"iterative: the conditioning floor raised P's ridge at the "
              f"{msg} (no bound there)")
    del state, st_b

    # the CLI at config 3's recipe, N=I_CLI_N: estimate_thetas
    # --fit_method=iterative -> snapshot -> interactive_mode
    # --serve_method=iterative over the pipe, against in-process serving
    crng = np.random.default_rng([seed, 11])
    X3, Y3 = _heavy_ion_like(crng, I_CLI_N, C3_D, C3_T)
    q3 = crng.uniform(size=(64, C3_D))
    with _workdir(work) as tmp:
        model = str(pathlib.Path(tmp) / "model.txt")
        write_model_file(model, X3, Y3)
        cstate = str(pathlib.Path(tmp) / "iter_state.txt")
        t0 = time.perf_counter()
        rc, _, err = _run_cli(
            ["estimate_thetas", model, cstate, "--dtype", "float32",
             "--device", "cuda", "--fit_method", "iterative",
             "--regression_order", "1", "--pca_variance", str(C3_PCA),
             "--restarts", "1", "--steps", "2", "--rank", str(I_RANK),
             "--probes", str(I_PROBES), "--cg_tol", str(I_TOL),
             "--cg_max_iters", str(I_FIT_ITERS), "--logdet_method", "mbcg",
             "--seed", str(seed)])
        cli_wall = time.perf_counter() - t0
        ok = rc == 0 and pathlib.Path(cstate).exists()
        check(ok, f"CLI estimate_thetas --fit_method=iterative --dtype "
              f"float32 at N={I_CLI_N} exit {rc} in {cli_wall:.2f} s "
              f"(process start included); stderr: {err.strip()!r}")
        if ok:
            emu, pn, on = read_snapshot(cstate, device=dev,
                                        dtype=torch.float32,
                                        build_states=False)
            batches = [q3[:1], q3[1:16], q3[16:]]
            header = ([f"{C3_D}\n"] + [f"{x}\n" for x in pn]
                      + [f"{2 * C3_T}\n"] + [f"mean_{x}\n" for x in on]
                      + [f"variance_{x}\n" for x in on])
            t0 = time.perf_counter()
            served = _serve_over_pipe(cstate, batches, C3_D, C3_T, header,
                                      extra=("--serve_method", "iterative"))
            serve_wall = time.perf_counter() - t0
            states = precompute_iterative_multivariate(emu)
            want = np.concatenate(
                [torch.cat(predict_multivariate_iterative(
                    emu, b, states=states, query_chunk=128,
                    variance_rhs=128), dim=1).cpu().double().numpy()
                 for b in batches])
            scale = np.abs(want[:, :C3_T]).max()
            pv = np.abs(want[:, C3_T:]).max()
            sm = np.abs(served[:, :C3_T] - want[:, :C3_T]).max() / scale
            sv = np.abs(served[:, C3_T:] - want[:, C3_T:]).max() / pv
            check(bool(np.isfinite(served).all()) and sm <= SERVER_TOL
                  and sv <= SERVER_TOL,
                  f"interactive_mode --serve_method=iterative on the CLI's "
                  f"snapshot ({emu.n_components} components; "
                  f"{serve_wall:.2f} s with process start) vs in-process: "
                  f"mean {sm:.3g} x scale, var {sv:.3g} x max var <= "
                  f"{SERVER_TOL}")
    print(f"iterative phase wall {time.perf_counter() - t_phase:.1f} s")
    require(not failed, f"iterative: {len(failed)} checks failed: {failed}")
    return (launches, (k1_err, k1_shapes), res.params,
            (ll32, g32, vg_k1, vg_wall))


def _truth1m(A):
    """bench/capability_1m.py's noiseless truth."""
    return (torch.sin(4.0 * A[:, 0]) + 0.5 * torch.cos(3.0 * A[:, 1])
            + A[:, 2] * A[:, 3])


def _k1_path_checks(dev, pairs, smi, cell) -> tuple:
    """K1 on a path's own operands: each (label, U (B, n1, d), V (B, n2, d),
    amp (B,)), or (label, U, U, amp, diag_add (B,)) for a Gram (the one
    tensor as both operands, diag_add on the diagonal, as the path hands
    them over), against the plain version, with kernel, plain and
    library-composite times and the bound. Returns (largest error,
    {label: reading})."""
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1

    fam = "power_exponential"
    err_max, by_shape = 0.0, {}
    for label, U, V, amp, *rest in pairs:
        g = rest[0] if rest else None
        gram = g is not None
        B, n1, d = U.shape
        n2 = V.shape[1]

        def kern(U=U, V=V, amp=amp, g=g):
            return k1.pairwise_covariance(U, V, amp, g, fam, add_diag=gram)

        def plain(U=U, V=V, amp=amp, g=g):
            return k1.pairwise_covariance_plain(U, V, amp, g, fam,
                                                add_diag=gram)

        got = kern()
        err = (got - plain()).abs().max().item()
        torch.cuda.synchronize()
        require(got.shape == (B, n1, n2) and err <= K1_ATOL,
                f"{cell} K1 {label} err {err:.3g} > {K1_ATOL}")
        del got
        big = n1 * n2 > K1_FULL_CHECK_MAX
        t = {"ms": cuda_ms(kern, iters=10 if big else 50),
             "graph_ms": None if big else graph_ms(kern),
             "plain_ms": cuda_ms(plain, iters=3, warmup=1),
             "composite_ms": cuda_ms(
                 lambda U=U, V=V, amp=amp, g=g: _k1_composite(U, V, amp, g,
                                                              gram),
                 iters=10)}
        t["bound_ms"], t["bound_by"] = bound_ms(
            4 * (B * (n1 + (0 if gram else n2)) * d + B * (2 if gram else 1)
                 + B * n1 * n2),
            B * n1 * n2 * (3 * d + 3))
        t["max_abs_err"] = err
        by_shape[label] = t
        err_max = max(err_max, err)
        dev_ms = t["graph_ms"] or t["ms"]
        print(f"{cell} K1 {label}: max_abs_err vs plain {err:.3g} <= "
              f"{K1_ATOL}; kernel {t['ms']:.4f} ms"
              f"{'' if t['graph_ms'] is None else ' (device, CUDA graph: %.4f ms)' % t['graph_ms']}"
              f", plain {t['plain_ms']:.4f} ms, library composite "
              f"{t['composite_ms']:.4f} ms, bound {t['bound_ms']:.4g} ms "
              f"({t['bound_by']}): {t['bound_ms'] / dev_ms:.2f} of the "
              f"bound ({smi})")
        torch.cuda.empty_cache()
    return err_max, by_shape


@contextlib.contextmanager
def _path_operands():
    """While the block runs, keep a copy of the operands of the last K1, K2
    and K3 launch of each shape (the launches and their counts run as
    before): {"pairwise_covariance": {(kind, B, n1, n2, d): (U, V, amp,
    diag_add)}, "cholesky": {(B, n): A}, "panel_factor": {(B, b): P}}; a
    Gram's V is its U."""
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    seen = {"pairwise_covariance": {}, "cholesky": {}, "panel_factor": {}}
    orig = (k1.pairwise_covariance, k2.cholesky, k3.panel_factor)

    def k1_record(U, V, amp, diag_add, family="power_exponential",
                  add_diag=False):
        require(family == "power_exponential",
                f"K1 path check: family {family!r}")
        gram = V.data_ptr() == U.data_ptr() and V.shape == U.shape
        Uc = U.clone()
        seen["pairwise_covariance"][
            ("gram" if gram else "cross", *U.shape[:2], V.shape[1],
             U.shape[2])] = (Uc, Uc if gram else V.clone(), amp.clone(),
                             diag_add.clone() if add_diag else None)
        return orig[0](U, V, amp, diag_add, family, add_diag)

    def k2_record(A):
        seen["cholesky"][tuple(A.shape[:2])] = A.clone()
        return orig[1](A)

    def k3_record(P):
        seen["panel_factor"][tuple(P.shape[:2])] = P.clone()
        return orig[2](P)

    k1.pairwise_covariance, k2.cholesky, k3.panel_factor = (
        k1_record, k2_record, k3_record)
    try:
        yield seen
    finally:
        k1.pairwise_covariance, k2.cholesky, k3.panel_factor = orig


def _path_kernel_checks(dev, seen, smi, cell, prefix="") -> dict:
    """Every kernel on the operands `_path_operands` kept: K1 against its
    plain version (`_k1_path_checks`), K2 and K3 by their backward errors
    (the operands sit at fitted thetas, where the forward distance of two
    float32 factors measures the conditioning). Returns {kernel name:
    {label: reading}}."""
    out = {}
    pairs = [(f"{prefix}{kind}({B},{n1},{n2})d{d}", U, V, amp,
              *(() if g is None else (g,)))
             for (kind, B, n1, n2, d), (U, V, amp, g)
             in sorted(seen["pairwise_covariance"].items())]
    if pairs:
        out["pairwise_covariance"] = _k1_path_checks(dev, pairs, smi,
                                                     cell)[1]
    for (B, n), A in sorted(seen["cholesky"].items()):
        out.setdefault("cholesky", {}).update(_k2_path_check(
            dev, A, smi, cell, f"{prefix}the path's last ({B},{n},{n}) "
            "Grams"))
    for (B, b), P in sorted(seen["panel_factor"].items()):
        out.setdefault("panel_factor", {}).update(_k3_path_check(
            dev, P, smi, cell, f"{prefix}the path's last ({B},{b},{b}) "
            "diagonal panels", fitted=True))
    return out


def _identity_pca_emulator(mv, scaling_d, dev, dtype, **fields):
    """A one-output container around one GP (identity scaling and PCA), so
    that a scalar fit writes and serves through the multivariate snapshot
    grammars; `mv` is the container class."""
    from madaiemulator_tpu_torch.models.multivariate import PCAState
    from madaiemulator_tpu_torch.utils.designs import DesignScaling

    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    o = lambda *s: torch.ones(s, dtype=dtype, device=dev)  # noqa: E731
    return mv(scaling=DesignScaling(mins=z(scaling_d), ranges=o(scaling_d)),
              pca=PCAState(ymean=z(1), ystd=o(1), eigenvalues=o(1),
                           U=o(1, 1)), **fields)


def phase_sparse(dev, seed: int, smi: str, work) -> tuple:
    """SGPR (models/sparse.py) at bench/capability_1m.py's full width:
    N=1,000,000 in d=4, float32, m=512, row chunks of 65,536. K1 at the
    path's shapes against its plain version; the main path with the launch
    counts set to 0 just before and read just after: select_inducing, the
    host-loop fit (S_R x S_STEPS, vg_batch 1) and S_Q queries served, with
    K1 required to launch exactly as the code implies (per ELBO value
    1 + C, per value+grad 1 + 2C: k(Z, Z) once, each of the C row chunks
    once forward and once more in its checkpoint recompute; per serve
    precompute 1 + C; per predict 1) and K2 = K3 = 0; the float32 ELBO
    value+grad against float64 with the same Z; the served mean against
    the truth; the snapshot (text and .npz) read back and served equal; the
    CLI (estimate_thetas --inducing, interactive_mode, validate
    --model_file) at config 3's recipe, N=S_CLI_N. Every check is made and
    printed; the phase fails at its end if any did not pass."""
    from madaiemulator_tpu_torch.io.modelfile import write_model_file
    from madaiemulator_tpu_torch.io.snapshot import (
        read_snapshot_auto,
        write_snapshot_auto,
    )
    from madaiemulator_tpu_torch.models import sparse
    from madaiemulator_tpu_torch.models.gp import GPData
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils.config import GPConfig

    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"sparse check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.rand((S_N, S_D), generator=gen, device=dev)
    y = _truth1m(X) + S_NOISE * torch.randn(S_N, generator=gen, device=dev)
    Xq = torch.rand((S_Q, S_D), generator=gen, device=dev)
    data = GPData(X=X, y=y)
    cfg = GPConfig(nparams=S_D, regression_order=1, n_restarts=S_R,
                   max_opt_steps=S_STEPS, linesearch="backtracking")
    C = -(-S_N // S_ROW_CHUNK)  # row chunks, the last padded
    print(f"sparse: N={S_N} d={S_D} float32 (drawn on the card), m={S_M}, "
          f"row_chunk {S_ROW_CHUNK} ({C} chunks), {S_R} restarts x "
          f"{S_STEPS} steps, backtracking, vg_batch 1 ({smi})")

    # the main path, the counts set to 0 just before and read just after
    k1.launches = k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sparse.fit_sgpr_host(torch.Generator().manual_seed(seed), data,
                               cfg, inducing=S_M, row_chunk=S_ROW_CHUNK,
                               vg_batch=1, value_linesearch=True)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    mean, var = sparse.predict_sgpr(res.state, res.params, cfg, Xq)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    st = res.stats
    want_k1 = (S_R * (st["n_vg_calls"] * (1 + 2 * C)
                      + st["n_v_calls"] * (1 + C)) + (1 + C) + 1)
    print(f"sparse fit: {fit_wall:.3f} s wall ({st['n_vg_calls']} "
          f"value+grad and {st['n_v_calls']} value-only calls over {S_R} "
          f"restarts, first value+grad {st['first_vg_wall_s']:.3f} s, "
          f"value+grad {st['vg_wall_s']:.3f} s, value {st['v_wall_s']:.3f} "
          f"s), peak {fit_peak:.2f} GiB; best ELBO "
          f"{res.elbo.item():.8g} (restarts {res.restart_elbos.tolist()}) "
          f"at amp {math.exp(res.params.log_amp.item()):.4g}, nugget "
          f"{math.exp(res.params.log_nugget.item()):.4g}, ls "
          f"{[round(v, 4) for v in torch.exp(res.params.log_ls).tolist()]};"
          f" serve {S_Q} {serve_wall * 1e3:.3f} ms = "
          f"{S_Q / serve_wall:.1f} pts/s ({smi})")
    check(launches == {"pairwise_covariance": want_k1, "cholesky": 0,
                       "panel_factor": 0},
          f"sparse path launches {launches}: K1 = {S_R} restarts x "
          f"({st['n_vg_calls']} value+grad x (1 + 2 x {C}) + "
          f"{st['n_v_calls']} value x (1 + {C})) + precompute (1 + {C}) + "
          f"predict 1 = {want_k1}; K2 = K3 = 0 (the m x m and p x p "
          f"Choleskys are library math, as in the JAX package)")
    rmse = (mean - _truth1m(Xq)).pow(2).mean().sqrt().item()
    check(bool(torch.isfinite(res.restart_elbos).all())
          and mean.shape == var.shape == (S_Q,)
          and bool(torch.isfinite(mean).all() & torch.isfinite(var).all()
                   & (var >= 0).all()) and rmse <= S_RMSE_MAX,
          f"every restart's ELBO finite; served {S_Q} means and variances "
          f"finite, variances >= 0 (mean posterior sd "
          f"{var.mean().sqrt().item():.4g}); rmse of the mean against the "
          f"truth {rmse:.4g} <= {S_RMSE_MAX} (noise floor {S_NOISE})")

    # K1 on the path's own operands at the fitted thetas
    U = kernels._scaled(res.Z, res.params, cfg)[None].contiguous()
    Xs = kernels._scaled(X[:S_ROW_CHUNK], res.params, cfg)[None].contiguous()
    Qs = kernels._scaled(Xq, res.params, cfg)[None].contiguous()
    amp = torch.exp(res.params.log_amp).reshape(1)
    k1_err, k1_shapes = _k1_path_checks(dev, [
        (f"cross(1,{S_M},{S_ROW_CHUNK})d{S_D}", U, Xs, amp),
        (f"cross(1,{S_M},{S_M})d{S_D}", U, U.clone(), amp),
        (f"cross(1,{S_M},{S_Q})d{S_D}", U, Qs, amp)], smi, "sparse")
    del Xs

    # one value+grad at the check theta: wall, device time, peak memory;
    # then float32 against float64 with the same Z
    theta = kernels.GPParams(
        log_amp=torch.tensor(math.log(S_AMP), device=dev),
        log_nugget=torch.tensor(math.log(S_NUGGET), device=dev),
        log_ls=torch.full((S_D,), math.log(S_LS), device=dev))

    def value_and_grad(params, d=data, Z=res.Z):
        leaves = [t.detach().clone().requires_grad_(True) for t in params]
        ll = sparse.elbo(kernels.GPParams(*leaves), d, cfg, Z,
                         row_chunk=S_ROW_CHUNK)
        return ll.detach(), torch.autograd.grad(ll, leaves)

    value_and_grad(theta)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = k1.launches
    t0 = time.perf_counter()
    ll32, g32 = value_and_grad(theta)
    torch.cuda.synchronize()
    vg_wall = time.perf_counter() - t0
    vg_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vg_k1 = k1.launches - before
    t0 = time.perf_counter()
    with torch.no_grad():
        sparse.elbo(theta, data, cfg, res.Z, row_chunk=S_ROW_CHUNK)
    torch.cuda.synchronize()
    v_wall = time.perf_counter() - t0
    print(f"sparse value+grad (check theta): {vg_wall * 1e3:.2f} ms wall, "
          f"peak {vg_peak:.2f} GiB, K1 {vg_k1} launches (1 + 2 x {C}); "
          f"value alone {v_wall * 1e3:.2f} ms ({smi})")
    check(vg_k1 == 1 + 2 * C, f"one value+grad launches K1 {vg_k1} = 1 + "
          f"2 x {C}")
    profile_once("value+grad (check theta)", lambda: value_and_grad(theta),
                 vg_wall * 1e3, smi, cell="sparse", warm=False)
    d64 = GPData(X=X.double(), y=y.double())
    t0 = time.perf_counter()
    ll64, g64 = value_and_grad(kernels.GPParams(*(t.double() for t in theta)),
                               d64, res.Z.double())
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    del d64
    dll = abs(ll32.item() - ll64.item()) / S_N
    gv32 = torch.cat([g.double().reshape(-1) for g in g32])
    gv64 = torch.cat([g.reshape(-1) for g in g64])
    dg = (gv32 - gv64).abs().max().item() / gv64.abs().max().item()
    check(dll <= S_LL_PER_POINT and dg <= S_GRAD_RTOL,
          f"ELBO value+grad float32 vs float64 (same Z; float64 "
          f"{wall64:.2f} s): {ll32.item():.10g} vs {ll64.item():.10g}, "
          f"{dll:.3g} nats a point <= {S_LL_PER_POINT} "
          f"({abs(ll32.item() - ll64.item()) / abs(ll64.item()):.3g} x "
          f"|ll64|); gradient {dg:.3g} x max|g64| <= {S_GRAD_RTOL} (g32 "
          f"{[round(v, 3) for v in gv32.tolist()]}, g64 "
          f"{[round(v, 3) for v in gv64.tolist()]})")

    # the snapshot, text and .npz: written, read back, served equal
    emu = _identity_pca_emulator(
        sparse.SparseMultivariateEmulator, S_D, dev, torch.float32,
        Z=res.Z, params=kernels.GPParams(*(a[None] for a in res.params)),
        states=sparse.SGPRServeState(*(a[None] for a in res.state)),
        config=cfg)
    sdir = pathlib.Path(work) / "sparse"
    sdir.mkdir(parents=True, exist_ok=True)
    for name, tol in (("sgpr_1m.npz", SERVER_TOL),
                      ("sgpr_1m.txt", S_TEXT_SERVE_TOL)):
        path = str(sdir / name)
        write_snapshot_auto(path, emu)
        back, _, _ = read_snapshot_auto(path, device=dev,
                                        dtype=torch.float32)
        same = torch.equal(back.Z, res.Z) and all(
            torch.equal(a[0], b) for a, b in
            zip(back.states[1:-1], res.state[1:-1]))
        dp = max(((a[0] - b).abs() / b.abs().clamp(min=1.0)).max().item()
                 for a, b in zip(back.params, res.params))
        mb, vb = sparse.predict_multivariate_sparse(back, Xq.cpu().numpy())
        dm = (mb[:, 0] - mean).abs().max().item() / mean.abs().max().item()
        dv = (vb[:, 0] - var).abs().max().item() / var.abs().max().item()
        check(same and dp <= 2.5e-7 and dm <= tol and dv <= tol,
              f"snapshot {name} ({os.path.getsize(path)} bytes) read back: "
              f"Z and the serve state bitwise equal {same}, log-parameters "
              f"{dp:.3g} x max(1, |log theta|) <= 2.5e-7; served: mean "
              f"{dm:.3g} x scale, variance {dv:.3g} x max var <= {tol}")

    # the CLI at config 3's recipe, N=S_CLI_N: estimate_thetas --inducing
    # -> interactive_mode over the pipe -> validate --model_file, at
    # float64 (the CLI's default): at float32 (NVIDIA H100 80GB HBM3)
    # restarts ran to K_mm beyond float32, a garbage ELBO won the argmax,
    # its state failed to factor and the writer refused the snapshot
    crng = np.random.default_rng([seed, 12])
    X3, Y3 = _heavy_ion_like(crng, S_CLI_N, C3_D, C3_T)
    q3 = crng.uniform(size=(64, C3_D))
    model, cstate = str(sdir / "model.txt"), str(sdir / "sgpr_state.txt")
    write_model_file(model, X3, Y3)
    t0 = time.perf_counter()
    rc, _, err = _run_cli(
        ["estimate_thetas", model, cstate, "--dtype", "float64", "--device",
         "cuda", "--inducing", str(S_CLI_M), "--row_chunk",
         str(S_CLI_ROW_CHUNK), "--regression_order", "1", "--pca_variance",
         str(C3_PCA), "--restarts", str(C3_R), "--steps", str(S_CLI_STEPS),
         "--seed", str(seed)])
    cli_wall = time.perf_counter() - t0
    ok = rc == 0 and pathlib.Path(cstate).exists()
    check(ok, f"CLI estimate_thetas --inducing {S_CLI_M} --row_chunk "
          f"{S_CLI_ROW_CHUNK} --dtype float64 at N={S_CLI_N} exit {rc} in "
          f"{cli_wall:.2f} s (process start included); stderr: "
          f"{err.strip()!r}")
    if ok:
        semu, pn, on = read_snapshot_auto(cstate, device=dev,
                                          dtype=torch.float32)
        batches = [q3[:1], q3[1:16], q3[16:]]
        header = ([f"{C3_D}\n"] + [f"{x}\n" for x in pn]
                  + [f"{2 * C3_T}\n"] + [f"mean_{x}\n" for x in on]
                  + [f"variance_{x}\n" for x in on])
        t0 = time.perf_counter()
        served = _serve_over_pipe(cstate, batches, C3_D, C3_T, header)
        serve_cli = time.perf_counter() - t0
        want = np.concatenate(
            [torch.cat(sparse.predict_multivariate_sparse(semu, b),
                       dim=1).cpu().double().numpy() for b in batches])
        scale = np.abs(want[:, :C3_T]).max()
        pv = np.abs(want[:, C3_T:]).max()
        sm = np.abs(served[:, :C3_T] - want[:, :C3_T]).max() / scale
        sv = np.abs(served[:, C3_T:] - want[:, C3_T:]).max() / pv
        check(bool(np.isfinite(served).all()) and sm <= SERVER_TOL
              and sv <= SERVER_TOL,
              f"interactive_mode on the sparse snapshot ({semu.n_components} "
              f"components, m={semu.Z.shape[0]}; {serve_cli:.2f} s with "
              f"process start) vs in-process: mean {sm:.3g} x scale, var "
              f"{sv:.3g} x max var <= {SERVER_TOL}")
        t0 = time.perf_counter()
        rc, out, err = _run_cli(["validate", cstate, "--model_file", model,
                                 "--dtype", "float32", "--device", "cuda"])
        summary = dict(ln.split() for ln in out.splitlines()[1:])
        check(rc == 0 and int(summary.get("n", 0)) == S_CLI_N * C3_T,
              f"CLI validate --model_file on the sparse snapshot exit {rc} "
              f"in {time.perf_counter() - t0:.2f} s: {summary}; stderr "
              f"{err.strip()!r}")
    print(f"sparse phase wall {time.perf_counter() - t_phase:.1f} s")
    require(not failed, f"sparse: {len(failed)} checks failed: {failed}")
    return launches, (k1_err, k1_shapes)


def _factored_members(A, L, Lp, cell, name) -> tuple:
    """A batch member that is not SPD in float32 comes back NaN from the
    kernel (the JAX package's rule): the kernel and its plain version must
    fail on the same members, and are compared on the others. Returns (L,
    Lp, A of the factored members, the count that failed)."""
    ok = torch.isfinite(L).flatten(1).all(1)
    ok_plain = torch.isfinite(Lp).flatten(1).all(1)
    require(torch.equal(ok, ok_plain) and bool(ok.any()),
            f"{cell} {name}: the kernel factors members "
            f"{ok.nonzero().flatten().tolist()}, the plain version "
            f"{ok_plain.nonzero().flatten().tolist()}")
    return L[ok], Lp[ok], A[ok], int((~ok).sum())


def _k2_path_check(dev, C_batch, smi, cell, what) -> dict:
    """K2 on a path's own Grams (B, n, n): against its plain version
    (relative to max|L|) and float64, timed beside the library call, with
    its bound."""
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2

    B, n, _ = C_batch.shape
    L, Lp, C, failed = _factored_members(C_batch, k2.cholesky(C_batch),
                                         k2.cholesky_plain(C_batch), cell,
                                         "K2")
    L64 = torch.linalg.cholesky_ex(C.double())[0]
    scale = L64.abs().max().item()
    e_plain = (L - Lp).abs().max().item() / scale
    e64 = (L.double() - L64).abs().max().item() / scale
    Ld = L.double()
    resid = ((Ld @ Ld.mT - C.double()).abs().max().item()
             / C.abs().max().item())
    t = {"ms": cuda_ms(lambda: k2.cholesky(C_batch)),
         "plain_ms": cuda_ms(lambda: k2.cholesky_plain(C_batch), iters=2,
                             warmup=1),
         "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(C_batch))}
    t["bound_ms"], t["bound_by"] = bound_ms(2 * 4 * B * n * n,
                                            B * n ** 3 / 3)
    t["max_abs_err"] = (L - Lp).abs().max().item()
    t["rel_err_plain"], t["rel_err_f64"] = e_plain, e64
    t["backward_err"], t["failed_members"] = resid, failed
    # the states' Grams sit at the fitted nuggets (cond up to ~1.6e7), where
    # any two float32 factors differ by ~1e-4 x max|L|: the backward error
    # is gated (phase 8's rule), the forward distances printed
    require(resid <= C5_K2_RESIDUAL,
            f"{cell} K2 ({B},{n},{n}) backward error {resid:.3g} > "
            f"{C5_K2_RESIDUAL}")
    print(f"{cell} K2 ({B},{n},{n}) on {what} ({failed} members not SPD "
          f"in float32, by both versions): backward error {resid:.3g} "
          f"<= {C5_K2_RESIDUAL}; forward vs plain {e_plain:.3g}, vs float64 "
          f"{e64:.3g} x max|L| (not gated); kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.2f} ms, cholesky_ex {t['library_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.4g} ms ({t['bound_by']}) ({smi})")
    return {f"cholesky({B},{n},{n})": t}


def _k3_path_check(dev, panel, smi, cell, what, fitted=False) -> dict:
    """K3 on a path's own diagonal panels (B, b, b): against its plain
    version (relative to max|L|) and float64, timed beside the library
    pair, with its bound. At a check theta the forward distances are gated;
    at `fitted` thetas (the nuggets' conditioning) the factor's backward
    error is, and the inverse's residual is held to the plain version's
    own on the same panels."""
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    B, b, _ = panel.shape
    (Lk, Li), (Lq, Lqi) = k3.panel_factor(panel), k3.panel_factor_plain(panel)
    ok = torch.isfinite(Lk).flatten(1).all(1)
    Lk, Lq, P, failed = _factored_members(panel, Lk, Lq, cell, "K3")
    Li, Lqi = Li[ok], Lqi[ok]
    P64 = torch.linalg.cholesky_ex(P.double())[0]
    scale = P64.abs().max().item()
    e_plain = (Lk - Lq).abs().max().item() / scale
    e64 = (Lk.double() - P64).abs().max().item() / scale
    eye = torch.eye(b, device=dev)
    inv = (Li @ Lk - eye).abs().max().item()
    inv_plain = (Lqi @ Lq - eye).abs().max().item()
    Ld = Lk.double()
    resid = ((Ld @ Ld.mT - P.double()).abs().max().item()
             / P.abs().max().item())

    def pair():
        Lc, _ = torch.linalg.cholesky_ex(panel)
        return torch.linalg.solve_triangular(
            Lc, torch.eye(b, device=dev).expand_as(Lc), upper=False)

    t = {"ms": cuda_ms(lambda: k3.panel_factor(panel)),
         "plain_ms": cuda_ms(lambda: k3.panel_factor_plain(panel), iters=2,
                             warmup=1),
         "library_ms": cuda_ms(pair)}
    t["bound_ms"], t["bound_by"] = bound_ms(3 * 4 * B * b * b,
                                            2 * B * b ** 3 / 3)
    t["max_abs_err"] = (Lk - Lq).abs().max().item()
    t["rel_err_plain"], t["rel_err_f64"], t["inv_err"] = e_plain, e64, inv
    t["failed_members"] = failed
    if fitted:
        inv_gate = max(K3_INV_TOL, 2.0 * inv_plain)
        t["backward_err"], t["inv_err_plain"] = resid, inv_plain
        require(resid <= C5_K2_RESIDUAL and inv <= inv_gate,
                f"{cell} K3 ({B},{b},{b}) backward error {resid:.3g}, "
                f"|Linv L - I| {inv:.3g} (plain {inv_plain:.3g})")
        gates = (f"backward error {resid:.3g} <= {C5_K2_RESIDUAL}, |Linv L "
                 f"- I| {inv:.3g} <= max({K3_INV_TOL}, 2 x the plain "
                 f"version's {inv_plain:.3g}); forward vs plain "
                 f"{e_plain:.3g}, vs float64 {e64:.3g} x max|L| (not gated)")
    else:
        require(e_plain <= K2_RTOL and e64 <= K2_RTOL and inv <= K3_INV_TOL,
                f"{cell} K3 ({B},{b},{b}) vs plain {e_plain:.3g}, vs float64 "
                f"{e64:.3g}, |Linv L - I| {inv:.3g}")
        gates = (f"vs plain {e_plain:.3g}, vs float64 {e64:.3g} x max|L| <= "
                 f"{K2_RTOL}, |Linv L - I| {inv:.3g} <= {K3_INV_TOL}")
    print(f"{cell} K3 ({B},{b},{b}) on {what} ({failed} members not SPD "
          f"in float32, by both versions): {gates}; kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.2f} ms, library pair "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4g} ms "
          f"({t['bound_by']}) ({smi})")
    return {f"panel_factor({B},{b},{b})": t}


def _loo_gap(res32, res64, y_scale) -> tuple:
    """LOO at float32 against float64: (means over the mean scale,
    variances over the largest float64 variance)."""
    dm = (res32[0].double() - res64[0]).abs().max().item() / y_scale
    dv = ((res32[1].double() - res64[1]).abs().max().item()
          / res64[1].abs().max().item())
    return dm, dv


def phase_diagnostics(dev, seed: int, smi: str, work, iter_params) -> tuple:
    """The validation diagnostics (models/diagnostics.py) and the `validate`
    CLI on the card, three paths each between counts set to 0 and read:
    config 3 (phase 7's snapshot read at float32, K1 + K2 building its
    states; LOO on the states; D_S joint draws at D_Q queries), config 4
    (LOO at N=16,384 at phase 6's check theta: one K1 Gram, K3 on its 32
    panels), the matrix-free path (phase 10's data at its fitted thetas:
    the holdout of D_HOLD points and the matrix-free covariance of D_COV
    queries, K1 tiles only). Around them: LOO at float32 against float64,
    the covariance's diagonal against the served variance, the draws'
    moments, the matrix-free diagonal against the "exact" served variance,
    K2 and K3 on the paths' own operands, and `validate` over the CLI
    (LOO with and without --model_file and --output; --matrix_free
    --holdout on phase 10's N=2,048 snapshot). Every check is made and
    printed; the phase fails at its end if any did not pass."""
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models import diagnostics as dg
    from madaiemulator_tpu_torch.models import gp, iterative
    from madaiemulator_tpu_torch.models.multivariate import (
        IterativeMultivariateEmulator,
        _predict_components,
        _scaled_queries,
        emulator_from_numpy,
        predict_multivariate,
        reconstruct_observables,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils.config import GPConfig

    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"diagnostics check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    def zero():
        k1.launches = k2.launches = k3.launches = 0
        torch.cuda.synchronize()

    def counts():
        return {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}

    paths, times = {}, {}
    c3 = pathlib.Path(work) / "config3"
    state, model = str(c3 / "state.txt"), str(c3 / "model.txt")
    require(pathlib.Path(state).exists(), "phase 7's snapshot is missing")
    Xq = np.random.default_rng([seed, 13]).uniform(size=(D_Q, C3_D))

    # 1. config 3: the snapshot's states (K1 + K2), LOO on them, the draws
    zero()
    t0 = time.perf_counter()
    emu, _, _ = read_snapshot(state, device=dev, dtype=torch.float32)
    res, loo_m, loo_v = dg.loo_cv_multivariate(emu)
    torch.cuda.synchronize()
    times["config3_loo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    draws = dg.sample_multivariate_posterior(
        emu, Xq, torch.Generator().manual_seed(seed), D_S)
    torch.cuda.synchronize()
    times["config3_draws_s"] = time.perf_counter() - t0
    paths["diagnostics_config3"] = counts()
    n3, r3 = emu.X.shape[0], emu.n_components
    c = paths["diagnostics_config3"]
    check(c["cholesky"] >= 1 and c["pairwise_covariance"]
          == c["cholesky"] + 2 and c["panel_factor"] == 0,
          f"config 3 diagnostics launches {c}: K2 once per factorization "
          f"of the states (1 + the jitter rungs it needed), K1 once per "
          f"Gram + 2 (the draws' K* and K**), K3 = 0")
    check(bool(res.ok.all()) and bool(torch.isfinite(loo_m).all()
                                      & torch.isfinite(loo_v).all()
                                      & (loo_v > 0).all())
          and draws.shape == (D_S, D_Q, C3_T)
          and bool(torch.isfinite(draws).all()),
          f"config 3 (N={n3}, r={r3}) LOO finite, variances > 0 "
          f"({times['config3_loo_s']:.3f} s with the states' build); "
          f"{D_S} joint draws at {D_Q} queries finite "
          f"({times['config3_draws_s']:.3f} s) ({smi})")
    # LOO at float32 against float64, at the fitted thetas (printed) and
    # at a well-conditioned theta (gated), the float32 jitter floor on both
    cfg = emu.config
    jit32 = kernels.effective_jitter_frac(n3, torch.float32, cfg)
    arrays = {k: v.detach().double().cpu().numpy() for k, v in dict(
        mins=emu.scaling.mins, ranges=emu.scaling.ranges, X=emu.X, Z=emu.Z,
        ymean=emu.pca.ymean, ystd=emu.pca.ystd,
        eigenvalues=emu.pca.eigenvalues, U=emu.pca.U,
        log_amp=emu.params.log_amp, log_nugget=emu.params.log_nugget,
        log_ls=emu.params.log_ls).items()}
    y_scale = float(np.abs(arrays["Z"]).max())
    for what in ("fitted", "check"):
        if what == "check":
            arrays["log_amp"] = np.full(r3, math.log(D_C3_AMP))
            arrays["log_nugget"] = np.full(r3, math.log(D_C3_NUGGET
                                                        * D_C3_AMP))
            arrays["log_ls"] = np.full((r3, C3_D), math.log(D_C3_LS))
        e32 = emulator_from_numpy(arrays, dataclasses.replace(
            cfg, jitter=jit32), dev, dtype=torch.float32)
        e64 = emulator_from_numpy(arrays, dataclasses.replace(
            cfg, jitter=jit32), dev, dtype=torch.float64)
        r32, r64 = dg.loo_cv_multivariate(e32)[0], dg.loo_cv_multivariate(
            e64)[0]
        dm, dv = _loo_gap(r32, r64, y_scale)
        msg = (f"config 3 LOO float32 vs float64 at the {what} thetas "
               f"(jitter {jit32:.3g} x amp on both): means {dm:.3g} x "
               f"scale, variances {dv:.3g} x max var")
        if what == "check":
            check(dm <= D_LOO_TOL and dv <= D_LOO_TOL,
                  f"{msg} <= {D_LOO_TOL}")
        else:
            print(f"diagnostics: {msg} (not gated: nuggets / amp "
                  f"{(emu.params.log_nugget - emu.params.log_amp).exp().tolist()})")
    # the covariance's diagonal against the served variance; the draws'
    # empirical mean against the served mean
    Xs = _scaled_queries(emu, Xq)
    _, cov = dg.posterior_covariance(emu.states, emu.params,
                                     gp.GPData(X=emu.X, y=emu.Z.mT), Xs, cfg)
    _, v_pc = _predict_components(emu.states, emu.params, emu.X, emu.Z, Xs,
                                  cfg)
    prior = (torch.exp(emu.params.log_amp)
             + torch.exp(emu.params.log_nugget)).max().item()
    dd = (torch.diagonal(cov, dim1=-2, dim2=-1) - v_pc).abs().max().item()
    mean_o, var_o = predict_multivariate(emu, Xq)
    # the draws' variance is that of the covariance sampled, eigh's with
    # its negative eigenvalues clamped: at the fitted nuggets (~1e-8 x amp)
    # float32 eigenvalue errors of ~eps x max lambda exceed the smallest
    # served variances, so the sampling error is taken from it
    lam, U = torch.linalg.eigh(cov)
    v_s = (U * U * torch.clamp(lam, min=0.0)[..., None, :]).sum(-1)
    _, var_s = reconstruct_observables(torch.zeros_like(v_s), v_s, emu.pca)
    zed = (draws.mean(0) - mean_o) / torch.sqrt(var_s / D_S)
    check(dd <= D_DIAG_TOL * prior and zed.abs().max().item() <= D_Z_MAX,
          f"the covariance's diagonal vs the served variance {dd:.3g} <= "
          f"{D_DIAG_TOL} x prior var {prior:.4g}; the draws' mean within "
          f"{zed.abs().max().item():.3g} <= {D_Z_MAX} standard errors of "
          f"the sampled covariance "
          f"({(zed.abs() <= 2).double().mean().item():.4f} within 2; its "
          f"variance vs the served one: max "
          f"{(var_s - var_o).abs().max().item():.3g}, "
          f"{(var_s - var_o).abs().max().item() / var_o.max().item():.3g} "
          f"of the largest)")
    del cov, draws

    # 2. config 4 at phase 6's check theta: LOO on the K3 route
    data, _ = _c4_data(seed, dev)
    c4cfg = GPConfig(nparams=C4_D, regression_order=1, cholesky_block=512)
    c4cfg = dataclasses.replace(c4cfg, jitter=kernels.effective_jitter_frac(
        C4_N, torch.float32, c4cfg))
    theta = kernels.GPParams(
        log_amp=torch.zeros((), device=dev),
        log_nugget=torch.log(torch.tensor(1e-2, device=dev)),
        log_ls=torch.log(torch.full((C4_D,), 0.5, device=dev)))
    zero()
    t0 = time.perf_counter()
    r32 = dg.loo_cv(theta, data, c4cfg)
    torch.cuda.synchronize()
    times["config4_loo_s"] = time.perf_counter() - t0
    paths["diagnostics_config4"] = counts()
    panels = C4_N // 512
    check(paths["diagnostics_config4"] == {"pairwise_covariance": 1,
                                           "cholesky": 0,
                                           "panel_factor": panels},
          f"config 4 LOO launches {paths['diagnostics_config4']}: one K1 "
          f"Gram, K3 on each of its {panels} diagonal panels, K2 = 0")
    t0 = time.perf_counter()
    r64 = dg.loo_cv(kernels.GPParams(*(a.double() for a in theta)),
                    gp.GPData(X=data.X.double(), y=data.y.double()), c4cfg)
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    dm, dv = _loo_gap(r32, r64, data.y.abs().max().item())
    check(bool(r32.ok) and dm <= D_C4_LOO_TOL and dv <= D_C4_LOO_TOL,
          f"config 4 LOO (N={C4_N}, K3 route, {times['config4_loo_s']:.3f} s"
          f"; float64 {wall64:.2f} s) float32 vs float64: means {dm:.3g} x "
          f"scale, variances {dv:.3g} x max var <= {D_C4_LOO_TOL}; "
          f"summary {dg.loo_summary(r32, data.y)} ({smi})")
    del r32, r64
    # K2 on config 3's state Grams, K3 on config 4's first panel
    C3 = kernels.gram_matrix(emu.X, emu.params, cfg).contiguous()
    C4 = kernels.gram_matrix(data.X, theta, c4cfg)
    k23 = _k2_path_check(dev, C3, smi, "diagnostics",
                         "config 3's state Grams")
    k23.update(_k3_path_check(dev, C4[:512, :512][None].contiguous(), smi,
                              "diagnostics", "config 4's first diagonal "
                              "panel"))
    del C3, C4, data
    torch.cuda.empty_cache()

    # 3. the matrix-free path on phase 10's data at its fitted thetas
    idata, iq = _iter_data(seed, dev)
    icfg = GPConfig(nparams=I_D, regression_order=1)
    iemu = _identity_pca_emulator(
        IterativeMultivariateEmulator, I_D, dev, torch.float32,
        X=idata.X, Z=idata.y[:, None],
        params=kernels.GPParams(*(a[None] for a in iter_params)),
        config=icfg)
    kw = dict(rank=I_RANK, cg_tol=I_SERVE_TOL, cg_max_iters=I_ITERS)
    zero()
    t0 = time.perf_counter()
    hold, hm, hv = dg.holdout_cv_multivariate(
        iemu, torch.Generator().manual_seed(seed), D_HOLD,
        row_chunk=I_ROW_CHUNK, **kw)
    torch.cuda.synchronize()
    times["holdout_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ist = iterative.precompute_iterative_predictor(
        iter_params, idata, icfg, row_chunk=I_ROW_CHUNK, **kw)
    q = iq[:D_COV]
    cm, cov = dg.posterior_covariance_iterative(ist, idata, q,
                                                row_chunk=I_ROW_CHUNK)
    torch.cuda.synchronize()
    times["cov_iterative_s"] = time.perf_counter() - t0
    paths["diagnostics_iterative"] = counts()
    c = paths["diagnostics_iterative"]
    check(c["pairwise_covariance"] > 0 and c["cholesky"] == 0
          and c["panel_factor"] == 0,
          f"matrix-free diagnostics launches {c}: K1 > 0, K2 = K3 = 0")
    s = dg.validation_summary(hm, hv, idata.y[torch.tensor(hold,
                                                           device=dev)])
    check(hm.shape == hv.shape == (D_HOLD, 1) and bool(
        torch.isfinite(hm).all() & torch.isfinite(hv).all()
        & (hv >= 0).all()),
          f"holdout of {D_HOLD} of N={I_N} at the fitted thetas "
          f"({times['holdout_s']:.2f} s): {s} ({smi})")
    me, ve = iterative.predict_iterative_from_state(
        ist, idata, q, query_chunk=D_COV, variance_method="exact",
        row_chunk=I_ROW_CHUNK)
    amp = math.exp(iter_params.log_amp.item())
    dd = (torch.diagonal(cov) - ve).abs().max().item()
    dmean = (cm - me).abs().max().item()
    check(dd <= D_ITER_DIAG_TOL * amp and dmean <= SERVER_TOL * max(
        1.0, me.abs().max().item()),
          f"matrix-free covariance of {D_COV} queries "
          f"({times['cov_iterative_s']:.2f} s with the serving state): "
          f"diagonal vs the exact served variance {dd:.3g} <= "
          f"{D_ITER_DIAG_TOL} x amp {amp:.4g}; means {dmean:.3g}")
    del ist, cov, idata

    # 4. validate over the CLI: phase 7's snapshot, with and without
    # --model_file, with --output; phase 10's N=2,048 snapshot matrix-free
    table = str(c3 / "loo_table.txt")
    istate = str(pathlib.Path(work) / "iterative" / "iter_state.txt")
    runs = {
        "loo": ["validate", state],
        "model_file_output": ["validate", state, "--model_file", model,
                              "--output", table],
        "matrix_free_holdout": ["validate", istate, "--matrix_free",
                                "--holdout", "64", "--rank", str(I_RANK),
                                "--cg_tol", str(I_SERVE_TOL),
                                "--cg_max_iters", str(I_ITERS)],
    }
    done = _run_clis({name: argv + ["--dtype", "float32", "--device", "cuda"]
                      for name, argv in runs.items()})
    for name, (rc, out, err, wall) in done.items():
        lines = out.splitlines()
        summary = dict(ln.split() for ln in lines[1:])
        want_n = (64 if "holdout" in name else n3) * C3_T
        ok = rc == 0 and int(summary.get("n", 0)) == want_n
        if name == "model_file_output" and ok:
            rows = pathlib.Path(table).read_text().splitlines()
            ok = len(rows) == n3 + 1 and rows[0].startswith(
                "# per-point LOO: loo_mean_")
        check(ok, f"CLI validate {name} exit {rc} in {wall:.2f} s (the "
              f"three started together, process start included): "
              f"{lines[:1]} {summary}; stderr {err.strip()[-300:]!r}")
    print(f"diagnostics phase wall {time.perf_counter() - t_phase:.1f} s "
          f"({times})")
    require(not failed, f"diagnostics: {len(failed)} checks failed: "
            f"{failed}")
    return paths, k23


def _forrester(x):
    return (6.0 * x - 2.0) ** 2 * np.sin(12.0 * x - 4.0)


def _forrester_check(dev, seed: int, smi: str, check) -> None:
    """The Forrester acceptance case at float64 on the card: 4 expensive and
    21 cheap points (nested), against a single-fidelity GP on the 4."""
    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.models.multifidelity import (
        fit_multifidelity,
        predict_multifidelity,
    )
    from madaiemulator_tpu_torch.utils.config import GPConfig
    from madaiemulator_tpu_torch.utils.designs import apply_scaling

    def low(x):
        return 0.5 * _forrester(x) + 10.0 * (x - 0.5) - 5.0

    def t(a):
        return torch.tensor(a, dtype=torch.float64, device=dev)

    x_lo, x_hi = np.linspace(0.0, 1.0, 21), np.array([0.0, 0.4, 0.6, 1.0])
    cfg = GPConfig(nparams=1, regression_order=1, n_restarts=4,
                   max_opt_steps=40)
    t0 = time.perf_counter()
    emu = fit_multifidelity(
        torch.Generator().manual_seed(seed), [t(x_lo[:, None]),
                                              t(x_hi[:, None])],
        [t(low(x_lo)), t(_forrester(x_hi))], cfg,
        lower_values=[t(low(x_hi))])
    xq = np.linspace(0.0, 1.0, 101)
    m_mf, v_mf = predict_multifidelity(emu, xq[:, None])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    truth = _forrester(xq)
    rmse_mf = float(np.sqrt(np.mean((m_mf.cpu().numpy() - truth) ** 2)))
    dh = gp.GPData(X=apply_scaling(t(x_hi[:, None]), emu.scaling),
                   y=t(_forrester(x_hi)))
    res = fit.fit_gp(torch.Generator().manual_seed(seed), dh, cfg)
    m_sf, _ = gp.gp_posterior(res.params, dh,
                              apply_scaling(t(xq[:, None]), emu.scaling), cfg)
    rmse_sf = float(np.sqrt(np.mean((m_sf.cpu().numpy() - truth) ** 2)))
    check(rmse_sf >= MF_GAIN_MIN * rmse_mf and bool((v_mf >= 0).all()),
          f"Forrester (float64, 21 cheap + 4 expensive, {wall:.2f} s): "
          f"multi-fidelity rmse {rmse_mf:.4g} vs single-fidelity "
          f"{rmse_sf:.4g}, {rmse_sf / rmse_mf:.1f}x >= {MF_GAIN_MIN}x; rho "
          f"{emu.rho.tolist()} (the generative link is 2) ({smi})")


def _text_gap_cause(emu, txt, mdir, Xt, mean, var, scale, pv, check,
                    smi) -> None:
    """Why the text snapshot read back at float32 serves apart from the
    emulator while the .npz serves equal. The text grammar stores
    natural-space thetas, exp of the float32 log-parameters (its bytes are
    the JAX writer's), so a log-parameter may read back an ulp off; every
    other array reads back exact. Printed: that distance in float32 ulps;
    the text read-back with the emulator's own log-parameters put back (its
    serve states rebuilt), gated to serve as the emulator does; and the
    text against the .npz both read at float64, where the state rebuild
    rounds at ~1e-16: how far the model itself moves for that ulp."""
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto
    from madaiemulator_tpu_torch.models.multifidelity import (
        predict_multivariate_multifidelity,
    )
    from madaiemulator_tpu_torch.models.multivariate import _vmapped_states

    ulps = 0.0
    for lt, le in zip(txt.levels, emu.levels):
        for a, b in zip(lt.params, le.params):
            ulp = torch.nextafter(b, torch.full_like(b, float("inf"))) - b
            ulps = max(ulps, ((a - b).abs() / ulp).max().item())
    own = txt._replace(levels=tuple(
        lt._replace(params=le.params, states=_vmapped_states(
            le.params, lt.X, lt.Z, txt.config, noise_pc=lt.noise,
            H_pc=lt.H))
        for lt, le in zip(txt.levels, emu.levels)))
    mo, vo = predict_multivariate_multifidelity(own, Xt)
    dm = (mo - mean).abs().max().item() / scale
    dv = (vo - var).abs().max().item() / pv
    dev = mean.device
    t64, _, _ = read_snapshot_auto(str(mdir / "mf.txt"), device=dev,
                                   dtype=torch.float64)
    n64, _, _ = read_snapshot_auto(str(mdir / "mf.npz"), device=dev,
                                   dtype=torch.float64)
    (mt, vt), (mn, vn) = (predict_multivariate_multifidelity(e, Xt)
                          for e in (t64, n64))
    dm64 = (mt - mn).abs().max().item() / scale
    dv64 = (vt - vn).abs().max().item() / pv
    check(dm <= SERVER_TOL and dv <= SERVER_TOL,
          f"the text snapshot's gap is its log-parameters': they read back "
          f"within {ulps:.0f} float32 ulp of the emulator's; put back, the "
          f"text read-back serves mean {dm:.3g} x scale, variance {dv:.3g} "
          f"x prior var from the emulator (<= {SERVER_TOL}); at float64 "
          f"the text and the .npz serve {dm64:.3g} x scale and {dv64:.3g} "
          f"x prior var apart (not gated) ({smi})")


def phase_multifidelity(dev, seed: int, smi: str, work, native) -> tuple:
    """Multi-fidelity AR(1) co-kriging (models/multifidelity.py) on the
    card: the Forrester acceptance case at float64; then config 3's width
    with a cheap level (MF_N0 runs of a biased copy of phase 7's simulator,
    non-nested) and phase 7's 512 expensive runs at float32, fitted and
    served with the launch counts set to 0 just before and read just after
    (K3 on every diagonal panel of the cheap level's factorizations, K2 on
    the expensive level's); the served rmse on MF_M held-out expensive runs
    against phase 7's single-fidelity snapshot; the text and .npz snapshots
    read back and served, the text one also by native/'s madai_query; the
    per-level LOO; the CLI (estimate_thetas on a MULTIFIDELITY model file,
    interactive_mode, validate). Returns (launches, the emulator)."""
    from madaiemulator_tpu_torch.io.modelfile import (
        write_multifidelity_model_file,
    )
    from madaiemulator_tpu_torch.io.snapshot import (
        read_snapshot,
        read_snapshot_auto,
        write_snapshot_auto,
    )
    from madaiemulator_tpu_torch.models.diagnostics import (
        loo_cv_multifidelity_mv,
        reconstruct_level_targets_mv,
    )
    from madaiemulator_tpu_torch.models.multifidelity import (
        fit_multivariate_multifidelity,
        predict_multivariate_multifidelity,
    )
    from madaiemulator_tpu_torch.models.multivariate import (
        predict_multivariate,
    )
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils.config import GPConfig

    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"multifidelity check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    _forrester_check(dev, seed, smi, check)

    # config 3's width: phase 7's data is the expensive level
    X, Y, f = _heavy_ion_like(np.random.default_rng(seed), C3_N, C3_D, C3_T,
                              with_simulator=True)
    mrng = np.random.default_rng([seed, 13])
    X0 = mrng.uniform(size=(MF_N0, C3_D))
    Y0 = (0.8 * f(X0) + 0.3 * np.sin(3.0 * X0[:, :1]) + 0.1 * X0[:, 1:2]
          + 0.01 * mrng.standard_normal((MF_N0, C3_T)))
    Xt = mrng.uniform(size=(MF_M, C3_D))
    Yt = f(Xt)
    cfg = GPConfig(nparams=C3_D, regression_order=1, n_restarts=C3_R,
                   max_opt_steps=C3_STEPS)

    def T(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    # the main path, the counts set to 0 just before and read just after:
    # the fit of both levels, then serving the held-out runs; the last
    # operands of each kernel and shape kept for the checks below
    k1.launches = k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    with _path_operands() as seen:
        t0 = time.perf_counter()
        emu = fit_multivariate_multifidelity(
            torch.Generator().manual_seed(seed), [T(X0), T(X)],
            [T(Y0), T(Y)], cfg, pca_variance=C3_PCA)
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean, var = predict_multivariate_multifidelity(emu, Xt)
        torch.cuda.synchronize()
        serve_wall = time.perf_counter() - t0
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    st0, st1 = emu.fit_stats
    e0 = st0["n_vg_calls"] + st0["n_v_calls"]
    e1 = st1["n_vg_calls"] + st1["n_v_calls"]
    panels = -(-MF_N0 // cfg.cholesky_block)
    r = emu.n_components
    print(f"multifidelity: levels N={MF_N0} (cheap, K3 route) and N={C3_N} "
          f"(expensive, K2), d={C3_D}, t={C3_T} -> r={r} (pooled PCA "
          f"{C3_PCA}), {C3_R} restarts x {C3_STEPS} steps a level, float32: "
          f"fit {fit_wall:.3f} s (level 0 {st0['fit_wall_s']:.3f} s, "
          f"{e0} objective evaluations, {e0 / st0['n_steps']:.2f} a step; "
          f"level 1 {st1['fit_wall_s']:.3f} s, {e1} evaluations, "
          f"{e1 / st1['n_steps']:.2f} a step); serve {MF_M} queries "
          f"{serve_wall * 1e3:.2f} ms; rho per component "
          f"{[round(v, 4) for v in emu.rho[0].tolist()]} ({smi})")
    # level 0: a Gram (K1) and a factorization (one K3 per diagonal panel)
    # an objective evaluation, and one of each for its serve states; the
    # expensive level's column is level 0's mean at its design (one K1);
    # level 1: K1 + K2 an evaluation and for its states; serving: one K1
    # cross covariance a level
    want = {"pairwise_covariance": (e0 + 1) + 1 + (e1 + 1) + 2,
            "cholesky": e1 + 1, "panel_factor": panels * (e0 + 1)}
    check(launches == want,
          f"multi-fidelity path launches {launches} = {want} (level 0: "
          f"{e0} evaluations + 1 state build, {panels} panels each; level "
          f"1: {e1} + 1; one K1 for the lower-level column, two for "
          f"serving)")
    lls = [ll.amax(dim=1) for ll in emu.restart_log_likelihoods]
    rmse_mf = float(np.sqrt(np.mean((mean.double().cpu().numpy() - Yt)
                                    ** 2)))
    sf, _, _ = read_snapshot(str(pathlib.Path(work) / "config3" /
                                 "state.txt"), device=dev,
                             dtype=torch.float32)
    m_sf, _ = predict_multivariate(sf, Xt)
    rmse_sf = float(np.sqrt(np.mean((m_sf.double().cpu().numpy() - Yt)
                                    ** 2)))
    check(all(bool(torch.isfinite(x).all()) for x in lls)
          and bool(torch.isfinite(mean).all() & torch.isfinite(var).all()
                   & (var >= 0).all()) and bool(torch.isfinite(emu.rho).all()),
          f"every level's best logL finite ({[x.tolist() for x in lls]}); "
          f"served rmse on {MF_M} held-out expensive runs {rmse_mf:.4g} vs "
          f"phase 7's single-fidelity fit on the same 512 runs "
          f"{rmse_sf:.4g} ({rmse_sf / rmse_mf:.2f}x) ({smi})")

    # every kernel on the operands the path handed it: K1 on both levels'
    # Grams (the fit's lanes and the states) and crosses (the lower level's
    # column, the serve), K2 on the expensive level's Grams, K3 on the cheap
    # level's diagonal panels
    checks = _path_kernel_checks(dev, seen, smi, "multifidelity")
    del seen
    torch.cuda.empty_cache()

    mdir = pathlib.Path(work) / "mf"
    mdir.mkdir(parents=True, exist_ok=True)
    scale = float(np.abs(Yt).max())
    # the top level's prior variance: the recursion's rho_k^2 var_{k-1} +
    # amp_k + nugget_k per component
    kss = None
    for lv in emu.levels:
        own = torch.exp(lv.params.log_amp) + torch.exp(lv.params.log_nugget)
        kss = own if kss is None else lv.rho ** 2 * kss + own
    pv = _prior_var(emu, kss)
    served = {}
    for name, tol in (("mf.npz", SERVER_TOL), ("mf.txt", MF_TEXT_SERVE_TOL)):
        path = str(mdir / name)
        write_snapshot_auto(path, emu)
        back, _, _ = read_snapshot_auto(path, device=dev, dtype=torch.float32)
        served[name] = back
        mb, vb = predict_multivariate_multifidelity(back, Xt)
        dm = (mb - mean).abs().max().item() / scale
        dv = (vb - var).abs().max().item() / pv
        check(dm <= tol and dv <= tol,
              f"snapshot {name} ({os.path.getsize(path)} bytes) read back "
              f"and served: mean {dm:.3g} x scale, variance {dv:.3g} x "
              f"prior var <= {tol}")
    _text_gap_cause(emu, served["mf.txt"], mdir, Xt, mean, var, scale, pv,
                    check, smi)
    del served
    # native/'s madai_query on the port-written text snapshot, against the
    # port's float64 serve of the same file
    text = str(mdir / "mf.txt")
    qn = Xt[:64]
    e64, _, _ = read_snapshot_auto(text, device=dev, dtype=torch.float64)
    want = torch.cat(predict_multivariate_multifidelity(e64, qn),
                     dim=1).cpu().numpy()
    rc_build, build_err = native.result()
    if rc_build != 0:
        check(False, f"native/ build exit {rc_build}: {build_err[-400:]}")
    else:
        proc = subprocess.run(
            [str(pathlib.Path(work) / "native" / "madai_query"), text],
            input="".join(" ".join(f"{v:.17g}" for v in p) + "\n"
                          for p in qn),
            capture_output=True, text=True, timeout=120)
        lines = proc.stdout.splitlines()
        head = 1 + C3_D + 1 + 2 * C3_T
        got = (np.asarray(lines[head:], float).reshape(len(qn), 2 * C3_T)
               if proc.returncode == 0 else np.full_like(want, np.nan))
        dm = np.abs(got[:, :C3_T] - want[:, :C3_T]).max() / scale
        dv = np.abs(got[:, C3_T:] - want[:, C3_T:]).max() / np.abs(
            want[:, C3_T:]).max()
        check(proc.returncode == 0 and dm <= MF_NATIVE_TOL
              and dv <= MF_NATIVE_TOL,
              f"madai_query (native/, built in {native.seconds:.1f} s) on "
              f"the port-written version-2 snapshot, {len(qn)} queries, vs "
              f"the port's float64 serve: exit {proc.returncode}, mean "
              f"{dm:.3g} x scale, variance {dv:.3g} x max var <= "
              f"{MF_NATIVE_TOL}; stderr {proc.stderr.strip()[-200:]!r}")
    t0 = time.perf_counter()
    loo = loo_cv_multifidelity_mv(emu)
    torch.cuda.synchronize()
    loo_wall = time.perf_counter() - t0
    parts = []
    for k, (res, lm, lv) in enumerate(loo):
        yk = reconstruct_level_targets_mv(emu, k)
        parts.append(
            f"level {k}: ok {bool(res.ok.all())}, rmse "
            f"{(lm - yk).pow(2).mean().sqrt().item():.4g}, finite "
            f"{bool(torch.isfinite(lm).all() & torch.isfinite(lv).all())}")
    check(all("ok True" in p and "finite True" in p for p in parts),
          f"per-level LOO ({loo_wall:.3f} s): " + "; ".join(parts))

    # the CLI: a MULTIFIDELITY model file -> estimate_thetas ->
    # interactive_mode over the pipe -> validate
    model, state = str(mdir / "model.txt"), str(mdir / "cli_state.txt")
    write_multifidelity_model_file(model, [X0, X], [Y0, Y])
    t0 = time.perf_counter()
    rc, _, err = _run_cli(
        ["estimate_thetas", model, state, "--dtype", "float32", "--device",
         "cuda", "--regression_order", "1", "--pca_variance", str(C3_PCA),
         "--restarts", str(MF_CLI_R), "--steps", str(MF_CLI_STEPS),
         "--seed", str(seed)])
    ok = rc == 0 and pathlib.Path(state).exists()
    check(ok, f"CLI estimate_thetas on a MULTIFIDELITY model file "
          f"(--dtype float32, {MF_CLI_R} x {MF_CLI_STEPS}) exit {rc} in "
          f"{time.perf_counter() - t0:.2f} s (process start included); "
          f"stderr: {err.strip()[-300:]!r}")
    if ok:
        cemu, pn, on = read_snapshot_auto(state, device=dev,
                                          dtype=torch.float32)
        batches = [Xt[:1], Xt[1:64], Xt[64:256]]
        header = ([f"{C3_D}\n"] + [f"{x}\n" for x in pn]
                  + [f"{2 * C3_T}\n"] + [f"mean_{x}\n" for x in on]
                  + [f"variance_{x}\n" for x in on])
        served = _serve_over_pipe(state, batches, C3_D, C3_T, header)
        want = np.concatenate(
            [torch.cat(predict_multivariate_multifidelity(cemu, b),
                       dim=1).cpu().double().numpy() for b in batches])
        sm = np.abs(served[:, :C3_T] - want[:, :C3_T]).max() / scale
        sv = np.abs(served[:, C3_T:] - want[:, C3_T:]).max() / np.abs(
            want[:, C3_T:]).max()
        check(sm <= SERVER_TOL and sv <= SERVER_TOL,
              f"interactive_mode on the CLI's multi-fidelity snapshot vs "
              f"in-process: mean {sm:.3g} x scale, var {sv:.3g} x max var "
              f"<= {SERVER_TOL}")
        rc, out, err = _run_cli(["validate", state, "--dtype", "float32",
                                 "--device", "cuda"])
        lines = [ln for ln in out.splitlines() if ln.startswith("level1_")]
        check(rc == 0 and len(lines) == 8,
              f"CLI validate on the multi-fidelity snapshot exit {rc}: "
              f"{lines[:2]}; stderr {err.strip()[-200:]!r}")
    print(f"multifidelity phase wall {time.perf_counter() - t_phase:.1f} s")
    require(not failed,
            f"multifidelity: {len(failed)} checks failed: {failed}")
    return launches, emu, checks


def _posterior_z(chain, burn, scaling, theta_true) -> tuple:
    """(natural-space kept draws, their mean, std, |mean - truth| / std)."""
    kept = chain[burn:].double().cpu().numpy()
    nat = (kept * scaling.ranges.double().cpu().numpy()
           + scaling.mins.double().cpu().numpy())
    flat = nat.reshape(-1, nat.shape[-1])
    mu, sd = flat.mean(0), flat.std(0)
    return nat, mu, sd, np.abs(mu - theta_true) / np.maximum(sd, 1e-300)


def _iter_emulator(seed: int, dev, iter_params) -> tuple:
    """Phase 10's N=65,536 GP at its fitted thetas as a one-output
    matrix-free emulator, with its serving cache (rank I_RANK, cg_tol
    I_SERVE_TOL): (emulator, cache, the cache's build seconds)."""
    from madaiemulator_tpu_torch.models.multivariate import (
        IterativeMultivariateEmulator,
        precompute_iterative_multivariate,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.utils.config import GPConfig

    idata, _ = _iter_data(seed, dev)
    iemu = _identity_pca_emulator(
        IterativeMultivariateEmulator, I_D, dev, torch.float32,
        X=idata.X, Z=idata.y[:, None],
        params=kernels.GPParams(*(a[None] for a in iter_params)),
        config=GPConfig(nparams=I_D, regression_order=1))
    t0 = time.perf_counter()
    states = precompute_iterative_multivariate(
        iemu, rank=I_RANK, cg_tol=I_SERVE_TOL, cg_max_iters=I_ITERS,
        row_chunk=I_ROW_CHUNK)
    torch.cuda.synchronize()
    return iemu, states, time.perf_counter() - t0


def phase_calibrate(dev, seed: int, smi: str, work, iter_params,
                    mf_emu) -> dict:
    """In-process MCMC calibration (models/calibrate.py) on the card:
    bench/bench_calibrate.py's run (emcee, CAL_W walkers x CAL_STEPS steps)
    over phase 7's config-3 snapshot at float32, with the launch counts set
    to 0 just before the chain and read just after (K1: one cross
    covariance a half-move, two a step, plus the start); steps/s, emulator
    evaluations/s, the busy share, acceptance, R-hat, ESS and the posterior
    mean against the true theta; pt, rwm and hmc; the multi-fidelity
    emulator of phase 13, phase 11's sparse snapshot and phase 10's
    matrix-free emulator on its serving cache; the float32 log-posterior
    against float64 over the walkers; the CLI's calibrate."""
    from madaiemulator_tpu_torch.io.experiment import write_experiment_file
    from madaiemulator_tpu_torch.io.snapshot import (
        read_snapshot,
        read_snapshot_auto,
    )
    from madaiemulator_tpu_torch.models import calibrate as cal
    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"calibrate check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    state = str(pathlib.Path(work) / "config3" / "state.txt")
    emu, _, _ = read_snapshot(state, device=dev, dtype=torch.float32)
    X, _, f = _heavy_ion_like(np.random.default_rng(seed), C3_N, C3_D, C3_T,
                              with_simulator=True)
    crng = np.random.default_rng([seed, 14])
    theta_true = X[7]
    y_exp = f(theta_true[None])[0] + CAL_NOISE * crng.standard_normal(C3_T)
    exp_var = np.full(C3_T, CAL_NOISE ** 2)
    lp = cal.make_log_posterior(emu, y_exp, exp_var)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = cal.init_walkers(gen, emu, lp, CAL_W)

    # the main path: the chain, the counts set to 0 just before and read
    # just after
    k1.launches = k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain, lps, acc = cal.run_emcee(gen, lp, x0, CAL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    want = {"pairwise_covariance": 2 * CAL_STEPS + 1, "cholesky": 0,
            "panel_factor": 0}
    check(launches == want,
          f"emcee path launches {launches} = {want} (one K1 cross "
          f"covariance over the {emu.n_components} components a half-move, "
          f"plus the start)")
    nat, mu, sd, z = _posterior_z(chain, CAL_BURN, emu.scaling, theta_true)
    rhat, ess = cal.gelman_rubin(nat), cal.effective_sample_size(nat)
    acc = float(acc)
    print(f"calibrate emcee: {CAL_W} walkers x {CAL_STEPS} steps on config "
          f"3 (N={C3_N}, t={C3_T}, r={emu.n_components}, float32) in "
          f"{wall:.3f} s: {CAL_STEPS / wall:.1f} steps/s, "
          f"{CAL_STEPS * CAL_W / wall:.0f} emulator evaluations/s; "
          f"acceptance {acc:.3f}; R-hat {np.round(rhat, 4).tolist()}; ESS "
          f"{np.round(ess, 1).tolist()} ({smi})")
    check(0.0 < acc < 1.0 and bool(torch.isfinite(lps[-1]).all())
          and bool((z <= CAL_Z_MAX).all()),
          f"acceptance in (0, 1), every walker finite; posterior mean "
          f"{np.round(mu, 4).tolist()} (sd {np.round(sd, 4).tolist()}) "
          f"against the true theta {np.round(theta_true, 4).tolist()}: "
          f"{np.round(z, 2).tolist()} posterior sd <= {CAL_Z_MAX}")
    xl = chain[-1]
    step_ms = host_ms(lambda: cal.run_emcee(gen, lp, xl, 10), iters=3) / 10
    profile_once("10 emcee steps", lambda: cal.run_emcee(gen, lp, xl, 10),
                 10 * step_ms, smi, cell="calibrate")
    print(f"calibrate time a step (2 half-moves, {CAL_W} walkers): "
          f"{step_ms:.3f} ms wall; the chain's {wall * 1e3 / CAL_STEPS:.3f} "
          f"ms ({smi})")
    # every kernel on the operands of one half-move's evaluation (K1's
    # cross covariance of the walkers over the components), here and for
    # each emulator kind below
    checks = {}

    def half_move_checks(kind, lpx, walkers):
        with _path_operands() as seen:
            lpx(walkers)
        for name, readings in _path_kernel_checks(
                dev, seen, smi, "calibrate", f"{kind} ").items():
            checks.setdefault(name, {}).update(readings)

    half_move_checks("dense", lp, xl[:CAL_W // 2])

    # float32 against float64: the same snapshot's arrays at both
    # precisions (the float32 jitter floor set on both, as phase 7 does),
    # the log-posterior at the same walker positions (the chain's start and
    # its last 20 steps)
    jit32 = kernels.effective_jitter_frac(C3_N, torch.float32, emu.config)
    arrays = dict(
        mins=emu.scaling.mins, ranges=emu.scaling.ranges, X=emu.X, Z=emu.Z,
        ymean=emu.pca.ymean, ystd=emu.pca.ystd,
        eigenvalues=emu.pca.eigenvalues, U=emu.pca.U,
        log_amp=emu.params.log_amp, log_nugget=emu.params.log_nugget,
        log_ls=emu.params.log_ls)
    e64 = emulator_from_numpy(
        {k: v.double().cpu().numpy() for k, v in arrays.items()},
        dataclasses.replace(emu.config, jitter=jit32), device=dev,
        dtype=torch.float64)
    lp64 = cal.make_log_posterior(e64, y_exp, exp_var)
    pos = torch.cat([x0[None], chain[-20:]]).reshape(-1, C3_D)
    with torch.no_grad():
        a, b = lp(pos).double(), lp64(pos.double())
    fin = torch.isfinite(b)
    d_abs = (a - b)[fin].abs().max().item()
    lp_abs = b[fin].abs()
    check(d_abs / C3_T <= CAL_F32_NATS_PER_OBS,
          f"log-posterior float32 vs float64 over {int(fin.sum())} walker "
          f"positions: max {d_abs:.4g} nats, {d_abs / C3_T:.4g} a "
          f"observable <= {CAL_F32_NATS_PER_OBS} (|lp64| "
          f"{lp_abs.min().item():.4g} to {lp_abs.max().item():.4g}; jitter "
          f"{jit32:.3g} x amp on both) ({smi})")

    # the other samplers, from the equilibrated walkers
    for name in ("pt", "rwm", "hmc"):
        run = {"pt": cal.run_parallel_tempering, "rwm": cal.run_rwm,
               "hmc": cal.run_hmc}[name]
        steps = CAL_HMC_STEPS if name == "hmc" else CAL_OTHER_STEPS
        kw = {} if name == "pt" else {"n_adapt": steps // 2}
        t0 = time.perf_counter()
        out = run(gen, lp, xl, steps, **kw)
        torch.cuda.synchronize()
        w_s = time.perf_counter() - t0
        a_s = float(out[2])
        half = out[0][steps // 2:]
        nat_s = (half.double().cpu().numpy()
                 * emu.scaling.ranges.double().cpu().numpy()
                 + emu.scaling.mins.double().cpu().numpy())
        check(0.0 < a_s < 1.0 and bool(torch.isfinite(out[1][-1]).all()),
              f"{name}: {CAL_W} walkers x {steps} steps in "
              f"{w_s:.3f} s ({steps / w_s:.1f} steps/s), "
              f"acceptance {a_s:.3f}"
              + (f", swap rate {float(out[3]):.3f}" if name == "pt" else
                 f", final step {float(out[3]):.4g}")
              + f"; R-hat of the second half "
              f"{np.round(cal.gelman_rubin(nat_s), 3).tolist()} ({smi})")

    def small_run(kind, label, e, y, v, steps, walkers, **lp_kw):
        lpx = cal.make_log_posterior(e, y, v, **lp_kw)
        g = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        xs = cal.init_walkers(g, e, lpx, walkers)
        ch, lq, ac = cal.run_emcee(g, lpx, xs, steps)
        torch.cuda.synchronize()
        w_s = time.perf_counter() - t0
        ac = float(ac)
        check(0.0 < ac < 1.0 and bool(torch.isfinite(lq[-1]).all()),
              f"{label}: {walkers} walkers x {steps} emcee steps in "
              f"{w_s:.3f} s ({steps / w_s:.1f} steps/s, "
              f"{steps * walkers / w_s:.0f} evaluations/s), acceptance "
              f"{ac:.3f}, every walker finite ({smi})")
        half_move_checks(kind, lpx, ch[-1][:walkers // 2])
        return ch

    ch = small_run("multi-fidelity",
                   "multi-fidelity (phase 13's emulator, two levels)",
                   mf_emu, y_exp, exp_var, CAL_OTHER_STEPS, CAL_W)
    _, mu_m, sd_m, z_m = _posterior_z(ch, CAL_OTHER_STEPS // 4,
                                      mf_emu.scaling, theta_true)
    print(f"calibrate multi-fidelity posterior mean "
          f"{np.round(mu_m, 4).tolist()} (sd {np.round(sd_m, 4).tolist()}),"
          f" {np.round(z_m, 2).tolist()} sd from the true theta")
    semu, _, _ = read_snapshot_auto(
        str(pathlib.Path(work) / "sparse" / "sgpr_1m.npz"), device=dev,
        dtype=torch.float32)
    th_s = torch.tensor([[0.3, 0.6, 0.5, 0.7]], dtype=torch.float64)
    y_s = _truth1m(th_s).numpy() + S_NOISE * crng.standard_normal(1)
    small_run("sparse", f"sparse (phase 11's N={S_N} snapshot, m={S_M})",
              semu, y_s, [S_NOISE ** 2], CAL_SMALL_STEPS, CAL_SMALL_W)
    iemu, states, pre_s = _iter_emulator(seed, dev, iter_params)
    th_i = np.array([[0.3, 0.6, 0.5, 0.7, 0.2, 0.4, 0.6, 0.8]])
    y_i = _truth64k(th_i) + I_NOISE * crng.standard_normal(1)
    small_run("matrix-free", f"matrix-free (phase 10's N={I_N} emulator, "
              f"serving cache {pre_s:.2f} s, precond variances)", iemu, y_i,
              [I_NOISE ** 2], CAL_SMALL_STEPS, CAL_SMALL_W, states=states,
              variance_method="precond", row_chunk=I_ROW_CHUNK)
    del states, iemu

    # the CLI over phase 7's snapshot with an experiment file
    exp = str(pathlib.Path(work) / "config3" / "experiment.txt")
    draws = str(pathlib.Path(work) / "config3" / "draws.txt")
    write_experiment_file(exp, y_exp, exp_var)
    t0 = time.perf_counter()
    rc, _, err = _run_cli(
        ["calibrate", state, exp, "--dtype", "float32", "--device", "cuda",
         "--n_walkers", str(CAL_W), "--n_steps", str(CAL_CLI_STEPS),
         "--seed", str(seed), "--output", draws])
    cli_wall = time.perf_counter() - t0
    rows = (np.loadtxt(draws) if rc == 0 else np.zeros((0, C3_D)))
    kept = CAL_CLI_STEPS - CAL_CLI_STEPS // 4
    check(rc == 0 and rows.shape == (kept * CAL_W, C3_D)
          and bool(np.isfinite(rows).all()),
          f"CLI calibrate --dtype float32 ({CAL_W} x {CAL_CLI_STEPS}) exit "
          f"{rc} in {cli_wall:.2f} s (process start included): draws "
          f"{rows.shape}; stderr tail {err.strip()[-300:]!r}")
    print(f"calibrate phase wall {time.perf_counter() - t_phase:.1f} s")
    require(not failed, f"calibrate: {len(failed)} checks failed: {failed}")
    return launches, checks


def _ishigami(U):
    """Ishigami on [0,1]^3 mapped to [-pi, pi]^3 (a=7, b=0.1)."""
    X = (U - 0.5) * (2.0 * math.pi)
    return (torch.sin(X[:, 0]) + 7.0 * torch.sin(X[:, 1]) ** 2
            + 0.1 * X[:, 2] ** 4 * torch.sin(X[:, 0]))


def _sobol_se(f, A, B) -> tuple:
    """The Saltelli estimates of f (numpy (m, d) -> (m, t)) on the designs A
    and B (n, d) and their Monte Carlo standard errors (the per-sample
    terms' sd over sqrt(n)): (first, total, se_first, se_total), each
    (d, t)."""
    n, d = A.shape
    fA, fB = f(A), f(B)
    fAB = np.stack([f(np.where(np.arange(d) == i, B, A)) for i in range(d)])
    pooled = np.concatenate([fA, fB])
    V = pooled.var(0)
    t1 = fB[None] * (fAB - fA[None]) / V
    tt = (fA[None] - fAB) ** 2 / (2.0 * V)
    return (t1.mean(1), tt.mean(1), t1.std(1) / math.sqrt(n),
            tt.std(1) / math.sqrt(n))


def _picks_agree(pool, w64, sel32, sel64, gap) -> tuple:
    """(ok, what): the float32 picks equal the float64 ones, or at the first
    pick where they split the two candidates' float64 greedy scores (the
    same earlier picks) differ by at most 2 gap x max w64 x their distance
    factor: a near-tie the float32 weights' gap can split."""
    d = pool.shape[1]
    for i, (a, b) in enumerate(zip(sel32, sel64)):
        if a == b:
            continue
        if i == 0:
            fa = fb = 1.0
        else:
            prev = pool[list(sel64[:i])]
            fa = min(float(d), float(((prev - pool[a]) ** 2).sum(1).min()))
            fb = min(float(d), float(((prev - pool[b]) ** 2).sum(1).min()))
        sa, sb = w64[a] * fa, w64[b] * fb
        lim = 2.0 * gap * w64.max() * max(fa, fb)
        return (sb - sa <= lim,
                f"split at pick {i}: float64 scores {sa:.6g} (float32's) vs "
                f"{sb:.6g}, apart {sb - sa:.3g} <= {lim:.3g}")
    return True, f"all {len(sel32)} picks equal"


def phase_design(dev, seed: int, smi: str, work, iter_params,
                 mf_emu) -> tuple:
    """Sequential design and Sobol sensitivity (models/design.py,
    models/sensitivity.py) on the card: on phase 7's config-3 snapshot at
    float32, an active-variance batch, an NROY wave against phase 14's
    experiment file, Sobol indices and main effects, each with the launch
    counts set to 0 just before and read just after and K1 / K2 equal to
    the counts the chunking implies; the acquisition weights, the picks,
    the viable fraction and the Sobol indices against a float64 emulator on
    the same pool and draws; the Sobol indices against the simulator's own
    and Ishigami against its closed forms; every NROY pick's float64
    implausibility; the other kinds (phase 13's multi-fidelity emulator,
    phase 11's N=10^6 sparse snapshot, phase 10's N=65,536 matrix-free
    emulator on its serving cache); K1 on every path's own operands; the
    CLI's design (both methods, --matrix_free) and sensitivity
    --main_effects against the in-process calls; compat's 1-D sin at
    float64 and float32. Every check is made and printed; the phase fails
    at its end if any did not pass."""
    from madaiemulator_tpu_torch import compat
    from madaiemulator_tpu_torch.cli import _sensitivity_fn
    from madaiemulator_tpu_torch.io.experiment import read_experiment_file
    from madaiemulator_tpu_torch.io.snapshot import (
        read_snapshot,
        read_snapshot_auto,
    )
    from madaiemulator_tpu_torch.models import design, sensitivity
    from madaiemulator_tpu_torch.models.calibrate import (
        implausibility_from_moments,
    )
    from madaiemulator_tpu_torch.models.multivariate import (
        _predict_components,
        emulator_from_numpy,
        reconstruct_observables,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils import profiling
    from madaiemulator_tpu_torch.utils.designs import (
        apply_scaling,
        unapply_scaling,
    )

    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"design check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    def gen(k=0):
        return torch.Generator().manual_seed(seed + k)

    def counted(fn):
        """(fn(), wall s, launches), the counts set to 0 just before."""
        k1.launches = k2.launches = k3.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            "pairwise_covariance": k1.launches, "cholesky": k2.launches,
            "panel_factor": k3.launches}

    def k1_only(n):
        return {"pairwise_covariance": n, "cholesky": 0, "panel_factor": 0}

    def in_box(pts, emu):
        lo = emu.scaling.mins.double().cpu().numpy()
        hi = lo + emu.scaling.ranges.double().cpu().numpy()
        tol = 1e-6 * (hi - lo)
        return bool(np.isfinite(pts).all() and (pts >= lo - tol).all()
                    and (pts <= hi + tol).all())

    c3 = pathlib.Path(work) / "config3"
    state, exp = str(c3 / "state.txt"), str(c3 / "experiment.txt")
    emu, _, _ = read_snapshot(state, device=dev, dtype=torch.float32)
    jit32 = kernels.effective_jitter_frac(C3_N, torch.float32, emu.config)
    arrays = {k: v.double().cpu().numpy() for k, v in dict(
        mins=emu.scaling.mins, ranges=emu.scaling.ranges, X=emu.X, Z=emu.Z,
        ymean=emu.pca.ymean, ystd=emu.pca.ystd,
        eigenvalues=emu.pca.eigenvalues, U=emu.pca.U,
        log_amp=emu.params.log_amp, log_nugget=emu.params.log_nugget,
        log_ls=emu.params.log_ls).items()}
    e64 = emulator_from_numpy(arrays, dataclasses.replace(
        emu.config, jitter=jit32), device=dev, dtype=torch.float64)
    y_exp, exp_var = read_experiment_file(exp)
    _, _, f = _heavy_ion_like(np.random.default_rng(seed), C3_N, C3_D, C3_T,
                              with_simulator=True)
    fn32 = sensitivity.multivariate_mean_fn(emu)
    n_sob = SOB_N * (C3_D + 2)
    n_me = C3_D * ME_GRID * ME_N

    def run_v(e=emu, **kw):
        return design.active_variance_design(gen(), e, DES_NEW,
                                             pool_size=DES_POOL, **kw)

    def run_n():
        return design.nroy_wave_design(
            gen(), emu, y_exp, exp_var, DES_NEW, threshold=DES_THRESHOLD,
            pool_size=DES_NROY_POOL)

    def run_s(fn=fn32, d=C3_D):
        return sensitivity.sobol_indices(fn, d, gen(), n=SOB_N,
                                         query_chunk=SEN_QC, device=dev)

    def run_m():
        return sensitivity.main_effects(fn32, C3_D, gen(1), grid=ME_GRID,
                                        n=ME_N, query_chunk=SEN_QC,
                                        device=dev)

    # the main paths on config 3, each counted
    prop_v, wall_v, l_v = counted(run_v)
    prop_n, wall_n, l_n = counted(run_n)
    sob, wall_s, l_s = counted(run_s)
    (gv, eff), wall_m, l_m = counted(run_m)
    chunks_s, chunks_m = -(-n_sob // SEN_QC), -(-n_me // SEN_QC)
    for what, got, want in (
            (f"active_variance_design (pool {DES_POOL})", l_v, k1_only(1)),
            (f"nroy_wave_design (pool {DES_NROY_POOL})", l_n, k1_only(1)),
            (f"sobol_indices ({n_sob} evaluations, {chunks_s} chunks)", l_s,
             k1_only(chunks_s)),
            (f"main_effects ({n_me} evaluations, {chunks_m} chunks)", l_m,
             k1_only(chunks_m))):
        check(got == want, f"config-3 {what} launches {got} = {want} (one "
              f"K1 cross covariance a predict; the states exist)")
    paths = {"design": {k: l_v[k] + l_n[k] for k in l_v},
             "sensitivity": {k: l_s[k] + l_m[k] for k in l_s}}
    check(prop_v.points.shape == prop_n.points.shape == (DES_NEW, C3_D)
          and in_box(prop_v.points, emu) and in_box(prop_n.points, emu)
          and bool(torch.isfinite(sob.first).all()
                   & torch.isfinite(sob.total).all())
          and sob.first.shape == (C3_D, C3_T)
          and eff.shape == (C3_D, ME_GRID, C3_T)
          and bool(torch.isfinite(eff).all()),
          f"config-3 outputs: {DES_NEW} finite points inside the design box "
          f"from each design (NROY viable fraction "
          f"{prop_n.pool_fraction_viable:.4f}), Sobol indices "
          f"{tuple(sob.first.shape)} and main effects {tuple(eff.shape)} "
          f"finite")

    # float32 against float64 on the same pool: the weights, the picks
    pool = design._candidate_pool(gen(), DES_POOL, C3_D,
                                  torch.float32).to(dev)

    def moments(e, P):
        m, v = _predict_components(e.states, e.params, e.X, e.Z, P, e.config,
                                   dZ=e.dZ)
        return reconstruct_observables(m, v, e.pca)

    with torch.no_grad():
        w32 = design._variance_weights(moments(emu, pool)[1], emu.pca.ystd)
        w64 = design._variance_weights(moments(e64, pool.double())[1],
                                       e64.pca.ystd)
    wgap = ((w32.double() - w64).abs().max() / w64.abs().max()).item()
    sel32 = design._greedy_maximin(pool, w32, DES_NEW)[0].tolist()
    sel64 = design._greedy_maximin(pool.double(), w64, DES_NEW)[0].tolist()
    same_entry = np.array_equal(prop_v.points, unapply_scaling(
        pool[sel32], emu.scaling).cpu().numpy())
    ok_p, what_p = _picks_agree(pool.double().cpu().numpy(),
                                w64.cpu().numpy(), sel32, sel64, wgap)
    check(wgap <= DES_WEIGHT_RTOL and same_entry and ok_p,
          f"acquisition weights float32 vs float64 over the {DES_POOL}-point "
          f"pool: {wgap:.3g} x max <= {DES_WEIGHT_RTOL} (jitter {jit32:.3g} "
          f"x amp on both); the entry point's picks are the pool's "
          f"{sel32}: {same_entry}; float64 picks {sel64}: {what_p}")

    # the NROY screen: the viable fraction, every pick's float64
    # implausibility
    pooln = design._candidate_pool(gen(), DES_NROY_POOL, C3_D,
                                   torch.float32).to(dev)
    s2 = torch.tensor(exp_var, device=dev)
    yq = torch.tensor(y_exp, device=dev)
    with torch.no_grad():
        imp32 = implausibility_from_moments(*moments(emu, pooln),
                                            yq.float(), s2.float()).double()
        imp64 = implausibility_from_moments(*moments(e64, pooln.double()),
                                            yq, s2)
    igap = (imp32 - imp64).abs().max().item()
    frac64 = (imp64 <= DES_THRESHOLD).double().mean().item()
    frac32 = prop_n.pool_fraction_viable
    near = int(((imp64 - DES_THRESHOLD).abs() <= igap).sum())
    picks = apply_scaling(torch.tensor(prop_n.points, device=dev,
                                       dtype=torch.float64), e64.scaling)
    with torch.no_grad():
        imp_picks = implausibility_from_moments(*moments(e64, picks), yq,
                                                s2).cpu().numpy()
    k_viable = min(DES_NEW, int(round(frac32 * DES_NROY_POOL)))
    check(abs(frac32 - frac64) * DES_NROY_POOL <= near
          and bool((imp_picks[:k_viable] <= DES_THRESHOLD + igap).all()),
          f"NROY viable fraction float32 {frac32:.5f} vs float64 "
          f"{frac64:.5f} ({abs(frac32 - frac64) * DES_NROY_POOL:.0f} points "
          f"apart <= {near} within the implausibility gap {igap:.3g} of "
          f"{DES_THRESHOLD}); the picks' float64 implausibility "
          f"{np.round(imp_picks, 3).tolist()}: the first {k_viable} <= "
          f"{DES_THRESHOLD} + gap")

    # Sobol: float32 against float64 on the same draws; against the
    # simulator on the same A and B; Ishigami
    sob64 = run_s(sensitivity.multivariate_mean_fn(e64))
    sgap = max((a.double() - b).abs().max().item()
               for a, b in zip(sob[:2], sob64[:2]))
    check(sgap <= SOB_F32_ATOL,
          f"Sobol indices float32 vs float64 (the same {SOB_N}-point A and "
          f"B): max {sgap:.3g} <= {SOB_F32_ATOL}")
    A, B = sensitivity._saltelli_uniform(gen(), SOB_N, C3_D, torch.float32,
                                         dev)
    raw = [unapply_scaling(M.double(), e64.scaling).cpu().numpy()
           for M in (A, B)]
    mins = e64.scaling.mins.cpu().numpy()
    ranges = e64.scaling.ranges.cpu().numpy()
    s1, st, se1, set_ = _sobol_se(f, *raw)
    dev1 = np.abs(sob.first.double().cpu().numpy() - s1)
    devt = np.abs(sob.total.double().cpu().numpy() - st)
    lim1, limt = 3.0 * se1 + SOB_TRUTH_ATOL, 3.0 * set_ + SOB_TRUTH_ATOL
    check(bool((dev1 <= lim1).all() and (devt <= limt).all()),
          f"Sobol indices against the simulator's own on the same A and B "
          f"(raw box {np.round(mins, 4).tolist()} + "
          f"{np.round(ranges, 4).tolist()}): first max |diff| "
          f"{dev1.max():.3g} (largest share of its limit "
          f"{(dev1 / lim1).max():.3g}), total {devt.max():.3g} "
          f"({(devt / limt).max():.3g}); limit 3 MC standard errors "
          f"(median {np.median(se1):.3g} / {np.median(set_):.3g}) + "
          f"{SOB_TRUTH_ATOL}; simulator totals by parameter "
          f"{np.round(st.max(1), 3).tolist()}")
    a_, b_, pi = 7.0, 0.1, math.pi
    V1 = 0.5 * (1 + b_ * pi ** 4 / 5) ** 2
    V2 = a_ ** 2 / 8
    V13 = b_ ** 2 * pi ** 8 * (1 / 18 - 1 / 50)
    V = V1 + V2 + V13
    ish = sensitivity.sobol_indices(_ishigami, 3, gen(), n=ISHIGAMI_N,
                                    dtype=torch.float64, device=dev)
    e1 = np.abs(ish.first.cpu().numpy() - [V1 / V, V2 / V, 0.0]).max()
    et = np.abs(ish.total.cpu().numpy()
                - [(V1 + V13) / V, V2 / V, V13 / V]).max()
    ev = abs(ish.variance.item() - V) / V
    check(e1 <= ISHIGAMI_ATOL and et <= ISHIGAMI_ATOL and ev <= 0.05,
          f"Ishigami on the card (n={ISHIGAMI_N}, float64): first "
          f"{np.round(ish.first.cpu().numpy(), 4).tolist()} off by {e1:.3g},"
          f" total off by {et:.3g} <= {ISHIGAMI_ATOL}; variance {ev:.3g} "
          f"<= 0.05 of {V:.4f}")

    # the other emulator kinds, each counted; their operands kept for the
    # kernel checks
    semu, _, _ = read_snapshot_auto(
        str(pathlib.Path(work) / "sparse" / "sgpr_1m.npz"), device=dev,
        dtype=torch.float32)
    iemu, states, _ = _iter_emulator(seed, dev, iter_params)
    n_lv = len(mf_emu.levels)
    kinds = {
        "multi-fidelity": (mf_emu, {}, n_lv),
        "sparse": (semu, {}, 1),
        "matrix-free": (iemu, dict(states=states, row_chunk=I_ROW_CHUNK),
                        -(-DES_POOL // 1024)),
    }
    walls = {"config 3": wall_v}
    for kind, (e, kw, per) in kinds.items():
        prop, walls[kind], got = counted(lambda e=e, kw=kw: run_v(e, **kw))
        check(got == k1_only(per) and prop.points.shape[0] == DES_NEW
              and in_box(prop.points, e),
              f"{kind} active_variance_design (pool {DES_POOL}) in "
              f"{walls[kind]:.3f} s: launches {got} = {k1_only(per)}; "
              f"{DES_NEW} finite points inside the design box")
        if kind == "matrix-free":
            continue
        fn, d = _sensitivity_fn(e)
        res, w_s, got = counted(lambda fn=fn, d=d: run_s(fn, d))
        want = k1_only(per * -(-SOB_N * (d + 2) // SEN_QC))
        check(got == want and bool(torch.isfinite(res.first).all()
                                   & torch.isfinite(res.total).all()),
              f"{kind} sobol_indices ({SOB_N * (d + 2)} evaluations) in "
              f"{w_s:.3f} s: launches {got} = {want}; indices finite, "
              f"largest total {res.total.max().item():.3f}")
    checks = {}
    for kind, (e, kw, _) in [("config-3", (emu, {}, 1))] + list(
            kinds.items()):
        with _path_operands() as seen:
            run_v(e, **kw)
        for name, readings in _path_kernel_checks(
                dev, seen, smi, "design", f"{kind} ").items():
            checks.setdefault(name, {}).update(readings)
    del states, iemu, semu

    # times (best of 3 after a warm-up, utils.profiling.timed) and the busy
    # share
    t_v, _ = profiling.timed(run_v)
    t_n, _ = profiling.timed(run_n)
    t_s, _ = profiling.timed(run_s)
    t_m, _ = profiling.timed(run_m)
    print(f"design times (best of 3): active_variance_design "
          f"{t_v * 1e3:.3f} ms, nroy_wave_design {t_n * 1e3:.3f} ms; design "
          f"walls of the counted runs by kind "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; sobol_indices {t_s * 1e3:.3f} ms = {n_sob / t_s:.0f} "
          f"evaluations/s; main_effects {t_m * 1e3:.3f} ms = "
          f"{n_me / t_m:.0f} evaluations/s ({smi})")
    for what, fn, t in (("active_variance_design", run_v, t_v),
                        ("sobol_indices", run_s, t_s),
                        ("main_effects", run_m, t_m)):
        profile_once(what, fn, t * 1e3, smi, cell="design")

    # the CLI on phase 7's snapshot against the in-process calls (the same
    # seeds, the port's own draws), the four processes started together
    out = {k: str(c3 / f"{k}.txt") for k in ("variance", "nroy", "sobol",
                                             "effects")}
    cstate = str(pathlib.Path(work) / "iterative" / "iter_state.txt")
    ipts = str(c3 / "design_matrix_free.txt")
    runs = {
        "design --method=variance": ["design", state, "--method",
                                     "variance", "--output",
                                     out["variance"]],
        "design --method=nroy": [
            "design", state, "--method", "nroy", "--output", out["nroy"],
            "--experiment_file", exp, "--threshold", str(DES_THRESHOLD),
            "--pool_size", str(DES_NROY_POOL)],
        "sensitivity --main_effects": [
            "sensitivity", state, "--output", out["sobol"], "--main_effects",
            out["effects"]],
        f"design --matrix_free on phase 10's N={I_CLI_N} snapshot": [
            "design", cstate, "--matrix_free", "--output", ipts],
    }
    done = _run_clis({what: argv + ["--dtype", "float32", "--device", "cuda",
                                    "--seed", str(seed), "--quiet"]
                      for what, argv in runs.items()})
    cli_ok = {}
    for what, (rc, _, err, wall) in done.items():
        check(rc == 0, f"CLI {what} exit {rc} in {wall:.2f} s (the four "
              f"started together, process start included); stderr "
              f"{err.strip()[-300:]!r}")
        cli_ok[what] = rc == 0
    for method, prop in (("variance", prop_v), ("nroy", prop_n)):
        if cli_ok[f"design --method={method}"]:
            rows = np.loadtxt(out[method], ndmin=2)
            check(np.array_equal(rows, prop.points.astype(np.float64)),
                  f"CLI design --method={method}: {rows.shape[0]} rows equal "
                  f"the in-process proposal's")
    if cli_ok["sensitivity --main_effects"]:
        tab = [ln.split() for ln in open(out["sobol"]) if ln[0] != "#"]
        got = np.array([[float(r[2]), float(r[3])] for r in tab])
        want = np.stack([sob.first.cpu().numpy().reshape(-1),
                         sob.total.cpu().numpy().reshape(-1)], 1)
        me = np.loadtxt(out["effects"])
        me_want = np.concatenate(
            [gv.cpu().numpy()[:, None],
             eff.cpu().numpy().transpose(1, 0, 2).reshape(ME_GRID, -1)], 1)
        check(np.array_equal(got, want.astype(np.float64))
              and np.array_equal(me, me_want.astype(np.float64)),
              f"CLI sensitivity: the {len(tab)}-row Sobol table and the "
              f"{me.shape} main-effects table equal the in-process results "
              f"(max diff {np.abs(got - want).max():.3g}, "
              f"{np.abs(me - me_want).max():.3g})")
    if cli_ok[f"design --matrix_free on phase 10's N={I_CLI_N} snapshot"]:
        cemu, _, _ = read_snapshot(cstate, device=dev, dtype=torch.float32,
                                   build_states=False)
        rows = np.loadtxt(ipts, ndmin=2)
        check(rows.shape == (DES_NEW, C3_D) and in_box(rows, cemu),
              f"CLI design --matrix_free: {rows.shape} finite points inside "
              f"the design box")

    # compat: tests/test_compat.py's 1-D sin on the card
    Xs = np.linspace(0, 10, 30)[:, None]
    ys = np.sin(Xs[:, 0])
    q = np.linspace(0.5, 9.5, 20)[:, None]
    for dtype in (None, torch.float32):
        t0 = time.perf_counter()
        th = compat.call_estimate(Xs, ys, n_restarts=3, max_steps=40, seed=1,
                                  dtype=dtype, device=dev)
        m, v = compat.call_emulate_at_list(Xs, ys, th, q, dtype=dtype,
                                           device=dev)
        rmse = float(np.sqrt(np.mean((m - np.sin(q[:, 0])) ** 2)))
        check(rmse < COMPAT_RMSE and bool(np.all(v >= 0)),
              f"compat {'float64' if dtype is None else 'float32'}: thetas "
              f"{np.round(th.astype(np.float64), 5).tolist()}, rmse {rmse:.3g}"
              f" < {COMPAT_RMSE}, variances >= 0 "
              f"({time.perf_counter() - t0:.2f} s)")
    print(f"design phase wall {time.perf_counter() - t_phase:.1f} s")
    require(not failed, f"design: {len(failed)} checks failed: {failed}")
    return paths, checks


class _SkewBuild:
    """The test-only skewed build of K2 and K3 (`build.load_skewed`),
    compiled in a thread beside phase 2's build."""

    def __init__(self):
        from madaiemulator_tpu_torch.ops.hopper import build

        self.seconds, self.error = None, None

        def run():
            t0 = time.perf_counter()
            try:
                build.load_skewed()
            except Exception as e:  # reported by result()
                self.error = e
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self, raise_error: bool = True) -> float:
        """Wait for the build (its nvcc processes end with it); the seconds
        it took, or its error raised."""
        self.thread.join(timeout=600)
        if raise_error:
            require(not self.thread.is_alive(),
                    "skewed build: no end in 600 s")
            if self.error is not None:
                raise self.error
        return self.seconds


class _NativeBuild:
    """native/ (libmadai_emu.so and madai_query) built by make in the
    background into `out` while the phases before it run; `stop` kills it
    if it is still running."""

    def __init__(self, out: pathlib.Path):
        t0 = time.perf_counter()
        self.seconds, self.out = None, ""
        self.proc = subprocess.Popen(
            ["make", "-C", str(ROOT / "native"), f"BUILD={out}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def wait():
            self.out = self.proc.communicate()[0] or ""
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=wait, daemon=True)
        self.thread.start()

    def result(self) -> tuple:
        self.thread.join(timeout=600)
        return self.proc.returncode, self.out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.thread.join(timeout=60)


def _mesh_counts(reset: bool = False) -> dict:
    """The three kernels' launch counts (set to 0 first when reset)."""
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    if reset:
        torch.cuda.synchronize()
        k1.launches = k2.launches = k3.launches = 0
    return {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
            "panel_factor": k3.launches}


def _vg(f, params):
    """(value, gradients) of f at params, the gradients by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in params]
    v = f(type(params)(*leaves))
    return v.detach(), torch.autograd.grad(v, leaves)


def _mesh_kernel_checks(dev, seen, smi, label, checks) -> None:
    """Every kernel on the operands a sharded call handed it
    (`_path_operands`), merged into `checks` by kernel name."""
    for name, readings in _path_kernel_checks(dev, seen, smi, "mesh",
                                              f"{label} ").items():
        checks.setdefault(name, {}).update(readings)


def _mesh_ensemble(dev, devices, label, seed, smi, check, checks) -> dict:
    """Step (a): config 5 (phase 8's data at full width, MESH_C5_STEPS
    L-BFGS steps) fitted and served over an (ensemble) mesh of the given
    devices, beside the unsharded fit from the same starts."""
    from madaiemulator_tpu_torch.models import fit
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.parallel import ensemble
    from madaiemulator_tpu_torch.parallel import mesh as mesh_lib
    from madaiemulator_tpu_torch.utils.config import GPConfig

    S = len(devices)
    E, N, d, R, M = C5_E, C5_N, C5_D, C5_R, C5_M
    X, y, Xs = _c5_data(seed, dev)
    cfg = GPConfig(nparams=d, regression_order=1, n_restarts=R,
                   max_opt_steps=MESH_C5_STEPS)
    mesh = ensemble.make_mesh(devices=devices)
    _mesh_counts(reset=True)
    t0 = time.perf_counter()
    res = ensemble.fit_ensemble(torch.Generator().manual_seed(seed), X, y,
                                cfg, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, var = ensemble.predict_ensemble(res.params, X, y, Xs, cfg,
                                          mesh=mesh)
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    got = _mesh_counts()
    evals = [s["n_vg_calls"] + s["n_v_calls"] for s in res.stats["shards"]]
    want = {"pairwise_covariance": sum(evals) + 2 * S,
            "cholesky": sum(evals) + S, "panel_factor": 0}
    check(got == want,
          f"{label} config 5 launches {got} = {want}: each of the {S} "
          f"shards' {evals} objective evaluations one K1 and one K2, "
          f"predict 2 K1 + 1 K2 a shard")
    pred0 = host_ms(lambda: ensemble.predict_ensemble(res.params, X, y, Xs,
                                                      cfg), iters=3)
    t0 = time.perf_counter()
    res0 = ensemble.fit_ensemble(torch.Generator().manual_seed(seed), X, y,
                                 cfg)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    n0 = res0.stats["n_vg_calls"] + res0.stats["n_v_calls"]
    ll0 = res0.log_likelihood
    ll1 = res.log_likelihood.to(ll0.device)
    both = torch.isfinite(ll0) & torch.isfinite(ll1)
    finite = torch.isfinite(ll1).double().mean().item()
    equal = ((ll1 - ll0).abs() <= MESH_FIT_RTOL * ll0.abs())[both]
    bitwise = (ll1 == ll0)[both].double().mean().item()
    print(f"{label} config 5: E={E} x R={R}, {MESH_C5_STEPS} steps, over "
          f"{S} shards ({devices[0]}"
          f"{'' if len(set(devices)) == 1 else ' ...'}), fit "
          f"{wall:.3f} s (unsharded, the same starts: {wall0:.3f} s), "
          f"objective evaluations a shard {evals} (unsharded: {n0}); "
          f"predict {M} a member {pred_wall * 1e3:.3f} ms (unsharded "
          f"{pred0:.3f} ms); the fit's per-member best LML against the "
          f"unsharded fit's: finite fraction "
          f"{finite:.6g}, equal within {MESH_FIT_RTOL} x |LML| "
          f"{equal.double().mean().item():.6g}, bitwise {bitwise:.6g} "
          f"(reported, not gated) ({smi})")
    check(finite >= C5_FINITE and mean.shape == (E, M)
          and bool(torch.isfinite(mean).all() & torch.isfinite(var).all()),
          f"{label} config 5: finite fraction {finite:.6g} >= {C5_FINITE}; "
          f"predictions ({E}, {M}) finite")
    # one batched LML value+grad at the fit's restart params, the lanes
    # split over the mesh as the fit split them, against one batch: gated at
    # float64 (library math; the fitted Grams sit at cond up to ~1e7, where
    # float32's batched GEMMs of another batch size round apart by far
    # more than 1e-6), reported at float32 with its bitwise share
    Xl = X[:, None].expand(E, R, N, d).reshape(E * R, N, d)
    yl = y[:, None].expand(E, R, N).reshape(E * R, N)
    pl = kernels.GPParams(*(a.to(dev).reshape((E * R,) + a.shape[2:])
                            for a in res.restart_params))

    def lane_vg(Xa, ya, p):
        lo, hi = fit._bounds_arrays(cfg, ya.dtype, Xa.device)
        vg, _ = fit._lane_objective(Xa, ya, None, cfg, lo, hi,
                                    fit._new_stats())
        return vg(fit._flatten_t(fit._params_to_u(p, lo, hi)))

    blocks = mesh_lib.blocks(E * R, S)

    def sharded(Xa, ya, p):
        parts = mesh.map(
            devices, lambda dv, b: lane_vg(
                Xa[b[0]:b[1]].to(dv), ya[b[0]:b[1]].to(dv),
                kernels.GPParams(*(a[b[0]:b[1]].to(dv) for a in p))),
            devices, blocks)
        return (mesh_lib.gather([q[0] for q in parts], dev),
                mesh_lib.gather([q[1] for q in parts], dev))

    def gaps(Xa, ya, p):
        v0, g0 = lane_vg(Xa, ya, p)
        v1, g1 = sharded(Xa, ya, p)
        ok = torch.isfinite(v0) & torch.isfinite(g0).all(-1)
        dv = ((v1 - v0).abs() / v0.abs().clamp(min=1.0))[ok].max().item()
        dg = ((g1 - g0).abs().amax(-1) / g0.abs().amax(-1).clamp(min=1.0)
              )[ok].max().item()
        bits = ((v1 == v0) & (g1 == g0).all(-1))[ok].double().mean().item()
        return dv, dg, bits, int(ok.sum())

    dv32, dg32, bits32, n32 = gaps(Xl, yl, pl)
    if checks is not None:
        # K1 and K2 on a shard's operands: the value+grad's (E R / S, N, N)
        # Grams, predict's (E / S, N, N) Grams and (E / S, N, M) crosses
        with _path_operands() as seen:
            sharded(Xl, yl, pl)
            ensemble.predict_ensemble(res.params, X, y, Xs, cfg, mesh=mesh)
        _mesh_kernel_checks(dev, seen, smi, label, checks)
    p64 = kernels.GPParams(*(a.double() for a in pl))
    dv64, dg64, bits64, n64 = gaps(Xl.double(), yl.double(), p64)
    t_sh = host_ms(lambda: sharded(Xl, yl, pl), iters=3)
    t_one = host_ms(lambda: lane_vg(Xl, yl, pl), iters=3)
    # K2 on the same Grams: 8,192 at once against S blocks
    A = kernels.gram_matrix(Xl, pl, cfg)
    L = k2.cholesky(A)
    Lb = torch.cat([k2.cholesky(A[a:b].contiguous()) for a, b in blocks])
    k2_bitwise = torch.equal(L.view(torch.int32), Lb.view(torch.int32))
    del A, L, Lb
    print(f"{label} config 5: float32 LML value+grad at the fit's params, "
          f"{S} shards against one batch ({n32} finite lanes): value "
          f"{dv32:.3g}, gradient {dg32:.3g} relative, bitwise share "
          f"{bits32:.6g} (reported, not gated); K2 on the "
          f"({E * R},{N},{N}) Grams in {S} blocks bitwise equal to one "
          f"batch: {k2_bitwise}; {t_sh:.3f} ms sharded, {t_one:.3f} ms one "
          f"batch ({smi})")
    check(n64 == E * R and dv64 <= MESH_LML_RTOL and dg64 <= MESH_LML_RTOL,
          f"{label} config 5: float64 LML value+grad at the float32 fit's "
          f"params over {E * R} lanes, {S} shards against one batch: "
          f"{n64} lanes finite; value {dv64:.3g}, gradient {dg64:.3g} "
          f"relative <= {MESH_LML_RTOL} (bitwise share {bits64:.6g})")
    return got


def _c3_reference(emu, dev):
    """Phase 7's float64 reference of a float32 config-3 emulator: the same
    arrays at float64 with the float32 jitter floor set (library math)."""
    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
    )
    from madaiemulator_tpu_torch.ops import kernels

    jit32 = kernels.effective_jitter_frac(emu.X.shape[0], torch.float32,
                                          emu.config)
    arrays = dict(
        mins=emu.scaling.mins, ranges=emu.scaling.ranges, X=emu.X, Z=emu.Z,
        ymean=emu.pca.ymean, ystd=emu.pca.ystd,
        eigenvalues=emu.pca.eigenvalues, U=emu.pca.U,
        log_amp=emu.params.log_amp, log_nugget=emu.params.log_nugget,
        log_ls=emu.params.log_ls)
    return emulator_from_numpy(
        {k: v.double().cpu().numpy() for k, v in arrays.items()},
        dataclasses.replace(emu.config, jitter=jit32), device=dev,
        dtype=torch.float64)


def _mesh_serve(dev, devices, label, seed, smi, work, check,
                checks) -> dict:
    """Step (b): phase 7's config-3 snapshot serving 8,192 and a ragged
    8,190 queries split over an (ensemble) mesh: at float32 (the kernels,
    counted) against phase 7's float64 reference under phase 7's serve
    gates, and at float64 against the unsharded serve."""
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models.multivariate import (
        predict_multivariate,
    )
    from madaiemulator_tpu_torch.parallel import ensemble

    S = len(devices)
    emu, _, _ = read_snapshot(str(pathlib.Path(work) / "config3"
                                  / "state.txt"),
                              device=dev, dtype=torch.float32)
    ref = _c3_reference(emu, dev)
    rng = np.random.default_rng([seed, 16])
    lo = emu.scaling.mins.cpu().numpy()
    span = emu.scaling.ranges.cpu().numpy()
    q = torch.tensor(lo + span * rng.uniform(size=(8192, lo.size)),
                     dtype=torch.float32, device=dev)
    mesh = ensemble.make_mesh(devices=devices)
    pv = _prior_var(ref)
    if checks is not None:
        with _path_operands() as seen:  # K1 on a shard's cross covariance
            ensemble.predict_queries_sharded(emu, q, mesh=mesh)
        _mesh_kernel_checks(dev, seen, smi, label, checks)
    total = None
    for m in (8192, 8190):
        _mesh_counts(reset=True)
        mt, vt = ensemble.predict_queries_sharded(emu, q[:m], mesh=mesh)
        torch.cuda.synchronize()
        got = _mesh_counts()
        total = got if total is None else {k: total[k] + got[k]
                                           for k in got}
        m0, v0 = predict_multivariate(emu, q[:m])
        r64, rv64 = predict_multivariate(ref, q[:m].double())
        s64, sv64 = ensemble.predict_queries_sharded(ref, q[:m].double(),
                                                     mesh=mesh)
        scale = max(1.0, r64.abs().max().item())
        dm = (mt.double() - r64).abs().max().item() / scale
        dvv = (vt.double() - rv64).abs().max().item() / pv
        dm0 = (mt - m0).abs().max().item() / scale
        dv0 = (vt - v0).abs().max().item() / pv
        dm64 = (s64 - r64).abs().max().item() / scale
        dv64 = (sv64 - rv64).abs().max().item() / pv
        t_sh = host_ms(lambda: ensemble.predict_queries_sharded(
            emu, q[:m], mesh=mesh), iters=5)
        t_one = host_ms(lambda: predict_multivariate(emu, q[:m]), iters=5)
        want = {"pairwise_covariance": S, "cholesky": 0, "panel_factor": 0}
        check(got == want and mt.shape == (m, emu.n_outputs)
              and dm <= C3_SERVE_MEAN_TOL and dvv <= SLICE_F32_TOL
              and dm64 <= MESH_SERVE_TOL and dv64 <= MESH_SERVE_TOL,
              f"{label} predict_queries_sharded of {m} queries (config 3, "
              f"N={emu.X.shape[0]}, {emu.n_components} components) over "
              f"{S} shards: float32 against the float64 reference mean "
              f"{dm:.3g} x scale <= {C3_SERVE_MEAN_TOL}, var {dvv:.3g} x "
              f"prior var <= {SLICE_F32_TOL} (phase 7's gates); float64 "
              f"against the unsharded float64 serve mean {dm64:.3g}, var "
              f"{dv64:.3g} <= {MESH_SERVE_TOL}; float32 against the "
              f"unsharded float32 serve (reported) mean {dm0:.3g}, var "
              f"{dv0:.3g} (bitwise: {torch.equal(mt, m0)}, "
              f"{torch.equal(vt, v0)}); launches {got} = {want} (one cross "
              f"covariance a shard); float32 {t_sh:.3f} ms sharded, "
              f"{t_one:.3f} ms unsharded ({smi})")
    return total


def _mesh_iterative(dev, devices, label, seed, smi, iter_vg, check) -> dict:
    """Step (c): the row-sharded matrix-free GP at phase 10's width: the
    matvec at N=65,536 and 65,533, and one value+grad at phase 10's gated
    settings against phase 10's own reading."""
    from madaiemulator_tpu_torch.models import iterative
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.parallel import iterative_sharded as its
    from madaiemulator_tpu_torch.utils.config import GPConfig

    S = len(devices)
    data, _ = _iter_data(seed, dev)
    cfg = GPConfig(nparams=I_D, regression_order=1)
    theta = kernels.GPParams(
        log_amp=torch.tensor(math.log(I_AMP), device=dev),
        log_nugget=torch.tensor(math.log(I_NUGGET), device=dev),
        log_ls=torch.full((I_D,), math.log(I_LS), device=dev))
    mesh = its.make_rows_mesh(devices=devices)
    V = torch.randn((I_N, MESH_MATVEC_COLS), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    for n in (I_N, I_N - 3):
        Xn, Vn = data.X[:n], V[:n]
        ref = iterative.gram_matvec(Xn, theta, cfg, Vn, row_chunk=I_ROW_CHUNK)
        _mesh_counts(reset=True)
        got = its.sharded_gram_matvec(Xn, theta, cfg, Vn, mesh,
                                      row_chunk=I_ROW_CHUNK)
        torch.cuda.synchronize()
        c = _mesh_counts()
        blocks = its.row_blocks(n, mesh)
        tiles = [-(-(r1 - r0) // I_ROW_CHUNK) for _, r0, r1 in blocks]
        want = {"pairwise_covariance": sum(tiles), "cholesky": 0,
                "panel_factor": 0}
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        t_sh = host_ms(lambda: its.sharded_gram_matvec(
            Xn, theta, cfg, Vn, mesh, row_chunk=I_ROW_CHUNK), iters=3)
        t_one = host_ms(lambda: iterative.gram_matvec(
            Xn, theta, cfg, Vn, row_chunk=I_ROW_CHUNK), iters=3)
        check(c == want and err <= MESH_MATVEC_RTOL,
              f"{label} sharded_gram_matvec N={n} d={I_D}, "
              f"{MESH_MATVEC_COLS} columns, row chunk {I_ROW_CHUNK}, {S} "
              f"shards of rows {[b[2] - b[1] for b in blocks]}: "
              f"{err:.3g} x max|CV| <= {MESH_MATVEC_RTOL} (bitwise: "
              f"{torch.equal(got, ref)}); K1 {c} = {want} ({tiles} tiles a "
              f"shard); {t_sh:.3f} ms sharded, {t_one:.3f} ms unsharded "
              f"({smi})")
        del ref, got
    del V
    kw = dict(seed=0, rank=I_RANK, probes=I_PROBES, lanczos_iters=I_LANCZOS,
              cg_tol=I_TOL, cg_max_iters=I_ITERS, logdet_method="mbcg",
              row_chunk=I_ROW_CHUNK)
    _mesh_counts(reset=True)
    t0 = time.perf_counter()
    ll, g = _vg(lambda p: iterative.lml_iterative(p, data, cfg, mesh=mesh,
                                                  **kw), theta)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _mesh_counts()
    ll0, g0, k1_0, wall0 = iter_vg
    gv = torch.cat([a.reshape(-1) for a in g])
    gv0 = torch.cat([a.reshape(-1) for a in g0])
    dll = abs(ll.item() - ll0.item()) / abs(ll0.item())
    dg = ((gv - gv0).abs().max() / gv0.abs().max()).item()
    want = {"pairwise_covariance": k1_0, "cholesky": 0, "panel_factor": 0}
    check(c == want and dll <= MESH_ITER_LL_RTOL
          and dg <= MESH_ITER_GRAD_RTOL,
          f"{label} lml_iterative(mesh=) value+grad at phase 10's check "
          f"theta and settings ({I_ITERS} PCG iterations, mBCG, "
          f"{I_PROBES} probes) against phase 10's reading: ll "
          f"{ll.item():.8g} vs {ll0.item():.8g}, {dll:.3g} <= "
          f"{MESH_ITER_LL_RTOL}; gradient {dg:.3g} x max|g| <= "
          f"{MESH_ITER_GRAD_RTOL}; K1 {c} = {want} (phase 10's count: the "
          f"row blocks are whole chunks, so a matvec's tiles are the "
          f"unsharded ones); {wall:.3f} s sharded, {wall0:.3f} s unsharded "
          f"(phase 10) ({smi})")
    return c


def _mesh_sparse(dev, devices, label, seed, smi, check) -> dict:
    """Step (d): SGPR at phase 11's width, elbo_sharded value+grad over a
    rows mesh against elbo."""
    from madaiemulator_tpu_torch.models import sparse
    from madaiemulator_tpu_torch.models.gp import GPData
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.parallel import sparse_sharded
    from madaiemulator_tpu_torch.utils.config import GPConfig

    S = len(devices)
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.rand((S_N, S_D), generator=gen, device=dev)
    y = _truth1m(X) + S_NOISE * torch.randn(S_N, generator=gen, device=dev)
    data = GPData(X=X, y=y)
    Z = sparse.select_inducing(X, S_M)
    cfg = GPConfig(nparams=S_D, regression_order=1)
    theta = kernels.GPParams(
        log_amp=torch.tensor(math.log(S_AMP), device=dev),
        log_nugget=torch.tensor(math.log(S_NUGGET), device=dev),
        log_ls=torch.full((S_D,), math.log(S_LS), device=dev))
    mesh = sparse_sharded.make_rows_mesh(devices=devices)
    one = lambda p: sparse.elbo(p, data, cfg, Z, row_chunk=S_ROW_CHUNK)
    sh = lambda p: sparse_sharded.elbo_sharded(p, data, cfg, Z, mesh,
                                               row_chunk=S_ROW_CHUNK)
    ll0, g0 = _vg(one, theta)
    _mesh_counts(reset=True)
    ll, g = _vg(sh, theta)
    torch.cuda.synchronize()
    c = _mesh_counts()
    rows = S_N // S
    chunks = S * -(-rows // S_ROW_CHUNK)
    want = {"pairwise_covariance": 1 + 2 * chunks, "cholesky": 0,
            "panel_factor": 0}
    t_sh = host_ms(lambda: _vg(sh, theta), iters=3)
    t_one = host_ms(lambda: _vg(one, theta), iters=3)
    # float64 (library math): sharded against unsharded, the same Z
    d64 = GPData(X=X.double(), y=y.double())
    th64 = kernels.GPParams(*(t.double() for t in theta))
    Z64 = Z.double()
    l64, h64 = _vg(lambda p: sparse.elbo(p, d64, cfg, Z64,
                                         row_chunk=S_ROW_CHUNK), th64)
    s64, k64 = _vg(lambda p: sparse_sharded.elbo_sharded(
        p, d64, cfg, Z64, mesh, row_chunk=S_ROW_CHUNK), th64)
    del d64

    def gap(a, b, ga, gb):
        va = torch.cat([t.double().reshape(-1) for t in ga])
        vb = torch.cat([t.double().reshape(-1) for t in gb])
        return (abs(a.item() - b.item()),
                ((va - vb).abs().max() / vb.abs().max()).item())

    d32, g32 = gap(ll, ll0, g, g0)
    dsh, gsh = gap(ll, l64, g, h64)
    d64_, g64_ = gap(s64, l64, k64, h64)
    check(c == want and dsh / S_N <= S_LL_PER_POINT and gsh <= S_GRAD_RTOL
          and d64_ / abs(l64.item()) <= MESH_ELBO_RTOL
          and g64_ <= MESH_ELBO_GRAD_RTOL,
          f"{label} elbo_sharded value+grad, N={S_N} d={S_D} m={S_M} over "
          f"{S} shards of {rows} rows (row chunks of {S_ROW_CHUNK}): "
          f"float32 against float64 {dsh / S_N:.3g} nats a point <= "
          f"{S_LL_PER_POINT}, gradient {gsh:.3g} x max|g64| <= "
          f"{S_GRAD_RTOL} (phase 11's gates); float64 against the "
          f"unsharded float64 value {d64_ / abs(l64.item()):.3g} <= "
          f"{MESH_ELBO_RTOL}, gradient {g64_:.3g} <= {MESH_ELBO_GRAD_RTOL}; "
          f"float32 against the unsharded float32 (reported) ll "
          f"{ll.item():.8g} vs {ll0.item():.8g}, {d32 / abs(ll0.item()):.3g}"
          f" relative, gradient {g32:.3g} x max|g|; K1 {c} = {want} (k(Z, "
          f"Z) once, each of the {chunks} row chunks forward and in its "
          f"checkpoint recompute); float32 {t_sh:.3f} ms sharded, "
          f"{t_one:.3f} ms unsharded ({smi})")
    return c


def _mesh_factor(dev, devices, label, seed, smi, check) -> dict:
    """Step (e): left_cholesky_sharded of phase 6's Gram (N=16,384) against
    float64, beside left_cholesky on the library and the K3 panel
    routes."""
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.parallel import iterative_sharded as its
    from madaiemulator_tpu_torch.utils.config import GPConfig

    S = len(devices)
    data, _ = _c4_data(seed, dev)
    cfg = GPConfig(nparams=C4_D, regression_order=1, cholesky_block=512)
    cfg = dataclasses.replace(cfg, jitter=kernels.effective_jitter_frac(
        C4_N, torch.float32, cfg))
    theta = kernels.GPParams(
        log_amp=torch.zeros((), device=dev),
        log_nugget=torch.log(torch.tensor(1e-2, device=dev)),
        log_ls=torch.log(torch.full((C4_D,), 0.5, device=dev)))
    C = kernels.gram_matrix(data.X, theta, cfg)
    L64 = torch.linalg.cholesky(C.double())
    mesh = its.make_rows_mesh(devices=devices)
    b = MESH_FACTOR_BLOCK
    _mesh_counts(reset=True)
    Ls = linalg.left_cholesky_sharded(C, mesh, block=b)
    torch.cuda.synchronize()
    c = _mesh_counts()
    scale = L64.abs().max().item()
    e = (Ls.double() - L64).abs().max().item() / scale
    del L64
    Lx = linalg.left_cholesky(C, block=b, diag="xla")
    dx = (Ls - Lx).abs().max().item() / scale
    same = torch.equal(Ls, Lx)
    del Ls, Lx
    t_sh = host_ms(lambda: linalg.left_cholesky_sharded(C, mesh, block=b),
                   iters=2)
    t_x = host_ms(lambda: linalg.left_cholesky(C, block=b, diag="xla"),
                  iters=2)
    t_k3 = host_ms(lambda: linalg.left_cholesky(C, block=b, diag="pallas"),
                   iters=2)
    want = {"pairwise_covariance": 0, "cholesky": 0, "panel_factor": 0}
    check(c == want and e <= C4_GRAM_FACTOR_RTOL,
          f"{label} left_cholesky_sharded N={C4_N}, block {b}, 'highest', "
          f"{S} shards of {C4_N // S} rows, on phase 6's Gram: {e:.3g} x "
          f"max|L| from float64 <= {C4_GRAM_FACTOR_RTOL}; from "
          f"left_cholesky(diag='xla') {dx:.3g} x max|L| (bitwise: {same}); "
          f"launches {c} = {want} (library panels, as in JAX); "
          f"{t_sh:.2f} ms sharded, {t_x:.2f} ms diag='xla', {t_k3:.2f} ms "
          f"the K3 route ({smi})")
    del C
    return c


def _mesh_walkers(dev, devices, label, seed, smi, work, check,
                  checks) -> dict:
    """Step (f): emcee on phase 7's snapshot (phase 14's experiment), the
    walker axis over a mesh, against the unsharded chain from the same
    generator seed: at float32 (the kernels, counted, CAL_W x
    MESH_CAL_STEPS), and at float64 (CAL_W x MESH_CAL_F64_STEPS), where the
    chains are gated equal."""
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models import calibrate as cal
    from madaiemulator_tpu_torch.parallel.mesh import Mesh

    S = len(devices)
    X, _, f = _heavy_ion_like(np.random.default_rng(seed), C3_N, C3_D, C3_T,
                              with_simulator=True)
    crng = np.random.default_rng([seed, 14])
    y_exp = f(X[7][None])[0] + CAL_NOISE * crng.standard_normal(C3_T)
    mesh = Mesh(devices, ("walkers",))
    runs = {}
    for dtype, steps in ((torch.float32, MESH_CAL_STEPS),
                         (torch.float64, MESH_CAL_F64_STEPS)):
        emu, _, _ = read_snapshot(str(pathlib.Path(work) / "config3"
                                      / "state.txt"),
                                  device=dev, dtype=dtype)
        lp = cal.make_log_posterior(emu, y_exp,
                                    np.full(C3_T, CAL_NOISE ** 2))
        x0 = cal.init_walkers(torch.Generator(device=dev).manual_seed(seed),
                              emu, lp, CAL_W)
        chain_gen = lambda: torch.Generator(device=dev).manual_seed(seed + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0, l0, a0 = cal.run_emcee(chain_gen(), lp, x0, steps)
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t0
        _mesh_counts(reset=True)
        t0 = time.perf_counter()
        c1, l1, a1 = cal.run_emcee(chain_gen(), lp, x0, steps, mesh=mesh)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        counts = _mesh_counts()
        diff = (c1 - c0).abs().amax(dim=(1, 2))
        apart = torch.nonzero(diff > 0)
        first = int(apart[0]) if len(apart) else None
        if checks is not None and dtype == torch.float32:
            # K1 on a shard's cross covariance of one half-move
            with _path_operands() as seen:
                cal._shard_walkers(lp, mesh)(c1[-1, :CAL_W // 2])
            _mesh_kernel_checks(dev, seen, smi, label, checks)
        runs[dtype] = dict(counts=counts, steps=steps, wall0=wall0,
                           wall1=wall1, a0=float(a0), a1=float(a1),
                           worst=diff.max().item(), first=first,
                           close=bool(torch.allclose(
                               c1, c0, rtol=MESH_CHAIN_RTOL,
                               atol=MESH_CHAIN_ATOL)),
                           finite=bool(torch.isfinite(l1[-1]).all()))
    r32, r64 = runs[torch.float32], runs[torch.float64]
    want = {"pairwise_covariance": S * (2 * MESH_CAL_STEPS + 1),
            "cholesky": 0, "panel_factor": 0}
    check(r32["counts"] == want and r32["finite"] and 0 < r32["a1"] < 1,
          f"{label} emcee {CAL_W} walkers x {MESH_CAL_STEPS} steps on "
          f"config 3 at float32, the walkers over {S} shards: every walker "
          f"finite, acceptance {r32['a1']:.6f}; K1 {r32['counts']} = {want} "
          f"(a shard's cross covariance each half-move, and the start); "
          f"against the unsharded chain from the same seed (reported: the "
          f"float32 log-posteriors of other batch widths round apart, and "
          f"one flipped accept moves the chain): first step apart "
          f"{r32['first']}, max |chain diff| {r32['worst']:.3g}, acceptance "
          f"{r32['a0']:.6f}; {r32['steps'] / r32['wall1']:.1f} steps/s "
          f"sharded, {r32['steps'] / r32['wall0']:.1f} unsharded ({smi})")
    check(r64["close"] and r64["a1"] == r64["a0"] and r64["finite"],
          f"{label} emcee {CAL_W} walkers x {MESH_CAL_F64_STEPS} steps on "
          f"config 3 at float64, the walkers over {S} shards, against the "
          f"unsharded chain: max |chain diff| {r64['worst']:.3g} within "
          f"rtol {MESH_CHAIN_RTOL} / atol {MESH_CHAIN_ATOL} (first step "
          f"apart {r64['first']}); acceptance {r64['a1']:.6f} = "
          f"{r64['a0']:.6f}; {r64['steps'] / r64['wall1']:.1f} steps/s "
          f"sharded, {r64['steps'] / r64['wall0']:.1f} unsharded ({smi})")
    return r32["counts"]


def phase_mesh(dev, seed: int, smi: str, work, iter_vg) -> tuple:
    """The multi-device paths (parallel/, `mesh=`): each step over a
    virtual mesh of MESH_SHARDS shards on cuda:0, then over a real mesh of
    up to MESH_SHARDS cards where two or more are visible; each against
    the unsharded call, timed beside it, its launches set to 0 just before
    the sharded path and read just after and required to equal the count
    derived from the shards. K1 and K2 are held against their plain
    versions on the operands the virtual mesh's shards hand them (config
    5's shard Grams, predict's, the serve's and a half-move's crosses; the
    matvec's tiles and SGPR's chunks are phases 10's and 11's shapes).
    Every check is made and printed; the phase fails at its end if any did
    not pass. Returns (paths, {kernel name: {label: reading}})."""
    t_phase = time.perf_counter()
    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"mesh check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    meshes = [("mesh", [dev] * MESH_SHARDS)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        real = [torch.device("cuda", i)
                for i in range(min(n_cards, MESH_SHARDS))]
        meshes.append((f"mesh{len(real)}cards", real))
    else:
        print(f"mesh: the real mesh did not run: {n_cards} CUDA device "
              f"visible (it runs over up to {MESH_SHARDS} cards where 2 or "
              f"more are)")
    paths, checks = {}, {}
    for label, devices in meshes:
        t0 = time.perf_counter()
        kc = checks if label == "mesh" else None
        paths[f"{label}_config5"] = _mesh_ensemble(dev, devices, label, seed,
                                                   smi, check, kc)
        paths[f"{label}_serve"] = _mesh_serve(dev, devices, label, seed, smi,
                                              work, check, kc)
        paths[f"{label}_iterative"] = _mesh_iterative(
            dev, devices, label, seed, smi, iter_vg, check)
        paths[f"{label}_sparse"] = _mesh_sparse(dev, devices, label, seed,
                                                smi, check)
        paths[f"{label}_factor"] = _mesh_factor(dev, devices, label, seed,
                                                smi, check)
        paths[f"{label}_calibrate"] = _mesh_walkers(dev, devices, label,
                                                    seed, smi, work, check,
                                                    kc)
        torch.cuda.empty_cache()
        print(f"{label}: {len(devices)} shards on "
              f"{sorted({str(d) for d in devices})} in "
              f"{time.perf_counter() - t0:.1f} s")
    print(f"mesh phase wall {time.perf_counter() - t_phase:.1f} s")
    require(not failed, f"mesh: {len(failed)} checks failed: {failed}")
    return paths, checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: CUDA device not available", file=sys.stderr)
        return 1
    import madaiemulator_tpu_torch  # noqa: F401  (sets the FP32 flags)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    # phases 7, 10 and 11 leave their files here for phases 12-14
    work_dir = tempfile.TemporaryDirectory()
    work = pathlib.Path(work_dir.name)
    smi = phase_device()
    # phase 13 serves a snapshot by native/'s madai_query: built meanwhile
    native = _NativeBuild(work / "native")
    try:
        return _run_phases(args, dev, rng, work, smi, native, t_start)
    finally:
        native.stop()
        work_dir.cleanup()


def _run_phases(args, dev, rng, work, smi, native, t_start) -> int:
    skew_build = _SkewBuild()
    try:
        phase_build()
        kernels = phase_kernels(dev, rng,
                                np.random.default_rng([args.seed, 1]),
                                skew_build)
    finally:
        skew_build.result(raise_error=False)
    phase_goldens(dev)
    paths = {}
    paths["serve_multivariate"], paths["serve_fast"] = phase_slice(dev, rng,
                                                                   smi)
    (paths["config4"], paths["config4_fast"], paths["config4_tiers"],
     paths["config4_blocked"]) = phase_config4(dev, args.seed, smi)
    paths["config3_fit"], k2_fit = phase_config3(dev, args.seed, smi,
                                                 work / "config3")
    paths["config5"], c5 = phase_config5(dev, args.seed, smi)
    paths["gradient"], k3_grad = phase_gradient(dev, args.seed, smi)
    paths["iterative"], k1_iter, iter_params, iter_vg = phase_iterative(
        dev, args.seed, smi, work / "iterative")
    paths["sparse"], k1_sparse = phase_sparse(dev, args.seed, smi, work)
    diag_paths, k23_diag = phase_diagnostics(dev, args.seed, smi, work,
                                             iter_params)
    paths.update(diag_paths)
    paths["multifidelity"], mf_emu, mf_checks = phase_multifidelity(
        dev, args.seed, smi, work, native)
    paths["calibrate"], cal_checks = phase_calibrate(
        dev, args.seed, smi, work, iter_params, mf_emu)
    des_paths, des_checks = phase_design(dev, args.seed, smi, work,
                                         iter_params, mf_emu)
    paths.update(des_paths)
    del mf_emu
    mesh_paths, mesh_checks = phase_mesh(dev, args.seed, smi, work, iter_vg)
    paths.update(mesh_paths)
    del iter_vg
    for k in kernels:
        by_path = {p: c.get(k["name"], 0) for p, c in paths.items()}
        k["launches_by_path"] = by_path
        k["launches"] = (by_path["config5"] or by_path["config3_fit"]
                         or by_path["config4"]
                         or by_path["serve_multivariate"])
        if k["name"] == "cholesky":
            # the error over every checked shape, the fit's lane batch too
            k["max_abs_err"] = max(k["max_abs_err"], k2_fit["max_abs_err"])
            k["fit_batch"] = k2_fit
        if k["name"] in c5:
            err, by_shape = c5[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k["config5"] = by_shape
        if k["name"] == "pairwise_covariance":
            # the matrix-free path's tiles, pivot columns and serve chunks;
            # the sparse path's row chunks, k(Z, Z) and serve block
            k["max_abs_err"] = max(k["max_abs_err"], k1_iter[0],
                                   k1_sparse[0])
            k["iterative"] = k1_iter[1]
            k["sparse"] = k1_sparse[1]
        for label, reading in k23_diag.items():
            # K2 on config 3's state Grams (gated by its backward error:
            # the forward distance there measures the fitted nuggets, not
            # the kernel), K3 on config 4's first panel
            if label.startswith(k["name"] + "("):
                if "backward_err" not in reading:
                    k["max_abs_err"] = max(k["max_abs_err"],
                                           reading["max_abs_err"])
                k["diagnostics"] = {label: reading}
        for cell, checks in (("multifidelity", mf_checks),
                             ("calibrate", cal_checks),
                             ("design", des_checks),
                             ("mesh", mesh_checks)):
            # every shape each new path handed the kernel; K2 and K3 at
            # fitted thetas are gated by their backward errors, as above
            readings = checks.get(k["name"], {})
            if readings:
                k[cell] = readings
                k["max_abs_err"] = max(
                    [k["max_abs_err"]] + [r["max_abs_err"] for r in
                                          readings.values()
                                          if "backward_err" not in r])
        if k["name"] == "panel_factor":
            # the gradient path's lane batch (16, 512, 512)
            k["max_abs_err"] = max(k["max_abs_err"], k3_grad["max_abs_err"])
            k["gradient_batch"] = k3_grad
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s, every "
          f"phase ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
