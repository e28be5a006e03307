#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mpisppy_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  1. env      torch/CUDA versions, the card, nvidia-smi name + power limit
  2. build    nvcc build (or load) of csrc/pdhg_chunk.cu, and what ptxas
              reports for each of its 27 instantiated kernels (9 of the
              tiled kernel, A in registers; 18 of the cluster kernel, A
              resident or streamed): registers, spills, stack; no
              kernel may spill
  3. kernel   each form of the PDHG chunk kernel (dense (S, M, N),
              shared (1, M, N), split SplitA) against its plain torch
              version at the main paths' shapes (farmer S=1000,
              crops_multiplier=10: M=61, N=120; n_steps=40; inputs from
              the dense and the split prep; and the shared form at UC's
              fallback shape (1, 174, 114), S=250, on the cluster
              kernel with A resident in shared memory) with A stored in
              f32, f64 and bf16 (f32 vectors);
              the shared and split forms must equal the dense kernel on
              the assembled matrices exactly; timings, the bound, the
              variant, its cluster size, blocks per SM, the clusters
              the card holds at once and the waves.  The bound counts A
              once, plus n_steps x what of a wave's A (the scenarios the
              card holds at once) exceeds the card's shared memory and
              L2, for each wave (chunk_bytes).  Then the dense and split
              forms (f32) on a compacted slab: the prep gathered to
              COMPACT_S=256 of the 1000 rows with
              ops.pdhg._gather_prep; and `cluster_forms`: the shared and
              split forms on the cluster kernel at UC's fallback shape,
              resident and streamed, at three cluster sizes, each
              bit-equal to the dense kernel on the assembled matrices
  4. slice    PH on farmer at full width (S=1000, crops_multiplier=10,
              f32, the bench's options with its dense prep,
              no_split_prep=True): Iter0, a few PH iterations, one xhat
              inner bound and one Lagrangian outer bound, the bench's
              gap loop and a profiled window; every solve must go
              through the kernel, and the (form, S, M, N, dtype) shapes
              it launched with are listed
  5. bf16x    the same farmer batch with pdhg_hot_dtype="bf16x": Iter0
              (promoted to full precision at pdhg_eps=1e-5), 2 PH
              iterations on the eps ladder in bf16 storage, one xhat and
              one Lagrangian bound
  6. split    farmer S=1000, cm=10, f32 with the bench's options and
              no_split_prep left out: the split prep, the gap loop to a
              verified 1% gap, launches by form and dtype (the split and
              shared forms must both launch), a profiled window
  7. true_size the true-size instance, crops_multiplier=1000 (M=6001,
              N=12000), f32, split-native, S cut from 1000 to TRUE_S:
              Iter0, TRUE_PH_ITERS PH iterations, one xhat and one
              Lagrangian bound
              on the matmul route, Iter0's certified-feasible mass; peak
              device memory under 20 GB, the per-step time of the
              matmul route against its bound, a profiled PH iteration,
              and the gap loop's projected wall
  8. uc       bench.py's uc1000 row at full width (21 units, 24 h:
              M=2502, N=1536, shared A, f32; depth cut as its `cuts` says):
              Iter0, PH iterations with a Lagrangian bound every 5, the
              threshold commitments screened in one stacked solve,
              screened 1-opt sweeps, the consensus-EF dual bound (no
              kernel launch); walls per step, chunk counts, peak
              memory, inner, outer and gap, and one consensus-route
              chunk timed alone against its bound.  Then the fallback size
              (6 units, 6 h, S=250): Iter0 and 2 PH iterations must
              launch the kernel's shared form at (1, 174, 114)
  9. sslp     bench.py's sslp50 row: SIPLIB sslp_5_25 at S=50, f32, one
              consensus EF solve and its f64 certify to a gap under 1%,
              the objective within 1e-4 of HiGHS on the same EF LP;
              one consensus-route chunk timed alone against its bound
 10. golden   farmer-3 in f64 through ph_main: E[obj] = -108390 +- 20,
              xbar ~ (170, 80, 250)
 11. wheel    the hub-and-spoke wheel (PH hub, Lagrangian and
              XhatShuffle spokes).  `wheel_row`: bench.py's wheel_mpmd
              row on one device (farmer S=100, f32, threads mode over
              the host seqlock, rel_gap 1e-4, 40 PH iterations); its
              bounds must bracket the farmer-100 optimum (the port's
              ExtensiveForm in f64 on the card).  `wheel_split`: farmer
              S=1000, cm=10, f32 built through the port's config and
              vanilla (examples/farmer_cylinders.py's command line),
              interleaved, the split phase's options with 20 PH
              iterations; the kernel's split and shared forms must both
              launch.  Supersteps, steps per spoke, bounds, gap, launches
              by form and dtype, f64 certifies, bound rejects, memory.
The slice, split, true_size and uc lines end with bench.py's telemetry
extras: after the phase's measured window, PHASE_TIMING_ITERS more PH
iterations under telemetry phase timing give `phase_seconds` (the mean
seconds of the solve / psum / w_update / conv cuts) and
`window_traffic`.  After true_size, the `compact` phase:
pdhg_compact_threshold=0.5 on farmer S=1000, cm=10 (Iter0, one xhat,
one Lagrangian bound, each beside the same step without compaction on
the same batch and prep: segments, FLOPs not spent, launches by
(form, S'); widths never grow, a launch below S=1000, bounds within
10x their solve's eps), then Iter0 of the true-size instance at TRUE_S
with compaction beside the true_size phase's.  In the wheel phase,
`wheel_row_telemetry` spins wheel_row again with its own telemetry
option into WHEEL_TELEMETRY_DIR: trace.json with one row each for the
hub and the two spokes, metrics.jsonl, its wheel and traffic counters.

 12. driver   the driver layer (`utils/amalgamator`, `extensions/`,
              `convergers/`).  `driver_cylinders`:
              examples/farmer_cylinders.py's command line with its
              extension flags (--fixer --farmer-with-integers
              --use-norm-rho-updater --wtracker --primal-dual-converger,
              Lagrangian and XhatShuffle spokes) through
              amalgamator.from_module at the split cell's size, f32,
              PHIterLimit cut to DRIVER_PH_ITERS: bounds, hook counts,
              pinned slots held at their values, rho changed where
              NormRhoUpdater's rule says, launches by form, seconds per
              superstep beside wheel_split's and each extension's hook
              seconds per iteration.  `driver_hub`: PH alone on the same
              batch with the in-hub XhatClosest, the Gapper and
              MultRhoUpdater (the Gapper's eps schedule, the in-hub
              xhat's shared-form launches).  `driver_ef`: --EF through
              the amalgamator on the wheel_row batch, f64, within 1e-6 of
              HiGHS.
 13. corpus   the model corpus through `amalgamator.from_module`, as
              examples/run_all.py runs it (interleaved wheels): hydro
              (3,3) f64 (20 of run_all.py's 40 iterations), its bounds
              bracketing the f64 EF optimum, which
              agrees with HiGHS on the multistage EF (`ef_lp_oracle`:
              one column per tree node and slot), and the JAX package's
              golden PH run (180, 190); aircond (10,10,10), S=1000, 111
              nodes, f32, 4 PH iterations, bracketing HiGHS, x̄ one
              value per node; acopf3 on the IEEE 14-bus case (3,2,2)
              f32 (a nonzero qdiag; 5 of run_all.py's 10 iterations)
              bracketing the port's f64 EF (a QP), then the
              5-bus (2,2) row; the two-stage rows (sizes, apl1p,
              battery, netdes, gbd, usar) f32 with finite bounds and
              each f64 --EF within 1e-6 of HiGHS; SPBase's
              scenario_creator path equal to build_batch for hydro and
              farmer (S=100, cm=10).  The kernel phase holds the dense
              form at the corpus's shapes against its plain version:
              the cluster kernel with A resident (sizes, usar, acopf3
              ieee14 with a nonzero qs in f32 and f64, and its f64
              certify at S'=4) and the register tile (acopf3 (2,2)).
              acopf3's sub-run must launch the cluster kernel.
 14. algorithms the remaining algorithms, each through its users' entry
              point on farmer S=1000, cm=10 unless said (ALG_CUTS lists
              the cuts): `alg_farmer_ef`, the f64 EF optimum by HiGHS;
              `alg_lshaped`, examples/farmer_lshapedhub.py's command
              line through config and vanilla at S=100, one iteration
              (f64, the example's dtype: the subproblems on the kernel,
              the root on the matmul route, re-solved from the primal
              weight's floor when it stalls), its bounds bracketing the
              EF optimum of its batch, no root left unconverged;
              `alg_aph`, vanilla.aph_hub with dispatch_frac 0.5 and a
              Lagrangian and an xhat-shuffle spoke (f32), conv falling,
              bounds finite and ordered; `alg_fwph`, a PH hub with the
              --fwph spoke (f32), whose hull QP launches the dense form
              at (1000, 121, 136), its best dual bound under the EF
              optimum; `alg_sc`, the Schur-complement IPM within 1e-6
              of the EF optimum at S=100, and at S=1000 within
              ALG_SC_FULL_TOL_REL of where the JAX package's IPM ends
              (tests/sc_witness.py); `alg_mip`, the MIP dive on integer
              farmer-6 against HiGHS's MILP optimum (sizes-3's golden
              row takes 751.2 s on the card: tests/algorithms_witness.py);
              `alg_bundles`, aircondB (aircond (10,10,10) in ten proper
              bundles of 100, (10, 1552, 1600), f32) through the
              amalgamator with a Lagrangian spoke, its outer bound
              under aircond's HiGHS EF optimum and within
              ALG_BUNDLE_OUTER_FACTOR x |optimum| of it; `alg_varprob`,
              PH with a non-uniform variable_probability, x̄ against a
              numpy weighting.  The kernel phase holds the dense form at
              the two new shapes against its plain version: the hull QP
              (f32, f64, A resident) and the bundles (f32, A streamed);
              alg_fwph and alg_bundles must launch the cluster kernel.
 15. soc      acopf3's Jabr SOC relaxation on IEEE 14-bus (2,2), f64:
              soc_refine's rounds (walls, iterations, cuts, objective
              rising, the last violation below a tenth of the first),
              the refined EF by the port's f64 EF (dead lines carry no
              flow and no lifted product), PH (rho 50, SOC_PH_OPTS) on
              the refined batch: Iter0 feasible, E[obj] after each
              iteration and against the EF's objective, its bounds
              around it where they certify, else the bracket reported
              vacuous (SOC_CUTS lists the rounds, iterations and solver
              caps cut and why).  The kernel
              phase holds the dense form at the SOC shape (4, 814, 600)
              against its plain version (the cluster kernel, streamed)
 16. cross_scen wheel_row's batch with cross-scenario cut capacity, a PH
              hub with CrossScenarioExtension, the cut spoke and an
              xhat-shuffle spoke, interleaved: cuts installed, the
              seeded cut's trivial bound at the wait-and-see value
              (HiGHS, scenario by scenario), the bounds around the
              HiGHS EF optimum
 17. wheel_multiproc wheel_row's dicts in multiproc mode: its spokes as
              child processes on the card over the native seqlock's
              window files (telemetry on: each child's trace row merged
              into trace.json), children on cuda, bounds around the
              farmer-100 optimum, seconds per superstep over the whole
              spin beside wheel_row's threads mode (the same span) and
              over the hub's loop alone, the children's kernel launches;
              then a supervised run whose Lagrangian child chaos kills
              (os._exit) at its third step: restarted once, pruned, the
              hub's outer bound still valid
 18. checkpoint farmer PH in f64 at wheel_row's size: two uninterrupted
              runs (they must agree to 1e-9), one crashed by chaos after
              iteration 4's checkpoint, its resume (W, x̄ and conv equal
              the uninterrupted run's to 1e-9)
The kernel phase also holds the kernel at the new paths' shapes
against its plain version (NEW_PATH_KERNEL_CASES): wheel_row's split
prep (100, 7, 12), the cross-scenario hub's augmented batch (100, 47,
13), the SOC batch.
The corpus phase, the algorithms sub-runs of ALG_CHILD (line
`algorithms`), soc and cross_scen run in a second process on the same
card (this script with SECOND_PROCESS_FLAG), started when true_size
ends, beside the uc, wheel and driver phases, the algorithms sub-runs
of ALG_MAIN (line `algorithms_main`), wheel_multiproc, checkpoint,
compact, the uc fallback pass, sslp and the golden of the main process
(the last four ran in the second process until soc and
cross_scen joined it); its lines are copied into this output when it ends, the
last one `child` with its wall.
Then the kernels line (each entry with its launches in `wheel_split`,
in the driver phase's cylinders run and in the compact phase, and the
dense and split forms with their compacted-slab run; the corpus rows
with their launches on the corpus path; the algorithms' rows with
their launches on the algorithms path), the nvidia-smi line, and the
result line.

Imports nothing of jax and nothing of the JAX package (scipy only for
the HiGHS reference of the sslp phase).  Exits non-zero,
printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

S, CM, N_STEPS = 1000, 10, 40
PH_ITERS = 4
BF16X_PH_ITERS = 2
# the true-size instance (bench.py:1229-1243): S=1000 scenarios at
# crops_multiplier=1000, split-native.  S is cut to 32 so that the
# script stays well inside its time limit: on an NVIDIA H100 80GB HBM3
# at 700 W, Iter0 alone took 719 s at S=1000 (f32 to its 30,000-iteration
# cap, then the f64 certify of its stragglers), the phase 469 s at S=250,
# 234-273 s at S=125 (the cut until the driver phase needed the time)
# and 168.8 s at S=64 (the cut until the corpus phase needed the time;
# the phase's time is the card's, so it does not shrink on a faster
# host as the host-bound phases do).  At S=16 Iter0 took as long as at
# S=32 (80.0 s, its f64 certify 63.5 s), so S stays 32.
# crops_multiplier, pdhg_eps and pdhg_max_iters stay the bench's.  One
# PH iteration (2 until the soc, cross_scen, wheel_multiproc and
# checkpoint phases needed the time: each took ~18 s)
TRUE_S, TRUE_CM, TRUE_PH_ITERS = 32, 1000, 1
# the bench's options (bench.py:1252-1294) for farmer, with the dense
# per-scenario prep of its accelerator row at the CPU-fallback size
# (cm=10); SPLIT_OPTS leave out no_split_prep, so farmer's declared
# A_delta_idx selects the split prep (the bench's BENCH_SPLIT=1 row)
SLICE_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": PH_ITERS,
              "convthresh": 0.0, "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
              "lagrangian_eps": 1e-4, "pdhg_max_iters": 30000,
              "no_split_prep": True,
              "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
              "pdhg_hot_dtype": "f32"}
SPLIT_OPTS = {k: v for k, v in SLICE_OPTS.items() if k != "no_split_prep"}

# bench.py's uc1000 row (bench.py:309-474): stochastic unit commitment
# at full width, 21 units (fleet_multiplier=7) over 24 h: M=2502,
# N=1536, one shared (1, M, N) matrix, f32, with its accelerator
# options.  Its depth is cut so that the whole script stays well inside
# its time limit (its `cuts` field lists each cut): at S=1000
# (tests/uc_steps_witness.py, an NVIDIA H100 80GB HBM3 at 700 W) every
# PH solve runs to its 20,000-iteration cap in ~13 s, one 64-flip
# screening launch of a 1-opt sweep (64,000 stacked scenarios, 2,000
# iterations) takes ~64 s and a full sweep is 8 of them, and the EF
# bound ~140 s.  S=64 keeps a sweep's launches at 4,096 scenarios; 2 PH
# iterations keep one Lagrangian bound (after the last iteration; 5
# until the script ran over its limit on a slower host, 6 until the
# corpus phase needed the time, with a second after iteration 6); one
# sweep is one full (terminating) sweep.  S was 64 until the algorithms
# phase needed the time (the phase took 220 s there, its EF bound 95 s
# and its sweep 57 s).  S was 250 and the iterations
# 10 until the driver phase needed the time: at S=250 the phase took
# 359-428 s on that card; S was 125 (264.3 s) until the corpus phase
# needed the time.
UC_FULL = {"H": 24, "fleet_multiplier": 7}
UC_FULL_SHAPE = (1, 2502, 1536)
UC_S, UC_PH_ITERS, UC_SWEEPS = 32, 2, 1
# the consensus-EF dual bound's iteration cap (ef_dual_bound's default
# and the bench's 100,000) for its f32 solve: at S=64 that solve runs to
# the cap; the f64 certify after it runs to its own 100,000-iteration
# floor whatever this cap (3,500 consensus chunks, 71.6 s in all at
# 40,000 and 72.4 s at 20,000 on an NVIDIA H100 80GB HBM3 at 700 W, so
# a lower cap gives no time back); the bound is valid at any iterate,
# only looser at a lower cap.  The certify is left out (uc_ef_bound)
# since the soc, cross_scen, wheel_multiproc and checkpoint phases needed the time
UC_EF_ITERS = 40000
UC_OPTS = {"defaultPHrho": 50.0, "convthresh": 0.0, "pdhg_eps": 1e-4,
           "superstep_eps": 1e-4, "lagrangian_eps": 1e-4,
           "pdhg_max_iters": 20000, "iter0_infeasibility_ok": True,
           "iter0_certify": False, "certify_max_iters": 30000}
# the bench's CPU fallback size of the same row (3 * 2 units, 6 h):
# one shared (1, 174, 114) matrix, which the chunk kernel stages in
# shared memory
UC_FALLBACK = {"H": 6, "fleet_multiplier": 2}
UC_FALLBACK_S = 250
# bench.py's sslp50 row (bench.py:253-306): the SIPLIB sslp_5_25_50
# instance's LP relaxation as one consensus EF solve, f32
SSLP_S = 50
SSLP_OPTS = {"pdhg_eps": 1e-5, "pdhg_max_iters": 200000}
# bench.py's wheel_mpmd row on one device (bench.py:1083-1124): farmer
# S=100 at crops_multiplier=1, a PH hub, a Lagrangian and an
# XhatShuffle spoke, threads mode over the host seqlock, to a certified
# rel_gap of 1e-4 within 40 PH iterations.  The row's options without
# its "telemetry": True for `wheel_row`, with it for
# `wheel_row_telemetry`.
WHEEL_S = 100
WHEEL_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 0.0,
              "pdhg_eps": 1e-7, "pdhg_max_iters": 30000}
WHEEL_HUB_OPTS = {"rel_gap": 1e-4, "abs_gap": 1.0}
# the heavier wheel through config + vanilla, as
# examples/farmer_cylinders.py builds it, with the split phase's solver
# options and PHIterLimit cut to 2 (20 until the driver phase, 8 until
# the corpus phase needed the time, 5 until the script ran over its
# limit on a slower host, 3 until the soc, cross_scen, wheel_multiproc
# and checkpoint phases needed the time)
WHEEL_SPLIT_ARGV = ["--num-scens", str(S), "--crops-multiplier", str(CM),
                    "--lagrangian", "--xhatshuffle", "--rel-gap", "0.01"]
WHEEL_SPLIT_PH_ITERS = 2
# the driver phase: examples/farmer_cylinders.py's command line with its
# extension flags, through the port's amalgamator at the split cell's
# size (S=1000, cm=10, f32, the split phase's solver options, which no
# flag carries) with PHIterLimit cut to DRIVER_PH_ITERS; then PH alone
# on the same batch for DRIVER_HUB_ITERS iterations with the in-hub
# XhatClosest, the Gapper (schedule DRIVER_GAPPER) and MultRhoUpdater;
# then --EF through the amalgamator on the wheel_row batch (f64), held
# to the HiGHS optimum as wheel_row holds its own EF
DRIVER_ARGV = ["--num-scens", str(S), "--crops-multiplier", str(CM),
               "--lagrangian", "--xhatshuffle", "--fixer",
               "--farmer-with-integers", "--use-norm-rho-updater",
               "--wtracker", "--primal-dual-converger", "--rel-gap", "0.01"]
# 6 until the soc, cross_scen, wheel_multiproc and checkpoint phases
# needed the time
DRIVER_PH_ITERS = 4
DRIVER_HUB_ITERS = 3
DRIVER_GAPPER = {0: 1e-4, 2: 1e-5}
DRIVER_EF_ARGV = ["--num-scens", str(WHEEL_S), "--EF", "--EF-solver-eps",
                  "1e-7", "--solver-max-iters", "400000"]
# examples/_driver.py's standard_cfg: the flag groups every cylinders
# driver declares
DRIVER_CFG_GROUPS = (
    "popular_args", "ph_args", "two_sided_args", "fwph_args",
    "lagrangian_args", "lagranger_args", "xhatlooper_args",
    "xhatshuffle_args", "xhatspecific_args", "xhatxbar_args",
    "xhatlshaped_args", "slammax_args", "slammin_args", "fixer_args",
    "gapper_args", "converger_args", "norm_rho_args", "mult_rho_args",
    "wtracker_args", "ef_args")

# the corpus phase: examples/run_all.py's rows through the port's
# amalgamator (interleaved wheels), each with the counts zeroed just
# before it; iteration cuts against run_all.py in CORPUS_CUTS
# hydro's row runs 40 iterations in run_all.py; cut to 20 for time (the
# 40-iteration wheel took 96-146 s on an NVIDIA H100 80GB HBM3 at 700 W,
# host-bound, its bounds [183.1717, 187.6257] around the optimum 186.17)
CORPUS_HYDRO_ITERS = 20
CORPUS_HYDRO_ARGV = ["--branching-factors", "3,3", "--max-iterations",
                     str(CORPUS_HYDRO_ITERS), "--default-rho", "1",
                     "--lagrangian", "--xhatshuffle"]
# the full published aircond parameter table at a tree of 1000 leaves
# (S=1000, 4 stages, 111 non-leaf nodes): a full batch for the kernel;
# 2 PH iterations (4 until the algorithms phase needed the time, 33.3 s
# on an NVIDIA H100 80GB HBM3 at 700 W; 10 until the script ran over
# its limit on a slower host: 64-76 s, its inner bound +inf all the
# same)
CORPUS_AIRCOND_ITERS = 2
CORPUS_AIRCOND_ARGV = ["--branching-factors", "10,10,10",
                       "--max-iterations", str(CORPUS_AIRCOND_ITERS),
                       "--default-rho", "1", "--lagrangian",
                       "--xhatshuffle"]
# the multistage wheels' xhat candidates are infeasible until PH
# converges (their sources break the balance rows), and each such
# evaluation runs its f64 certify to the 100,000-iteration cap: in
# aircond 25,000 of the run's 35,658 chunks, ~90 of its 128 s on an
# NVIDIA H100 80GB HBM3 at 700 W.  The cap is cut to the fast solve's
# 20,000 for hydro and aircond: hydro's bounds are then the same to the
# last digit on the CPU (183.17174991757466, 187.62566102204437), its
# wall 152 s there against 226 s
CORPUS_CERTIFY_OPTIONS = {"certify_max_iters": 20000}
# run_all.py's ieee14 row at 5 of its 10 iterations (10 until the
# script ran over its limit on a slower host)
CORPUS_ACOPF3_ITERS = 5
CORPUS_ACOPF3_ARGV = ["--branching-factors", "3,2,2", "--max-iterations",
                      str(CORPUS_ACOPF3_ITERS), "--default-rho", "5",
                      "--case", "ieee14", "--lagrangian", "--xhatshuffle"]
# run_all.py's default acopf3 row (the synthetic 5-bus grid, (2,2)),
# whose (4, 39, 72) system takes the register tile with a nonzero qs
CORPUS_ACOPF3_22_ARGV = ["--branching-factors", "2,2", "--max-iterations",
                         "5", "--default-rho", "5", "--lagrangian",
                         "--xhatshuffle"]
# run_all.py's two-stage rows: (module, --num-scens, run_all.py's
# --max-iterations); run here at CORPUS_2STAGE_ITERS
CORPUS_2STAGE = (("sizes", 3, 5), ("apl1p", 4, 30), ("battery", 8, 30),
                 ("netdes", 5, 30), ("gbd", 10, 30), ("usar", 3, 25))
CORPUS_2STAGE_ITERS = 5
# bound tolerances of the corpus wheels, relative: an f32 wheel's bounds
# carry the f32 eps floor (1.19e-5) of its solves; the wheel_row bracket
# (f64 EF against an f32 wheel) uses 1e-5 too.  Outer may exceed inner
# by CORPUS_CROSS_TOL_REL: both come from solves at solver_eps 1e-6 with
# a 10 x eps residual test (acopf3's QP bounds cross by ~1.6e-5 on the
# CPU in f64)
CORPUS_BRACKET_TOL_REL = 1e-5
CORPUS_CROSS_TOL_REL = 1e-4
# the algorithms phase: L-shaped, APH, FWPH, the
# Schur-complement IPM, the MIP dive, bundles and variable_probability,
# each through its users' entry point, farmer at S=1000, cm=10 (the
# slice's batch) unless said.  Iteration caps cut for time (ALG_CUTS)
# L-shaped at S=100 (cm=10), one iteration: its first root LP at
# S=1000, (1, 1 + 2000, 1030), ends unconverged at 50,000 PDHG
# iterations in both packages, the port's also after its re-solve from
# the primal weight's floor (tests/lshaped_root_witness.py --scens 1000
# on the CPU: duality gap 1.0e-2 in the JAX package, 6.3e-3 in the
# port), and an unconverged root's objective is no bound.  At S=100 the
# first root converges (the port's after its re-solve); a later one
# runs far longer, so the iterations are cut to 1
ALG_LSHAPED_S = 100
ALG_LSHAPED_ITERS = 1
ALG_LSHAPED_ARGV = ["--num-scens", str(ALG_LSHAPED_S), "--crops-multiplier",
                    str(CM), "--max-iterations", str(ALG_LSHAPED_ITERS),
                    "--xhatlshaped"]
ALG_APH_ITERS = 3
ALG_APH_ARGV = ["--num-scens", str(S), "--crops-multiplier", str(CM),
                "--max-iterations", str(ALG_APH_ITERS), "--dispatch-frac",
                "0.5", "--default-rho", "1", "--lagrangian",
                "--xhatshuffle"]
ALG_FWPH_ITERS = 1
ALG_FWPH_ARGV = ["--num-scens", str(S), "--crops-multiplier", str(CM),
                 "--max-iterations", str(ALG_FWPH_ITERS), "--default-rho",
                 "1", "--fwph"]
# the MIP extensive form in the script: integer farmer-6 (the JAX
# package's tests/test_integer_goldens.py case); examples/sizes_ef_mip.py's
# run_all.py row takes 751.2 s on the card, host-bound on the consensus
# route, and runs in tests/algorithms_witness.py with its golden
ALG_MIP_S = 6
ALG_MIP_OPTIONS = {"pdhg_eps": 1e-7, "pdhg_max_iters": 200000}
ALG_BUNDLE_ITERS = 1
# aircondB's outer bound after ALG_BUNDLE_ITERS PH iteration(s) must lie
# within this many |EF optimum| below aircond's EF optimum (HiGHS): a
# finite bound that the cut iteration count can still fail (-38,268.9
# against 732.1976, 53 of them, on an NVIDIA H100 80GB HBM3 at 700 W)
ALG_BUNDLE_OUTER_FACTOR = 100
# --solver-eps 1e-5: at the default 1e-6, below the f32 floor (1.19e-5),
# two of the ten bundles' Iter0 solves end with a primal residual above
# the 1e-5 feasibility test, and their f64 certify (20,000 iterations)
# does not finish them; the JAX package's Iter0 fails there too
# (tests/aircondb_iter0_witness.py on the CPU)
ALG_BUNDLE_ARGV = ["--branching-factors", "10,10,10",
                   "--scenarios-per-bundle", "100", "--max-iterations",
                   str(ALG_BUNDLE_ITERS), "--default-rho", "1",
                   "--solver-eps", "1e-5", "--lagrangian"]
ALG_VARPROB_ITERS = 2
# the Schur-complement IPM: its default 100 iterations leave farmer at
# S=100, cm=10 far from the optimum in both packages; the run held to
# 1e-6 of the EF optimum is S=100 at ALG_SC_ITERS.  At S=1000 and
# ALG_SC_FULL_ITERS iterations both packages' IPMs stop ~0.1945 short of
# the EF optimum (its feasibility test is absolute, so mu falls at the
# slow rate to its floor): tests/sc_witness.py on the CPU, the JAX
# package at ALG_SC_FULL_JAX, the port 3.0e-4 from it; where a stalled
# IPM stops depends on its rounding (the port's CPU and card ends differ
# by 2.7e-4), so the card's end must lie within ALG_SC_FULL_TOL_REL of
# the JAX package's
ALG_SC_S = 100
ALG_SC_ITERS = 3000
ALG_SC_FULL_ITERS = 1000
ALG_SC_FULL_JAX = -1074660.2125392444
ALG_SC_FULL_TOL_REL = 1e-3
ALG_CUTS = {
    "alg_lshaped": {"--max-iterations": {"run_all.py": 50,
                                         "here": ALG_LSHAPED_ITERS},
                    "--num-scens": {"full width": S, "here": ALG_LSHAPED_S}},
    "alg_aph": {"PHIterLimit": {"vanilla default": 100,
                                "here": ALG_APH_ITERS}},
    "alg_fwph": {"PHIterLimit": {"vanilla default": 100,
                                 "here": ALG_FWPH_ITERS}},
    "alg_bundles": {"PHIterLimit": {"vanilla default": 100,
                                    "here": ALG_BUNDLE_ITERS},
                    "--solver-eps": {"default": 1e-6, "here": 1e-5}},
    "alg_varprob": {"PHIterLimit": {"vanilla default": 100,
                                    "here": ALG_VARPROB_ITERS}},
    "alg_sc": {"sc_max_iter": {"default": 100, "here": ALG_SC_ITERS},
               "S (to 1e-6 of the EF)": {"full width": S,
                                         "here": ALG_SC_S}},
    "alg_mip": {"instance": {"run_all.py": "sizes-3 (examples/"
                                           "sizes_ef_mip.py, 751.2 s on "
                                           "the card)",
                             "here": f"integer farmer-{ALG_MIP_S}"}}}
# the dense kernel at the algorithms' new shapes: FWPH's hull QP at
# (S, N+1, N+T) = (1000, 121, 136), A resident (f32 and f64), and
# aircondB's ten bundles of 100 scenarios, (10, 1552, 1600), A streamed
# (f32)
ALG_KERNEL_CASES = (("hull_qp_fwph", (S, 121, 136),
                     ("resident", "resident")),
                    ("bundles_aircondB", (10, 1552, 1600),
                     ("streamed", None)))
# acopf3's Jabr SOC relaxation: refine the IEEE 14-bus case
# on the (2,2) outage tree (the full width the JAX package supports)
# with 8 cut slots a (stage, line), each round one consensus EF solve
# warm-started from the last (certify=False); the refined EF by the
# port's own f64 EF, warm-started from the last round; then PH as
# tests/test_acopf3_soc.py runs it (rho 50) on the refined batch, f64.
# SOC_CUTS lists what is cut and why (NVIDIA H100 80GB HBM3, 700 W):
# the refine's rounds run at 8,000 iterations (~4 s a round), and round
# 6 is the first whose violation (0.0061) is below a tenth of round 0's
# (0.307), so 7 rounds are run; PH's E[obj] is within 6.0e-4 of the EF's
# objective after Iter0 and 2.6e-4 after 2 iterations (line `soc`,
# `ph_eobj_by_iteration`; 10 iterations took 35 s), so 2 are run.  PH's
# Iter0 at the JAX test's eps 1e-6 (100,000 iterations) fails, and at
# 1e-4 no bound certifies, in both packages on this batch
# (tests/soc_ph_witness.py): the phase runs PH at 1e-4 and says that its
# bracket is vacuous
SOC_BF, SOC_CASE, SOC_SLOTS = (2, 2), "ieee14", 8
SOC_ROUNDS = 7
SOC_REFINE_OPTS = {"pdhg_eps": 1e-5, "pdhg_max_iters": 8000}
SOC_EF_OPTS = {"pdhg_eps": 1e-5, "pdhg_max_iters": 20000}
SOC_PH_OPTS = {"defaultPHrho": 50.0, "PHIterLimit": 2, "convthresh": 1e-6,
               "pdhg_eps": 1e-4, "pdhg_max_iters": 20000}
SOC_EOBJ_TOL_REL = 1e-3
SOC_CUTS = {"rounds": {"JAX test (synthetic grid)": 6, "here": SOC_ROUNDS},
            "refine": {"soc_refine default": {"pdhg_eps": 1e-6,
                                              "pdhg_max_iters": 60000},
                       "here": SOC_REFINE_OPTS},
            "ef": {"JAX test": {"pdhg_eps": 1e-6, "pdhg_max_iters": 100000,
                                "certify": True},
                   "here": dict(SOC_EF_OPTS, certify=False)},
            "ph": {"JAX test": {"pdhg_eps": 1e-6, "pdhg_max_iters": 100000,
                                "PHIterLimit": 10},
                   "here": {k: SOC_PH_OPTS[k] for k in ("pdhg_eps",
                                                         "pdhg_max_iters",
                                                         "PHIterLimit")}}}
# cross-scenario cuts: wheel_row's farmer batch (S=100,
# f32) with the capacity added (40 cut rows, eta weight 0.1), a PH hub
# with CrossScenarioExtension, the cut spoke and an xhat-shuffle spoke
# (for the inner bound of the bracket) on the base batch, interleaved.
# PHIterLimit is cut from wheel_row's 40 to 2: every blended hub solve
# runs to its 30,000-iteration cap, 6 iterations took 47 s and 3 took
# 26 s on an NVIDIA H100 80GB HBM3 at 700 W
CROSS_MAX_CUTS, CROSS_W, CROSS_PH_ITERS = 40, 0.1, 2
# multiproc mode: wheel_row's dicts with "proc" specs, each
# spoke a child process on the card over the native windows; then a
# supervised run whose Lagrangian child chaos crashes (os._exit) at its
# third step, restarted once, then pruned
MULTIPROC_TELEMETRY_DIR = os.path.join("build", "wheel_multiproc_telemetry")
MULTIPROC_HUB_OPTS = {"supervise_interval": 0.5,
                      "shutdown_join_timeout": 120.0}
MULTIPROC_CHAOS = {"crash_at_step": 3, "hard_exit": True}
MULTIPROC_CHAOS_HUB_OPTS = {"supervise_interval": 0.1,
                            "spoke_max_restarts": 1,
                            "spoke_restart_backoff": 0.1,
                            "shutdown_join_timeout": 60.0}
MULTIPROC_CHAOS_WALL_S = 120.0
# run checkpoints: farmer PH in f64 at wheel_row's size,
# the JAX test's options (tests/test_resilience.py), crashed by chaos
# after iteration CKPT_CRASH_AT's checkpoint and resumed
CKPT_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 8, "convthresh": 0.0,
             "pdhg_eps": 1e-7, "pdhg_max_iters": 20000}
CKPT_CRASH_AT = 4
CKPT_PATH = os.path.join("build", "checkpoint", "run.ckpt")
# the kernel at the shapes the soc, cross_scen, wheel_multiproc and
# checkpoint paths put on it: (row, form, the
# source of A expected in f32 and f64, the path whose launches it
# carries).  wheel_row's split prep (100, 7, 12) runs in the multiproc
# hub and children (f32) and in the checkpoint runs (f64); the
# cross-scenario hub's augmented dense batch (100, 47, 13); acopf3's SOC
# batch (4, 814, 600), qs != 0, in the SOC PH (f64; A resident at C=16
# in f32, streamed in f64)
NEW_PATH_KERNEL_CASES = (
    ("split_wheel_row", "split", ("registers", "registers")),
    ("dense_cross_scen", "dense", ("registers", "registers")),
    ("qs_soc_ieee14", "dense", ("resident", "streamed")))
# values the second process's phases share (the aircond HiGHS optimum)
SHARED = {}
# the corpus phase, the ALG_CHILD algorithms, soc and cross_scen run in
# a second process (this script with this flag); its lines go to
# SECOND_PROCESS_OUT until main() copies them to its own output; one
# still running after SECOND_PROCESS_TIMEOUT_S is killed and fails the
# script; it runs at this CPU niceness
SECOND_PROCESS_FLAG = "--second-process"
SECOND_PROCESS_OUT = os.path.join("build", "second_process.jsonl")
SECOND_PROCESS_TIMEOUT_S = 900
SECOND_PROCESS_NICE = 10
# the farmer creator path's size (SPBase(scenario_creator=...) against
# build_batch)
CORPUS_CREATOR_S, CORPUS_CREATOR_CM = 100, 10
# the plain hydro PH run of tests/test_hydro_multistage.py:98-112 (its
# goldens: trivial bound 180, E[obj] 190 at 2 significant figures)
HYDRO_GOLDEN_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 100,
                     "convthresh": 1e-6, "pdhg_eps": 1e-8,
                     "pdhg_max_iters": 40000}

# converged-scenario compaction (pdhg_compact_threshold): the value of
# the bench's BENCH_COMPACT example (bench.py:1280-1285), and the width
# of the gathered slab the kernel phase launches at (a seeded choice of
# COMPACT_S of the S scenarios, as solve_compacted gathers survivors)
COMPACT_THRESHOLD = 0.5
COMPACT_S = 256
# PH iterations run with telemetry phase timing after a phase's measured
# window (bench.py:_telemetry_extras)
PHASE_TIMING_ITERS = 2
# where the wheel_row_telemetry run writes trace.json and metrics.jsonl
WHEEL_TELEMETRY_DIR = os.path.join("build", "wheel_row_telemetry")
# wheel_row_telemetry's PHIterLimit: the row's 40 until the soc,
# cross_scen, wheel_multiproc and checkpoint phases needed the time
# (its wall is compared per superstep)
WHEEL_TELEMETRY_ITERS = 10

# Kernel-vs-twin tolerance, as max|kernel - twin| / max(1, max|twin|):
# both do the same arithmetic in the same order except the summation
# order inside the two matvecs; over 40 steps that is ~1e-13 relative
# in f64 and, in f32, up to a few hundred ulp of the largest iterate
# (the chunk amplifies rounding by the number of steps and the row
# length).  With A in bf16 both cast the same bf16 values up and run in
# f32, so bf16 has f32's tolerance.
TOL = {"float64": 1e-9, "float32": 2e-4, "bfloat16": 2e-4}
# what each kernel row of the kernels line says of its launch: the
# kernel (tiled or cluster), the cluster size, blocks per SM, the
# clusters the card holds at once and the waves
CLUSTER_KEYS = ("kernel", "cluster", "blocks_per_sm", "active_clusters",
                "waves")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, reps=5, batch=20, warmup=3, queue_behind_sleep=False):
    """Median over `reps` runs of the mean time per call of `batch`
    back-to-back calls between two CUDA events, after warmup.  Events
    around a single call would also count the host's time to reach the
    launch (the wrapper's checks, the ctypes call), while the device
    waits.  queue_behind_sleep: first put a spin kernel of 8e6 clock
    cycles (4 ms at 2 GHz) on the stream, so that the host enqueues all
    `batch` calls while the device is still busy; the events then
    bracket device work alone even when one call's device work is
    shorter than its host cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queue_behind_sleep:
            torch.cuda._sleep(8_000_000)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def host_us(fn, n=50):
    """Host time per call of `fn` (enqueue only: no synchronize)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return dt


def template_args(mangled):
    """The template arguments of a mangled `pdhg_chunk_tiled<...>` or
    `pdhg_chunk_cluster<...>` name (Itanium ABI: f float, d double,
    <len><name> a class, Li<n>E an int), or None for another kernel."""
    for kernel in ("pdhg_chunk_tiledI", "pdhg_chunk_clusterI"):
        i = mangled.find(kernel)
        if i >= 0:
            break
    else:
        return None
    rest, args = mangled[i + len(kernel):], []
    while rest and rest[0] != "E":
        m = re.match(r"Li(-?\d+)E|(\d+)|([fd])", rest)
        if m is None:
            return None
        if m.group(1) is not None:
            args.append(m.group(1))
        elif m.group(3) is not None:
            args.append({"f": "float", "d": "double"}[m.group(3)])
        else:
            n = int(m.group(2))
            args.append(rest[m.end():m.end() + n])
            rest = rest[n:]
        rest = rest[m.end():]
    return args


def ptxas_report(log):
    """What `nvcc -Xptxas -v` said about each kernel: its template
    arguments (the tiled kernel: storage, compute, rows per thread,
    column vectors per lane, warps, source of A 0 (registers), form of
    A: 0 dense / 1 shared / 2 split, min blocks per SM; the cluster
    kernel: storage, compute, source of A: 1 resident / 2 streamed,
    form), registers, stack, spill stores and loads."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"mangled": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    for k in out:
        name = k.pop("mangled")
        args = template_args(name)
        k["variant"] = ", ".join(args) if args else name
        k["kernel"] = ("pdhg_chunk_cluster" if "pdhg_chunk_clusterI" in name
                       else "pdhg_chunk_tiled")
    return out


# template arguments of the main path's f32 variant (all but min blocks):
# storage, compute, R, V, W, source (0 registers), form (0 dense)
MAIN_F32 = ["float", "float", "8", "1", "8", "0", "0"]


def sass_summary(lib):
    """The instruction mix of the main path's f32 variant's step loop
    (the backward branch whose body holds the most barriers), from
    `cuobjdump -sass`; None where the tool is missing."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    for block in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        args = template_args(block.split("\n", 1)[0].strip())
        if not args or args[:7] != MAIN_F32 or "pdhg_chunk_tiledI" not in \
                block.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), i.strip()) for a, i in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        best = (0, [])
        for addr, i in ins:
            m = re.search(r"BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", i)
            if m and int(m.group(1), 16) < addr:
                body = [j for b, j in ins if int(m.group(1), 16) <= b <= addr]
                bars = sum("BAR.SYNC" in j for j in body)
                if bars > best[0]:
                    best = (bars, body)
        ops = {}
        for j in best[1]:
            op = re.sub(r"^@!?U?P\w+\s+", "", j).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        return {"variant": ", ".join(args), "barriers": best[0],
                "loop_instructions": len(best[1]),
                "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return None


def build_phase():
    from mpisppy_tpu_torch.ops import pdhg_chunk
    t = time.time()
    lib = pdhg_chunk.build()
    pdhg_chunk.load_library()
    report = ptxas_report(pdhg_chunk.build_log_path().read_text())
    # for each of f32, f64 and bf16: each form with A in registers (the
    # tiled kernel) and with A resident or streamed (the cluster kernel)
    check(len(report) == 27, f"ptxas reported {len(report)} kernels")
    check(sum(k["kernel"] == "pdhg_chunk_cluster" for k in report) == 18,
          "ptxas reported other than 18 cluster kernels")
    main = [k for k in report if k["kernel"] == "pdhg_chunk_tiled"
            and k["variant"].split(", ")[:7] == MAIN_F32]
    check(len(main) == 1, "no ptxas line for the main path's f32 variant")
    for k in report:
        check(k.get("spill_stores", 1) == 0 and k.get("spill_loads", 1) == 0,
              f"a variant spills: {k}")
    emit({"phase": "build", "library": str(lib), "s": time.time() - t,
          "ptxas": report, "main_f32_step_loop": sass_summary(lib)})


def compact_rows():
    """COMPACT_S of the S scenario rows, a seeded choice in order: the
    survivors a compacted solve gathers."""
    return np.sort(np.random.default_rng(0).choice(S, COMPACT_S,
                                                   replace=False))


def solver_space_inputs(dtype, split=False, gather=None, scens=S, cm=CM):
    """The chunk's inputs as PDHGSolver builds them for farmer S=1000,
    crops_multiplier=10 (or `scens`, `cm`; Ruiz-scaled prep, cold start,
    omega=1): from the dense prep, or with split=True from the split
    prep of farmer's default options (A is then a SplitA).  gather:
    scenario rows to gather the prep (`ops.pdhg._gather_prep`) and the
    batch down to, as `solve_compacted` does."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    b = farmer.build_batch(scens, crops_multiplier=cm,
                           dtype=np.float32 if dtype == torch.float32
                           else np.float64)
    return batch_space_inputs(b, split=split, gather=gather)


def batch_space_inputs(b, split=False, gather=None):
    """solver_space_inputs for a batch `b` (boxes may be infinite
    above)."""
    import torch

    from mpisppy_tpu_torch.ops.pdhg import (_gather_prep, prepare_batch,
                                            prepare_batch_split)
    if split:
        p = prepare_batch_split(b.A, *b.model_meta["A_delta_idx"],
                                b.row_lo, b.row_hi)
    else:
        p = prepare_batch(b.A, b.row_lo, b.row_hi)
    c, q, lb, ub = b.c, b.qdiag, b.lb, b.ub
    if gather is not None:
        ii = torch.as_tensor(gather, device=c.device)
        p = _gather_prep(p, ii)
        c, q, lb, ub = c[ii], q[ii], lb[ii], ub[ii]
    dc = p.d_col
    qs = q * dc * dc
    lbs = lb / dc
    ubs = torch.where(torch.isfinite(ub), ub / dc, ub)
    # a warm, non-trivial start: the box midpoint clipped
    x = torch.clamp(0.5 * (lbs + torch.clamp(ubs, max=1e3)), min=0.0)
    y = torch.zeros_like(p.row_lo)
    tau = 0.9 / (p.anorm + 0.9 * qs.amax(dim=1))
    sigma = (0.9 / p.anorm).expand(tau.shape)
    vec = [t.contiguous() for t in (c * dc, qs, lbs, ubs, p.row_lo,
                                    p.row_hi, x, y, tau, sigma)]
    return [p.A.contiguous()] + vec


def on_chip_bytes():
    """What the card can hold on chip between two reads of A: every SM's
    opt-in shared memory (the library's query) plus the L2 cache
    (torch's device properties)."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg_chunk
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", None)
    check(l2 is not None and l2 > 0, "torch reports no L2 size")
    return props.multi_processor_count * pdhg_chunk.smem_optin() + l2


def chunk_bytes(A, vec, n_steps=N_STEPS, on_chip=None, wave=None):
    """Bytes the chunk must move: each input read once (A at its storage
    width, a shared matrix once for all scenarios, a SplitA's shared
    block and coordinates once plus its per-scenario values), each
    output written once; and, where the A of the `wave` scenarios the
    card works on at once (default all S; the shared part once, the
    per-scenario part `wave` times) exceeds what it holds on chip
    (`on_chip`, default on_chip_bytes()), that excess again at every
    step of each of the ceil(S / wave) waves:
    |A| + n_steps x ceil(S / wave) x max(0, |A of a wave| - on_chip)."""
    from mpisppy_tpu_torch.ir import SplitA
    S = vec[0].shape[0]
    if isinstance(A, SplitA):
        shared = (A.shared.numel() * A.shared.element_size()
                  + 2 * A.rows.numel() * A.rows.element_size())
        each = A.vals.numel() * A.vals.element_size() // S
    elif A.shape[0] == 1:
        shared, each = A.numel() * A.element_size(), 0
    else:
        shared, each = 0, A.numel() * A.element_size() // S
    wave = S if wave is None else max(1, min(S, wave))
    if on_chip is None:
        on_chip = on_chip_bytes()
    vin = sum(t.numel() * t.element_size() for t in vec)
    vout = 2 * (vec[6].numel() + vec[7].numel()) * vec[6].element_size()
    excess = max(0, shared + wave * each - on_chip)
    return (shared + S * each + n_steps * -(-S // wave) * excess
            + vin + vout)


def measure_form(form, A, vec, dname, peak, bw, peak_name, n_sm):
    """One form of the chunk kernel on (A, vec): error against its plain
    version and, for the shared and split forms, against the dense
    kernel on the assembled matrices (must be 0); time, bound and
    occupancy.  Returns the row."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg_chunk
    store = A.dtype
    S = vec[0].shape[0]
    ref = pdhg_chunk.REFERENCE[form]
    got = pdhg_chunk.fused_chunk(A, *vec, N_STEPS)
    torch.cuda.synchronize()
    want = ref(A, *vec, N_STEPS)
    err_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    err_rel = max(float((g - w).abs().max())
                  / max(1.0, float(w.abs().max()))
                  for g, w in zip(got, want))
    for g in got:
        check(bool(torch.isfinite(g).all()),
              f"{form} {dname} kernel output not finite")
    check(err_rel <= TOL[dname],
          f"{form} {dname} kernel disagrees with its plain version:"
          f" {err_rel:.3e} > {TOL[dname]:.0e}")
    vs_dense = None
    if form != "dense":
        dense = (A.expand(S, -1, -1) if form == "shared"
                 else A.to_dense()).contiguous()
        d = pdhg_chunk.fused_chunk(dense, *vec, N_STEPS)
        vs_dense = max(float((g - w).abs().max()) for g, w in zip(got, d))
        check(vs_dense == 0.0,
              f"{form} {dname} kernel differs from the dense kernel "
              f"on the assembled matrices by {vs_dense}")

    def call():
        return pdhg_chunk.fused_chunk(A, *vec, N_STEPS)

    ms = time_ms(call, queue_behind_sleep=True)
    wrapper_us = host_us(call)
    plain_ms = time_ms(lambda: ref(A, *vec, N_STEPS))
    _, M, N = A.shape
    variant, blocks, held = pdhg_chunk.occupancy(S, M, N, store, form)
    # a wave: the scenarios the card holds at once (a cluster or tiled
    # block each)
    nbytes = chunk_bytes(A, vec, wave=held)
    # FLOP at the compute type's peak (bf16 storage computes in f32):
    # the two matvecs and the elementwise updates
    flops = N_STEPS * S * (4 * M * N + 10 * N + 8 * M)
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / peak * 1e3
    bound = max(t_bytes, t_ops)
    return {
        "form": form, "dtype": dname, "S": S, "M": M, "N": N,
        "n_steps": N_STEPS, "max_abs_err": err_abs,
        "max_rel_err": err_rel, "tol_rel": TOL[dname],
        "max_abs_err_vs_dense_kernel": vs_dense,
        "ms": ms, "wrapper_host_us": wrapper_us,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "share_of_bound": bound / ms,
        "bytes": nbytes, "flops": flops,
        "peaks": {"card": peak_name, "bytes_per_s": bw,
                  "flops_per_s": peak},
        "variant": dataclasses.asdict(variant),
        "kernel": ("pdhg_chunk_tiled" if variant.source == "registers"
                   else "pdhg_chunk_cluster"),
        "cluster": variant.cluster, "blocks_per_sm": blocks, "sms": n_sm,
        "active_clusters": held, "waves": S / held,
        "library_ms": None}


def uc_solver_space_inputs(dtype):
    """The chunk's inputs as PDHGSolver builds them for UC at the
    bench's fallback size (S=UC_FALLBACK_S, fleet_multiplier=2, H=6):
    the shared (1, 174, 114) matrix of its Ruiz-scaled prep."""
    import torch

    from mpisppy_tpu_torch.models import uc
    return model_solver_space_inputs(uc.build_batch(
        UC_FALLBACK_S, **UC_FALLBACK,
        dtype=np.float32 if dtype == torch.float32 else np.float64))


def kernel_phase(name):
    """Each form of the chunk kernel at the main paths' shapes, in f32,
    f64 and bf16 storage (farmer S=1000, cm=10: dense, shared, split;
    UC's fallback size: the shared form at (1, 174, 114) with A staged
    in shared memory): error against its plain version; for the shared
    and split forms also against the dense kernel on the assembled
    matrices (must be 0); time, bound and occupancy."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.utils.mfu import cuda_peaks
    peak_name, (bw, f32_peak, f64_peak) = cuda_peaks(name)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    base = {False: solver_space_inputs(torch.float32),
            True: solver_space_inputs(torch.float32, split=True)}
    uc_base = uc_solver_space_inputs(torch.float32)
    rows = {}
    for store, peak in ((torch.float32, f32_peak),
                        (torch.float64, f64_peak),
                        (torch.bfloat16, f32_peak)):
        dname = str(store).replace("torch.", "")
        for form in pdhg_chunk.FORMS + ("shared_uc",):
            split = form in ("shared", "split")
            if form == "shared_uc":
                args = (uc_solver_space_inputs(torch.float64)
                        if store == torch.float64 else list(uc_base))
                args[0] = args[0].to(store)
            elif store == torch.float64:
                args = solver_space_inputs(torch.float64, split=split)
            else:
                args = list(base[split])
                args[0] = args[0].astype(store) if split \
                    else args[0].to(store)
            A, vec = args[0], args[1:]
            if form == "shared":
                # the split prep's shared block as one matrix for all
                A = A.shared[None].contiguous()
            row = measure_form("shared" if form == "shared_uc" else form,
                               A, vec, dname, peak, bw, peak_name, n_sm)
            if form == "shared_uc":
                check(row["variant"]["source"] == "resident",
                      f"UC's fallback shape took {row['variant']}")
                row["case"] = "uc_fallback"
            rows[(form, dname)] = row
            emit({"phase": "kernel", **row})
    # the dense and split forms on a compacted slab: the prep gathered
    # to COMPACT_S rows as solve_compacted gathers its survivors
    for form in ("dense", "split"):
        args = solver_space_inputs(torch.float32, split=form == "split",
                                   gather=compact_rows())
        A, vec = args[0], args[1:]
        if form == "split":
            check(tuple(A.vals.shape) == (COMPACT_S, A.rows.shape[0])
                  and A.vals.is_contiguous(),
                  f"the gathered SplitA's vals are {tuple(A.vals.shape)}")
        row = measure_form(form, A, vec, "float32", f32_peak, bw,
                           peak_name, n_sm)
        check(row["S"] == COMPACT_S, f"the slab has S={row['S']}")
        row["case"] = "compacted_slab"
        rows[(form + "_compacted", "float32")] = row
        emit({"phase": "kernel", **row})
    rows.update(corpus_kernel_rows(peak_name, bw, f32_peak, f64_peak, n_sm))
    rows.update(alg_kernel_rows(peak_name, bw, f32_peak, f64_peak, n_sm))
    rows.update(new_path_kernel_rows(peak_name, bw, f32_peak, f64_peak,
                                    n_sm))
    rows.update(cluster_forms_rows())
    return rows


def cluster_forms_rows():
    """The shared and split forms on the cluster kernel, on both sources
    of A: UC's fallback matrix (its Ruiz-scaled prep, shared (1, 174,
    114), S=UC_FALLBACK_S) as the shared form, and as a SplitA with
    per-scenario deltas at 2 M seeded slots (the shared block zero
    there), in f32, f64 and bf16 storage; at the variant the card picks
    and at forced variants (resident in clusters of 4, streamed in
    clusters of 1 and 4).  Each must equal the dense kernel on the
    assembled matrices bit for bit and match its plain version."""
    import torch

    from mpisppy_tpu_torch.ir import SplitA
    from mpisppy_tpu_torch.ops import pdhg_chunk
    V = pdhg_chunk.Variant
    rows = {}
    for store in (torch.float32, torch.float64, torch.bfloat16):
        dname = str(store).replace("torch.", "")
        args = uc_solver_space_inputs(
            torch.float64 if store == torch.float64 else torch.float32)
        shared, vec = args[0].to(store), args[1:]
        S, M, N = vec[0].shape[0], shared.shape[1], shared.shape[2]
        rng = np.random.default_rng(31)
        nnz = 2 * M
        r = rng.integers(0, M, nnz).astype(np.int32)
        c = rng.integers(0, N, nnz).astype(np.int32)
        r[-1], c[-1] = r[0], c[0]
        block = shared[0].clone()
        block[torch.as_tensor(r).long(), torch.as_tensor(c).long()] = 0
        split = SplitA(shared=block.contiguous(),
                       rows=torch.as_tensor(r, device=block.device),
                       cols=torch.as_tensor(c, device=block.device),
                       vals=torch.as_tensor(
                           rng.standard_normal((S, nnz)) * 0.1,
                           device=block.device).to(store).contiguous())
        forms = {"shared": (shared, shared.expand(S, -1, -1).contiguous()),
                 "split": (split, split.to_dense().contiguous())}
        picked = pdhg_chunk.card_variant(S, M, N, store)
        for v in (picked, V("resident", 4), V("streamed", 1, 4),
                  V("streamed", 4, 4)):
            out = {"phase": "kernel", "case": "cluster_forms",
                   "dtype": dname, "S": S, "M": M, "N": N,
                   "n_steps": N_STEPS, "variant": dataclasses.asdict(v),
                   "picked": v == picked}
            for form, (A, dense) in forms.items():
                got = pdhg_chunk.fused_chunk(A, *vec, N_STEPS, variant=v)
                want = pdhg_chunk.fused_chunk(dense, *vec, N_STEPS,
                                              variant=v)
                torch.cuda.synchronize()
                vs_dense = max(float((g - w).abs().max())
                               for g, w in zip(got, want))
                check(vs_dense == 0.0,
                      f"cluster_forms {form} {dname} {v} differs from the "
                      f"dense kernel by {vs_dense}")
                ref = pdhg_chunk.REFERENCE[form](A, *vec, N_STEPS)
                err = max(float((g - w).abs().max())
                          / max(1.0, float(w.abs().max()))
                          for g, w in zip(got, ref))
                check(err <= TOL[dname] and all(
                    bool(torch.isfinite(g).all()) for g in got),
                      f"cluster_forms {form} {dname} {v}: {err:.3e} from "
                      f"its plain version")
                out[form] = {"max_rel_err": err,
                             "max_abs_err_vs_dense_kernel": vs_dense}
            rows[("cluster_forms", dname, v)] = out
            emit(out)
    return rows


def reset_counts():
    """Zero the kernel's launch counts and the matmul and consensus
    routes' chunk counts (just before a path is driven)."""
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    pdhg_chunk.launches = 0
    pdhg_chunk.launch_shapes.clear()
    pdhg_chunk.variant_launches.clear()
    pdhg.matmul_chunks = 0
    pdhg.consensus_chunks = 0


def launch_table():
    """The (form, S, M, N, dtype) tuples the kernel launched with since
    the last reset_counts(), with their counts."""
    from mpisppy_tpu_torch.ops import pdhg_chunk
    return [{"form": k[0], "S": k[1], "M": k[2], "N": k[3], "dtype": k[4],
             "launches": n}
            for k, n in sorted(pdhg_chunk.launch_shapes.items())]


def phase_timing(ph, n=PHASE_TIMING_ITERS):
    """bench.py's _telemetry_extras: after a phase's measured window, n
    more PH iterations under telemetry phase timing (the superstep as
    its solve / x̄ psum / W update / conv cuts, a device sync after
    each); the mean seconds of each cut, and the window traffic."""
    import torch

    from mpisppy_tpu_torch import telemetry
    out = {"window_traffic": telemetry.traffic_counters()}
    prev = telemetry._active
    tel = telemetry.configure({"enabled": True, "phase_timing": True})
    saved = ph._tel
    ph._tel = tel
    t = time.time()
    try:
        for _ in range(n):
            ph.ph_iteration()
        torch.cuda.synchronize()
        hists = tel.registry.snapshot()["histograms"]
    finally:
        ph._tel = saved
        telemetry._active = prev
    cuts = ("solve", "psum", "w_update", "conv")
    secs = {k: hists.get(f"ph.phase.{k}_seconds", {}).get("mean")
            for k in cuts}
    check(all(v is not None and np.isfinite(v) for v in secs.values())
          and all(hists[f"ph.phase.{k}_seconds"]["count"] == n
                  for k in cuts), f"phase timing incomplete: {hists}")
    total = sum(secs.values())
    out.update({"phase_seconds": secs, "phase_timing_iters": n,
                "phase_timing_wall_s": time.time() - t,
                "solve_share_of_phases": secs["solve"] / total,
                "ph_iteration_mean_s":
                    hists["ph.iteration_seconds"]["mean"]})
    return out


def slice_phase():
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    opts = dict(SLICE_OPTS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                    # count the main path's run only
    t0 = time.time()
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    ph = PH(opts, [f"scen{i}" for i in range(S)], batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup", "s": time.time() - t0}]

    def timed(step, fn):
        n0, t = pdhg_chunk.launches, time.time()
        out = fn()
        torch.cuda.synchronize()
        steps.append({"step": step, "s": time.time() - t,
                      "launches": pdhg_chunk.launches - n0,
                      "solve_iters": int(ph.state.solve_iters)
                      if ph.state is not None else None})
        return out

    trivial = timed("iter0", ph.Iter0)
    for k in range(PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
    inner, feas = timed("evaluate_xhat", lambda: ph.evaluate_xhat(
        ph.root_xbar()))
    outer = timed("lagrangian_bound", ph.lagrangian_bound)
    gap = gap_loop(PH, opts, b)
    gap["profile"] = profile_window(gap.pop("ph"))
    launches = pdhg_chunk.launches
    shapes = launch_table()
    check(sum(r["launches"] for r in shapes) == launches,
          "the per-shape launch counts do not add up")
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    check(all(np.isfinite([trivial, inner, outer])),
          f"bounds not finite: {trivial}, {inner}, {outer}")
    check(feas, "xhat candidate infeasible")
    check(max(trivial, outer) <= inner + 1e-6 * abs(inner),
          f"outer bound above inner: {max(trivial, outer)} > {inner}")
    check(launches > 0, "the main path launched no kernel")
    it_launches = [s["launches"] for s in steps
                   if s["step"].startswith("ph_iteration")]
    out = {"phase": "slice", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "ph_iterations": PH_ITERS,
           "trivial_bound": trivial, "inner_bound": inner,
           "outer_bound": outer, "conv": ph.conv,
           "rel_gap": (inner - max(trivial, outer)) / abs(inner),
           "kernel_launches": launches, "launch_shapes": shapes,
           "launches_per_ph_iteration": it_launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "steps": steps, "pdhg_stats": ph.pdhg_stats(),
           "gap_loop": gap}
    out.update(phase_timing(ph))
    emit(out)
    return out


def split_phase():
    """Path (a): farmer S=1000, cm=10, f32 with the bench's options and
    `no_split_prep` left out (its BENCH_SPLIT=1 row at the fallback
    size).  The delta-split prep feeds the PH supersteps through the
    kernel's split form and the shared (1, M, N) xhat system through its
    shared form.  The bench's gap loop to a verified 1% gap, then a
    profiled window of 2 PH iterations."""
    import torch

    from mpisppy_tpu_torch.ir import SplitA
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    opts = dict(SPLIT_OPTS)
    torch.cuda.reset_peak_memory_stats()
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    reset_counts()                    # count this path's run only
    t0 = time.time()
    gap = gap_loop(PH, opts, b)
    ph = gap.pop("ph")
    check(isinstance(ph.prep.A, SplitA), "the default prep is not split")
    check(tuple(ph.prep.d_row.shape) == (1, b.num_rows),
          f"the split prep's d_row is {tuple(ph.prep.d_row.shape)}")
    by_form = pdhg_chunk.launches_by("form")
    by_form_dtype = pdhg_chunk.launches_by("form/dtype")
    shapes = launch_table()
    matmul = pdhg.matmul_chunks
    check(by_form.get("split", 0) > 0, "the split form never launched")
    check(by_form.get("shared", 0) > 0, "the shared form never launched")
    check(matmul == 0, f"{matmul} chunks took the matmul route at cm=10")
    wall = time.time() - t0
    gap["profile"] = profile_window(ph)
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    out = {"phase": "split", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "prep": "delta-split (no no_split_prep)",
           "launches_by_form": by_form,
           "launches_by_form_dtype": by_form_dtype,
           "launch_shapes": shapes, "matmul_chunks": matmul,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "wall_s": wall, "gap_loop": gap,
           "pdhg_stats": ph.pdhg_stats()}
    out.update(phase_timing(ph))
    emit(out)
    return out


def true_size_phase(name, split_gap):
    """Path (b): the true-size instance, farmer crops_multiplier=1000
    (M=6001, N=12000 per scenario), f32, born split-native, with the
    bench's options: Iter0, PH iterations, one xhat inner bound and one
    Lagrangian outer bound.  Its operator is too large for the kernel's
    tile, so its solves take the matmul route; no (S, M, N) tensor
    exists (the dense one would be ~288 GB at S=1000).  TRUE_S is the
    scenario count (1000 uncut)."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.utils.mfu import cuda_peaks
    peak_name, (bw, f32_peak, _) = cuda_peaks(name)
    # under the bench's iteration caps Iter0 leaves part of the
    # probability mass primal-infeasible at this size (0.785 feasible at
    # S=1000): the run goes on with that mass reported, as the option
    # allows, so that the rest of the path is driven and checked
    opts = dict(SPLIT_OPTS, PHIterLimit=TRUE_PH_ITERS,
                iter0_infeasibility_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                    # count this path's run only
    t0 = time.time()
    b = farmer.build_batch(TRUE_S, crops_multiplier=TRUE_CM,
                           dtype=np.float32)
    check(b.split_A, "the true-size batch is not split-native")
    ph = PH(opts, [f"scen{i}" for i in range(TRUE_S)], batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup (build + split prep)", "s": time.time() - t0}]

    def timed(step, fn):
        n0, m0 = pdhg_chunk.launches_by("form/dtype"), pdhg.matmul_chunks
        c0, t = ph._certify_wall, time.time()
        out = fn()
        torch.cuda.synchronize()
        n1 = pdhg_chunk.launches_by("form/dtype")
        steps.append({
            "step": step, "s": time.time() - t,
            "certify_s": ph._certify_wall - c0,
            "matmul_chunks": pdhg.matmul_chunks - m0,
            "kernel_launches": {k: n1[k] - n0.get(k, 0) for k in n1
                                if n1[k] != n0.get(k, 0)},
            "solve_iters": int(ph.state.solve_iters)
            if ph.state is not None else None})
        emit({"phase": "true_size_step", **steps[-1]})
        return out

    trivial = timed("iter0", ph.Iter0)
    for k in range(TRUE_PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
    inner, feas = timed("evaluate_xhat", lambda: ph.evaluate_xhat(
        ph.root_xbar()))
    outer = timed("lagrangian_bound", ph.lagrangian_bound)
    wall = time.time() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    path_chunks = pdhg.matmul_chunks     # before the timing calls below
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    check(all(np.isfinite([trivial, inner, outer])),
          f"true-size bounds not finite: {trivial}, {inner}, {outer}")
    check(feas, "true-size xhat candidate infeasible")
    check(max(trivial, outer) <= inner + 1e-6 * abs(inner),
          f"true-size outer bound above inner: {max(trivial, outer)} > "
          f"{inner}")
    check(peak_mem < 20e9, f"true-size peak device memory {peak_mem}")
    check(path_chunks > 0, "the true-size path ran no matmul chunk")
    straggler = single_straggler_check(ph)

    # one matmul-route chunk alone, on the solver-space data of the prep
    p = ph.prep
    dc = p.d_col
    vec = [b.c * dc, b.qdiag * dc * dc, b.lb / dc,
           torch.where(torch.isfinite(b.ub), b.ub / dc, b.ub),
           p.row_lo, p.row_hi]
    x, y = torch.zeros_like(b.c), torch.zeros_like(p.row_lo)
    tau = 0.9 / (p.anorm + 0.9 * vec[1].amax(dim=1))
    sigma = (0.9 / p.anorm).expand(tau.shape)
    chunk_ms = time_ms(lambda: pdhg.matmul_chunk(p.A, *vec, x, y, tau,
                                                 sigma, N_STEPS),
                       reps=3, batch=1, warmup=1)
    M, N = b.num_rows, b.num_vars
    step_flops = 2 * 2 * TRUE_S * M * N
    step_bound = step_flops / f32_peak * 1e3
    prof = profile_window(ph, n=1)
    out = {"phase": "true_size", "S": TRUE_S, "crops_multiplier": TRUE_CM,
           "M": M, "N": N, "dtype": "float32", "split_native": True,
           "cut": (None if TRUE_S == 1000 else
                   f"S cut from 1000 to {TRUE_S} (125 until the driver "
                   f"phase, 64 until the corpus phase needed the time) "
                   f"and PH iterations to {TRUE_PH_ITERS} (2 until the "
                   f"soc, cross_scen, wheel_multiproc and checkpoint "
                   f"phases needed the time) to stay well inside "
                   f"the "
                   f"smoke's time limit; crops_multiplier, pdhg_eps and "
                   f"pdhg_max_iters as the bench"),
           "options_beyond_the_bench": {"iter0_infeasibility_ok": True},
           "iter0_feasible_mass": ph.iter0_feas_mass,
           "ph_iterations": TRUE_PH_ITERS, "trivial_bound": trivial,
           "inner_bound": inner, "outer_bound": outer, "conv": ph.conv,
           "rel_gap": (inner - max(trivial, outer)) / abs(inner),
           "wall_s": wall, "steps": steps,
           "max_memory_allocated": peak_mem,
           "dense_A_bytes": 4 * TRUE_S * M * N,
           "matmul_chunks": path_chunks,
           "kernel_launches": pdhg_chunk.launches_by("form/dtype"),
           "matmul_chunk_ms": chunk_ms,
           "matmul_step_ms": chunk_ms / N_STEPS,
           "matmul_step_bound_ms": step_bound,
           "matmul_step_bound_by": "operations",
           "matmul_step_share_of_bound": step_bound / (chunk_ms / N_STEPS),
           "peaks": {"card": peak_name, "flops_per_s": f32_peak},
           "profile_1_ph_iteration": prof,
           "single_straggler_f64": straggler,
           "pdhg_stats": ph.pdhg_stats(),
           "iter0": {"s": steps[1]["s"], "trivial_bound": trivial,
                     "certify_s": steps[1]["certify_s"],
                     "iter0_feasible_mass": ph.iter0_feas_mass}}
    # what the bench's gap loop would take here: Iter0, then as many PH
    # iterations and bound checks as the cm=10 split gap loop needed (an
    # assumption: the loop's PH iteration count at cm=1000 is not
    # measured)
    it = [st["s"] for st in steps if st["step"].startswith("ph_iteration")]
    per_check = steps[-2]["s"] + steps[-1]["s"]
    out["gap_loop_projection_s"] = (
        steps[1]["s"] + split_gap["iters"] * statistics.mean(it)
        + split_gap["bound_checks"] * per_check)
    out["gap_loop_projection_basis"] = (
        "iter0 + (PH iterations of the cm=10 split gap loop, assumed for "
        "cm=1000, not measured) x mean PH iteration wall here + (its "
        "bound checks) x (xhat + Lagrangian wall here); not run")
    out.update(phase_timing(ph))
    emit(out)
    return out


def compact_tolerance(opts, step, residuals):
    """Relative tolerance within which a compacted solve's bound must
    agree with the uncompacted one (the JAX package's compaction
    contract: survivors restart each segment, with their restart
    average and omega re-seeded, so the two runs stop at different
    iterates that agree only up to the KKT test).  For one scenario whose
    solve ended with KKT residual r = max(pres, dres, gap), the dual
    objective lies within ~r (1 + |p| + |d|) ~ r (1 + 2 |obj|) of the
    scenario's optimum, so the two runs' expected bounds differ by at
    most ~2 (r̄_c + r̄_u) relative, r̄ the probability-weighted residual
    of each run (below the solve's eps e, clamped to the f32 floor
    1.19e-5, where every scenario converged; larger where one ends at
    its cap).  The tolerance is twice that, and at least 10 e for f32
    rounding; `residuals` is None for a step that solves the same
    problem uncompacted in both runs (xhat), which must agree to 10 e."""
    eps = opts["lagrangian_eps"] if step == "lagrangian_bound" \
        else opts["pdhg_eps"]
    floor = 10.0 * max(eps, 100 * float(np.finfo(np.float32).eps))
    return floor if residuals is None else max(floor, 4.0 * sum(residuals))


def compact_phase(true_iter0):
    """Converged-scenario compaction (pdhg_compact_threshold=
    COMPACT_THRESHOLD, the bench's BENCH_COMPACT example) on farmer
    S=1000, cm=10, f32 with the split phase's options.  First, without
    compaction: Iter0, one xhat at its x̄ and one Lagrangian bound at its
    W.  Then a second PH over the same batch and prep, with compaction:
    Iter0, and xhat and the Lagrangian bound at the first run's x̄ and W,
    so that each step solves the same problem in both runs.  Each
    step's wall, segment trajectory, FLOPs not spent and launches by
    (form, S').  evaluate_xhat solves through `_solve_impl`, not
    solve_loop, in both packages: it is never compacted.  Then Iter0 of
    the true-size instance at TRUE_S with the same threshold, beside the
    true_size phase's uncompacted Iter0 (`true_iter0`)."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    names = [f"scen{i}" for i in range(S)]
    opts_c = dict(SPLIT_OPTS, pdhg_compact_threshold=COMPACT_THRESHOLD)
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    ph_c = PH(opts_c, names, batch=b)
    ph_u = PH(dict(SPLIT_OPTS), names, batch=b, prep=ph_c.prep)
    check(ph_c.solver.compact_threshold == COMPACT_THRESHOLD
          and ph_u.solver.compact_threshold == 0.0,
          "the compaction option did not reach the solvers")

    def run(ph, xbar=None, W=None):
        reset_counts()
        steps, last = {}, {}
        solve_loop = ph.solve_loop

        def recording(*a, **kw):
            last["res"] = solve_loop(*a, **kw)
            return last["res"]

        ph.solve_loop = recording
        for step, fn in (
                ("iter0", ph.Iter0),
                ("evaluate_xhat", lambda: ph.evaluate_xhat(
                    ph.root_xbar() if xbar is None else xbar)[0]),
                ("lagrangian_bound", lambda: ph.lagrangian_bound(W=W))):
            saved0, ph._active_traj = ph._flops_saved, []
            n0 = dict(pdhg_chunk.launch_shapes)
            last.clear()
            t = time.time()
            value = fn()
            torch.cuda.synchronize()
            res = last.get("res")
            steps[step] = {
                "s": time.time() - t, "value": value,
                "segments": list(ph._active_traj),
                "flops_saved": ph._flops_saved - saved0,
                "residual": None if res is None else float(torch.sum(
                    b.prob * torch.maximum(torch.maximum(res.pres,
                                                         res.dres),
                                           res.gap))),
                "converged": None if res is None
                else int(torch.sum(res.converged)),
                "launches_by_form_S": {
                    f"{k[0]}/{k[1]}": n - n0.get(k, 0)
                    for k, n in pdhg_chunk.launch_shapes.items()
                    if n != n0.get(k, 0)}}
        del ph.solve_loop
        return steps, launch_table(), pdhg_chunk.launches_by("form")

    steps_u, _, by_form_u = run(ph_u)
    steps_c, shapes_c, by_form_c = run(ph_c, xbar=ph_u.root_xbar(),
                                       W=ph_u.state.W)
    narrow = sum(r["launches"] for r in shapes_c if r["S"] < S)
    check(narrow > 0, f"no launch below S={S} with compaction: {shapes_c}")
    gathered = False
    for step, st in steps_c.items():
        widths = [t["width"] for t in st["segments"]]
        check(widths == sorted(widths, reverse=True),
              f"{step}: a compacted width grew: {widths}")
        gathered |= any(w < S for w in widths)
        u = steps_u[step]
        tol = compact_tolerance(
            opts_c, step, None if st["residual"] is None
            else (st["residual"], u["residual"]))
        st["rel_diff_vs_uncompacted"] = (abs(st["value"] - u["value"])
                                         / max(1.0, abs(u["value"])))
        st["tol_rel"] = tol
        check(np.isfinite(st["value"])
              and st["rel_diff_vs_uncompacted"] <= tol,
              f"{step}: compacted {st['value']} against uncompacted "
              f"{u['value']} (tol {tol:.2e})")
    check(gathered, "no compacted segment ran below full width")
    out = {"phase": "compact", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "compact_threshold": COMPACT_THRESHOLD,
           "options": opts_c, "compacted": steps_c,
           "uncompacted": steps_u,
           "launch_shapes_compacted": shapes_c,
           "launches_by_form_compacted": by_form_c,
           "launches_by_form_uncompacted": by_form_u,
           "launches_below_full_width": narrow,
           "pdhg_stats_compacted": ph_c.pdhg_stats()}
    del ph_c, ph_u

    # true size: Iter0 with the same threshold
    bt = farmer.build_batch(TRUE_S, crops_multiplier=TRUE_CM,
                            dtype=np.float32)
    ph = PH(dict(SPLIT_OPTS, PHIterLimit=TRUE_PH_ITERS,
                 iter0_infeasibility_ok=True,
                 pdhg_compact_threshold=COMPACT_THRESHOLD),
            [f"scen{i}" for i in range(TRUE_S)], batch=bt)
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    trivial = ph.Iter0()
    torch.cuda.synchronize()
    wall = time.time() - t
    widths = [s_["width"] for s_ in ph._active_traj]
    check(widths == sorted(widths, reverse=True),
          f"true-size Iter0: a compacted width grew: {widths}")
    check(np.isfinite(trivial), f"true-size compacted Iter0 {trivial}")
    out["true_size_iter0"] = {
        "S": TRUE_S, "crops_multiplier": TRUE_CM,
        "compacted": {"s": wall, "trivial_bound": trivial,
                      "iter0_feasible_mass": ph.iter0_feas_mass,
                      "certify_s": ph._certify_wall,
                      "segments": list(ph._active_traj),
                      "flops_saved": ph._flops_saved,
                      "matmul_chunks": pdhg.matmul_chunks,
                      "solve_iters": ph.pdhg_stats()["inner_iters"]},
        "uncompacted_true_size_phase": true_iter0}
    emit(out)
    return out


def single_straggler_check(ph):
    """The float64 re-solve of one straggler on the xhat's reduced
    system, as `_certified_resolve` gathers it: the shared (1, M, N)
    matrix keeps its form at S=1 (the kernel cannot take it: its state
    alone exceeds shared memory), so the solve takes the matmul route.
    Two chunks: the route, not the verdict, is checked."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg
    f64 = torch.float64
    b, xc = ph.batch, ph._xhat_cache(None)
    full = pdhg.prepare_batch(xc["A_red"].to(f64), b.row_lo.to(f64),
                              b.row_hi.to(f64))
    one = pdhg._gather_prep(full, torch.tensor([0], device=b.c.device))
    check(tuple(one.A.shape) == (1, b.num_rows, b.num_vars),
          f"the gathered f64 xhat operator is {tuple(one.A.shape)}")
    m0, t = pdhg.matmul_chunks, time.time()
    res = pdhg.PDHGSolver(max_iters=2 * N_STEPS, eps=1e-5).solve(
        one, *(xc[k][:1].to(f64) for k in ("c_red", "q_red", "lb_red",
                                           "ub_red")))
    torch.cuda.synchronize()
    chunks = pdhg.matmul_chunks - m0
    check(chunks == int(res.iters) // N_STEPS > 0,
          f"the S=1 f64 xhat re-solve ran {chunks} matmul chunks for "
          f"{int(res.iters)} iterations")
    check(bool(torch.isfinite(res.x).all() & torch.isfinite(res.y).all()),
          "the S=1 f64 xhat re-solve is not finite")
    del full
    return {"S": 1, "A_shape": list(one.A.shape), "dtype": "float64",
            "iters": int(res.iters), "matmul_chunks": chunks,
            "s": time.time() - t}


def gap_loop(PH, opts, b):
    """The bench's farmer row on a fresh PH (bench.py:1322-1343): Iter0,
    then PH iterations with inner/outer bounds every 4 iterations (every
    2 below a 3% gap) until the gap is at most 1% or 200 iterations."""
    import torch
    ph = PH(dict(opts, PHIterLimit=200), [f"scen{i}" for i in range(S)],
            batch=b)
    torch.cuda.synchronize()
    t0 = time.time()
    outer = ph.Iter0()
    inner, gap, iters, checks = None, float("inf"), 0, 0
    while gap > 0.01 and iters < 200:
        ph.ph_iteration()
        iters += 1
        cadence = 2 if gap < 0.03 else 4
        if iters % cadence == 0 or ph.conv < 1e-4:
            inner, feas = ph.evaluate_xhat(ph.root_xbar())
            outer = max(outer, ph.lagrangian_bound())
            checks += 1
            if feas:
                gap = abs(inner - outer) / max(abs(inner), 1e-9)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(gap <= 0.01, f"gap loop ended at gap {gap} after {iters} iters")
    check(outer <= inner + 1e-6 * abs(inner), "outer above inner")
    return {"ph": ph, "wall_s": wall, "iters": iters, "bound_checks": checks,
            "gap": gap, "inner": inner, "outer": outer,
            "inner_iters": ph.pdhg_stats()["inner_iters"]}


def profile_window(ph, n=2):
    """Device time by kernel over `n` PH iterations under torch.profiler
    (the profiler's own host overhead inflates the window's wall time,
    so the idle share is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            ph.ph_iteration()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = {}
    # the profiler's raw events: parsing them into prof.events() takes
    # about a minute of host time for a PH iteration at true size
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            d = by_name.setdefault(e.name(), [0, 0.0])
            d[0] += 1
            d[1] += e.duration_ns() / 1e3
    busy = sum(v[1] for v in by_name.values())
    chunk = sum(v[1] for k, v in by_name.items() if "pdhg_chunk" in k)
    chunk_n = sum(v[0] for k, v in by_name.items() if "pdhg_chunk" in k)
    # the matmul route's matrix products (cuBLAS / CUTLASS GEMM kernels)
    gemm = sum(v[1] for k, v in by_name.items()
               if re.search(r"gemm|xmma|cutlass", k, re.I))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"ph_iterations": n, "wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1.0 - busy / wall_us) if busy else None,
            "chunk_kernel_us": chunk, "chunk_kernel_launches": chunk_n,
            "chunk_share_of_busy": (chunk / busy) if busy else None,
            "gemm_us": gemm,
            "gemm_share_of_busy": (gemm / busy) if busy else None,
            "other_share_of_busy": ((busy - gemm - chunk) / busy)
            if busy else None,
            "device_events": sum(v[0] for v in by_name.values()),
            "top": [{"name": k[:60], "count": v[0], "us": v[1]}
                    for k, v in top]}


def bf16x_phase():
    """This slice's own path: farmer S=1000, cm=10, f32 batch, the
    slice's options with A stored in bf16 in the hot loop."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    opts = dict(SLICE_OPTS, PHIterLimit=BF16X_PH_ITERS,
                pdhg_hot_dtype="bf16x")
    reset_counts()
    t0 = time.time()
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    ph = PH(opts, [f"scen{i}" for i in range(S)], batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup", "s": time.time() - t0}]

    def timed(step, fn):
        n0, t = pdhg_chunk.launches_by("dtype"), time.time()
        out = fn()
        torch.cuda.synchronize()
        n1 = pdhg_chunk.launches_by("dtype")
        steps.append({"step": step, "s": time.time() - t,
                      "launches": {k: n1[k] - n0.get(k, 0) for k in n1
                                   if n1[k] != n0.get(k, 0)}})
        return out

    trivial = timed("iter0", ph.Iter0)
    for k in range(BF16X_PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
    inner, feas = timed("evaluate_xhat", lambda: ph.evaluate_xhat(
        ph.root_xbar()))
    outer = timed("lagrangian_bound", ph.lagrangian_bound)
    by_dtype = pdhg_chunk.launches_by("dtype")
    check(all(np.isfinite([trivial, inner, outer])),
          f"bf16x bounds not finite: {trivial}, {inner}, {outer}")
    check(feas, "bf16x xhat candidate infeasible")
    check(max(trivial, outer) <= inner + 1e-6 * abs(inner),
          f"bf16x outer bound above inner: {max(trivial, outer)} > {inner}")
    check(by_dtype.get("bfloat16", 0) > 0, "the bf16x path launched no "
          "bf16 kernel")
    check(all(s["launches"].get("bfloat16", 0) > 0 for s in steps
              if s["step"].startswith("ph_iteration")),
          "a bf16x PH iteration did not run in bf16 storage")
    out = {"phase": "bf16x", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "hot_dtype": "bf16x",
           "ph_iterations": BF16X_PH_ITERS, "trivial_bound": trivial,
           "inner_bound": inner, "outer_bound": outer, "conv": ph.conv,
           "rel_gap": (inner - max(trivial, outer)) / abs(inner),
           "launches_by_dtype": by_dtype, "launch_shapes": launch_table(),
           "steps": steps, "pdhg_stats": ph.pdhg_stats()}
    emit(out)
    return out


def uc_ef_bound(b, names):
    """(bound, seconds): ef_dual_bound's consensus-EF LP solve at
    UC_EF_ITERS without its f64 certify: the dual objective of an LP
    with all-finite boxes bounds at any iterate.  The certify ran to
    its 100,000-iteration floor (~70 s on an NVIDIA H100 80GB HBM3 at
    700 W) until the soc, cross_scen, wheel_multiproc and checkpoint
    phases needed the time."""
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    t0 = time.time()
    ef = ExtensiveForm({"pdhg_eps": 1e-5, "pdhg_max_iters": UC_EF_ITERS},
                       names, batch=b)
    check(ef.is_lp and ef.all_bounds_finite,
          "the uc EF is not an LP with finite boxes: its uncertified dual "
          "objective would bound nothing")
    ef.solve_extensive_form(certify=False)
    return ef.get_dual_bound(), time.time() - t0


def uc_cuts():
    """The depth cuts of the uc phase against the bench's row."""
    cuts = {}
    for key, got, bench in (("S", UC_S, 1000),
                            ("ph_iterations", UC_PH_ITERS, 25),
                            ("max_sweeps", UC_SWEEPS, 8),
                            ("ef_max_iters", UC_EF_ITERS, 100000),
                            ("ef_f64_certify", False, True)):
        if got != bench:
            cuts[key] = {"bench": bench, "here": got}
    # the depths before the driver phase needed the time
    cuts["S"]["before the driver phase"] = 250
    cuts["S"]["before the corpus phase"] = 125
    cuts["S"]["before the algorithms phase"] = 64
    cuts["ph_iterations"]["before the driver phase"] = 10
    cuts["ph_iterations"]["before the corpus phase"] = 6
    cuts["ph_iterations"]["before the script ran over its limit"] = 5
    return cuts


def uc_phase():
    """bench.py's uc1000 protocol at full width (fleet_multiplier=7,
    H=24), depth as UC_S / UC_PH_ITERS / UC_SWEEPS: Iter0, PH iterations
    with a Lagrangian bound every 5, the 5 threshold commitments
    screened in one stacked solve, screened 1-opt sweeps
    (screen_eps=3e-3, screen_cap=2000), then the consensus-EF dual
    bound.  The shared operator is beyond the kernel's tile, so the
    per-scenario solves take the matmul route; the EF bound takes the
    consensus route and must launch no kernel."""
    import torch

    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    from mpisppy_tpu_torch.opt.ph import PH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                    # count this path's run only
    t0 = time.time()
    b = uc.build_batch(UC_S, **UC_FULL, dtype=np.float32)
    check(b.shared_A and tuple(b.A.shape) == UC_FULL_SHAPE,
          f"UC at full width is {tuple(b.A.shape)}")
    names = uc.scenario_names_creator(UC_S)
    ph = PH(dict(UC_OPTS, PHIterLimit=UC_PH_ITERS), names, batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup (build + prep)", "s": time.time() - t0}]
    emit({"phase": "uc_step", **steps[-1]})

    def timed(step, fn):
        k0, m0, c0 = (pdhg_chunk.launches, pdhg.matmul_chunks,
                      pdhg.consensus_chunks)
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        steps.append({"step": step, "s": time.time() - t,
                      "matmul_chunks": pdhg.matmul_chunks - m0,
                      "consensus_chunks": pdhg.consensus_chunks - c0,
                      "kernel_launches": pdhg_chunk.launches - k0})
        emit({"phase": "uc_step", **steps[-1]})
        return out

    outer = timed("iter0", ph.Iter0)
    for k in range(UC_PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
        if (k + 1) % 5 == 0:
            # valid at any dual iterate (all-finite boxes), not
            # monotone along the W path: keep the best
            outer = max(outer, timed(f"lagrangian_{k + 1}",
                                     ph.lagrangian_bound))
    if UC_PH_ITERS % 5:
        outer = max(outer, timed("lagrangian_final", ph.lagrangian_bound))
    cands = uc.commitment_candidates(b, ph.root_xbar())
    objs, feas, mass = timed("candidate_screen", lambda: (
        ph.evaluate_candidates(cands, return_mass=True)))
    ok = np.flatnonzero(feas)
    check(ok.size > 0, f"no feasible threshold commitment (mass {mass})")
    best = cands[int(ok[np.argmin(objs[ok])])]
    # each stacked screen launch and each certifying xhat solve of the
    # sweeps, timed
    calls = []

    def clocked(kind, fn):
        def run(*a, **kw):
            t = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            calls.append({"kind": kind, "s": time.time() - t,
                          "k": len(a[0]) if kind == "screen" else 1})
            return out
        return run

    ph.evaluate_candidates = clocked("screen", ph.evaluate_candidates)
    ph.evaluate_xhat = clocked("verify", ph.evaluate_xhat)
    best, inner = timed("one_opt_sweeps", lambda: uc.one_opt_commitment(
        ph, b, best, max_sweeps=UC_SWEEPS, screen_eps=3e-3,
        screen_cap=2000))
    del ph.evaluate_candidates, ph.evaluate_xhat
    check(np.isfinite(inner), "the 1-opt search lost its feasible "
          "incumbent")
    wall = time.time() - t0
    k0 = pdhg_chunk.launches
    ef_b, ef_s = timed("ef_dual_bound", lambda: uc_ef_bound(b, names))
    ef_step = steps[-1]
    check(pdhg_chunk.launches == k0, "the consensus EF solve launched "
          "the chunk kernel")
    check(ef_step["consensus_chunks"] > 0, "the EF bound ran no consensus "
          "chunk")
    check(np.isfinite(ef_b), f"EF dual bound {ef_b}")
    outer_all = max(outer, ef_b)
    check(outer_all <= inner + 1e-6 * abs(inner),
          f"uc outer bound above inner: {outer_all} > {inner}")
    peak_mem = torch.cuda.max_memory_allocated()
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    screens = [c for c in calls if c["kind"] == "screen"]
    verifies = [c for c in calls if c["kind"] == "verify"]
    out = {"phase": "uc", "S": UC_S, **UC_FULL, "units": 3 * UC_FULL[
               "fleet_multiplier"], "M": b.num_rows, "N": b.num_vars,
           "dtype": "float32", "shared_A": True,
           "cuts": uc_cuts(), "ph_iterations": UC_PH_ITERS,
           "max_sweeps": UC_SWEEPS,
           "inner": inner, "outer_ph": outer, "ef_dual_bound": ef_b,
           "outer": outer_all,
           "gap": (inner - outer_all) / max(abs(inner), 1e-9),
           "threshold_objs": objs.tolist(), "threshold_feas_mass":
           mass.tolist(), "iter0_feas_mass": ph.iter0_feas_mass,
           "wall_s_to_recovered_commitment": wall, "ef_bound_s": ef_s,
           "steps": steps,
           "sweep_screen_launches": len(screens),
           "sweep_screen_s": [c["s"] for c in screens],
           "sweep_verify_calls": len(verifies),
           "sweep_verify_s": [c["s"] for c in verifies],
           "matmul_chunks": pdhg.matmul_chunks,
           "consensus_chunks": pdhg.consensus_chunks,
           "kernel_launches": pdhg_chunk.launches,
           "kernel_launches_in_consensus_solves": 0,
           "max_memory_allocated": peak_mem,
           "pdhg_stats": ph.pdhg_stats(), "solve_stats": ph.solve_stats()}
    # one consensus-route chunk alone at this shape (after the counts
    # above were read)
    out["consensus_route"] = consensus_step_timing(
        ExtensiveForm({"pdhg_eps": 1e-5}, names, batch=b), b)
    out.update(phase_timing(ph))
    emit(out)
    return out


def uc_fallback_pass():
    """UC at the bench's fallback size (fleet_multiplier=2, H=6,
    S=UC_FALLBACK_S) with the uc row's options: Iter0 and 2 PH
    iterations, which must launch the kernel's shared form at
    (1, 174, 114) (A staged in shared memory)."""
    import torch

    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    b = uc.build_batch(UC_FALLBACK_S, **UC_FALLBACK, dtype=np.float32)
    ph = PH(dict(UC_OPTS, PHIterLimit=2),
            uc.scenario_names_creator(UC_FALLBACK_S), batch=b)
    reset_counts()                    # count this path's run only
    t0 = time.time()
    trivial = ph.Iter0()
    for _ in range(2):
        ph.ph_iteration()
    torch.cuda.synchronize()
    wall = time.time() - t0
    key = ("shared", UC_FALLBACK_S, 174, 114, "float32")
    launched = pdhg_chunk.launch_shapes.get(key, 0)
    check(launched > 0, f"the UC fallback pass never launched {key}: "
          f"{launch_table()}")
    variants = launch_variants()
    through = sum(r["launches"] for r in variants
                  if (r["form"], r["S"], r["M"], r["N"], r["dtype"]) == key
                  and r["variant"] in ("resident", "streamed"))
    check(through == launched, f"the UC fallback pass launched {key} "
          f"{launched} times, {through} through the cluster kernel")
    out = {"phase": "uc_fallback", "S": UC_FALLBACK_S, **UC_FALLBACK,
           "dtype": "float32", "wall_s": wall, "trivial_bound": trivial,
           "conv": ph.conv, "iter0_feas_mass": ph.iter0_feas_mass,
           "launch_shapes": launch_table(), "launch_variants": variants,
           "shared_174x114_launches": launched,
           "cluster_launches": through}
    emit(out)
    return out


def ef_lp_oracle(b, integer=False):
    """The LP optimum of the batch's extensive form by HiGHS
    (scipy.optimize.linprog), assembled from the batch's arrays in
    float64: one column per (tree node, nonant slot), shared by the
    scenarios through that node (`tree.node_of`; a two-stage batch has
    one node, so one copy of the nonant columns for all scenarios), each
    scenario's other columns its own, the objective weighted by the
    scenario probabilities.  A plain reference, independent of the PDHG
    solver.  integer=True: the EF MILP's optimum instead (HiGHS
    branch-and-cut through scipy.optimize.milp, the batch's
    integer_mask).  Returns (objective, number of EF columns)."""
    import scipy.sparse as sp
    from scipy.optimize import Bounds, LinearConstraint, linprog, milp

    def host(t):
        return t.detach().cpu().double().numpy()

    A, c, lb, ub = host(b.A), host(b.c), host(b.lb), host(b.ub)
    rlo, rhi, prob = host(b.row_lo), host(b.row_hi), host(b.prob)
    S, M, N = A.shape
    na = b.nonant_idx.cpu().numpy()
    node_of = b.tree.node_of.cpu().numpy()
    rest = np.setdiff1d(np.arange(N), na)
    K, R = na.size, rest.size
    # the shared columns: one per (node, slot) pair that occurs
    pairs = {}
    for s in range(S):
        for j in range(K):
            pairs.setdefault((int(node_of[s, j]), j), len(pairs))
    P = len(pairs)
    col = np.array([[pairs[(int(node_of[s, j]), j)] for j in range(K)]
                    for s in range(S)])
    cost = np.zeros(P + S * R)
    lo_sh, hi_sh = np.full(P, -np.inf), np.full(P, np.inf)
    blocks = []
    for s in range(S):
        sel = sp.csr_matrix((np.ones(K), (np.arange(K), col[s])),
                            shape=(K, P))
        row = [sp.csr_matrix(A[s][:, na]) @ sel] + [None] * S
        row[1 + s] = sp.csr_matrix(A[s][:, rest])
        blocks.append(row)
        np.add.at(cost, col[s], prob[s] * c[s, na])
        cost[P + s * R:P + (s + 1) * R] = prob[s] * c[s, rest]
        np.maximum.at(lo_sh, col[s], lb[s, na])
        np.minimum.at(hi_sh, col[s], ub[s, na])
    big = sp.bmat(blocks, format="csr")
    lo, hi = rlo.reshape(-1), rhi.reshape(-1)
    eq = lo == hi
    up = ~eq & np.isfinite(hi)
    dn = ~eq & np.isfinite(lo)
    A_ub = sp.vstack([big[up], -big[dn]], format="csr")
    b_ub = np.concatenate([hi[up], -lo[dn]])
    bounds = (list(zip(lo_sh.tolist(), hi_sh.tolist()))
              + [(float(lb[s, j]), float(ub[s, j]))
                 for s in range(S) for j in rest])
    if integer:
        im = b.integer_mask.cpu().numpy()
        integ = np.zeros(P + S * R)
        for s in range(S):
            integ[col[s]] = np.maximum(integ[col[s]], im[s, na])
            integ[P + s * R:P + (s + 1) * R] = im[s, rest]
        cons = [LinearConstraint(big[~eq], lo[~eq], hi[~eq]),
                LinearConstraint(big[eq], lo[eq], hi[eq])]
        res = milp(cost, constraints=cons, integrality=integ,
                   bounds=Bounds(*map(np.array, zip(*bounds))),
                   options={"mip_rel_gap": 1e-6})
    else:
        res = linprog(cost, A_ub=A_ub, b_ub=b_ub, A_eq=big[eq],
                      b_eq=lo[eq], bounds=bounds, method="highs")
    check(res.status == 0, f"HiGHS failed on the EF: {res.message}")
    return float(res.fun) + float(np.sum(prob * host(b.obj_const))), P + S * R


def sslp_phase():
    """bench.py's sslp50 row: SIPLIB sslp_5_25 at S=50, f32, one
    consensus EF solve (pdhg_eps=1e-5, pdhg_max_iters=200000), then the
    f64 certify; the objective against HiGHS on the same EF LP."""
    import torch

    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    b = sslp.build_batch(SSLP_S, instance="sslp_5_25", dtype=np.float32)
    ef = ExtensiveForm(dict(SSLP_OPTS), sslp.scenario_names_creator(SSLP_S),
                       batch=b)
    torch.cuda.synchronize()
    reset_counts()                    # count this path's run only
    t0 = time.time()
    res = ef.solve_extensive_form()
    torch.cuda.synchronize()
    wall = time.time() - t0
    obj, dual = ef.get_objective_value(), ef.get_dual_bound()
    gap = abs(obj - dual) / max(abs(obj), 1e-9)
    t = time.time()
    lp, n_vars = ef_lp_oracle(b)
    oracle_s = time.time() - t
    rel = abs(obj - lp) / max(abs(lp), 1e-9)
    check(pdhg_chunk.launches == 0, "the sslp EF solve launched the "
          "chunk kernel")
    check(pdhg.consensus_chunks > 0, "the sslp EF ran no consensus chunk")
    check(gap <= 0.01, f"sslp EF gap {gap} above 1%")
    check(rel <= 1e-4, f"sslp EF objective {obj} is {rel:.2e} from the "
          f"HiGHS optimum {lp}")
    x_na = b.nonants(res.x)
    counts = (pdhg.consensus_chunks, pdhg.matmul_chunks,
              pdhg_chunk.launches)
    route = consensus_step_timing(ef, b)
    out = {"phase": "sslp", "S": SSLP_S, "instance": "sslp_5_25",
           "dtype": "float32", "options": SSLP_OPTS, "wall_s": wall,
           "objective": obj, "dual_bound": dual, "gap": gap,
           "converged": bool(res.converged.all()), "iters": res.iters,
           "root_solution": ef.get_root_solution().tolist(),
           "nonant_spread": float((x_na - x_na[0]).abs().max()),
           "highs_objective": lp, "rel_to_highs": rel,
           "highs_ef_vars": n_vars, "highs_s": oracle_s,
           "consensus_chunks": counts[0], "matmul_chunks": counts[1],
           "kernel_launches": counts[2], "consensus_route": route,
           "solve_stats": ef.solve_stats()}
    emit(out)
    return out


def consensus_step_timing(ef, b):
    """One consensus-route chunk (`ops/pdhg.py::consensus_chunk`, torch
    ops) alone, on the solver-space data of the EF's prep: ms a step
    against the bound of the same work (A once, the vectors in and out,
    40 steps of two matvecs and the elementwise updates at the FP32
    peak).  Not a kernel: no single PyTorch call computes it either."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.utils.mfu import cuda_peaks
    _, (bw, f32_peak, _) = cuda_peaks(torch.cuda.get_device_name(0))
    p, prob = ef.prep, b.prob[:, None]
    dc = p.d_col
    vec = [b.c * prob * dc, b.qdiag * prob * dc * dc,
           torch.where(torch.isfinite(b.lb), b.lb / dc, b.lb),
           torch.where(torch.isfinite(b.ub), b.ub / dc, b.ub),
           p.row_lo, p.row_hi]
    cons = pdhg._Consensus(ef.consensus, vec[0])
    anorm, qmax = cons.norm_and_qmax(p.A, vec[1])
    x, y = torch.zeros_like(b.c), torch.zeros_like(p.row_lo)
    tau, sigma = 0.9 / (anorm + 0.9 * qmax), 0.9 / anorm
    chunk_ms = time_ms(lambda: pdhg.consensus_chunk(
        p.A, *vec, x, y, tau, sigma, N_STEPS, cons.csum), reps=3, batch=5,
        warmup=1)
    S_, (_, M, N) = vec[0].shape[0], p.A.shape
    nbytes = chunk_bytes(p.A, vec + [x, y, tau, sigma])
    flops = N_STEPS * S_ * (4 * M * N + 10 * N + 8 * M)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
    bound = max(t_bytes, t_ops)
    return {"S": S_, "M": M, "N": N, "A_shape": list(p.A.shape),
            "dtype": str(p.A.dtype).replace("torch.", ""),
            "chunk_ms": chunk_ms, "step_ms": chunk_ms / N_STEPS,
            "chunk_bound_ms": bound, "step_bound_ms": bound / N_STEPS,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / chunk_ms, "library_ms": None}


def _counting(cls):
    """`cls` counting its steps that did work (for the xhat spoke: an
    evaluation, on fresh or on stale nonants), those of them that read
    fresh hub data (the spoke's last_hub_id advanced), and their wall
    (the threads run them concurrently)."""
    class Counting(cls):
        steps_done = 0
        fresh_steps = 0
        step_s = 0.0

        def step(self):
            t = time.time()
            seen = self.last_hub_id
            did = super().step()
            if did:
                self.steps_done += 1
                self.fresh_steps += int(self.last_hub_id > seen)
                self.step_s += time.time() - t
            return did

    Counting.__name__ = cls.__name__
    return Counting


def spin_wheel(hub_dict, spoke_dicts, mode):
    """Spin one wheel with the counts zeroed just before; what it did:
    bounds, supersteps, steps per spoke, launches by form and dtype,
    float64 certify re-solves, rejects, peak memory."""
    import threading

    import torch

    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.spopt import SPOpt
    for d in spoke_dicts:
        d["spoke_class"] = _counting(d["spoke_class"])
    certifies, lock = [0], threading.Lock()
    resolve = SPOpt._certified_resolve

    def counted_resolve(self, res, *a, **kw):
        out = resolve(self, res, *a, **kw)
        if out is not res:             # stragglers were re-solved
            with lock:
                certifies[0] += 1
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak counts it too
    mem0 = torch.cuda.memory_allocated()
    SPOpt._certified_resolve = counted_resolve
    try:
        reset_counts()                 # count this wheel's run only
        t0 = time.time()
        ws = WheelSpinner(hub_dict, spoke_dicts, mode=mode).spin()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        SPOpt._certified_resolve = resolve
    hub = ws.spcomm
    alive = [t.name for t in threading.enumerate()
             if "guarded_main" in t.name]
    check(not alive, f"spoke threads still alive after the spin: {alive}")
    check(hub.failed_spokes == [], f"spokes failed: {hub.failed_spokes}")
    check(hub.finalize_failures == [],
          f"spoke final passes failed: {hub.finalize_failures}")
    outer, inner = float(ws.BestOuterBound), float(ws.BestInnerBound)
    check(np.isfinite(outer) and np.isfinite(inner),
          f"wheel bounds not finite: outer {outer}, inner {inner}")
    check(outer <= inner, f"wheel outer bound {outer} above inner {inner}")
    for sp in hub.spokes:
        for f, v in vars(sp.opt.batch).items():
            if torch.is_tensor(v):
                check(v.device.type == "cuda",
                      f"{type(sp).__name__} batch.{f} is on {v.device}")
    supersteps = hub.current_iteration()
    gap = abs(inner - outer) / max(1.0, abs(inner))   # bench.py:1155
    rel_gap = hub.options["rel_gap"]
    return ws, {
        "mode": mode, "exchange_backend": ws.exchange_backend_used,
        "wall_s": wall, "certified": gap <= rel_gap,
        "value": wall if gap <= rel_gap else -1,
        "supersteps": supersteps, "s_per_superstep": wall / supersteps,
        "steps_per_spoke": {type(sp).__name__: sp.steps_done
                            for sp in hub.spokes},
        "fresh_steps_per_spoke": {type(sp).__name__: sp.fresh_steps
                                  for sp in hub.spokes},
        "spoke_step_s": {type(sp).__name__: sp.step_s
                         for sp in hub.spokes},
        "best_outer": outer, "best_inner": inner, "rel_gap": gap,
        "rel_gap_target": rel_gap,
        "bound_rejects": {type(sp).__name__: int(n) for sp, n in
                          zip(hub.spokes, hub.bound_rejects)},
        "corrupt_reads": int(hub.corrupt_reads.sum()),
        "launches_by_form_dtype": pdhg_chunk.launches_by("form/dtype"),
        "launches_by_form": pdhg_chunk.launches_by("form"),
        "launch_shapes": launch_table(),
        "matmul_chunks": pdhg.matmul_chunks,
        "consensus_chunks": pdhg.consensus_chunks,
        "f64_certifies": certifies[0],
        "certify_s": {name: o._certify_wall for name, o in
                      [("hub", hub.opt)] + [(type(sp).__name__, sp.opt)
                                            for sp in hub.spokes]},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start": mem0,
        "peak_memory_of_the_wheel":
            torch.cuda.max_memory_allocated() - mem0}


def wheel_row_dicts(names, batch, opts):
    """bench.py's wheel_mpmd row: PH hub, Lagrangian and XhatShuffle
    spokes, every optimizer with `opts`."""
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
        LagrangianOuterBound)
    from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
        XhatShuffleInnerBound)
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
    hub_dict = {"hub_class": PHHub,
                "hub_kwargs": {"options": dict(WHEEL_HUB_OPTS)},
                "opt_class": PH,
                "opt_kwargs": {"options": dict(opts),
                               "all_scenario_names": names,
                               "batch": batch}}
    spoke_dicts = [
        {"spoke_class": LagrangianOuterBound,
         "spoke_kwargs": {"options": {}}, "opt_class": PH,
         "opt_kwargs": {"options": dict(opts),
                        "all_scenario_names": names}},
        {"spoke_class": XhatShuffleInnerBound,
         "spoke_kwargs": {"options": {}}, "opt_class": Xhat_Eval,
         "opt_kwargs": {"options": dict(opts),
                        "all_scenario_names": names}}]
    return hub_dict, spoke_dicts


def wheel_row_telemetry(names, batch, off_row, opt):
    """The wheel_mpmd row as bench.py writes it: every optimizer with
    its "telemetry": True, here with a dir for trace.json and
    metrics.jsonl (phase timing on, the default: the hub runs the phased
    superstep).  Its counters, its wall beside the telemetry-off row's,
    and the spans per trace row."""
    from mpisppy_tpu_torch import telemetry
    d = WHEEL_TELEMETRY_DIR
    shutil.rmtree(d, ignore_errors=True)
    telemetry.reset()
    opts = dict(WHEEL_OPTS, PHIterLimit=WHEEL_TELEMETRY_ITERS,
                telemetry={"enabled": True, "dir": d})
    try:
        ws, row = spin_wheel(*wheel_row_dicts(names, batch, opts),
                             "threads")
        wheel = telemetry.wheel_counters()
        traffic = telemetry.traffic_counters()
        hub = ws.spcomm
        check(hub.telemetry.enabled and hub.telemetry.out_dir == d,
              "the wheel's telemetry is not the row's")
    finally:
        telemetry.reset()
    tol = 1e-5 * abs(opt)
    check(row["best_outer"] <= opt + tol and row["best_inner"] >= opt - tol,
          f"telemetry wheel bounds [{row['best_outer']}, "
          f"{row['best_inner']}] do not bracket {opt}")
    with open(os.path.join(d, "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        snap = json.loads(f.read().strip().splitlines()[-1])
    rows = {e["pid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    labels = sorted(rows.values())
    check(len(labels) == 3 and "hub" in labels
          and sum(lb.startswith("spoke0:") for lb in labels) == 1
          and sum(lb.startswith("spoke1:") for lb in labels) == 1,
          f"trace rows {labels}")
    spans = {}
    for e in evs:
        if e["ph"] == "X":
            key = f"{rows.get(e['pid'], e['pid'])}/{e['name']}"
            spans[key] = spans.get(key, 0) + 1
    c = snap["counters"]
    check(c.get("window.reads", 0) > 0 and c.get("window.writes", 0) > 0,
          f"window traffic {c}")
    check(c.get("wheel.corrupt_reads", 0) == 0,
          f"{c.get('wheel.corrupt_reads')} corrupt reads")
    rejects = int(sum(row["bound_rejects"].values()))
    check(c.get("window.bound_rejects", 0) == rejects
          == traffic["window_bound_rejects"],
          f"bound rejects: registry {c.get('window.bound_rejects', 0)}, "
          f"hub {rejects}")
    hists = snap["histograms"]
    return {"phase": "wheel_row_telemetry", "S": WHEEL_S,
            "crops_multiplier": 1, "dtype": "float32",
            "options": opts, "hub_options": WHEEL_HUB_OPTS,
            **row, "telemetry_dir": d,
            "cuts": {"PHIterLimit": {"wheel_row": WHEEL_OPTS["PHIterLimit"],
                                     "here": WHEEL_TELEMETRY_ITERS}},
            "wall_s_telemetry_off": off_row["wall_s"],
            "s_per_superstep_telemetry_off": off_row["s_per_superstep"],
            "s_per_superstep_ratio_on_over_off":
                row["s_per_superstep"] / off_row["s_per_superstep"],
            "wheel_counters": wheel, "traffic_counters": traffic,
            "trace_rows": labels, "spans_per_row_and_name": spans,
            "trace_events": len(evs),
            "phase_seconds_mean": {
                k: hists.get(f"ph.phase.{k}_seconds", {}).get("mean")
                for k in ("solve", "psum", "w_update", "conv")},
            "superstep_phases_timed": hists.get(
                "ph.phase.solve_seconds", {}).get("count", 0)}


def wheel_phase():
    """The hub-and-spoke wheel on the card, three runs.

    (a) `wheel_row`: bench.py's wheel_mpmd protocol on one device,
        threads mode over the host seqlock: farmer S=100, cm=1, f32, PH
        hub + Lagrangian + XhatShuffle, telemetry off.  Its bounds must
        bracket the farmer-100 optimum, computed on the card by the
        port's ExtensiveForm in f64 through the amalgamator's --EF (the
        driver phase's `driver_ef`), and by HiGHS on the host as a
        check.
    (a') `wheel_row_telemetry`: the same row with its own telemetry
        option, as the bench writes it (wheel_row_telemetry).
    (b) `wheel_split`: farmer S=1000, cm=10, f32 built through the
        port's config and vanilla as examples/farmer_cylinders.py does,
        interleaved, with the split phase's options: the split and
        shared forms of the kernel must both launch during the spin."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.utils import config, vanilla

    # (a) the bench's row, telemetry off
    names = farmer.scenario_names_creator(WHEEL_S)
    batch = farmer.build_batch(WHEEL_S, dtype=np.float32)
    ws, row = spin_wheel(*wheel_row_dicts(names, batch, WHEEL_OPTS),
                         "threads")
    # the farmer-100 optimum in f64 on the card: --EF through the
    # port's amalgamator (the driver phase's EF run, reported there)
    highs, _ = ef_lp_oracle(farmer.build_batch(WHEEL_S))
    ef_line, ef = driver_ef(highs)
    ef_res, ef_s = ef.ef._result, ef_line["wall_s"]
    opt = ef.EF_Obj
    tol = 1e-5 * abs(opt)
    check(row["best_outer"] <= opt + tol and row["best_inner"] >= opt - tol,
          f"wheel bounds [{row['best_outer']}, {row['best_inner']}] do "
          f"not bracket the farmer-{WHEEL_S} optimum {opt}")
    out_a = {"phase": "wheel_row", "S": WHEEL_S, "crops_multiplier": 1,
             "dtype": "float32", "options": WHEEL_OPTS,
             "hub_options": WHEEL_HUB_OPTS,
             "cuts": {"telemetry": {"bench": True, "here": False,
                                    "why": "measured with it on in "
                                           "wheel_row_telemetry"}},
             **row, "ef_optimum_f64": opt, "ef_s": ef_s,
             "ef_iters": int(ef_res.iters),
             "ef_converged": bool(ef_res.converged.all()),
             "highs_optimum": highs,
             "bracket_tol_rel": 1e-5}
    emit(out_a)
    out_a["driver_ef"] = ef_line
    del ws, ef
    # (a') the same row with its own telemetry option
    out_t = wheel_row_telemetry(names, batch, row, opt)
    emit(out_t)

    # (b) through config and vanilla, split prep
    cfg = config.Config()
    for group in ("popular_args", "ph_args", "two_sided_args",
                  "lagrangian_args", "xhatshuffle_args"):
        getattr(cfg, group)()
    farmer.inparser_adder(cfg)
    cfg.parse_command_line("farmer_cylinders", args=WHEEL_SPLIT_ARGV)
    names = farmer.scenario_names_creator(cfg.num_scens)
    batch = farmer.batch_creator(
        dict(farmer.kw_creator(cfg), dtype=np.float32), cfg.num_scens)
    hub_dict = vanilla.ph_hub(cfg, farmer.scenario_creator, None, names,
                              batch=batch)
    spoke_dicts = vanilla.build_spokes(cfg, farmer.scenario_creator, None,
                                       names, batch=batch)
    for d in [hub_dict] + spoke_dicts:
        d["opt_kwargs"]["options"].update(
            SPLIT_OPTS, PHIterLimit=WHEEL_SPLIT_PH_ITERS)
    ws, row = spin_wheel(hub_dict, spoke_dicts, "interleaved")
    by_form = row["launches_by_form"]
    check(by_form.get("split", 0) > 0, "the split form never launched in "
          "the wheel")
    check(by_form.get("shared", 0) > 0, "the shared form never launched "
          "in the wheel")
    check(row["matmul_chunks"] == 0, f"{row['matmul_chunks']} chunks took "
          "the matmul route at cm=10")
    out_b = {"phase": "wheel_split", "S": cfg.num_scens,
             "crops_multiplier": cfg.crops_multiplier, "dtype": "float32",
             "argv": WHEEL_SPLIT_ARGV,
             "options": dict(SPLIT_OPTS, PHIterLimit=WHEEL_SPLIT_PH_ITERS),
             "cuts": {"PHIterLimit": {"command line": cfg.max_iterations,
                                      "here": WHEEL_SPLIT_PH_ITERS,
                                      "before the driver phase": 20,
                                      "before the corpus phase": 8,
                                      "before the script ran over its "
                                      "limit": 5,
                                      "before the soc, cross_scen, "
                                      "wheel_multiproc and checkpoint "
                                      "phases": 3}},
             "s_per_superstep_before_the_cut": "5.48 (PHIterLimit 20)",
             **row}
    emit(out_b)
    return out_a, out_b


def _driver_cfg(config, options=None):
    """A Config with examples/_driver.py's flag groups; `options`, when
    given, are laid over its options_dict() (the solver options the
    split cell uses and no flag carries)."""
    class DriverConfig(config.Config):
        def options_dict(self):
            return dict(super().options_dict(), **(options or {}))

    cfg = DriverConfig()
    for group in DRIVER_CFG_GROUPS:
        getattr(cfg, group)()
    return cfg


def _hook_recorder():
    """MultiExtension's fan-out, counted and timed: calls and seconds
    per (extension class, hook), in the fan-out's order; and at each
    pre_solve_loop, the nonant slots the coming superstep receives
    pinned (lb_eff == ub_eff).  Returns (install, restore, rec)."""
    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.extensions import MultiExtension
    fan = MultiExtension._fan
    rec = {"calls": {}, "seconds": {}, "pinned": None}

    def timed_fan(self, hook):
        if hook == "pre_solve_loop":
            opt = self.opt
            na = host(opt.batch.nonant_idx)
            rec["pinned"] = host(opt.lb_eff)[:, na] == host(opt.ub_eff)[:, na]
        for ext in self.extensions:
            key = f"{type(ext).__name__}.{hook}"
            t = time.time()
            getattr(ext, hook)()
            rec["seconds"][key] = rec["seconds"].get(key, 0.0) + (
                time.time() - t)
            rec["calls"][key] = rec["calls"].get(key, 0) + 1

    def install():
        MultiExtension._fan = timed_fan

    def restore():
        MultiExtension._fan = fan

    return install, restore, rec


def _norm_rho_checker():
    """NormRhoUpdater.miditer held to the update rule, recomputed here
    from host copies of the state: per slot, rho multiplied by `step`
    where the prob-weighted primal residual exceeds `ratio` x the dual
    one, divided where the dual one exceeds `ratio` x the primal, else
    unchanged.  Returns (install, restore, log)."""
    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.extensions.norm_rho_updater import NormRhoUpdater
    miditer = NormRhoUpdater.miditer
    log = []

    def checked(self):
        st = self.opt.state
        prev = None if self._xbar_prev is None else self._xbar_prev.copy()
        rho0 = host(self.opt.rho).copy()
        miditer(self)
        rho1 = host(self.opt.rho)
        if prev is None:
            factor = np.ones(rho0.shape[1])
        else:
            b = self.opt.batch
            p = host(b.prob)[:, None].astype(np.float64)
            x_na = host(b.nonants(st.x)).astype(np.float64)
            xbar = host(st.xbar).astype(np.float64)
            prim = np.sum(p * np.abs(x_na - xbar), axis=0)
            dual = np.mean(rho0.astype(np.float64), axis=0) * np.sum(
                p * np.abs(xbar - prev), axis=0)
            factor = np.where(prim > self.ratio * dual, self.step,
                              np.where(dual > self.ratio * prim,
                                       1.0 / self.step, 1.0))
        want = rho0 * factor[None, :]
        check(np.array_equal(rho1 != rho0,
                             np.broadcast_to(factor != 1.0, rho0.shape))
              and np.allclose(rho1, want, rtol=1e-6, atol=0.0),
              f"NormRhoUpdater at iteration {int(st.it)}: rho changed "
              f"where the rule did not say so")
        log.append({"it": int(st.it), "up": int(np.sum(factor > 1.0)),
                    "down": int(np.sum(factor < 1.0)),
                    "rho_mean": float(rho1.mean())})

    def install():
        NormRhoUpdater.miditer = checked

    def restore():
        NormRhoUpdater.miditer = miditer

    return install, restore, log


def _check_hook_counts(calls, classes, n):
    """Each extension's hooks fired as PH's loop calls them: once for
    pre_iter0, post_iter0 and post_everything, once per iteration for
    the solve-loop pair, miditer and enditer, once per iteration not
    ended by a stop for enditer_after_sync, and post_iter0_after_sync
    never (PH calls it from no loop)."""
    want = {"pre_iter0": {1}, "post_iter0": {1}, "post_everything": {1},
            "pre_solve_loop": {n}, "post_solve_loop": {n}, "miditer": {n},
            "enditer": {n}, "enditer_after_sync": {n - 1, n},
            "post_iter0_after_sync": {0}}
    for cls in classes:
        for hook, ok in want.items():
            got = calls.get(f"{cls}.{hook}", 0)
            check(got in ok, f"{cls}.{hook} fired {got} times in {n} PH "
                  f"iterations (want {sorted(ok)})")
    after = {calls.get(f"{cls}.enditer_after_sync", 0) for cls in classes}
    check(len(after) == 1, f"enditer_after_sync counts differ: {after}")


def driver_phase(wheel_row, wheel_split):
    """The driver layer on the card, three runs.

    (a) cylinders: examples/farmer_cylinders.py's command line with its
        extension flags (DRIVER_ARGV) through the port's
        amalgamator.from_module(farmer, ...), at the split cell's size
        (S=1000, cm=10, f32, integer farmer, the split phase's solver
        options), PHIterLimit cut to DRIVER_PH_ITERS.  Both bounds
        finite with outer <= inner; every extension's hooks fired as
        the loop calls them; every slot pinned before the last
        superstep holds its pinned value in state.x; rho changed where
        NormRhoUpdater's rule says; the split and shared forms
        launched.  Seconds per superstep beside wheel_split's, and the
        seconds each extension's hooks took per iteration.
    (b) hub only: PH on the same batch and prep for DRIVER_HUB_ITERS
        iterations with MultiExtension [XhatClosest, Gapper,
        MultRhoUpdater]: the in-hub xhat's inner bound finite (a
        feasible candidate) and above the trivial bound, solver_eps at
        every iteration on the Gapper's schedule (rounded to f32), the
        shared form's launches from the in-hub xhat.
    (d) the Fixer pinning on integer farmer-3 (driver_fixer).
    (c) --EF through the amalgamator on the wheel_row batch (farmer
        S=100, cm=1, f64), run and checked by driver_ef at the start of
        the wheel phase, whose bracket it supplies: its line, from
        `wheel_row["driver_ef"]`, is emitted here."""
    import torch

    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.extensions import Extension, MultiExtension
    from mpisppy_tpu_torch.extensions.mipgapper import Gapper
    from mpisppy_tpu_torch.extensions.mult_rho_updater import MultRhoUpdater
    from mpisppy_tpu_torch.extensions.xhatter import XhatClosest
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.utils import amalgamator, config

    # (a) cylinders through the amalgamator
    opts = dict(SPLIT_OPTS, PHIterLimit=DRIVER_PH_ITERS)
    cfg = _driver_cfg(config, opts)
    rows = {}

    class CountedSpinner:
        """amalgamator's WheelSpinner, spun by spin_wheel (counts zeroed
        just before, bounds and threads checked)."""
        def __init__(self, hub_dict, spoke_dicts):
            self.dicts = (hub_dict, spoke_dicts)

        def spin(self):
            ws, rows["wheel"] = spin_wheel(*self.dicts, "interleaved")
            return ws

    hooks_on, hooks_off, rec = _hook_recorder()
    nr_on, nr_off, nr_log = _norm_rho_checker()
    spinner = amalgamator.WheelSpinner
    amalgamator.WheelSpinner = CountedSpinner
    hooks_on()
    nr_on()
    try:
        t0 = time.time()
        ama = amalgamator.from_module(farmer, cfg, args=DRIVER_ARGV,
                                      progname="farmer_cylinders",
                                      batch_kwargs={"dtype": np.float32})
        ama.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        amalgamator.WheelSpinner = spinner
        hooks_off()
        nr_off()
    row = rows["wheel"]
    hub = ama.wheel.spcomm
    opt = hub.opt
    n = hub.current_iteration()
    exts = [type(e).__name__ for e in opt.extobject.extensions]
    check(exts == ["Fixer", "NormRhoUpdater", "Wtracker_extension"],
          f"the hub's extensions are {exts}")
    check(type(opt.convobject).__name__ == "PrimalDualConverger",
          f"the hub's converger is {opt.convobject}")
    # polled after the hub's sync: not in an iteration the hub ended
    check(len(opt.convobject.history) in (n - 1, n),
          f"the converger was polled {len(opt.convobject.history)} times "
          f"in {n} PH iterations")
    check(opt.batch.c.dtype == torch.float32 and bool(
        opt.batch.integer_mask.any()), "not the f32 integer farmer batch")
    _check_hook_counts(rec["calls"], exts, n)
    fixed = opt.count_fixed()
    pinned = rec["pinned"]
    na = host(opt.batch.nonant_idx)
    lb = host(opt.lb_eff)[:, na]
    x_na = host(opt.state.x)[:, na]
    # at this size the Fixer's default tolerance (a cross-scenario
    # variance under 1e-2) pins nothing within a few PH iterations;
    # whatever it pinned before the last superstep must hold its value,
    # and driver_fixer below pins slots for certain
    check(pinned is not None and np.array_equal(x_na[pinned], lb[pinned]),
          f"pinned slots left their value")
    check(len(nr_log) == n, f"NormRhoUpdater ran {len(nr_log)} times")
    by_form = row["launches_by_form"]
    check(by_form.get("split", 0) > 0 and by_form.get("shared", 0) > 0,
          f"the driver's wheel launched {by_form}")
    check(row["matmul_chunks"] == 0,
          f"{row['matmul_chunks']} chunks took the matmul route at cm=10")
    hook_s = {k: v / n for k, v in sorted(rec["seconds"].items())
              if not k.endswith(("pre_iter0", "post_iter0",
                                 "post_everything"))}
    out_a = {"phase": "driver_cylinders", "S": S, "crops_multiplier": CM,
             "dtype": "float32", "argv": DRIVER_ARGV,
             "options": opts, "cuts": {"PHIterLimit": {
                 "command line": cfg.max_iterations,
                 "here": DRIVER_PH_ITERS}},
             **row, "amalgamator_wall_s": wall,
             "wall_build_s": ama.wall_build, "wall_run_s": ama.wall_run,
             "s_per_superstep_wheel_split": wheel_split["s_per_superstep"],
             "extensions": exts, "hook_calls": rec["calls"],
             "hook_s_per_iteration": hook_s,
             "hooks_s_per_iteration_total": sum(hook_s.values()),
             "count_fixed": fixed, "pinned_before_last_superstep":
                 int(pinned.sum()), "nonant_slots": int(pinned.size),
             "norm_rho_updates": nr_log,
             "converger": {"name": "PrimalDualConverger",
                           "convergence_value":
                               opt.convobject.convergence_value,
                           "history": opt.convobject.history}}
    emit(out_a)

    # (b) PH alone on the same batch: the in-hub xhat, Gapper, MultRho
    eps_log = []

    class EpsLog(Extension):
        def post_iter0(self):
            eps_log.append((0, float(self.opt.solver_eps)))

        def enditer(self):
            eps_log.append((int(self.opt.state.it),
                            float(self.opt.solver_eps)))

    names = farmer.scenario_names_creator(S)
    hopts = dict(SPLIT_OPTS, PHIterLimit=DRIVER_HUB_ITERS,
                 gapperoptions={"mipgapdict": DRIVER_GAPPER})
    ph = PH(hopts, names, batch=opt.batch, prep=opt.prep,
            extensions=MultiExtension,
            extension_kwargs={"ext_classes": [XhatClosest, Gapper,
                                              MultRhoUpdater, EpsLog]})
    del ama, hub, opt
    hooks_on, hooks_off, rec_b = _hook_recorder()
    reset_counts()
    hooks_on()
    try:
        t = time.time()
        conv, eobj, trivial = ph.ph_main()
        torch.cuda.synchronize()
        wall_b = time.time() - t
    finally:
        hooks_off()
    xc = ph.extobject.extdict["XhatClosest"]
    inner = float(xc.best_inner_bound)
    check(np.isfinite(inner) and xc.best_nonants is not None,
          f"the in-hub XhatClosest found no feasible candidate ({inner})")
    check(trivial <= inner + 1e-6 * abs(inner),
          f"trivial bound {trivial} above the in-hub inner bound {inner}")
    sched, want = sorted(DRIVER_GAPPER), []
    for it, _ in eps_log:
        key = max(k for k in sched if k <= it)
        want.append((it, float(np.float32(DRIVER_GAPPER[key]))))
    check(eps_log == want and len(eps_log) == DRIVER_HUB_ITERS + 1,
          f"solver_eps {eps_log} is off the Gapper's schedule {want}")
    _check_hook_counts(rec_b["calls"], ["XhatClosest", "Gapper",
                                        "MultRhoUpdater"],
                       int(ph.state.it))
    by_form_b = pdhg_chunk.launches_by("form")
    check(by_form_b.get("shared", 0) > 0,
          f"the in-hub xhat launched no shared form: {by_form_b}")
    out_b = {"phase": "driver_hub", "S": S, "crops_multiplier": CM,
             "dtype": "float32", "options": {
                 k: v for k, v in hopts.items()},
             "ph_iterations": int(ph.state.it), "wall_s": wall_b,
             "trivial_bound": trivial, "eobj": eobj,
             "xhat_closest_inner_bound": inner,
             "solver_eps_by_iteration": eps_log,
             "rho_mean_end": float(ph.rho.mean()),
             "launches_by_form": by_form_b,
             "shared_launches_in_hub_xhat": by_form_b.get("shared", 0),
             "launch_shapes": launch_table(),
             "hook_s_per_iteration": {
                 k: v / int(ph.state.it)
                 for k, v in sorted(rec_b["seconds"].items())
                 if not k.endswith(("pre_iter0", "post_iter0",
                                    "post_everything"))}}
    emit(out_b)
    del ph

    # (d) the Fixer pinning for certain: tests/test_extensions.py's
    # integer farmer-3 case (rho 2, boundtol 0.5, nb 2), f64
    out_d = driver_fixer()
    emit(out_d)

    # (c) --EF through the amalgamator on the wheel_row batch, f64: run
    # at the start of the wheel phase, whose bracket it supplies
    out_c = wheel_row["driver_ef"]
    emit(out_c)
    return out_a, out_b, out_c


def driver_ef(highs):
    """--EF through the port's amalgamator on the wheel_row batch
    (farmer S=100, cm=1, f64), as a user runs it: its objective within
    1e-6 relative of the HiGHS optimum `highs`, its dual bound below
    it.  Returns the driver_ef line and the Amalgamator."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.utils import amalgamator, config
    t = time.time()
    ama = amalgamator.from_module(farmer, _driver_cfg(config),
                                  args=DRIVER_EF_ARGV, progname="farmer_ef")
    ama.run()
    torch.cuda.synchronize()
    check(ama.ef.batch.c.device.type == "cuda"
          and ama.ef.batch.c.dtype == torch.float64,
          "the EF batch is not f64 on the card")
    check(abs(ama.EF_Obj - highs) <= 1e-6 * abs(highs),
          f"amalgamator EF {ama.EF_Obj} is off the HiGHS optimum {highs}")
    check(ama.best_outer_bound <= ama.EF_Obj + 1e-6 * abs(ama.EF_Obj),
          f"EF dual bound {ama.best_outer_bound} above {ama.EF_Obj}")
    line = {"phase": "driver_ef", "S": WHEEL_S, "crops_multiplier": 1,
            "dtype": "float64", "argv": DRIVER_EF_ARGV,
            "wall_s": time.time() - t, "wall_build_s": ama.wall_build,
            "wall_run_s": ama.wall_run, "ef_obj": ama.EF_Obj,
            "ef_dual_bound": ama.best_outer_bound, "highs_optimum": highs,
            "rel_err_vs_highs": abs(ama.EF_Obj - highs) / abs(highs),
            "ef_iters": int(ama.ef._result.iters),
            "run_in": "the wheel phase, whose bracket it supplies"}
    return line, ama


def driver_fixer():
    """The Fixer on the card where it pins: integer farmer-3 in f64
    with tests/test_extensions.py's options (rho 2, boundtol 0.5, nb 2,
    12 PH iterations).  Slots pinned before the last superstep hold
    their pinned (integral) values in state.x exactly: the kernel's box
    projection onto lb_eff == ub_eff."""
    import torch

    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.extensions import MultiExtension
    from mpisppy_tpu_torch.extensions.fixer import Fixer
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    opts = {"defaultPHrho": 2.0, "PHIterLimit": 12, "convthresh": 0.0,
            "pdhg_eps": 1e-6, "pdhg_max_iters": 4000,
            "fixeroptions": {"boundtol": 0.5, "nb": 2}}
    hooks_on, hooks_off, rec = _hook_recorder()
    ph = PH(opts, farmer.scenario_names_creator(3),
            batch=farmer.build_batch(3, use_integer=True),
            extensions=MultiExtension,
            extension_kwargs={"ext_classes": [Fixer]})
    reset_counts()
    hooks_on()
    try:
        t = time.time()
        ph.ph_main()
        torch.cuda.synchronize()
        wall = time.time() - t
    finally:
        hooks_off()
    na = host(ph.batch.nonant_idx)
    lb, ub = host(ph.lb_eff)[:, na], host(ph.ub_eff)[:, na]
    x_na = host(ph.state.x)[:, na]
    pinned = rec["pinned"]
    fixed = ph.count_fixed()
    check(fixed == int(np.sum(lb == ub)) and fixed > 0
          and pinned is not None and pinned.any(),
          f"the Fixer pinned no slot on integer farmer-3 ({fixed})")
    check(np.array_equal(lb[lb == ub], np.round(lb[lb == ub])),
          "a pinned value is not integral")
    check(np.array_equal(x_na[pinned], lb[pinned]),
          f"{int(np.sum(x_na[pinned] != lb[pinned]))} pinned slots left "
          "their value")
    launched = pdhg_chunk.launches_by("form")
    check(sum(launched.values()) > 0, "driver_fixer launched no kernel")
    return {"phase": "driver_fixer", "S": 3, "dtype": "float64",
            "options": opts, "wall_s": wall,
            "ph_iterations": int(ph.state.it), "count_fixed": fixed,
            "pinned_before_last_superstep": int(pinned.sum()),
            "pinned_values": lb[lb == ub].tolist(),
            "launches_by_form": launched}


# ---- the model corpus ----------------------------------------------------

def launch_variants():
    """The kernel's launches since the last reset_counts() by (form, S,
    M, N, dtype, where A was held: "registers" (the tiled kernel),
    "resident" or "streamed" (the cluster kernel), cluster size)."""
    from mpisppy_tpu_torch.ops import pdhg_chunk
    return [{"form": k[0], "S": k[1], "M": k[2], "N": k[3], "dtype": k[4],
             "variant": k[5], "cluster": k[6], "launches": n}
            for k, n in sorted(pdhg_chunk.variant_launches.items())]


def cluster_launches(rows):
    """The launches of launch_variants() rows that went through the
    cluster kernel."""
    return sum(r["launches"] for r in rows
               if r["variant"] in ("resident", "streamed"))


def model_solver_space_inputs(b):
    """The chunk's inputs as PDHGSolver builds them for batch `b`, whose
    boxes are all finite: the port's Ruiz-scaled prep (dense, or shared
    for a (1, M, N) matrix), cold duals, the box midpoint as the primal
    start, omega=1; qs is qdiag scaled."""
    return lp_solver_space_inputs(b.A, b.row_lo, b.row_hi, b.c, b.qdiag,
                                  b.lb, b.ub)


def lp_solver_space_inputs(A, row_lo, row_hi, c, qdiag, lb, ub):
    """model_solver_space_inputs for one batched LP/QP given by its
    arrays (finite boxes)."""
    import torch

    from mpisppy_tpu_torch.ops.pdhg import prepare_batch
    check(bool(torch.isfinite(lb).all() and torch.isfinite(ub).all()),
          "lp_solver_space_inputs needs finite boxes")
    p = prepare_batch(A, row_lo, row_hi)
    dc = p.d_col
    qs = qdiag * dc * dc
    lbs = lb / dc
    ubs = ub / dc
    x = 0.5 * (lbs + ubs)
    y = torch.zeros_like(p.row_lo)
    tau = 0.9 / (p.anorm + 0.9 * qs.amax(dim=1))
    sigma = (0.9 / p.anorm).expand(tau.shape)
    vec = [t.contiguous() for t in (c * dc, qs, lbs, ubs, p.row_lo,
                                    p.row_hi, x, y, tau, sigma)]
    return [p.A.contiguous()] + vec


# the dense kernel's variants that the corpus puts on a path: (row name,
# batch builder (dtype) -> batch, the source of A expected in f32 and
# f64 (None: no row in that dtype), the scenarios kept (None: all; the
# f64 certify of acopf3 ieee14 re-solves S'=4 of its 12))
def _corpus_kernel_cases():
    from mpisppy_tpu_torch.models import acopf3, sizes, usar

    def ieee14(dt):
        return acopf3.build_batch((3, 2, 2), case="ieee14", dtype=dt)

    return (
        ("dense_sizes", lambda dt: sizes.build_batch(3, dtype=dt),
         ("resident", "resident"), None),
        ("dense_usar", lambda dt: usar.build_batch(3, dtype=dt),
         ("resident", "resident"), None),
        ("qs_ieee14", ieee14, ("resident", "resident"), None),
        ("qs_ieee14_certify", ieee14, (None, "resident"), 4),
        ("qs_registers_acopf3_22", lambda dt: acopf3.build_batch(
            (2, 2), dtype=dt), ("registers", "registers"), None))


def corpus_kernel_rows(peak_name, bw, f32_peak, f64_peak, n_sm):
    """The dense kernel at the corpus's shapes against its plain version
    (`fused_chunk_reference`), f32 and f64, on solver-space inputs from
    the port's own prep of each model's batch: the cluster kernel with A
    resident (sizes, usar, acopf3 ieee14 with a nonzero qs, and its f64
    certify's S'=4) and the register tile (acopf3 (2,2))."""
    import torch
    rows = {}
    for case, build, expect, keep in _corpus_kernel_cases():
        for (store, peak), want in zip(((torch.float32, f32_peak),
                                        (torch.float64, f64_peak)), expect):
            if want is None:
                continue
            dname = str(store).replace("torch.", "")
            args = model_solver_space_inputs(
                build(np.float32 if store == torch.float32 else np.float64))
            if keep is not None:
                args = [t[:keep].contiguous() for t in args]
            A, vec = args[0], args[1:]
            if case.startswith("qs_"):
                check(int((vec[1] != 0).sum()) > 0,
                      f"{case}: the scaled qs is all zero")
            row = measure_form("dense", A, vec, dname, peak, bw, peak_name,
                               n_sm)
            check(row["variant"]["source"] == want,
                  f"{case} {dname} took {row['variant']}, not A in {want}")
            row["case"] = case
            row["nonzero_qs"] = int((vec[1] != 0).sum())
            rows[(case, dname)] = row
            emit({"phase": "kernel", **row})
    return rows


def new_path_kernel_inputs(case, dtype):
    """Solver-space chunk inputs at NEW_PATH_KERNEL_CASES' shapes."""
    import torch

    from mpisppy_tpu_torch.models import acopf3, farmer
    from mpisppy_tpu_torch.utils.cross_scenario import (
        add_cross_scenario_capacity)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    if case == "split_wheel_row":
        return solver_space_inputs(dtype, split=True, scens=WHEEL_S, cm=1)
    if case == "dense_cross_scen":
        return batch_space_inputs(add_cross_scenario_capacity(
            farmer.build_batch(WHEEL_S, dtype=npdt),
            max_cuts=CROSS_MAX_CUTS, eta_weight=CROSS_W))
    return model_solver_space_inputs(acopf3.build_soc_batch(
        SOC_BF, case=SOC_CASE, soc_cut_slots=SOC_SLOTS, dtype=npdt))


def new_path_kernel_rows(peak_name, bw, f32_peak, f64_peak, n_sm):
    """The kernel at the shapes of the soc, cross_scen, wheel_multiproc
    and checkpoint paths against its plain version, f32 and f64
    (NEW_PATH_KERNEL_CASES)."""
    import torch
    rows = {}
    for case, form, expect in NEW_PATH_KERNEL_CASES:
        for (store, peak), want in zip(((torch.float32, f32_peak),
                                        (torch.float64, f64_peak)), expect):
            dname = str(store).replace("torch.", "")
            args = new_path_kernel_inputs(case, store)
            A, vec = args[0], args[1:]
            if case.startswith("qs_"):
                check(int((vec[1] != 0).sum()) > 0,
                      f"{case}: the scaled qs is all zero")
            row = measure_form(form, A, vec, dname, peak, bw, peak_name,
                               n_sm)
            check(row["variant"]["source"] == want,
                  f"{case} {dname} took {row['variant']}, not A in {want}")
            row["case"] = case
            row["nonzero_qs"] = int((vec[1] != 0).sum())
            rows[(case, dname)] = row
            emit({"phase": "kernel", **row})
    return rows


def alg_kernel_inputs(case, dtype):
    """Solver-space chunk inputs at the algorithms' new shapes: FWPH's
    lifted hull QP over farmer S=1000, cm=10 with a full bank of 16
    columns (seeded points of each scenario's box), or aircondB's ten
    bundles of 100 scenarios."""
    import torch

    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.fwph.fwph import hull_qp_arrays
    from mpisppy_tpu_torch.models import aircondB, farmer
    npdt = np.float32 if dtype == torch.float32 else np.float64
    if case == "bundles_aircondB":
        b = aircondB.build_batch((10, 10, 10), scenarios_per_bundle=100,
                                 dtype=npdt)
        return lp_solver_space_inputs(b.A, b.row_lo, b.row_hi, b.c,
                                      b.qdiag, b.lb, b.ub)
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=npdt)
    T = 16
    lb, ub = host(b.lb), host(b.ub)
    u = np.random.default_rng(0).uniform(size=(S, T, b.num_vars))
    V = lb[:, None, :] + u * (ub - lb)[:, None, :]
    K = b.num_nonants
    W = torch.zeros((S, K), dtype=b.c.dtype, device=b.c.device)
    xbar = torch.as_tensor(V[:, 0][:, host(b.nonant_idx)].mean(axis=0),
                           dtype=b.c.dtype, device=b.c.device).expand(S, K)
    rho = torch.ones((S, K), dtype=b.c.dtype, device=b.c.device)
    return lp_solver_space_inputs(*hull_qp_arrays(
        b, V, np.ones((S, T), bool), W, xbar, rho))


def alg_kernel_rows(peak_name, bw, f32_peak, f64_peak, n_sm):
    """The dense kernel at the algorithms' new shapes against its plain
    version: FWPH's hull QP (1000, 121, 136), A resident, f32 and f64;
    aircondB's bundles (10, 1552, 1600), A streamed, f32."""
    import torch
    rows = {}
    for case, shape, expect in ALG_KERNEL_CASES:
        for (store, peak), want in zip(((torch.float32, f32_peak),
                                        (torch.float64, f64_peak)), expect):
            if want is None:
                continue
            dname = str(store).replace("torch.", "")
            args = alg_kernel_inputs(case, store)
            A, vec = args[0], args[1:]
            check(tuple(A.shape) == shape,
                  f"{case}: A is {tuple(A.shape)}, not {shape}")
            row = measure_form("dense", A, vec, dname, peak, bw, peak_name,
                               n_sm)
            check(row["variant"]["source"] == want,
                  f"{case} {dname} took {row['variant']}, not A in {want}")
            row["case"] = case
            rows[(case, dname)] = row
            emit({"phase": "kernel", **row})
            del args, A, vec
    return rows


def _corpus_run(module, argv, progname, dtype, inner_required=True,
                options=None):
    """One examples/run_all.py row through `amalgamator.from_module`,
    as a user runs it (interleaved wheel, or --EF), on the card, with
    the counts zeroed just before: its common line fields.  A wheel's
    outer bound must be finite and at most the inner bound plus
    CORPUS_CROSS_TOL_REL; the inner bound must be finite unless
    `inner_required` is False (a multistage wheel whose xhat candidates
    are all infeasible within its iterations reports +inf).  `options`
    are laid over the flags' options (what no flag carries)."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.utils import amalgamator, config
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    ama = amalgamator.from_module(module, _driver_cfg(config, options),
                                  args=argv,
                                  progname=progname,
                                  batch_kwargs={"dtype": dtype})
    ama.run()
    torch.cuda.synchronize()
    wall = time.time() - t
    hub = ama.wheel.spcomm if ama.wheel is not None else None
    b = ama.ef.batch if hub is None else hub.opt.batch
    check(b.c.device.type == "cuda" and b.c.dtype == getattr(
        torch, np.dtype(dtype).name), f"{progname}: the batch is "
          f"{b.c.dtype} on {b.c.device}")
    line = {"argv": argv, "dtype": np.dtype(dtype).name,
            "S": b.num_scens, "M": b.num_rows, "N": b.num_vars,
            "num_nodes": b.tree.num_nodes,
            "nonzero_qdiag": int((b.qdiag != 0).sum()),
            "wall_s": wall, "wall_build_s": ama.wall_build,
            "wall_run_s": ama.wall_run, "launches": launch_variants(),
            "matmul_chunks": pdhg.matmul_chunks,
            "consensus_chunks": pdhg.consensus_chunks}
    if hub is None:
        line.update(ef_obj=ama.EF_Obj, ef_dual_bound=ama.best_outer_bound,
                    ef_iters=int(ama.ef._result.iters))
        return ama, line
    outer, inner = float(ama.best_outer_bound), float(ama.best_inner_bound)
    check(hub.failed_spokes == [] and hub.finalize_failures == [],
          f"{progname}: spokes failed: {hub.failed_spokes} "
          f"{hub.finalize_failures}")
    check(np.isfinite(outer) and (np.isfinite(inner) or (
        not inner_required and inner == np.inf)),
          f"{progname}: bounds not finite: outer {outer}, inner {inner}")
    check(outer <= inner + CORPUS_CROSS_TOL_REL * abs(inner),
          f"{progname}: outer bound {outer} above inner {inner}")
    line.update(ph_iterations=hub.current_iteration(), best_outer=outer,
                best_inner=inner,
                rel_gap=abs(inner - outer) / max(1.0, abs(inner)),
                launches_by_form=pdhg_chunk.launches_by("form/dtype"))
    return ama, line


def _certify_cut():
    return {"certify_max_iters": {
        "default": 100000,
        "here": CORPUS_CERTIFY_OPTIONS["certify_max_iters"]}}


def _bracket(line, opt, tol_rel, what):
    tol = tol_rel * abs(opt)
    check(line["best_outer"] <= opt + tol and line["best_inner"] >= opt - tol,
          f"{what}: bounds [{line['best_outer']}, {line['best_inner']}] "
          f"do not bracket {opt}")


def _node_spread(ph):
    """Per stage, the largest spread of x̄ over the scenarios of one
    tree node (0.0: x̄ is one value per (node, slot))."""
    from mpisppy_tpu_torch.device import host
    xbar = host(ph.state.xbar)
    node_of = host(ph.batch.tree.node_of)
    stage_of = np.asarray(ph.batch.tree.stage_of)
    out = {}
    for st in np.unique(stage_of):
        cols = np.where(stage_of == st)[0]
        worst = 0.0
        for n in np.unique(node_of[:, cols]):
            rows = np.where((node_of[:, cols] == n).all(axis=1))[0]
            blk = xbar[np.ix_(rows, cols)]
            worst = max(worst, float(np.max(np.abs(blk - blk[0]))))
        out[f"stage{int(st)}"] = worst
    return out


def round_pos_sig(x, sig=2):
    """tests/utils.py of the reference: x at `sig` significant figures."""
    return round(x, -int(np.floor(np.log10(abs(x)))) + (sig - 1))


def corpus_hydro():
    """hydro (3,3) in f64, run_all.py's row (its iterations cut to
    CORPUS_HYDRO_ITERS): the wheel's bounds bracket
    the f64 EF optimum (the amalgamator's --EF), which agrees with the
    multistage HiGHS oracle; plain PH with the JAX package's golden
    options gives trivial bound 180 and E[obj] 190."""
    import torch

    from mpisppy_tpu_torch.models import hydro
    from mpisppy_tpu_torch.opt.ph import PH
    ama, line = _corpus_run(hydro, CORPUS_HYDRO_ARGV, "hydro_cylinders",
                            np.float64, options=CORPUS_CERTIFY_OPTIONS)
    ef, ef_line = _corpus_run(hydro, ["--branching-factors", "3,3", "--EF",
                                      "--EF-solver-eps", "1e-8"],
                              "hydro_ef", np.float64)
    highs, n_vars = ef_lp_oracle(ef.ef.batch)
    opt = ef.EF_Obj
    check(abs(opt - highs) <= 1e-6 * abs(highs),
          f"hydro EF {opt} is off the HiGHS optimum {highs}")
    _bracket(line, opt, CORPUS_BRACKET_TOL_REL, "corpus_hydro")
    spread = _node_spread(ama.wheel.spcomm.opt)
    check(max(spread.values()) == 0.0, f"hydro x̄ varies in a node: {spread}")
    t = time.time()
    ph = PH(dict(HYDRO_GOLDEN_OPTS), hydro.scenario_names_creator(9),
            batch=hydro.build_batch())
    conv, eobj, tbound = ph.ph_main()
    inner, feas = ph.evaluate_xhat(ph.state.xbar)
    torch.cuda.synchronize()
    golden = {"trivial_bound": tbound, "eobj": eobj, "xhat_inner": inner,
              "xhat_feasible": feas, "conv": conv,
              "ph_iterations": int(ph.state.it), "wall_s": time.time() - t}
    check(round_pos_sig(tbound) == 180 and round_pos_sig(eobj) == 190
          and feas and round_pos_sig(inner) == 190,
          f"hydro goldens (180, 190): {golden}")
    out = {"phase": "corpus_hydro", **line, "ef": ef_line,
           "ef_optimum_f64": opt, "highs_optimum": highs,
           "highs_ef_vars": n_vars,
           "rel_err_vs_highs": abs(opt - highs) / abs(highs),
           "bracket_tol_rel": CORPUS_BRACKET_TOL_REL,
           "xbar_spread_in_node": spread,
           "cuts": dict(_certify_cut(), **{"--max-iterations": {
               "run_all.py": 40, "here": CORPUS_HYDRO_ITERS}}),
           "golden_ph": golden}
    emit(out)
    return out


def corpus_aircond():
    """aircond (10,10,10) in f32: S=1000, 4 stages, 111 non-leaf nodes,
    the full published parameter table; the bounds bracket the HiGHS EF
    optimum; x̄ of stages 2 and 3 is one value per node."""
    from mpisppy_tpu_torch.models import aircond
    ama, line = _corpus_run(aircond, CORPUS_AIRCOND_ARGV,
                            "aircond_cylinders", np.float32,
                            inner_required=False,
                            options=CORPUS_CERTIFY_OPTIONS)
    from mpisppy_tpu_torch.scenario_tree import MultistageTree
    tree = MultistageTree([int(f) for f in CORPUS_AIRCOND_ARGV[1].split(",")])
    b = ama.wheel.spcomm.opt.batch
    check(b.num_scens == tree.num_scens
          and b.tree.num_nodes == tree.num_nodes,
          f"aircond tree: S={b.num_scens}, {b.tree.num_nodes} nodes")
    t = time.time()
    highs, n_vars = ef_lp_oracle(b)
    highs_s = time.time() - t
    SHARED["aircond_highs"] = highs     # aircondB's reference too
    _bracket(line, highs, CORPUS_BRACKET_TOL_REL, "corpus_aircond")
    spread = _node_spread(ama.wheel.spcomm.opt)
    check(spread["stage2"] == 0.0 and spread["stage3"] == 0.0,
          f"aircond x̄ varies in a node: {spread}")
    out = {"phase": "corpus_aircond", **line, "highs_optimum": highs,
           "highs_ef_vars": n_vars, "highs_s": highs_s,
           "bracket_tol_rel": CORPUS_BRACKET_TOL_REL,
           "xbar_spread_in_node": spread,
           "cuts": dict(_certify_cut(), **{"--max-iterations": {
               "before the script ran over its limit": 10,
               "before the algorithms phase": 4,
               "here": CORPUS_AIRCOND_ITERS}})}
    emit(out)
    return out


def corpus_acopf3():
    """acopf3 on the IEEE 14-bus case, (3,2,2), in f32: a nonzero qdiag
    on the card; its bounds bracket the port's own f64 EF objective (a
    QP: HiGHS's linprog cannot be the oracle).  Then run_all.py's
    default row (the 5-bus grid, (2,2)) cut to 5 iterations: the
    register tile with a nonzero qs."""
    from mpisppy_tpu_torch.models import acopf3
    ama, line = _corpus_run(acopf3, CORPUS_ACOPF3_ARGV, "acopf3_cylinders",
                            np.float32, inner_required=False)
    check(line["nonzero_qdiag"] > 0, "acopf3 ieee14 has no qdiag")
    ef, ef_line = _corpus_run(acopf3, CORPUS_ACOPF3_ARGV[:2] + [
        "--case", "ieee14", "--EF", "--EF-solver-eps", "1e-7"],
        "acopf3_ef", np.float64)
    opt = ef.EF_Obj
    _bracket(line, opt, CORPUS_BRACKET_TOL_REL, "corpus_acopf3")
    _, line22 = _corpus_run(acopf3, CORPUS_ACOPF3_22_ARGV,
                            "acopf3_cylinders", np.float32)
    out = {"phase": "corpus_acopf3", **line, "ef": ef_line,
           "cuts": {"--max-iterations": {"run_all.py": 10,
                                         "here": CORPUS_ACOPF3_ITERS}},
           "ef_optimum_f64": opt, "bracket_tol_rel": CORPUS_BRACKET_TOL_REL,
           "grid_5bus_22": line22}
    emit(out)
    return out


def corpus_2stage():
    """run_all.py's two-stage rows (sizes, apl1p, battery, netdes, gbd,
    usar) in f32 with --max-iterations cut to CORPUS_2STAGE_ITERS:
    finite bounds, outer <= inner; then each family's --EF in f64
    within 1e-6 of HiGHS on the same EF LP (for the integer families
    their LP relaxation, which is what the port solves)."""
    import importlib
    out = {"phase": "corpus_2stage", "rows": {}}
    for name, n, iters in CORPUS_2STAGE:
        mod = importlib.import_module(f"mpisppy_tpu_torch.models.{name}")
        argv = ["--num-scens", str(n), "--max-iterations",
                str(CORPUS_2STAGE_ITERS), "--default-rho", "1",
                "--lagrangian", "--xhatshuffle"]
        _, line = _corpus_run(mod, argv, f"{name}_cylinders", np.float32)
        ef, ef_line = _corpus_run(mod, ["--num-scens", str(n), "--EF"],
                                  f"{name}_ef", np.float64)
        highs, n_vars = ef_lp_oracle(ef.ef.batch)
        rel = abs(ef.EF_Obj - highs) / max(abs(highs), 1e-9)
        check(rel <= 1e-6, f"{name} EF {ef.EF_Obj} is {rel:.2e} from the "
              f"HiGHS optimum {highs}")
        line.update(cut={"--max-iterations": {"run_all.py": iters,
                                              "here": CORPUS_2STAGE_ITERS}},
                    ef=ef_line, highs_optimum=highs, highs_ef_vars=n_vars,
                    ef_rel_err_vs_highs=rel,
                    integer=bool(ef.ef.batch.integer_mask.any()))
        out["rows"][name] = line
        emit({"phase": f"corpus_2stage_{name}", **line})
    return out


def corpus_creator():
    """SPBase(scenario_creator=...) on the card against the vectorized
    builders, exactly: hydro's creator against hydro.build_batch, and
    farmer's at S=CORPUS_CREATOR_S, cm=CORPUS_CREATOR_CM against
    build_batch(split=False); the creator path's build wall beside the
    builder's."""
    import torch

    from mpisppy_tpu_torch.models import farmer, hydro
    from mpisppy_tpu_torch.spbase import SPBase

    def same(a, b):
        bad = [f for f in ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub",
                           "obj_const", "nonant_idx", "integer_mask",
                           "stage_cost_c")
               if not torch.equal(getattr(a, f), getattr(b, f))]
        bad += [f"tree.{f}" for f in ("node_of", "prob")
                if not torch.equal(getattr(a.tree, f), getattr(b.tree, f))]
        if a.tree.num_nodes != b.tree.num_nodes:
            bad.append("tree.num_nodes")
        return bad

    out = {"phase": "corpus_creator"}
    S, cm = CORPUS_CREATOR_S, CORPUS_CREATOR_CM
    for name, names, creator, kw, build in (
            ("hydro", hydro.scenario_names_creator(9),
             hydro.scenario_creator, {"branching_factors": [3, 3]},
             hydro.build_batch),
            ("farmer", farmer.scenario_names_creator(S),
             farmer.scenario_creator,
             {"crops_multiplier": cm, "num_scens": S},
             lambda: farmer.build_batch(S, crops_multiplier=cm,
                                        split=False))):
        torch.cuda.synchronize()
        t = time.time()
        sb = SPBase({}, names, scenario_creator=creator,
                    scenario_creator_kwargs=kw)
        torch.cuda.synchronize()
        t_creator = time.time() - t
        t = time.time()
        ref = build()
        torch.cuda.synchronize()
        t_build = time.time() - t
        check(sb.batch.c.device.type == "cuda",
              f"{name}: the creator path's batch is on {sb.batch.c.device}")
        bad = same(sb.batch, ref)
        check(not bad, f"{name}: the creator path differs from build_batch "
              f"in {bad}")
        out[name] = {"S": sb.batch.num_scens, "M": sb.batch.num_rows,
                     "N": sb.batch.num_vars,
                     "num_nodes": sb.batch.tree.num_nodes,
                     "creator_build_s": t_creator, "build_batch_s": t_build,
                     "equal": True}
    emit(out)
    return out


def corpus_phase():
    """The model corpus on the card: each sub-run through
    the users' entry point, one JSON line each; the launches of every
    sub-run summed by (form, M, N, dtype) for the kernels line."""
    import collections
    t0 = time.time()
    subs = {}
    for fn in (corpus_creator, corpus_hydro, corpus_aircond, corpus_acopf3,
               corpus_2stage):
        t = time.time()
        subs[fn.__name__] = fn()
        subs[fn.__name__]["s"] = time.time() - t
    lines = [subs["corpus_hydro"], subs["corpus_hydro"]["ef"],
             subs["corpus_aircond"], subs["corpus_acopf3"],
             subs["corpus_acopf3"]["ef"],
             subs["corpus_acopf3"]["grid_5bus_22"]]
    for row in subs["corpus_2stage"]["rows"].values():
        lines += [row, row["ef"]]
    launched = collections.Counter()
    for ln in lines:
        for r in ln["launches"]:
            launched[(r["form"], r["M"], r["N"], r["dtype"])] += r["launches"]
    acopf3 = subs["corpus_acopf3"]
    out = {"phase": "corpus", "s": time.time() - t0,
           "sub_run_s": {k: v["s"] for k, v in subs.items()},
           "cluster_launches": {"corpus_acopf3": sum(cluster_launches(
               ln["launches"]) for ln in (acopf3, acopf3["ef"],
                                          acopf3["grid_5bus_22"]))},
           "launches_by_form_shape_dtype": [
               {"form": k[0], "M": k[1], "N": k[2], "dtype": k[3],
                "launches": n} for k, n in sorted(launched.items())]}
    emit(out)
    out["launched"] = launched
    return out


# ---- the remaining algorithms ----------------------------------------------

def _alg_line(name, fn):
    """Run one algorithms sub-run with the counts zeroed just before
    it; its line gains the wall, the kernel launches by (form, S, M, N,
    dtype, variant) and the matmul and consensus routes' chunks."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    line = {"phase": name, **out, "wall_s": time.time() - t,
            "launches": launch_variants(),
            "matmul_chunks": pdhg.matmul_chunks,
            "consensus_chunks": pdhg.consensus_chunks}
    if name in ALG_CUTS:
        line["cuts"] = ALG_CUTS[name]
    emit(line)
    return line


def _farmer_cfg(argv, progname, options=None):
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.utils import config
    cfg = _driver_cfg(config, options)
    cfg.aph_args()
    farmer.inparser_adder(cfg)
    cfg.parse_command_line(progname, args=argv)
    return cfg


def alg_farmer_ef():
    """The f64 EF optimum of farmer S=1000, cm=10 by HiGHS (the
    L-shaped, FWPH and SC checks' reference)."""
    from mpisppy_tpu_torch.models import farmer
    t = time.time()
    opt, n_vars = ef_lp_oracle(farmer.build_batch(S, crops_multiplier=CM))
    SHARED["farmer_ef"] = opt
    return {"highs_optimum": opt, "highs_ef_vars": n_vars,
            "highs_s": time.time() - t}


def alg_lshaped():
    """examples/farmer_lshapedhub.py's command line at S=ALG_LSHAPED_S,
    cm=10 through the port's config and vanilla (its batch in f64, the
    example's dtype): the subproblems on the kernel, the root
    (1, 1 + S (max_iter + 1), 30 + S) on the matmul route.  Outer <=
    inner, both around the f64 EF optimum of the same batch (HiGHS);
    the gap at the cap."""
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.utils import vanilla
    cfg = _farmer_cfg(ALG_LSHAPED_ARGV, "farmer_lshapedhub")
    names = farmer.scenario_names_creator(cfg.num_scens)
    batch = farmer.build_batch(cfg.num_scens,
                               crops_multiplier=cfg.get("crops_multiplier"))
    hub = vanilla.lshaped_hub(cfg, farmer.scenario_creator, None, names,
                              batch=batch)
    spokes = [vanilla.xhatlshaped_spoke(cfg, farmer.scenario_creator,
                                        None, names, batch=batch)]
    ws = WheelSpinner(hub, spokes).spin()
    opt = ws.spcomm.opt
    outer, inner = float(ws.BestOuterBound), float(ws.BestInnerBound)
    ef, _ = ef_lp_oracle(batch)
    tol = CORPUS_BRACKET_TOL_REL * abs(ef)
    check(np.isfinite(outer) and np.isfinite(inner),
          f"alg_lshaped: bounds {outer}, {inner}")
    check(outer <= inner + tol, f"alg_lshaped: outer {outer} > inner {inner}")
    check(outer <= ef + tol and inner >= ef - tol,
          f"alg_lshaped: [{outer}, {inner}] do not bracket {ef}")
    check(ws.spcomm.failed_spokes == [], "alg_lshaped: a spoke failed")
    check(opt.root_unconverged == 0, f"alg_lshaped: {opt.root_unconverged}"
          " root LP(s) unconverged: the outer bound is no bound")
    M_root, N_root = opt._root["A"].shape[1:]
    return {"S": batch.num_scens, "dtype": "float64", "iterations": opt.iter,
            "best_outer": outer, "best_inner": inner,
            "rel_gap": (inner - outer) / abs(inner), "ef_optimum": ef,
            "root_shape": [1, M_root, N_root], "cuts_added":
            opt._root["n_cuts"], "root_resolves": opt.root_resolves,
            "history": [[o, i] for o, i, _ in opt.history]}


def _aph_recording():
    """APH recording its convergence metric after each superstep."""
    from mpisppy_tpu_torch.opt.aph import APH

    class Rec(APH):
        def _aph_superstep(self, *a):
            st = super()._aph_superstep(*a)
            self.convs = getattr(self, "convs", []) + [float(st.conv)]
            return st
    return Rec


def alg_aph():
    """vanilla.aph_hub on farmer S=1000, cm=10, f32, dispatch_frac 0.5,
    with a Lagrangian and an xhat-shuffle spoke, interleaved: APH's conv
    falls, both bounds finite, outer <= inner."""
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.utils import vanilla
    cfg = _farmer_cfg(ALG_APH_ARGV, "farmer_aph")
    names = farmer.scenario_names_creator(cfg.num_scens)
    batch = farmer.build_batch(cfg.num_scens, crops_multiplier=CM,
                               dtype=np.float32)
    hub = vanilla.aph_hub(cfg, farmer.scenario_creator, None, names,
                          batch=batch)
    hub["opt_class"] = _aph_recording()
    spokes = vanilla.build_spokes(cfg, farmer.scenario_creator, None,
                                  names, batch=batch)
    ws = WheelSpinner(hub, spokes).spin()
    opt = ws.spcomm.opt
    outer, inner = float(ws.BestOuterBound), float(ws.BestInnerBound)
    check(opt.n_dispatch == S // 2, f"alg_aph dispatches {opt.n_dispatch}")
    convs = opt.convs
    check(len(convs) >= 2 and np.isfinite(convs[-1])
          and convs[-1] < convs[1], f"alg_aph: conv did not fall: {convs}")
    check(np.isfinite(outer) and np.isfinite(inner),
          f"alg_aph: bounds {outer}, {inner}")
    check(outer <= inner + CORPUS_CROSS_TOL_REL * abs(inner),
          f"alg_aph: outer {outer} > inner {inner}")
    check(ws.spcomm.failed_spokes == [], "alg_aph: a spoke failed")
    return {"S": S, "dtype": "float32", "n_dispatch": opt.n_dispatch,
            "iterations": ws.spcomm.current_iteration(), "convs": convs,
            "best_outer": outer, "best_inner": inner,
            "rel_gap": (inner - outer) / abs(inner)}


def alg_fwph():
    """A PH hub with the FWPH spoke (--fwph through vanilla) on farmer
    S=1000, cm=10, f32: the hull QP launches the dense kernel at (1000,
    121, 136); the spoke's best dual bound is at most the EF optimum and
    never decreases."""
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    from mpisppy_tpu_torch.utils import vanilla
    cfg = _farmer_cfg(ALG_FWPH_ARGV, "farmer_fwph")
    names = farmer.scenario_names_creator(cfg.num_scens)
    batch = farmer.build_batch(cfg.num_scens, crops_multiplier=CM,
                               dtype=np.float32)
    hub = vanilla.ph_hub(cfg, farmer.scenario_creator, None, names,
                         batch=batch)
    spokes = vanilla.build_spokes(cfg, farmer.scenario_creator, None,
                                  names, batch=batch)
    ws = WheelSpinner(hub, spokes).spin()
    sp = ws.spcomm.spokes[0]
    bounds = list(sp.opt._dual_bounds)
    best = np.maximum.accumulate(bounds).tolist()
    ef = SHARED["farmer_ef"]
    check(len(bounds) >= 1 and np.isfinite(sp.bound),
          f"alg_fwph: no dual bound ({bounds})")
    check(sp.bound == best[-1], f"alg_fwph: spoke bound {sp.bound} is not "
          f"the best pass bound {best[-1]}")
    check(sp.bound <= ef + CORPUS_BRACKET_TOL_REL * abs(ef),
          f"alg_fwph: dual bound {sp.bound} above the EF optimum {ef}")
    check(ws.spcomm.failed_spokes == [], "alg_fwph: the spoke failed")
    return {"S": S, "dtype": "float32", "passes": len(bounds),
            "dual_bounds": bounds, "best_dual_bound": sp.bound,
            "ef_optimum": ef, "rel_gap_to_ef": (ef - sp.bound) / abs(ef),
            "sdm_early_stops": sp.opt.sdm_early_stops,
            "hub_outer": float(ws.BestOuterBound),
            "hub_inner": float(ws.BestInnerBound)}


def alg_sc():
    """SchurComplement (the IPM runs in f64) on farmer S=ALG_SC_S, cm=10
    at ALG_SC_ITERS iterations: its objective within 1e-6 of the f64 EF
    optimum (HiGHS).  Then at S=1000 and ALG_SC_FULL_ITERS iterations:
    within ALG_SC_FULL_TOL_REL of where the JAX package's IPM stops
    (both packages stop short of the optimum there)."""
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.sc import SchurComplement
    b = farmer.build_batch(ALG_SC_S, crops_multiplier=CM)
    ef, _ = ef_lp_oracle(b)
    t = time.time()
    sc = SchurComplement({"sc_max_iter": ALG_SC_ITERS},
                         farmer.scenario_names_creator(ALG_SC_S), batch=b)
    obj, x = sc.solve()
    wall = time.time() - t
    rel = abs(obj - ef) / abs(ef)
    check(rel <= 1e-6, f"alg_sc: {obj} is {rel:.2e} from the EF {ef}")
    t = time.time()
    fobj, _ = SchurComplement(
        {"sc_max_iter": ALG_SC_FULL_ITERS}, farmer.scenario_names_creator(S),
        batch=farmer.build_batch(S, crops_multiplier=CM)).solve()
    ref = SHARED["farmer_ef"]
    to_jax = abs(fobj - ALG_SC_FULL_JAX) / abs(ALG_SC_FULL_JAX)
    check(np.isfinite(fobj) and to_jax <= ALG_SC_FULL_TOL_REL,
          f"alg_sc: at S={S} the IPM ends at {fobj}, {to_jax:.2e} from the "
          f"JAX package's {ALG_SC_FULL_JAX}")
    full = {"S": S, "sc_max_iter": ALG_SC_FULL_ITERS, "objective": fobj,
            "ef_optimum": ref, "rel_err": abs(fobj - ref) / abs(ref),
            "jax_objective": ALG_SC_FULL_JAX, "rel_to_jax": to_jax,
            "s": time.time() - t}
    return {"S": ALG_SC_S, "sc_max_iter": ALG_SC_ITERS, "objective": obj,
            "ef_optimum": ef, "rel_err": rel, "ipm_s": wall,
            "first_stage": [float(v) for v in x[:6]], "at_S1000": full}


def alg_mip():
    """The MIP extensive form (`opt/mip.ExtensiveFormMIP`) on integer
    farmer-6 (acreage integrality, f64, the JAX package's test options):
    its incumbent integral and within 1e-4 of the HiGHS MILP optimum of
    the same EF (-123,483.879 on the CPU), bound <= incumbent, the LP
    count.  examples/sizes_ef_mip.py's row and its golden take 751.2 s
    on the card (tests/algorithms_witness.py)."""
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.mip import ExtensiveFormMIP
    batch = farmer.build_batch(ALG_MIP_S, use_integer=True)
    ef = ExtensiveFormMIP(dict(ALG_MIP_OPTIONS),
                          farmer.scenario_names_creator(ALG_MIP_S),
                          batch=batch)
    out = ef.solve_mip()
    inc, bound = out["incumbent"], out["bound"]
    t = time.time()
    milp_opt, _ = ef_lp_oracle(batch, integer=True)
    milp_s = time.time() - t
    im = batch.integer_mask.cpu().numpy()
    xi = out["x"][im]
    rel = abs(inc - milp_opt) / abs(milp_opt)
    check(np.allclose(xi, np.round(xi)), "alg_mip: incumbent not integral")
    check(bound <= inc + 1e-9 * abs(inc),
          f"alg_mip: bound {bound} above incumbent {inc}")
    check(rel <= 1e-4, f"alg_mip: incumbent {inc} is {rel:.2e} from the "
          f"MILP optimum {milp_opt}")
    return {"S": batch.num_scens, "M": batch.num_rows, "N": batch.num_vars,
            "integer_columns": int(im.sum()), "incumbent": inc,
            "bound": bound, "gap": out["gap"], "milp_optimum": milp_opt,
            "milp_s": milp_s, "rel_to_milp": rel, "viol": out["viol"],
            "lp_solves": out["lp_solves"], "rounds": out["rounds"],
            "options": ALG_MIP_OPTIONS}


def alg_bundles():
    """aircondB through the amalgamator: aircond (10,10,10) in proper
    bundles of 100 scenarios, ten two-stage bundles (10, 1552, 1600) in
    f32, PH with a Lagrangian spoke: its outer bound at most aircond's
    multistage EF optimum (HiGHS) and at most ALG_BUNDLE_OUTER_FACTOR x
    |optimum| below it."""
    from mpisppy_tpu_torch.models import aircond, aircondB
    ama, line = _corpus_run(aircondB, ALG_BUNDLE_ARGV, "aircondB_cylinders",
                            np.float32, inner_required=False,
                            options=CORPUS_CERTIFY_OPTIONS)
    b = ama.wheel.spcomm.opt.batch
    shape = dict((c, s) for c, s, _ in ALG_KERNEL_CASES).get(
        "bundles_aircondB")
    check(shape is None or (b.num_scens, b.num_rows, b.num_vars) == shape,
          f"alg_bundles: the bundled batch is ({b.num_scens}, "
          f"{b.num_rows}, {b.num_vars}), not {shape}")
    highs = SHARED.get("aircond_highs")
    if highs is None:
        # the corpus phase did not run first: the same batch afresh
        bf = ALG_BUNDLE_ARGV[ALG_BUNDLE_ARGV.index("--branching-factors")
                             + 1]
        highs, _ = ef_lp_oracle(aircond.build_batch(
            tuple(int(f) for f in bf.split(",")), start_seed=0,
            dtype=np.float32))
    check(line["best_outer"] <= highs + CORPUS_BRACKET_TOL_REL * abs(highs),
          f"alg_bundles: outer {line['best_outer']} above the aircond EF "
          f"optimum {highs}")
    check(line["best_outer"] >= highs - ALG_BUNDLE_OUTER_FACTOR * abs(highs),
          f"alg_bundles: outer {line['best_outer']} more than "
          f"{ALG_BUNDLE_OUTER_FACTOR} x |{highs}| below the aircond EF "
          "optimum")
    line.pop("launches")
    return {**line, "aircond_highs_optimum": highs}


def alg_varprob():
    """PH on farmer S=1000, cm=10, f32, with a non-uniform (S, K)
    variable_probability: x̄ equals a numpy weighting of the same x;
    the W-based Lagrangian bound refuses."""
    import torch

    from mpisppy_tpu_torch.device import host
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ph import PH
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    vp = np.random.default_rng(1).uniform(0.2, 1.0, (S, b.num_nonants))
    vp /= vp.sum(axis=0, keepdims=True)
    ph = PH({"defaultPHrho": 1.0, "PHIterLimit": ALG_VARPROB_ITERS,
             "convthresh": 0.0, "pdhg_eps": 1e-6},
            farmer.scenario_names_creator(S), batch=b,
            variable_probability=vp)
    conv, eobj, triv = ph.ph_main()
    x_na = host(b.nonants(ph.state.x)).astype(np.float64)
    want = (vp * x_na).sum(axis=0) / vp.sum(axis=0)
    got = host(ph.state.xbar)[0].astype(np.float64)
    rel = float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))
    check(rel <= 1e-5, f"alg_varprob: x̄ {rel:.2e} from the numpy weighting")
    plain = (host(b.prob)[:, None] * x_na).sum(axis=0)
    refused = False
    try:
        ph.lagrangian_bound()
    except NotImplementedError:
        refused = True
    check(refused, "alg_varprob: the W-based bound did not refuse")
    check(ph.state.x.device.type == "cuda" and torch.is_tensor(
        ph.batch.var_prob), "alg_varprob left the card")
    return {"S": S, "dtype": "float32", "iterations": int(ph.state.it),
            "xbar_rel_err": rel, "eobj": eobj, "conv": conv,
            "xbar_moved_by_weights": float(np.max(np.abs(got - plain))),
            "lagrangian_refused": refused}


# the algorithms' sub-runs by process: the second process's (after
# `compact`) and the main process's (after `driver`), so that the two
# end near each other; `alg_farmer_ef` gives the second process's
# checks their reference
ALG_CHILD = ("alg_farmer_ef", "alg_fwph", "alg_sc", "alg_bundles")
ALG_MAIN = ("alg_lshaped", "alg_aph", "alg_mip", "alg_varprob")


def algorithms_phase(names=ALG_CHILD, phase="algorithms"):
    """The remaining algorithms on the card, each through its users'
    entry point, one line each (the sub-runs `names`, of ALG_CHILD or
    ALG_MAIN); the launches of every sub-run summed by (form, M, N,
    dtype) for the kernels line.  Its line is `phase`."""
    import collections
    t0 = time.time()
    lines = {}
    for name in names:
        lines[name] = _alg_line(name, globals()[name])
    launched = collections.Counter()
    for ln in lines.values():
        for r in ln["launches"]:
            launched[(r["form"], r["M"], r["N"], r["dtype"])] += r["launches"]
    out = {"phase": phase, "s": time.time() - t0,
           "sub_run_s": {k: v["wall_s"] for k, v in lines.items()},
           "cluster_launches": {k: cluster_launches(v["launches"])
                                for k, v in lines.items()},
           "launches_by_form_shape_dtype": [
               {"form": k[0], "M": k[1], "N": k[2], "dtype": k[3],
                "launches": n} for k, n in sorted(launched.items())]}
    emit(out)
    out["launched"] = launched
    return out


# ---- SOC, cross-scenario cuts, multiproc, checkpoints -------------------

def _soc_flow_idx(b):
    """(T, nL) column indices of each flow family (P, Pr, Q, Qr) of an
    SOC batch, from its variable names."""
    m = b.model_meta
    T, nL = m["soc_cc"].shape
    col = {n: i for i, n in enumerate(b.var_names)}
    return {k: np.array([[col[f"{k}[{t + 1},{l_}]"] for l_ in range(nL)]
                         for t in range(T)])
            for k in ("P", "Pr", "Q", "Qr")}


def soc_phase():
    """acopf3's SOC relaxation on the card: soc_refine on IEEE 14-bus
    (2,2) (rounds, walls, iterations, cuts), the refined EF by the
    port's f64 EF, dead lines, then PH on the refined batch: its E[obj]
    against the EF's objective and its bounds around it where they
    certify."""
    import torch

    from mpisppy_tpu_torch.extensions.extension import Extension
    from mpisppy_tpu_torch.models import acopf3
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.ops import pdhg
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    b = acopf3.build_soc_batch(SOC_BF, case=SOC_CASE,
                               soc_cut_slots=SOC_SLOTS)
    rounds, last = [], {}
    solve = ExtensiveForm.solve_extensive_form

    def timed(self, *a, **kw):
        t = time.time()
        res = solve(self, *a, **kw)
        torch.cuda.synchronize()
        rounds.append({"wall_s": time.time() - t, "iters": int(res.iters),
                       "converged": bool(res.converged.all())})
        last["x"], last["y"] = res.x, res.y
        return res
    ExtensiveForm.solve_extensive_form = timed
    try:
        b2, hist = acopf3.soc_refine(b, rounds=SOC_ROUNDS,
                                     opts=dict(SOC_REFINE_OPTS))
    finally:
        ExtensiveForm.solve_extensive_form = solve
    refine_s = time.time() - t0
    for r, h in zip(rounds, hist):
        r.update(round=h[0], objective=h[1], max_violation=h[2], cuts=h[3])
    objs = [h[1] for h in hist]
    for a, c in zip(objs, objs[1:]):
        check(c >= a - 1e-3 * abs(a),
              f"the SOC objective fell across rounds: {objs}")
    check(hist[-1][2] < hist[0][2] / 10,
          f"the last round's violation {hist[-1][2]} is not below a "
          f"tenth of the first's {hist[0][2]}")
    # the refined EF by the port's own f64 EF, warm from the last round
    t = time.time()
    ef = ExtensiveForm(dict(SOC_EF_OPTS), list(b2.tree.scen_names),
                       batch=b2)
    res = ef.solve_extensive_form(certify=False, x0=last["x"],
                                  y0=last["y"])
    torch.cuda.synchronize()
    ef_s = time.time() - t
    ef_obj = ef.get_objective_value()
    check(b2.c.dtype == torch.float64 and np.isfinite(ef_obj),
          f"the refined f64 EF objective is {ef_obj}")
    x = res.x.cpu().numpy()
    m = b2.model_meta
    dead = m["soc_alive"] == 0
    dead_max = {k: float(np.abs(x[:, idx][dead]).max(initial=0.0))
                for k, idx in [("cc", m["soc_cc"]), ("ss", m["soc_ss"])]
                + list(_soc_flow_idx(b2).items())}
    check(int(dead.sum()) > 0, "the outage tree has no dead line")
    check(max(dead_max.values()) < 1e-6,
          f"dead lines carry flow or lifted product: {dead_max}")
    # PH on the refined batch, as the JAX test runs it, with its E[obj]
    # after Iter0 and after each iteration
    eobjs = []

    class EobjTrace(Extension):
        def post_iter0(self):
            eobjs.append(float(self.ph.Eobjective(self.ph.state.obj)))

        enditer = post_iter0

    t = time.time()
    ph = PH(dict(SOC_PH_OPTS), list(b2.tree.scen_names), batch=b2,
            extensions=EobjTrace)
    conv, eobj, triv = ph.ph_main()
    xhat_obj, feas = ph.evaluate_xhat(ph.state.xbar)
    torch.cuda.synchronize()
    ph_s = time.time() - t
    check(ph.state.x.device.type == "cuda", "the SOC PH left the card")
    check(ph.iter0_feas_mass == 1.0,
          f"PH's Iter0 feasible mass {ph.iter0_feas_mass}")
    check(np.isfinite(eobj),
          f"PH on the refined batch: E[obj] {eobj}")
    check(abs(eobj - ef_obj) <= SOC_EOBJ_TOL_REL * abs(ef_obj),
          f"PH's E[obj] {eobj} is off the refined EF's {ef_obj}")
    # PH's bracket of the EF objective, on the bounds that certify: an
    # uncertified QP solve masks the trivial bound to -inf, and an
    # x̄ whose evaluation does not certify feasible bounds nothing.
    # Where neither certifies the bracket holds nothing, and the line
    # and stderr say so
    tol = 1e-4 * abs(ef_obj)
    if np.isfinite(triv):
        check(triv <= ef_obj + tol, f"PH's trivial bound {triv} above the "
              f"refined EF objective {ef_obj}")
    if feas:
        check(xhat_obj >= ef_obj - tol, f"PH's x̄ ({xhat_obj}) below the "
              f"refined EF objective {ef_obj}")
    bracket = ("checked" if np.isfinite(triv) and feas else
               "one-sided" if np.isfinite(triv) or feas else "vacuous")
    if bracket != "checked":
        print(f"chip_smoke: soc: PH's bracket of the refined EF objective "
              f"is {bracket} (trivial bound {triv}, x̄ certified "
              f"feasible: {bool(feas)}); E[obj] is held against the f64 "
              f"EF instead", file=sys.stderr, flush=True)
    launches = launch_variants()
    out = {"phase": "soc", "case": SOC_CASE,
           "branching_factors": list(SOC_BF), "soc_cut_slots": SOC_SLOTS,
           "shape": list(b2.A.shape), "dtype": "float64",
           "refine_opts": SOC_REFINE_OPTS, "cuts": SOC_CUTS,
           "refine_s": refine_s, "rounds": rounds,
           "ef_options": SOC_EF_OPTS, "ef_objective_f64": ef_obj,
           "ef_dual_objective": ef.get_dual_bound(), "ef_s": ef_s,
           "ef_iters": int(res.iters),
           "ef_converged": bool(res.converged.all()),
           "ef_pres": float(res.pres.max()), "ef_gap": float(res.gap.max()),
           "dead_lines": int(dead.sum()), "dead_line_max_abs": dead_max,
           "ph_options": SOC_PH_OPTS, "ph_s": ph_s, "ph_conv": conv,
           "ph_eobj": eobj, "ph_trivial_bound": triv,
           "ph_iter0_feas_mass": ph.iter0_feas_mass,
           "ph_xhat_obj": xhat_obj, "ph_xhat_feasible": bool(feas),
           "ph_bracket": bracket, "ph_eobj_by_iteration": eobjs,
           "eobj_vs_ef_rel": abs(eobj - ef_obj) / max(1.0, abs(ef_obj)),
           "eobj_tol_rel": SOC_EOBJ_TOL_REL,
           "ph_iterations": int(ph.state.it), "bracket_tol_rel": 1e-4,
           "launches": launches,
           "cluster_launches": cluster_launches(launches),
           "matmul_chunks": pdhg.matmul_chunks,
           "consensus_chunks": pdhg.consensus_chunks,
           "s": time.time() - t0}
    emit(out)
    return out


def ws_oracle(b):
    """The wait-and-see value sum_s p_s min f_s by HiGHS, scenario by
    scenario, in float64 (a plain reference for the seeded cut)."""
    from scipy.optimize import linprog

    def host(t):
        return t.detach().cpu().double().numpy()

    A, c, lb, ub = host(b.A), host(b.c), host(b.lb), host(b.ub)
    lo, hi, prob = host(b.row_lo), host(b.row_hi), host(b.prob)
    total = 0.0
    for s in range(b.num_scens):
        eq = lo[s] == hi[s]
        up = ~eq & np.isfinite(hi[s])
        dn = ~eq & np.isfinite(lo[s])
        res = linprog(c[s], A_ub=np.vstack([A[s][up], -A[s][dn]]),
                      b_ub=np.concatenate([hi[s][up], -lo[s][dn]]),
                      A_eq=A[s][eq], b_eq=lo[s][eq],
                      bounds=list(zip(lb[s], ub[s])), method="highs")
        check(res.status == 0, f"HiGHS failed on scenario {s}")
        total += prob[s] * res.fun
    return float(total)


def cross_scen_phase():
    """Cross-scenario cuts on the card: wheel_row's farmer batch with
    the capacity added, a PH hub with CrossScenarioExtension, the cut
    spoke and an xhat-shuffle spoke, interleaved: cuts installed, the
    seeded cut's trivial bound against the wait-and-see value by HiGHS,
    the bounds around the HiGHS EF optimum."""
    from mpisppy_tpu_torch.cylinders.cross_scen_spoke import (
        CrossScenarioCutSpoke)
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
        XhatShuffleInnerBound)
    from mpisppy_tpu_torch.extensions.cross_scen_extension import (
        CrossScenarioExtension)
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.utils.cross_scenario import (
        add_cross_scenario_capacity, cross_meta)
    from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
    t0 = time.time()
    names = farmer.scenario_names_creator(WHEEL_S)
    base = farmer.build_batch(WHEEL_S, dtype=np.float32)
    opts = dict(WHEEL_OPTS, PHIterLimit=CROSS_PH_ITERS)
    hub_dict = {"hub_class": PHHub,
                "hub_kwargs": {"options": dict(WHEEL_HUB_OPTS)},
                "opt_class": PH,
                "opt_kwargs": {"options": dict(opts),
                               "all_scenario_names": names,
                               "batch": add_cross_scenario_capacity(
                                   base, max_cuts=CROSS_MAX_CUTS,
                                   eta_weight=CROSS_W),
                               "extensions": CrossScenarioExtension}}
    spoke_dicts = [
        {"spoke_class": cls, "spoke_kwargs": {"options": {}},
         "opt_class": Xhat_Eval,
         "opt_kwargs": {"options": dict(opts), "all_scenario_names": names,
                        "batch": base}}
        for cls in (CrossScenarioCutSpoke, XhatShuffleInnerBound)]
    ws, row = spin_wheel(hub_dict, spoke_dicts, "interleaved")
    opt = ws.spcomm.opt
    n_cuts = opt.extobject.n_cuts
    highs, _ = ef_lp_oracle(farmer.build_batch(WHEEL_S))
    ws_value = ws_oracle(farmer.build_batch(WHEEL_S))
    check(n_cuts > 1, f"{n_cuts} cuts installed (the seeded one only)")
    check(cross_meta(opt.batch)["n_cuts"] == n_cuts,
          "the batch's cut rows disagree with the extension's count")
    check(abs(opt.trivial_bound - ws_value) <= 1e-4 * abs(ws_value),
          f"the seeded cut's trivial bound {opt.trivial_bound} is not "
          f"the wait-and-see value {ws_value}")
    tol = CORPUS_BRACKET_TOL_REL * abs(highs)
    check(row["best_outer"] <= highs + tol
          and row["best_inner"] >= highs - tol,
          f"cross-scenario bounds [{row['best_outer']}, "
          f"{row['best_inner']}] do not bracket the HiGHS optimum {highs}")
    out = {"phase": "cross_scen", "S": WHEEL_S, "dtype": "float32",
           "max_cuts": CROSS_MAX_CUTS, "eta_weight": CROSS_W,
           "options": opts, "hub_options": WHEEL_HUB_OPTS,
           "cuts": {"PHIterLimit": {"wheel_row": WHEEL_OPTS["PHIterLimit"],
                                    "here": CROSS_PH_ITERS,
                                    "before the script needed the time":
                                        20, "before the new phases gave "
                                        "time back": 3}},
           "n_cuts": n_cuts, "trivial_bound": opt.trivial_bound,
           "wait_and_see_highs": ws_value, "highs_optimum": highs,
           "bracket_tol_rel": CORPUS_BRACKET_TOL_REL,
           "launches": launch_variants(), **row, "s": time.time() - t0}
    emit(out)
    return out


def _proc_dicts(names, opts, hub_opts):
    """wheel_row's dicts (wheel_row_dicts) with `hub_opts` and the
    "proc" spec from which each child rebuilds wheel_row's batch."""
    from mpisppy_tpu_torch.models import farmer
    hub_dict, spoke_dicts = wheel_row_dicts(
        names, farmer.build_batch(WHEEL_S, dtype=np.float32), opts)
    hub_dict["hub_kwargs"]["options"] = hub_opts
    spec = {"module": "mpisppy_tpu_torch.models.farmer",
            "builder": "build_batch",
            "kwargs": {"num_scens": WHEEL_S, "dtype": "float32"}}
    for sd in spoke_dicts:
        sd["proc"] = {"batch": spec}
    return hub_dict, spoke_dicts


def _child_launches(ws):
    """The children's kernel launches from their info files, by form."""
    import collections
    by_form, shapes = collections.Counter(), collections.Counter()
    for info in ws.child_info:
        for form, S_, M, N, dt, n in (info or {}).get("kernel_launches", ()):
            by_form[form] += n
            shapes[(form, S_, M, N, dt)] += n
    return by_form, shapes


def wheel_multiproc_phase(wrow):
    """Multiproc mode on the card: wheel_row's hub here, its Lagrangian
    and xhat-shuffle spokes as child processes on the card over the
    native windows (telemetry on, phase timing off); then a supervised
    run whose only spoke chaos crashes twice and is pruned."""
    import torch

    from mpisppy_tpu_torch import telemetry
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.resilience import wheel_counters
    from mpisppy_tpu_torch.runtime import native
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
    t0 = time.time()
    check(native.available(), "the native exchange library is unavailable")
    names = farmer.scenario_names_creator(WHEEL_S)
    d = MULTIPROC_TELEMETRY_DIR
    shutil.rmtree(d, ignore_errors=True)
    opts = dict(WHEEL_OPTS, telemetry={"enabled": True, "dir": d,
                                       "phase_timing": False})
    hub_dict, spoke_dicts = _proc_dicts(
        names, opts, dict(WHEEL_HUB_OPTS, **MULTIPROC_HUB_OPTS))
    telemetry.reset()
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    try:
        ws = WheelSpinner(hub_dict, spoke_dicts, mode="multiproc").spin()
        torch.cuda.synchronize()
    finally:
        telemetry.reset()
    wall = time.time() - t
    hub = ws.spcomm
    hub_by_form = pdhg_chunk.launches_by("form")
    child_by_form, child_shapes = _child_launches(ws)
    for h in hub.spokes:
        check(h.proc is not None and h.proc.returncode == 0,
              f"spoke process {h.spoke_name} ended with "
              f"{getattr(h.proc, 'returncode', None)}")
    devices = [(i or {}).get("device", "") for i in ws.child_info]
    check(all(dv.startswith("cuda") for dv in devices),
          f"the children ran on {devices}, not the card")
    check(all((i or {}).get("forbidden_modules") == [] for i in
              ws.child_info), "a child loaded JAX or the JAX package")
    check(sum(child_by_form.values()) > 0,
          "the children launched the kernel no time")
    outer, inner = float(ws.BestOuterBound), float(ws.BestInnerBound)
    opt = wrow["ef_optimum_f64"]
    tol = 1e-5 * abs(opt)
    check(outer <= opt + tol and inner >= opt - tol,
          f"multiproc bounds [{outer}, {inner}] do not bracket the "
          f"farmer-{WHEEL_S} optimum {opt}")
    check(wheel_counters(ws) == {"spoke_restarts": 0, "spokes_failed": 0},
          f"resilience counters {wheel_counters(ws)}")
    with open(os.path.join(d, "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    rows = {e["pid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    labels = sorted(rows.values())
    spans = {}
    for e in evs:
        if e["ph"] == "X":
            key = rows.get(e["pid"], e["pid"])
            spans[key] = spans.get(key, 0) + 1
    for i, h in enumerate(hub.spokes):
        lab = f"spoke{i}:{h.spoke_name}"
        check(lab in labels and spans.get(lab, 0) > 0,
              f"the trace has no row with spans for {lab}: {labels}")
    supersteps = hub.current_iteration()
    gap = abs(inner - outer) / max(1.0, abs(inner))
    out = {"phase": "wheel_multiproc", "S": WHEEL_S, "dtype": "float32",
           "options": opts,
           "hub_options": dict(WHEEL_HUB_OPTS, **MULTIPROC_HUB_OPTS),
           "exchange_backend": ws.exchange_backend_used, "wall_s": wall,
           "ready_wait_s": ws.ready_wait_s, "hub_loop_s": ws.hub_loop_s,
           "supersteps": supersteps,
           # the whole spin over its supersteps: the span of wheel_row's
           # threads-mode figure (spin_wheel), start-up and shutdown in
           "s_per_superstep": wall / supersteps,
           "s_per_superstep_threads_wheel_row": wrow["s_per_superstep"],
           # the hub's loop alone, after its children attached
           "s_per_superstep_hub_loop": ws.hub_loop_s / supersteps,
           "best_outer": outer, "best_inner": inner, "rel_gap": gap,
           "certified": gap <= WHEEL_HUB_OPTS["rel_gap"],
           "ef_optimum_f64": opt, "child_devices": devices,
           "launches_by_form_hub": hub_by_form,
           "launches_by_form_children": dict(child_by_form),
           "launch_shapes_children": [
               {"form": k[0], "S": k[1], "M": k[2], "N": k[3],
                "dtype": k[4], "launches": n}
               for k, n in sorted(child_shapes.items())],
           "launch_shapes_hub": launch_table(),
           "trace_rows": labels, "spans_per_row": spans}
    emit(out)

    # the supervised run: the Lagrangian child hard-exits at its third
    # step, is restarted once, dies again and is pruned
    class UntilPruned(PHHub):
        def setup_hub(self):
            super().setup_hub()
            self._t0 = time.monotonic()

        def is_converged(self):
            super().is_converged()
            if self.supervisor is not None and self.supervisor.spokes_failed:
                return True
            time.sleep(0.02)
            return time.monotonic() - self._t0 > MULTIPROC_CHAOS_WALL_S

    hub_dict, spoke_dicts = _proc_dicts(
        names, dict(WHEEL_OPTS, PHIterLimit=10 ** 6),
        dict(MULTIPROC_CHAOS_HUB_OPTS))
    hub_dict["hub_class"] = UntilPruned
    # the Lagrangian spoke alone, with the chaos crash
    spoke_dicts = spoke_dicts[:1]
    spoke_dicts[0]["spoke_kwargs"] = {"options": {"chaos": MULTIPROC_CHAOS}}
    t = time.time()
    ws = WheelSpinner(hub_dict, spoke_dicts, mode="multiproc").spin()
    chaos_wall = time.time() - t
    hub = ws.spcomm
    sup = hub.supervisor
    check(sup.spoke_restarts == 1 and sup.spokes_failed == 1,
          f"restarts {sup.spoke_restarts}, pruned {sup.spokes_failed}")
    check([r["rc"] for r in sup.exit_reports] == [13, 13],
          f"exit reports {sup.exit_reports}")
    check(hub.failed_spokes and hub.failed_spokes[0][0]
          == "LagrangianOuterBound", f"failed spokes {hub.failed_spokes}")
    check(wheel_counters(ws) == {"spoke_restarts": 1, "spokes_failed": 1},
          f"resilience counters {wheel_counters(ws)}")
    outer = float(ws.BestOuterBound)
    check(np.isfinite(outer) and outer <= opt + tol,
          f"the hub's outer bound {outer} after the prune is not valid")
    shutil.rmtree(ws.workdir, ignore_errors=True)
    chaos = {"phase": "wheel_multiproc_chaos", "chaos": MULTIPROC_CHAOS,
             "hub_options": MULTIPROC_CHAOS_HUB_OPTS, "wall_s": chaos_wall,
             "supersteps": hub.current_iteration(),
             "spoke_restarts": sup.spoke_restarts,
             "spokes_failed": sup.spokes_failed,
             "exit_codes": [r["rc"] for r in sup.exit_reports],
             "incarnations": [r["incarnation"] for r in sup.exit_reports],
             "best_outer": outer, "wheel_counters": wheel_counters(ws),
             "s": time.time() - t0}
    emit(chaos)
    return out


def checkpoint_phase():
    """Run checkpoints on the card: farmer PH in f64 at wheel_row's
    size, two uninterrupted runs (they must agree), a run chaos crashes
    after iteration CKPT_CRASH_AT's checkpoint, and its resume, whose
    W, x̄ and conv must equal the uninterrupted run's (1e-9)."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ph import PH
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.resilience.chaos import ChaosError
    t0 = time.time()
    names = farmer.scenario_names_creator(WHEEL_S)
    os.makedirs(os.path.dirname(CKPT_PATH), exist_ok=True)
    for f in (CKPT_PATH + ".npz", CKPT_PATH + ".npz.tmp"):
        if os.path.exists(f):
            os.remove(f)

    def run(extra=None):
        ph = PH(dict(CKPT_OPTS, **(extra or {})), names,
                batch=farmer.build_batch(WHEEL_S))
        t = time.time()
        try:
            ph.ph_main(finalize=False)
            crashed = None
        except ChaosError as e:
            crashed = str(e)
        torch.cuda.synchronize()
        return ph, time.time() - t, crashed

    torch.cuda.synchronize()
    reset_counts()
    a, a_s, _ = run()
    a2, a2_s, _ = run()

    def diff(p, q):
        return {f: float((getattr(p.state, f) - getattr(q.state, f))
                         .abs().max())
                for f in ("W", "xbar", "x", "y")} | {
            "conv": abs(float(p.state.conv) - float(q.state.conv))}

    def close(p, q):
        return all(torch.allclose(getattr(p.state, f), getattr(q.state, f),
                                  rtol=1e-9, atol=1e-9)
                   for f in ("W", "xbar")) and \
            abs(float(p.state.conv) - float(q.state.conv)) \
            <= 1e-8 * abs(float(q.state.conv)) + 1e-12
    replay = diff(a2, a)
    check(close(a2, a), f"two uninterrupted runs differ: {replay}")
    b, b_s, crashed = run({"run_checkpoint": CKPT_PATH,
                           "chaos": {"crash_at_iter": CKPT_CRASH_AT}})
    check(crashed is not None and f"iter {CKPT_CRASH_AT}" in crashed,
          f"the chaos crash did not fire: {crashed}")
    saved_it = int(np.load(CKPT_PATH + ".npz")["it"])
    check(saved_it == CKPT_CRASH_AT, f"the checkpoint holds it={saved_it}")
    c, c_s, _ = run({"resume_from": CKPT_PATH})
    check(int(c.state.it) == int(a.state.it) == CKPT_OPTS["PHIterLimit"],
          f"the resumed run ended at it={int(c.state.it)}")
    resumed = diff(c, a)
    check(close(c, a) and c.trivial_bound == a.trivial_bound,
          f"the resumed run differs from the uninterrupted one: {resumed}")
    check(a.state.x.device.type == "cuda", "the checkpoint runs left the card")
    out = {"phase": "checkpoint", "S": WHEEL_S, "dtype": "float64",
           "options": CKPT_OPTS, "crash_at_iter": CKPT_CRASH_AT,
           "uninterrupted_s": [a_s, a2_s], "crashed_s": b_s,
           "resumed_s": c_s, "max_abs_diff_two_uninterrupted": replay,
           "two_uninterrupted_bitwise_equal": max(replay.values()) == 0.0,
           "max_abs_diff_resumed": resumed, "tol": 1e-9,
           "checkpoint_bytes": os.path.getsize(CKPT_PATH + ".npz"),
           "launches_by_form": pdhg_chunk.launches_by("form"),
           "launch_shapes": launch_table(), "s": time.time() - t0}
    emit(out)
    return out


def start_second_process():
    """Start the second process on the same card (this script with
    SECOND_PROCESS_FLAG, see second_process), its lines going to
    SECOND_PROCESS_OUT.  Its phases are host-bound; run beside the main
    process's later phases they take little time of their own from the
    script's limit.  It runs at a lower CPU priority with one host
    thread per library, so that the main process keeps its cores."""
    os.makedirs(os.path.dirname(SECOND_PROCESS_OUT), exist_ok=True)
    env = dict(os.environ, **{k: "1" for k in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
    with open(SECOND_PROCESS_OUT, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), SECOND_PROCESS_FLAG,
             str(os.getpid())], stdout=fh, env=env)
    return proc, time.time()


def join_second_process(child):
    """Wait for the second process, copy its lines to this process's
    output, and return its lines by phase; the `corpus` line gains
    `launched`, the launches of the corpus sub-runs by (form, M, N,
    dtype).  Fails if the process failed or a phase's line is
    missing."""
    import collections
    proc, t0 = child
    t = time.time()
    try:
        rc = proc.wait(timeout=SECOND_PROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    waited = time.time() - t
    by_phase = {}
    with open(SECOND_PROCESS_OUT) as fh:
        for line in fh:
            sys.stdout.write(line)
            if line.startswith('{"phase": '):
                d = json.loads(line)
                by_phase[d["phase"]] = d
    sys.stdout.flush()
    check(rc == 0, f"the second process ended with {rc} (stderr above)")
    for phase in ("corpus", "algorithms", "soc", "cross_scen", "child"):
        check(phase in by_phase, f"the second process printed no {phase} "
              "line")
    for phase in ("corpus", "algorithms"):
        d = by_phase[phase]
        d["launched"] = collections.Counter({
            (r["form"], r["M"], r["N"], r["dtype"]): r["launches"]
            for r in d["launches_by_form_shape_dtype"]})
    by_phase["child"]["waited_s"] = waited
    by_phase["child"]["until_joined_s"] = time.time() - t0
    return by_phase


def second_process(parent_pid):
    """The second process of main(): the corpus phase, the ALG_CHILD
    algorithms, soc and cross_scen, each as main() ran them before
    (counts zeroed just before each path); the kernel library is the
    one main()'s build phase built.
    Its last line is `child` with its wall.  It is killed when main()'s
    process ends (PR_SET_PDEATHSIG), so that no run outlives the
    script."""
    import ctypes
    import signal

    import torch
    t_all = time.time()
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG
    check(os.getppid() == parent_pid, "the main process has ended")
    check(torch.cuda.is_available(), "the second process sees no card")
    os.nice(SECOND_PROCESS_NICE)
    torch.set_num_threads(1)
    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.ops import pdhg_chunk
    disable_tictoc_output()
    pdhg_chunk.load_library()
    for name, fn in (("corpus", corpus_phase),
                     ("algorithms", algorithms_phase),
                     ("soc", soc_phase), ("cross_scen", cross_scen_phase)):
        t = time.time()
        fn()
        emit({"phase": f"{name}_done", "s": time.time() - t})
    emit({"phase": "child", "s": time.time() - t_all})
    return 0


def golden_phase():
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ph import PH
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 200, "convthresh": 1e-5,
            "pdhg_eps": 1e-7}
    ph = PH(opts, [f"scen{i}" for i in range(3)],
            batch=farmer.build_batch(3))
    conv, eobj, triv = ph.ph_main()
    xbar = ph.root_xbar().cpu().numpy()
    check(ph.state.x.device.type == "cuda", "golden run left the card")
    check(abs(eobj - -108390.0) < 20.0, f"E[obj] {eobj} != -108390 +- 20")
    check(np.allclose(xbar, [170.0, 80.0, 250.0], atol=0.5),
          f"xbar {xbar} != (170, 80, 250)")
    check(abs(triv - -115405.55) < 5.0, f"trivial bound {triv}")
    out = {"phase": "golden", "eobj": eobj, "trivial_bound": triv,
           "xbar": xbar.tolist(), "conv": conv,
           "ph_iterations": int(ph.state.it)}
    emit(out)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    t_all = time.time()
    from mpisppy_tpu_torch import disable_tictoc_output
    disable_tictoc_output()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    t = time.time()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": name, "nvidia_smi": smi, "s": time.time() - t})
    build_phase()
    t = time.time()
    rows = kernel_phase(name)
    emit({"phase": "kernel_done", "s": time.time() - t})
    t = time.time()
    sl = slice_phase()
    emit({"phase": "slice_done", "s": time.time() - t})
    t = time.time()
    bx = bf16x_phase()
    emit({"phase": "bf16x_done", "s": time.time() - t})
    t = time.time()
    sp = split_phase()
    emit({"phase": "split_done", "s": time.time() - t})
    t = time.time()
    ts = true_size_phase(name, sp["gap_loop"])
    emit({"phase": "true_size_done", "s": time.time() - t})
    # the corpus phase runs in a second process from here on, beside
    # the phases below (the kernel rows and the phases above are timed
    # alone on the card)
    child = start_second_process()
    try:
        kernels_line = main_after_true_size(t_all, rows, sl, bx, sp, ts,
                                            child)
    finally:
        if child[0].poll() is None:
            child[0].kill()
            child[0].wait()
    emit(kernels_line)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _launched(rows, form, M, N, dtype):
    """The launches of `rows` (launch_table / launch_variants rows) of
    `form` at (M, N) in `dtype`, at any S."""
    return sum(r["launches"] for r in rows
               if (r["form"], r["M"], r["N"], r["dtype"])
               == (form, M, N, dtype))


def main_after_true_size(t_all, rows, sl, bx, sp, ts, child):
    """main()'s phases from uc on, the second process's join, and the
    kernels line (returned)."""
    t = time.time()
    uc_phase()
    emit({"phase": "uc_done", "s": time.time() - t})
    t = time.time()
    wrow, wsplit = wheel_phase()
    emit({"phase": "wheel_done", "s": time.time() - t})
    t = time.time()
    drv, _, _ = driver_phase(wrow, wsplit)
    emit({"phase": "driver_done", "s": time.time() - t,
          "total_s": time.time() - t_all})
    t = time.time()
    alg_main = algorithms_phase(ALG_MAIN, "algorithms_main")
    emit({"phase": "algorithms_main_done", "s": time.time() - t,
          "total_s": time.time() - t_all})
    t = time.time()
    mp = wheel_multiproc_phase(wrow)
    emit({"phase": "wheel_multiproc_done", "s": time.time() - t,
          "total_s": time.time() - t_all})
    t = time.time()
    ck = checkpoint_phase()
    emit({"phase": "checkpoint_done", "s": time.time() - t,
          "total_s": time.time() - t_all})
    # the compact phase, the uc fallback pass, sslp and the golden ran in
    # the second process until soc and cross_scen joined it there
    t = time.time()
    cp = compact_phase(ts["iter0"])
    ucf = uc_fallback_pass()
    sslp_phase()
    golden_phase()
    emit({"phase": "compact_ucf_sslp_golden_done", "s": time.time() - t,
          "total_s": time.time() - t_all})
    second = join_second_process(child)
    corpus, alg = (second[k] for k in ("corpus", "algorithms"))
    alg_launched = alg["launched"] + alg_main["launched"]
    for case, shape, _ in ALG_KERNEL_CASES:
        check(alg_launched[("dense", shape[1], shape[2], "float32")] > 0,
              f"the dense form at {case}'s {shape} launched no time on "
              "the algorithms path")
    # these paths run the cluster kernel: each sub-run's count, zeroed
    # just before it ran
    through = {"alg_fwph": alg["cluster_launches"]["alg_fwph"],
               "alg_bundles": alg["cluster_launches"]["alg_bundles"],
               "corpus_acopf3":
                   corpus["cluster_launches"]["corpus_acopf3"],
               "uc_fallback": ucf["cluster_launches"]}
    for path, n in through.items():
        check(n > 0, f"{path} launched the cluster kernel no time")
    emit({"phase": "second_process_done", "s": second["child"]["s"],
          "waited_s": second["child"]["waited_s"],
          "total_s": time.time() - t_all})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "kernel", "cluster", "blocks_per_sm",
            "active_clusters", "waves")
    # launches: the dense form's on the slice phase (path of the dense
    # prep), its bf16 storage's on the bf16x phase, the shared and split
    # forms' on the split phase, the shared form at UC's (1, 174, 114)
    # on the UC fallback pass; each count was zeroed just before its
    # path ran
    launched = {"dense": (sl["kernel_launches"],
                          bx["launches_by_dtype"].get("bfloat16", 0)),
                "shared": (sp["launches_by_form"].get("shared", 0),
                           None),
                "split": (sp["launches_by_form"].get("split", 0), None),
                "shared_uc": (ucf["shared_174x114_launches"], None)}
    kernels = []
    for form in ("dense", "shared", "split", "shared_uc"):
        f32 = rows[(form, "float32")]
        entry = {
            "name": "pdhg_chunk" if form == "dense"
            else f"pdhg_chunk_{form}",
            "route": "cuda",
            "source": "mpisppy_tpu_torch/csrc/pdhg_chunk.cu",
            "replaces": "mpisppy_tpu/ops/pallas_pdhg.py:106",
            "launches": launched[form][0],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a chunk of "
                            "PDHG steps",
            "form": f32["form"], "dtype": "float32",
            "shape": [f32["S"], f32["M"], f32["N"]],
            "variant_source": f32["variant"]["source"],
            "share_of_bound": f32["share_of_bound"],
            **{k: f32[k] for k in CLUSTER_KEYS},
            "f64": {k: rows[(form, "float64")][k] for k in keys},
            "bf16": {k: rows[(form, "bfloat16")][k] for k in keys}}
        if form != "dense":
            entry["max_abs_err_vs_dense_kernel"] = {
                d: rows[(form, d)]["max_abs_err_vs_dense_kernel"]
                for d in ("float32", "float64", "bfloat16")}
        else:
            entry["bf16"]["launches"] = launched[form][1]
        # its launches in the wheel_split run, read from that run's
        # counts (for shared_uc: the shared form at UC's M=174, N=114)
        entry["launches_wheel"] = (
            sum(r["launches"] for r in wsplit["launch_shapes"]
                if r["form"] == "shared" and (r["M"], r["N"]) == (174, 114))
            if form == "shared_uc"
            else wsplit["launches_by_form"].get(form, 0))
        # its launches in the driver phase's cylinders run, counted
        # there (for shared_uc: the shared form at M=174, N=114)
        entry["launches_driver"] = (
            sum(r["launches"] for r in drv["launch_shapes"]
                if r["form"] == "shared" and (r["M"], r["N"]) == (174, 114))
            if form == "shared_uc"
            else drv["launches_by_form"].get(form, 0))
        # its launches in the compact phase's compacted run, counted
        # there (for shared_uc: the shared form at M=174, N=114)
        entry["launches_compact"] = (
            sum(r["launches"] for r in cp["launch_shapes_compacted"]
                if r["form"] == "shared" and (r["M"], r["N"]) == (174, 114))
            if form == "shared_uc"
            else cp["launches_by_form_compacted"].get(form, 0))
        slab = rows.get((form + "_compacted", "float32"))
        if slab is not None:
            # the same form on a slab gathered to COMPACT_S rows
            entry["compacted_slab"] = {
                k: slab[k] for k in ("S", "max_abs_err", "max_rel_err",
                                     "ms", "plain_ms", "bound_ms",
                                     "bound_by", "share_of_bound",
                                     "blocks_per_sm", "waves")}
        check(entry["launches"] > 0, f"the {form} form launched no time "
              f"on its path")
        kernels.append(entry)
    # the dense form's variants that the corpus phase puts on a path,
    # with their launches there (the dense form at the row's M, N)
    rkeys = keys + ("variant", "nonzero_qs", "S", "M", "N")
    for case, _, expect, _ in _corpus_kernel_cases():
        if expect[0] is None:
            continue
        f32, f64 = rows[(case, "float32")], rows[(case, "float64")]
        n32, n64 = (corpus["launched"][("dense", f32["M"], f32["N"], d)]
                    for d in ("float32", "float64"))
        entry = {
            "name": f"pdhg_chunk_{case}", "route": "cuda",
            "source": "mpisppy_tpu_torch/csrc/pdhg_chunk.cu",
            "replaces": "mpisppy_tpu/ops/pallas_pdhg.py:106",
            "launches": n32,
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a chunk of "
                            "PDHG steps",
            "form": "dense", "dtype": "float32",
            "shape": [f32["S"], f32["M"], f32["N"]],
            "variant_source": f32["variant"]["source"],
            "share_of_bound": f32["share_of_bound"],
            **{k: f32[k] for k in CLUSTER_KEYS},
            "nonzero_qs": f32["nonzero_qs"],
            "f64": {**{k: f64[k] for k in rkeys}, "launches": n64}}
        certify = rows.get((case + "_certify", "float64"))
        if certify is not None:
            # the f64 certify's re-solve at S'=4 (its launches are the
            # f64 ones above: the path's counts are by (M, N))
            entry["f64_certify"] = {k: certify[k] for k in rkeys}
        check(n32 > 0, f"the dense form at {case}'s (M, N) = "
              f"({f32['M']}, {f32['N']}) launched no time in f32 on the "
              "corpus path")
        kernels.append(entry)
    # the dense form at the algorithms' new shapes, with their launches
    # on the algorithms path (FWPH's hull QP, aircondB's bundles)
    for case, shape, _ in ALG_KERNEL_CASES:
        f32 = rows[(case, "float32")]
        n32 = alg_launched[("dense", shape[1], shape[2], "float32")]
        entry = {
            "name": f"pdhg_chunk_{case}", "route": "cuda",
            "source": "mpisppy_tpu_torch/csrc/pdhg_chunk.cu",
            "replaces": "mpisppy_tpu/ops/pallas_pdhg.py:106",
            "launches": n32,
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a chunk of "
                            "PDHG steps",
            "form": "dense", "dtype": "float32", "shape": list(shape),
            "variant_source": f32["variant"]["source"],
            "share_of_bound": f32["share_of_bound"],
            **{k: f32[k] for k in CLUSTER_KEYS}}
        f64 = rows.get((case, "float64"))
        if f64 is not None:
            entry["f64"] = {**{k: f64[k] for k in keys + ("variant",)},
                            "launches": alg_launched[
                                ("dense", shape[1], shape[2], "float64")]}
        check(n32 > 0, f"the dense form at {case}'s {shape} launched no "
              "time in f32 on the algorithms path")
        kernels.append(entry)
    # the rows of the new paths, each with its path's launches (counted from
    # zero on that path): the multiproc hub and children (f32) and the
    # checkpoint runs (f64) at wheel_row's split shape, the
    # cross-scenario hub's augmented dense batch, the SOC PH (f64)
    soc, cross = second["soc"], second["cross_scen"]
    mp_rows = mp["launch_shapes_hub"] + mp["launch_shapes_children"]
    new_paths = {"wheel_multiproc": mp_rows,
                 "checkpoint": ck["launch_shapes"],
                 "cross_scen": cross["launches"], "soc": soc["launches"]}
    path_of = {"split_wheel_row": ("wheel_multiproc", "checkpoint"),
               "dense_cross_scen": ("cross_scen", "cross_scen"),
               "qs_soc_ieee14": ("soc", "soc")}
    for case, form, _ in NEW_PATH_KERNEL_CASES:
        f32, f64 = rows[(case, "float32")], rows[(case, "float64")]
        n32, n64 = (_launched(new_paths[path], form, r["M"], r["N"], d)
                    for path, r, d in zip(path_of[case], (f32, f64),
                                          ("float32", "float64")))
        main_row, n_main, main_dt = ((f64, n64, "float64")
                                     if case == "qs_soc_ieee14"
                                     else (f32, n32, "float32"))
        other = f32 if main_row is f64 else f64
        entry = {
            "name": f"pdhg_chunk_{case}", "route": "cuda",
            "source": "mpisppy_tpu_torch/csrc/pdhg_chunk.cu",
            "replaces": "mpisppy_tpu/ops/pallas_pdhg.py:106",
            "launches": n_main,
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a chunk of "
                            "PDHG steps",
            "form": form, "dtype": main_dt,
            "shape": [main_row["S"], main_row["M"], main_row["N"]],
            "variant_source": main_row["variant"]["source"],
            "share_of_bound": main_row["share_of_bound"],
            **{k: main_row[k] for k in CLUSTER_KEYS},
            "nonzero_qs": main_row["nonzero_qs"],
            "launched_on": path_of[case],
            "f64" if main_dt == "float32" else "f32": {
                **{k: other[k] for k in keys + ("variant",)},
                "launches": n64 if main_dt == "float32" else n32}}
        check(n_main > 0, f"the {form} form at {case}'s (M, N) = "
              f"({main_row['M']}, {main_row['N']}) launched no time in "
              f"{main_dt} on {path_of[case][0]}")
        if case == "split_wheel_row":
            check(n64 > 0, "the split form at wheel_row's shape launched "
                  "no time in f64 on the checkpoint runs")
        kernels.append(entry)
    through["soc"] = soc["cluster_launches"]
    check(through["soc"] > 0, "soc launched the cluster kernel no time")
    # every entry: its form's launches at any shape on the new paths
    for e in kernels:
        e["launches_new_paths_by_form"] = {
            path: sum(r["launches"] for r in rs if r["form"] == e["form"])
            for path, rs in new_paths.items()}
    # the cluster kernel's launches on the paths that must run it, on the
    # rows of their shapes
    for e in kernels:
        path = {"pdhg_chunk_shared_uc": "uc_fallback",
                "pdhg_chunk_qs_ieee14": "corpus_acopf3",
                "pdhg_chunk_hull_qp_fwph": "alg_fwph",
                "pdhg_chunk_bundles_aircondB": "alg_bundles",
                "pdhg_chunk_qs_soc_ieee14": "soc"}.get(e["name"])
        if path is not None:
            e["cluster_kernel_launches"] = {path: through[path]}
    return {"kernels": kernels}


if __name__ == "__main__":
    sys.exit(second_process(int(sys.argv[2]))
             if sys.argv[1:2] == [SECOND_PROCESS_FLAG] else main())
