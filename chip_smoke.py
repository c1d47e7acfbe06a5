#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile every CUDA kernel of the paths (one nvcc each, in
               parallel) into waveflow_tpu_torch/build/;
  3. kernels — hold each kernel against its plain PyTorch version on the
               card at the main paths' shapes and at ragged sizes, and time
               kernel (back-to-back calls, and the kernel alone by the
               profiler's device time), plain version and (where one
               exists) a single library call: K1 sampler 'squared' and K3
               basis jet at the flagship's shapes (K3 also at the batch
               sweep's, K3_TIMED_SITES), K2 sampler 'linear' and
               K4 table-lerp evaluation with its backward kernel at the
               density model's (K4 also at ragged sizes, on a table of 13
               bases and on unaligned views); K1 also on
               a table too large for shared memory (the streamed regime)
               and on meshes that take the kernel's other branches, and
               on the big ansatz's 36-base prior table (``streamed_k1``,
               the studies phase's rows);
               print each kernel's launch plan at those shapes;
  4. checkpoint — load the committed JAX flagship checkpoint, draw 65,536
               ancestral walkers and compute the raw mean local energy,
               which must lie within 5 combined stderr of the JAX
               evaluation's raw mean (results/round5_quality.json);
  5. training — VMCTrainer at the flagship config with the CUDA basis-jet
               backend, 2 windows of 100 epochs at batch 256, each window
               a replayed CUDA graph of one epoch; every loss finite, K1
               and K3 launched on that run; 10 replayed epochs profiled;
     graph-train — the ancestral adam window as a CUDA graph against its
               eager twin (graph=False) from the 100k checkpoint, for
               train-256, reference-256 ('reference' + 'dense', right after
               train-256, where its first eager run of a process used to
               part from later ones) and the 'reference' estimator on
               'fwd_batched': turns eager, graph, graph, eager of 2 windows
               of GRAPH_WINDOW epochs (TWIN_WINDOW for the two reference
               twins; CUDA events); losses, parameters,
               Adam state, baseline and generator equal to the bit (or
               within GRAPH_MAX_REL),
               launches per epoch equal; 10 replayed epochs profiled;
  6. evaluation — the 100k checkpoint loaded into a 'poly_pallas' trainer,
               evaluate_trainer at the JAX protocol (4,096 walkers, 250
               warmup sweeps, 64 blocks × 25 sweeps, step 0.4, '1d' sort):
               raw and clipped means within 5 combined stderr of the JAX
               evaluation's, accept rate in [0.45, 0.55], K1 and K3
               launched, through the graphed evaluation; one eager block
               profiled;
     graph-eval — eval-4k graphed against eager, turns graph, eager, graph
               (CUDA events): every field of the evaluation equal to the
               bit (or within GRAPH_MAX_REL), launches equal; 5 replays of
               evaluate_energy's own block graph timed and 5 profiled;
  7. resume  — the 100k checkpoint with its Adam moments, window 10: 2
               windows, save_checkpoint, a fresh trainer's load_checkpoint,
               2 more windows, against 4 windows straight: losses and
               parameters equal to the bit;
  8. metropolis — resume results/he1d_metropolis_seed7 (its 256 walkers)
               with sampler='metropolis' and train one window of 100
               epochs: finite losses, mean accept rate in [0.3, 0.7], K3
               launched; walkers/s beside the ancestral figure;
     graph-metropolis — the Metropolis adam window as a CUDA graph against
               its eager twin from he1d_metropolis_seed7, as graph-train
               but in turns of one window (walkers and accept rates
               compared too);
 46. graph-mala — the adam MALA window from he1d_mala_s3 the same way,
               in turns of one window of TWIN_WINDOW epochs (the drift's reverse
               pass through K3's backward rule inside the capture), with
               each graph phase's capture seconds and graph pool (the
               memory reserved over the capture);
 47. graph-spring — SPRING + ancestral from r4_spring100k as graph-mala,
               K1 and K3 launched by the replays, SPRING's step, skipped
               and fallbacks counters advancing alike in both twins;
 48. graph-sr — SR + ancestral from he1d_sr, turns of one window of
               SR_GRAPH_WINDOW epochs (an eager SR epoch takes ~1.5 s);
 49. graph-natgrad-mcmc — SPRING + MALA from r4_spring100k (as
               graph-mala) and SR + Metropolis from he1d_sr (as graph-sr),
               the walkers warm-started on the trainer's stream;
  9. mala    — he1d_mala_s3 evaluated at the JAX protocol (clipped mean
               within 5 combined stderr of the JAX figure; raw reported),
               then resumed with sampler='mala' for one graphed window of
               100 epochs: finite losses, accept rate in [0.3, 0.7], K3
               launched, walkers/s;
 10. spring, sr — r4_spring100k evaluated (raw and clipped gated) and
               resumed with optimizer='spring' for one graphed window of
               100 epochs (SPRING's skipped / fallbacks counters, K3
               launches per step, 3 replayed epochs profiled); he1d_sr
               resumed with optimizer='sr' for one of 20 (1 more
               profiled);
 11. li      — r5_li_metro_refresh100_s3 (3 electrons) evaluated (raw and
               clipped gated) and resumed for one Metropolis window of 20
               epochs under the 'auto' refresh (K1 launched, 3 columns);
 12. vmap    — K3 under vmap(grad): SPRING's per-walker score matrix at 256
               walkers, kernel against the plain core, one launch per jet
               call, K3's device time in it against its bound;
 13. lap-forms — Hψ of the 100k checkpoint at 4,096 walkers under every
               Laplacian form on the kernel backend ('fwd' per walker,
               'hvp', 'dense' against 'fwd_batched'; eps = 0.1 against the
               plain core), K3 launched by each, launches and ms per pass;
 14. reference-grad — the 'reference' loss's parameter gradient at 256
               walkers, kernel against plain core, under 'fwd_batched' and
               'dense';
 15. reference-256 — the reference design ('reference' + 'dense', adam)
               and 'reference' on 'fwd_batched' from the 100k checkpoint,
               one window of 10 epochs each: finite losses, the baseline
               equal to the window's mean loss, walkers/s, 2 epochs
               profiled;
 16. poly-sample — sampling_backend='poly' at 65,536 walkers: the draws
               against the float64 CDF of the polynomial density, the raw
               mean of one E_L pass against the JAX raw mean; sample times
               and a window of 100 epochs for 'poly' and 'table';
 17. antisym-eval — r5_he2d2e_antisym (the antisymmetrized He-2d-2e, 2!
               permuted copies of φ per walker) at the JAX protocol: raw
               and clipped within 5 combined stderr of the JAX figures,
               accept rate in [0.45, 0.55], K1 (the permuted warm start)
               and K3 launched, K3 at 4 launches per coordinate per Hψ
               pass, peak device memory; fidelity_2d_2e against the
               two-state ED40 subspace within 1e-4 of the JAX figure;
 18. box3-2d-eval — r5_box3_2d_antisym (3 free electrons, 6 permuted
               copies) the same way, beside the analytic energy;
 19. paired2d-eval — r4_he2d2e_lr3e-4_decay (the 'paired2d' x-sorted
               sector, its sector projection) the same way;
 20. h2d-fidelity — results/h_2d (one electron, 'independent' map):
               fidelity_2d_1e against the 120²-grid ED within 1e-4 of the
               JAX figure, the ED energy printed;
 21. graph-antisym — the antisym Metropolis adam window from
               r5_he2d2e_antisym at lr 3e-5 as a CUDA graph against its
               eager twin, as graph-mala (walkers and accept rates to the
               bit too), then one graphed window of 100 epochs;
 22. paired2d-256 — the paired2d ancestral adam window from the r4 run the
               same way (K1 4 launches per epoch, one per column);
 23. k4-vmap (run first in the table) — K4 and its backward under
               torch.func.vmap over chains at
               the parameter posterior's shapes (8 chains and 128 SMC
               particles × 300 points × 2 dims): forward, autograd.grad of
               the vmapped sum and vmap(grad) each 1 + 1 launches, equal to
               a loop of per-chain calls to the bit, within K4's tolerance
               of the plain path under vmap; the posterior gradient 1 + 1
               launches whatever the number of chains;
 24-26. posterior-hmc, posterior-nuts, posterior-smc — the parameter
               posterior of examples/parameter_posterior_torch.py over the
               example MFlow's 10,816 parameters, depth cut (HMC's steps,
               NUTS's trajectory bodies and SMC's temperatures replayed
               CUDA graphs): gradient evaluations per second, ms per step,
               NUTS's replays and host reads per step, tree depth,
               accept, step size, K4 1 + 1 launches per gradient (a
               replay's counted once per replay), the idle share of a
               profiled stretch, held-out LL at init and under the BMA
               (finite, above the init's);
 51-53. graph-posterior-hmc, graph-posterior-smc, graph-density — HMC's
               warm-up and kept steps (8 chains), SMC's temperature (128
               particles) and the density trainer's epoch (MFlow, 20,000
               points) as CUDA graphs against their eager twins from one
               state, in turns eager, graph, graph, eager: everything they
               carry to the bit; ms per replay and per eager step, capture
               s, graph pool MiB, the idle share of a profiled replayed
               turn, K4's launches per replay held to the code's count
               (17 + 17, 5 + 0, 1 + 1); train_density_model graphed
               against eager for Flow, IFlow and RQSFlow; an MFlow
               continued with ``model=`` refused while a kept loss holds
               its parameters' autograd graph, then graphed once it is
               dropped;
 54. graph-posterior-smc-sharded-1 (after posterior-sharded-1) — the SMC
               twin with its particles sharded over the world of one on
               NCCL: the all-gather of the weights and the cross-rank
               resample captured with the temperature, to the bit;
 55. graph-posterior-nuts (after graph-posterior-smc) — NUTS over the
               example posterior (8 chains, max_tree_depth 6) graphed
               against eager in turns of 2 warm-up steps, the step-size
               switch and 2 kept steps: six captures (the step's start, a
               subtree's start, a leaf, a merge, the warm-up and the kept
               end); state, traces, tree depths, leaf counts, accepts,
               replays and host reads per step and the generator to the
               bit; K4 1 + leaves forward and backward launches per step
               on both twins; capture s and pools, ms per gradient,
               chain-gradients/s, replays and host reads per step, the idle
               share per gradient of a profiled turn;
 56. graph-posterior-nuts-sharded-1 (after 54) — the NUTS twin with the
               graph twin's chains sharded over the world of one on NCCL
               (the warm-up end's pmean captured), against the unsharded
               eager twin, to the bit;
 27. nuts-waveflow — HMC and NUTS over He-1d walkers of the 100k
               checkpoint on the sorted sector, 256 chains warm-started at
               K1 ancestral draws, both replayed as CUDA graphs: pooled
               moments within 0.25 of the ancestral ones (JAX's
               test_hmc_stationary_on_waveflow), K3 4 launches per density
               call (replays counted), chain-gradients per second;
 28. density — train_density_model at the full width of the density
               benchmark (MFlow, circles, 20,000 points), 200 epochs with a
               metric checkpoint every 100, each epoch a replayed CUDA
               graph; losses finite and falling, K2
               and both K4 kernels launched on that run, metrics finite,
               the round trip closes, the card agrees with the CPU;
 30. dp-nccl-1 (right after k4-vmap) — the train-256 adam window sharded
               over a world of one process on NCCL (data_parallel=True: the
               clip window's all-gather and the gradient's all-reduce
               captured in the epoch's CUDA graph) against the unsharded
               graphed window from the 100k checkpoint, in turns: equal to
               the bit, launches per epoch equal; the collectives' ms per
               replayed epoch (alternating windows, CUDA events), the NCCL
               events and copies per replayed epoch (profiler);
 31. dp-metropolis-1 — the same for the Metropolis window from
               he1d_metropolis_seed7 (the step size's all-reduce per sweep);
 50. dp-spring-1 (after dp-metropolis-1) — SPRING + ancestral from
               r4_spring100k sharded over the world of one on NCCL, graphed
               against its eager sharded twin as graph-spring (the
               all-gathers, the chunked Gram matrix's all-gathers and the
               update's psum captured), then adam + MALA from he1d_mala_s3
               (the accept fraction's pmean) and SR from he1d_sr (a pmean
               per CG iteration) the same way; NCCL events and copies per
               replayed epoch;
 32. dp-gloo-2 (after nuts-waveflow) — two ranks on the one card over
               gloo, eager, spawned by this script (``--dp-gloo-rank``):
               the sharded clipped-score step, the chunked SPRING Gram and
               update, one Metropolis sweep's step size, each against the
               single-process reference on the 256 gathered walkers; K1
               and K3 launched on both ranks;
 33. posterior-sharded-1 — posterior-hmc with its chains sharded over the
               world of one on NCCL: K4 1 + 1 launches per gradient;
 34-37. be4-eval, box4-eval, li-2d-eval, h2-2d-eval — the committed runs
               r5_be4_interacting, r5_box4_free (1D, n = 4 sorted sector),
               r5_li_2d_antisym and r5_h2_2d2e_antisym (2D antisym; H2's
               fidelity against its ED40) at the JAX protocol, within 5
               combined stderr of results/round5_quality.json;
 38. table-kernels (after k4-vmap) — K4's forward-mode chain for the table
               eval backend on the card against its plain versions on the
               card, at the flagship's OB-prior and I-spline tables: the
               forward kernel in step mode (slope tables; x NaN too), the
               pair entry, the backward kernel with step-mode tables and
               without coefficients, at N = 1 ... 40,001; the jet entry
               (a site's terms over 4 coefficient components in one
               launch) at N = 1 ... 40,001 with x at 0, 1, outside [0, 1]
               and NaN, against its plain version and, value for value,
               against the per-call launches it replaces; then every
               order's value, first and second jvp (coefficients moving
               with x) and both outputs of ``pair``, kernel chain against
               the plain chain, no plain lerp run on the card; the pair
               entry, the step mode, the backward kernel on step-mode
               tables and without coefficients and the jet entry (beside
               its per-call launches, in turns) timed at N = 512, 8,192,
               40,000; then the 'reference' gradient under 'dense' and
               SPRING's score matrix under 'table' at 256 K1 walkers,
               kernels against the plain chain (REF_GRAD_RTOL), launches
               equal to the CPU's count, and every launch of the forms the
               trainer menu adds (the grad-of-grad rules' per-term
               forward and backward launches, the backward kernel's g_x
               from a slope table, the vmap fold's backward launches)
               recorded there and replayed against its plain version,
               one of each timed beside its bound;
 39. table-hpsi — the 100k checkpoint under 'table', Hψ at 4,096 K1
               walkers under every Laplacian form: K4 launches per pass
               equal to the evaluations the same pass makes on the CPU;
               'fwd_batched' against the plain chain on the card
               (TABLE_HPSI_RTOL); 'fwd_batched' and 'fwd' from the jet
               equal to the per-call chain's to the bit; E_L against
               'poly_pallas' on the same walkers within the float64
               interpolation error (TABLE_POLY_EL_BOUND,
               TABLE_POLY_EL_MEAN_BOUND);
 40. table-eval — the 100k checkpoint under 'table' at the JAX protocol,
               graphed: raw and clipped beside the JAX 'poly' figures (a
               record), accept rate, K1 and K4 (forward, pair, jet)
               launched, launches by entry;
 41. graph-table — train-256 under 'table' graphed against its eager twin
               (to the bit, K1 and K4 launches per replayed epoch); the
               jet's graphed windows against the per-call entries' (to the
               bit after 3 turns of 2 x 10 epochs, ms per replayed epoch in
               turns per-call, jet, jet, per-call); then ms per replayed
               epoch against 'poly_pallas' in turns;
 57. graph-table-menu (after graph-table) — the trainer menu under
               'table' (TABLE_MENU: the reference design under 'dense',
               'hvp' and 'fwd_batched', SR, SPRING, Metropolis, MALA, each
               from the committed run its 'poly_pallas' twin loads)
               graphed against its eager twin as graph-mala (the
               reference recipes in turns of two windows): to the bit,
               K3 not launched, K4 per replayed epoch by entry equal to the
               CPU's count for one epoch of the recipe, K1 launched by the
               ancestral ones; E_L against 'poly_pallas' on the run's
               starting walkers (TABLE_POLY_EL_BOUND,
               TABLE_POLY_EL_MEAN_BOUND); ms per replayed epoch against
               the 'poly_pallas' twin in turns;
 58. catalogue (after h2-2d-eval) — every system of
               examples/catalogue_sweep_torch.py (its 12 1D systems and the
               2D H, He+ and H2+) from scratch at full width, seed 2, batch
               256: the graphed window against its eager twin in turns
               eager, graph, graph, eager of one window of
               CATALOGUE_WINDOW epochs, to the bit, every loss finite, K1
               per replayed epoch equal to the CPU's count (one per
               coordinate), K3 0 under 'poly'; then H, He_off_center and
               box3 (1, 2 and 3 electrons) again under 'poly_pallas': K3
               per replayed epoch equal to the CPU's count, and K3 at the
               shapes of each path against the plain core;
 59. quality (after catalogue) — examples/round5_quality_torch.py's paths
               at full width from scratch, graphed against eager in turns
               of one window, each to the bit, peak memory and graph pool
               printed: the He-2d antisym decay (one window at lr 3e-4
               checkpointed; trainers at lr 3e-5 load it, each Adam must
               read 3e-5; windows of QUALITY_WINDOW epochs); Li on
               Metropolis walkers, 3 sweeps, a refresh every window, two
               windows (K1 over the graph twin = the CPU's count, the
               refresh's draws included); the ng batches — adam, SR,
               SPRING at 16,384 walkers, adam and SR at 65,536, windows of
               NG_TWIN_WINDOW epochs, K1 / K3 per replayed epoch = the
               CPU's count; the 65,536 adam twin again under 'poly_pallas'
               (K3 12 per epoch) and K3 at its path's shapes (R = 131,072,
               the staged regime) against the plain core;
 60. scaling (after quality) — examples/batch_sweep_torch.py's window
               ('poly_pallas') and examples/mcmc_scale_torch.py's
               Metropolis (3 sweeps) and MALA (1 sweep) windows at
               SCALING_BATCH walkers, graphed against eager in turns of one
               window of SCALING_WINDOW epochs, to the bit, K1 / K3 per
               replayed epoch = the CPU's count; the tail pass (vmc/evaluate.py::record_tail) on the 100k
               checkpoint: the evaluation's chain continued to the bit, the
               'dense' and finite-difference Hψ at its walkers within the
               lap-forms limits;
 61. studies (after scaling) — examples/frontier_2d2e_torch.py's He recipe
               from scratch on the 'paired2d' sector (which the trainer
               must resolve) and examples/sr_study_torch.py's
               big_spring_0.05_m0.9_tr and big_sr_cg_0.05_tr (31 knots, 4
               layers), each graphed against eager in turns of one window,
               to the bit, K1 / K3 per replayed epoch = the CPU's count,
               the big rows' K1 in the 'streamed' regime; K1 on the big
               prior's real 36-base table against its plain version at B =
               256 and 4,096 (phase 3 of a whole run, ``streamed_k1``),
               timed beside the staged 28-base table;
 62. reports (after studies) — examples/evaluate_flagship_torch.py's loader
               and evaluation (4,096 walkers, 100 + 8 x 10 sweeps) on
               results/he1d_seed2, every parameter NaN: no exception,
               non-finite energies; then results/r4_spring100k in the same
               process, within 5 combined sigma of JAX's (no sticky CUDA
               error); examples/outlier_study_torch.py's box2 median_abs
               recipe and examples/round4_quality_torch.py's
               li_big_spring_20k recipe from scratch, graphed against
               eager to the bit, K1 / K3 per replayed epoch = the CPU's
               count; phase 3 of a whole run holds K3 (NaN / ±inf sites),
               K1 and K2 (NaN coefficients) to their plain versions NaN for
               NaN and times K3 before and after its NaN check (a build of
               the source without it, in turns, outputs equal to the bit);
 42. rqs-density — RQSFlow on benchmarks/circles_parity.py's split, 300
               epochs (cut from 12,000): loss falls, round trip under 1e-4,
               points/s;
 43. gm-density — MFlow on gaussian_mixtures (reg 0.05, degree 5, 15
               knots), 200 epochs: loss falls, K2 and K4 launched;
 44. compat — the reference's API (waveflow_tpu_torch/compat.py) on the
               card: BSpline_fun (degree 6, 23 knots, 2000 mesh)
               apply_fun_vec at 65,536 rows and sample_fun_vec at 32,768 x
               2 (one K1 launch), ISpline_fun (degree 5) apply_fun_vec,
               apply_fun_vec_grad and reverse_fun_vec at 40,000 rows,
               MSpline_fun (degree 3, 15 knots) sample_fun_vec at 20,000 x
               2 (one K2 launch), each against the same call on the CPU,
               its launches held to the CPU's count, timed against the
               direct ops call; train_model (MFlow, 20,000 circles points,
               200 epochs) equal to train_density_model to the bit (losses,
               parameters, metric files, launches); ModelTrainer at the
               reference defaults for 200 epochs (finite, K1, walkers/s);
 45. artifacts (last: it records a profiler trace) — save_artifacts on a
               'poly_pallas' trainer from the 100k checkpoint: 2 graphed
               windows of 10 with a save_checkpoint between equal to the
               same run without artifacts to the bit; every file at its
               shape; the ψ grid and slices against the plain core on the
               card (ARTIFACTS_PSI_RTOL); K1 and K3 launches per
               save_wavefunction_artifacts call held to the CPU's count;
               utils/profiling.py's trace around 10 replayed epochs names
               K1 and K3, time_fn of K3 at R = 512;
 29. report  — one JSON line of kernels, then the final status line.

Each phase that drives a path sets the launch counts to 0 just before it
and reads them just after.  A replayed graph's launches are counted by
vmc/graphs.py, once per replay, as the capture counted them.

    python3 chip_smoke.py --only graph-train,graph-eval

runs the build and the named phases of ``phase_table`` alone (no kernels
line).

Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / 'results' / 'r5_flagship_fwd_batched_100k' / 'checkpoints'
METROPOLIS_RUN = ROOT / 'results' / 'he1d_metropolis_seed7'
MALA_RUN = ROOT / 'results' / 'he1d_mala_s3'
SPRING_RUN = ROOT / 'results' / 'r4_spring100k'
SR_RUN = ROOT / 'results' / 'he1d_sr'
LI_RUN = ROOT / 'results' / 'r5_li_metro_refresh100_s3'
# the 2D runs (L = 5, default widths): the antisymmetrized He-2d-2e and
# box3-2d (benchmarks/round5_quality.py stage_antisym and
# stage_antisym2d_free: Metropolis, lr 3e-4 then 3e-5), the paired2d He-2d
# (benchmarks/round4_quality.py stage_he2d2e: ancestral, the same lr
# schedule) and the 1-electron H-2d ('independent' map, ancestral)
ANTISYM_RUN = ROOT / 'results' / 'r5_he2d2e_antisym'
BOX3_RUN = ROOT / 'results' / 'r5_box3_2d_antisym'
PAIRED2D_RUN = ROOT / 'results' / 'r4_he2d2e_lr3e-4_decay'
H2D_RUN = ROOT / 'results' / 'h_2d'
# the n_grid = 40 ED of He-2d-2e, its two degenerate ground states
ED40_HE = ROOT / 'results' / 'ed40_He_2d2e.npz'
# the JAX package's frozen-params Metropolis evaluations of those
# checkpoints: the flagship's, Li's and the 2D runs', the SPRING run's, the
# MALA run's, the paired2d run's
JAX_EVAL = ROOT / 'results' / 'round5_quality.json'
JAX_EVAL_R4 = ROOT / 'results' / 'final_energies_r4.json'
JAX_EVAL_MCMC = ROOT / 'results' / 'long_mcmc_runs.json'
JAX_EVAL_2D_R4 = ROOT / 'results' / 'round4_quality.json'
# the JAX runs' configurations (benchmarks/round4_quality.py SPRING,
# benchmarks/round5_quality.py stage_li_refresh; he1d_sr: SR at lr 0.05)
SPRING_CONFIG = dict(optimizer='spring', learning_rate=0.05,
                     spring_momentum=0.9, sr_max_update_norm=0.3)
SR_CONFIG = dict(optimizer='sr', learning_rate=0.05)
LI_CONFIG = dict(system_name='Li', learning_rate=3e-4, sampler='metropolis',
                 mcmc_sweeps=3, mcmc_refresh_every=100)
# the 2D runs at their final learning rate
BOX_2D = dict(n_space_dimension=2, box_length=5.0, learning_rate=3e-5)
ANTISYM_CONFIG = dict(BOX_2D, system_name='He', ansatz='antisym',
                      sampler='metropolis')
BOX3_CONFIG = dict(BOX_2D, system_name='box3', ansatz='antisym',
                   sampler='metropolis', interactions=False)
PAIRED2D_CONFIG = dict(BOX_2D, system_name='He')
H2D_CONFIG = dict(BOX_2D, system_name='H')
# fidelity gates: the port's overlap within this of the JAX figure
FIDELITY_TOL = 1e-4
# the grid of H-2d's ED state that its fidelity was taken on (RESULTS.md)
H2D_ED_GRID = 120
# lap-forms gates, relative to max|Hψ| over the batch, fixed from a
# float64 CPU run of the 100k checkpoint at 2,048 walkers
# (tests/test_torch_hamiltonian.py::test_laplacian_forms_against_float64):
# every f32 analytic form lies within 2e-4 of the float64 Hψ (9.9e-5
# measured), so two forms agree to twice that; the f32 finite difference
# (eps 0.1) lies within 1e-3 of its float64 value (6.7e-4 measured), so
# the kernel and the plain core agree to twice that
LAP_FORMS_RTOL = 4e-4
LAP_FD_RTOL = 2e-3
# poly-sample gate: |F64(x) − u| of 'poly' draws against the float64 CDF of
# the polynomial density; on the CPU the flagship's conditional rows read
# 3.5e-7 (the port) and 2.1e-6 (JAX's f32 path)
# (tests/test_torch_poly_sampler.py)
POLY_QUANTILE_TOL = 1e-5
# table-hpsi gates.  K4's forward-mode chain against its plain chain on the
# card: Hψ within TABLE_HPSI_RTOL of max|Hψ|.  Both are f32 orderings of
# the same chain, which read 4.30e-5 apart on the H100 (the 100k checkpoint,
# 4,096 walkers, seed 11): the gate is 3x that.  A K4 with its step mode or
# its pair entry wrong moves Hψ by 2e-3 of max|Hψ| or more
# (tests/test_torch_table_backend.py::
# test_table_hpsi_gate_catches_planted_k4_faults).  E_L
# under 'table' against 'poly' on the same walkers where |ψ| >
# 0.05 max|ψ| (JAX's test_waveflow_poly_vs_table_backends criterion): the
# table interpolation error, max 9.61e-3 and mean 2.13e-4 in float64 at
# 1,024 walkers on the CPU (test_table_against_poly_energies_float64, f32
# the same to 3 digits); held to about 5x that, for the tail of 4,096
# walkers
TABLE_HPSI_RTOL = 1.3e-4
TABLE_POLY_EL_BOUND = 0.05
TABLE_POLY_EL_MEAN_BOUND = 1e-3
# artifacts gate: ψ of the 100k checkpoint on the artifacts' 100² grid and
# both density slices, 'poly_pallas' (K3) against the plain core on the
# card, relative to max|ψ|; fixed from a float64 CPU run
# (tests/test_torch_utils.py::test_artifacts_psi_f32_against_float64): the
# f32 ψ lies within 1e-5 of the float64 ψ (3.8e-6 measured), so the two
# f32 orderings agree to twice that
ARTIFACTS_PSI_RTOL = 2e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
FLAGSHIP = dict(spline_degree=6, num_knots=23, n_mesh=2000)
# the density benchmark's model at full width (examples/run_benchmark_torch.py
# defaults): 3 x (IMADE + Reverse), I-splines of degree 5 with 23 knots,
# M-spline prior of degree 3 with 15 knots, 2000-point mesh
DENSITY = dict(spline_reg=0.02, n_flow_layers=3, spline_degree=5, n_knots=23,
               n_mesh_points=2000, prior_spline_degree=3, prior_n_knots=15)
DENSITY_POINTS = 20000


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(torch, fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of the kernels one call of ``fn`` launches, without
    the host path around them: one profiler pass over ``reps`` calls, self
    device time over the calls.

    The profiler's device clock is not CUDA events' clock: after the card
    has idled for some seconds inside a process (a compile, a sleep) it
    reads about 5% short, and the steps add up, while events do not move.
    Here every reading follows seconds of steady work, and for kernels
    longer than their launch path the back-to-back time by events printed
    beside it bounds it from above.  Two builds are compared by events, in
    turns (examples/kernel_sweep_torch.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a profiler pass now and then comes back without its device rows;
    # such a pass is taken again, and three in a row fail
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps
    fail("the profiler recorded no device time")


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def table_rows(torch, n_mesh: int, x, step: bool = False) -> int:
    """The distinct rows of an (n_mesh, n_bases) table that a K4 evaluation
    at these x must read: the two rows around each x's cell for a lerp, the
    row at the cell in step mode (the cell as the kernel clamps it).  A
    bound counts these bytes, not the whole table: at a few hundred rows x
    touches a fraction of a 2000-point mesh."""
    n_cells = n_mesh - 1
    cell = torch.nan_to_num(torch.clamp(torch.floor(x.reshape(-1) * n_cells),
                                        0, n_cells - 1), nan=0.0).long()
    rows = cell if step else torch.cat([cell, cell + 1])
    return int(torch.unique(rows).numel())


def quantile_err(torch, table_t, c, u, x, kind):
    """|F(x) − u| in float64: how much probability lies between each draw x
    and the exact u-quantile of its own density, (c · T)² for kind
    'squared' and max(c · T, 0) for kind 'linear', T the table."""
    psi = c.double() @ table_t.double()
    if kind == 'linear':
        psi = torch.clamp(psi, min=0.0)
    n_cells = psi.shape[-1] - 1
    h = 1.0 / n_cells
    p_l = psi[..., :-1]
    d = psi[..., 1:] - p_l
    if kind == 'squared':
        m = h * (p_l * p_l + p_l * d + d * d / 3.0)
    else:
        m = h * (p_l + 0.5 * d)
    cdf = torch.cat([torch.zeros_like(m[..., :1]), torch.cumsum(m, -1)], -1)
    xd = x.double()
    j = torch.clamp(torch.floor(xd / h).long(), 0, n_cells - 1)
    s = xd / h - j

    def at(a):
        return torch.gather(a, -1, j[..., None])[..., 0]

    a, dd = at(p_l), at(d)
    if kind == 'squared':
        in_cell = h * (a * a * s + a * dd * s * s + dd * dd * s ** 3 / 3.0)
    else:
        in_cell = h * (a * s + 0.5 * dd * s * s)
    return ((at(cdf) + in_cell) / cdf[..., -1] - u.double()).abs()


def poly_quantile_err(torch, ev, c, u, x):
    """|F(x) − u| in float64 for draws x of the POLYNOMIAL density (c · T)²
    of a poly evaluator ``ev`` (the density ``sample_squared_amplitude_poly``
    inverts): exact cell masses h · lᵀ H l and the exact in-cell
    antiderivative, all in float64."""
    M, K = ev.n_cells, ev.ncoef
    h = 1.0 / M
    P = (c.double() @ ev.A.double()).reshape(c.shape[:-1] + (M, K))
    k = torch.arange(K, device=P.device, dtype=torch.float64)
    H = 1.0 / (k[:, None] + k[None, :] + 1.0)
    m = torch.clamp(h * torch.einsum('...mk,kl,...ml->...m', P, H, P),
                    min=0.0)
    cdf = torch.cat([torch.zeros_like(m[..., :1]), torch.cumsum(m, -1)], -1)
    xd = x.double()
    j = torch.clamp(torch.floor(xd * M).long(), 0, M - 1)
    s = xd * M - j
    l = torch.gather(P, -2, j[..., None, None].expand(
        j.shape + (1, K)))[..., 0, :]
    sq = torch.zeros(l.shape[:-1] + (2 * K - 1,), dtype=torch.float64,
                     device=l.device)
    for k1 in range(K):
        sq[..., k1:k1 + K] += l[..., k1:k1 + 1] * l
    powers = s[..., None] ** torch.arange(1, 2 * K, device=s.device)
    F = h * (sq / torch.arange(1, 2 * K, device=s.device) * powers).sum(-1)
    below = torch.gather(cdf, -1, j[..., None])[..., 0] + F
    return (below / cdf[..., -1] - u.double()).abs()


def check_sampler(torch, gen, kind, ev, coeffs_of, B_max, in_probability=False):
    """A sampler kernel (K1: kind 'squared', K2: kind 'linear') against its
    plain path on the inputs the main path gives it: the model's conditional
    coefficients ``coeffs_of(points)[:, column]`` of both ancestral columns,
    at a batch of 256 and at ``B_max`` (both timed), at ragged batches
    (1, 3, 255, 257, 300, 1,000 and ``B_max`` − 1: every walkers-per-group
    variant, groups and grids that do not divide), with the u = 0 and
    u = 1 − 1e-7 walls among the draws, plus 4,096 draws per column in the
    right tail u ∈ (1 − 1e-4, 1 − 1e-7].

    Draws with u ≤ 1 − 1e-4 are held to the f32 plain draw at 6e-5 (the
    prefix sum's association order, ~0.1 mesh cell).  For u > 1 − 1e-4 the
    target lies within a few f32 ulps of the CDF total, where the rounding
    of either f32 prefix sum can span whole cells of a thin tail; there both
    f32 versions are held to a float64 plain draw on the same inputs,
    measured as the probability between the draw and the exact quantile:
    the kernel's largest must not exceed the f32 plain path's by more than
    2 ulps of u.

    ``in_probability``: the u <= 1 - 1e-4 draws too are held in
    probability rather than in x (a density near zero over some cells lets
    the two f32 prefix sums' rounding move a draw across them): at each
    batch the kernel's largest |F64(x) − u| must not exceed the f32 plain
    path's by more than the worst-case rounding of an f32 prefix sum over
    the mesh's cells, n_cells × 2^-24 of the total; |dx| is reported."""
    import types
    from waveflow_tpu_torch.ops import cuda_sampler
    from waveflow_tpu_torch.ops.sampling import (
        sample_linear_density, sample_squared_amplitude)
    if kind == 'squared':
        name, sample = 'K1 sampler', sample_squared_amplitude
        kernel = cuda_sampler.sample_squared_amplitude_cuda
        cell_ops = 8                 # cubic mass 6, scan 1, compare 1
    else:
        name, sample = 'K2 sampler_linear', sample_linear_density
        kernel = cuda_sampler.sample_linear_density_cuda
        cell_ops = 5                 # clamp 1, trapezoid 2, scan 1, compare 1
    ev_64 = types.SimpleNamespace(
        density_on_mesh=lambda cc, t=ev.table_t.double(): cc @ t)
    n_b, n_mesh = ev.table_t.shape
    n_tail = 4096
    u = torch.rand((2, B_max), generator=gen, device='cuda')
    u[:, :3] = 0.0
    u[:, 3:6] = 1.0 - 1e-7
    u_tail = 1.0 - 10.0 ** -(4.0 + 3.0 * torch.rand(
        (2, n_tail), generator=gen, device='cuda', dtype=torch.float64))
    u_tail = torch.clamp(u_tail.float(), max=1.0 - 1e-7)
    with torch.no_grad():
        c0 = coeffs_of(torch.zeros((B_max, 2), device='cuda'))[:, 0]
        x0 = sample(ev, c0, u[0], impl='plain')
        c1 = coeffs_of(torch.stack([x0, torch.zeros_like(x0)], -1))[:, 1]
    rows, tail = {}, {'dx': [], 'k64': [], 'p64': [], 'qk': [], 'qp': []}
    ragged = (1, 3, 255, 257, 300, 1000, B_max - 1)
    body_tol = (n_mesh - 1) * 2.0 ** -24
    for B in (256, B_max, 'tail') + ragged:
        errs, body_q = [], {'k': [], 'p': []}
        for col, c in enumerate((c0, c1)):
            if B == 'tail':
                c, uu = c[:n_tail].contiguous(), u_tail[col]
            else:
                c, uu = c[:B].contiguous(), u[col, :B]
            x_k = sample(ev, c, uu, impl='cuda')
            x_p = sample(ev, c, uu, impl='plain')
            torch.cuda.synchronize()
            if not (x_k.min() >= 0 and x_k.max() <= 1):
                fail(f"{name} draws outside [0, 1] at B={B}")
            diff = (x_k - x_p).abs()
            t = uu > 1.0 - 1e-4
            errs.append(diff[~t])
            if in_probability and B != 'tail':
                for side, x in (('k', x_k), ('p', x_p)):
                    body_q[side].append(quantile_err(
                        torch, ev.table_t, c[~t], uu[~t], x[~t], kind))
            if t.any():
                ct, ut = c[t], uu[t]
                x64 = sample(ev_64, ct.double(), ut.double(), impl='plain')
                tail['dx'].append(diff[t])
                tail['k64'].append((x_k[t] - x64).abs())
                tail['p64'].append((x_p[t] - x64).abs())
                tail['qk'].append(quantile_err(torch, ev.table_t, ct, ut,
                                               x_k[t], kind))
                tail['qp'].append(quantile_err(torch, ev.table_t, ct, ut,
                                               x_p[t], kind))
        if B == 'tail':
            continue
        diff = torch.cat(errs)
        err, med = diff.max().item(), diff.median().item()
        q = {}
        if in_probability:
            q = {k: torch.cat(v).max().item() for k, v in body_q.items()}
            print(f"{name} B={B} (n_bases {n_b}): max|F64(x) - u| over u <= "
                  f"1 - 1e-4: kernel {q['k']:.3e}, f32 plain {q['p']:.3e} "
                  f"(bound: plain + {body_tol:.3e}) | max|dx| {err:.3e}, "
                  f"{(diff > 6e-5).sum().item()} draws beyond 6e-5", flush=True)
            if q['k'] > q['p'] + body_tol:
                fail(f"{name} lies farther from the float64 quantile than its "
                     f"plain version at B={B}: {q['k']:.3e} > {q['p']:.3e} + "
                     f"{body_tol:.3e}")
        elif err > 6e-5:
            fail(f"{name} disagrees with its plain version at B={B}: max "
                 f"{err:.3e} for u <= 1 - 1e-4 (atol 6e-5), "
                 f"{(diff > 6e-5).sum().item()} draws beyond it")
        if B in ragged:
            rows[('ragged', B)] = dict(max_abs_err=err)
            continue
        k_ms = cuda_ms(torch, lambda: kernel(ev, c, uu))
        d_ms = device_ms(torch, lambda: kernel(ev, c, uu))
        p_ms = cuda_ms(torch, lambda: sample(ev, c, uu, impl='plain'))
        n_cells = n_mesh - 1
        b_ms, b_by = bound_ms(4 * (B * n_b + 2 * B + n_b * n_mesh),
                              B * (2 * n_b * n_mesh + cell_ops * n_cells))
        rows[B] = dict(max_abs_err=err, median_abs_err=med, ms=k_ms,
                       device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms,
                       bound_by=b_by, plan=cuda_sampler.last_plan)
        if q:
            rows[B].update(quantile_err=q['k'], plain_quantile_err=q['p'])
        print(f"{name} B={B} (n_bases {n_b}, n_mesh {n_mesh}): max|dx| "
              f"{err:.3e} over u <= 1 - 1e-4 (atol 6e-5), median {med:.3e} | "
              f"kernel_ms {k_ms:.4f} device_ms {d_ms:.4f} plain_ms {p_ms:.4f} "
              f"bound_ms {b_ms:.5f} ({b_by})", flush=True)
    print(f"{name} ragged batches: max|dx| over u <= 1 - 1e-4 (atol 6e-5) "
          + ", ".join(f"B={B}: {rows[('ragged', B)]['max_abs_err']:.3e}"
                      for B in ragged), flush=True)
    t = {k: torch.cat(v).max().item() for k, v in tail.items()}
    n = sum(v.numel() for v in tail['dx'])
    print(f"{name} tail: {n} draws with u > 1 - 1e-4 (walls included) | "
          f"max|dx| against the f32 plain draw {t['dx']:.3e} | against a "
          f"float64 plain draw: kernel {t['k64']:.3e}, f32 plain "
          f"{t['p64']:.3e} | max |F64(x) - u|: kernel {t['qk']:.3e}, f32 "
          f"plain {t['qp']:.3e}", flush=True)
    if not t['qk'] <= t['qp'] + 2.0 ** -23:
        fail(f"{name}'s tail draws lie farther from the float64 quantile than "
             f"the f32 plain path's: {t['qk']:.3e} > {t['qp']:.3e} + 2^-23")
    rows['tail'] = dict(n=n, max_abs_err=t['dx'], k64=t['k64'], p64=t['p64'],
                        quantile_err=t['qk'], plain_quantile_err=t['qp'])
    return rows


def check_sampler_other_tables(torch, ops, gen):
    """K1 on tables the main paths do not use, each of which takes another
    branch of the kernel: a table too large for a block's shared memory
    (orthonormal B-splines of degree 6 with 40 knots: 45 bases, 360 KB on
    the 2000-point mesh) must take the 'streamed' regime, the same kernel
    reading the table through L1/L2; a mesh whose rows are not 16-byte
    aligned (1001 points) is staged by plain loads instead of bulk copies;
    the largest mesh (2049 points) has a last point that no thread owns,
    streamed at 28 bases and staged at 15.  The draws must agree with the
    plain path as everywhere else: 6e-5 for u <= 1 - 1e-4."""
    from waveflow_tpu_torch.ops import cuda_sampler
    from waveflow_tpu_torch.ops.sampling import sample_squared_amplitude
    cases = ((40, 2000, 'streamed'), (23, 1001, 'shared'),
             (23, 2049, 'streamed'), (10, 2049, 'shared'))
    for knots, n_mesh, regime in cases:
        tabs = ops.get_tables('B', FLAGSHIP['spline_degree'], knots,
                              n_mesh=n_mesh)
        ev = ops.make_evaluator(tabs, use_ob=True, device='cuda')
        n_b = ev.table_t.shape[0]
        errs = {}
        for B in (1, 257, 4096):
            c = torch.randn((B, n_b), generator=gen, device='cuda')
            c = c / c.norm(dim=-1, keepdim=True)
            u = torch.rand((B,), generator=gen, device='cuda')
            x_k = sample_squared_amplitude(ev, c, u, impl='cuda')
            x_p = sample_squared_amplitude(ev, c, u, impl='plain')
            torch.cuda.synchronize()
            plan = cuda_sampler.last_plan
            if plan.regime != regime:
                fail(f"a ({n_b}, {n_mesh}) table was launched as {plan}, not "
                     f"{regime}")
            body = u <= 1.0 - 1e-4
            errs[B] = (x_k - x_p).abs()[body].max().item()
            if not (x_k.min() >= 0 and x_k.max() <= 1 and errs[B] <= 6e-5):
                fail(f"K1 on a ({n_b}, {n_mesh}) table disagrees with its "
                     f"plain version at B={B}: max {errs[B]:.3e} (atol 6e-5)")
        d_ms = device_ms(torch, lambda: sample_squared_amplitude(
            ev, c, u, impl='cuda'))
        print(f"K1 sampler, {regime} table (n_bases {n_b}, n_mesh {n_mesh}, "
              f"{4 * n_b * n_mesh} B): max|dx| over u <= 1 - 1e-4 (atol 6e-5) "
              + ", ".join(f"B={B}: {e:.3e}" for B, e in errs.items())
              + f" | B=4096 device_ms {d_ms:.4f} | plan grid {plan.grid} x "
              f"{plan.threads} threads, {plan.smem_bytes} B dynamic shared, "
              f"group {plan.group}", flush=True)


def count_device_launches(torch, fn) -> int:
    """Every kernel the device runs for one call of ``fn``, by the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
        if n:
            return n
    fail("the profiler recorded no device launch")


def check_spline_eval(torch, model, gen):
    """K4, forward and backward kernel, on the density model's prior.

    Forward against the plain gather-lerp and the one-hot matmul form: the
    M-spline tables of orders 0 and 1, the model's own prior weights as
    coefficients, N = 512 and N = 40,000 (the (20,000, 2) batch flattened),
    with x = 0, x = 1, cell edges and out-of-domain points among the
    inputs.  Backward against ``spline_eval_bwd_plain`` at the same sizes,
    at order 0 (x-gradient from the order-1 table) and at the top order
    (x-gradient zero).  Both at ragged N (1, 3, 31, 513, 40,001), on a
    second table whose n_bases is no multiple of 4, on views that are not
    16-byte aligned (the scalar path: the same bits as the vector path),
    and with either gradient left out.  atol 2e-5, times the largest
    reference value where that exceeds 1 (the order-1 table holds slopes).
    Then through SplineEvaluator.__call__ with its backward against the
    same evaluator on the CPU, counting the launches."""
    from waveflow_tpu_torch.ops import cuda_spline, make_evaluator
    from waveflow_tpu_torch.ops.spline_tables import get_tables
    ev = model.ev
    n_mesh, n_b = ev.tables.shape[1:]
    top = ev.tables.shape[0] - 1
    N_max = 2 * DENSITY_POINTS
    x = torch.rand((N_max + 1,), generator=gen, device='cuda')
    special = torch.tensor([0.0, 1.0, -0.03, 1.02, -1e-6, 1.0 + 1e-6,
                            0.5, 1000 / (n_mesh - 1), 1 / (n_mesh - 1)],
                           device='cuda')
    x[:special.numel()] = special
    g = torch.randn((N_max + 1,), generator=gen, device='cuda')
    with torch.no_grad():
        coeffs = model.prior_weights(
            x[:N_max].reshape(-1, 2)).reshape(N_max, n_b)
        coeffs = torch.cat([coeffs, coeffs[:1]]).contiguous()

    def close(got, ref, what):
        """Largest |got − ref| and its limit, 2e-5 of the largest reference
        value (at least 1); fails above the limit."""
        tol = 2e-5 * max(1.0, ref.abs().max().item())
        err = (got - ref).abs().max().item()
        if not err <= tol:
            fail(f"K4 {what}: max {err:.3e} (atol {tol:.3e})")
        return err, tol

    rows, rows_b = {}, {}
    for d in (0, 1):
        table = ev.tables[d]
        for N in (512, N_max):
            c, xx = coeffs[:N], x[:N]
            y_k = cuda_spline.spline_eval_cuda(table, c, xx)
            y_p = cuda_spline.spline_eval_plain(table, c, xx)
            y_o = cuda_spline.onehot_matmul_eval(table, c, xx)
            torch.cuda.synchronize()
            err, tol = close(y_k, y_p, f"forward d={d} N={N} against the "
                             "gather-lerp")
            err_o, _ = close(y_k, y_o, f"forward d={d} N={N} against the "
                             "one-hot matmul")
            k_ms = cuda_ms(torch, lambda: cuda_spline.spline_eval_cuda(
                table, c, xx))
            d_ms = device_ms(torch, lambda: cuda_spline.spline_eval_cuda(
                table, c, xx))
            p_ms = cuda_ms(torch, lambda: cuda_spline.spline_eval_plain(
                table, c, xx))
            o_ms = cuda_ms(torch, lambda: cuda_spline.onehot_matmul_eval(
                table, c, xx), reps=10)
            b_ms, b_by = bound_ms(
                4 * (N * n_b + 2 * N + table_rows(torch, n_mesh, xx) * n_b),
                N * (4 * n_b + 6))
            rows[(d, N)] = dict(max_abs_err=err, onehot_abs_err=err_o,
                                ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                                onehot_ms=o_ms, bound_ms=b_ms, bound_by=b_by,
                                plan=cuda_spline.plan(N, n_b))
            print(f"K4 spline_eval d={d} N={N} (n_bases {n_b}, n_mesh "
                  f"{n_mesh}): max|dy| {err:.3e} against the gather-lerp, "
                  f"{err_o:.3e} against the one-hot matmul (atol "
                  f"{tol:.1e}) | kernel_ms {k_ms:.4f} device_ms "
                  f"{d_ms:.4f} plain_ms {p_ms:.4f} onehot_matmul_ms "
                  f"{o_ms:.4f} bound_ms {b_ms:.5f} ({b_by})", flush=True)

    # the backward kernel: order 0 chains to the order-1 table, the top
    # order has none
    for d in (0, top):
        t_d = ev.tables[d]
        t_d1 = ev.tables[d + 1] if d < top else None
        for N in (512, N_max):
            c, xx, gg = coeffs[:N], x[:N], g[:N]

            def bwd():
                return cuda_spline.spline_eval_bwd_cuda(t_d, t_d1, c, xx, gg)

            def bwd_plain():
                return cuda_spline.spline_eval_bwd_plain(t_d, t_d1, c, xx, gg)

            (gc_k, gx_k), (gc_p, gx_p) = bwd(), bwd_plain()
            torch.cuda.synchronize()
            err_c, tol_c = close(gc_k, gc_p, f"backward d={d} N={N} g_coeffs")
            err_x, tol_x = close(gx_k, gx_p, f"backward d={d} N={N} g_x")
            if t_d1 is None:
                if gx_k.any():
                    fail("K4 backward: the x-gradient at the top tabulated "
                         "order is not zero")
            elif not torch.equal(
                    gx_k, gg * cuda_spline.spline_eval_cuda(t_d1, c, xx)):
                fail("K4 backward: g_x is not g times the forward kernel at "
                     "order d + 1, bit for bit")
            k_ms, d_ms = cuda_ms(torch, bwd), device_ms(torch, bwd)
            p_ms = cuda_ms(torch, bwd_plain)
            # each input once, each output once: grad, x and g_coeffs, g_x
            # always; coeffs and the second table only where g_x chains
            chains = t_d1 is not None
            b_ms, b_by = bound_ms(
                4 * (N * (2 + n_b + 1 + n_b * chains)
                     + (1 + chains) * table_rows(torch, n_mesh, xx) * n_b),
                N * (3 * n_b + (4 * n_b + 1) * chains + 6))
            rows_b[(d, N)] = dict(
                max_abs_err=max(err_c, err_x), g_coeffs_abs_err=err_c, g_x_abs_err=err_x, ms=k_ms,
                device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                plan=cuda_spline.plan(N, n_b, True))
            print(f"K4 spline_eval_bwd d={d} N={N}: max|d g_coeffs| "
                  f"{err_c:.3e} (atol {tol_c:.1e}), max|d g_x| {err_x:.3e} "
                  f"(atol {tol_x:.1e}) against spline_eval_bwd_plain | "
                  f"kernel_ms {k_ms:.4f} device_ms {d_ms:.4f} plain_ms "
                  f"{p_ms:.4f} bound_ms {b_ms:.5f} ({b_by})", flush=True)

    # ragged sizes, a table of another width, unaligned views, one gradient
    tabs13 = get_tables('M', DENSITY['prior_spline_degree'],
                        DENSITY['prior_n_knots'] - 3, n_mesh=n_mesh)
    ev13 = make_evaluator(tabs13, device='cuda')
    if ev13.n_bases % 4 == 0:
        fail(f"the second table has {ev13.n_bases} bases, a multiple of 4")
    c13 = torch.rand((N_max + 1, ev13.n_bases), generator=gen, device='cuda')
    worst = {}
    for e, cc in ((ev, coeffs), (ev13, c13)):
        t0, t1 = e.tables[0], e.tables[1]
        for N in (1, 3, 31, 513, N_max + 1):
            c, xx, gg = cc[:N], x[:N], g[:N]
            y = cuda_spline.spline_eval_cuda(t0, c, xx)
            gc, gx = cuda_spline.spline_eval_bwd_cuda(t0, t1, c, xx, gg)
            gc_p, gx_p = cuda_spline.spline_eval_bwd_plain(t0, t1, c, xx, gg)
            torch.cuda.synchronize()
            what = f"n_bases {e.n_bases} N={N}"
            errs = (close(y, cuda_spline.spline_eval_plain(t0, c, xx),
                          f"forward {what}"),
                    close(gc, gc_p, f"backward {what} g_coeffs"),
                    close(gx, gx_p, f"backward {what} g_x"))
            worst[(e.n_bases, N)] = (errs[0][0], max(errs[1][0], errs[2][0]))
            # views one float off a 16-byte boundary take the scalar path
            off = [torch.empty(a.numel() + 1, device='cuda')[1:].view(a.shape)
                   .copy_(a) for a in (t0, t1, c)]
            if not all(a.data_ptr() % 16 for a in off):
                fail("the unaligned views came out aligned")
            y_u = cuda_spline.spline_eval_cuda(off[0], off[2], xx)
            gc_u, gx_u = cuda_spline.spline_eval_bwd_cuda(
                off[0], off[1], off[2], xx, gg)
            if not (torch.equal(y_u, y) and torch.equal(gc_u, gc)
                    and torch.equal(gx_u, gx)):
                fail(f"K4 on unaligned views differs from aligned ones, {what}")
            only_c = cuda_spline.spline_eval_bwd_cuda(t0, t1, c, xx, gg,
                                                      need_x=False)
            only_x = cuda_spline.spline_eval_bwd_cuda(t0, t1, c, xx, gg,
                                                      need_coeffs=False)
            if not (only_c[1] is None and only_x[0] is None
                    and torch.equal(only_c[0], gc)
                    and torch.equal(only_x[1], gx)):
                fail(f"K4 backward with one gradient left out differs, {what}")
    print("K4 forward + backward at ragged N, on aligned and unaligned views "
          "(equal to the bit), either gradient alone; max|dy| / max|d "
          "gradient|, each inside 2e-5 of its largest value: "
          + ", ".join(f"n_bases {k[0]} N={k[1]}: {v[0]:.2e} / {v[1]:.2e}"
                      for k, v in worst.items()), flush=True)
    rows['ragged'] = dict(max_abs_err=max(v[0] for v in worst.values()))
    rows_b['ragged'] = dict(max_abs_err=max(v[1] for v in worst.values()))

    # the evaluator's Function: value and both gradients, card against CPU
    tabs = get_tables('M', DENSITY['prior_spline_degree'],
                      DENSITY['prior_n_knots'], n_mesh=n_mesh)
    ev_cpu = make_evaluator(tabs, device='cpu')
    before = cuda_spline.launches, cuda_spline.launches_bwd
    for d in (0, top):
        got, ref = [], []
        for evaluator, dev, out in ((ev, 'cuda', got), (ev_cpu, 'cpu', ref)):
            c = coeffs[:512].to(dev).requires_grad_()
            xx = x[:512].to(dev).requires_grad_()
            y = evaluator(c, xx, d)
            out.extend((y, *torch.autograd.grad((y * g[:512].to(dev)).sum(),
                                                (c, xx))))
        for a, b, what in zip(got, ref, ('value', 'coeffs-gradient',
                                         'x-gradient')):
            close(a.cpu(), b, f"SplineEvaluator.__call__ d={d} {what}, card "
                  "against CPU")
        if d == top and got[2].any():
            fail("the x-gradient at the top tabulated order is not zero")
    # one forward and one backward launch per differentiated call
    counted = (cuda_spline.launches - before[0],
               cuda_spline.launches_bwd - before[1])
    if counted != (2, 2):
        fail(f"SplineEvaluator.__call__ launched K4 forward/backward "
             f"{counted} times for 2 differentiated calls")

    c2 = coeffs[:N_max].reshape(-1, 2, n_b).clone().requires_grad_()
    x2 = x[:N_max].reshape(-1, 2).clone().requires_grad_()
    g2 = g[:N_max].reshape(-1, 2).contiguous()

    def forward_backward():
        return torch.autograd.grad(ev(c2, x2), (c2, x2), g2)

    n_launch = count_device_launches(torch, forward_backward)
    if n_launch != 2:
        fail(f"one forward + backward of SplineEvaluator.__call__ ran "
             f"{n_launch} kernels on the device, not 2")
    print("K4 through SplineEvaluator.__call__: value, coeffs-gradient and "
          "x-gradient (order-(d+1) table; zero at the top order) agree with "
          "the CPU evaluator (atol 2e-5 of the largest value); one forward "
          f"+ backward at (20000, 2) runs {n_launch} device kernels, both "
          "K4's (15 while the backward was plain PyTorch: 2 K4 launches and "
          "13 generic ones)", flush=True)
    return rows, rows_b


def k3_timed_row(torch, label, x, A, nc, k, out_k, out_p):
    """K3 at x (R sites) on the jet table A, its output ``out_k`` held by
    the caller against the plain core's ``out_p``: the error, kernel_ms
    (CUDA events, wrapper in), device_ms (profiler), plain_ms, library_ms
    (``torch.matmul`` of a built (R, cells × coefficients) W on A) and the
    bound, printed and returned."""
    from waveflow_tpu_torch.ops import cuda_jet
    R = x.numel()
    err = (out_k - out_p).abs().max().item()
    W = torch.zeros((R, nc * k), device='cuda')
    k_ms = cuda_ms(torch, lambda: cuda_jet.basis_jet_cuda(x, A, nc, k))
    d_ms = device_ms(torch, lambda: cuda_jet.basis_jet_cuda(x, A, nc, k))
    p_ms = cuda_ms(torch, lambda: cuda_jet.basis_jet_plain(x, A, nc, k))
    lib_ms = cuda_ms(torch, lambda: torch.matmul(W, A))
    lib_d_ms = device_ms(torch, lambda: torch.matmul(W, A))
    N = A.shape[1]
    b_ms, b_by = bound_ms(4 * (R + A.numel() + R * N), 2 * R * N * k)
    print(f"{label} R={R}: max|d| {err:.3e} "
          f"(rtol 2e-5, atol 2e-4) | kernel_ms {k_ms:.4f} device_ms "
          f"{d_ms:.4f} plain_ms {p_ms:.4f} library_ms {lib_ms:.4f} "
          f"library_device_ms {lib_d_ms:.4f} (matmul of a built W) "
          f"bound_ms {b_ms:.5f} ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                library_ms=lib_ms, library_device_ms=lib_d_ms, bound_ms=b_ms,
                bound_by=b_by, plan=cuda_jet.last_plan)


# K3's timed sites per jet call: the flagship's train-256 (512) and
# eval-65k (131,072), and the batch sweep's 1,024 / 4,096 / 16,384 walkers
# (examples/batch_sweep_torch.py, two coordinates each).  Timed here, before
# any profiled graph phase: after those the profiler drops eager launches
K3_TIMED_SITES = (512, 2048, 8192, 32768, 131072)


def check_basis_jet(torch, ops, tabs_i, tabs_b, gen):
    """K3 against the plain core, and its derivative rules against the
    plain backend, for the I-spline (29 bases) and OB (28 bases) jets: at
    K3_TIMED_SITES (timed), and at ragged sizes on both sides of the
    kernel's direct/staged switch, x partly outside [0, 1] throughout."""
    from waveflow_tpu_torch.ops import cuda_jet
    switch = cuda_jet.STAGED_MIN_SITES
    ragged = (1, 31, 513, 4097, switch - 1, switch, 131071)
    rows = {}
    for label, tabs, use_ob in (('I', tabs_i, False), ('OB', tabs_b, True)):
        ev_k = ops.make_poly_evaluator(tabs, use_ob=use_ob,
                                       jet_backend='pallas', device='cuda')
        ev_p = ops.make_poly_evaluator(tabs, use_ob=use_ob,
                                       jet_backend='xla', device='cuda')
        A, nc, k = ev_k.A_jet, ev_k.n_cells, ev_k.ncoef
        for R in K3_TIMED_SITES:
            x = torch.rand((R,), generator=gen, device='cuda') * 1.1 - 0.05
            out_k = cuda_jet.basis_jet_cuda(x, A, nc, k)
            out_p = cuda_jet.basis_jet_plain(x, A, nc, k)
            full_k, full_p = ev_k.basis_jet(x), ev_p.basis_jet(x)
            torch.cuda.synchronize()
            for a, b, what in ((out_k, out_p, 'core'), (full_k, full_p, 'jet')):
                if not torch.allclose(a, b, rtol=2e-5, atol=2e-4):
                    fail(f"K3 {label} {what} R={R} disagrees: max "
                         f"{(a - b).abs().max().item():.3e}")
            rows[(label, R)] = k3_timed_row(torch, f"K3 basis_jet {label}",
                                            x, A, nc, k, out_k, out_p)
        seen = {}
        for R in ragged:
            x = torch.rand((R,), generator=gen, device='cuda') * 1.1 - 0.05
            out_k = cuda_jet.basis_jet_cuda(x, A, nc, k)
            out_p = cuda_jet.basis_jet_plain(x, A, nc, k)
            torch.cuda.synchronize()
            if not torch.allclose(out_k, out_p, rtol=2e-5, atol=2e-4):
                fail(f"K3 {label} core R={R} disagrees: max "
                     f"{(out_k - out_p).abs().max().item():.3e}")
            err = (out_k - out_p).abs().max().item()
            rows[(label, 'ragged', R)] = dict(max_abs_err=err)
            seen[R] = (err, cuda_jet.last_plan.regime)
        if {seen[switch - 1][1], seen[switch][1]} != {'direct', 'staged'}:
            fail(f"K3 did not change regime at R={switch}: {seen}")
        print(f"K3 basis_jet {label} ragged sizes (rtol 2e-5, atol 2e-4): "
              + ", ".join(f"R={R} {reg}: {err:.3e}"
                          for R, (err, reg) in seen.items()), flush=True)
        # first and second x-derivatives through the Function: nested jvp
        # and backward, kernel core against the plain core
        n_b = ev_k.n_bases
        c = torch.rand((512, n_b), generator=gen, device='cuda') * 0.9 + 0.1
        x = torch.rand((512,), generator=gen, device='cuda') * 0.9 + 0.05

        def derivs(ev):
            def g(xx):
                return (c * ev.basis_jet(xx)[..., 0, :]).sum(-1)

            def d1(xx):
                return torch.func.jvp(g, (xx,), (torch.ones_like(xx),))[1]

            d1v, d2v = torch.func.jvp(d1, (x,), (torch.ones_like(x),))
            xr = x.clone().requires_grad_()
            (gx,) = torch.autograd.grad(g(xr).sum(), xr)
            return g(x), d1v, d2v, gx

        before = cuda_jet.launches
        got = derivs(ev_k)
        relaunch = cuda_jet.launches - before
        for a, b, what in zip(got, derivs(ev_p),
                              ('value', 'jvp d1', 'jvp d2', 'backward d1')):
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-3):
                fail(f"K3 {label} {what} disagrees: max "
                     f"{(a - b).abs().max().item():.3e}")
        # one launch each for: the nested jvp, the backward's forward, the value
        if relaunch != 3:
            fail(f"K3 derivative rules relaunched the kernel ({relaunch} "
                 "launches for 3 jet evaluations)")
        print(f"K3 {label}: value, nested-jvp d1/d2 and backward d1 agree "
              "(rtol 1e-4, atol 1e-3); the second-order tangent came from "
              "the saved jet (no relaunch)", flush=True)
    return rows


def host_ms(torch, fn, n=20):
    """Mean host-clock time of ``fn`` over ``n`` calls ending in a
    synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def profile_window(torch, run, n_epochs, label, unit='epochs', top=8):
    """Profile ``run()`` (``n_epochs`` epochs, or other ``unit``s): print the
    device's busy and idle share of the wall time and the ``top`` kernels
    that take most of it; return those figures.  A replayed CUDA graph's
    kernels are reported one by one, as eager launches are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n_kernels = sum(e.count for e in kern) / n_epochs
    print(f"{label}profiled {n_epochs} {unit}: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
          f"{n_kernels:.0f} kernel launches per {unit.rstrip('s')}",
          flush=True)
    if not kern:
        fail(f"{label}: the profiler saw no kernel")
    # the largest, and the port's own kernels wherever they rank
    own = ('sampler_kernel', 'basis_jet_', 'spline_eval_kernel',
           'spline_eval_bwd_kernel', 'spline_eval_jet_kernel',
           'spline_eval_bwd_jet_kernel')
    for e in kern[:top] + [e for e in kern[top:]
                           if any(k in e.key for k in own)]:
        print(f"  {e.self_device_time_total / 1e3 / n_epochs:8.4f} ms/{unit[0]} "
              f"{e.count / n_epochs:6.1f}/{unit[0]}  {e.key[:90]}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle=1 - busy_ms / wall_ms, launches_per_unit=n_kernels)


def reset_counts():
    from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler
    cuda_sampler.launches = 0
    cuda_jet.launches = 0


def read_counts():
    from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler
    return {'sampler': cuda_sampler.launches, 'basis_jet': cuda_jet.launches}


def sigmas(value, stderr, ref):
    """Distance of ``value`` ± ``stderr`` from the JAX figure ``ref`` = (mean,
    stderr), in combined standard errors √(σ² + σ_jax²)."""
    return abs(value - ref[0]) / math.hypot(stderr, ref[1])


def evaluation_phase(torch, jax_raw, jax_clipped):
    """The frozen-parameter Metropolis evaluation of the 100k checkpoint at
    the JAX protocol, through ``evaluate_trainer``; then one block profiled
    and the host time of one sweep and one E_L pass at 4,096 walkers."""
    from waveflow_tpu_torch.vmc import (VMCConfig, VMCTrainer,
                                        evaluate_energy, evaluate_trainer)
    from waveflow_tpu_torch.vmc.metropolis import (make_metropolis_sampler,
                                                   sector_projection)
    trainer = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cuda'))
    if not trainer.load_checkpoint(str(CHECKPOINT.parent)):
        fail(f"no checkpoint under {CHECKPOINT.parent}")
    n_blocks, per_block, warmup, B = 64, 25, 250, 4096
    reset_counts()
    t0 = time.perf_counter()
    ev = evaluate_trainer(trainer, n_blocks=n_blocks,
                          sweeps_per_block=per_block, n_warmup_sweeps=warmup,
                          batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_sweeps = warmup + n_blocks * per_block
    d_raw = sigmas(ev.e_mean, ev.e_stderr, jax_raw)
    d_clip = sigmas(ev.e_clipped, ev.e_clipped_stderr, jax_clipped)
    print(f"evaluation (epoch {trainer.epoch}, {B} walkers, {warmup} warmup + "
          f"{n_blocks} x {per_block} sweeps, step 0.4, '1d' sort): "
          f"E = {ev.e_mean:.6f} +- {ev.e_stderr:.6f} (2x {ev.e_stderr_2x:.6f}, "
          f"4x {ev.e_stderr_4x:.6f}), {d_raw:.2f} combined sigma from the JAX "
          f"raw mean {jax_raw[0]} +- {jax_raw[1]} | clipped "
          f"{ev.e_clipped:.6f} +- {ev.e_clipped_stderr:.6f}, {d_clip:.2f} "
          f"combined sigma from the JAX clipped mean {jax_clipped[0]} +- "
          f"{jax_clipped[1]} | median {ev.e_median:.6f} | accept rate "
          f"{ev.accept_rate:.4f} | {wall:.2f} s wall, {n_sweeps / wall:.1f} "
          f"sweeps/s | launches: sampler {launches['sampler']}, basis_jet "
          f"{launches['basis_jet']}", flush=True)
    if not (math.isfinite(ev.e_mean) and d_raw <= 5.0):
        fail(f"evaluated mean {ev.e_mean} is {d_raw:.2f} combined sigma from "
             f"the JAX raw mean {jax_raw}")
    if not (math.isfinite(ev.e_clipped) and d_clip <= 5.0):
        fail(f"evaluated clipped mean {ev.e_clipped} is {d_clip:.2f} combined "
             f"sigma from the JAX clipped mean {jax_clipped}")
    if not 0.45 <= ev.accept_rate <= 0.55:
        fail(f"evaluation accept rate {ev.accept_rate} outside [0.45, 0.55]")
    if min(launches.values()) == 0:
        fail(f"a kernel of the path was not launched in evaluation: {launches}")

    # where the time goes: one sweep and one E_L pass (host clock), one
    # block of 25 sweeps + E_L profiled
    model, gen = trainer.model, torch.Generator('cuda').manual_seed(3)
    init_fn, step_fn, _ = make_metropolis_sampler(
        model.log_pdf, bounds=(-10.0, 10.0),
        proposal_map=sector_projection(True))
    state = init_fn(model.sample(B, generator=gen), step_size=0.4)
    ms_sweep = host_ms(torch, lambda: step_fn(state, gen))
    with torch.no_grad():
        ms_eloc = host_ms(torch, lambda: trainer.h_fn(state.positions), n=5)
    print(f"evaluation stages (host clock, {B} walkers): one sweep "
          f"{ms_sweep:.2f} ms | one E_L pass {ms_eloc:.2f} ms", flush=True)
    profile_window(torch, lambda: evaluate_energy(
        model.psi, trainer.h_fn, model.log_pdf, 10.0, state.positions, gen,
        n_blocks=1, sweeps_per_block=per_block, n_warmup_sweeps=0,
        graph=False), 1,
        "eager evaluation block (25 sweeps + E_L, and the chain's first "
        "log_pdf) ", unit='blocks')
    return launches, dict(wall_s=wall, sweeps_per_s=n_sweeps / wall,
                          ms_sweep=ms_sweep, ms_eloc=ms_eloc)


def resume_phase(torch):
    """Exact resume: from the 100k checkpoint with its Adam moments, 2
    windows of 10 epochs, save, load into a fresh trainer, 2 more, against
    4 windows straight.  Losses and final parameters equal to the bit."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    cfg = VMCConfig(batch_size=256, window=10, log_every=10,
                    eval_backend='poly_pallas', device='cuda')

    def loaded():
        t = VMCTrainer(cfg)
        if not t.load_checkpoint(str(CHECKPOINT.parent)):
            fail(f"no checkpoint under {CHECKPOINT.parent}")
        return t

    reset_counts()
    t0 = time.perf_counter()
    straight = loaded()
    straight.train(40, verbose=False)
    first = loaded()
    first.train(20, verbose=False)
    with tempfile.TemporaryDirectory() as d:
        first.save_checkpoint(d)
        second = VMCTrainer(cfg)
        if not second.load_checkpoint(d):
            fail("the port's checkpoint did not load")
    second.train(20, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    a, b = straight.losses[-40:], second.losses[-40:]
    if second.epoch != straight.epoch or len(second.losses) != len(
            straight.losses) or not all(math.isfinite(v) for v in b):
        fail(f"resumed run at epoch {second.epoch} with {len(second.losses)} "
             f"losses, straight at {straight.epoch} with "
             f"{len(straight.losses)}")
    pairs = list(zip(straight.model.parameters(), second.model.parameters()))
    bitwise = a == b and all(torch.equal(x, y) for x, y in pairs)
    rel = max([abs(x - y) / max(abs(x), 1e-30) for x, y in zip(a, b)]
              + [((x - y).abs().max() / x.abs().max()).item() for x, y in pairs])
    print(f"resume: 100k checkpoint + Adam moments, 2 + 2 windows of 10 "
          f"epochs at batch 256 with a save / load between, against 4 "
          f"straight: {'equal to the bit' if bitwise else 'NOT bitwise'} "
          f"(largest relative difference {rel:.3e}; last loss "
          f"{b[-1]:.6f}) | {wall:.2f} s wall for 80 epochs and 3 trainers | "
          f"launches: sampler {launches['sampler']}, basis_jet "
          f"{launches['basis_jet']}", flush=True)
    # a path that is not deterministic on the card (ROADMAP Queue 3) is held
    # to 1e-6 relative instead of the bit
    if not (bitwise or rel <= 1e-6):
        fail(f"the resumed run differs from the uninterrupted one by {rel:.3e}"
             " relative (limit 1e-6 where the card is not deterministic)")
    return launches, dict(wall_s=wall, bitwise=bitwise, max_rel_diff=rel)


def metropolis_phase(torch, ancestral_wps):
    """Metropolis training resumed from the JAX run he1d_metropolis_seed7:
    its 256 walkers, step size and Adam moments, one window of 100 epochs
    of 3 sweeps + one update each."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    t = VMCTrainer(VMCConfig(batch_size=256, window=100, log_every=100,
                             sampler='metropolis', eval_backend='poly_pallas',
                             device='cuda'))
    if not t.load_checkpoint(str(METROPOLIS_RUN)):
        fail(f"no checkpoint under {METROPOLIS_RUN}")
    if t.mcmc_state is None or t.mcmc_state.positions.shape != (256, 2):
        fail("the JAX run's Metropolis walkers did not load")
    step0 = t.mcmc_state.step_size.item()
    n0 = len(t.losses)
    reset_counts()
    t0 = time.perf_counter()
    losses = t.train(100, verbose=True)[n0:]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    acc = sum(t.accept_rates) / len(t.accept_rates)
    wps = 100 * 256 / wall
    print(f"metropolis: epoch {t.epoch}, 100 epochs at batch 256 (3 sweeps "
          f"each), losses finite: {all(math.isfinite(v) for v in losses)}, "
          f"last {losses[-1]:.5f} | mean accept rate {acc:.4f}, step size "
          f"{step0:.4f} -> {t.mcmc_state.step_size.item():.4f} | walkers/s "
          f"{wps:.1f} (host clock; ancestral training "
          f"{'not run' if ancestral_wps is None else f'{ancestral_wps:.1f}'}) | "
          f"launches per epoch: sampler {launches['sampler'] / 100:g}, "
          f"basis_jet {launches['basis_jet'] / 100:g}", flush=True)
    if len(losses) != 100 or not all(math.isfinite(v) for v in losses):
        fail("Metropolis training produced non-finite losses")
    if not 0.3 <= acc <= 0.7:
        fail(f"Metropolis mean accept rate {acc} outside [0.3, 0.7]")
    if launches['basis_jet'] == 0:
        fail("K3 was not launched in Metropolis training")
    profile_window(torch, lambda: t.mcmc_window(t.mcmc_state, 10, t.baseline,
                                                t.generator), 10,
                   "metropolis window ")
    return launches, dict(wall_s=wall, walkers_per_s=wps, accept_rate=acc)


# the graph-against-eager phases: epochs per window (each turn trains two
# windows, so the second hands the 'reference' loss a non-zero baseline)
GRAPH_WINDOW = 10
# the windows per turn of the twins whose estimator reads no baseline
# (every one but the 'reference' recipes), cut from two to keep the
# script's length
ONE_WINDOW = dict(turn_windows=1)
# a graphed run against its eager twin, where the card is not bitwise: the
# largest relative difference allowed, as the resume phase allows (ROADMAP
# Queue 3 names any difference met)
GRAPH_MAX_REL = 1e-6


def events_ms(torch, fn):
    """(fn(), the ms between CUDA events recorded around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def trainer_tensors(torch, t):
    """What a trainer carries from window to window, by name: losses,
    baseline, parameters, optimizer state (Adam's moments, SPRING's delta
    and counters; SR keeps none), generator, walkers, accept rates."""
    out = {'losses': torch.tensor(t.losses, dtype=torch.float64),
           'baseline': t.baseline, 'generator': t.generator.get_state()}
    out.update({f'param {k}': v for k, v in t.model.state_dict().items()})
    opt = t.step.optimizer.state_dict()
    if t.config.optimizer == 'adam':
        for i, st in opt['state'].items():
            out.update({f'adam {i} {k}': v for k, v in st.items()})
    elif t.config.optimizer == 'spring':
        out.update({f'spring {k}': v for k, v in opt.items()})
    if t.mcmc_state is not None:
        out.update({f'walkers {k}': v for k, v in
                    zip(t.mcmc_state._fields, t.mcmc_state)})
        out['accept_rates'] = torch.tensor(t.accept_rates,
                                           dtype=torch.float64)
    return out


def compare_twins(torch, a, b):
    """(equal to the bit, largest relative difference, that difference by
    the first word of the names) of two dicts of tensors with the same
    names; a tensor's difference is relative to its largest entry."""
    if a.keys() != b.keys():
        fail(f"twins carry different tensors: {sorted(a.keys() ^ b.keys())}")
    bitwise, by_group = True, {}
    for k in a:
        x, y = a[k].detach().cpu(), b[k].detach().cpu()
        bitwise &= torch.equal(x, y)
        if x.numel():
            x, y = x.double(), y.double()
            diff = (x - y).abs().max().item()
            group = k.split()[0]
            by_group[group] = max(by_group.get(group, 0.0),
                                  diff / max(x.abs().max().item(), 1e-30))
    return bitwise, max(by_group.values(), default=0.0), by_group


@contextlib.contextmanager
def capture_clock(torch):
    """Every ``EpochGraph`` capture made inside: (seconds, bytes the caching
    allocator reserved over it — the graph's private pool) appended to the
    list yielded, the card synchronised on both sides.  Garbage is
    collected and the cache emptied first, as the capture itself does, so
    the reserved bytes before it are the live tensors' alone."""
    from waveflow_tpu_torch.vmc import graphs
    real, record = graphs.EpochGraph._capture, []

    def timed(self):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
        out = real(self)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0,
                       torch.cuda.memory_reserved() - reserved))
        return out
    graphs.EpochGraph._capture = timed
    try:
        yield record
    finally:
        graphs.EpochGraph._capture = real


def spring_counters(t):
    """SPRING's step, skipped and fallbacks counters of a trainer, or None
    for another optimizer."""
    if t.config.optimizer != 'spring':
        return None
    return {k: int(v) for k, v in t.step.optimizer.state_dict().items()
            if k != 'delta'}


def replayed_window(t, n: int):
    """``n`` epochs of a trainer's own window (replayed when it is graphed),
    outside ``train``: the ancestral or the MCMC window."""
    if t.config.sampler == 'ancestral':
        return t.train_window(n, t.baseline)
    return t.mcmc_window(t.mcmc_state, n, t.baseline, t.generator)


def graph_twins(torch, label, make, read=None, reset=None,
                required=('basis_jet',), after=None, turn_windows=2,
                profile=True):
    """A trainer on the graph path and its eager twin (``graph=False``),
    both from one state (``make(graph)``): turns of ``turn_windows`` windows
    (of the trainers' ``window`` epochs) in the order eager, graph, graph, eager,
    each timed
    by CUDA events with its kernel launches counted (the first graph turn
    holds the warm-up epoch and the capture, whose own seconds and graph
    pool — ``torch.cuda.memory_reserved`` before and after — are read by
    ``capture_clock``); then everything the two carry compared (to the
    bit, or within GRAPH_MAX_REL), SPRING's counters too (they must
    advance alike, one step per epoch), launches per epoch compared, and
    ``window`` epochs of ``replayed_window`` (the graph replayed)
    profiled: the profiler's processing time grows with the kernels it
    saw, ~33,500 per SR epoch.  ``read`` / ``reset`` are the launch counters (K1 and K3
    unless given), ``required`` the kernels the replays must launch;
    ``after(eager, graphed)`` adds its figures to the row;
    ``profile=False`` leaves the profiled window out."""
    eager, graphed = make(False), make(None)
    if eager.graph or not graphed.graph:
        fail(f"{label}: the twins' graph flags are {eager.graph}, "
             f"{graphed.graph}")
    window = graphed.config.window
    read, reset = read or read_counts, reset or reset_counts
    n_turn = turn_windows * window
    ms = {'eager': [], 'graph': []}
    counts = {kind: dict.fromkeys(read(), 0) for kind in ms}
    counters0 = spring_counters(graphed)
    reserved = []
    with capture_clock(torch) as captures:
        for kind, t in (('eager', eager), ('graph', graphed),
                        ('graph', graphed), ('eager', eager)):
            reset()
            reserved.append(torch.cuda.memory_reserved())
            _, dt = events_ms(torch, lambda: t.train(n_turn, verbose=False))
            reserved[-1] = (reserved[-1], torch.cuda.memory_reserved())
            ms[kind].append(dt)
            counts[kind] = {k: counts[kind][k] + v for k, v in read().items()}
    n_ep = 2 * n_turn
    per_epoch = {kind: {k: v / n_ep for k, v in c.items()}
                 for kind, c in counts.items()}
    bitwise, rel, by_group = compare_twins(
        torch, trainer_tensors(torch, eager), trainer_tensors(torch, graphed))
    losses = graphed.losses[-n_ep:]
    B = graphed.config.batch_size
    eager_ms = sum(ms['eager']) / n_ep
    graph_ms = ms['graph'][1] / n_turn
    first_ms = ms['graph'][0] / n_turn
    if len(captures) != 1:
        fail(f"{label}: {len(captures)} captures in the turns, not 1")
    capture_s, pool_bytes = captures[0]
    out = dict(eager_ms_per_epoch=eager_ms, graph_ms_per_epoch=graph_ms,
               graph_first_turn_ms_per_epoch=first_ms,
               eager_walkers_per_s=B / eager_ms * 1e3,
               graph_walkers_per_s=B / graph_ms * 1e3,
               speedup=eager_ms / graph_ms, turns_ms=ms, bitwise=bitwise,
               max_rel_diff=rel, rel_diff_by_group=by_group,
               launches_per_epoch=per_epoch, capture_s=capture_s,
               graph_pool_mib=pool_bytes / 2 ** 20,
               first_graph_turn_reserved_mib=[
                   v / 2 ** 20 for v in reserved[1]])
    if graphed.accept_rates:
        out['accept_rate'] = sum(graphed.accept_rates[-n_ep:]) / n_ep
    counters = {kind: spring_counters(t) for kind, t in
                (('eager', eager), ('graph', graphed))}
    if counters0 is not None:
        out['spring_counters'] = dict(counters, start=counters0)
    print(f"{label}: eager, graph, graph, eager turns of {turn_windows} x "
          f"{window} epochs at batch {B} (CUDA events): "
          f"{' / '.join(f'{v:.1f}' for v in ms['eager'][:1] + ms['graph'] + ms['eager'][1:])} ms "
          f"| eager {eager_ms:.3f} ms per epoch, {out['eager_walkers_per_s']:.1f}"
          f" walkers/s | graph {graph_ms:.3f} ms per epoch (replays; "
          f"first turn {first_ms:.3f} with the warm-up and the capture), "
          f"{out['graph_walkers_per_s']:.1f} walkers/s, {out['speedup']:.2f}x "
          f"| capture {capture_s:.3f} s, graph pool {out['graph_pool_mib']:.1f}"
          f" MiB (reserved {out['first_graph_turn_reserved_mib'][0]:.1f} -> "
          f"{out['first_graph_turn_reserved_mib'][1]:.1f} MiB over the first "
          f"graph turn) | graph against eager after {n_ep} epochs: "
          f"{'equal to the bit' if bitwise else 'NOT bitwise'} (largest "
          f"relative difference {rel:.3e}; by kind "
          f"{ {k: f'{v:.2e}' for k, v in by_group.items()} }) | launches per epoch eager "
          f"{per_epoch['eager']}, graph {per_epoch['graph']}"
          + (f" | mean accept rate {out['accept_rate']:.4f}"
             if 'accept_rate' in out else "")
          + (f" | SPRING counters {counters0} -> eager {counters['eager']}, "
             f"graph {counters['graph']}" if counters0 is not None else ""),
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: the graphed run produced non-finite losses")
    if not (bitwise or rel <= GRAPH_MAX_REL):
        fail(f"{label}: the graph differs from its eager twin by {by_group} "
             f"relative (limit {GRAPH_MAX_REL:g})")
    if counters0 is not None and (
            counters['eager'] != counters['graph']
            or counters['graph']['step'] != counters0['step'] + n_ep):
        fail(f"{label}: SPRING's counters from {counters0}: {counters}")
    if per_epoch['graph'] != per_epoch['eager']:
        fail(f"{label}: launches per epoch differ: {per_epoch}")
    missing = [k for k in required if counts['graph'][k] == 0]
    if missing:
        fail(f"{label}: {missing} not launched by the graph's replays")
    if profile:
        out['profile'] = prof = profile_window(
            torch, lambda: replayed_window(graphed, window), window,
            f"{label} graphed window ", top=10)
        # the profiler slows the host's side of a replay: the idle share of
        # an unprofiled replay is the profiled busy time against the
        # events' time
        out['idle_unprofiled'] = 1 - prof['busy_ms'] / window / graph_ms
        print(f"{label}: device busy {prof['busy_ms'] / window:.3f} ms per "
              f"replayed epoch (profiler) against {graph_ms:.3f} ms per "
              f"epoch unprofiled (CUDA events): idle share "
              f"{out['idle_unprofiled']:.4f}", flush=True)
    if after is not None:
        out.update(after(eager, graphed))
    return counts['graph'], out


# the windows of the MALA, SPRING and SR twins (graph-mala, graph-spring,
# graph-sr, graph-natgrad-mcmc, dp-spring-1), cut to keep the script's
# length: windows of TWIN_WINDOW epochs, and of SR_GRAPH_WINDOW for SR,
# whose eager epoch takes ~1-1.5 s at batch 256 (turns of one window,
# ONE_WINDOW, but for the 'reference' recipes)
TWIN_WINDOW = 5
SR_GRAPH_WINDOW = 2


def twin_maker(run_dir, config, window=GRAPH_WINDOW,
               eval_backend='poly_pallas'):
    """``make(graph)`` of ``graph_twins``: a trainer at batch 256 on
    ``eval_backend`` with windows of ``window`` epochs and ``config``,
    resumed from the committed run ``run_dir`` (its parameters, optimizer
    state and walkers, or walkers warm-started on the trainer's stream)."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    def make(graph):
        t = VMCTrainer(VMCConfig(batch_size=256, window=window,
                                 log_every=window, eval_backend=eval_backend,
                                 device='cuda', **config), graph=graph)
        if not t.load_checkpoint(str(run_dir)):
            fail(f"no checkpoint under {run_dir}")
        return t
    return make


def graph_train_phase(torch):
    """The ancestral adam window as a CUDA graph against its eager twin,
    from the 100k checkpoint with its Adam moments: train-256 (the main
    path), reference-256 (the reference design, 'reference' + 'dense';
    its backward runs on the calling thread, vmc/estimators.py, so its first
    run of a process equals later ones) and the 'reference' estimator on
    the main path's Laplacian (its running baseline through the graph's
    buffer); the two reference twins in windows of TWIN_WINDOW."""
    rows, total = {}, {'sampler': 0, 'basis_jet': 0}
    for label, extra, window in (
            ('train-256', {}, GRAPH_WINDOW),
            ('reference-256', dict(estimator='reference',
                                   laplacian_mode='dense'), TWIN_WINDOW),
            ('reference-256 fwd_batched', dict(estimator='reference'),
             TWIN_WINDOW)):
        launches, rows[label] = graph_twins(
            torch, f"graph-train {label}",
            twin_maker(CHECKPOINT.parent, extra, window))
        if launches['sampler'] == 0:
            fail(f"graph-train {label}: K1 was not launched by the replays")
        total = {k: total[k] + v for k, v in launches.items()}
    return total, rows


def graph_metropolis_phase(torch):
    """The Metropolis adam window as a CUDA graph against its eager twin,
    from he1d_metropolis_seed7 with its walkers and Adam moments."""
    launches, row = graph_twins(
        torch, "graph-metropolis metropolis-256",
        twin_maker(METROPOLIS_RUN, dict(sampler='metropolis')), **ONE_WINDOW)
    return launches, {'metropolis-256': row}


def graph_mala_phase(torch):
    """The adam MALA window (``MALATrainWindow``: the sweeps, the update,
    the refresh of log-prob and drift, K3's backward rule inside the
    capture) as a CUDA graph against its eager twin from he1d_mala_s3."""
    launches, row = graph_twins(
        torch, "graph-mala mala-256",
        twin_maker(MALA_RUN, dict(sampler='mala'), TWIN_WINDOW), **ONE_WINDOW)
    return launches, {'mala-256': row}


def graph_spring_phase(torch):
    """The SPRING ancestral window (its delta and counters written in
    place, the Cholesky ladder inside the capture) as a CUDA graph against
    its eager twin from r4_spring100k: K1 and K3 launched by the replays,
    the counters advancing alike."""
    launches, row = graph_twins(
        torch, "graph-spring spring-256",
        twin_maker(SPRING_RUN, SPRING_CONFIG, TWIN_WINDOW),
        required=('sampler', 'basis_jet'), **ONE_WINDOW)
    return launches, {'spring-256': row}


def graph_sr_phase(torch):
    """The SR ancestral window (20 masked CG iterations of one jvp and one
    vjp: the port's largest graph) against its eager twin from he1d_sr,
    turns of one window of SR_GRAPH_WINDOW epochs."""
    launches, row = graph_twins(
        torch, "graph-sr sr-256",
        twin_maker(SR_RUN, SR_CONFIG, SR_GRAPH_WINDOW),
        required=('sampler', 'basis_jet'), **ONE_WINDOW)
    return launches, {'sr-256': row}


def graph_natgrad_mcmc_phase(torch):
    """The natural-gradient updates over MCMC walkers as CUDA graphs
    against their eager twins: SPRING + MALA from r4_spring100k and SR +
    Metropolis from he1d_sr (ancestral runs: the walkers are warm-started
    on the trainer's stream, the same in both twins)."""
    rows, total = {}, {'sampler': 0, 'basis_jet': 0}
    for label, run_dir, config, window in (
            ('spring-mala-256', SPRING_RUN,
             dict(SPRING_CONFIG, sampler='mala'), TWIN_WINDOW),
            ('sr-metropolis-256', SR_RUN,
             dict(SR_CONFIG, sampler='metropolis'), SR_GRAPH_WINDOW)):
        launches, rows[label] = graph_twins(
            torch, f"graph-natgrad-mcmc {label}",
            twin_maker(run_dir, config, window), **ONE_WINDOW)
        total = {k: total[k] + v for k, v in launches.items()}
    return total, rows


def dp_spring_phase(torch):
    """SPRING + ancestral sharded over a world of one process on NCCL
    (``data_parallel=True``: the clip window's and the row norms'
    all-gathers, the chunked all-gather Gram matrix and the update's psum
    captured in the epoch) graphed against its eager sharded twin; then
    the same for the other collectives of this slice's windows, adam +
    MALA (the accept fraction's pmean per sweep) and SR (a pmean per CG
    iteration).  Each as ``graph_twins``, both twins' steps and samplers
    built on the walker axis, plus the NCCL events and copies per replayed
    epoch (profiler; a world of one launches no NCCL kernel, a record)."""
    rows, total = {}, {'sampler': 0, 'basis_jet': 0}
    for label, run_dir, config, window, required in (
            ('spring-256', SPRING_RUN, SPRING_CONFIG, TWIN_WINDOW,
             ('sampler', 'basis_jet')),
            ('mala-256', MALA_RUN, dict(sampler='mala'), TWIN_WINDOW,
             ('basis_jet',)),
            ('sr-256', SR_RUN, SR_CONFIG, SR_GRAPH_WINDOW,
             ('sampler', 'basis_jet'))):
        name = f"dp-spring-1 {label}"

        def collectives(eager, graphed, window=window, name=name):
            if not all(t.mesh is not None and t.mesh.backend == 'nccl'
                       and t.mesh.size == 1 and t.walker_axis is not None
                       for t in (eager, graphed)):
                fail(f"{name}: walker meshes {eager.mesh}, {graphed.mesh}")
            prof = collective_profile(
                torch, lambda: replayed_window(graphed, window), window)
            print(f"{name}: world of one over NCCL, per replayed epoch "
                  f"(profiler): NCCL events {prof['nccl_per_epoch']:g} "
                  f"{prof['nccl_by_name']}, copies "
                  f"{prof['copies_per_epoch']:g}, device events "
                  f"{prof['events_per_epoch']:g}, busy "
                  f"{prof['busy_ms_per_epoch']:.4f} ms", flush=True)
            return dict(collectives=prof)
        launches, rows[label] = graph_twins(
            torch, name,
            twin_maker(run_dir, dict(config, data_parallel=True), window),
            required=required, after=collectives, **ONE_WINDOW)
        total = {k: total[k] + v for k, v in launches.items()}
    return total, rows


def graph_eval_phase(torch):
    """eval-4k as two CUDA graphs against the eager evaluation: the 100k
    checkpoint at the JAX protocol, turns graph, eager, graph (CUDA
    events), every field of the evaluation compared, launches compared;
    then the block graph of ``evaluation_windows`` (25 frozen sweeps + the
    E_L pass and its row) captured, 5 replays timed and 5 profiled."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, evaluate_trainer
    from waveflow_tpu_torch.vmc.evaluate import evaluation_windows
    trainer = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cuda'))
    if not trainer.load_checkpoint(str(CHECKPOINT.parent)):
        fail(f"no checkpoint under {CHECKPOINT.parent}")
    runs, ms, counts = [], [], []
    for graph in (None, False, None):
        reset_counts()
        ev, dt = events_ms(torch, lambda: evaluate_trainer(trainer,
                                                           graph=graph))
        runs.append(ev)
        ms.append(dt)
        counts.append(read_counts())
    (g1, e, g2) = runs

    def fields(ev):
        # the fields left NaN (no clip ladder) compare as equal
        return {f: torch.as_tensor(getattr(ev, f), dtype=torch.float64)
                .nan_to_num() for f in ev._fields}
    bitwise, rel, _ = compare_twins(torch, fields(e), fields(g1))
    same_graphs = compare_twins(torch, fields(g1), fields(g2))[0]
    n_sweeps = 250 + 64 * 25
    print(f"graph-eval eval-4k (4096 walkers, 250 + 64 x 25 sweeps; turns "
          f"graph, eager, graph, CUDA events): {ms[0] / 1e3:.3f} / "
          f"{ms[1] / 1e3:.3f} / {ms[2] / 1e3:.3f} s, sweeps/s graph "
          f"{n_sweeps / ms[2] * 1e3:.1f} against eager "
          f"{n_sweeps / ms[1] * 1e3:.1f} ({ms[1] / ms[2]:.2f}x) | graph "
          f"against eager: {'equal to the bit' if bitwise else 'NOT bitwise'}"
          f" (largest relative difference {rel:.3e}; raw {g1.e_mean:.6f} "
          f"+- {g1.e_stderr:.6f}, clipped {g1.e_clipped:.6f}); the two "
          f"graphed runs equal: {same_graphs} | launches graph {counts[0]}, "
          f"eager {counts[1]}", flush=True)
    if not (bitwise or rel <= GRAPH_MAX_REL) or not same_graphs:
        fail(f"graph-eval: the graphed evaluation differs from the eager one "
             f"by {rel:.3e} relative (limit {GRAPH_MAX_REL:g}), or from "
             "itself")
    if counts[0] != counts[1] or counts[0] != counts[2]:
        fail(f"graph-eval: launches differ: {counts}")

    # the shipped block graph alone (evaluation_windows, as evaluate_energy
    # builds it): one warm-up block and the capture, then 5 replays timed
    # by CUDA events and 5 profiled
    model, gen = trainer.model, torch.Generator('cuda').manual_seed(3)
    _, blocks = evaluation_windows(model.psi, trainer.h_fn, model.log_pdf,
                                   10.0, model.sample(4096, generator=gen),
                                   gen)
    blocks.window(1)
    _, replay_ms = events_ms(torch, lambda: blocks.window(5))
    prof = profile_window(torch, lambda: blocks.window(5), 5,
                          "graph-eval block (25 sweeps + E_L) ",
                          unit='blocks')
    prof['idle_unprofiled'] = 1 - prof['busy_ms'] / replay_ms
    print(f"graph-eval: device busy {prof['busy_ms'] / 5:.3f} ms per "
          f"replayed block (profiler) against {replay_ms / 5:.3f} ms per "
          f"block unprofiled (CUDA events): idle share "
          f"{prof['idle_unprofiled']:.4f}", flush=True)
    return counts[0], dict(graph_s=ms[2] / 1e3, graph_first_s=ms[0] / 1e3,
                           eager_s=ms[1] / 1e3,
                           graph_sweeps_per_s=n_sweeps / ms[2] * 1e3,
                           eager_sweeps_per_s=n_sweeps / ms[1] * 1e3,
                           bitwise=bitwise, max_rel_diff=rel, profile=prof)


def gate_phase(torch, label, run_dir, config, jax_raw, jax_clipped):
    """The frozen-parameter evaluation of a committed JAX run at the JAX
    protocol (4,096 walkers, 250 + 64 × 25 sweeps): raw and clipped means
    within 5 combined stderr of the JAX figures (``jax_raw`` with a stderr
    of None is reported, not gated)."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, evaluate_trainer
    trainer = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cuda',
                                   **config))
    if not trainer.load_checkpoint(str(run_dir)):
        fail(f"no checkpoint under {run_dir}")
    reset_counts()
    t0 = time.perf_counter()
    ev = evaluate_trainer(trainer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    d_clip = sigmas(ev.e_clipped, ev.e_clipped_stderr, jax_clipped)
    d_raw = (None if jax_raw[1] is None
             else sigmas(ev.e_mean, ev.e_stderr, jax_raw))
    raw_txt = ("not gated: the JAX figure has no stderr" if d_raw is None
               else f"{d_raw:.2f} combined sigma")
    print(f"{label} evaluation ({run_dir.name}, epoch {trainer.epoch}): raw "
          f"E = {ev.e_mean:.6f} +- {ev.e_stderr:.6f} against the JAX raw "
          f"{jax_raw[0]} +- {jax_raw[1]} ({raw_txt}) | clipped "
          f"{ev.e_clipped:.6f} +- {ev.e_clipped_stderr:.6f} against "
          f"{jax_clipped[0]} +- {jax_clipped[1]}: {d_clip:.2f} combined sigma "
          f"| accept rate {ev.accept_rate:.4f} | {wall:.2f} s | launches: "
          f"sampler {launches['sampler']}, basis_jet {launches['basis_jet']}",
          flush=True)
    if not (math.isfinite(ev.e_clipped) and d_clip <= 5.0):
        fail(f"{label}: clipped mean {ev.e_clipped} is {d_clip:.2f} combined "
             f"sigma from the JAX clipped mean {jax_clipped}")
    if d_raw is not None and not (math.isfinite(ev.e_mean) and d_raw <= 5.0):
        fail(f"{label}: raw mean {ev.e_mean} is {d_raw:.2f} combined sigma "
             f"from the JAX raw mean {jax_raw}")
    if min(launches.values()) == 0:
        fail(f"a kernel of the path was not launched in {label}'s "
             f"evaluation: {launches}")
    return launches, dict(raw=ev.e_mean, raw_stderr=ev.e_stderr,
                          clipped=ev.e_clipped,
                          clipped_stderr=ev.e_clipped_stderr,
                          raw_sigma=d_raw, clipped_sigma=d_clip,
                          accept_rate=ev.accept_rate, wall_s=wall)


def vmap_phase(torch):
    """K3 under ``vmap(grad)``: SPRING's per-walker score matrix O of the
    r4_spring100k parameters at 256 ancestral walkers, through the kernel
    backend against the plain basis-jet core on the same walkers.  The
    kernel runs once per jet call for the whole batch (4 jets in ψ: 3 IMADE
    layers and the prior); O agrees with the plain core's to 1e-4 of the
    largest entry."""
    from waveflow_tpu_torch.convert import load_jax_checkpoint, params_from_jax
    from waveflow_tpu_torch.vmc.sr import make_score_fn
    params = params_from_jax(load_jax_checkpoint(
        SPRING_RUN / 'checkpoints')['params'])
    models = {}
    for backend in ('poly_pallas', 'poly'):
        m = flagship_model(torch, params, backend)
        models[backend] = make_score_fn(m)
    batch = m.sample(256, generator=torch.Generator('cuda').manual_seed(4))
    flatten, scores_k = models['poly_pallas']
    flat = flatten()
    reset_counts()
    O_k = scores_k(flat, batch)
    torch.cuda.synchronize()
    per_call = read_counts()['basis_jet']
    O_p = models['poly'][1](flat, batch)
    err = (O_k - O_p).abs().max().item()
    scale = O_p.abs().max().item()
    ms_k = cuda_ms(torch, lambda: scores_k(flat, batch), reps=10)
    ms_p = cuda_ms(torch, lambda: models['poly'][1](flat, batch), reps=10)
    k3_dev_ms = k3_device_ms(torch, lambda: scores_k(flat, batch), per_call)
    k3_bound, k3_by = k3_bound_ms(2 * 256)
    print(f"K3 under vmap(grad): score matrix {tuple(O_k.shape)} of "
          f"r4_spring100k at 256 walkers, kernel against the plain "
          f"core: max|dO| {err:.3e} (largest |O| {scale:.3e}, limit 1e-4 of "
          f"it) | K3 launches per score matrix {per_call} (4 jet calls) | "
          f"{ms_k:.2f} ms per score matrix ({ms_p:.2f} with the plain core) "
          f"| K3 device time {k3_dev_ms:.4f} ms per score matrix (4 launches "
          f"at R = 512; profiler), bound {k3_bound:.5f} ms ({k3_by})",
          flush=True)
    if not (torch.isfinite(O_k).all() and err <= 1e-4 * scale):
        fail(f"K3 under vmap(grad) disagrees with the plain core: {err:.3e}")
    if per_call != 4:
        fail(f"the score matrix launched K3 {per_call} times, not once per "
             "jet call (4)")
    return dict(max_abs_err=err, max_abs_O=scale, launches_per_call=per_call,
                ms=ms_k, plain_ms=ms_p, k3_device_ms=k3_dev_ms,
                k3_bound_ms=k3_bound, k3_bound_by=k3_by)


def k3_bound_ms(R: int):
    """The bound of ψ's four basis jets at R sites each (3 IMADE layers on
    the 29-basis I-spline jet, the prior on the 28-basis OB jet), as
    check_basis_jet counts one: x read, A_jet read, the jet written; 2
    operations per multiply-add of the local polynomial."""
    from waveflow_tpu_torch import ops
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    n_bytes = n_ops = 0
    for kind, use_ob, count in (('I', False, 3), ('B', True, 1)):
        ev = ops.make_poly_evaluator(ops.get_tables(kind, deg, knots,
                                                    n_mesh=mesh),
                                     use_ob=use_ob, jet_backend='pallas',
                                     device='cuda')
        A = ev.A_jet
        N = A.shape[1]
        n_bytes += count * 4 * (R + A.numel() + R * N)
        n_ops += count * 2 * R * N * ev.ncoef
    return bound_ms(n_bytes, n_ops)


def k3_device_ms(torch, fn, expected: int) -> float:
    """K3's own device time in one call of ``fn`` (profiler), summed over
    its ``expected`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and 'basis_jet' in e.key]
    if sum(e.count for e in kern) != expected:
        fail(f"the profiler saw {sum(e.count for e in kern)} K3 launches, "
             f"not {expected}")
    return sum(e.self_device_time_total for e in kern) / 1e3


def launch_device_ms(torch, fn, key: str, reps: int = 20) -> float:
    """The mean device time of one launch of the kernel whose name holds
    ``key``, over ``reps`` calls of ``fn`` in one profiler pass.  After
    profiled graph replays the profiler drops such eager launches (seen:
    19 of 20 recorded after one graph phase, none after all of them; the
    k4-vmap phase therefore runs first), so the mean is over the launches
    it recorded; the launch count itself is checked by the wrappers'
    counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key]
    n = sum(e.count for e in kern)
    if not 0 < n <= reps:
        fail(f"the profiler saw {n} {key} launches in {reps} calls")
    return sum(e.self_device_time_total for e in kern) / 1e3 / n


def window_phase(torch, label, run_dir, config, n_epochs, profile=0):
    """One training window resumed from a committed JAX run at batch 256
    with the kernel backend, graphed (the trainer's default on the card:
    its first epoch warms up and captures): finite losses, walkers/s (host
    clock), the MCMC accept rate, SPRING's counters, launches per epoch;
    ``profile`` further replayed epochs under the profiler."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    t = VMCTrainer(VMCConfig(batch_size=256, window=n_epochs,
                             log_every=n_epochs, eval_backend='poly_pallas',
                             device='cuda', **config))
    if not t.load_checkpoint(str(run_dir)):
        fail(f"no checkpoint under {run_dir}")
    opt0 = t.step.optimizer.state_dict()
    spring = isinstance(opt0, dict) and 'delta' in opt0
    counters0 = ({k: int(v) for k, v in opt0.items() if k != 'delta'}
                 if spring else None)
    n0 = len(t.losses)
    reset_counts()
    t0 = time.perf_counter()
    losses = t.train(n_epochs, verbose=False)[n0:]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    wps = n_epochs * 256 / wall
    out = dict(walkers_per_s=wps, wall_s=wall, last_loss=losses[-1],
               graphed=t.graph,
               launches_per_epoch={k: v / n_epochs
                                   for k, v in launches.items()})
    extra = ""
    if t.accept_rates:
        out['accept_rate'] = sum(t.accept_rates) / len(t.accept_rates)
        extra += f" | mean accept rate {out['accept_rate']:.4f}"
    if counters0 is not None:
        out['counters'] = {k: int(v) for k, v in
                           t.step.optimizer.state_dict().items()
                           if k != 'delta'}
        extra += f" | counters {counters0} -> {out['counters']}"
    print(f"{label}: {run_dir.name} resumed at epoch {t.epoch - n_epochs}, "
          f"{n_epochs} epochs at batch 256, last loss {losses[-1]:.5f} | "
          f"walkers/s {wps:.1f} (host clock, "
          f"{'graphed' if t.graph else 'eager'} window){extra} | launches "
          "per epoch: "
          f"sampler {launches['sampler'] / n_epochs:g}, basis_jet "
          f"{launches['basis_jet'] / n_epochs:g}", flush=True)
    if len(losses) != n_epochs or not all(math.isfinite(v) for v in losses):
        fail(f"{label} produced non-finite losses")
    if 'accept_rate' in out and not 0.3 <= out['accept_rate'] <= 0.7:
        fail(f"{label} mean accept rate {out['accept_rate']} outside "
             "[0.3, 0.7]")
    if launches['basis_jet'] == 0:
        fail(f"K3 was not launched in {label}")
    if not t.graph:
        fail(f"{label}: the window ran eagerly")
    if profile:
        profile_window(torch, lambda: replayed_window(t, profile), profile,
                       f"{label} graphed window ")
    return launches, out


def li_window_phase(torch):
    """Li (3 electrons) resumed from r5_li_metro_refresh100_s3 with its
    configuration, one Metropolis window of 20 epochs under the 'auto'
    refresh (one exact ancestral refresh of the walkers per window for >= 3
    electrons): K1 launched on an MCMC path, 3 columns per refresh."""
    launches, out = window_phase(torch, 'li-256', LI_RUN,
                                 dict(LI_CONFIG, mcmc_refresh_every='auto'),
                                 20)
    if launches['sampler'] != 3:
        fail(f"the Li window's refresh launched K1 {launches['sampler']} "
             "times, not 3 (one per column)")
    return launches, out


def flagship_model(torch, params, eval_backend, sampling_backend='table',
                   device='cuda'):
    """The flagship Waveflow on the card (or ``device``) with the given
    parameters."""
    from waveflow_tpu_torch.models import get_waveflow_model
    m = get_waveflow_model(
        2, base_spline_degree=FLAGSHIP['spline_degree'],
        i_spline_degree=FLAGSHIP['spline_degree'],
        n_prior_internal_knots=FLAGSHIP['num_knots'],
        n_i_internal_knots=FLAGSHIP['num_knots'], i_spline_reg=0.05,
        n_flow_layers=3, box_size=10.0, eval_backend=eval_backend,
        sampling_backend=sampling_backend,
        generator=torch.Generator().manual_seed(0), device=device)
    m.load_state_dict(params)
    return m


def he_hamiltonian(model, mode, eps=0.0):
    from waveflow_tpu_torch.physics import (
        construct_hamiltonian_function, system_catalogue)
    return construct_hamiltonian_function(
        model.psi, protons=system_catalogue[1]['He'][0],
        n_space_dimensions=1, eps=eps, laplacian_mode=mode)


def counted(torch, fn):
    """(fn(), the kernel launches it made), synchronised."""
    before = read_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in read_counts().items()}


LAP_FORMS = (('fwd_batched', 0.0), ('fwd', 0.0), ('hvp', 0.0),
             ('dense', 0.0), ('fwd', 0.1))


def lap_forms_phase(torch, params):
    """Hψ of the 100k checkpoint at 4,096 ancestral walkers under every
    Laplacian form on the kernel backend: 'fwd' (per walker, K3 through its
    vmap rule), 'hvp', 'dense' against 'fwd_batched' within
    LAP_FORMS_RTOL of max|Hψ|; the finite difference (eps 0.1) against the
    same form on the plain core within LAP_FD_RTOL, and its O(ε²) gap to
    the analytic form reported.  K3 launched by every form, K3 launches
    and ms (CUDA events) per Hψ pass reported."""
    mk = flagship_model(torch, params, 'poly_pallas')
    mp = flagship_model(torch, params, 'poly')
    x = mk.sample(4096, generator=torch.Generator('cuda').manual_seed(11))
    reset_counts()
    hs, rows = {}, {}
    with torch.no_grad():
        for mode, eps in LAP_FORMS:
            h = he_hamiltonian(mk, mode, eps)
            v, n = counted(torch, lambda: h(x)[:, 0])
            name = f"{mode}{' eps=0.1' if eps else ''}"
            hs[name] = v
            rows[name] = dict(k3_per_pass=n['basis_jet'],
                              k1_per_pass=n['sampler'],
                              ms=cuda_ms(torch, lambda: h(x), reps=5,
                                         warmup=1))
        launches = read_counts()
        h_fd_plain = he_hamiltonian(mp, 'fwd', 0.1)
        fd_plain, n_plain = counted(torch, lambda: h_fd_plain(x)[:, 0])
        fd_plain_ms = cuda_ms(torch, lambda: h_fd_plain(x), reps=5, warmup=1)
    ref = hs['fwd_batched']
    scale = ref.abs().max().item()
    for name, v in hs.items():
        row = rows[name]
        if name.endswith('eps=0.1'):
            row['rel_err'] = (v - fd_plain).abs().max().item() / scale
            row['gap_to_analytic'] = (v - ref).abs().max().item() / scale
            row['plain_ms'] = fd_plain_ms
            limit, against = LAP_FD_RTOL, "the plain core's"
        else:
            row['rel_err'] = (v - ref).abs().max().item() / scale
            limit, against = LAP_FORMS_RTOL, "'fwd_batched''s"
        extra = (f"; O(eps^2) gap to the analytic form "
                 f"{row['gap_to_analytic']:.3e}, plain core "
                 f"{fd_plain_ms:.2f} ms" if 'gap_to_analytic' in row else "")
        print(f"lap-forms {name}: max|dHpsi| {row['rel_err']:.3e} of "
              f"max|Hpsi| {scale:.4f} against {against} (limit {limit:g}) | "
              f"K3 {row['k3_per_pass']} and K1 {row['k1_per_pass']} launches "
              f"per Hpsi pass at 4096 walkers | {row['ms']:.2f} ms per pass"
              f"{extra}", flush=True)
        if not (torch.isfinite(v).all() and row['rel_err'] <= limit):
            fail(f"lap-forms: {name} disagrees by {row['rel_err']:.3e} of "
                 f"max|Hpsi| (limit {limit:g})")
        if row['k3_per_pass'] == 0:
            fail(f"lap-forms: {name} did not launch K3 on a CUDA tensor")
    if n_plain['basis_jet']:
        fail("the plain core launched K3")
    return launches, rows


REF_GRAD_RTOL = 1e-3


def reference_grad_phase(torch, params):
    """The 'reference' loss's parameter gradient (reverse mode through the
    Laplacian and local_energy's rule) at 256 ancestral walkers and baseline
    −1.8 on the kernel backend against the plain core, under 'fwd_batched'
    and 'dense': relative global-norm error within REF_GRAD_RTOL, every
    entry finite; K3 launches and ms (CUDA events) per gradient."""
    from waveflow_tpu_torch.vmc import make_loss_fn
    models = {'kernel': flagship_model(torch, params, 'poly_pallas'),
              'plain': flagship_model(torch, params, 'poly')}
    x = models['kernel'].sample(
        256, generator=torch.Generator('cuda').manual_seed(12))
    baseline = torch.tensor(-1.8, device='cuda')
    reset_counts()
    rows = {}
    for mode in ('fwd_batched', 'dense'):
        flat, row = {}, {}
        for name, m in models.items():
            loss_fn = make_loss_fn(m.psi, he_hamiltonian(m, mode),
                                   estimator='reference')
            ps = list(m.parameters())

            def grad():
                g = torch.autograd.grad(loss_fn(x, baseline), ps,
                                        allow_unused=True)
                return torch.cat([torch.zeros_like(p).ravel() if gi is None
                                  else gi.ravel() for p, gi in zip(ps, g)])

            flat[name], n = counted(torch, grad)
            row[f'{name}_ms'] = cuda_ms(torch, grad, reps=3, warmup=1)
            row[f'{name}_k3'] = n['basis_jet']
        gk, gp = flat['kernel'], flat['plain']
        row['rel_err'] = ((gk - gp).norm() / gp.norm()).item()
        rows[mode] = row
        print(f"reference-grad {mode}: |dg| / |g| {row['rel_err']:.3e} "
              f"kernel against plain core (limit {REF_GRAD_RTOL:g}), |g| "
              f"{gp.norm().item():.4e} over {gp.numel()} entries | K3 "
              f"{row['kernel_k3']} launches per gradient | "
              f"{row['kernel_ms']:.2f} ms per gradient (plain core "
              f"{row['plain_ms']:.2f})", flush=True)
        if not (torch.isfinite(gk).all() and row['rel_err'] <= REF_GRAD_RTOL):
            fail(f"reference-grad {mode}: the kernel's gradient is "
                 f"{row['rel_err']:.3e} from the plain core's")
        if row['kernel_k3'] == 0 or row['plain_k3']:
            fail(f"reference-grad {mode}: K3 launches {row}")
    return read_counts(), rows


def reference_window_phase(torch):
    """The reference design — estimator='reference' with
    laplacian_mode='dense', adam, ancestral walkers, the kernel backend —
    from the 100k checkpoint: one window of 10 epochs at batch 256, then
    2 epochs profiled; and one window of 10 of 'reference' on
    'fwd_batched'.  Every loss finite; the window's baseline equal to the
    bit to the mean of its losses; walkers/s and launches per epoch."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    rows, total = {}, {'sampler': 0, 'basis_jet': 0}
    for mode in ('dense', 'fwd_batched'):
        t = VMCTrainer(VMCConfig(batch_size=256, window=10, log_every=10,
                                 estimator='reference', laplacian_mode=mode,
                                 eval_backend='poly_pallas', device='cuda'))
        if not t.load_checkpoint(str(CHECKPOINT.parent)):
            fail(f"no checkpoint under {CHECKPOINT.parent}")
        n0 = len(t.losses)
        reset_counts()
        t0 = time.perf_counter()
        t.train(10, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        losses = t.losses[n0:]
        mean = torch.tensor(losses, device='cuda').mean()
        wps = 10 * 256 / wall
        rows[mode] = dict(walkers_per_s=wps, wall_s=wall, last_loss=losses[-1],
                          launches_per_epoch={k: v / 10
                                              for k, v in launches.items()})
        print(f"reference-256 {mode}: 10 epochs at batch 256 from the 100k "
              f"checkpoint, losses finite: "
              f"{all(math.isfinite(v) for v in losses)}, last "
              f"{losses[-1]:.5f}, baseline {t.baseline.item():.6f} "
              f"(= the window's mean loss: {torch.equal(t.baseline, mean)}) "
              f"| walkers/s {wps:.1f} (host clock) | launches per epoch: "
              f"sampler {launches['sampler'] / 10:g}, basis_jet "
              f"{launches['basis_jet'] / 10:g}", flush=True)
        if len(losses) != 10 or not all(math.isfinite(v) for v in losses):
            fail(f"reference-256 {mode} produced non-finite losses")
        if not torch.equal(t.baseline, mean):
            fail(f"reference-256 {mode}: baseline {t.baseline.item()} is not "
                 f"the window's mean loss {mean.item()}")
        if min(launches.values()) == 0:
            fail(f"a kernel of the path was not launched in reference-256 "
                 f"{mode}: {launches}")
        total = {k: total[k] + v for k, v in launches.items()}
        if mode == 'dense':
            profile_window(torch, lambda: t.train(2, verbose=False), 2,
                           "reference-256 dense ")
    return total, rows


# the tails of the uniforms in the poly-sample phase
U_TAILS = (0.0, 1e-7, 1e-4, 1.0 - 1e-7, 1.0 - 1e-4)


def poly_sample_phase(torch, params, jax_raw):
    """sampling_backend='poly' (the exact poly-density sampler) under
    'poly_pallas' at 65,536 walkers from the 100k checkpoint: each prior
    column's draws within POLY_QUANTILE_TOL of their uniforms under the
    float64 CDF of the polynomial density (tails included), the model's
    ``sample`` giving the same walkers with no K1 launch, and the raw mean
    of one E_L pass over 65,536 other draws (the seed of phase 4's, no
    forced tails) within 5 combined stderr of the JAX raw mean.  Then ms
    (CUDA events) per sample(256) and sample(65,536) for 'poly' and
    'table', and one window of 100 epochs at batch 256 with each."""
    from waveflow_tpu_torch.ops import sample_squared_amplitude_poly
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    models = {'poly': flagship_model(torch, params, 'poly_pallas', 'poly'),
              'table': flagship_model(torch, params, 'poly_pallas')}
    m = models['poly']
    B = 65536
    u = torch.rand((2, B), generator=torch.Generator('cuda').manual_seed(13),
                   device='cuda')
    u[:, :len(U_TAILS)] = torch.tensor(U_TAILS, device='cuda')
    reset_counts()
    with torch.no_grad():
        outputs = torch.zeros((B, 2), device='cuda')
        q_err = []
        for i in range(2):
            c = m.ob_coeffs(outputs)[:, i]
            col = sample_squared_amplitude_poly(m.fwd_ob, c, u[i])
            q_err.append(poly_quantile_err(torch, m.fwd_ob, c, u[i],
                                           col).max().item())
            outputs[:, i] = col
        x_cols = m.transform.inverse(outputs)[0]
        x, n_sample = counted(torch, lambda: m.sample(B, u=u))
        # the energy on draws without the forced tails (a draw at u = 0
        # sits on ψ's zero at the box edge, where E_L is unbounded)
        xe = m.sample(B, generator=torch.Generator('cuda').manual_seed(7))
        e_loc = he_hamiltonian(m, 'fwd_batched')(xe)[:, 0] / m.psi(xe)
    launches = read_counts()
    mean = e_loc.mean().item()
    stderr = (e_loc.std() / math.sqrt(B)).item()
    d_raw = sigmas(mean, stderr, jax_raw)
    print(f"poly-sample: |F64(x) - u| of the prior columns at {B} walkers "
          f"(tails {U_TAILS} included): {q_err[0]:.3e}, {q_err[1]:.3e} "
          f"(limit {POLY_QUANTILE_TOL:g}) | sample() equal to the column "
          f"loop: {torch.equal(x, x_cols)}, K1 launches in it "
          f"{n_sample['sampler']} | raw E = {mean:.6f} +- {stderr:.6f} over "
          f"one E_L pass; JAX evaluation raw mean {jax_raw[0]} +- "
          f"{jax_raw[1]}: {d_raw:.2f} combined sigma", flush=True)
    if max(q_err) > POLY_QUANTILE_TOL:
        fail(f"poly-sample: draws {max(q_err):.3e} from their quantiles")
    if not torch.equal(x, x_cols) or n_sample['sampler']:
        fail("poly-sample: the model's sample did not take the poly sampler")
    if not (math.isfinite(mean) and d_raw <= 5.0):
        fail(f"poly-sample: raw mean {mean} is {d_raw:.2f} combined sigma "
             f"from the JAX raw mean {jax_raw}")
    timing = {}
    with torch.no_grad():
        for name, mm in models.items():
            g = torch.Generator('cuda').manual_seed(14)
            timing[name] = [cuda_ms(torch, lambda: mm.sample(n, generator=g),
                                    reps=reps, warmup=1)
                            for n, reps in ((256, 20), (B, 5))]
    for name in models:
        t = VMCTrainer(VMCConfig(batch_size=256, window=100, log_every=100,
                                 sampling_backend=name,
                                 eval_backend='poly_pallas', device='cuda'))
        if not t.load_checkpoint(str(CHECKPOINT.parent)):
            fail(f"no checkpoint under {CHECKPOINT.parent}")
        n0 = len(t.losses)
        t0 = time.perf_counter()
        t.train(100, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = t.losses[n0:]
        if len(losses) != 100 or not all(math.isfinite(v) for v in losses):
            fail(f"poly-sample: the {name} window produced non-finite losses")
        timing[name].append(100 * 256 / wall)
        print(f"poly-sample {name}: sample(256) {timing[name][0]:.3f} ms, "
              f"sample({B}) {timing[name][1]:.3f} ms (CUDA events) | one "
              f"window of 100 epochs at batch 256: walkers/s "
              f"{timing[name][2]:.1f} (host clock), last loss "
              f"{losses[-1]:.5f}", flush=True)
    return launches, dict(quantile_err=q_err, raw=mean, raw_stderr=stderr,
                          raw_sigma=d_raw, timing=timing)


def density_phase(torch):
    """The density-estimation path at full width: MFlow trained by MLE on
    20,000 'circles' points, 200 epochs, a metric checkpoint every 100.
    Returns the launches of K2 and of both K4 kernels on that run."""
    from waveflow_tpu_torch.benchmark import get_dataset, train_density_model
    from waveflow_tpu_torch.benchmark.density import (
        density_epochs, density_optimizer, get_benchmark_model,
        metric_checkpoint)
    from waveflow_tpu_torch.ops import cuda_sampler, cuda_spline
    n_epochs, log_every = 200, 100
    X = get_dataset('circles', DENSITY_POINTS)
    X_test = get_dataset('circles', 5000, seed=43)
    kw = dict(model_name='MFlow', learning_rate=1e-4, log_every=log_every,
              n_model_sample=DENSITY_POINTS, X_test=X_test, device='cuda',
              **DENSITY)
    cuda_sampler.launches_linear = 0
    cuda_spline.launches = cuda_spline.launches_bwd = 0
    t0 = time.perf_counter()
    model, hist = train_density_model(X, num_epochs=n_epochs, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {'sampler_linear': cuda_sampler.launches_linear,
                'spline_eval': cuda_spline.launches,
                'spline_eval_bwd': cuda_spline.launches_bwd}
    losses = hist['losses']
    if len(losses) != n_epochs or not all(math.isfinite(v) for v in losses):
        fail("density training produced non-finite losses")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if not last < first:
        fail(f"density loss did not fall: first 10 mean {first:.5f}, last 10 "
             f"mean {last:.5f}")
    n_ckpt = n_epochs // log_every
    if launches['sampler_linear'] != 2 * n_ckpt:
        fail(f"K2 launched {launches['sampler_linear']} times for {n_ckpt} "
             "metric checkpoints of 2 columns")
    # every epoch: one forward and one backward launch; the checkpoints'
    # log_pdf calls add forward launches only
    if (launches['spline_eval'] < n_epochs
            or launches['spline_eval_bwd'] != n_epochs):
        fail(f"K4 launched {launches['spline_eval']} times forward and "
             f"{launches['spline_eval_bwd']} times backward in {n_epochs} "
             "epochs")
    for key in ('kl', 'hellinger', 'test_ll', 'reconstruction'):
        if len(hist[key]) != n_ckpt or not all(
                math.isfinite(v) for v in hist[key]):
            fail(f"density metric {key} is missing or not finite: {hist[key]}")
    if not max(hist['reconstruction']) < 1e-3:
        fail(f"reconstruction distance {max(hist['reconstruction']):.3e} >= 1e-3")
    print(f"density: {n_epochs} epochs at batch {DENSITY_POINTS}, losses "
          f"finite, first-10 mean {first:.5f} -> last-10 mean {last:.5f} | "
          f"KL {hist['kl'][-1]:.4f} H2 {hist['hellinger'][-1]:.4f} held-out LL "
          f"{hist['test_ll'][-1]:.4f} recon {hist['reconstruction'][-1]:.3e} | "
          f"whole run (first calls and {n_ckpt} metric checkpoints included) "
          f"{t1 - t0:.2f} s | launches: sampler_linear "
          f"{launches['sampler_linear']} "
          f"({launches['sampler_linear'] / n_ckpt:g} per checkpoint), "
          f"spline_eval {launches['spline_eval']} (1 per epoch + "
          f"{(launches['spline_eval'] - n_epochs) / n_ckpt:g} per "
          f"checkpoint), spline_eval_bwd {launches['spline_eval_bwd']} (1 "
          "per epoch)", flush=True)

    # the card against the CPU: the same parameters in a CPU module
    cpu = get_benchmark_model('MFlow', **DENSITY, device='cpu')
    cpu.load_state_dict(model.state_dict())
    pts = torch.as_tensor(X[:4096])
    with torch.no_grad():
        lp_card = model.log_pdf(pts.cuda()).cpu()
        lp_cpu = cpu.log_pdf(pts)
    err = (lp_card - lp_cpu).abs().max().item()
    print(f"density: log_pdf of 4096 points, card against CPU (plain paths): "
          f"max |d| {err:.3e} (atol 1e-4)", flush=True)
    if not err <= 1e-4:
        fail("log_pdf on the card disagrees with the CPU")

    # where an epoch's time goes: host clock per eager stage, then replayed
    # epochs timed and profiled
    opt = density_optimizer(model, 1e-4)
    X_dev = torch.as_tensor(X, device='cuda')
    held = {}

    def forward():
        held['loss'] = -model.log_pdf(X_dev).mean()

    def backward_adam():
        # every timed call needs a fresh graph; its forward is timed above
        forward()
        opt.zero_grad(set_to_none=True)
        held['loss'].backward()
        opt.step()

    ms_fwd = host_ms(torch, forward)
    ms_all = host_ms(torch, backward_adam)
    gen = torch.Generator('cuda').manual_seed(8)
    ms_ckpt = host_ms(torch, lambda: metric_checkpoint(
        model, DENSITY_POINTS, gen, X_test), n=2)
    print(f"density epoch stages (host clock, batch {DENSITY_POINTS}): forward "
          f"{ms_fwd:.2f} ms | backward + adam {ms_all - ms_fwd:.2f} ms (a "
          f"whole step {ms_all:.2f} ms less the forward) | one metric "
          f"checkpoint ({DENSITY_POINTS} draws, 300x300 KDE, round trip, held-out "
          f"LL) "
          f"{ms_ckpt:.1f} ms", flush=True)

    # the last timed forward's autograd graph holds the parameters' grad
    # accumulators, made on the default stream: a capture whose backward
    # met them would wait on that stream, which CUDA refuses
    held.clear()
    epochs = density_epochs(model, opt, X_dev,
                            torch.Generator('cuda').manual_seed(9))
    epochs.window(1)        # the warm-up epoch and the capture
    # a further block of 100 replayed epochs, without its checkpoint
    ms_epoch = host_ms(torch, lambda: epochs.window(100), n=1) / 100
    print(f"density: points/s {DENSITY_POINTS / ms_epoch * 1e3:.1f} (a "
          f"further block of 100 replayed epochs, {ms_epoch:.3f} ms per "
          "epoch)", flush=True)
    profile_window(torch, lambda: epochs.window(10), 10, "density replayed ")
    return launches


def eval_2d_phase(torch, label, run_dir, config, jax_row, fidelity=None):
    """A committed 2D run evaluated at the JAX protocol (4,096 walkers, 250
    + 64 × 25 sweeps, step 0.4, the sector of its resolved coordinate map):
    raw and clipped means within 5 combined stderr of ``jax_row``'s, the
    accept rate in [0.45, 0.55], K1 (the warm start) and K3 launched; K3's
    launches per Hψ pass at 4,096 walkers, which the permuted batch of the
    antisym ansatz widens and does not multiply: 4 jets (3 IMADE layers and
    the prior) per coordinate; the peak device memory of the evaluation,
    in all and above what was allocated before it.
    ``fidelity`` = (the ED40 npz, the JAX figure): ``fidelity_2d_2e``
    against the ED's ground subspace within FIDELITY_TOL."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, evaluate_trainer
    trainer = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cuda',
                                   **config))
    if not trainer.load_checkpoint(str(run_dir)):
        fail(f"no checkpoint under {run_dir}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    ev = evaluate_trainer(trainer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    jax_raw = (jax_row['eval_mean'], jax_row['eval_stderr'])
    jax_clipped = (jax_row['eval_clipped'], jax_row['eval_clipped_stderr'])
    d_raw = sigmas(ev.e_mean, ev.e_stderr, jax_raw)
    d_clip = sigmas(ev.e_clipped, ev.e_clipped_stderr, jax_clipped)
    x = trainer.model.sample(4096,
                             generator=torch.Generator('cuda').manual_seed(5))
    with torch.no_grad():
        _, per_pass = counted(torch, lambda: trainer.h_fn(x))
    D = trainer.input_dim
    out = dict(raw=ev.e_mean, raw_stderr=ev.e_stderr, clipped=ev.e_clipped,
               clipped_stderr=ev.e_clipped_stderr, raw_sigma=d_raw,
               clipped_sigma=d_clip, accept_rate=ev.accept_rate, wall_s=wall,
               peak_memory_bytes=peak, eval_memory_bytes=peak - before,
               k3_per_pass=per_pass['basis_jet'],
               ansatz=trainer.ansatz, xu_coord_type=trainer.xu_coord_type)
    if 'exact_analytic' in jax_row:
        out['analytic'] = jax_row['exact_analytic']
    print(f"{label} ({run_dir.name}, epoch {trainer.epoch}, {trainer.ansatz} "
          f"on '{trainer.xu_coord_type}', {D} coordinates; 4096 walkers, 250 "
          f"+ 64 x 25 sweeps): raw E = {ev.e_mean:.6f} +- {ev.e_stderr:.6f} "
          f"against the JAX raw {jax_raw[0]} +- {jax_raw[1]}: {d_raw:.2f} "
          f"combined sigma | clipped {ev.e_clipped:.6f} +- "
          f"{ev.e_clipped_stderr:.6f} against {jax_clipped[0]} +- "
          f"{jax_clipped[1]}: {d_clip:.2f} combined sigma"
          + (f" | analytic {out['analytic']}" if 'analytic' in out else "")
          + f" | accept rate {ev.accept_rate:.4f} | {wall:.2f} s wall | peak "
          f"device memory {peak / 2**30:.3f} GiB, the evaluation's own "
          f"{(peak - before) / 2**30:.3f} GiB | launches: sampler "
          f"{launches['sampler']}, basis_jet {launches['basis_jet']} | K3 per "
          f"H psi pass at 4096 walkers {per_pass['basis_jet']}", flush=True)
    if not (math.isfinite(ev.e_mean) and d_raw <= 5.0):
        fail(f"{label}: raw mean {ev.e_mean} is {d_raw:.2f} combined sigma "
             f"from the JAX raw mean {jax_raw}")
    if not (math.isfinite(ev.e_clipped) and d_clip <= 5.0):
        fail(f"{label}: clipped mean {ev.e_clipped} is {d_clip:.2f} combined "
             f"sigma from the JAX clipped mean {jax_clipped}")
    if not 0.45 <= ev.accept_rate <= 0.55:
        fail(f"{label}: accept rate {ev.accept_rate} outside [0.45, 0.55]")
    if min(launches.values()) == 0:
        fail(f"a kernel of the path was not launched in {label}: {launches}")
    if per_pass['basis_jet'] != 4 * D:
        fail(f"{label}: {per_pass['basis_jet']} K3 launches per H psi pass, "
             f"not 4 per coordinate ({4 * D})")
    if fidelity is not None:
        import numpy as np
        from waveflow_tpu_torch.utils import fidelity_2d_2e
        ed_path, ref = fidelity
        ed = np.load(ed_path)
        t0 = time.perf_counter()
        fid = fidelity_2d_2e(trainer.model.psi, ed['psi'], ed['sites'],
                             ed['x'], device='cuda')
        out.update(fidelity=fid, fidelity_s=time.perf_counter() - t0)
        print(f"{label}: fidelity against the {ed['psi'].shape[1]}-state "
              f"ED40 ground subspace ({ed['psi'].shape[0]} pairs) {fid:.6f}, "
              f"JAX {ref} ({out['fidelity_s']:.1f} s)", flush=True)
        if not abs(fid - ref) <= FIDELITY_TOL:
            fail(f"{label}: fidelity {fid} is not within {FIDELITY_TOL} of "
                 f"the JAX figure {ref}")
    return launches, out


def h2d_fidelity_phase(torch):
    """The 1-electron H-2d run ('independent' map): ``fidelity_2d_1e``
    against the ground state of the 2D grid ED it was judged on, within
    FIDELITY_TOL of the JAX figure (results/h_2d/fidelity.txt); K3 launched
    by the ψ blocks."""
    from waveflow_tpu_torch.physics import exact_ground_state_2d_1e
    from waveflow_tpu_torch.utils import fidelity_2d_1e
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    # "overlap 0.999942" and "ED energy -0.430352"
    ref = dict(line.split(maxsplit=1) for line in
               (H2D_RUN / 'fidelity.txt').read_text().splitlines())
    jax_fid = float(ref['overlap'])
    trainer = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cuda',
                                   **H2D_CONFIG))
    if not trainer.load_checkpoint(str(H2D_RUN)):
        fail(f"no checkpoint under {H2D_RUN}")
    e_ed, psi_grid, x = exact_ground_state_2d_1e(
        trainer.protons, trainer.config.box_length, n_grid=H2D_ED_GRID)
    reset_counts()
    t0 = time.perf_counter()
    fid = fidelity_2d_1e(trainer.model.psi, psi_grid, x, device='cuda')
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"h2d-fidelity ({H2D_RUN.name}, epoch {trainer.epoch}, "
          f"'{trainer.xu_coord_type}' map): fidelity {fid:.6f} against the "
          f"{H2D_ED_GRID}^2-grid ED state, JAX {jax_fid} | ED energy "
          f"{e_ed:.6f} (JAX run: {ref['ED'].split()[-1]}) | {wall:.2f} s | "
          f"launches: basis_jet {launches['basis_jet']}", flush=True)
    if not abs(fid - jax_fid) <= FIDELITY_TOL:
        fail(f"h2d-fidelity: {fid} is not within {FIDELITY_TOL} of the JAX "
             f"figure {jax_fid}")
    if launches['basis_jet'] == 0:
        fail("h2d-fidelity: K3 was not launched")
    return launches, dict(fidelity=fid, ed_energy=e_ed, wall_s=wall)


def graph_2d_phase(torch, label, run_dir, config, k1_per_epoch):
    """A 2D window as a CUDA graph against its eager twin from a committed
    run (``graph_twins``: turns eager, graph, graph, eager of one window of
    TWIN_WINDOW epochs, everything to the bit, launches per epoch equal,
    a window of replays profiled), K1's launches per epoch held to
    ``k1_per_epoch``; then one graphed window of 100 epochs timed by CUDA
    events."""
    launches, row = graph_twins(torch, label,
                                twin_maker(run_dir, config, TWIN_WINDOW),
                                **ONE_WINDOW)
    k1 = row['launches_per_epoch']['graph']['sampler']
    if k1 != k1_per_epoch:
        fail(f"{label}: K1 launched {k1} times per epoch, not {k1_per_epoch}")
    t = twin_maker(run_dir, config, window=100)(None)
    t.train(100, verbose=False)                  # warm-up epoch and capture
    _, ms = events_ms(torch, lambda: t.train(100, verbose=False))
    row['window_100_ms_per_epoch'] = ms / 100
    row['window_100_walkers_per_s'] = 100 * 256 / ms * 1e3
    print(f"{label}: one graphed window of 100 epochs at batch 256 (CUDA "
          f"events): {ms / 100:.3f} ms per epoch, "
          f"{row['window_100_walkers_per_s']:.1f} walkers/s", flush=True)
    return launches, row


# ---- 23-27. the probprog samplers: HMC, NUTS, SMC ---------------------------
POSTERIOR_POINTS = 300           # the posterior example's training points
K4_VMAP_CHAINS = (8, 128)        # HMC / NUTS chains, SMC particles
# depth cut from the example's 150 warm-up + 200 steps, to keep the three
# posterior phases to seconds
POSTERIOR_CUT = {'hmc': dict(n_warmup=20, n_steps=20),
                 'nuts': dict(n_warmup=12, n_steps=12), 'smc': {}}
WAVEFLOW_CHAINS = 256            # JAX's test_hmc_stationary_on_waveflow
WAVEFLOW_MOMENT_ATOL = 0.25      # its tolerance


def example_module(stem: str):
    """examples/<stem>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        stem, ROOT / 'examples' / f'{stem}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def posterior_example():
    """examples/parameter_posterior_torch.py as a module: its model
    settings and ``run_posterior``."""
    return example_module('parameter_posterior_torch')


def k4_counts():
    from waveflow_tpu_torch.ops import cuda_spline
    return cuda_spline.launches, cuda_spline.launches_bwd


def k4_vmap_phase(torch):
    """K4 under ``torch.func.vmap`` over chains at the parameter
    posterior's shapes (C chains × 300 points × 2 dims, the example MFlow's
    7-basis M-spline prior on its 800-point mesh; C = 8 chains and 128 SMC
    particles), coefficients from the model's own prior weights: the
    forward, the gradient by ``autograd.grad`` of the vmapped sum and by
    ``vmap(grad(...))``, each one launch of the forward kernel and one of
    the backward kernel, equal to a loop of per-chain calls to the bit, and
    within K4's tolerance (2e-5 of the largest value) of the plain path
    under vmap.  Then the posterior's gradient itself: 1 + 1 launches
    whatever the number of chains, both ways.  Comparison launches only:
    no path's count."""
    from torch.func import grad, vmap
    from waveflow_tpu_torch.benchmark import get_dataset
    from waveflow_tpu_torch.benchmark.density import get_benchmark_model
    from waveflow_tpu_torch.ops import cuda_spline
    from waveflow_tpu_torch.vmc.hmc import (make_parameter_posterior,
                                            value_and_grad)
    ex = posterior_example()
    model = get_benchmark_model('MFlow', **ex.MODEL, device='cuda',
                                generator=torch.Generator().manual_seed(0))
    ev = model.ev
    n_b, n_mesh = ev.n_bases, ev.n_mesh
    t0, t1 = ev.tables[0], ev.tables[1]
    gen = torch.Generator('cuda').manual_seed(5)

    def launched(fn, expected, what):
        before = k4_counts()
        out = fn()
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(k4_counts(), before))
        if got != expected:
            fail(f"k4-vmap: {what} launched K4 forward/backward {got}, not "
                 f"{expected}")
        return out

    def close(got, ref, what):
        tol = 2e-5 * max(1.0, ref.abs().max().item())
        err = (got - ref).abs().max().item()
        if not err <= tol:
            fail(f"k4-vmap {what}: max {err:.3e} against the plain path "
                 f"under vmap (atol {tol:.3e})")
        return err

    f = vmap(lambda c, x: ev(c, x))
    f_plain = vmap(lambda c, x: cuda_spline.spline_eval_plain(t0, c, x))
    bwd_plain = vmap(lambda c, x, g: cuda_spline.spline_eval_bwd_plain(
        t0, t1, c, x, g))

    def single(c, x, g):
        return (ev(c, x) * g).sum()
    vgrad = vmap(grad(single, (0, 1)))

    rows = {}
    for C in K4_VMAP_CHAINS:
        shape = (C, POSTERIOR_POINTS, 2)
        x = torch.rand(shape, generator=gen, device='cuda') * 1.1 - 0.05
        x[0, :4, 0] = torch.tensor([0.0, 1.0, -1e-6, 1.0 + 1e-6])
        with torch.no_grad():
            c = model.prior_weights(x.reshape(-1, 2)).reshape(shape + (n_b,))
        g = torch.randn(shape, generator=gen, device='cuda')
        cr, xr = c.clone().requires_grad_(), x.clone().requires_grad_()

        def fwd():
            return f(c, x)

        def fwd_bwd():
            return torch.autograd.grad((f(cr, xr) * g).sum(), (cr, xr))

        y = launched(fwd, (1, 0), f"the forward at C = {C}")
        gc, gx = launched(fwd_bwd, (1, 1), f"autograd.grad at C = {C}")
        vc, vx = launched(lambda: vgrad(c, x, g), (1, 1),
                          f"vmap(grad) at C = {C}")
        for i in range(C):
            ci, xi = c[i].clone().requires_grad_(), x[i].clone() \
                .requires_grad_()
            yi = ev(ci, xi)
            rc, rx = torch.autograd.grad((yi * g[i]).sum(), (ci, xi))
            if not (torch.equal(y[i], yi) and torch.equal(gc[i], rc)
                    and torch.equal(gx[i], rx) and torch.equal(vc[i], rc)
                    and torch.equal(vx[i], rx)):
                fail(f"k4-vmap: chain {i} of {C} differs from its own "
                     "kernel call")
        pc, px = bwd_plain(c, x, g)
        err = close(y, f_plain(c, x), f"forward C = {C}")
        err_b = max(close(gc, pc, f"g_coeffs C = {C}"),
                    close(gx, px, f"g_x C = {C}"))
        N = C * POSTERIOR_POINTS * 2
        rows_read = table_rows(torch, n_mesh, x)
        fwd_b = bound_ms(4 * (N * n_b + 2 * N + rows_read * n_b),
                         N * (4 * n_b + 6))
        bwd_b = bound_ms(4 * (N * (2 + 2 * n_b + 1) + 2 * rows_read * n_b),
                         N * (7 * n_b + 7))
        row_f = dict(chains=C, N=N, max_abs_err=err, ms=cuda_ms(torch, fwd),
                     device_ms=launch_device_ms(torch, fwd,
                                                'spline_eval_kernel'),
                     plain_ms=cuda_ms(torch, lambda: f_plain(c, x)),
                     bound_ms=fwd_b[0], bound_by=fwd_b[1])
        row_b = dict(chains=C, N=N, max_abs_err=err_b,
                     ms=cuda_ms(torch, fwd_bwd),
                     device_ms=launch_device_ms(torch, fwd_bwd,
                                                'spline_eval_bwd_kernel'),
                     plain_ms=cuda_ms(torch, lambda: bwd_plain(c, x, g)),
                     bound_ms=bwd_b[0], bound_by=bwd_b[1])
        rows[C] = (row_f, row_b)
        print(f"K4 under vmap, {C} chains x {POSTERIOR_POINTS} points x 2 "
              f"(N = {N}, {n_b} bases, mesh {n_mesh}): forward, autograd.grad "
              f"of the vmapped sum and vmap(grad) each 1 launch of K4 and 1 "
              f"of its backward, equal to a loop of per-chain calls to the "
              f"bit; max|dy| {err:.3e}, max|d gradient| {err_b:.3e} against "
              f"the plain path under vmap | forward kernel_ms "
              f"{row_f['ms']:.4f} device_ms {row_f['device_ms']:.4f} "
              f"plain_ms {row_f['plain_ms']:.4f} bound_ms "
              f"{row_f['bound_ms']:.5f} ({row_f['bound_by']}) | forward + "
              f"backward kernel_ms {row_b['ms']:.4f}, backward device_ms "
              f"{row_b['device_ms']:.4f}, plain backward ms "
              f"{row_b['plain_ms']:.4f}, backward bound_ms "
              f"{row_b['bound_ms']:.5f} ({row_b['bound_by']})", flush=True)

    # the posterior's own gradient: 1 + 1 launches for any number of chains
    X = get_dataset('circles', n_samples=POSTERIOR_POINTS + 1000)
    lp, _, flat0 = make_parameter_posterior(
        model, torch.as_tensor(X[:POSTERIOR_POINTS], device='cuda'), 2.0)
    per_chain = vmap(grad(lambda th: lp(th[None])[0]))
    for C in K4_VMAP_CHAINS:
        theta = flat0 + 0.01 * torch.randn((C, flat0.numel()), generator=gen,
                                           device='cuda')
        _, g1 = launched(lambda: value_and_grad(lp, theta), (1, 1),
                         f"the posterior gradient at {C} chains")
        g2 = launched(lambda: per_chain(theta), (1, 1),
                      f"vmap(grad) of the posterior at {C} chains")
        if not torch.isfinite(g1).all():
            fail("k4-vmap: the posterior gradient is not finite")
        err = ((g1 - g2).abs().max() / g1.abs().max()).item()
        print(f"posterior gradient at {C} chains (D = {flat0.numel()}): K4 "
              f"1 + 1 launches by autograd.grad of the vmapped sum and by "
              f"vmap(grad); the two agree to {err:.2e} of the largest "
              f"entry", flush=True)
        if not err <= 1e-5:
            fail(f"k4-vmap: the two posterior gradients differ by {err:.2e}")
    row_f, row_b = rows[K4_VMAP_CHAINS[0]]
    return dict(forward=dict(row_f, smc=rows[K4_VMAP_CHAINS[1]][0]),
                backward=dict(row_b, smc=rows[K4_VMAP_CHAINS[1]][1]))


def posterior_phase(torch, sampler, sharded=False):
    """The parameter posterior of examples/parameter_posterior_torch.py at
    full width (D = 10,816; 8 chains or 128 particles, 300 points), depth
    cut (POSTERIOR_CUT): gradient evaluations per second, ms per step, the
    adapted step size and acceptance, NUTS's tree depth, K4 launches per
    density call (1) and per gradient (1 backward), the idle share of a
    profiled stretch; held-out LL at init and under the BMA, which must be
    finite and above the init's.  ``sharded``: the chains split over the
    walker group (a world of one over NCCL here; the step size's
    all-reduce in every step).  Returns K4's launches on that path."""
    ex = posterior_example()
    from waveflow_tpu_torch.ops import cuda_spline
    cuda_spline.launches = cuda_spline.launches_bwd = 0
    label = (f"posterior-sharded-1 {sampler}" if sharded
             else f"posterior-{sampler}")
    # the example's stretch: SMC's whole ladder again, HMC / NUTS 2 steps
    n, unit = ((ex.SMC['n_temps'], 'temperatures') if sampler == 'smc'
               else (2, 'steps'))
    fig = ex.run_posterior(
        sampler, device='cuda', seed=0, verbose=False,
        profile=lambda run: profile_window(torch, run, n, f"{label}: ",
                                           unit=unit),
        sharded=sharded, **POSTERIOR_CUT[sampler])
    launches = dict(zip(('spline_eval', 'spline_eval_bwd'), k4_counts()))
    prof = fig.pop('profile')
    print(f"{label}: D = {fig['D']}, {fig['sampling_s']:.2f} s sampling, "
          f"{fig['ms_per_step']:.1f} ms per step, "
          f"{fig['grad_evals_per_s']:.1f} chain-gradients/s "
          f"({fig['grad_calls_per_s']:.1f} batched) | "
          + (f"step size {fig['step_size']:.3e}, " if sampler != 'smc'
             else f"{fig['n_resamples']} resamples, ")
          + f"accept {fig['accept']:.4f}"
          + (f", mean tree depth {fig['mean_tree_depth']:.3f} (max "
             f"{fig['max_tree_depth']}), {fig['calls_per_step']:.2f} "
             f"replays and {fig['host_reads_per_step']:.2f} host reads per "
             "step" if sampler == 'nuts' else '')
          + (f" | ranks {fig['ranks']}" if sharded else '')
          + f" | K4 per density call {fig['k4_per_density_call']:g}, "
          f"backward per gradient {fig['k4_bwd_per_grad_call']:g} | idle "
          f"{prof['idle']:.4f} | held-out LL init {fig['init_ll']:.4f}, "
          f"best draw {fig['best_draw_ll']:.4f}, BMA {fig['bma_ll']:.4f}",
          flush=True)
    if fig['k4_per_density_call'] != 1.0 or (
            sampler != 'smc' and fig['k4_bwd_per_grad_call'] != 1.0):
        fail(f"{label}: K4 launched {fig['k4_per_density_call']} times per "
             f"density call and its backward {fig['k4_bwd_per_grad_call']} "
             "per gradient, not 1 and 1")
    if not (fig['finite'] and fig['bma_ll'] > fig['init_ll']):
        fail(f"{label}: BMA held-out LL {fig['bma_ll']} is not finite and "
             f"above the init's {fig['init_ll']}")
    return launches, dict(fig, idle=prof['idle'])


# the probprog and density twins (graph-density, graph-posterior-hmc,
# -nuts, -smc): a turn is 2 blocks of DENSITY_TWIN_BLOCK epochs,
# HMC_TWIN_STEPS (NUTS_TWIN_STEPS) warm-up and as many kept steps, or
# SMC_TWIN_TEMPS temperatures; the posterior at the example's prior scale
# and step size
DENSITY_TWIN_BLOCK = 5
HMC_TWIN_STEPS = 2
NUTS_TWIN_STEPS = 2
SMC_TWIN_TEMPS = 3
POSTERIOR_NUTS_DEPTH = 6         # the example's max_tree_depth
POSTERIOR_PRIOR_SCALE, POSTERIOR_STEP = 2.0, 2e-3
# K4's (forward, backward) launches per replay, counted from the code: a
# density epoch is one log_pdf and its backward; an HMC step n_leapfrog + 1
# = 17 gradients of the vmapped posterior; an SMC temperature 5 moves, one
# likelihood call each, no gradient (a NUTS step's count follows its tree)
K4_PER_REPLAY = {'density': (1, 1), 'hmc': (17, 17), 'smc': (5, 0)}


def twin_turns(torch, label, make, turn, carried, units, unit, expected,
               n_captures=1):
    """A driver on the graph path and its eager twin (``make(graph)``, both
    from one state): turns of ``units`` ``unit`` (``turn(twin)``) in the
    order eager, graph, graph, eager, each timed by CUDA events with K4's
    launches counted (the first graph turn holds the warm-up calls and the
    captures, whose seconds and graph pools ``capture_clock`` reads); then
    everything the two carry (``carried(twin)``, a dict of tensors)
    compared, which must be equal to the bit, K4's launches per unit
    held to ``expected`` = (forward, backward) on both twins (or to
    ``expected(eager twin)``, where the count follows the run), the
    graph's ``n_captures`` made once, and one more graph turn profiled: the
    idle share of an unprofiled replay is the profiled busy time against
    the events' time.  Returns (K4's launches over the graph turns, the
    figures)."""
    from waveflow_tpu_torch.ops import cuda_spline
    ms = {'eager': [], 'graph': []}
    k4 = {kind: (0, 0) for kind in ms}
    eager, graphed = make(False), make(None)
    with capture_clock(torch) as captures:
        for kind, t in (('eager', eager), ('graph', graphed),
                        ('graph', graphed), ('eager', eager)):
            cuda_spline.launches = cuda_spline.launches_bwd = 0
            _, dt = events_ms(torch, lambda: turn(t))
            ms[kind].append(dt)
            k4[kind] = tuple(a + b for a, b in zip(k4[kind], k4_counts()))
    per_unit = {kind: tuple(v / (2 * units) for v in c)
                for kind, c in k4.items()}
    bitwise, rel, by_group = compare_twins(torch, carried(eager),
                                           carried(graphed))
    if callable(expected):
        expected = expected(eager)
    eager_ms = sum(ms['eager']) / (2 * units)
    graph_ms = ms['graph'][1] / units
    prof = profile_window(torch, lambda: turn(graphed), units,
                          f"{label} graphed ", unit=unit)
    out = dict(eager_ms=eager_ms, graph_ms=graph_ms,
               graph_first_turn_ms=ms['graph'][0] / units,
               speedup=eager_ms / graph_ms, turns_ms=ms, bitwise=bitwise,
               max_rel_diff=rel, rel_diff_by_group=by_group,
               capture_s=[c[0] for c in captures],
               graph_pool_mib=[c[1] / 2 ** 20 for c in captures],
               k4_per_replay=per_unit['graph'], busy_ms=prof['busy_ms'] / units,
               idle_unprofiled=1 - prof['busy_ms'] / units / graph_ms,
               kernels_per_replay=prof['launches_per_unit'])
    one = unit.rstrip('s')
    print(f"{label}: eager, graph, graph, eager turns of {units} {unit} "
          f"(CUDA events): "
          f"{' / '.join(f'{v:.1f}' for v in ms['eager'][:1] + ms['graph'] + ms['eager'][1:])}"
          f" ms | eager {eager_ms:.3f} ms per {one} | graph {graph_ms:.3f} ms "
          f"per replay (first turn {out['graph_first_turn_ms']:.3f} with the "
          f"warm-up and the capture), {out['speedup']:.2f}x | capture "
          f"{', '.join(f'{s:.3f}' for s in out['capture_s'])} s, graph pool "
          f"{', '.join(f'{p:.1f}' for p in out['graph_pool_mib'])} MiB | "
          f"device busy {out['busy_ms']:.3f} ms per replay (profiler), idle "
          f"share {out['idle_unprofiled']:.4f} | graph against eager: "
          f"{'equal to the bit' if bitwise else 'NOT bitwise'} (largest "
          f"relative difference {rel:.3e}; by kind "
          f"{ {k: f'{v:.2e}' for k, v in by_group.items()} }) | K4 (forward, "
          f"backward) per {one}: eager {per_unit['eager']}, graph "
          f"{per_unit['graph']}, expected {expected}", flush=True)
    if len(captures) != n_captures:
        fail(f"{label}: {len(captures)} captures in the turns, not "
             f"{n_captures}")
    if not bitwise:
        fail(f"{label}: the graph differs from its eager twin by {by_group} "
             "relative")
    if not per_unit['graph'] == per_unit['eager'] == tuple(map(float,
                                                             expected)):
        fail(f"{label}: K4 launched {per_unit} per {one}, not {expected}")
    return dict(zip(('spline_eval', 'spline_eval_bwd'), k4['graph'])), out


def graph_density_phase(torch):
    """The density trainer's epoch as a CUDA graph against its eager twin:
    the full-width MFlow on 20,000 circles points from seeded weights,
    turns of 2 blocks of DENSITY_TWIN_BLOCK epochs (``density_epochs``,
    what ``train_density_model`` runs between its metric checkpoints);
    then ``train_density_model`` graphed against eager for the other three
    model names (2 blocks of 5 epochs, a checkpoint after each): losses
    and parameters to the bit."""
    from types import SimpleNamespace
    from waveflow_tpu_torch.benchmark import get_dataset, train_density_model
    from waveflow_tpu_torch.benchmark.density import (
        density_epochs, density_optimizer, get_benchmark_model)
    X = get_dataset('circles', DENSITY_POINTS)
    X_dev = torch.as_tensor(X, dtype=torch.float32, device='cuda')

    def make(graph):
        model = get_benchmark_model(
            'MFlow', **DENSITY, generator=torch.Generator().manual_seed(5),
            device='cuda')
        opt = density_optimizer(model, 1e-4)
        gen = torch.Generator('cuda').manual_seed(6)
        return SimpleNamespace(model=model, opt=opt, gen=gen, losses=[],
                               epochs=density_epochs(model, opt, X_dev, gen,
                                                     graph))

    def turn(t):
        for _ in range(2):
            t.losses.append(t.epochs.window(DENSITY_TWIN_BLOCK)[0])

    def carried(t):
        """Losses, parameters, Adam's moments and step, the permutations'
        generator."""
        out = {'losses': torch.cat(t.losses), 'generator': t.gen.get_state()}
        out.update({f'param {k}': v for k, v in t.model.state_dict().items()})
        for i, st in t.opt.state_dict()['state'].items():
            out.update({f'adam {i} {k}': v for k, v in st.items()})
        return out

    launches, out = twin_turns(
        torch, 'graph-density MFlow', make, turn, carried,
        2 * DENSITY_TWIN_BLOCK, 'epochs', K4_PER_REPLAY['density'])
    out['points_per_s'] = DENSITY_POINTS / out['graph_ms'] * 1e3
    out['eager_points_per_s'] = DENSITY_POINTS / out['eager_ms'] * 1e3
    print(f"graph-density: points/s graph {out['points_per_s']:.1f}, eager "
          f"{out['eager_points_per_s']:.1f}", flush=True)
    out['models'] = {}
    for name in ('Flow', 'IFlow', 'RQSFlow'):
        runs = []
        for graph in (False, None):
            with capture_clock(torch) as captures:
                model, hist = train_density_model(
                    X, model_name=name, num_epochs=10, log_every=5,
                    n_model_sample=2000, verbose=False, device='cuda',
                    graph=graph, **DENSITY)
            runs.append((model, hist, len(captures)))
        (a, ha, na), (b, hb, nb) = runs
        same = ha['losses'] == hb['losses'] and all(
            torch.equal(v, b.state_dict()[k])
            for k, v in a.state_dict().items())
        out['models'][name] = dict(bitwise=same, captures=(na, nb),
                                   last_loss=hb['losses'][-1])
        print(f"graph-density {name}: train_density_model graphed "
              f"({nb} capture) against eager ({na}), 2 blocks of 5 epochs: "
              f"losses and parameters "
              f"{'equal to the bit' if same else 'DIFFER'}; last loss "
              f"{hb['losses'][-1]:.5f}", flush=True)
        if not same or (na, nb) != (0, 1) or not all(
                math.isfinite(v) for v in hb['losses']):
            fail(f"graph-density {name}: graphed against eager: "
                 f"{out['models'][name]}")
    out['continued'] = density_continuation(torch, X, X_dev)
    return launches, out


def density_continuation(torch, X, X_dev):
    """``train_density_model(model=...)`` on an MFlow whose eager forward
    left a loss alive: the graphed default refuses it before its first
    epoch (RuntimeError, the parameters untouched), and once the loss is
    dropped runs graphed (one capture), equal to the eager continuation,
    which takes the kept loss, to the bit."""
    from waveflow_tpu_torch.benchmark import train_density_model
    from waveflow_tpu_torch.benchmark.density import get_benchmark_model

    def fresh():
        return get_benchmark_model(
            'MFlow', **DENSITY, generator=torch.Generator().manual_seed(5),
            device='cuda')

    def train(model, graph):
        with capture_clock(torch) as captures:
            _, hist = train_density_model(
                X, model=model, num_epochs=5, log_every=5, n_model_sample=2000,
                verbose=False, device='cuda', graph=graph,
                generator=torch.Generator().manual_seed(7), **DENSITY)
        return hist['losses'], len(captures)

    eager, graphed = fresh(), fresh()
    kept = [-m.log_pdf(X_dev).mean() for m in (eager, graphed)]
    before = {k: v.clone() for k, v in graphed.state_dict().items()}
    try:
        train(graphed, None)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    untouched = all(torch.equal(v, graphed.state_dict()[k])
                    for k, v in before.items())
    eager_losses, _ = train(eager, False)
    kept.clear()
    graph_losses, n = train(graphed, None)
    same = eager_losses == graph_losses and all(
        torch.equal(v, graphed.state_dict()[k])
        for k, v in eager.state_dict().items())
    print(f"graph-density continued MFlow: with a kept loss the graphed "
          f"default {'refused: ' + repr(refused) if refused else 'RAN'} "
          f"(parameters {'untouched' if untouched else 'CHANGED'}); the "
          f"loss dropped, {n} capture, 5 epochs against the eager "
          f"continuation (which kept it): "
          f"{'equal to the bit' if same else 'DIFFER'}", flush=True)
    if refused is None or not untouched or n != 1 or not same:
        fail("graph-density: model= continuation after an eager forward")
    return dict(refused=refused, captures=n, bitwise=same)


def posterior_twin_target(torch, ex, n_rows: int, spread: float):
    """The example's posterior on the card, its log density and ``n_rows``
    rows of flat0 plus ``spread`` standard normals (seeded)."""
    _, log_prob, _, flat0, _ = ex.posterior_target(
        prior_scale=POSTERIOR_PRIOR_SCALE, device='cuda', seed=0)
    rows = flat0[None] + spread * torch.randn(
        (n_rows, flat0.numel()), generator=torch.Generator('cuda').manual_seed(1),
        device='cuda')
    return log_prob, rows


def graph_posterior_hmc_phase(torch):
    """HMC over the example posterior (D = 10,816, 8 chains, 16 leapfrogs)
    graphed against eager: turns of HMC_TWIN_STEPS warm-up steps, the step
    size switched, HMC_TWIN_STEPS kept steps (``run_fn``; two captures:
    the warm-up step and the kept step); state, traces, accepts and
    generator to the bit; K4 17 + 17 per replayed step."""
    from types import SimpleNamespace
    from waveflow_tpu_torch.vmc import make_hmc_sampler
    ex = posterior_example()
    log_prob, chains = posterior_twin_target(torch, ex, 8, 0.01)
    init_fn, _, run_fn = make_hmc_sampler(log_prob, n_leapfrog=16)

    def make(graph):
        return SimpleNamespace(state=init_fn(chains, step_size=POSTERIOR_STEP),
                               gen=torch.Generator('cuda').manual_seed(2),
                               graph=graph, traces=[], accepts=[])

    def turn(t):
        t.state, trace, info = run_fn(t.state, t.gen, HMC_TWIN_STEPS,
                                      n_warmup=HMC_TWIN_STEPS,
                                      return_info=True, graph=t.graph)
        t.traces.append(trace)
        t.accepts.append(info['accept'])

    def carried(t):
        out = {f'state {k}': v for k, v in zip(t.state._fields, t.state)}
        out.update(trace=torch.cat(t.traces), accept=torch.cat(t.accepts),
                   generator=t.gen.get_state())
        return out
    return twin_turns(torch, 'graph-posterior-hmc', make, turn, carried,
                      2 * HMC_TWIN_STEPS, 'steps', K4_PER_REPLAY['hmc'],
                      n_captures=2)


def graph_posterior_smc_phase(torch, sharded=False):
    """Tempered SMC over the example posterior (128 particles, 5 moves per
    temperature) graphed against eager: turns of an SMC_TWIN_TEMPS ladder
    (one capture: a temperature, β copied into its slot before each
    replay); state, ESS, accepts and generators to the bit; K4 5 forward
    launches per replayed temperature.  ``sharded``: the particles on the
    walker group (parallel/probprog.py::make_sharded_smc; a world of one
    over NCCL here), so the capture holds the weights' all-gather and the
    cross-rank resample, the resample uniform from a shared generator."""
    from types import SimpleNamespace
    from waveflow_tpu_torch.parallel import make_sharded_smc, make_walker_mesh
    from waveflow_tpu_torch.vmc import make_smc_sampler
    ex = posterior_example()
    log_prob, particles = posterior_twin_target(torch, ex, 128, 0.1)

    def log_prior(th):
        return -0.5 * (th ** 2).sum(-1) / POSTERIOR_PRIOR_SCALE ** 2

    def log_like(th):
        return log_prob(th) - log_prior(th)
    smc_kw = dict(n_temps=SMC_TWIN_TEMPS, n_mcmc_moves=5,
                  mcmc_step_size=POSTERIOR_STEP)
    if sharded:
        mesh = make_walker_mesh('cuda')
        init_fn, sharded_run = make_sharded_smc(log_prior, log_like, mesh,
                                                **smc_kw)
        label = f"graph-posterior-smc-sharded-{mesh.size} ({mesh.backend})"

        def run_fn(state, gen, shared, **kw):
            return sharded_run(state, gen, shared, **kw)
    else:
        init_fn, smc_run = make_smc_sampler(log_prior, log_like, **smc_kw)
        label = 'graph-posterior-smc'

        def run_fn(state, gen, shared, **kw):
            return smc_run(state, gen, **kw)

    def make(graph):
        return SimpleNamespace(state=init_fn(particles), graph=graph,
                               gen=torch.Generator('cuda').manual_seed(2),
                               shared=torch.Generator('cuda').manual_seed(3),
                               ess=[], acc=[])

    def turn(t):
        t.state, ess, acc = run_fn(t.state, t.gen, t.shared,
                                   return_accept=True, graph=t.graph)
        t.ess.append(ess)
        t.acc.append(acc)

    def carried(t):
        out = {f'state {k}': v for k, v in zip(t.state._fields, t.state)}
        out.update(ess=torch.cat(t.ess), accept=torch.cat(t.acc),
                   generator=t.gen.get_state(),
                   shared_generator=t.shared.get_state())
        return out
    return twin_turns(torch, label, make, turn, carried, SMC_TWIN_TEMPS,
                      'temperatures', K4_PER_REPLAY['smc'])


def graph_posterior_nuts_phase(torch, sharded=False):
    """NUTS over the example posterior (D = 10,816, 8 chains,
    max_tree_depth 6) graphed against eager: turns of NUTS_TWIN_STEPS
    warm-up steps, the step size switched, NUTS_TWIN_STEPS kept steps
    (``run_fn``; six captures: the step's start, a subtree's start, a leaf,
    a merge, the warm-up and the kept end); state, traces, tree depths,
    leaf counts, accepts, body calls and host reads per step and the
    generator to the bit; K4's forward and backward launches per step
    1 + the leaves the batch built, on both twins (the trees set the count:
    it is read from the eager twin's runs).  Chain-gradients per second and
    ms per gradient from the second graph turn; the idle share per
    gradient from the profiled turn.  ``sharded``: the graph twin's chains
    on the walker group (parallel/probprog.py::make_sharded_chain_sampler;
    a world of one over NCCL here), the warm-up end's pmean captured,
    against the unsharded eager twin."""
    from types import SimpleNamespace
    from waveflow_tpu_torch.parallel import (
        make_sharded_chain_sampler, make_walker_mesh)
    from waveflow_tpu_torch.vmc import make_nuts_sampler
    ex = posterior_example()
    log_prob, chains = posterior_twin_target(torch, ex, 8, 0.01)
    kw = dict(max_tree_depth=POSTERIOR_NUTS_DEPTH)
    init_fn, _, run_fn = make_nuts_sampler(log_prob, **kw)
    n, steps = NUTS_TWIN_STEPS, 2 * NUTS_TWIN_STEPS
    label = 'graph-posterior-nuts'
    if sharded:
        mesh = make_walker_mesh('cuda')
        sharded_init, make_run = make_sharded_chain_sampler(
            make_nuts_sampler, log_prob, mesh, **kw)
        label = f"graph-posterior-nuts-sharded-{mesh.size} ({mesh.backend})"
    twins = {}

    def make(graph):
        t = SimpleNamespace(gen=torch.Generator('cuda').manual_seed(2),
                            traces=[], infos=[])
        if sharded and graph is None:
            t.state = sharded_init(chains, step_size=POSTERIOR_STEP)
            run = make_run(n, n)
            t.run = lambda: run(t.state, t.gen, return_info=True)
        else:
            t.state = init_fn(chains, step_size=POSTERIOR_STEP)
            t.run = lambda: run_fn(t.state, t.gen, n, n_warmup=n,
                                   return_info=True, graph=graph)
        twins['eager' if graph is False else 'graph'] = t
        return t

    def turn(t):
        t.state, trace, info = t.run()
        t.traces.append(trace)
        t.infos.append(info)

    def carried(t):
        out = {f'state {k}': v for k, v in zip(t.state._fields, t.state)}
        out.update(trace=torch.cat(t.traces), generator=t.gen.get_state())
        out.update({f'info {k}': torch.cat([i[k] for i in t.infos])
                    for k in t.infos[0]})
        return out

    def gradients(info):
        """The batch's gradients in a turn: one per step and per leaf."""
        return steps + int(info['leaves'].sum())

    def expected(eager):
        per_step = sum(gradients(i) for i in eager.infos) / (2 * steps)
        return per_step, per_step

    launches, out = twin_turns(torch, label, make, turn, carried, steps,
                               'steps', expected, n_captures=6)
    g, e = twins['graph'], twins['eager']
    grads = [gradients(i) for i in g.infos]     # graph turns 1, 2, profiled
    ms_per_grad = out['turns_ms']['graph'][1] / grads[1]
    busy_per_grad = out['busy_ms'] * steps / grads[2]
    kept = g.infos[1]
    out.update(
        chains=chains.shape[0], gradients_per_step=grads[1] / steps,
        ms_per_gradient=ms_per_grad,
        chain_grads_per_s=chains.shape[0] / ms_per_grad * 1e3,
        eager_chain_grads_per_s=chains.shape[0] * sum(
            gradients(i) for i in e.infos) / sum(out['turns_ms']['eager'])
        * 1e3,
        busy_ms_per_gradient=busy_per_grad,
        idle_per_gradient=1 - busy_per_grad / ms_per_grad,
        replays_per_step=float(kept['calls'].float().mean()),
        host_reads_per_step=float(kept['host_reads'].float().mean()),
        mean_tree_depth=float(torch.cat([i['depth'] for i in g.infos[:2]])
                              .float().mean()))
    print(f"{label}: {out['gradients_per_step']:.2f} gradients per step "
          f"(second graph turn), mean tree depth "
          f"{out['mean_tree_depth']:.3f} | {out['replays_per_step']:.2f} "
          f"replays and {out['host_reads_per_step']:.2f} host reads per "
          f"step | graph {ms_per_grad:.4f} ms per gradient, "
          f"{out['chain_grads_per_s']:.1f} chain-gradients/s; eager "
          f"{out['eager_chain_grads_per_s']:.1f} | profiled turn: busy "
          f"{busy_per_grad:.4f} ms per gradient, idle share per gradient "
          f"{out['idle_per_gradient']:.4f}", flush=True)
    return launches, out


def nuts_waveflow_phase(torch, params):
    """HMC and NUTS over He-1d walkers of the 100k checkpoint on the sorted
    sector (JAX's test_hmc_stationary_on_waveflow: the density clipped into
    the open box and sorted), 256 chains warm-started at K1 ancestral
    draws, depth cut: the pooled moments of the kept draws within 0.25 of
    4,096 ancestral draws'.  K3 launches per density call (4: the 3 IMADE
    layers and the prior) and chain-gradients per second: the rows of the
    density calls that take a gradient, over the wall (HMC replays its
    steps and NUTS its trajectory bodies as CUDA graphs: the calls are
    counted on the device, so that a replay counts them again)."""
    from waveflow_tpu_torch.vmc import make_hmc_sampler, make_nuts_sampler
    m = flagship_model(torch, params, 'poly_pallas')
    L = 10.0
    reset_counts()
    with torch.no_grad():
        anc = m.sample(4096, generator=torch.Generator('cuda').manual_seed(1))
    launches = read_counts()
    # density calls; the rows of those under a gradient
    calls = torch.zeros(2, dtype=torch.int64, device='cuda')

    def log_prob(x):
        calls[0].add_(1)
        if torch.is_grad_enabled():
            calls[1].add_(x.shape[0])
        return m.log_pdf(torch.sort(torch.clamp(x, -L + 1e-3, L - 1e-3),
                                    -1).values)

    out = {}
    for name, make, kw, cut in (
            ('hmc', make_hmc_sampler, dict(n_leapfrog=8), (30, 45)),
            ('nuts', make_nuts_sampler, dict(max_tree_depth=5), (20, 30))):
        init_fn, _, run_fn = make(log_prob, **kw)
        before = read_counts()['basis_jet']
        calls.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = init_fn(anc[:WAVEFLOW_CHAINS], step_size=0.3)
        state, trace, info = run_fn(state, torch.Generator('cuda')
                                    .manual_seed(3), cut[1], cut[0],
                                    return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_calls, n_rows = calls.tolist()
        k3 = read_counts()['basis_jet'] - before
        mc = torch.sort(torch.clamp(trace[cut[1] // 3:].reshape(-1, 2),
                                    -L, L), -1).values
        d_mean = (mc.mean(0) - anc.mean(0)).abs().max().item()
        d_std = (mc.std(0) - anc.std(0)).abs().max().item()
        row = dict(wall_s=wall, density_calls=n_calls,
                   k3_per_call=k3 / n_calls,
                   chain_grads_per_s=n_rows / wall,
                   d_mean=d_mean, d_std=d_std,
                   step_size=float(state.step_size),
                   accept=float(info['accept'][cut[0]:].mean()))
        if name == 'nuts':
            row['mean_tree_depth'] = float(
                info['depth'][cut[0]:].float().mean())
        out[name] = row
        print(f"nuts-waveflow {name}: {WAVEFLOW_CHAINS} chains from K1 "
              f"ancestral draws of the 100k checkpoint, {cut[0]} + {cut[1]} "
              f"steps in {wall:.2f} s | pooled moments against 4096 "
              f"ancestral draws: max|d mean| {d_mean:.4f}, max|d std| "
              f"{d_std:.4f} (atol {WAVEFLOW_MOMENT_ATOL}) | step size "
              f"{row['step_size']:.4f}, accept {row['accept']:.4f}"
              + (f", mean tree depth {row['mean_tree_depth']:.3f}"
                 if name == 'nuts' else '')
              + f" | K3 {row['k3_per_call']:g} per density call, "
              f"{row['chain_grads_per_s']:.1f} chain-gradients/s", flush=True)
        if not (torch.isfinite(trace).all() and d_mean <= WAVEFLOW_MOMENT_ATOL
                and d_std <= WAVEFLOW_MOMENT_ATOL):
            fail(f"nuts-waveflow {name}: pooled moments off the ancestral "
                 f"ones by {d_mean:.4f} / {d_std:.4f}")
        if row['k3_per_call'] != 4:
            fail(f"nuts-waveflow {name}: K3 launched {row['k3_per_call']} "
                 "times per density call, not 4")
        launches['basis_jet'] += k3
    return launches, out


# ---- walker parallelism: the collectives on the card ------------------------
# the world-of-one twins: windows of GRAPH_WINDOW epochs, 2 per turn as
# graph-train; then DP_TIMING_TURNS windows of each, alternating, timed
DP_TIMING_TURNS = 3
# the two gloo ranks on the card: seconds for both, their start included
DP_GLOO_TIMEOUT = 420
DP_GLOO_BATCH = 256              # global walkers of the gloo gates
# the gloo gates' tolerances, those of tests/test_torch_parallel.py: the
# clipped-score step (JAX's test_sharded_step_matches_single_device), the
# chunked Gram, SPRING's update (tests/test_torch_sr.py), the step size
DP_LOSS_RTOL, DP_MIN_COS, DP_RATIO = 1e-4, 0.999, (0.95, 1.05)
DP_GRAM_RTOL, DP_SPRING_TOL, DP_STEP_RTOL = 1e-5, 2e-3, 1e-6


def collective_profile(torch, run, n_epochs):
    """Profile ``run()`` (``n_epochs`` epochs): per epoch, the device events
    whose name says NCCL, the device-to-device copies, every device event,
    and the busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = {e.key[:80]: e.count / n_epochs for e in dev
            if 'nccl' in e.key.lower()}
    return dict(nccl_per_epoch=sum(nccl.values()), nccl_by_name=nccl,
                copies_per_epoch=sum(e.count for e in dev
                                     if 'memcpy' in e.key.lower()) / n_epochs,
                events_per_epoch=sum(e.count for e in dev) / n_epochs,
                busy_ms_per_epoch=sum(e.self_device_time_total
                                      for e in dev) / 1e3 / n_epochs)


def dp_world1_phase(torch, label, run_dir, config):
    """A graphed adam window sharded over a world of one process on NCCL
    (``data_parallel=True``: the clip window's all-gather, the gradient's
    all-reduce and, with Metropolis walkers, the step size's all-reduce per
    sweep, captured in the epoch's CUDA graph) against the unsharded graphed
    window, both from ``run_dir``: turns unsharded, sharded, sharded,
    unsharded of 2 windows of GRAPH_WINDOW epochs (CUDA events; the first
    turn of each holds its warm-up and capture), everything the two carry
    equal to the bit, launches per epoch equal; then DP_TIMING_TURNS
    replayed windows of each in alternation (the collectives' overhead per
    replayed epoch) and one profiled window of each (the NCCL events and
    copies per replayed epoch; the sharded replay must hold more of them)."""
    plain, sharded = (twin_maker(run_dir, dict(config, data_parallel=dp))(None)
                      for dp in (False, True))
    mesh = sharded.mesh
    if not (plain.graph and sharded.graph and mesh.size == 1
            and mesh.backend == 'nccl'):
        fail(f"{label}: graphs {plain.graph}, {sharded.graph}, walker mesh "
             f"{mesh}")
    n_turn = 2 * GRAPH_WINDOW
    turns = {'plain': [], 'sharded': []}
    counts = {kind: {'sampler': 0, 'basis_jet': 0} for kind in turns}
    for kind, t in (('plain', plain), ('sharded', sharded),
                    ('sharded', sharded), ('plain', plain)):
        reset_counts()
        _, dt = events_ms(torch, lambda: t.train(n_turn, verbose=False))
        turns[kind].append(dt)
        counts[kind] = {k: counts[kind][k] + v
                        for k, v in read_counts().items()}
    bitwise, rel, by_group = compare_twins(
        torch, trainer_tensors(torch, plain), trainer_tensors(torch, sharded))
    per_epoch = {kind: {k: v / (2 * n_turn) for k, v in c.items()}
                 for kind, c in counts.items()}
    replays = {'plain': [], 'sharded': []}
    for i in range(DP_TIMING_TURNS):
        order = (('plain', plain), ('sharded', sharded))
        for kind, t in (order if i % 2 == 0 else order[::-1]):
            _, dt = events_ms(torch, lambda: replayed_window(t, GRAPH_WINDOW))
            replays[kind].append(dt / GRAPH_WINDOW)
    med = {k: sorted(v)[len(v) // 2] for k, v in replays.items()}
    overhead = med['sharded'] - med['plain']
    prof = {kind: collective_profile(
        torch, lambda: replayed_window(t, GRAPH_WINDOW), GRAPH_WINDOW)
        for kind, t in (('plain', plain), ('sharded', sharded))}
    extra_copies = (prof['sharded']['copies_per_epoch']
                    - prof['plain']['copies_per_epoch'])
    row = dict(turns_ms=turns, bitwise=bitwise, max_rel_diff=rel,
               rel_diff_by_group=by_group, launches_per_epoch=per_epoch,
               replay_ms_per_epoch=replays, median_ms_per_epoch=med,
               collectives_ms_per_epoch=overhead,
               collectives_share=overhead / med['plain'],
               profile=prof, extra_copies_per_epoch=extra_copies,
               walkers_per_s={k: 256 / v * 1e3 for k, v in med.items()})
    print(f"{label}: world of one over NCCL ({torch.cuda.get_device_name(0)})"
          f" | turns unsharded, sharded, sharded, unsharded of 2 x "
          f"{GRAPH_WINDOW} epochs (CUDA events): "
          f"{turns['plain'][0]:.1f} / {turns['sharded'][0]:.1f} / "
          f"{turns['sharded'][1]:.1f} / {turns['plain'][1]:.1f} ms | sharded "
          f"against unsharded: {'equal to the bit' if bitwise else 'NOT bitwise'}"
          f" (largest relative difference {rel:.3e}) | launches per epoch "
          f"{per_epoch} | replayed epoch, median of {DP_TIMING_TURNS} "
          f"alternating windows: unsharded {med['plain']:.4f} ms, sharded "
          f"{med['sharded']:.4f} ms ({replays}), collectives "
          f"{overhead * 1e3:.1f} us per epoch ({100 * overhead / med['plain']:.2f}%)"
          f" | per replayed epoch (profiler): NCCL events "
          f"{prof['sharded']['nccl_per_epoch']:g} {prof['sharded']['nccl_by_name']}"
          f", copies {prof['sharded']['copies_per_epoch']:g} against "
          f"{prof['plain']['copies_per_epoch']:g} unsharded, device events "
          f"{prof['sharded']['events_per_epoch']:g} against "
          f"{prof['plain']['events_per_epoch']:g}, busy "
          f"{prof['sharded']['busy_ms_per_epoch']:.4f} against "
          f"{prof['plain']['busy_ms_per_epoch']:.4f} ms", flush=True)
    if not all(math.isfinite(v) for v in sharded.losses):
        fail(f"{label}: the sharded run produced non-finite losses")
    if not bitwise:
        fail(f"{label}: the sharded window differs from the unsharded one by "
             f"{by_group} relative")
    if per_epoch['plain'] != per_epoch['sharded']:
        fail(f"{label}: launches per epoch differ: {per_epoch}")
    if counts['sharded']['basis_jet'] == 0:
        fail(f"{label}: K3 was not launched by the sharded replays")
    if prof['sharded']['nccl_per_epoch'] + extra_copies <= 0:
        fail(f"{label}: the sharded replay holds no device work of its "
             f"collectives: {prof}")
    return counts['sharded'], row


def dp_nccl_phase(torch):
    launches, row = dp_world1_phase(
        torch, 'dp-nccl-1 train-256', CHECKPOINT.parent, {})
    if launches['sampler'] == 0:
        fail("dp-nccl-1: K1 was not launched by the sharded replays")
    return launches, row


def dp_metropolis_phase(torch):
    return dp_world1_phase(
        torch, 'dp-metropolis-1 metropolis-256', METROPOLIS_RUN,
        dict(sampler='metropolis'))


def random_flagship(torch, device='cuda'):
    """The flagship Waveflow with random weights from seed 2."""
    from waveflow_tpu_torch.models import get_waveflow_model
    return get_waveflow_model(
        2, base_spline_degree=FLAGSHIP['spline_degree'],
        i_spline_degree=FLAGSHIP['spline_degree'],
        n_prior_internal_knots=FLAGSHIP['num_knots'],
        n_i_internal_knots=FLAGSHIP['num_knots'], i_spline_reg=0.05,
        n_flow_layers=3, box_size=10.0, eval_backend='poly_pallas',
        generator=torch.Generator().manual_seed(2), device=device)


def flat_grads(torch, model):
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in model.parameters()])


def flat_params(torch, model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def dp_gloo_rank(rank: int, port: int, out_dir: str,
                 device: str = 'cuda:0') -> int:
    """One of the two gloo ranks of dp-gloo-2 on the card: this rank draws
    its 128 walkers (K1) with its own generator; the sharded clipped-score
    step, the chunked Gram and one SPRING step, and one Metropolis sweep
    from explicit draws on them, each from fresh random flagship weights;
    rank 0 then runs the single-process references on the 256 gathered
    walkers (no collective).  Writes its figures as JSON."""
    import torch
    sys.path.insert(0, str(ROOT))
    from waveflow_tpu_torch.parallel import (
        all_gather, destroy_walker_mesh, distributed_init,
        make_sharded_train_step, make_walker_mesh, shard_batch,
        walker_generator)
    from waveflow_tpu_torch.vmc.estimators import make_train_step
    from waveflow_tpu_torch.vmc.metropolis import (
        make_metropolis_sampler, sector_projection)
    from waveflow_tpu_torch.vmc.sr import (
        gram_matrix, make_score_fn, make_spring_train_step)

    distributed_init(f'localhost:{port}', 2, rank, backend='gloo',
                     device=device)
    mesh = make_walker_mesh(device=device)
    dev = mesh.device
    zero = torch.zeros((), device=dev)
    spring_kw = dict(learning_rate=0.05, momentum=0.9, damping=1e-3,
                     max_update_norm=0.3)

    def fresh():
        m = random_flagship(torch, dev)
        return m, he_hamiltonian(m, 'fwd_batched')

    def adam(m, h, axis=True):
        kw = dict(grad_clip=None)
        if axis:
            return make_sharded_train_step(m.psi, h, m.parameters(), 1e-4,
                                           mesh, **kw)
        return make_train_step(m.psi, h, m.parameters(), 1e-4, **kw)

    def spring_update(rows, axis=True):
        m, h = fresh()
        p0 = flat_params(torch, m)
        make_spring_train_step(m, h, pmean_axis=mesh.axis if axis else None,
                               **spring_kw)(rows, zero)
        return flat_params(torch, m) - p0

    def sweep(rows, noise, u, axis=True):
        m, _ = fresh()
        init, step_fn, _ = make_metropolis_sampler(
            m.log_pdf, axis_name=mesh.axis if axis else None,
            bounds=(-10.0, 10.0), proposal_map=sector_projection(True))
        return step_fn(init(rows, step_size=0.5), noise=noise, u=u)

    res = {'backend': mesh.backend, 'size': mesh.size}
    reset_counts()
    try:
        m, h = fresh()
        local = m.sample(DP_GLOO_BATCH // mesh.size,
                         generator=walker_generator(7, mesh))
        batch = all_gather(local, mesh.axis)
        step = adam(m, h)
        res['loss'] = step(local, zero).item()
        grad = flat_grads(torch, m)
        m, _ = fresh()
        flatten, scores = make_score_fn(m)
        gram = gram_matrix(scores(flatten(), local).detach(), mesh.axis)
        update = spring_update(local)
        draws = torch.Generator(dev).manual_seed(9)
        noise = torch.randn((DP_GLOO_BATCH, 2), generator=draws, device=dev)
        u = torch.rand((DP_GLOO_BATCH,), generator=draws, device=dev)
        st = sweep(local, shard_batch(noise, mesh), shard_batch(u, mesh))
        positions = all_gather(st.positions, mesh.axis)
        res['step_size'] = st.step_size.item()
        # ms per step while two processes time-share the card (a second
        # call of each, warm)
        _, res['adam_ms'] = events_ms(torch, lambda: step(local, zero))
        _, res['spring_ms'] = events_ms(torch, lambda: spring_update(local))
        res['launches'] = read_counts()
        if rank == 0:
            m, h = fresh()
            res['loss_one'] = adam(m, h, axis=False)(batch, zero).item()
            g1 = flat_grads(torch, m)
            res['cos'] = (grad @ g1 / (grad.norm() * g1.norm())).item()
            res['ratio'] = (grad.norm() / g1.norm()).item()
            m, _ = fresh()
            flatten, scores = make_score_fn(m)
            O1 = scores(flatten(), batch).detach()
            want = O1 @ O1.T
            res['gram_rel'] = ((gram - want).abs().max()
                               / want.abs().max()).item()
            res['n_params'] = O1.shape[1]
            want = spring_update(batch, axis=False)
            res['spring_rel'] = ((update - want).norm() / want.norm()).item()
            perm = torch.randperm(DP_GLOO_BATCH, device=dev,
                                  generator=torch.Generator(dev)
                                  .manual_seed(3))
            res['spring_reorder_rel'] = (
                (spring_update(batch[perm], axis=False) - want).norm()
                / want.norm()).item()
            st1 = sweep(batch, noise, u, axis=False)
            res['step_size_one'] = st1.step_size.item()
            res['positions_diff'] = (positions - st1.positions).abs() \
                .max().item()
    finally:
        destroy_walker_mesh()
    Path(out_dir, f'rank{rank}.json').write_text(json.dumps(res))
    return 0


def dp_gloo_phase(torch):
    """Two ranks on the one card over gloo, eager (its collectives cannot be
    captured), spawned from this script: each runs ``dp_gloo_rank``; the
    gates hold the sharded clipped-score step, the chunked Gram, SPRING's
    update and the collective step size to the single-process references
    on the 256 gathered walkers, and K1 and K3 launched on both ranks.  The
    ms are two processes time-sharing one card, not a scaling figure."""
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    out = Path(tempfile.mkdtemp(prefix='dp-gloo-'))
    logs = [open(out / f'rank{r}.log', 'w') for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), '--dp-gloo-rank',
         str(r), '--dp-port', str(port), '--dp-out', str(out)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    failed = None
    try:
        for r, p in enumerate(procs):
            left = DP_GLOO_TIMEOUT - (time.perf_counter() - t0)
            try:
                if p.wait(timeout=max(left, 1.0)) != 0:
                    failed = f"rank {r} exited with {p.returncode}"
                    break
            except subprocess.TimeoutExpired:
                failed = f"the ranks ran past {DP_GLOO_TIMEOUT} s"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    if failed:
        for r in range(2):
            print(f"--- dp-gloo-2 rank {r} ---\n"
                  + (out / f'rank{r}.log').read_text()[-6000:], flush=True)
        fail(f"dp-gloo-2: {failed}")
    r0, r1 = (json.loads((out / f'rank{r}.json').read_text())
              for r in range(2))
    launches = {k: r0['launches'][k] + r1['launches'][k]
                for k in r0['launches']}
    print(f"dp-gloo-2: 2 ranks over {r0['backend']} on one card, eager, "
          f"{DP_GLOO_BATCH} walkers (2 x {DP_GLOO_BATCH // 2}), random "
          f"flagship weights | clipped-score step: loss {r0['loss']:.6f} "
          f"against one process {r0['loss_one']:.6f}, gradient cos "
          f"{r0['cos']:.8f}, norm ratio {r0['ratio']:.8f} | chunked Gram "
          f"({r0['n_params']} columns) {r0['gram_rel']:.3e} | SPRING update "
          f"{r0['spring_rel']:.3e} relative L2 (one process, walkers "
          f"reordered: {r0['spring_reorder_rel']:.3e}) | step size "
          f"{r0['step_size']:.9f} / {r1['step_size']:.9f} against one process "
          f"{r0['step_size_one']:.9f}, walkers {r0['positions_diff']:.3e} | "
          f"launches rank 0 {r0['launches']}, rank 1 {r1['launches']} | ms "
          f"per step while two processes time-share the card: adam "
          f"{r0['adam_ms']:.1f} / {r1['adam_ms']:.1f}, SPRING "
          f"{r0['spring_ms']:.1f} / {r1['spring_ms']:.1f} | {wall:.1f} s wall",
          flush=True)
    if r0['backend'] != 'gloo' or r0['size'] != 2:
        fail(f"dp-gloo-2: a world of {r0['size']} over {r0['backend']}")
    if not (r0['loss'] == r1['loss']
            and near(r0['loss'], r0['loss_one'], DP_LOSS_RTOL)):
        fail(f"dp-gloo-2: losses {r0['loss']}, {r1['loss']} against "
             f"{r0['loss_one']}")
    if not (r0['cos'] > DP_MIN_COS
            and DP_RATIO[0] < r0['ratio'] < DP_RATIO[1]):
        fail(f"dp-gloo-2: gradient cos {r0['cos']}, ratio {r0['ratio']}")
    if not r0['gram_rel'] <= DP_GRAM_RTOL:
        fail(f"dp-gloo-2: chunked Gram {r0['gram_rel']} from O O^T")
    if not r0['spring_rel'] <= DP_SPRING_TOL:
        fail(f"dp-gloo-2: SPRING update {r0['spring_rel']} from one process")
    if not (r0['step_size'] == r1['step_size']
            and near(r0['step_size'], r0['step_size_one'], DP_STEP_RTOL)):
        fail(f"dp-gloo-2: step sizes {r0['step_size']}, {r1['step_size']} "
             f"against {r0['step_size_one']}")
    if not r0['positions_diff'] <= 1e-5:
        fail(f"dp-gloo-2: the sharded sweep's walkers part from one "
             f"process's by {r0['positions_diff']}")
    for r, res in enumerate((r0, r1)):
        if min(res['launches'].values()) == 0:
            fail(f"dp-gloo-2: a kernel was not launched on rank {r}: "
                 f"{res['launches']}")
    return launches, dict(r0, rank1=r1, wall_s=wall)


# ---- 38-43. the table eval backend and the rest of the density side -------

def table_counts():
    """K1, K3 (which 'table' bypasses) and K4's five entry points (forward,
    pair, jet, backward, backward jet)."""
    from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler, cuda_spline
    return {'sampler': cuda_sampler.launches, 'basis_jet': cuda_jet.launches,
            'spline_eval': cuda_spline.launches,
            'spline_eval_pair': cuda_spline.launches_pair,
            'spline_eval_jet': cuda_spline.launches_jet,
            'spline_eval_bwd': cuda_spline.launches_bwd,
            'spline_eval_bwd_jet': cuda_spline.launches_bwd_jet}


def reset_table_counts():
    from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler, cuda_spline
    cuda_sampler.launches = cuda_jet.launches = 0
    cuda_spline.launches = cuda_spline.launches_pair = 0
    cuda_spline.launches_jet = cuda_spline.launches_bwd = 0
    cuda_spline.launches_bwd_jet = 0


def per_call_site(ev, requests, comps, x):
    """The per-call entries' launches of one site (the requests of
    ops/spline_eval.py::site_jet) on the card: {(component, order, step): value}."""
    from waveflow_tpu_torch.ops import cuda_spline
    out = {}
    for m, ks in requests:
        tabs = [(ev.slopes[d], True) if letter == 'S'
                else (ev.tables[d], False) for letter, d in ks]
        if len(ks) == 1:
            vals = (cuda_spline.spline_eval_cuda(tabs[0][0], comps[m], x,
                                                 tabs[0][1]),)
        else:
            vals = cuda_spline.spline_eval_pair_cuda(
                tabs[0][0], tabs[1][0], comps[m], x, tabs[0][1], tabs[1][1])
        for (letter, d), v in zip(ks, vals):
            out[(m, d, letter == 'S')] = v
    return out


def nan_rel_err(got, ref, scale) -> float:
    """``rel_err`` over the entries where ``ref`` is a number; infinite
    unless ``got`` is NaN exactly where ``ref`` is."""
    nan = ref.isnan()
    if not bool((got.isnan() == nan).all()):
        return float('inf')
    keep = ~nan
    return rel_err(got[keep], ref[keep], scale[keep]) if keep.any() else 0.0


# the table backend's two evaluation sites, by table family: an IMADE
# layer's ``pair(0)`` and the prior's ``__call__`` at order 0
JET_SITES = {'I-spline': (('G', 0), ('F', 1)), 'OB prior': (('F', 0),)}


def same_values(a, b) -> bool:
    """Equal, element by element, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def jet_bound(torch, ev, N, x, terms, n_components):
    """(bound ms, by) of one jet launch: x and the components' rows read
    once, the outputs written once, and the distinct table rows the terms
    need at the cells of x by ``table_rows``' rule (an order with a lerp
    term: the two rows around each cell; an order with step terms only:
    the row at the cell, its slope following from it), unpadded; a fused
    multiply-add per base for each lerp, a multiply per base for each step
    chunk and a dot per term."""
    n_b = ev.n_bases
    lerp = {d for _, d, st in terms if not st}
    step = {d for _, d, st in terms if st}
    rows = (len(lerp) * table_rows(torch, ev.n_mesh, x)
            + len(step - lerp) * table_rows(torch, ev.n_mesh, x, step=True))
    n_bytes = 4 * (N * (1 + n_components * n_b + len(terms)) + rows * n_b)
    n_ops = N * (n_b * (2 * len(lerp) + len(step)) + 2 * n_b * len(terms))
    return bound_ms(n_bytes, n_ops)


def per_call_bwd(ev, comps, x, vecs, c_groups, x_terms):
    """The per-call launches and sums that one launch of the backward jet
    entry replaces, on the card: a backward form (a g_x term per kind) as
    one backward-kernel launch per kind (its g·B term's weight is its g_x
    term's), both outputs, then the kinds' outputs added; a g·B form as one launch of the backward kernel without
    its x output per term (a product weight formed first), added in groups,
    then the groups -> (g_c or None, g_x or None)."""
    from waveflow_tpu_torch.ops import cuda_spline

    def table(d, step):
        return ev.slopes[d] if step else ev.tables[d]

    def add(a, b):
        return b if a is None else a + b

    g_c = g_x = None
    if x_terms:
        for ((_, d, st),), (v, m, dx, sx) in zip(c_groups, x_terms):
            gc, gx = cuda_spline.spline_eval_bwd_cuda(
                table(d, st), None if dx is None else table(dx, sx),
                comps[m], x, vecs[v], True, True, st, sx)
            g_c, g_x = add(g_c, gc), add(g_x, gx)
        return g_c, g_x
    for group in c_groups:
        part = None
        for factors, d, st in group:
            w = vecs[factors[0]]
            if len(factors) == 2:
                w = w * vecs[factors[1]]
            part = add(part, cuda_spline.spline_eval_bwd_cuda(
                table(d, st), None, None, x, w, True, False, st)[0])
        g_c = add(g_c, part)
    return g_c, None


def bwd_jet_bound(torch, ev, N, x, c_groups, x_terms, n_vecs, n_comps):
    """(bound ms, by) of one backward jet launch: x, the weight vectors
    and the components' rows read once, g_c and g_x written once, and the
    distinct table rows its terms need at the cells of x by
    ``table_rows``' rule (an order with a lerp term: the two rows around
    each cell; with step terms only: the row at the cell), unpadded; per
    row a fused multiply-add per base for each lerp basis and a multiply
    for each step basis, a multiply per base for each g_c term and an add
    between terms, a product per two-factor weight, a dot and a multiply
    per g_x term and an add between them."""
    n_b = ev.n_bases
    terms = [(d, st) for g in c_groups for _, d, st in g] + [
        (d, st) for _, _, d, st in x_terms if d is not None]
    lerp = {d for d, st in terms if not st}
    step = {d for d, st in terms if st}
    rows = (len(lerp) * table_rows(torch, ev.n_mesh, x)
            + len(step - lerp) * table_rows(torch, ev.n_mesh, x, step=True))
    n_c = sum(len(g) for g in c_groups)
    live_x = sum(d is not None for _, _, d, _ in x_terms)
    n_bytes = 4 * (N * (1 + n_vecs + n_comps * n_b + (n_b if n_c else 0)
                        + (1 if x_terms else 0)) + rows * n_b)
    n_ops = N * (n_b * (2 * len(lerp) + len(step)) + n_b * (2 * n_c - 1)
                 * (n_c > 0) + sum(len(f) == 2 for g in c_groups
                                    for f, _, _ in g)
                 + live_x * (2 * n_b + 1) + max(len(x_terms) - 1, 0))
    return bound_ms(n_bytes, n_ops)


class evaluations:
    """Within the block, the table evaluator's five launch points
    (ops/spline_eval.py) call K4's plain versions when ``plain``, else
    their own wrappers, and every call is counted in ``calls``, by entry
    point: the plain chain on the card, and the chain's evaluations counted
    on the CPU.  ``plain_calls`` counts the plain functions of
    ops/cuda_spline.py however they are reached."""

    def __init__(self, plain: bool):
        self.plain = plain
        self.calls = {'spline_eval': 0, 'spline_eval_pair': 0,
                      'spline_eval_jet': 0, 'spline_eval_bwd': 0,
                      'spline_eval_bwd_jet': 0}
        self.plain_calls = 0

    def __enter__(self):
        from waveflow_tpu_torch.ops import cuda_spline
        from waveflow_tpu_torch.ops import spline_eval as se
        self.saved = (se.spline_eval, se.spline_eval_pair, se.spline_eval_jet,
                      se.spline_eval_bwd, se.spline_eval_bwd_jet,
                      cuda_spline.lerp_basis)
        fwd, pair, jet, bwd, bwd_jet, lerp = self.saved

        def plain_pair(ta, tb, c, x, sa=False, sb=False):
            return (cuda_spline.spline_eval_plain(ta, c, x, sa),
                    cuda_spline.spline_eval_plain(tb, c, x, sb))

        def plain_jet(tables, slopes, records, comps, x, terms):
            return cuda_spline.spline_eval_jet_plain(tables, slopes, comps, x,
                                                     terms)

        def plain_bwd(td, tx, c, x, g, nc=True, nx=True, sd=False, sx=False):
            gc, gx = cuda_spline.spline_eval_bwd_plain(td, tx, c, x, g, sd, sx)
            return gc if nc else None, gx if nx else None

        def plain_bwd_jet(tables, slopes, records, comps, x, vecs, c_groups,
                          x_terms):
            return cuda_spline.spline_eval_bwd_jet_plain(
                tables, slopes, comps, x, vecs, c_groups, x_terms)

        def counting(name, fn):
            def call(*args, **kw):
                self.calls[name] += 1
                return fn(*args, **kw)
            return call

        def counting_lerp(*args, **kw):
            self.plain_calls += 1
            return lerp(*args, **kw)

        chosen = ((cuda_spline.spline_eval_plain, plain_pair, plain_jet,
                   plain_bwd, plain_bwd_jet) if self.plain
                  else (fwd, pair, jet, bwd, bwd_jet))
        (se.spline_eval, se.spline_eval_pair, se.spline_eval_jet,
         se.spline_eval_bwd, se.spline_eval_bwd_jet) = (
            counting(n, f) for n, f in zip(self.calls, chosen))
        # every plain version of K4 goes through the lerp of its rows
        cuda_spline.lerp_basis = counting_lerp
        return self

    def __exit__(self, *exc):
        from waveflow_tpu_torch.ops import cuda_spline
        from waveflow_tpu_torch.ops import spline_eval as se
        (se.spline_eval, se.spline_eval_pair, se.spline_eval_jet,
         se.spline_eval_bwd, se.spline_eval_bwd_jet,
         cuda_spline.lerp_basis) = self.saved


def rel_err(got, ref, scale=None) -> float:
    """max|got − ref| over max(1, max|scale|), ``scale`` ``ref`` unless
    given."""
    scale = ref if scale is None else scale
    return ((got - ref).abs().max()
            / max(1.0, scale.abs().max().item())).item()


def magnitude(torch, table, c, x, step=False):
    """Σ_i |c_i| |B_i(x)| per row: the size of the terms of a K4 sum, the
    scale of its f32 rounding (the orthonormal and derivative tables mix
    signs, so a sum can be far smaller than its terms)."""
    from waveflow_tpu_torch.ops import cuda_spline
    return cuda_spline.spline_eval_plain(table.abs(), c.abs(), x, step)


def table_chain_values(torch, ev, c0, W, x, orders):
    """ev(c0 + W·x, x, d) at every order d and both outputs of ev.pair at
    every pair order, with their first and second x-derivatives (nested
    jvps, the coefficients moving with x): {(what, d, k): tensor}."""
    one = torch.ones_like(x)
    fns = {}
    for d in orders:
        fns[('call', d)] = lambda xx, d=d: ev(c0 + W * xx[:, None], xx, d)
    for d in range(ev.n_derivatives - 1):
        for k in (0, 1):
            fns[(f'pair{k}', d)] = (lambda xx, d=d, k=k:
                                    ev.pair(c0 + W * xx[:, None], xx, d)[k])
    out = {}
    for key, f in fns.items():
        d1 = lambda xx, f=f: torch.func.jvp(f, (xx,), (one,))[1]
        d2 = lambda xx, d1=d1: torch.func.jvp(d1, (xx,), (one,))[1]
        for k, g in enumerate((f, d1, d2)):
            out[key + (k,)] = g(x)
    return out


def table_kernels_phase(torch, params):
    """K4's forward-mode chain on the card against its plain versions on
    the card, at the table backend's shapes: the flagship prior's
    orthonormal-B tables (28 bases) and the IMADE layers' I-spline tables
    (29 bases, the scalar path), 2000-point mesh, coefficients from the
    100k checkpoint's own conditioners.  The kernel entry points at N =
    512 and 40,000 and at ragged N: the forward kernel on the slope tables
    in step mode, the pair entry (value tables, slope tables, one of each),
    the backward kernel with value and step-mode tables and without
    coefficients, the jet entry and the backward jet entry (its three
    forms, each also to the bit against the per-call launches and sums it
    replaces, and timed beside them); then the chain itself (every order's value, first and second jvp with
    the coefficients moving with x, both outputs of ``pair``) against the
    same chain on the plain versions, and no plain lerp run by the kernel
    chain.  The pair entry is timed against its plain version."""
    from waveflow_tpu_torch.ops import cuda_spline
    from waveflow_tpu_torch.ops import spline_eval as se
    model = flagship_model(torch, params, 'table')
    gen = torch.Generator('cuda').manual_seed(21)
    N_max = 40000
    evs = {'OB prior': model.ev_ob,
           'I-spline': model.transform.layers[1].ev}
    u = torch.rand((N_max // 2 + 1, 2), generator=gen, device='cuda')
    with torch.no_grad():
        coeffs = {'OB prior': model.ob_coeffs(u),
                  'I-spline': model.transform.layers[1].spline_params(u)}
    x = torch.rand((N_max + 1,), generator=gen, device='cuda') * 1.1 - 0.05
    x[:6] = torch.tensor([0.0, 1.0, -0.03, 1.02, 0.5, 1 / 1999])
    g = torch.randn((N_max + 1,), generator=gen, device='cuda')
    # x with NaN at every fifth row: step mode reads cell 0's slope there
    x_nan = x.clone()
    x_nan[::5] = float('nan')
    worst = {'step': 0.0, 'pair': 0.0, 'bwd': 0.0, 'chain': 0.0, 'jet': 0.0,
             'bwd_jet': 0.0}
    rows = {}
    jet_equal = bwd_jet_equal = True
    for name, ev in evs.items():
        cc = coeffs[name].reshape(-1, ev.n_bases)[:N_max + 1].contiguous()
        n_b, nd = ev.n_bases, ev.n_derivatives
        for N in (1, 3, 31, 512, 513, N_max, N_max + 1):
            c, xx, gg = cc[:N], x[:N], g[:N]
            for d in range(nd):
                T, S = ev.tables[d], ev.slopes[d]
                for xs in (xx, x_nan[:N]):
                    worst['step'] = max(worst['step'], rel_err(
                        cuda_spline.spline_eval_cuda(S, c, xs, step=True),
                        cuda_spline.spline_eval_plain(S, c, xs, step=True),
                        magnitude(torch, S, c, xs, True)))
                if d + 1 < nd:
                    T1 = ev.tables[d + 1]
                    for ta, tb, sa, sb in ((T, T1, False, False),
                                           (S, ev.slopes[d + 1], True, True),
                                           (T, S, False, True)):
                        ya, yb = cuda_spline.spline_eval_pair_cuda(
                            ta, tb, c, xx, sa, sb)
                        worst['pair'] = max(
                            worst['pair'],
                            rel_err(ya, cuda_spline.spline_eval_plain(
                                ta, c, xx, sa),
                                magnitude(torch, ta, c, xx, sa)),
                            rel_err(yb, cuda_spline.spline_eval_plain(
                                tb, c, xx, sb),
                                magnitude(torch, tb, c, xx, sb)))
                for tx, sd, sx, cx in ((S, False, True, c),
                                       (None, True, False, c),
                                       (None, False, False, None)) + (
                        ((ev.tables[d + 1], False, False, c),)
                        if d + 1 < nd else ()):
                    got = cuda_spline.spline_eval_bwd_cuda(
                        S if sd else T, tx, cx, xx, gg, step_d=sd,
                        step_d1=sx)
                    ref = cuda_spline.spline_eval_bwd_plain(
                        S if sd else T, tx, cx, xx, gg, sd, sx)
                    # g_coeffs is a product, no sum: its own scale
                    worst['bwd'] = max(
                        worst['bwd'], rel_err(got[0], ref[0]),
                        rel_err(got[1], ref[1], None if tx is None else
                                gg * magnitude(torch, tx, cx, xx, sx)))
        # the pair entry's and the step mode's times at the main paths'
        # shapes: train-256 (512 rows), a Hψ pass at 4,096 walkers (8,192)
        for N in (512, 8192, N_max):
            c, xx = cc[:N], x[:N]
            T0, T1, S0 = ev.tables[0], ev.tables[1], ev.slopes[0]
            k_ms = cuda_ms(torch, lambda: cuda_spline.spline_eval_pair_cuda(
                T0, T1, c, xx))
            d_ms = device_ms(torch, lambda: cuda_spline.spline_eval_pair_cuda(
                T0, T1, c, xx))
            p_ms = cuda_ms(torch, lambda: (
                cuda_spline.spline_eval_plain(T0, c, xx),
                cuda_spline.spline_eval_plain(T1, c, xx)))
            # coefficients and x read once, two outputs, the rows of the
            # two tables that x reads
            b_ms, b_by = bound_ms(
                4 * (N * (n_b + 3)
                     + 2 * table_rows(torch, ev.n_mesh, xx) * n_b),
                N * (8 * n_b + 6))
            rows[(name, N)] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   plan=cuda_spline.plan(N, n_b))
            s_ms = cuda_ms(torch, lambda: cuda_spline.spline_eval_cuda(
                S0, c, xx, step=True))
            sd_ms = device_ms(torch, lambda: cuda_spline.spline_eval_cuda(
                S0, c, xx, step=True))
            sp_ms = cuda_ms(torch, lambda: cuda_spline.spline_eval_plain(
                S0, c, xx, step=True))
            sb_ms, sb_by = bound_ms(
                4 * (N * (n_b + 2)
                     + table_rows(torch, ev.n_mesh, xx, step=True) * n_b),
                N * (2 * n_b + 4))
            rows[('step', name, N)] = dict(
                ms=s_ms, device_ms=sd_ms, plain_ms=sp_ms, bound_ms=sb_ms,
                bound_by=sb_by)
            print(f"K4 {name} N={N} (n_bases {n_b}): pair entry kernel_ms "
                  f"{k_ms:.4f} device_ms {d_ms:.4f} plain_ms {p_ms:.4f} (two "
                  f"gather-lerps) bound_ms {b_ms:.5f} ({b_by}) | forward "
                  f"kernel in step mode on the slope table kernel_ms "
                  f"{s_ms:.4f} device_ms {sd_ms:.4f} plain_ms {sp_ms:.4f} "
                  f"bound_ms {sb_ms:.5f} ({sb_by})", flush=True)
            # the backward kernel in the forms the table backend launches:
            # g·B on the value table with g_x from the next value table (a
            # grad-level site's per-kind backward), or from the slope table
            # in step mode (the grad of a plain lerp); g·B alone on the
            # value table and on the slope table in step mode (a tangent's
            # terms, per call); bound by check_spline_eval's rule, a step
            # table's rows read once
            gg = g[:N]
            rows_l = table_rows(torch, ev.n_mesh, xx)
            rows_s = table_rows(torch, ev.n_mesh, xx, step=True)
            for form, td, sd, tx, sx, cx, bytes_, ops_ in (
                    ('value g_x', T0, False, T1, False, c,
                     4 * (N * (3 + 2 * n_b) + 2 * rows_l * n_b),
                     N * (7 * n_b + 7)),
                    ('step g_x', T0, False, S0, True, c,
                     4 * (N * (3 + 2 * n_b) + (rows_l + rows_s) * n_b),
                     N * (5 * n_b + 7)),
                    ('no coeffs', T0, False, None, False, None,
                     4 * (N * (3 + n_b) + rows_l * n_b), N * (3 * n_b + 6)),
                    ('step, no coeffs', S0, True, None, False, None,
                     4 * (N * (3 + n_b) + rows_s * n_b), N * (n_b + 6))):
                def bwd(td=td, sd=sd, tx=tx, sx=sx, cx=cx):
                    return cuda_spline.spline_eval_bwd_cuda(
                        td, tx, cx, xx, gg, step_d=sd, step_d1=sx)

                def bwd_plain(td=td, sd=sd, tx=tx, sx=sx, cx=cx):
                    return cuda_spline.spline_eval_bwd_plain(
                        td, tx, cx, xx, gg, sd, sx)

                bk_ms, bd_ms = cuda_ms(torch, bwd), device_ms(torch, bwd)
                bp_ms = cuda_ms(torch, bwd_plain)
                bb_ms, bb_by = bound_ms(bytes_, ops_)
                rows[('bwd', form, name, N)] = dict(
                    ms=bk_ms, device_ms=bd_ms, plain_ms=bp_ms,
                    bound_ms=bb_ms, bound_by=bb_by)
                print(f"K4 {name} N={N}: backward kernel ({form}) kernel_ms "
                      f"{bk_ms:.4f} device_ms {bd_ms:.4f} plain_ms "
                      f"{bp_ms:.4f} bound_ms {bb_ms:.5f} ({bb_by})",
                      flush=True)
        # the jet entry: the site's terms over 4 coefficient components
        # (the conditioners' own and three random) in one launch, against
        # its plain version and, value for value, against the per-call
        # launches it replaces; x at 0, 1, outside [0, 1] and NaN
        requests, terms = se.site_jet(ev, JET_SITES[name])
        comps_all = [cc] + [torch.randn(cc.shape, generator=gen,
                                        device='cuda') for _ in range(3)]
        x_jet = x.clone()
        x_jet[6] = float('nan')
        for N in (1, 3, 31, 512, 513, 8192, N_max, N_max + 1):
            comps, xx = [a[:N] for a in comps_all], x_jet[:N]
            got = cuda_spline.spline_eval_jet_cuda(ev.records, comps, xx,
                                                   terms, n_b)
            ref = cuda_spline.spline_eval_jet_plain(ev.tables, ev.slopes,
                                                    comps, xx, terms)
            per = per_call_site(ev, requests, comps, xx)
            for t, (m, d, st) in enumerate(terms):
                table = ev.slopes[d] if st else ev.tables[d]
                worst['jet'] = max(worst['jet'], nan_rel_err(
                    got[t], ref[t],
                    magnitude(torch, table, comps[m], xx, st)))
                jet_equal &= same_values(got[t], per[(m, d, st)])
        # timed at the main paths' shapes beside the per-call launches of
        # the same site on the same inputs, in turns (per-call, jet, jet,
        # per-call; CUDA events), each also by the profiler's device time
        for N in (512, 8192, N_max):
            comps, xx = [a[:N] for a in comps_all], x[:N]

            def jet(comps=comps, xx=xx):
                return cuda_spline.spline_eval_jet_cuda(ev.records, comps,
                                                        xx, terms, n_b)

            def per_call(comps=comps, xx=xx):
                return per_call_site(ev, requests, comps, xx)

            turns = [cuda_ms(torch, f) for f in (per_call, jet, jet,
                                                 per_call)]
            j_dev, pc_dev = device_ms(torch, jet), device_ms(torch, per_call)
            j_plain = cuda_ms(torch, lambda: cuda_spline.spline_eval_jet_plain(
                ev.tables, ev.slopes, comps, xx, terms))
            jb_ms, jb_by = jet_bound(torch, ev, N, xx, terms, len(comps))
            p = cuda_spline.plan_jet(N, n_b, len(terms), len(comps), nd)
            rows[('jet', name, N)] = dict(
                ms=(turns[1] + turns[2]) / 2, device_ms=j_dev,
                plain_ms=j_plain, bound_ms=jb_ms, bound_by=jb_by,
                per_call_ms=(turns[0] + turns[3]) / 2,
                per_call_device_ms=pc_dev, per_call_launches=len(requests),
                terms=len(terms), turns_ms=turns, plan=p)
            print(f"K4 jet entry {name} N={N} ({len(terms)} terms over 4 "
                  f"components, grid {p.grid} x {p.threads} threads): "
                  f"kernel_ms {rows[('jet', name, N)]['ms']:.4f} device_ms "
                  f"{j_dev:.4f} plain_ms {j_plain:.4f} bound_ms "
                  f"{jb_ms:.5f} ({jb_by}) | the {len(requests)} per-call "
                  f"launches it replaces: kernel_ms "
                  f"{rows[('jet', name, N)]['per_call_ms']:.4f} device_ms "
                  f"{pc_dev:.4f} | turns per-call / jet / jet / per-call "
                  f"{' / '.join(f'{v:.4f}' for v in turns)}", flush=True)
        # the backward jet entry in the forms the gathered chain launches
        # at this site (ops/spline_eval.py::site_bwd): its backward (every
        # kind's g·B and g_x; the prior's one kind) and the IMADE site's
        # tangent (4 terms, lerp and step, g·t_x formed in the kernel),
        # against its plain version and, value for value, against the
        # per-call backward launches and sums it replaces; x at 0, 1,
        # outside [0, 1] and NaN
        forms = se.site_bwd(ev, JET_SITES[name])
        if name == 'OB prior':
            del forms['tangent']
        slots_all = {slot for slots, _, _ in forms.values() for slot in slots}
        vec_all = {slot: torch.randn((N_max + 1,), generator=gen,
                                     device='cuda') for slot in slots_all}

        def bwd_operands(form, N, xx):
            slots, c_groups, x_terms = forms[form]
            return ([cc[:N]] if x_terms else [], xx,
                    [vec_all[slot][:N] for slot in slots], c_groups, x_terms)

        for N in (1, 3, 31, 512, 513, 8192, N_max, N_max + 1):
            for form in forms:
                comps, xx, vecs, c_groups, x_terms = bwd_operands(
                    form, N, x_jet[:N])
                got = cuda_spline.spline_eval_bwd_jet_cuda(
                    ev.records, comps, xx, vecs, c_groups, x_terms, n_b)
                ref = cuda_spline.spline_eval_bwd_jet_plain(
                    ev.tables, ev.slopes, comps, xx, vecs, c_groups, x_terms)
                # each output's scale: the sum of its terms' magnitudes
                scale = cuda_spline.spline_eval_bwd_jet_plain(
                    ev.tables.abs(), ev.slopes.abs(),
                    [a.abs() for a in comps], xx, [v.abs() for v in vecs],
                    c_groups, x_terms)
                per = per_call_bwd(ev, comps, xx, vecs, c_groups, x_terms)
                for out, r, sc, pc in zip(got, ref, scale, per):
                    if r is None:
                        continue
                    worst['bwd_jet'] = max(worst['bwd_jet'],
                                           nan_rel_err(out, r, sc))
                    bwd_jet_equal &= same_values(out, pc)
        # timed at the main paths' shapes beside the per-call launches and
        # sums, in turns (per-call, entry, entry, per-call; CUDA events),
        # each also by the profiler's device time
        for N in (512, 8192, N_max):
            for form in forms:
                comps, xx, vecs, c_groups, x_terms = bwd_operands(form, N,
                                                                  x[:N])

                def new(ops=(comps, xx, vecs, c_groups, x_terms)):
                    return cuda_spline.spline_eval_bwd_jet_cuda(
                        ev.records, *ops, n_b)

                def old(ops=(comps, xx, vecs, c_groups, x_terms)):
                    return per_call_bwd(ev, *ops)

                turns = [cuda_ms(torch, f) for f in (old, new, new, old)]
                n_dev, o_dev = device_ms(torch, new), device_ms(torch, old)
                n_plain = cuda_ms(
                    torch, lambda: cuda_spline.spline_eval_bwd_jet_plain(
                        ev.tables, ev.slopes, comps, xx, vecs, c_groups,
                        x_terms))
                b_ms, b_by = bwd_jet_bound(torch, ev, N, xx, c_groups,
                                           x_terms, len(vecs), len(comps))
                n_terms = sum(len(g) for g in c_groups)
                p = cuda_spline.plan_bwd_jet(N, n_b, n_terms, len(x_terms),
                                             len(vecs), len(comps))
                replaced = len(x_terms) or n_terms
                row = rows[('bwd_jet', form, name, N)] = dict(
                    ms=(turns[1] + turns[2]) / 2, device_ms=n_dev,
                    plain_ms=n_plain, bound_ms=b_ms, bound_by=b_by,
                    per_call_ms=(turns[0] + turns[3]) / 2,
                    per_call_device_ms=o_dev, per_call_launches=replaced,
                    turns_ms=turns, plan=p)
                print(f"K4 backward jet entry {name} {form} N={N} "
                      f"({n_terms} g_c terms, {len(x_terms)} g_x terms, grid "
                      f"{p.grid} x {p.threads} threads, {p.smem_bytes} B "
                      f"staged): kernel_ms {row['ms']:.4f} device_ms "
                      f"{n_dev:.4f} plain_ms {n_plain:.4f} bound_ms "
                      f"{b_ms:.5f} ({b_by}; {n_dev / b_ms:.1f}x) | the "
                      f"{replaced} per-call backward launches and their sums "
                      f"it replaces: kernel_ms {row['per_call_ms']:.4f} "
                      f"device_ms {o_dev:.4f} | turns per-call / entry / "
                      f"entry / per-call "
                      f"{' / '.join(f'{v:.4f}' for v in turns)}", flush=True)
        # the chain: kernel against the plain chain, launches counted
        for N in (512, N_max):
            c0 = cc[:N]
            W = 0.5 * torch.randn(c0.shape, generator=gen, device='cuda')
            xx = x[:N]
            reset_table_counts()
            with evaluations(plain=False) as k_run:
                got = table_chain_values(torch, ev, c0, W, xx, range(nd))
            torch.cuda.synchronize()
            launched = table_counts()
            with evaluations(plain=True) as p_run:
                ref = table_chain_values(torch, ev, c0, W, xx, range(nd))
            errs = {key: rel_err(got[key], ref[key]) for key in got}
            worst['chain'] = max(worst['chain'], max(errs.values()))
            if k_run.plain_calls:
                fail(f"table-kernels: the kernel chain ran {k_run.plain_calls}"
                     " plain lerps on the card")
            if {k: launched[k] for k in k_run.calls} != k_run.calls \
                    or k_run.calls != p_run.calls:
                fail(f"table-kernels: launches {launched} against the "
                     f"chain's calls {k_run.calls} (plain chain "
                     f"{p_run.calls})")
            print(f"K4 forward-mode chain {name} N={N}: values, first and "
                  f"second jvps of every order and of pair, kernel against "
                  f"the plain chain on the card: max {max(errs.values()):.3e}"
                  f" of max(1, max|ref|) (limit 2e-5) | launches forward "
                  f"{launched['spline_eval']}, pair "
                  f"{launched['spline_eval_pair']}, backward "
                  f"{launched['spline_eval_bwd']}, equal to the chain's "
                  f"evaluations; plain lerps on the card 0", flush=True)
    # the evaluator-only inverse: 30 bisections and 2 Newton steps, every
    # evaluation a K4 launch, against the same on the plain versions
    from waveflow_tpu_torch.ops import bisection_inverse
    ev_i = evs['I-spline']
    with torch.no_grad():
        w = coeffs['I-spline'].reshape(-1, ev_i.n_bases)[:512].contiguous()
        y = ev_i(w, torch.rand((512,), generator=gen, device='cuda'))
        reset_table_counts()
        got = bisection_inverse(ev_i, w, y)
        torch.cuda.synchronize()
        n_bisect = table_counts()
        with evaluations(plain=True):
            ref = bisection_inverse(ev_i, w, y)
    worst['bisect'] = (got - ref).abs().max().item()
    # the forms the trainer menu's paths launch beyond this grid
    menu_worst, menu_rows = menu_kernel_rows(torch, params)
    worst['menu'] = max(menu_worst.values())
    rows['menu'] = menu_rows
    back = (ev_i(w, got) - y).abs().max().item()
    print(f"K4 under the 'bisect' inverse (512 I-spline rows): "
          f"{n_bisect['spline_eval']} forward launches (30 bisections + 2 x "
          f"2 Newton evaluations), max|dx| {worst['bisect']:.3e} against the "
          f"plain versions, |f(x) - y| {back:.3e}", flush=True)
    if n_bisect['spline_eval'] != 34 or not worst['bisect'] <= 1e-5 \
            or not back <= 1e-5:
        fail(f"table-kernels: the 'bisect' inverse: {n_bisect}, "
             f"{worst['bisect']:.3e}, {back:.3e}")
    print("K4 entry points at N = 1 ... 40,001 on both table families: "
          f"step mode {worst['step']:.3e} (NaN x included), pair "
          f"{worst['pair']:.3e}, jet {worst['jet']:.3e} (x at 0, 1, outside "
          f"[0, 1], NaN; NaN where the plain version is), backward with "
          f"step-mode tables / without coefficients {worst['bwd']:.3e}, "
          f"backward jet {worst['bwd_jet']:.3e} (its three forms, NaN x "
          f"included), the menu's launches {worst['menu']:.3e} (replayed) "
          "against their plain versions, of max(1, the largest "
          "row's sum of term magnitudes) (limit 2e-5) | the jet's outputs "
          f"{'equal' if jet_equal else 'NOT equal'} to the per-call "
          "launches' value for value | the backward jet's outputs "
          f"{'equal' if bwd_jet_equal else 'NOT equal'} to the per-call "
          "backward launches and sums value for value", flush=True)
    bad = {k: v for k, v in worst.items() if k != 'bisect' and not v <= 2e-5}
    if bad:
        fail(f"table-kernels: K4 disagrees with its plain versions: {bad}")
    if not jet_equal:
        fail("table-kernels: the jet entry differs from the per-call "
             "launches it replaces")
    if not bwd_jet_equal:
        fail("table-kernels: the backward jet entry differs from the "
             "per-call backward launches and sums it replaces")
    rows['max_abs_err'] = worst
    return None, rows


def table_hpsi_phase(torch, params):
    """The 100k checkpoint under 'table': Hψ ('fwd_batched') at 4,096
    walkers drawn by K1, the K4 chain against the plain chain on the card
    (TABLE_HPSI_RTOL of max|Hψ|); K4 launches per Hψ pass against the
    count the same pass makes on the CPU (the code's own evaluations, 8
    walkers: the count does not depend on the batch), gathered and per
    call; every Laplacian form's Hψ gathered (the jet, the gathered
    backward) equal to the per-call chain's to the bit; every form's
    launches and ms per pass; E_L 'table' against 'poly_pallas' on the
    same walkers (TABLE_POLY_EL_BOUND)."""
    from waveflow_tpu_torch.models import get_waveflow_model
    from waveflow_tpu_torch.ops import spline_eval as se
    mt = flagship_model(torch, params, 'table')
    mp = flagship_model(torch, params, 'poly_pallas')
    reset_table_counts()
    x = mt.sample(4096, generator=torch.Generator('cuda').manual_seed(11))
    k1 = table_counts()['sampler']
    cpu = get_waveflow_model(
        2, base_spline_degree=FLAGSHIP['spline_degree'],
        i_spline_degree=FLAGSHIP['spline_degree'],
        n_prior_internal_knots=FLAGSHIP['num_knots'],
        n_i_internal_knots=FLAGSHIP['num_knots'], i_spline_reg=0.05,
        n_flow_layers=3, box_size=10.0, eval_backend='table',
        generator=torch.Generator().manual_seed(0), device='cpu')
    cpu.load_state_dict(params)
    rows = {}
    with torch.no_grad():
        for mode in ('fwd_batched', 'fwd', 'hvp', 'dense'):
            with evaluations(plain=False) as derived:
                he_hamiltonian(cpu, mode)(x[:8].cpu())
            h = he_hamiltonian(mt, mode)
            h(x[:64])
            torch.cuda.synchronize()
            reset_table_counts()
            hk = h(x)[:, 0]
            torch.cuda.synchronize()
            per_pass = table_counts()
            ms = cuda_ms(torch, lambda: h(x), reps=3, warmup=1)
            row = dict(launches_per_pass=per_pass, derived=derived.calls,
                       ms=ms)
            # the same pass on the per-call entries: Hψ to the bit (the jet
            # under 'fwd_batched' and 'fwd', the gathered backward under
            # 'hvp' and 'dense'), and the per-call launches against the
            # same pass's evaluations on the CPU
            with se._per_call():
                with evaluations(plain=False) as derived_pc:
                    he_hamiltonian(cpu, mode)(x[:8].cpu())
                reset_table_counts()
                hpc = h(x)[:, 0]
                torch.cuda.synchronize()
                row['per_call_launches_per_pass'] = table_counts()
                row['per_call_ms'] = cuda_ms(torch, lambda: h(x), reps=3,
                                             warmup=1)
            row['per_call_equal'] = same_values(hk, hpc)
            print(f"table-hpsi {mode}: Hpsi gathered "
                  f"{'equal to' if row['per_call_equal'] else 'NOT equal to'}"
                  f" the per-call chain's on the card | per-call "
                  f"launches per pass {row['per_call_launches_per_pass']}"
                  f" | per-call {row['per_call_ms']:.2f} ms per pass",
                  flush=True)
            if not row['per_call_equal']:
                fail(f"table-hpsi {mode}: Hpsi gathered differs from the "
                     "per-call chain's")
            if {k: row['per_call_launches_per_pass'][k]
                    for k in derived_pc.calls} != derived_pc.calls:
                fail(f"table-hpsi {mode}: per-call K4 launches "
                     f"{row['per_call_launches_per_pass']} against the "
                     f"{derived_pc.calls} evaluations the code makes")
            if mode == 'fwd_batched':
                with evaluations(plain=True):
                    hp = h(x)[:, 0]
                scale = hp.abs().max().item()
                row['rel_err'] = (hk - hp).abs().max().item() / scale
                hk_main = hk
            rows[mode] = row
            print(f"table-hpsi {mode}: K4 launches per Hpsi pass at 4096 "
                  f"walkers: forward {per_pass['spline_eval']}, pair "
                  f"{per_pass['spline_eval_pair']}, jet "
                  f"{per_pass['spline_eval_jet']}, backward "
                  f"{per_pass['spline_eval_bwd']}, backward jet "
                  f"{per_pass['spline_eval_bwd_jet']} (the code's evaluations "
                  f"on the CPU: {derived.calls}) | {ms:.2f} ms per pass"
                  + (f" | kernel against the plain chain on the card: max "
                     f"|dHpsi| {row['rel_err']:.3e} of max|Hpsi| {scale:.4f}"
                     f" (limit {TABLE_HPSI_RTOL:g})" if 'rel_err' in row
                     else ""), flush=True)
            if {k: per_pass[k] for k in derived.calls} != derived.calls:
                fail(f"table-hpsi {mode}: K4 launches {per_pass} against the "
                     f"{derived.calls} evaluations the code makes")
        if not (torch.isfinite(hk_main).all()
                and rows['fwd_batched']['rel_err'] <= TABLE_HPSI_RTOL):
            fail(f"table-hpsi: the K4 chain's Hpsi differs from the plain "
                 f"chain's by {rows['fwd_batched']['rel_err']:.3e}")
        psi_t, psi_p = mt.psi(x), mp.psi(x)
        e_t = hk_main / psi_t
        e_p = he_hamiltonian(mp, 'fwd_batched')(x)[:, 0] / psi_p
        ms_poly = cuda_ms(torch, lambda: he_hamiltonian(mp, 'fwd_batched')(x),
                          reps=3, warmup=1)
    rows['el_table_vs_poly'] = dict(
        el_against_poly("table-hpsi", e_t, e_p, psi_p,
                        f" | 'poly_pallas' Hpsi pass {ms_poly:.2f} ms | K1 "
                        f"{k1} launches for the walkers"),
        poly_pallas_ms=ms_poly, k1=k1)
    # the path: the walkers' draw and one 'fwd_batched' Hψ pass, each read
    # just after its own reset (the later passes and timings are not it)
    launches = dict(rows['fwd_batched']['launches_per_pass'], sampler=k1)
    return launches, rows


def el_against_poly(label, e_t, e_p, psi_p, note=""):
    """E_L under 'table' (``e_t``) against 'poly_pallas' (``e_p``) on the
    same walkers where |ψ| > 0.05 max|ψ| (``psi_p``, JAX's
    test_waveflow_poly_vs_table_backends criterion): the largest within
    TABLE_POLY_EL_BOUND and the mean within TABLE_POLY_EL_MEAN_BOUND, the
    float64 interpolation error -> dict(max, mean, walkers)."""
    big = psi_p.abs() > 0.05 * psi_p.abs().max()
    d = (e_t - e_p).abs()[big]
    row = dict(max=d.max().item(), mean=d.mean().item(),
               walkers=int(big.sum()))
    print(f"{label}: E_L 'table' against 'poly_pallas' on the same "
          f"{psi_p.numel()} walkers (|psi| > 0.05 max|psi|: "
          f"{row['walkers']}): max {row['max']:.4e} (bound "
          f"{TABLE_POLY_EL_BOUND:g}), mean {row['mean']:.4e} (bound "
          f"{TABLE_POLY_EL_MEAN_BOUND:g}){note}", flush=True)
    if not (row['max'] <= TABLE_POLY_EL_BOUND
            and row['mean'] <= TABLE_POLY_EL_MEAN_BOUND):
        fail(f"{label}: E_L under 'table' is further from 'poly_pallas' "
             "than the float64 interpolation error allows")
    return row


def table_eval_phase(torch, jax_raw, jax_clipped):
    """The 100k checkpoint evaluated under 'table' at the JAX protocol
    (4,096 walkers, 250 + 64 × 25 sweeps, graphed), raw and clipped printed
    beside the JAX 'poly' figures (no JAX 'table' figure exists: a record,
    not a gate); finite, accept rate in [0.45, 0.55], K1 and K4 launched."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, evaluate_trainer
    trainer = VMCTrainer(VMCConfig(eval_backend='table', device='cuda'))
    if not trainer.load_checkpoint(str(CHECKPOINT.parent)):
        fail(f"no checkpoint under {CHECKPOINT.parent}")
    reset_table_counts()
    t0 = time.perf_counter()
    ev = evaluate_trainer(trainer, n_blocks=64, sweeps_per_block=25,
                          n_warmup_sweeps=250, batch_size=4096)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = table_counts()
    row = dict(e_mean=ev.e_mean, e_stderr=ev.e_stderr,
               e_clipped=ev.e_clipped, e_clipped_stderr=ev.e_clipped_stderr,
               accept_rate=ev.accept_rate, wall_s=wall,
               sigma_raw_vs_poly=sigmas(ev.e_mean, ev.e_stderr, jax_raw),
               sigma_clipped_vs_poly=sigmas(ev.e_clipped,
                                            ev.e_clipped_stderr,
                                            jax_clipped))
    print(f"table-eval (epoch {trainer.epoch}, 'table', graphed): E = "
          f"{ev.e_mean:.6f} +- {ev.e_stderr:.6f}, clipped {ev.e_clipped:.6f} "
          f"+- {ev.e_clipped_stderr:.6f} | JAX 'poly' raw {jax_raw[0]} +- "
          f"{jax_raw[1]}, clipped {jax_clipped[0]} +- {jax_clipped[1]} "
          f"({row['sigma_raw_vs_poly']:.2f} / "
          f"{row['sigma_clipped_vs_poly']:.2f} combined sigma; a record) | "
          f"accept {ev.accept_rate:.4f} | {wall:.2f} s | launches {launches}",
          flush=True)
    if not (math.isfinite(ev.e_mean) and math.isfinite(ev.e_clipped)):
        fail("table-eval: non-finite energies")
    if not 0.45 <= ev.accept_rate <= 0.55:
        fail(f"table-eval: accept rate {ev.accept_rate} outside [0.45, 0.55]")
    if not (launches['sampler'] and launches['spline_eval']
            and launches['spline_eval_pair'] and launches['spline_eval_jet']):
        fail(f"table-eval: a kernel of the path was not launched: {launches}")
    return launches, row


def graph_table_phase(torch, params):
    """train-256 under 'table' (the flagship config from the 100k
    checkpoint): the graphed adam window against its eager twin, to the
    bit, K1 and K4 launches per replayed epoch; the gathered twin (the jet
    and the gathered backward) against the per-call twin, to the bit, K4
    launches per replayed epoch against the CPU-derived counts, and device
    busy per replayed epoch by the profiler in turns; then ms per replayed
    epoch against the 'poly_pallas' twin, windows of 2 x 10 in turns
    table, poly, poly, table (CUDA events)."""
    from waveflow_tpu_torch.ops import spline_eval as se
    trainer = twin_maker(CHECKPOINT.parent, {}, GRAPH_WINDOW, 'table')
    launches, row = graph_twins(
        torch, "graph-table train-256", trainer, read=table_counts, reset=reset_table_counts,
        required=('sampler', 'spline_eval', 'spline_eval_pair',
                  'spline_eval_jet', 'spline_eval_bwd',
                  'spline_eval_bwd_jet'))
    twins = {'table': trainer(None), 'per_call': trainer(None)}

    def turn(k):
        """2 windows of GRAPH_WINDOW replayed epochs of twin ``k`` (the
        per-call twin with every site on the per-call entries): (ms per
        epoch by CUDA events, launches per epoch)."""
        reset_table_counts()
        with se._per_call() if k == 'per_call' else contextlib.nullcontext():
            _, dt = events_ms(torch, lambda: twins[k].train(2 * GRAPH_WINDOW,
                                                            verbose=False))
        return dt / (2 * GRAPH_WINDOW), {
            n: v / (2 * GRAPH_WINDOW) for n, v in table_counts().items()}

    for k in twins:
        turn(k)                                       # warm-up and capture
    # the jet against the per-call entries, graphed: turns per-call, jet,
    # jet, per-call, then everything the two carry compared
    jet_ms, pc_launches = {'table': [], 'per_call': []}, {}
    for k in ('per_call', 'table', 'table', 'per_call'):
        dt, per_epoch = turn(k)
        jet_ms[k].append(dt)
        pc_launches[k] = per_epoch
    bitwise, rel, _ = compare_twins(torch, trainer_tensors(torch,
                                                           twins['table']),
                                    trainer_tensors(torch, twins['per_call']))
    # K4's launches in one epoch as the code makes them on the CPU
    derived = {'table': menu_epoch_evaluations(torch, params, {})['calls']}
    with se._per_call():
        derived['per_call'] = menu_epoch_evaluations(torch, params,
                                                     {})['calls']
    row['jet_against_per_call'] = dict(
        bitwise=bitwise, max_rel_diff=rel, turns_ms=jet_ms,
        launches_per_epoch=pc_launches, derived_per_epoch=derived,
        ms_per_replayed_epoch={k: sum(v) / len(v) for k, v in jet_ms.items()})

    def backward(counts):
        return counts['spline_eval_bwd'] + counts['spline_eval_bwd_jet']

    print(f"graph-table: gathered (jet and backward jet) against per-call "
          f"after {6 * GRAPH_WINDOW} epochs each ({4 * GRAPH_WINDOW} "
          f"replayed in turns): {'equal to the bit' if bitwise else 'NOT bitwise'}"
          f" (largest relative difference {rel:.3e}) | ms per replayed "
          f"epoch, turns per-call / gathered / gathered / per-call: "
          f"{jet_ms['per_call'][0]:.3f} / {jet_ms['table'][0]:.3f} / "
          f"{jet_ms['table'][1]:.3f} / {jet_ms['per_call'][1]:.3f} | K4 "
          f"launches per replayed epoch: gathered {pc_launches['table']} "
          f"(backward {backward(pc_launches['table']):g}), per-call "
          f"{pc_launches['per_call']} (backward "
          f"{backward(pc_launches['per_call']):g}) | the code's evaluations "
          f"per epoch on the CPU: gathered {derived['table']}, per-call "
          f"{derived['per_call']}", flush=True)
    if not bitwise:
        fail(f"graph-table: the gathered windows differ from the per-call "
             f"entries' by {rel:.3e}")
    for k in ('table', 'per_call'):
        if {n: pc_launches[k][n] for n in derived[k]} != derived[k]:
            fail(f"graph-table: {k} K4 launches per replayed epoch "
                 f"{pc_launches[k]} against the {derived[k]} evaluations "
                 "the code makes")
    # the device's side of the A/B: busy time and kernels per replayed
    # epoch of each twin, in turns (the profiler; wall time drifts between
    # turns)
    busy = {'per_call': [], 'table': []}
    kernels = {'per_call': [], 'table': []}
    for k in ('per_call', 'table', 'table', 'per_call'):
        with se._per_call() if k == 'per_call' else contextlib.nullcontext():
            prof = profile_window(
                torch, lambda: twins[k].train_window(10, twins[k].baseline),
                10, f"graph-table {'per-call' if k == 'per_call' else 'gathered'}"
                " twin, graphed window ", top=3)
        busy[k].append(prof['busy_ms'] / 10)
        kernels[k].append(prof['launches_per_unit'])
    for k in ('per_call', 'table'):
        row['jet_against_per_call'][f'{k}_busy_ms_per_epoch'] = busy[k]
        row['jet_against_per_call'][f'{k}_kernels_per_epoch'] = kernels[k]
    print(f"graph-table: device busy ms per replayed epoch, turns per-call / "
          f"gathered / gathered / per-call: {busy['per_call'][0]:.4f} / "
          f"{busy['table'][0]:.4f} / {busy['table'][1]:.4f} / "
          f"{busy['per_call'][1]:.4f} | kernels per epoch "
          f"{kernels['per_call'][0]} / {kernels['table'][0]} / "
          f"{kernels['table'][1]} / {kernels['per_call'][1]}", flush=True)
    row.update(against_poly_turns(
        torch, "graph-table", twins['table'],
        twin_maker(CHECKPOINT.parent, {}, GRAPH_WINDOW)))
    return launches, row


# the trainer menu under 'table' (graph-table-menu): each recipe resumed
# from the committed run its 'poly_pallas' twin loads, (label, run, config,
# window); the reference design under its three Laplacian forms
TABLE_MENU = (
    ('reference-256', CHECKPOINT.parent,
     dict(estimator='reference', laplacian_mode='dense'), TWIN_WINDOW),
    ('reference-256 hvp', CHECKPOINT.parent,
     dict(estimator='reference', laplacian_mode='hvp'), TWIN_WINDOW),
    ('reference-256 fwd_batched', CHECKPOINT.parent,
     dict(estimator='reference'), TWIN_WINDOW),
    ('sr-256', SR_RUN, SR_CONFIG, SR_GRAPH_WINDOW),
    ('spring-256', SPRING_RUN, SPRING_CONFIG, TWIN_WINDOW),
    ('metropolis-256', METROPOLIS_RUN, dict(sampler='metropolis'),
     TWIN_WINDOW),
    ('mala-256', MALA_RUN, dict(sampler='mala'), TWIN_WINDOW))


def is_step_g_x(args, kw) -> bool:
    """Whether a call of ``spline_eval_bwd`` (its arguments) asks for g_x
    from a table read in step mode: the grad of a plain lerp."""
    need_x = args[6] if len(args) > 6 else kw.get('need_x', True)
    step_d1 = args[8] if len(args) > 8 else kw.get('step_d1', False)
    return args[1] is not None and bool(need_x) and bool(step_d1)


class evaluation_forms(evaluations):
    """``evaluations`` that also counts two forms apart, in ``forms``: the
    backward-kernel calls whose g_x reads a slope table in step mode
    ('bwd step g_x': the grad of a plain lerp), and every evaluation made
    inside the vjp rules of a backward or a basis evaluation ('grad of
    grad', by entry point: the per-term launches of the grad-of-grad
    rules).  ``record``: every call kept in ``calls_made`` as (entry
    point, its arguments, its keywords, made inside a grad-of-grad rule),
    for replaying it."""

    def __init__(self, plain: bool, record: bool = False):
        super().__init__(plain)
        self.forms = {'bwd step g_x': 0,
                      'grad of grad': dict.fromkeys(self.calls, 0)}
        self.record = record
        self.calls_made = []

    def __enter__(self):
        from waveflow_tpu_torch.ops import spline_eval as se
        super().__enter__()
        self.depth = 0
        self.saved_forms = ((se._BWD, se._BWD.__dict__['vjp']),
                            (se._BASIS, se._BASIS.__dict__['vjp']))
        for name in self.calls:
            def call(*args, _fn=getattr(se, name), _name=name, **kw):
                if self.depth:
                    self.forms['grad of grad'][_name] += 1
                if _name == 'spline_eval_bwd' and is_step_g_x(args, kw):
                    self.forms['bwd step g_x'] += 1
                if self.record:
                    self.calls_made.append((_name, args, kw,
                                            self.depth > 0))
                return _fn(*args, **kw)
            setattr(se, name, call)

        def nested(rule):
            def vjp(*args):
                self.depth += 1
                try:
                    return rule(*args)
                finally:
                    self.depth -= 1
            return staticmethod(vjp)
        for cls, rule in self.saved_forms:
            cls.vjp = nested(rule.__func__)
        return self

    def __exit__(self, *exc):
        for cls, rule in self.saved_forms:
            cls.vjp = rule
        super().__exit__(*exc)


def replay_against_plain(torch, name, args, kw):
    """One recorded K4 call (``evaluation_forms``) launched again on its
    own operands by the kernel and by its plain version: (the kernel's
    call, the plain call, the largest error of its outputs against the
    plain ones over the rows' sum of term magnitudes, N, its bound (ms,
    by))."""
    import types
    from waveflow_tpu_torch.ops import cuda_spline as cs
    if name == 'spline_eval':
        table, coeffs, x, step = (list(args) + [kw.get('step', False)])[:4]
        n_b = table.shape[-1]

        def kernel():
            return cs.spline_eval_cuda(table, coeffs, x, step)

        def plain():
            return cs.spline_eval_plain(table, coeffs, x, step)
        err = nan_rel_err(kernel(), plain(),
                          magnitude(torch, table, coeffs, x, step))
        # coefficients and x read once, the output written once, the rows
        # x reads; per base a fused multiply-add for the lerp (none in step
        # mode) and one for the dot
        bound = bound_ms(4 * (x.numel() * (n_b + 2) + table_rows(
            torch, table.shape[0], x, step) * n_b),
            x.numel() * ((2 if step else 4) * n_b + 3))
    elif name == 'spline_eval_bwd':
        names = ('table_d', 'table_d1', 'coeffs', 'x', 'grad', 'need_coeffs',
                 'need_x', 'step_d', 'step_d1')
        defaults = dict(need_coeffs=True, need_x=True, step_d=False,
                        step_d1=False)
        a = dict(defaults, **dict(zip(names, args)), **kw)
        td, tx, c, x, g = (a[k] for k in names[:5])
        n_b = td.shape[-1]

        def kernel():
            return cs.spline_eval_bwd_cuda(td, tx, c, x, g, a['need_coeffs'],
                                           a['need_x'], a['step_d'],
                                           a['step_d1'])

        def plain():
            return cs.spline_eval_bwd_plain(td, tx, c, x, g, a['step_d'],
                                            a['step_d1'])
        got, ref = kernel(), plain()
        err = 0.0
        if a['need_coeffs']:
            err = max(err, nan_rel_err(got[0], ref[0], ref[0]))
        g_x = a['need_x'] and tx is not None and c is not None
        if g_x:
            err = max(err, nan_rel_err(got[1], ref[1], g * magnitude(
                torch, tx, c, x, a['step_d1'])))
        # x and g read, the coefficients where g_x is asked for, g_c and
        # g_x written, the rows of each table x reads; per base a fused
        # multiply-add for each lerp, a multiply for g·B, a fused
        # multiply-add for g_x's dot (the backward kernel's rows of
        # table-kernels)
        N = x.numel()
        rows = table_rows(torch, td.shape[0], x, a['step_d']) + (
            table_rows(torch, tx.shape[0], x, a['step_d1']) if g_x else 0)
        n_ops = N * (n_b * ((0 if a['step_d'] else 2) + 1 + (
            (0 if a['step_d1'] else 2) + 2 if g_x else 0)) + 7)
        bound = bound_ms(4 * (N * (2 + n_b * bool(a['need_coeffs'])
                                   + (n_b + 1) * g_x) + rows * n_b), n_ops)
    else:
        tables, slopes, records, comps, x, vecs, c_groups, x_terms = args
        n_b = tables.shape[-1]

        def kernel():
            return cs.spline_eval_bwd_jet_cuda(records, comps, x, vecs,
                                               c_groups, x_terms, n_b)

        def plain():
            return cs.spline_eval_bwd_jet_plain(tables, slopes, comps, x,
                                                vecs, c_groups, x_terms)
        scale = cs.spline_eval_bwd_jet_plain(
            tables.abs(), slopes.abs(), [c.abs() for c in comps], x,
            [v.abs() for v in vecs], c_groups, x_terms)
        err = max(nan_rel_err(o, r, s) for o, r, s in
                  zip(kernel(), plain(), scale) if r is not None)
        bound = bwd_jet_bound(
            torch, types.SimpleNamespace(n_bases=n_b, n_mesh=tables.shape[1]),
            x.numel(), x, c_groups, x_terms, len(vecs), len(comps))
    return kernel, plain, err, x.numel(), bound


# the K4 calls of the menu's paths that menu_kernel_rows replays, by form
# (the forward and the backward kernel inside the grad-of-grad rules; the
# backward kernel with g_x from a slope table in step mode, its table_d1;
# the backward jet entry and the backward kernel under SPRING's vmap
# fold): (path, test on (entry point, arguments, keywords, made inside a
# grad-of-grad rule))
MENU_FORMS = {
    'grad-of-grad forward': (
        'reference-grad dense',
        lambda n, a, k, gog: gog and n == 'spline_eval'),
    'grad-of-grad backward': (
        'reference-grad dense',
        lambda n, a, k, gog: gog and n == 'spline_eval_bwd'),
    'step g_x backward': (
        'reference-grad dense',
        lambda n, a, k, gog: n == 'spline_eval_bwd' and is_step_g_x(a, k)),
    'vmap-fold backward jet': (
        'spring score', lambda n, a, k, gog: n == 'spline_eval_bwd_jet'),
    'vmap-fold backward': (
        'spring score', lambda n, a, k, gog: n == 'spline_eval_bwd'),
}


def menu_kernel_rows(torch, params):
    """K4's launches on the trainer menu's paths that table-kernels' grid
    does not make, recorded where the paths make them on the card and
    replayed against their plain versions: the 'reference' loss's
    gradient under 'dense' (the reference design's; per-term launches of
    the grad-of-grad rules, and the backward kernel's g_x from a slope
    table in step mode) and SPRING's score matrix O = vmap(grad(log|ψ|))
    (the vmap fold's backward launches, the walkers folded into the rows),
    each at 256 walkers drawn by K1 from the 100k checkpoint under
    'table'.  Each path whole, kernels against the plain chain on the
    card, within REF_GRAD_RTOL of its global norm, its K4 launches equal
    to the evaluations the same call makes on the CPU (8 walkers), no
    plain lerp on the card; every recorded launch of each form (MENU_FORMS)
    against its plain version on its own operands (scale: the rows' sum of
    term magnitudes, as table-kernels); the largest launch of each form
    timed (b2b, device, plain) beside its bound.  -> (worst error by form,
    rows)."""
    from waveflow_tpu_torch.models import get_waveflow_model
    from waveflow_tpu_torch.vmc import make_loss_fn
    from waveflow_tpu_torch.vmc.sr import make_score_fn

    def paths(model, x):
        h = he_hamiltonian(model, 'dense')
        loss_fn = make_loss_fn(model.psi, h, estimator='reference')
        base = torch.full((), -1.8, device=x.device)
        ps = list(model.parameters())
        flatten, scores = make_score_fn(model)
        flat = flatten()

        def ref_grad():
            with torch.autograd.set_multithreading_enabled(False):
                g = torch.autograd.grad(loss_fn(x, base), ps,
                                        allow_unused=True)
            return torch.cat([(torch.zeros_like(p) if a is None else a)
                              .reshape(-1) for p, a in zip(ps, g)])
        return {'reference-grad dense': ref_grad,
                'spring score': lambda: scores(flat, x)}

    mt = flagship_model(torch, params, 'table')
    x = torch.sort(mt.sample(256, generator=torch.Generator(
        'cuda').manual_seed(13)), dim=-1).values
    cpu = get_waveflow_model(
        2, base_spline_degree=FLAGSHIP['spline_degree'],
        i_spline_degree=FLAGSHIP['spline_degree'],
        n_prior_internal_knots=FLAGSHIP['num_knots'],
        n_i_internal_knots=FLAGSHIP['num_knots'], i_spline_reg=0.05,
        n_flow_layers=3, box_size=10.0, eval_backend='table',
        generator=torch.Generator().manual_seed(0), device='cpu')
    cpu.load_state_dict(params)
    on_cpu = paths(cpu, x[:8].cpu())
    recorded, rows = {}, {}
    for name, fn in paths(mt, x).items():
        with evaluation_forms(plain=False) as derived:
            on_cpu[name]()
        reset_table_counts()
        with evaluation_forms(plain=False, record=True) as run:
            got = fn()
        torch.cuda.synchronize()
        launched = table_counts()
        with evaluations(plain=True):
            ref = fn()
        rel = ((got - ref).norm() / ref.norm()).item()
        recorded[name] = run.calls_made
        rows[name] = dict(rel_err=rel, launches=launched,
                          derived=derived.calls, forms=derived.forms)
        print(f"table-kernels {name} (256 walkers, 'table'): kernels "
              f"against the plain chain on the card {rel:.3e} of the "
              f"global norm (limit {REF_GRAD_RTOL:g}) | K4 launches "
              f"{ {k: launched[k] for k in derived.calls} } (the code's "
              f"evaluations on the CPU {derived.calls}; the backward "
              f"kernel's g_x from a slope table "
              f"{derived.forms['bwd step g_x']}, inside the grad-of-grad "
              f"rules {derived.forms['grad of grad']}) | plain lerps on "
              f"the card {run.plain_calls}", flush=True)
        if not (torch.isfinite(got).all() and rel <= REF_GRAD_RTOL):
            fail(f"table-kernels {name}: kernels against the plain chain "
                 f"{rel:.3e}")
        if run.plain_calls or run.calls != derived.calls or {
                k: launched[k] for k in derived.calls} != derived.calls:
            fail(f"table-kernels {name}: K4 launches {launched} against the "
                 f"{derived.calls} evaluations the code makes on the CPU "
                 f"({run.plain_calls} plain lerps on the card)")
    worst = {}
    for form, (path, test) in MENU_FORMS.items():
        calls = [(n, a, k) for n, a, k, gog in recorded[path]
                 if test(n, a, k, gog)]
        if not calls:
            fail(f"table-kernels: {path} made no launch of the form {form}")
        replays = [replay_against_plain(torch, *c) for c in calls]
        worst[form] = max(r[2] for r in replays)
        kernel, plain, _, N, (b_ms, b_by) = max(replays, key=lambda r: r[3])
        rows[form] = row = dict(
            launches=len(calls), max_abs_err=worst[form], N=N,
            ms=cuda_ms(torch, kernel), device_ms=device_ms(torch, kernel),
            plain_ms=cuda_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
            rows=sorted({r[3] for r in replays}))
        print(f"K4 {form}: {len(calls)} launches in one {path} (rows "
              f"{row['rows']}), each against its plain version on its own "
              f"operands: max {worst[form]:.3e} (limit 2e-5) | at N={N}: "
              f"kernel_ms {row['ms']:.4f} device_ms {row['device_ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} bound_ms {b_ms:.5f} ({b_by})",
              flush=True)
    return worst, rows


def menu_epoch_evaluations(torch, params, config):
    """K4's launches in one epoch of a recipe under 'table' as the code
    makes them on the CPU (8 walkers, the flagship model with the 100k
    checkpoint's parameters: the count depends on neither), in a window of
    one epoch after a first one (the MCMC warm start), by entry point and
    by ``evaluation_forms``' forms.  A launch made once per window would
    show here and not per replayed epoch, and the card's gate would part."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    t = VMCTrainer(VMCConfig(batch_size=8, window=1, log_every=1,
                             eval_backend='table', device='cpu', **config))
    t.model.load_state_dict(params)
    t.train(1, verbose=False)
    with evaluation_forms(plain=False) as run:
        t.train(1, verbose=False)
    return dict(calls={k: float(v) for k, v in run.calls.items()},
                bwd_step_g_x=float(run.forms['bwd step g_x']),
                grad_of_grad={k: float(v) for k, v in
                              run.forms['grad of grad'].items()})


def menu_el_gate(torch, label, run_dir, config):
    """E_L = Hψ/ψ under 'table' against 'poly_pallas' (each trainer's own
    Laplacian form, ``el_against_poly``) on the walkers the recipe's run
    starts from: the committed run's MCMC walkers, or the first ancestral
    draw on the trainer's stream, sorted."""
    ts = {b: twin_maker(run_dir, config, 1, b)(False)
          for b in ('table', 'poly_pallas')}
    t = ts['table']
    with torch.no_grad():
        x = (t.mcmc_state.positions if t.mcmc_state is not None
             else t.sample(256))
        x = torch.sort(x, dim=-1).values
        e, psi = {}, {}
        for b, tb in ts.items():
            psi[b] = tb.model.psi(x)
            e[b] = tb.h_fn(x)[:, 0] / psi[b]
    return el_against_poly(f"graph-table-menu {label} (the run's starting "
                           "walkers)", e['table'], e['poly_pallas'],
                           psi['poly_pallas'])


def against_poly_turns(torch, label, graphed, make_poly):
    """ms per replayed epoch of a graphed 'table' trainer against its
    'poly_pallas' twin ``make_poly(None)`` (graphed, warmed up and captured
    first), turns of 2 windows in the order table, poly, poly, table (CUDA
    events)."""
    poly = make_poly(None)
    n = 2 * graphed.config.window
    poly.train(n, verbose=False)
    ms = {'table': [], 'poly_pallas': []}
    for k, t in (('table', graphed), ('poly_pallas', poly),
                 ('poly_pallas', poly), ('table', graphed)):
        _, dt = events_ms(torch, lambda: t.train(n, verbose=False))
        ms[k].append(dt / n)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"{label}: ms per replayed epoch, turns table / "
          f"poly_pallas / poly_pallas / table: {ms['table'][0]:.3f} / "
          f"{ms['poly_pallas'][0]:.3f} / {ms['poly_pallas'][1]:.3f} / "
          f"{ms['table'][1]:.3f} | table over poly_pallas "
          f"{mean['table'] / mean['poly_pallas']:.3f}x", flush=True)
    return dict(turns_ms_against_poly=ms,
                ms_per_replayed_epoch_table=mean['table'],
                ms_per_replayed_epoch_poly_pallas=mean['poly_pallas'])


def graph_table_menu_phase(torch, params):
    """The trainer menu under 'table' on the card (TABLE_MENU: the
    reference design under 'dense', 'hvp' and 'fwd_batched', SR, SPRING,
    Metropolis and MALA, each from its committed run), each through
    ``VMCTrainer`` with graphed windows against its eager twin
    (``graph_twins``): equal to the bit (losses, parameters, optimizer
    state, walkers, SPRING's counters); K3 not launched; K4's launches per
    replayed epoch, by entry point, equal to the count the code makes on
    the CPU for the same recipe (``menu_epoch_evaluations``; its forms —
    the backward kernel's g_x from a slope table, the grad-of-grad rules'
    per-term launches — printed beside it); K1 launched by the ancestral
    recipes; E_L against 'poly_pallas' on the run's starting walkers
    (``menu_el_gate``); then ms per replayed epoch against the
    'poly_pallas' twin in turns."""
    rows, total = {}, {}
    for label, run_dir, config, window in TABLE_MENU:
        derived = menu_epoch_evaluations(torch, params, config)
        el = menu_el_gate(torch, label, run_dir, config)
        ancestral = config.get('sampler', 'ancestral') == 'ancestral'
        required = (('sampler',) if ancestral else ()) + tuple(
            k for k, v in derived['calls'].items() if v)
        launches, row = graph_twins(
            torch, f"graph-table-menu {label}",
            twin_maker(run_dir, config, window, 'table'), read=table_counts,
            reset=reset_table_counts, required=required,
            turn_windows=2 if config.get('estimator') == 'reference' else 1,
            after=lambda eager, graphed, label=label, run_dir=run_dir,
            config=config, window=window: against_poly_turns(
                torch, f"graph-table-menu {label}", graphed,
                twin_maker(run_dir, config, window)))
        per_epoch = row['launches_per_epoch']['graph']
        row.update(el_table_vs_poly=el, derived_per_epoch=derived)
        print(f"graph-table-menu {label}: K4 launches per replayed epoch "
              f"{ {k: per_epoch[k] for k in derived['calls']} } | the code's "
              f"evaluations per epoch on the CPU {derived['calls']} (of "
              f"which the backward kernel's g_x from a slope table "
              f"{derived['bwd_step_g_x']:g}, the grad-of-grad rules' "
              f"per-term launches {derived['grad_of_grad']}) | K1 "
              f"{per_epoch['sampler']:g}, K3 {per_epoch['basis_jet']:g} per "
              "replayed epoch", flush=True)
        if not row['bitwise']:
            fail(f"graph-table-menu {label}: the graph is not equal to its "
                 f"eager twin to the bit: {row['rel_diff_by_group']}")
        if launches['basis_jet']:
            fail(f"graph-table-menu {label}: K3 launched "
                 f"{launches['basis_jet']} times under 'table'")
        if {k: per_epoch[k] for k in derived['calls']} != derived['calls']:
            fail(f"graph-table-menu {label}: K4 launches per replayed epoch "
                 f"{per_epoch} against the {derived['calls']} evaluations "
                 "the code makes")
        rows[label] = row
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total, rows


def circles_split():
    """benchmarks/circles_parity.py's split: 1,000 train, 2,000 held out."""
    from waveflow_tpu_torch.benchmark import get_dataset
    X = get_dataset('circles', 3000, margin=0.025, seed=42)
    return X[:1000], X[1000:]


def density_cut_phase(torch, label, X, X_test, n_epochs, model_name, **kw):
    """A density model trained by MLE on 1,000 points, ``n_epochs`` epochs
    with a metric checkpoint at the end (20,000 draws): losses finite and
    falling, the metrics finite, the round trip under 1e-4; K2 and K4
    launches; points/s over a further block of 100 replayed epochs."""
    from waveflow_tpu_torch.benchmark import train_density_model
    from waveflow_tpu_torch.benchmark.density import (
        density_epochs, density_optimizer)
    reset_table_counts()
    from waveflow_tpu_torch.ops import cuda_sampler
    cuda_sampler.launches_linear = 0
    t0 = time.perf_counter()
    model, hist = train_density_model(
        X, model_name=model_name, num_epochs=n_epochs, learning_rate=1e-4,
        n_flow_layers=3, log_every=n_epochs, n_model_sample=20000, seed=5,
        X_test=X_test, verbose=False, device='cuda', **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = table_counts()
    launches['sampler_linear'] = cuda_sampler.launches_linear
    losses = hist['losses']
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    epochs = density_epochs(model, density_optimizer(model, 1e-4),
                            torch.as_tensor(X, dtype=torch.float32,
                                            device='cuda'),
                            torch.Generator('cuda').manual_seed(9))
    epochs.window(1)        # the warm-up epoch and the capture
    ms_epoch = host_ms(torch, lambda: epochs.window(100), n=1) / 100
    row = dict(first10=first, last10=last, test_ll=hist['test_ll'][-1],
               kl=hist['kl'][-1], hellinger=hist['hellinger'][-1],
               reconstruction=hist['reconstruction'][-1], wall_s=wall,
               points_per_s=len(X) / ms_epoch * 1e3, launches=launches)
    print(f"{label}: {model_name}, {n_epochs} epochs at batch {len(X)}: "
          f"first-10 mean loss {first:.5f} -> last-10 {last:.5f} | held-out "
          f"LL {row['test_ll']:.4f} KL {row['kl']:.4f} H2 "
          f"{row['hellinger']:.4f} recon {row['reconstruction']:.3e} | "
          f"{wall:.2f} s | points/s {row['points_per_s']:.1f} ({ms_epoch:.3f}"
          f" ms per epoch, a further block of 100 replayed) | launches "
          f"{launches}", flush=True)
    if not (all(math.isfinite(v) for v in losses) and last < first):
        fail(f"{label}: the loss did not fall ({first} -> {last})")
    if not all(math.isfinite(row[k]) for k in ('test_ll', 'kl', 'hellinger')):
        fail(f"{label}: non-finite metrics {row}")
    if not row['reconstruction'] < 1e-4:
        fail(f"{label}: reconstruction {row['reconstruction']:.3e} >= 1e-4")
    return launches, row


def rqs_density_phase(torch):
    """RQSFlow on the circles split (benchmarks/rqs_row.py's model, seed
    5), cut from 12,000 to 300 epochs: plain PyTorch, no kernel."""
    X, X_test = circles_split()
    return None, density_cut_phase(torch, 'rqs-density', X, X_test, 300,
                                   'RQSFlow')[1]


def gm_density_phase(torch):
    """MFlow on gaussian_mixtures (reg 0.05, degree 5, 15 knots, as
    results/dataset_generality.json records), the same split, cut from
    12,000 to 200 epochs: K2 at the checkpoint, K4 every epoch."""
    from waveflow_tpu_torch.benchmark import get_dataset
    Z = get_dataset('gaussian_mixtures', 3000, margin=0.025, seed=42)
    launches, row = density_cut_phase(
        torch, 'gm-density', Z[:1000], Z[1000:], 200, 'MFlow',
        spline_reg=0.05, spline_degree=5, n_knots=15)
    if not (launches['sampler_linear'] and launches['spline_eval']
            and launches['spline_eval_bwd']):
        fail(f"gm-density: K2 or K4 was not launched: {launches}")
    return launches, row


# ---- 44-45. the reference-API layer and the evaluation artifacts ---------

KERNEL_NAMES = ('basis_jet', 'sampler', 'sampler_linear', 'spline_eval',
                'spline_eval_bwd', 'spline_eval_pair', 'spline_eval_jet',
                'spline_eval_bwd_jet')


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel (ops.LAUNCH_COUNTERS
    order)."""
    from waveflow_tpu_torch import ops
    return dict(zip(KERNEL_NAMES, ops.read_launches()))


def zero_counts():
    from waveflow_tpu_torch import ops
    ops.set_launches((0,) * len(KERNEL_NAMES))


class counted_calls:
    """Within the block, every call of each named function (``name=(module,
    attribute)``) is counted in ``calls``, whatever the device: run on the
    CPU, the launches the same code makes on the card."""

    def __init__(self, **targets):
        self.targets = targets
        self.calls = dict.fromkeys(targets, 0)

    def __enter__(self):
        self.saved = {n: getattr(m, a) for n, (m, a) in self.targets.items()}
        for n, (m, a) in self.targets.items():
            def call(*args, n=n, fn=self.saved[n], **kw):
                self.calls[n] += 1
                return fn(*args, **kw)
            setattr(m, a, call)
        return self

    def __exit__(self, *exc):
        for n, (m, a) in self.targets.items():
            setattr(m, a, self.saved[n])


def compat_targets():
    """The launch points of compat.py's kernels: K4's entries (by the
    names ops/spline_eval.py calls them) and the two samplers compat
    calls."""
    from waveflow_tpu_torch import compat
    from waveflow_tpu_torch.ops import spline_eval as se
    return dict(spline_eval=(se, 'spline_eval'),
                spline_eval_pair=(se, 'spline_eval_pair'),
                spline_eval_jet=(se, 'spline_eval_jet'),
                spline_eval_bwd=(se, 'spline_eval_bwd'),
                sampler=(compat, 'sample_squared_amplitude'),
                sampler_linear=(compat, 'sample_linear_density'))


def launches_of_call(torch, fn):
    """(fn(), the kernel launches it made on the card)."""
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernel_counts().items() if v}


def predicted_launches(fn, targets):
    """The launches ``fn`` (on CPU tensors) predicts for the card."""
    with counted_calls(**targets) as run:
        fn()
    return {k: v for k, v in run.calls.items() if v}


def compat_spline_phase(torch, gen):
    """The reference's spline factories at the widths the paths give them,
    built on the card and on the CPU with the same parameters: each entry
    against the same call on the CPU (its plain version), its launches
    held to the CPU's prediction, its time per call against the direct
    ops call (CUDA events)."""
    from waveflow_tpu_torch import compat, ops
    rows, total = {}, dict.fromkeys(KERNEL_NAMES, 0)

    def params_of(tup, B, kind):
        """B rows around ``initial``, de-biased (M, I) and projected, on
        the card and as a CPU copy."""
        init = tup[0]
        p = init + 0.3 * init.abs().mean() * torch.randn(
            (B, init.shape[0]), generator=gen, device='cuda')
        if kind != 'B':
            p = tup[6](p.abs())
        p = tup[5](p)
        return p, p.cpu()

    def entry(label, card_fn, cpu_fn, direct_fn, atol_of, targets):
        got, launched = launches_of_call(torch, card_fn)
        predicted = predicted_launches(cpu_fn, targets)
        ref = cpu_fn()
        err, tol = atol_of(got.cpu(), ref)
        w_ms = cuda_ms(torch, card_fn, reps=20)
        d_ms = cuda_ms(torch, direct_fn, reps=20)
        print(f"compat {label}: max|d| {err:.3e} against the CPU (limit "
              f"{tol:.1e}) | launches {launched} (CPU predicts {predicted}) "
              f"| wrapper {w_ms:.4f} ms per call, direct ops call "
              f"{d_ms:.4f} ms (CUDA events)", flush=True)
        if not err <= tol:
            fail(f"compat {label}: the card disagrees with the CPU: "
                 f"{err:.3e} > {tol:.1e}")
        if launched != predicted:
            fail(f"compat {label}: launches {launched} on the card, "
                 f"{predicted} predicted by the CPU")
        for k, v in launched.items():
            total[k] += v
        rows[label] = dict(max_abs_err=err, launches=launched,
                           wrapper_ms=w_ms, direct_ms=d_ms)
        return got

    def k4_tol(got, ref):
        return ((got - ref).abs().max().item(),
                2e-5 * max(1.0, ref.abs().max().item()))

    def draws_tol(kind, table_t, cc, u):
        """Draws held as check_sampler holds them: 6e-5 where u <= 1 -
        1e-4; beyond, in probability against the float64 quantile, no
        farther than the f32 plain draws plus 2 ulps of u."""
        def tol(got, ref):
            got, ref = got.reshape(-1), ref.reshape(-1)
            t = u.cpu() > 1.0 - 1e-4
            err = (got - ref).abs()[~t].max().item()
            if t.any():
                ct, ut = cc[t.cuda()], u[t.cuda()]
                qk = quantile_err(torch, table_t, ct, ut, got[t].cuda(), kind)
                qp = quantile_err(torch, table_t, ct, ut, ref[t].cuda(), kind)
                if not qk.max().item() <= qp.max().item() + 2.0 ** -23:
                    fail(f"compat sample ({kind}): tail draws {qk.max():.3e} "
                         f"from the quantile, plain {qp.max():.3e}")
            return err, 6e-5
        return tol

    targets = compat_targets()
    # B-splines: the flagship prior's width (degree 6, 23 knots, 2000 mesh)
    kw = dict(k=6, n_internal_knots=23, n_mesh_points=2000)
    bt = compat.BSpline_fun()(0, **kw)
    bt_cpu = compat.BSpline_fun()(0, **kw, device='cpu')
    ev_ob = ops.make_evaluator(ops.get_tables('B', 6, 23, n_mesh=2000),
                               use_ob=True, device='cuda')
    ob_to_b = torch.as_tensor(ops.get_tables('B', 6, 23, n_mesh=2000).ob_to_b,
                              device='cuda')
    B = 65536
    p, p_cpu = params_of(bt, B, 'B')
    x = torch.rand((B,), generator=gen, device='cuda')
    c = p @ ob_to_b
    c = c / torch.sqrt((c ** 2).sum(-1, keepdim=True))
    entry('BSpline apply_fun_vec N=65536', lambda: bt[1](p, x),
          lambda: bt_cpu[1](p_cpu, x.cpu()), lambda: ev_ob(c, x), k4_tol,
          targets)
    Bs, S = 32768, 2
    p, p_cpu = p[:Bs].contiguous(), p_cpu[:Bs].contiguous()
    u = torch.rand((Bs, S), generator=gen, device='cuda')
    cc = torch.repeat_interleave(c[:Bs], S, dim=0)
    entry('BSpline sample_fun_vec 32768 x 2',
          lambda: bt[3]._from_uniforms(p, u),
          lambda: bt_cpu[3]._from_uniforms(p_cpu, u.cpu()),
          lambda: ops.sample_squared_amplitude(ev_ob, cc, u.reshape(-1)),
          draws_tol('squared', ev_ob.table_t, cc, u.reshape(-1)), targets)
    own = bt[3](torch.Generator('cuda').manual_seed(3), p, S)
    if own.shape != (Bs, S) or not (own.min() >= 0 and own.max() <= 1):
        fail(f"compat BSpline sample_fun_vec: shape {tuple(own.shape)}")
    # I-splines: the IMADE layers' width at the density path's 40,000 rows
    kw = dict(k=5, n_internal_knots=23, n_mesh_points=2000)
    it = compat.ISpline_fun()(0, **kw)
    it_cpu = compat.ISpline_fun()(0, **kw, device='cpu')
    ev_i = ops.make_evaluator(ops.get_tables('I', 5, 23, n_mesh=2000),
                              device='cuda')
    N = 40000
    p, p_cpu = params_of(it, N, 'I')
    x = torch.rand((N,), generator=gen, device='cuda')
    y = entry('ISpline apply_fun_vec N=40000', lambda: it[1](p, x),
              lambda: it_cpu[1](p_cpu, x.cpu()), lambda: ev_i(p, x), k4_tol,
              targets)
    entry('ISpline apply_fun_vec_grad N=40000', lambda: it[2](p, x),
          lambda: it_cpu[2](p_cpu, x.cpu()), lambda: ev_i(p, x, d=1), k4_tol,
          targets)
    entry('ISpline reverse_fun_vec N=40000', lambda: it[3](p, y),
          lambda: it_cpu[3](p_cpu, y.cpu()),
          lambda: ops.batched_monotone_inverse(ev_i, p, y),
          lambda got, ref: ((got - ref).abs().max().item(), 1e-5), targets)
    # M-splines: the MFlow prior's width, 20,000 rows x 2 draws
    kw = dict(k=3, n_internal_knots=15, n_mesh_points=2000)
    mt = compat.MSpline_fun()(0, **kw)
    mt_cpu = compat.MSpline_fun()(0, **kw, device='cpu')
    ev_m = ops.make_evaluator(ops.get_tables('M', 3, 15, n_mesh=2000),
                              device='cuda')
    Bm = 20000
    p, p_cpu = params_of(mt, Bm, 'M')
    u = torch.rand((Bm, S), generator=gen, device='cuda')
    cc = torch.repeat_interleave(p, S, dim=0)
    entry('MSpline sample_fun_vec 20000 x 2',
          lambda: mt[3]._from_uniforms(p, u),
          lambda: mt_cpu[3]._from_uniforms(p_cpu, u.cpu()),
          lambda: ops.sample_linear_density(ev_m, cc, u.reshape(-1)),
          draws_tol('linear', ev_m.table_t, cc, u.reshape(-1)), targets)
    for label, kernel in (('BSpline sample_fun_vec 32768 x 2', 'sampler'),
                          ('MSpline sample_fun_vec 20000 x 2',
                           'sampler_linear')):
        if rows[label]['launches'] != {kernel: 1}:
            fail(f"compat {label}: {rows[label]['launches']}, not one "
                 f"{kernel} launch")
    return total, rows


def compat_train_phase(torch):
    """train_model on 20,000 'circles' points (MFlow, the density path's
    widths, 200 epochs, check_step 100) against train_density_model with
    the same arguments and seed: losses, parameters and every metric file
    equal to the bit, and the same K4 and K2 launches."""
    from waveflow_tpu_torch import compat
    from waveflow_tpu_torch.benchmark import get_dataset, train_density_model
    X = get_dataset('circles', DENSITY_POINTS)
    kw = dict(spline_reg=DENSITY['spline_reg'], num_flow_layer=3,
              spline_degree=5, num_knots=23, prior_spline_degree=3,
              prior_num_knots=15)
    files = ('losses.txt', 'kl_divergences.txt', 'hellinger_divergences.txt',
             'reconstruction_distances.txt')
    with tempfile.TemporaryDirectory() as d:
        zero_counts()
        t0 = time.perf_counter()
        params, log_pdf, _ = compat.train_model(
            X, 200, DENSITY_POINTS, model_type='MFlow',
            dataset_name='circles', check_step=100, save_dir=d, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = kernel_counts()
        zero_counts()
        model, _ = train_density_model(
            X, model_name='MFlow', num_epochs=200,
            spline_reg=kw['spline_reg'], n_flow_layers=3, spline_degree=5,
            n_knots=23, log_every=100, save_dir=f'{d}/direct',
            n_model_sample=DENSITY_POINTS, prior_spline_degree=3,
            prior_n_knots=15, verbose=False, device='cuda')
        torch.cuda.synchronize()
        direct = kernel_counts()
        run = Path(d) / 'circles' / f"MFlow_{kw['spline_reg']}_3_5_23"
        same_files = {f: (run / f).read_bytes() == (Path(d) / 'direct' / f)
                      .read_bytes() for f in files}
        n_lines = len((run / 'losses.txt').read_text().split())
    state = model.state_dict()
    same_params = params.keys() == state.keys() and all(
        torch.equal(params[k], state[k]) for k in state)
    with torch.no_grad():
        lp = log_pdf(params, X[:4096])
        same_lp = torch.equal(lp, model.log_pdf(torch.as_tensor(
            X[:4096], device='cuda')))
    print(f"compat train_model: MFlow on {DENSITY_POINTS} circles points, 200 "
          f"epochs, check_step 100 ({wall:.2f} s): files {same_files} "
          f"({n_lines} losses), parameters "
          f"{'equal' if same_params else 'NOT equal'} to train_density_model's "
          f"to the bit, log_pdf through functional_call "
          f"{'equal' if same_lp else 'NOT equal'} | launches {launched} "
          f"(direct call {direct})", flush=True)
    if not (all(same_files.values()) and same_params and same_lp
            and n_lines == 200):
        fail("compat train_model differs from train_density_model")
    if launched != direct or not (launched['spline_eval']
                                  and launched['spline_eval_bwd']
                                  and launched['sampler_linear']):
        fail(f"compat train_model launches {launched}, direct {direct}")
    return launched, dict(wall_s=wall, launches=launched)


def compat_trainer_phase(torch):
    """ModelTrainer at the reference's defaults (He, L = 10, degree 6, 23
    knots, 3 layers, batch 128, window 100) for 200 epochs on the card:
    every loss finite, K1 launched; walkers/s."""
    from waveflow_tpu_torch import compat
    trainer = compat.ModelTrainer()
    trainer.num_epochs = 200
    zero_counts()
    t0 = time.perf_counter()
    losses = trainer.start_training()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in kernel_counts().items() if v}
    wps = 200 * trainer.batch_size / wall
    print(f"compat ModelTrainer: {len(losses)} epochs at batch "
          f"{trainer.batch_size} ({wall:.2f} s, the graph's capture "
          f"included): walkers/s {wps:.1f}, last loss {losses[-1]:.5f} | "
          f"launches {launched}", flush=True)
    if len(losses) != 200 or not all(math.isfinite(v) for v in losses):
        fail("compat ModelTrainer: non-finite or missing losses")
    if not launched.get('sampler'):
        fail(f"compat ModelTrainer: K1 not launched: {launched}")
    return launched, dict(wall_s=wall, walkers_per_s=wps)


def compat_phase(torch):
    """The reference's API on the card (waveflow_tpu_torch/compat.py): the
    spline factories, train_model and ModelTrainer."""
    gen = torch.Generator('cuda').manual_seed(13)
    total, rows = compat_spline_phase(torch, gen)
    for name, run in (('train_model', compat_train_phase),
                      ('ModelTrainer', compat_trainer_phase)):
        launched, rows[name] = run(torch)
        for k, v in launched.items():
            total[k] += v
    return {k: v for k, v in total.items() if v}, rows


def artifacts_phase(torch, k3_b2b_ms=None):
    """The evaluation artifacts from the 100k checkpoint on a 'poly_pallas'
    trainer: 2 graphed windows of 10 epochs with a save_checkpoint between,
    with save_artifacts and without, equal to the bit; every file at its
    shape; the ψ grid and both slices against the plain core's ψ on the
    card (ARTIFACTS_PSI_RTOL); K1 and K3 launches per
    save_wavefunction_artifacts call held to the CPU's prediction.  Then
    utils/profiling.py: trace around 10 replayed epochs names K1's and K3's
    kernels; time_fn of K3 at R = 512."""
    import numpy as np

    from waveflow_tpu_torch.models import waveflow as waveflow_mod
    from waveflow_tpu_torch.ops import cuda_jet
    from waveflow_tpu_torch.utils import profiling
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    from waveflow_tpu_torch.vmc.artifacts import (
        eval_psi_antisymmetrized, save_wavefunction_artifacts)

    def trainer(flag):
        t = VMCTrainer(VMCConfig(batch_size=256, window=10, log_every=10,
                                 eval_backend='poly_pallas', device='cuda',
                                 save_artifacts=flag))
        if not t.load_checkpoint(str(CHECKPOINT.parent)):
            fail(f"no checkpoint under {CHECKPOINT.parent}")
        return t

    out = {}
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for flag in (True, False):
            t = trainer(flag)
            zero_counts()
            t.train(10, verbose=False)
            if flag:
                at_save = {k: v.detach().cpu().clone()
                           for k, v in t.model.state_dict().items()}
            t.save_checkpoint(f'{d}/{flag}')
            t.train(10, verbose=False)
            torch.cuda.synchronize()
            runs[flag] = t
            if flag:
                launched = {k: v for k, v in kernel_counts().items() if v}
        bitwise, rel, by_group = compare_twins(
            torch, trainer_tensors(torch, runs[True]),
            trainer_tensors(torch, runs[False]))
        epoch = runs[True].epoch - 10
        base = Path(d) / 'True' / 'outputs'
        shapes = {
            f'wavefunctions_2d/values_epoch{epoch}.npy': (10000,),
            f'density_1e/random_values_epoch{epoch}.npy': (100,),
            f'density_1e/random_coord_epoch{epoch}.npy': (100, 2),
            f'density_1e/onproton_values_epoch{epoch}.npy': (100,),
            f'density_1e/onproton_coord_epoch{epoch}.npy': (100, 2),
            f'sample_points/values_epoch{epoch}.npy': (250, 2)}
        saved = {k: np.load(base / k) for k in shapes}
        absent = (Path(d) / 'False' / 'outputs').exists()
        print(f"artifacts: 2 graphed windows of 10 epochs from the 100k "
              f"checkpoint with a save_checkpoint between, save_artifacts "
              f"against without: {'equal to the bit' if bitwise else 'NOT bitwise'}"
              f" (largest relative difference {rel:.3e}) | files "
              f"{ {k: v.shape for k, v in saved.items()} } | launches of the "
              f"run with artifacts {launched}", flush=True)
        if not bitwise:
            fail(f"artifacts: the run with artifacts differs: {by_group}")
        if absent or any(saved[k].shape != s for k, s in shapes.items()):
            fail("artifacts: files missing or at the wrong shape")
        # ψ against the plain core on the card, the parameters the
        # artifacts were written with
        t = runs[True]
        plain = flagship_model(torch, at_save, 'poly')
        line = np.linspace(-10.0, 10.0, 100)
        X, Y = np.meshgrid(line, line)
        errs = {}
        zero_counts()
        with torch.no_grad():
            for key, coords in (
                    (f'wavefunctions_2d/values_epoch{epoch}.npy',
                     np.stack([X, Y], -1).reshape(-1, 2)),
                    (f'density_1e/random_values_epoch{epoch}.npy',
                     saved[f'density_1e/random_coord_epoch{epoch}.npy']),
                    (f'density_1e/onproton_values_epoch{epoch}.npy',
                     saved[f'density_1e/onproton_coord_epoch{epoch}.npy'])):
                ref = eval_psi_antisymmetrized(plain.psi, torch.as_tensor(
                    coords, dtype=torch.float32, device='cuda'))
                if not np.isfinite(saved[key]).all():
                    fail(f"artifacts: non-finite values in {key}")
                errs[key] = float(np.abs(saved[key] - ref).max()
                                  / np.abs(ref).max())
        plain_launches = kernel_counts()['basis_jet']
        print(f"artifacts: psi against the plain core on the card (K3 "
              f"launched {plain_launches} times by it), of max|psi|: {errs} "
              f"(limit {ARTIFACTS_PSI_RTOL:g})", flush=True)
        if plain_launches:
            fail("artifacts: the plain core launched K3")
        if not max(errs.values()) <= ARTIFACTS_PSI_RTOL:
            fail(f"artifacts: psi disagrees with the plain core: {errs}")
        # launches per save_wavefunction_artifacts call, and the CPU's count
        call_args = dict(epoch=0, box_length=10.0,
                         n_particle=int(t.n_particle), protons=t.protons)
        t0 = time.perf_counter()
        _, per_call = launches_of_call(torch, lambda: (
            save_wavefunction_artifacts(
                f'{d}/call', t.model, generator=torch.Generator(
                    'cuda').manual_seed(1), **call_args)))
        call_ms = (time.perf_counter() - t0) * 1e3
        cpu = flagship_model(torch, at_save, 'poly_pallas', device='cpu')
        predicted = predicted_launches(
            lambda: save_wavefunction_artifacts(
                f'{d}/cpu', cpu, generator=torch.Generator().manual_seed(1),
                **call_args),
            dict(basis_jet=(cuda_jet, 'basis_jet'),
                 sampler=(waveflow_mod, 'sample_squared_amplitude')))
        print(f"artifacts: one save_wavefunction_artifacts call launches "
              f"{per_call} (CPU predicts {predicted}), {call_ms:.1f} ms wall "
              f"(files written included)", flush=True)
        if per_call != predicted:
            fail(f"artifacts: launches {per_call}, predicted {predicted}")
    out.update(bitwise=bitwise, psi_rel_err=errs, call_launches=per_call,
               call_ms=call_ms)
    # a profiler trace around 10 replayed epochs
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as logdir:
            t.train_window(10, t.baseline)
            torch.cuda.synchronize()
        traces = list(Path(logdir).glob('*.pt.trace.json*'))
        text = traces[0].read_text() if len(traces) == 1 else ''
        named = {k: k in text for k in ('sampler_kernel', 'basis_jet_')}
        size = traces[0].stat().st_size if traces else 0
    print(f"artifacts: profiling.trace around 10 replayed epochs wrote "
          f"{len(traces)} trace file ({size} bytes); names the kernels "
          f"{named}", flush=True)
    if len(traces) != 1 or not all(named.values()):
        fail(f"artifacts: the trace {traces} does not name K1 and K3: {named}")
    # time_fn of K3 at R = 512, beside phase 3's back-to-back figure
    from waveflow_tpu_torch import ops
    pe = ops.make_poly_evaluator(ops.get_tables('I', 6, 23, n_mesh=2000),
                                 jet_backend='pallas', device='cuda')
    x = torch.rand((512,), generator=torch.Generator('cuda').manual_seed(4),
                   device='cuda')
    args = (x, pe.A_jet, pe.n_cells, pe.ncoef)
    tf_ms = profiling.time_fn(cuda_jet.basis_jet_cuda, *args, iters=50,
                              warmup=3) * 1e3
    b2b_ms = cuda_ms(torch, lambda: cuda_jet.basis_jet_cuda(*args))
    print(f"artifacts: profiling.time_fn of K3 at R = 512 (I-spline, 29 "
          f"bases): {tf_ms:.4f} ms per call; chip_smoke's back-to-back "
          f"figure here {b2b_ms:.4f} ms"
          + (f", phase 3's {k3_b2b_ms:.4f} ms" if k3_b2b_ms else ""),
          flush=True)
    out.update(trace_bytes=size, time_fn_ms=tf_ms, b2b_ms=b2b_ms)
    return launched, out


def near(value, ref, rel) -> bool:
    """|value − ref| within ``rel`` of |ref|."""
    return abs(value - ref) <= rel * abs(ref)


# the four committed JAX runs no earlier phase loads (round5_quality.json
# rows; benchmarks/round5_quality.py stage_box4: 1D, lr 3e-4, ancestral;
# the 2D antisym runs at their final lr 3e-5, Metropolis)
BE4_RUN = ROOT / 'results' / 'r5_be4_interacting'
BOX4_RUN = ROOT / 'results' / 'r5_box4_free'
LI2D_RUN = ROOT / 'results' / 'r5_li_2d_antisym'
H2_2D_RUN = ROOT / 'results' / 'r5_h2_2d2e_antisym'
ED40_H2 = ROOT / 'results' / 'ed40_H2_2d2e.npz'
BE4_CONFIG = dict(system_name='Be', box_length=10.0, learning_rate=3e-4)
BOX4_CONFIG = dict(system_name='box4', box_length=5.0, interactions=False,
                   learning_rate=3e-4)
LI2D_CONFIG = dict(BOX_2D, system_name='Li', ansatz='antisym',
                   sampler='metropolis')
H2_2D_CONFIG = dict(BOX_2D, system_name='H2', ansatz='antisym',
                    sampler='metropolis')


# the catalogue phase: every system of examples/catalogue_sweep_torch.py's
# SWEEP and SWEEP_2D from scratch (seed 2, batch 256, full width), its
# graphed window against its eager twin in turns of one window of this many
# epochs; then one system per electron count again under 'poly_pallas'
CATALOGUE_WINDOW = 10
CATALOGUE_POLY_PALLAS = ('H', 'He_off_center', 'box3')


@contextlib.contextmanager
def k1_k3_calls():
    """Within the block, every call of the K1 wrapper's entry
    (``sample_squared_amplitude`` as the model's sampler calls it) and of
    the K3 core (``cuda_jet.basis_jet``, the 'poly_pallas' jets) counted
    in the dict yielded, whatever the device: on the CPU the count of
    launches the same run makes on the card."""
    from waveflow_tpu_torch.models import waveflow as wf
    from waveflow_tpu_torch.ops import cuda_jet
    calls = {'sampler': 0, 'basis_jet': 0}
    real = (wf.sample_squared_amplitude, cuda_jet.basis_jet)

    def counting(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call
    wf.sample_squared_amplitude = counting('sampler', real[0])
    cuda_jet.basis_jet = counting('basis_jet', real[1])
    try:
        yield calls
    finally:
        wf.sample_squared_amplitude, cuda_jet.basis_jet = real


def catalogue_epoch_calls(config) -> dict:
    """K1 and K3 launches in one ancestral epoch of a sweep system as the
    code makes them on the CPU: a window of one epoch after a first one, 8
    walkers and narrow splines (degree 3, 6 knots, a 300-point mesh) with
    the flow's depth kept — the count depends on neither the batch nor
    the widths."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    t = VMCTrainer(VMCConfig(batch_size=8, window=1, log_every=1,
                             spline_degree=3, num_knots=6,
                             n_spline_base_mesh_points=300, device='cpu',
                             **config))
    t.train(1, verbose=False)
    with k1_k3_calls() as calls:
        t.train(1, verbose=False)
    return {k: float(v) for k, v in calls.items()}


def catalogue_maker(config):
    """``make(graph)`` of ``graph_twins``: a sweep system from scratch at
    batch 256 and full width, windows of CATALOGUE_WINDOW epochs."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    def make(graph):
        return VMCTrainer(VMCConfig(batch_size=256, window=CATALOGUE_WINDOW,
                                    log_every=CATALOGUE_WINDOW,
                                    device='cuda', **config), graph=graph)
    return make


def k3_at_path_shapes(torch, label, make):
    """K3 at the shapes a system's path gives it: the core calls of one
    eager epoch of ``make(False)`` recorded, then each distinct (sites,
    table) launched again, kernel against the plain core on the card
    (phase 3's tolerance, rtol 2e-5 and atol 2e-4), timed beside its plain
    version and its bound."""
    from waveflow_tpu_torch.ops import cuda_jet
    t = make(False)
    seen, real = {}, cuda_jet.basis_jet_cuda

    def record(x, A, nc, k):
        seen.setdefault((tuple(x.shape), tuple(A.shape)),
                        (x.detach().clone(), A, nc, k))
        return real(x, A, nc, k)
    cuda_jet.basis_jet_cuda = record
    try:
        t.train(1, verbose=False)
    finally:
        cuda_jet.basis_jet_cuda = real
    if not seen:
        fail(f"{label}: the path launched no K3")
    rows = {}
    for (x_shape, a_shape), (x, A, nc, k) in seen.items():
        out_k = cuda_jet.basis_jet_cuda(x, A, nc, k)
        out_p = cuda_jet.basis_jet_plain(x, A, nc, k)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        if not torch.allclose(out_k, out_p, rtol=2e-5, atol=2e-4):
            fail(f"{label}: K3 at x {x_shape}, table {a_shape} disagrees "
                 f"with the plain core: max {err:.3e}")
        R, N = x.numel(), A.shape[1]
        b_ms, b_by = bound_ms(4 * (R + A.numel() + R * N), 2 * R * N * k)
        rows[f"x {x_shape} table {a_shape}"] = row = dict(
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            ms=cuda_ms(torch, lambda: cuda_jet.basis_jet_cuda(x, A, nc, k)),
            plain_ms=cuda_ms(torch,
                             lambda: cuda_jet.basis_jet_plain(x, A, nc, k)))
        print(f"{label}: K3 at x {x_shape}, table {a_shape} (R = {R}): max|d| "
              f"{err:.3e} (rtol 2e-5, atol 2e-4) | kernel_ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} bound_ms {b_ms:.5f} ({b_by})",
              flush=True)
    return rows


def catalogue_phase(torch):
    """Every system of the catalogue sweep (examples/catalogue_sweep_torch.py:
    the 12 1D systems and the 3 2D one-electron systems) from scratch at
    full width through ``VMCTrainer``, its graphed window against its eager
    twin (``graph_twins``, turns eager, graph, graph, eager of one window of
    CATALOGUE_WINDOW epochs): losses, parameters, Adam state, baseline and
    generator equal to the bit, every loss finite, K1 launches per replayed
    epoch equal to the CPU's count (``catalogue_epoch_calls``: one per
    coordinate), K3 0 under the default 'poly'.  Then CATALOGUE_POLY_PALLAS
    (one 1D system per electron count) again under 'poly_pallas': K3 per
    replayed epoch equal to the CPU's count, and K3 at the shapes of that
    system's path held against the plain core (``k3_at_path_shapes``)."""
    sweep = example_module('catalogue_sweep_torch')
    runs = [(dims, name, L, extra, 'poly') for dims in (1, 2)
            for name, L, extra in sweep.sweep_of(dims)]
    runs += [(1, name, L, extra, 'poly_pallas')
             for name, L, extra in sweep.SWEEP
             if name in CATALOGUE_POLY_PALLAS]
    rows, total = {}, {}
    for dims, name, L, extra, backend in runs:
        label = f"catalogue {name} {dims}D {backend}"
        config = dict(system_name=name, n_space_dimension=dims,
                      box_length=L, seed=sweep.SEED, eval_backend=backend,
                      **extra)
        derived = catalogue_epoch_calls(config)
        make = catalogue_maker(config)
        launches, row = graph_twins(
            torch, label, make,
            required=tuple(k for k, v in derived.items() if v),
            turn_windows=1, profile=False)
        per_epoch = row['launches_per_epoch']['graph']
        print(f"{label}: launches per replayed epoch {per_epoch} | the "
              f"code's on the CPU {derived}", flush=True)
        if not row['bitwise']:
            fail(f"{label}: the graph is not equal to its eager twin to the "
                 f"bit: {row['rel_diff_by_group']}")
        if per_epoch != derived:
            fail(f"{label}: launches per replayed epoch {per_epoch} against "
                 f"the {derived} the code makes on the CPU")
        row['derived_per_epoch'] = derived
        if backend == 'poly_pallas':
            row['k3_at_path_shapes'] = k3_at_path_shapes(torch, label, make)
        rows[label] = row
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total, rows


# the quality phase: examples/round5_quality_torch.py's recipes at full
# width from scratch, each graphed window against its eager twin in turns
# of one window: the antisym decay and the Li refresh in windows of this
# many epochs, the ng batches in windows of NG_TWIN_WINDOW
QUALITY_WINDOW = 5
NG_TWIN_WINDOW = 2


def refresh_calls(config, n_windows: int, refresh_every=1) -> dict:
    """K1 and K3 launches of ``n_windows`` MCMC windows from scratch with a
    refresh every ``refresh_every`` windows (the warm start and each
    refresh; 'auto' as the config resolves it) as the code makes them on
    the CPU, at 8 walkers, narrow splines and windows of one epoch: the
    count depends on none of them."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    t = VMCTrainer(VMCConfig(**dict(config, batch_size=8, window=1,
                                    log_every=1,
                                    mcmc_refresh_every=refresh_every,
                                    spline_degree=3, num_knots=6,
                                    n_spline_base_mesh_points=300,
                                    device='cpu')))
    with k1_k3_calls() as calls:
        t.train(n_windows, verbose=False)
    return {k: float(v) for k, v in calls.items()}


def quality_twin(torch, label, make, derived, per_epoch=True):
    """``graph_twins`` of ``make`` in turns of one window, unprofiled, held
    to the bit and to the CPU's launch count ``derived`` (per replayed
    epoch, or over the graph twin's turns when ``per_epoch`` is False);
    the peak device memory over the turns added to the row."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, row = graph_twins(
        torch, label, make, required=tuple(k for k, v in derived.items() if v),
        turn_windows=1, profile=False)
    row['peak_memory_mib'] = torch.cuda.max_memory_allocated() / 2 ** 20
    got = (row['launches_per_epoch']['graph'] if per_epoch
           else {k: float(v) for k, v in launches.items()})
    print(f"{label}: launches {'per replayed epoch' if per_epoch else 'over the graph twin'}"
          f" {got} | the code's on the CPU {derived} | peak device memory "
          f"{row['peak_memory_mib']:.1f} MiB, graph pool "
          f"{row['graph_pool_mib']:.1f} MiB", flush=True)
    if not row['bitwise']:
        fail(f"{label}: the graph is not equal to its eager twin to the bit: "
             f"{row['rel_diff_by_group']}")
    if got != derived:
        fail(f"{label}: launches {got} against the {derived} the code makes "
             "on the CPU")
    row['derived'] = derived
    return launches, row


def quality_phase(torch):
    """examples/round5_quality_torch.py's paths at full width on the card:

      * the antisym decay: stage_antisym's recipe (He, 2D, L = 5, batch
        256, Metropolis, lr 3e-4, seed 2) trains one window and writes its
        checkpoint; trainers at lr 3e-5 load it — each Adam must read lr
        3e-5 — and run graphed against eager, to the bit;
      * the Li refresh: Li on Metropolis walkers, 3 sweeps, a refresh every
        window, two windows per twin (the warm start, one refresh), to the
        bit, K1 over the graph twin equal to the CPU's count;
      * the ng batches: adam, SR and SPRING at 16,384 walkers, adam and SR
        at 65,536 (the ng_scale recipes, windows of NG_TWIN_WINDOW epochs),
        to the bit, K1 / K3 per replayed epoch equal to the CPU's count,
        peak memory and graph pool printed; the 65,536 adam twin again
        under 'poly_pallas', K3 at its path's shapes (the staged regime)
        against the plain core."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    r5 = example_module('round5_quality_torch')
    jobs = {j.key: j for j in r5.plan()}
    rows, total = {}, {}

    def add(label, launches, row):
        rows[label] = row
        total.update({k: total.get(k, 0) + v for k, v in launches.items()})

    # ---- the antisym decay ----
    job = jobs['he2d2e_antisym']
    decay_lr = job.decay[1]
    base = dict(job.cfg, window=QUALITY_WINDOW, log_every=QUALITY_WINDOW,
                device='cuda')
    with tempfile.TemporaryDirectory() as run_dir:
        first = VMCTrainer(VMCConfig(**dict(base, save_dir=run_dir)))
        first.train(QUALITY_WINDOW, verbose=False)
        del first

        def make_decay(graph):
            t = VMCTrainer(VMCConfig(**dict(base, learning_rate=decay_lr)),
                           graph=graph)
            if not t.load_checkpoint(run_dir):
                fail(f"quality decay: no checkpoint under {run_dir}")
            lr = t.step.optimizer.param_groups[0]['lr']
            if lr != decay_lr:
                fail(f"quality decay: the loaded Adam reads lr {lr}, its "
                     f"config {decay_lr}")
            return t
        derived = {'sampler': 0.0, 'basis_jet': 0.0}
        add('decay', *quality_twin(torch, 'quality decay (He-2d antisym, lr '
                                   f'{job.cfg["learning_rate"]:g} -> '
                                   f'{decay_lr:g})', make_decay, derived))
    print(f"quality decay: the loaded Adam reads lr {decay_lr:g}", flush=True)

    # ---- the Li refresh ----
    li = dict(jobs['li_metro_refresh100_s3'].cfg, window=QUALITY_WINDOW,
              mcmc_refresh_every=QUALITY_WINDOW)

    def make_li(graph):
        return VMCTrainer(VMCConfig(**dict(li, log_every=QUALITY_WINDOW,
                                           device='cuda')), graph=graph)
    add('li refresh', *quality_twin(
        torch, 'quality Li refresh (3 sweeps, every window)', make_li,
        refresh_calls(li, 2), per_epoch=False))

    # ---- the ng batches; the 65,536 adam again under 'poly_pallas' ----
    ng = [(key, dict(job.cfg, window=NG_TWIN_WINDOW))
          for key, job in jobs.items()
          if job.stage == 'ng_scale' and not job.post.get('not_run')]
    ng.append(('ng_adam_65k poly_pallas',
               dict(jobs['ng_adam_65k'].cfg, window=NG_TWIN_WINDOW,
                    eval_backend='poly_pallas')))
    for key, config in ng:
        def make(graph, config=config):
            return VMCTrainer(VMCConfig(**dict(
                config, log_every=NG_TWIN_WINDOW, device='cuda')),
                graph=graph)
        label = f"quality {key} (batch {config['batch_size']})"
        launches, row = quality_twin(torch, label, make, catalogue_epoch_calls(
            {k: v for k, v in config.items()
             if k not in ('batch_size', 'window')}))
        if config.get('eval_backend') == 'poly_pallas':
            row['k3_at_path_shapes'] = k3_at_path_shapes(torch, label, make)
        add(key, launches, row)
    return total, rows


# the scaling phase: examples/batch_sweep_torch.py's and
# examples/mcmc_scale_torch.py's windows at this batch, graphed against
# eager in turns of one window of SCALING_WINDOW epochs (K3 at the batch
# sweep's sites is timed in phase 3, K3_TIMED_SITES)
SCALING_BATCH = 4096
SCALING_WINDOW = 2
# the tail pass on the committed 100k checkpoint, cut to a few blocks
SCALING_TAIL = dict(k=8, n_blocks=2, skip_blocks=2, sweeps_per_block=5,
                    n_warmup_sweeps=20, batch_size=4096)


def scaling_phase(torch, params):
    """The batch and MCMC scaling studies' paths on the card:

      * examples/batch_sweep_torch.py's window (the flagship at seed 0, adam
        without a clip) at SCALING_BATCH walkers under 'poly_pallas', and
        examples/mcmc_scale_torch.py's Metropolis (3 sweeps) and MALA (1
        sweep) windows at SCALING_BATCH ('poly', step 0.5, the sampler's
        target acceptance), each graphed against its eager twin in turns
        of one window of SCALING_WINDOW epochs (``quality_twin``): to the
        bit, every loss finite, K1 / K3 per replayed epoch (over the graph
        twin's two windows from scratch for the MCMC twins: the warm start)
        equal to the CPU's count;
      * the tail pass (vmc/evaluate.py::record_tail) once on the committed
        100k checkpoint after an evaluation cut to SCALING_TAIL's blocks: it
        continues the evaluation's chain (the last block's raw mean equal
        to the bit), its rows are finite, and at them the 'dense' form
        lies within LAP_FORMS_RTOL and the finite difference (where its
        stencil stays inside the box and the sorted sector) within
        LAP_FD_RTOL of max|Hψ| from the pass's own Hψ."""
    from waveflow_tpu_torch.vmc import (VMCConfig, VMCTrainer,
                                        evaluate_trainer, record_tail)
    sweep = example_module('batch_sweep_torch')
    mcmc = example_module('mcmc_scale_torch')
    rows, total = {}, {}
    recipes = [('batch_sweep poly_pallas', 'poly_pallas', {})]
    recipes += [(f'mcmc_scale {sampler} s{sweeps}', 'poly',
                 dict(sampler=sampler, mcmc_sweeps=sweeps, mcmc_step_size=0.5,
                      mcmc_target_accept=mcmc.TARGET_ACCEPT[sampler]))
                for sampler, sweeps in (('metropolis', 3), ('mala', 1))]
    for name, backend, extra in recipes:
        def make(graph, backend=backend, extra=extra):
            return sweep.build(SCALING_BATCH, SCALING_WINDOW, backend, 'cuda',
                               graph=graph, **extra)
        config = {k: v for k, v in sweep.config(
            SCALING_BATCH, SCALING_WINDOW, backend, **extra).items()
            if k not in ('batch_size', 'window', 'log_every')}
        label = f"scaling {name} (batch {SCALING_BATCH})"
        if extra:
            # the MCMC twin's K1 is its warm start: counted over the graph
            # twin's two windows from scratch
            derived, per_epoch = refresh_calls(config, 2, 'auto'), False
        else:
            derived, per_epoch = catalogue_epoch_calls(config), True
        launches, row = quality_twin(torch, label, make, derived, per_epoch)
        rows[name] = row
        total = {k: total.get(k, 0) + v for k, v in launches.items()}

    trainer = VMCTrainer(VMCConfig(batch_size=256, device='cuda'))
    trainer.model.load_state_dict(params)
    cut = {k: v for k, v in SCALING_TAIL.items()
           if k not in ('k', 'n_blocks', 'skip_blocks')}
    ev = evaluate_trainer(trainer, n_blocks=SCALING_TAIL['skip_blocks'],
                          **cut)
    tail = record_tail(trainer, evaluation=ev, **SCALING_TAIL)
    scale = tail['hpsi_scale']
    dense = max(abs(r['hpsi_dense'] - r['hpsi']) for r in tail['rows']) / scale
    fd = max((abs(r['hpsi_fd'] - r['hpsi']) for r in tail['rows']
              if r['fd_inside']), default=0.0) / scale
    finite = all(math.isfinite(v) for r in tail['rows']
                 for v in (r['el'], r['el_dense'], r['el_fd'],
                           r['el_float64']))
    top = tail['rows'][0]
    print(f"scaling tail (100k checkpoint, {SCALING_TAIL['batch_size']} "
          f"walkers): same chain {tail['same_chain']} (last block "
          f"{tail['last_block_mean']:.7f} / {tail['evaluation_last_block_mean']:.7f}) "
          f"| top E_L {top['el']:.5f} at wall {top['wall_distance']:.4f}, "
          f"gap {top['pair_distance']:.4f}; dense {dense:.3e}, finite "
          f"difference {fd:.3e} of max|Hpsi| {scale:.4f} (limits "
          f"{LAP_FORMS_RTOL:g}, {LAP_FD_RTOL:g}); float64 E_L "
          f"{top['el_float64']:.5f}", flush=True)
    if not tail['same_chain']:
        fail("scaling tail: the pass did not continue the evaluation's chain")
    if not finite or dense > LAP_FORMS_RTOL or fd > LAP_FD_RTOL:
        fail(f"scaling tail: the forms disagree at the tail (dense {dense:.3e},"
             f" finite difference {fd:.3e}) or a value is not finite")
    rows['tail'] = dict(same_chain=tail['same_chain'], dense_rel=dense,
                        fd_rel=fd, top=top, el_quantiles=tail['el_quantiles'])
    return total, rows


# the studies phase: examples/frontier_2d2e_torch.py's and
# examples/sr_study_torch.py's recipes at full width from scratch; K1 on the
# big ansatz's prior table at these batches (the SR study's and its
# evaluation's), the staged flagship table timed beside it
STUDIES_SR_ROWS = ('big_spring_0.05_m0.9_tr', 'big_sr_cg_0.05_tr')
STUDIES_K1_BATCHES = (256, 4096)


def streamed_k1(torch, gen):
    """K1 on the big ansatz's real prior table (orthonormal B-splines of
    degree 6, 31 knots: 36 bases x the 2000-point mesh, 288 KB, above a
    block's shared memory) with the conditional coefficients of a big model
    from seed 2, every draw held in probability against a float64 quantile
    (``check_sampler(in_probability=True)``: on this table, on an H100,
    one draw of 1,000 lay 9.4e-5 in x from the plain f32 draw, beyond
    phase 3's 6e-5),
    both timed batches in the 'streamed' regime; then the flagship's
    28-base table (staged in shared memory) timed at the same batches, for
    the comparison."""
    from waveflow_tpu_torch.ops import cuda_sampler
    from waveflow_tpu_torch.ops.sampling import sample_squared_amplitude
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    sr = example_module('sr_study_torch')

    def prior(name):
        return VMCTrainer(VMCConfig(batch_size=256, device='cuda',
                                    **sr.ANSATZE[name])).model

    big = prior('big')
    got = check_sampler(torch, gen, 'squared', big.ev_ob, big.ob_coeffs,
                        max(STUDIES_K1_BATCHES), in_probability=True)
    rows = {'tail': got['tail']}
    for B in STUDIES_K1_BATCHES:
        if got[B]['plan'].regime != 'streamed':
            fail(f"studies: K1 on the big prior's "
                 f"{tuple(big.ev_ob.table_t.shape)} table at B={B} ran as "
                 f"{got[B]['plan']}, not streamed")
        rows[('streamed', B)] = got[B]
    flagship = prior('flagship')
    for B in STUDIES_K1_BATCHES:
        with torch.no_grad():
            c = flagship.ob_coeffs(torch.rand((B, 2), generator=gen,
                                              device='cuda'))[:, 0]
        u = torch.rand((B,), generator=gen, device='cuda')

        def fn(c=c, u=u):
            return sample_squared_amplitude(flagship.ev_ob, c, u, impl='cuda')
        fn()
        plan = cuda_sampler.last_plan
        rows[('staged', B)] = dict(ms=cuda_ms(torch, fn),
                                   device_ms=device_ms(torch, fn), plan=plan)
    for B in STUDIES_K1_BATCHES:
        s, f = rows[('streamed', B)], rows[('staged', B)]
        print(f"studies: K1 at B={B}: streamed (36 bases) kernel_ms "
              f"{s['ms']:.4f} device_ms {s['device_ms']:.4f} against staged "
              f"(28 bases, regime {f['plan'].regime}) kernel_ms {f['ms']:.4f} "
              f"device_ms {f['device_ms']:.4f}: {s['device_ms'] / f['device_ms']:.2f}x "
              f"device | streamed plan grid {s['plan'].grid} x "
              f"{s['plan'].threads} threads, {s['plan'].smem_bytes} B dynamic "
              f"shared, group {s['plan'].group}", flush=True)
    return rows


def studies_calls(config) -> dict:
    """``catalogue_epoch_calls`` of a study recipe: the spline widths are
    the count's own (narrow), the flow's depth and the optimizer kept."""
    return catalogue_epoch_calls({k: v for k, v in config.items()
                                  if k not in ('spline_degree', 'num_knots',
                                               'n_spline_base_mesh_points',
                                               'batch_size', 'window',
                                               'log_every', 'save_dir',
                                               'device')})


def studies_phase(torch, k1_rows=None):
    """The three study scripts' training paths on the card:

      * examples/frontier_2d2e_torch.py's He recipe (2D, two electrons, L =
        5, lr 3e-4, seed 2) from scratch on the 'paired2d' sector, which
        the trainer must resolve, in windows of QUALITY_WINDOW epochs;
      * examples/sr_study_torch.py's STUDIES_SR_ROWS on the big ansatz (31
        knots, 4 layers): SPRING with the trust region in windows of
        TWIN_WINDOW epochs, CG-SR with it in windows of SR_GRAPH_WINDOW;

    each graphed against its eager twin in turns of one window
    (``quality_twin``): to the bit, every loss finite, K1 / K3 per replayed
    epoch equal to the CPU's count (``studies_calls``); the big rows' K1
    launched in the 'streamed' regime.  ``k1_rows``: ``streamed_k1``'s rows
    from phase 3 of a whole run (before the profiled graph phases, after
    which the profiler records no eager launch); a partial run makes them
    here, first."""
    from waveflow_tpu_torch.ops import cuda_sampler
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    if k1_rows is None:
        k1_rows = streamed_k1(torch, torch.Generator('cuda').manual_seed(23))
    frontier = example_module('frontier_2d2e_torch')
    sr = example_module('sr_study_torch')
    args = argparse.Namespace(device='cuda', out_dir='')
    recipes = [('frontier He paired2d', vars(frontier.config('He', args)),
                QUALITY_WINDOW)]
    recipes += [(f'sr_study {key}', vars(sr.config(key, args)),
                 SR_GRAPH_WINDOW if 'sr_cg' in key else TWIN_WINDOW)
                for key in STUDIES_SR_ROWS]
    rows, total = {'k1': k1_rows}, {}
    for label, config, window in recipes:
        config = dict(config, save_dir=None, window=window, log_every=window)

        def make(graph, config=config):
            t = VMCTrainer(VMCConfig(**config), graph=graph)
            if label.startswith('frontier') and (
                    t.ansatz, t.xu_coord_type) != ('sorted', 'paired2d'):
                fail(f"studies {label}: the trainer resolved "
                     f"({t.ansatz}, {t.xu_coord_type}), not paired2d")
            return t
        launches, row = quality_twin(torch, f"studies {label}", make,
                                     studies_calls(config))
        regime = cuda_sampler.last_plan.regime
        row['k1_regime'] = regime
        if label.startswith('sr_study') and regime != 'streamed':
            fail(f"studies {label}: K1 ran in the {regime!r} regime, not "
                 "'streamed'")
        print(f"studies {label}: K1 regime {regime}", flush=True)
        rows[label] = row
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total, rows


# the reports phase: examples/evaluate_flagship_torch.py's evaluation, its
# chain cut to REPORTS_EVAL, on the run whose every parameter is NaN and
# then on a finite run in the same process; the outlier study's median_abs
# recipe and round 4's big Li SPRING recipe graphed against eager
NAN_RUN = ROOT / 'results' / 'he1d_seed2'
REPORTS_EVAL = dict(n_blocks=8, sweeps_per_block=10, n_warmup_sweeps=100,
                    batch_size=4096)
REPORTS_RECIPES = (('outlier_study_torch', 'box2__median_abs_lr3e-4_40k'),
                   ('round4_quality_torch', 'li_big_spring_20k'))
# K3's sites of the NaN checks and of the timing before / after the check
K3_NAN_SITES = (512, 131072)
# csrc/basis_jet.cu's s before and since the NaN check
K3_NAN_LINE = 's[u] = pos != pos ? pos : fminf(fmaxf(pos - idx, 0.f), 1.f);'
K3_PRE_NAN_LINE = 's[u] = fminf(fmaxf(pos - idx, 0.f), 1.f);'


def nan_sites(torch, gen, R: int):
    """R sites uniform in [−0.05, 1.05], every 7th NaN, two ±inf."""
    x = torch.rand((R,), generator=gen, device='cuda') * 1.1 - 0.05
    x[::7] = float('nan')
    x[3], x[5] = float('inf'), -float('inf')
    return x


def same_nans(torch, a, b) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b))


def k3_nan_check(torch, ops, tabs_i, tabs_b, gen) -> dict:
    """K3 at NaN, ±inf and finite sites against its plain core, for the
    I-spline and OB jets at K3_NAN_SITES: NaN for NaN, every other value
    within phase 3's rtol 2e-5, atol 2e-4; and the whole jet
    (``PolySplineEvaluator.basis_jet``, the linear extension around the
    core) with the kernel core against the plain core, NaN for NaN."""
    from waveflow_tpu_torch.ops import cuda_jet
    rows = {}
    for label, tabs, use_ob in (('I', tabs_i, False), ('OB', tabs_b, True)):
        ev_k, ev_p = (ops.make_poly_evaluator(tabs, use_ob=use_ob,
                                              jet_backend=b, device='cuda')
                      for b in ('pallas', 'xla'))
        A, nc, k = ev_k.A_jet, ev_k.n_cells, ev_k.ncoef
        for R in K3_NAN_SITES:
            x = nan_sites(torch, gen, R)
            pairs = ((cuda_jet.basis_jet_cuda(x, A, nc, k),
                      cuda_jet.basis_jet_plain(x, A, nc, k), 'core'),
                     (ev_k.basis_jet(x), ev_p.basis_jet(x), 'jet'))
            torch.cuda.synchronize()
            for got, want, what in pairs:
                nan, fin = torch.isnan(want), torch.isfinite(want)
                if not same_nans(torch, got, want):
                    fail(f"K3 {label} {what} R={R}: NaN at "
                         f"{int(torch.isnan(got).sum())} outputs, the plain "
                         f"version at {int(nan.sum())}")
                # ±inf (the jet's linear extension at an infinite x) equal
                err = (got[fin] - want[fin]).abs().max().item()
                if not (torch.allclose(got[~nan], want[~nan], rtol=2e-5,
                                       atol=2e-4)):
                    fail(f"K3 {label} {what} R={R}: the non-NaN outputs "
                         f"disagree, max|d| over the finite ones {err:.3e}")
                rows[f'{label} {what} R={R}'] = dict(
                    nan_outputs=int(nan.sum()), max_abs_err=err)
        print(f"K3 {label} at NaN / ±inf / finite sites: NaN for NaN, core "
              "and jet, against the plain core (rtol 2e-5, atol 2e-4): "
              + ", ".join(f"{name}: {r['nan_outputs']} NaN, max|d| "
                          f"{r['max_abs_err']:.3e}"
                          for name, r in rows.items()
                          if name.startswith(f'{label} ')), flush=True)
    return rows


def sampler_nan_check(torch, model, gen) -> dict:
    """K1 and K2 on the flagship prior's table against their plain
    versions, every 5th walker's coefficients NaN, at B = 256 and 4,096:
    NaN for NaN, the other draws (u <= 1 − 1e-4) within phase 3's 6e-5."""
    from waveflow_tpu_torch.ops.sampling import (sample_linear_density,
                                                 sample_squared_amplitude)
    rows = {}
    for name, sample in (('K1', sample_squared_amplitude),
                         ('K2', sample_linear_density)):
        for B in (256, 4096):
            with torch.no_grad():
                c = model.ob_coeffs(torch.rand((B, 2), generator=gen,
                                               device='cuda'))[:, 0]
            if name == 'K2':
                c = c.abs()
            c = c.contiguous()
            c[::5] = float('nan')
            u = torch.rand((B,), generator=gen, device='cuda') * (1 - 1e-4)
            x_k = sample(model.ev_ob, c, u, impl='cuda')
            x_p = sample(model.ev_ob, c, u, impl='plain')
            torch.cuda.synchronize()
            fin = ~torch.isnan(x_p)
            err = (x_k[fin] - x_p[fin]).abs().max().item()
            if not same_nans(torch, x_k, x_p) or err > 6e-5:
                fail(f"{name} at NaN coefficients, B={B}: "
                     f"{int(torch.isnan(x_k).sum())} NaN draws against the "
                     f"plain version's {int((~fin).sum())}, max|dx| {err:.3e}")
            rows[f'{name} B={B}'] = dict(nan_draws=int((~fin).sum()),
                                         max_abs_err=err)
    print("K1 / K2 at NaN coefficients (every 5th walker): NaN for NaN "
          "against the plain versions, the rest within 6e-5: "
          + ", ".join(f"{n}: {r['nan_draws']} NaN, max|dx| "
                      f"{r['max_abs_err']:.3e}" for n, r in rows.items()),
          flush=True)
    return rows


def pre_nan_k3_paths():
    """(source, library) of csrc/basis_jet.cu as it was before the NaN
    check (K3_PRE_NAN_LINE), under a file name of its own in the build
    directory (a library opened twice under one path is the first one)."""
    import hashlib
    from waveflow_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC_DIR / 'basis_jet.cu').read_text()
    if src.count(K3_NAN_LINE) != 1:
        fail("basis_jet.cu holds no NaN check to time against")
    old = src.replace(K3_NAN_LINE, K3_PRE_NAN_LINE)
    tag = hashlib.sha1((old + ' '.join(cuda_build.NVCC_FLAGS)).encode()
                       ).hexdigest()[:12]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_path = cuda_build.BUILD_DIR / f'basis_jet_pre_nan_{tag}.cu'
    src_path.write_text(old)
    return src_path, cuda_build.BUILD_DIR / f'libbasis_jet_pre_nan_{tag}.so'


def start_pre_nan_k3_build():
    """nvcc started on the pre-NaN-check K3 source, to run beside the
    build of the kernels (one process each, started together); None where
    the library is built already."""
    from waveflow_tpu_torch.ops import cuda_build
    src_path, lib_path = pre_nan_k3_paths()
    if lib_path.exists():
        return None
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-I',
         str(cuda_build.CSRC_DIR), '-o', str(lib_path), str(src_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def pre_nan_k3_library(build=None):
    """The pre-NaN-check K3 library (``build``: its nvcc process from
    ``start_pre_nan_k3_build``, else one started here), waited for,
    loaded and bound; its init entry called, which lifts the staged
    kernel's shared-memory limit."""
    import ctypes
    from waveflow_tpu_torch.ops import cuda_jet
    build = build or start_pre_nan_k3_build()
    if build is not None:
        out, _ = build.communicate(timeout=600)
        if build.returncode != 0:
            fail(f"nvcc failed for the pre-NaN-check basis_jet.cu:\n{out}")
    lib = ctypes.CDLL(str(pre_nan_k3_paths()[1]))
    for entry, (argtypes, restype) in cuda_jet.SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(argtypes), restype
    n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
    if lib.basis_jet_init(ctypes.byref(n_sm), ctypes.byref(smem)):
        fail("basis_jet_init of the pre-NaN-check build failed")
    return lib


def k3_nan_timing(torch, ops, tabs_i, gen, build=None) -> dict:
    """K3 before and after the NaN check (one compare per site) on the
    I-spline jet at K3_NAN_SITES, finite sites: both builds launched
    through one raw launcher (the wrapper's plan and checks left out),
    equal outputs to the bit, CUDA events over 50 back-to-back calls in
    turns before, after, after, before, and the profiler's device time."""
    from waveflow_tpu_torch.ops import cuda_build, cuda_jet
    old = pre_nan_k3_library(build)
    new = cuda_build.bind('basis_jet', cuda_jet.SIGNATURES)
    ev = ops.make_poly_evaluator(tabs_i, use_ob=False, jet_backend='pallas',
                                 device='cuda')
    A, nc, k = ev.A_jet, ev.n_cells, ev.ncoef
    n_out = A.shape[1]
    stream = cuda_build.current_stream(0)
    rows = {}
    for R in K3_NAN_SITES:
        x = torch.rand((R,), generator=gen, device='cuda') * 1.1 - 0.05
        out = torch.empty((R, n_out), device='cuda')
        p = cuda_jet.plan(R, nc, k, n_out, *cuda_build.device_limits(
            new, 'basis_jet_init', 0))

        def launch(lib):
            err = lib.basis_jet_launch(
                x.data_ptr(), A.data_ptr(), out.data_ptr(), R, nc, k, n_out,
                p.regime == 'staged', p.grid, p.threads, p.smem_bytes, stream)
            if err:
                fail(f"K3 launch failed: {lib.basis_jet_error_string(err)}")
        outs = []
        for lib in (old, new):
            launch(lib)
            torch.cuda.synchronize()
            outs.append(out.clone())
        if not torch.equal(*outs):
            fail(f"K3 before and after the NaN check differ at R={R} on "
                 "finite sites")
        turns = [cuda_ms(torch, lambda lib=lib: launch(lib))
                 for lib in (old, new, new, old)]
        before = 0.5 * (turns[0] + turns[3])
        after = 0.5 * (turns[1] + turns[2])
        dev = {name: device_ms(torch, lambda lib=lib: launch(lib))
               for name, lib in (('before', old), ('after', new))}
        rows[R] = dict(ms_before=before, ms_after=after, turns_ms=turns,
                       device_ms_before=dev['before'],
                       device_ms_after=dev['after'], regime=p.regime)
        print(f"K3 before / after the NaN check, R={R} ({p.regime}): "
              f"kernel_ms {before:.4f} / {after:.4f} (turns "
              f"{', '.join(f'{t:.4f}' for t in turns)}) | device_ms "
              f"{dev['before']:.4f} / {dev['after']:.4f} | outputs equal to "
              "the bit", flush=True)
    return rows


def nan_rows(torch, ops, model, gen, build=None) -> dict:
    """The NaN checks of K3, K1 and K2 and K3's time before / after its
    NaN check (``build``: ``start_pre_nan_k3_build``'s process): in phase 3
    of a whole run (before the profiled graph phases), else in the reports
    phase, first."""
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    tabs_i = ops.get_tables('I', deg, knots, n_mesh=mesh)
    tabs_b = ops.get_tables('B', deg, knots, n_mesh=mesh)
    return dict(k3=k3_nan_check(torch, ops, tabs_i, tabs_b, gen),
                samplers=sampler_nan_check(torch, model, gen),
                k3_timing=k3_nan_timing(torch, ops, tabs_i, gen, build))


def reports_phase(torch, params, nan=None):
    """The three report scripts' paths on the card:

      * examples/evaluate_flagship_torch.py's loader and evaluation
        (``load_run``, ``evaluate``) on results/he1d_seed2, every
        parameter NaN, at REPORTS_EVAL: no exception, non-finite raw and
        clipped energies (the accept rate printed, not gated); then on
        results/r4_spring100k in the same process: finite, within 5
        combined σ of JAX's figures (results/final_energies_r4.json), raw
        and clipped — no sticky CUDA error;
      * examples/outlier_study_torch.py's box2 median_abs recipe and
        examples/round4_quality_torch.py's li_big_spring_20k recipe from
        scratch, each graphed against its eager twin in turns of one window
        of QUALITY_WINDOW epochs, to the bit, K1 / K3 per replayed epoch
        equal to the CPU's count;
      * ``nan``: ``nan_rows`` of phase 3; a partial run makes them here,
        first."""
    from waveflow_tpu_torch import ops
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    if nan is None:
        nan = nan_rows(torch, ops,
                       flagship_model(torch, params, 'poly_pallas'),
                       torch.Generator('cuda').manual_seed(24))
    ef = example_module('evaluate_flagship_torch')
    refs = json.loads(JAX_EVAL_R4.read_text())
    rows, total = {'nan': nan}, {}
    for run_dir in (NAN_RUN, SPRING_RUN):
        key = f'results/{run_dir.name}'
        trainer = ef.load_run(ef.config('He', run_dir, {}, 'cuda'))
        flat = torch.cat([p.detach().reshape(-1)
                          for p in trainer.model.parameters()])
        n_nan = int(torch.isnan(flat).sum())
        ev, launches, wall = ef.evaluate(trainer, **REPORTS_EVAL)
        ref = refs[key]
        finite = ef.finite(ev.e_mean, ev.e_clipped)
        sig = {k: ef.r5.combined_sigma(getattr(ev, k), getattr(ev, s),
                                       ref[k], ref[s])
               for k, s in ef.GATED}
        cut = REPORTS_EVAL
        print(f"reports {run_dir.name} ({n_nan} of {flat.numel()} parameters "
              f"NaN; {cut['batch_size']} walkers, {cut['n_warmup_sweeps']} + "
              f"{cut['n_blocks']} x {cut['sweeps_per_block']} sweeps): raw {ev.e_mean:.6f} +- {ev.e_stderr:.6f}, clipped "
              f"{ev.e_clipped:.6f} +- {ev.e_clipped_stderr:.6f}, accept rate "
              f"{ev.accept_rate:.4f} | JAX raw {ref['e_mean']}, clipped "
              f"{ref['e_clipped']} | combined sigma {sig} | {wall:.2f} s | "
              f"launches {launches}", flush=True)
        if run_dir == NAN_RUN:
            if n_nan != flat.numel() or finite:
                fail(f"reports {run_dir.name}: {n_nan} of {flat.numel()} "
                     f"parameters NaN, energies finite: {finite}")
        elif not finite or any(v is None or abs(v) > 5.0
                               for v in sig.values()):
            fail(f"reports {run_dir.name} after the NaN run: {sig} combined "
                 "sigma from JAX, finite: " + str(finite))
        rows[run_dir.name] = dict(e_mean=ev.e_mean, e_clipped=ev.e_clipped,
                                  accept_rate=ev.accept_rate, sigma=sig,
                                  wall_s=wall, launches=launches,
                                  nan_parameters=n_nan)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        del trainer
    args = argparse.Namespace(device='cuda', out_dir='')
    for stem, key in REPORTS_RECIPES:
        mod = example_module(stem)
        config = (vars(mod.config(key, args)) if stem.startswith('outlier')
                  else dict(next(j for j in mod.plan() if j.key == key).cfg))
        config = dict(config, save_dir=None, window=QUALITY_WINDOW,
                      log_every=QUALITY_WINDOW, device='cuda')

        def make(graph, config=config):
            return VMCTrainer(VMCConfig(**config), graph=graph)
        launches, row = quality_twin(torch, f"reports {stem} {key}", make,
                                     studies_calls(config))
        rows[key] = row
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total, rows


def phase_table(torch, params, jax_raw, jax_clipped, ancestral_wps=None,
                k3_b2b_ms=None, k1_streamed=None, nan=None):
    """Phases 23, 38-39, 30-31, 50, 6-8, 46-49, 9-26, 51-53, 55, 27,
    32-33, 54, 56, 34-37, 58-62, 40-41, 57 and 42-45 in order, as (name,
    run): run() -> (the kernel launches on that path, or None, and the
    phase's figures)."""
    r4 = json.loads(JAX_EVAL_R4.read_text())[f'results/{SPRING_RUN.name}']
    mcmc = json.loads(JAX_EVAL_MCMC.read_text())[MALA_RUN.name]
    r5 = json.loads(JAX_EVAL.read_text())
    li = r5['li_metro_refresh100_s3']
    paired2d = json.loads(JAX_EVAL_2D_R4.read_text())['he2d2e_lr3e-4_decay']
    return (
        # ---- 23. K4 under vmap, first: after many profiled graph replays
        # the profiler stops recording its eager launches ----
        ('k4-vmap', lambda: (None, k4_vmap_phase(torch))),
        # ---- 38-39. K4's forward-mode chain and the table backend's Hψ
        # (before the profiled graph phases, as k4-vmap) ----
        ('table-kernels', lambda: table_kernels_phase(torch, params)),
        ('table-hpsi', lambda: table_hpsi_phase(torch, params)),
        # ---- 30-31. the collectives in the graphed windows, world of one
        # (before the profiled graph phases, as k4-vmap) ----
        ('dp-nccl-1', lambda: dp_nccl_phase(torch)),
        ('dp-metropolis-1', lambda: dp_metropolis_phase(torch)),
        ('dp-spring-1', lambda: dp_spring_phase(torch)),
        # ---- 6-8. graphs against eager, evaluation, resume, Metropolis ----
        ('graph-train', lambda: graph_train_phase(torch)),
        ('eval-4k', lambda: evaluation_phase(torch, jax_raw, jax_clipped)),
        ('graph-eval', lambda: graph_eval_phase(torch)),
        ('resume', lambda: resume_phase(torch)),
        ('metropolis-256', lambda: metropolis_phase(torch, ancestral_wps)),
        ('graph-metropolis', lambda: graph_metropolis_phase(torch)),
        # ---- the MALA, SPRING and SR windows graphed against eager ----
        ('graph-mala', lambda: graph_mala_phase(torch)),
        ('graph-spring', lambda: graph_spring_phase(torch)),
        ('graph-sr', lambda: graph_sr_phase(torch)),
        ('graph-natgrad-mcmc', lambda: graph_natgrad_mcmc_phase(torch)),
        # ---- 9-12. MALA, SPRING, SR, Li: windows and the JAX gates ----
        ('mala-eval', lambda: gate_phase(
            torch, 'mala', MALA_RUN, dict(sampler='mala'),
            (mcmc['eval_mean'], None),
            (mcmc['eval_clipped'], mcmc['eval_clipped_stderr']))),
        ('mala-256', lambda: window_phase(
            torch, 'mala-256', MALA_RUN, dict(sampler='mala'), 100)),
        ('spring-eval', lambda: gate_phase(
            torch, 'spring', SPRING_RUN, SPRING_CONFIG,
            (r4['e_mean'], r4['e_stderr']),
            (r4['e_clipped'], r4['e_clipped_stderr']))),
        ('spring-256', lambda: window_phase(
            torch, 'spring-256', SPRING_RUN, SPRING_CONFIG, 100,
            profile=3)),
        ('sr-256', lambda: window_phase(
            torch, 'sr-256', SR_RUN, SR_CONFIG, 20, profile=1)),
        ('li-eval', lambda: gate_phase(
            torch, 'li', LI_RUN, LI_CONFIG,
            (li['eval_mean'], li['eval_stderr']),
            (li['eval_clipped'], li['eval_clipped_stderr']))),
        ('li-256', lambda: li_window_phase(torch)),
        ('vmap', lambda: (None, vmap_phase(torch))),
        # ---- 13-16. the Laplacian forms, the reference design, poly ----
        ('lap-forms', lambda: lap_forms_phase(torch, params)),
        ('reference-grad', lambda: reference_grad_phase(torch, params)),
        ('reference-256', lambda: reference_window_phase(torch)),
        ('poly-sample', lambda: poly_sample_phase(torch, params, jax_raw)),
        # ---- 17-22. two dimensions and the antisym ansatz ----
        ('antisym-eval', lambda: eval_2d_phase(
            torch, 'antisym-eval', ANTISYM_RUN, ANTISYM_CONFIG,
            r5['he2d2e_antisym'],
            fidelity=(ED40_HE, r5['he2d2e_antisym']['fidelity_ed40']))),
        ('box3-2d-eval', lambda: eval_2d_phase(
            torch, 'box3-2d-eval', BOX3_RUN, BOX3_CONFIG,
            r5['box3_2d_antisym'])),
        ('paired2d-eval', lambda: eval_2d_phase(
            torch, 'paired2d-eval', PAIRED2D_RUN, PAIRED2D_CONFIG, paired2d)),
        ('h2d-fidelity', lambda: h2d_fidelity_phase(torch)),
        ('graph-antisym', lambda: graph_2d_phase(
            torch, 'graph-antisym', ANTISYM_RUN, ANTISYM_CONFIG, 0)),
        ('paired2d-256', lambda: graph_2d_phase(
            torch, 'paired2d-256', PAIRED2D_RUN, PAIRED2D_CONFIG, 4)),
        # ---- 23-27. the probprog samplers ----
        ('posterior-hmc', lambda: posterior_phase(torch, 'hmc')),
        ('posterior-nuts', lambda: posterior_phase(torch, 'nuts')),
        ('posterior-smc', lambda: posterior_phase(torch, 'smc')),
        # ---- 51-53. the posterior's and the density trainer's graphs
        # against their eager twins ----
        ('graph-posterior-hmc', lambda: graph_posterior_hmc_phase(torch)),
        ('graph-posterior-smc', lambda: graph_posterior_smc_phase(torch)),
        ('graph-posterior-nuts', lambda: graph_posterior_nuts_phase(torch)),
        ('graph-density', lambda: graph_density_phase(torch)),
        ('nuts-waveflow', lambda: nuts_waveflow_phase(torch, params)),
        # ---- 32-33. two gloo ranks on the card; the sharded posterior ----
        ('dp-gloo-2', lambda: dp_gloo_phase(torch)),
        ('posterior-sharded-1', lambda: posterior_phase(torch, 'hmc',
                                                        sharded=True)),
        ('graph-posterior-smc-sharded-1',
         lambda: graph_posterior_smc_phase(torch, sharded=True)),
        ('graph-posterior-nuts-sharded-1',
         lambda: graph_posterior_nuts_phase(torch, sharded=True)),
        # ---- 34-37. the committed JAX runs no earlier phase loads ----
        ('be4-eval', lambda: gate_phase(
            torch, 'be4-eval', BE4_RUN, BE4_CONFIG,
            (r5['be4_interacting']['eval_mean'],
             r5['be4_interacting']['eval_stderr']),
            (r5['be4_interacting']['eval_clipped'],
             r5['be4_interacting']['eval_clipped_stderr']))),
        ('box4-eval', lambda: gate_phase(
            torch, 'box4-eval', BOX4_RUN, BOX4_CONFIG,
            (r5['box4_free']['eval_mean'], r5['box4_free']['eval_stderr']),
            (r5['box4_free']['eval_clipped'],
             r5['box4_free']['eval_clipped_stderr']))),
        ('li-2d-eval', lambda: eval_2d_phase(
            torch, 'li-2d-eval', LI2D_RUN, LI2D_CONFIG,
            r5['li_2d_antisym'])),
        ('h2-2d-eval', lambda: eval_2d_phase(
            torch, 'h2-2d-eval', H2_2D_RUN, H2_2D_CONFIG,
            r5['h2_2d2e_antisym'],
            fidelity=(ED40_H2, r5['h2_2d2e_antisym']['fidelity_ed40']))),
        # ---- 58. the system catalogue from scratch ----
        ('catalogue', lambda: catalogue_phase(torch)),
        # ---- 59. the round-5 quality studies' paths ----
        ('quality', lambda: quality_phase(torch)),
        # ---- 60. the batch and MCMC scaling studies' paths ----
        ('scaling', lambda: scaling_phase(torch, params)),
        # ---- 61. the frontier and SR-study recipes; K1 streamed ----
        ('studies', lambda: studies_phase(torch, k1_streamed)),
        # ---- 62. the report scripts: a NaN run evaluated, then a finite
        # one; the round-4 and outlier recipes ----
        ('reports', lambda: reports_phase(torch, params, nan)),
        # ---- 40-43. the table backend's evaluation and window; the
        # density side's new model and dataset ----
        ('table-eval', lambda: table_eval_phase(torch, jax_raw,
                                                jax_clipped)),
        ('graph-table', lambda: graph_table_phase(torch, params)),
        ('graph-table-menu', lambda: graph_table_menu_phase(torch, params)),
        ('rqs-density', lambda: rqs_density_phase(torch)),
        ('gm-density', lambda: gm_density_phase(torch)),
        # ---- 44-45. the reference-API layer and the evaluation artifacts,
        # last: the artifacts phase records a profiler trace ----
        ('compat', lambda: compat_phase(torch)),
        ('artifacts', lambda: artifacts_phase(torch, k3_b2b_ms)))


def end_walker_mesh():
    """End the process group the sharded phases made (NCCL, a world of
    one), so that the script exits with no communicator left."""
    from waveflow_tpu_torch.parallel import destroy_walker_mesh
    destroy_walker_mesh()


def partial_run(torch, only, params, jax_raw, jax_clipped, kind, t_start):
    """``--only``: the named phases of the table, then the status line."""
    table = phase_table(torch, params, jax_raw, jax_clipped)
    names = {name for name, _ in table}
    unknown = sorted(only - names)
    if unknown:
        fail(f"--only: no phase named {unknown}; phases: {sorted(names)}")
    for name, run in table:
        if name in only:
            t0 = time.perf_counter()
            run()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall",
                  flush=True)
    end_walker_mesh()
    print(f"chip_smoke --only: {time.perf_counter() - t_start:.1f} s wall, "
          "the build included; no kernels line in a partial run", flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Drive the port's paths on one card and check them.")
    parser.add_argument(
        '--only', default=None,
        help="comma-separated phases of the table (phase_table: "
             "graph-train, eval-4k, graph-eval, resume, metropolis-256, "
             "graph-metropolis, graph-mala, graph-spring, graph-sr, "
             "graph-natgrad-mcmc, mala-eval, ..., poly-sample, antisym-eval, "
             "..., paired2d-256, k4-vmap, posterior-hmc, posterior-nuts, "
             "posterior-smc, graph-posterior-hmc, graph-posterior-smc, "
             "graph-posterior-nuts, graph-density, nuts-waveflow, "
             "dp-nccl-1, dp-metropolis-1, dp-spring-1, dp-gloo-2, "
             "posterior-sharded-1, graph-posterior-smc-sharded-1, "
             "graph-posterior-nuts-sharded-1, be4-eval, box4-eval, "
             "li-2d-eval, h2-2d-eval, catalogue, quality, scaling, "
             "studies, reports, "
             "table-kernels, "
             "table-hpsi, "
             "table-eval, graph-table, graph-table-menu, rqs-density, "
             "gm-density, compat, "
             "artifacts) to run alone "
             "after the build; a partial run prints no kernels line")
    # one rank of dp-gloo-2, which the phase starts itself
    parser.add_argument('--dp-gloo-rank', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--dp-port', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--dp-out', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dp_gloo_rank is not None:
        return dp_gloo_rank(args.dp_gloo_rank, args.dp_port, args.dp_out)
    only = None if args.only is None else set(args.only.split(','))

    import torch
    t_start = time.perf_counter()

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ''
    if not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)

    sys.path.insert(0, str(ROOT))
    from waveflow_tpu_torch import ops
    from waveflow_tpu_torch.convert import load_jax_checkpoint, params_from_jax
    from waveflow_tpu_torch.benchmark.density import get_benchmark_model
    from waveflow_tpu_torch.ops import cuda_build, cuda_jet, cuda_sampler
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    pre_nan_build = start_pre_nan_k3_build()
    report = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, (secs, log) in report.items():
        print(f"  {name}.cu: {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if any(w in line for w in ('Compiling entry', 'registers', 'spill')):
                print(f"    {line.strip()}", flush=True)

    ck = load_jax_checkpoint(CHECKPOINT)
    params = params_from_jax(ck['params'])
    model = flagship_model(torch, params, 'poly_pallas')
    # like with like: raw means against the JAX evaluation's raw mean,
    # clipped against clipped
    ref = json.loads(JAX_EVAL.read_text())['flagship_fwd_batched_100k']
    jax_raw = (ref['eval_mean'], ref['eval_stderr'])
    jax_clipped = (ref['eval_clipped'], ref['eval_clipped_stderr'])
    if only is not None:
        return partial_run(torch, only, params, jax_raw, jax_clipped,
                           kind, t_start)

    # ---- 3. kernels against their plain versions --------------------------
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    tabs_b = ops.get_tables('B', deg, knots, n_mesh=mesh)
    tabs_i = ops.get_tables('I', deg, knots, n_mesh=mesh)
    gen = torch.Generator('cuda').manual_seed(0)
    k1 = check_sampler(torch, gen, 'squared', model.ev_ob, model.ob_coeffs,
                       65536)
    check_sampler_other_tables(torch, ops, gen)
    k1_streamed = streamed_k1(torch, torch.Generator('cuda').manual_seed(23))
    k3 = check_basis_jet(torch, ops, tabs_i, tabs_b, gen)
    nan = nan_rows(torch, ops, model, torch.Generator('cuda').manual_seed(24),
                   pre_nan_build)
    # the density model at full width, random weights from a seed
    mflow = get_benchmark_model('MFlow', **DENSITY,
                                generator=torch.Generator().manual_seed(1),
                                device='cuda')
    gen = torch.Generator('cuda').manual_seed(1)
    k2 = check_sampler(torch, gen, 'linear', mflow.ev, mflow.prior_weights,
                       DENSITY_POINTS)
    k4, k4b = check_spline_eval(torch, mflow, gen)
    # how each wrapper launched its kernel at the driven shapes
    plans = [('K1 sampler', k1, (256, 65536)),
             ('K2 sampler_linear', k2, (256, DENSITY_POINTS)),
             ('K3 basis_jet', k3, (('I', 512), ('I', 131072))),
             ('K4 spline_eval', k4, ((0, 512), (0, 2 * DENSITY_POINTS))),
             ('K4 spline_eval_bwd', k4b, ((0, 512), (0, 2 * DENSITY_POINTS)))]
    for name, rows, shapes in plans:
        parts = []
        for shape in shapes:
            p = rows[shape]['plan']
            parts.append(f"{shape}: grid {p.grid} x {p.threads} threads, "
                         f"{p.smem_bytes} B dynamic shared, regime {p.regime}, "
                         f"group {p.group}")
        print(f"launch plan {name}: " + "; ".join(parts), flush=True)

    # ---- 4. checkpoint ----------------------------------------------------
    h_fn = he_hamiltonian(model, 'fwd_batched')
    t0 = time.perf_counter()
    with torch.no_grad():
        x = model.sample(65536, generator=torch.Generator('cuda').manual_seed(7))
        e_loc = h_fn(x)[:, 0] / model.psi(x)
    torch.cuda.synchronize()
    mean = e_loc.mean().item()
    stderr = (e_loc.std() / math.sqrt(e_loc.numel())).item()
    d_raw = sigmas(mean, stderr, jax_raw)
    print(f"checkpoint (epoch {ck['epoch']}): raw E = {mean:.6f} +- "
          f"{stderr:.6f} over 65536 ancestral walkers "
          f"({time.perf_counter() - t0:.2f} s); JAX evaluation raw mean "
          f"{jax_raw[0]} +- {jax_raw[1]}: {d_raw:.2f} combined sigma",
          flush=True)
    if not (math.isfinite(mean) and d_raw <= 5.0):
        fail(f"checkpoint energy {mean} is {d_raw:.2f} combined sigma from "
             f"the JAX raw mean {jax_raw}")

    # ---- 5. training (the main path; counts reset just before) -------------
    trainer = VMCTrainer(VMCConfig(batch_size=256, window=100, log_every=100,
                                   eval_backend='poly_pallas', device='cuda'))
    cuda_sampler.launches = 0
    cuda_jet.launches = 0
    t0 = time.perf_counter()
    trainer.train(100, verbose=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = trainer.train(100, verbose=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {'sampler': cuda_sampler.launches, 'basis_jet': cuda_jet.launches}
    if len(losses) != 200 or not all(math.isfinite(v) for v in losses):
        fail("training produced non-finite losses")
    wps_first = 100 * 256 / (t1 - t0)
    wps_second = 100 * 256 / (t2 - t1)
    print(f"training: 200 epochs at batch 256, losses finite, last "
          f"{losses[-1]:.5f} | walkers/s {wps_second:.1f} (second window; "
          f"first window {wps_first:.1f}) | launches per epoch: sampler "
          f"{launches['sampler'] / 200:g}, basis_jet "
          f"{launches['basis_jet'] / 200:g}", flush=True)
    if min(launches.values()) == 0:
        fail(f"a kernel of the path was not launched in training: {launches}")

    # the same window on the plain basis-jet core, for the end-to-end A/B
    plain = VMCTrainer(VMCConfig(batch_size=256, window=100, log_every=100,
                                 eval_backend='poly', device='cuda'))
    plain.train(10, verbose=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plain.train(100, verbose=False)
    torch.cuda.synchronize()
    print(f"training, plain basis-jet core (eval_backend='poly'): walkers/s "
          f"{100 * 256 / (time.perf_counter() - t3):.1f}", flush=True)

    # where an epoch's time goes: host clock per stage, then a profiled
    # window for the device's busy share and its kernels
    batch = trainer.sample(256)
    with torch.no_grad():
        ms_sample = host_ms(torch, lambda: trainer.sample(256))
        ms_energy = host_ms(torch, lambda: trainer.h_fn(batch))
    ms_step = host_ms(torch, lambda: trainer.step(batch, trainer.baseline))
    print(f"epoch stages (host clock, batch 256): sample {ms_sample:.2f} ms | "
          f"energy (nested-jvp Laplacian) {ms_energy:.2f} ms | train step "
          f"(loss incl. energy, backward, clip, adam) {ms_step:.2f} ms",
          flush=True)
    profile_window(torch, lambda: trainer.train_window(10, trainer.baseline),
                   10, "graphed window: ", top=10)

    # ---- 6-27: the phase table ---------------------------------------------
    by_phase = {'train-256': dict(launches)}
    rows = {}
    for name, run in phase_table(torch, params, jax_raw, jax_clipped,
                                 wps_second, k3[('I', 512)]['ms'],
                                 k1_streamed, nan):
        t0 = time.perf_counter()
        launches_of, rows[name] = run()
        if launches_of is not None:
            by_phase[name] = launches_of
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall", flush=True)
    end_walker_mesh()
    vmap_row = rows['vmap']

    # ---- 28. density (the second main path; counts reset just before) ------
    by_phase['density-20k'] = density_phase(torch)
    launches.update(by_phase['density-20k'])

    def by_path(name):
        """A kernel's launches on each path that ran it."""
        return {k: v[name] for k, v in by_phase.items() if v.get(name)}

    # ---- 29. report --------------------------------------------------------
    # each row at the shape its main path gives the kernel: K1 and K3 at the
    # training batch of 256, K2 at the 20,000 model draws of a metric
    # checkpoint, K4 at the flattened (20,000, 2) training batch
    k3_row, k4_row = k3[('I', 512)], k4[(0, 2 * DENSITY_POINTS)]
    # the pair entry at the shape train-256 under 'table' gives it: the
    # IMADE layers' I-spline tables, 256 walkers x 2 coordinates
    tk = rows['table-kernels']
    pair_row = tk[('I-spline', 512)]
    # the jet entry at the same shape: an IMADE site's 15 terms
    jet_row = tk[('jet', 'I-spline', 512)]
    # the backward jet entry at the same shape: an IMADE site's backward
    bwd_jet_row = tk[('bwd_jet', 'backward', 'I-spline', 512)]
    k4b_row = k4b[(0, 2 * DENSITY_POINTS)]

    def sampler_row(name, rows, shape):
        # max_abs_err: every compared draw, the right tail's included;
        # tail_*: the u > 1 - 1e-4 draws alone, against the f32 plain draw
        # and as probability from the float64 quantile (kernel, f32 plain)
        row, tail = rows[shape], rows['tail']
        return dict(name=name, route='cuda',
                    source='waveflow_tpu_torch/csrc/sampler.cu',
                    replaces='waveflow_tpu/ops/pallas_sampler.py:63',
                    launches=launches[name],
                    launches_by_path=by_path(name),
                    max_abs_err=max(r['max_abs_err'] for r in rows.values()),
                    ms=row['ms'], device_ms=row['device_ms'],
                    plain_ms=row['plain_ms'],
                    bound_ms=row['bound_ms'], bound_by=row['bound_by'],
                    library_ms=None, tail_max_abs_err=tail['max_abs_err'],
                    tail_quantile_err=tail['quantile_err'],
                    tail_plain_quantile_err=tail['plain_quantile_err'])

    def streamed(B):
        # K1 on the big ansatz's 36-base prior table (the SR study's big
        # rows), beside the staged 28-base table at the same batch
        row, staged = k1_streamed[('streamed', B)], k1_streamed[('staged', B)]
        return dict(max_abs_err=row['max_abs_err'], ms=row['ms'],
                    device_ms=row['device_ms'], plain_ms=row['plain_ms'],
                    bound_ms=row['bound_ms'], bound_by=row['bound_by'],
                    library_ms=None, regime=row['plan'].regime,
                    staged_ms=staged['ms'],
                    staged_device_ms=staged['device_ms'])

    kernels = [
        dict(sampler_row('sampler', k1, 256),
             streamed_36_bases={B: streamed(B) for B in STUDIES_K1_BATCHES},
             nan_check={k: v for k, v in nan['samplers'].items()
                        if k.startswith('K1')}),
        dict(sampler_row('sampler_linear', k2, DENSITY_POINTS),
             nan_check={k: v for k, v in nan['samplers'].items()
                        if k.startswith('K2')}),
        dict(name='basis_jet', route='cuda',
             source='waveflow_tpu_torch/csrc/basis_jet.cu',
             replaces='waveflow_tpu/ops/pallas_jet.py:63',
             launches=launches['basis_jet'],
             launches_by_path=by_path('basis_jet'),
             max_abs_err=max(r['max_abs_err'] for r in k3.values()),
             ms=k3_row['ms'], device_ms=k3_row['device_ms'],
             plain_ms=k3_row['plain_ms'],
             bound_ms=k3_row['bound_ms'], bound_by=k3_row['bound_by'],
             library_ms=k3_row['library_ms'],
             library_device_ms=k3_row['library_device_ms'],
             nan_check={'sites': nan['k3'], 'timing': nan['k3_timing']},
             vmap_grad=vmap_row, laplacian_forms=rows['lap-forms'],
             reference_grad=rows['reference-grad']),
        dict(name='spline_eval', route='cuda',
             source='waveflow_tpu_torch/csrc/spline_eval.cu',
             replaces='waveflow_tpu/ops/pallas_spline.py:29',
             launches=launches['spline_eval'],
             launches_by_path=by_path('spline_eval'),
             max_abs_err=max(r['max_abs_err'] for r in k4.values()),
             ms=k4_row['ms'], device_ms=k4_row['device_ms'],
             plain_ms=k4_row['plain_ms'],
             bound_ms=k4_row['bound_ms'], bound_by=k4_row['bound_by'],
             library_ms=None, onehot_matmul_ms=k4_row['onehot_ms'],
             vmap=rows['k4-vmap']['forward'],
             grad_of_grad=tk['menu']['grad-of-grad forward'],
             forward_mode=dict(step_mode_abs_err=tk['max_abs_err']['step'],
                               chain_abs_err=tk['max_abs_err']['chain'],
                               bisect_abs_err=tk['max_abs_err']['bisect'],
                               step_mode_8192=tk[('step', 'OB prior',
                                                  8192)],
                               hpsi=rows['table-hpsi'])),
        dict(name='spline_eval_pair', route='cuda',
             source='waveflow_tpu_torch/csrc/spline_eval.cu',
             replaces='waveflow_tpu/ops/pallas_spline.py:29',
             launches=by_phase['graph-table']['spline_eval_pair'],
             launches_by_path=by_path('spline_eval_pair'),
             max_abs_err=tk['max_abs_err']['pair'],
             ms=pair_row['ms'], device_ms=pair_row['device_ms'],
             plain_ms=pair_row['plain_ms'], bound_ms=pair_row['bound_ms'],
             bound_by=pair_row['bound_by'], library_ms=None),
        dict(name='spline_eval_jet', route='cuda',
             source='waveflow_tpu_torch/csrc/spline_eval.cu',
             replaces='waveflow_tpu/ops/pallas_spline.py:29',
             launches=by_phase['graph-table']['spline_eval_jet'],
             launches_by_path=by_path('spline_eval_jet'),
             max_abs_err=tk['max_abs_err']['jet'],
             ms=jet_row['ms'], device_ms=jet_row['device_ms'],
             plain_ms=jet_row['plain_ms'], bound_ms=jet_row['bound_ms'],
             bound_by=jet_row['bound_by'], library_ms=None,
             per_call_ms=jet_row['per_call_ms'],
             per_call_device_ms=jet_row['per_call_device_ms'],
             per_call_launches=jet_row['per_call_launches']),
        dict(name='spline_eval_bwd_jet', route='cuda',
             source='waveflow_tpu_torch/csrc/spline_eval.cu',
             replaces='waveflow_tpu/ops/pallas_spline.py:29',
             launches=by_phase['graph-table']['spline_eval_bwd_jet'],
             launches_by_path=by_path('spline_eval_bwd_jet'),
             max_abs_err=tk['max_abs_err']['bwd_jet'],
             ms=bwd_jet_row['ms'], device_ms=bwd_jet_row['device_ms'],
             plain_ms=bwd_jet_row['plain_ms'],
             bound_ms=bwd_jet_row['bound_ms'],
             bound_by=bwd_jet_row['bound_by'], library_ms=None,
             per_call_ms=bwd_jet_row['per_call_ms'],
             per_call_device_ms=bwd_jet_row['per_call_device_ms'],
             per_call_launches=bwd_jet_row['per_call_launches'],
             vmap_fold=tk['menu']['vmap-fold backward jet']),
        dict(name='spline_eval_bwd', route='cuda',
             source='waveflow_tpu_torch/csrc/spline_eval.cu',
             replaces='waveflow_tpu/ops/pallas_spline.py:29',
             launches=launches['spline_eval_bwd'],
             launches_by_path=by_path('spline_eval_bwd'),
             max_abs_err=max(r['max_abs_err'] for r in k4b.values()),
             g_coeffs_abs_err=k4b_row['g_coeffs_abs_err'],
             g_x_abs_err=k4b_row['g_x_abs_err'],
             step_mode_abs_err=tk['max_abs_err']['bwd'],
             ms=k4b_row['ms'], device_ms=k4b_row['device_ms'],
             plain_ms=k4b_row['plain_ms'],
             bound_ms=k4b_row['bound_ms'], bound_by=k4b_row['bound_by'],
             library_ms=None, vmap=rows['k4-vmap']['backward'],
             step_g_x=tk['menu']['step g_x backward'],
             grad_of_grad=tk['menu']['grad-of-grad backward'],
             vmap_fold=tk['menu']['vmap-fold backward']),
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, the "
          "build included", flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
