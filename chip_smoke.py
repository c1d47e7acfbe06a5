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
               basis jet at the flagship's shapes, K2 sampler 'linear' and
               K4 table-lerp evaluation with its backward kernel at the
               density model's (K4 also at ragged sizes, on a table of 13
               bases and on unaligned views); K1 also on
               a table too large for shared memory (the streamed regime)
               and on meshes that take the kernel's other branches;
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
               of GRAPH_WINDOW epochs (CUDA events); losses, parameters,
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
               (walkers and accept rates compared too);
  9. mala    — he1d_mala_s3 evaluated at the JAX protocol (clipped mean
               within 5 combined stderr of the JAX figure; raw reported),
               then resumed with sampler='mala' for one window of 100
               epochs: finite losses, accept rate in [0.3, 0.7], K3
               launched, walkers/s;
 10. spring, sr — r4_spring100k evaluated (raw and clipped gated) and
               resumed with optimizer='spring' for 100 epochs (SPRING's
               skipped / fallbacks counters, K3 launches per step, 3
               epochs profiled); he1d_sr resumed with optimizer='sr' for 20
               (1 more profiled);
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
               one window of 20 epochs each: finite losses, the baseline
               equal to the window's mean loss, walkers/s, 5 epochs
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
               eager twin, as graph-train (walkers and accept rates to the
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
               example MFlow's 10,816 parameters, depth cut: gradient
               evaluations per second, ms per step, tree depth, accept,
               step size, K4 1 + 1 launches per gradient, the idle share of
               a profiled stretch, held-out LL at init and under the BMA
               (finite, above the init's);
 27. nuts-waveflow — HMC and NUTS over He-1d walkers of the 100k
               checkpoint on the sorted sector, 256 chains warm-started at
               K1 ancestral draws: pooled moments within 0.25 of the
               ancestral ones (JAX's test_hmc_stationary_on_waveflow), K3 4
               launches per density call, chain-gradients per second;
 28. density — train_density_model at the full width of the density
               benchmark (MFlow, circles, 20,000 points), 200 epochs with a
               metric checkpoint every 100; losses finite and falling, K2
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
               forward kernel in step mode (slope tables), the pair entry,
               the backward kernel with step-mode tables and without
               coefficients, at N = 1 ... 40,001; then every order's value,
               first and second jvp (coefficients moving with x) and both
               outputs of ``pair``, kernel chain against the plain chain,
               no plain lerp run on the card; the pair entry, the step
               mode and the backward kernel on step-mode tables and
               without coefficients timed at N = 512, 8,192, 40,000;
 39. table-hpsi — the 100k checkpoint under 'table', Hψ at 4,096 K1
               walkers under every Laplacian form: K4 launches per pass
               equal to the evaluations the same pass makes on the CPU;
               'fwd_batched' against the plain chain on the card
               (TABLE_HPSI_RTOL); E_L against 'poly_pallas' on the same
               walkers within the float64 interpolation error
               (TABLE_POLY_EL_BOUND, TABLE_POLY_EL_MEAN_BOUND);
 40. table-eval — the 100k checkpoint under 'table' at the JAX protocol,
               graphed: raw and clipped beside the JAX 'poly' figures (a
               record), accept rate, K1 and K4 launched;
 41. graph-table — train-256 under 'table' graphed against its eager twin
               (to the bit, K1 and K4 launches per replayed epoch), then ms
               per replayed epoch against 'poly_pallas' in turns;
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


def check_sampler(torch, gen, kind, ev, coeffs_of, B_max):
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
    2 ulps of u."""
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
    for B in (256, B_max, 'tail') + ragged:
        errs = []
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
        if err > 6e-5:
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


def check_basis_jet(torch, ops, tabs_i, tabs_b, gen):
    """K3 against the plain core, and its derivative rules against the
    plain backend, for the I-spline (29 bases) and OB (28 bases) jets: at
    R = 512 and 131,072 (timed), and at ragged sizes on both sides of the
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
        for R in (512, 131072):
            x = torch.rand((R,), generator=gen, device='cuda') * 1.1 - 0.05
            out_k = cuda_jet.basis_jet_cuda(x, A, nc, k)
            out_p = cuda_jet.basis_jet_plain(x, A, nc, k)
            full_k, full_p = ev_k.basis_jet(x), ev_p.basis_jet(x)
            torch.cuda.synchronize()
            for a, b, what in ((out_k, out_p, 'core'), (full_k, full_p, 'jet')):
                if not torch.allclose(a, b, rtol=2e-5, atol=2e-4):
                    fail(f"K3 {label} {what} R={R} disagrees: max "
                         f"{(a - b).abs().max().item():.3e}")
            err = (out_k - out_p).abs().max().item()
            W = torch.zeros((R, nc * k), device='cuda')
            k_ms = cuda_ms(torch, lambda: cuda_jet.basis_jet_cuda(x, A, nc, k))
            d_ms = device_ms(torch, lambda: cuda_jet.basis_jet_cuda(x, A, nc, k))
            p_ms = cuda_ms(torch, lambda: cuda_jet.basis_jet_plain(x, A, nc, k))
            lib_ms = cuda_ms(torch, lambda: torch.matmul(W, A))
            lib_d_ms = device_ms(torch, lambda: torch.matmul(W, A))
            N = A.shape[1]
            b_ms, b_by = bound_ms(4 * (R + A.numel() + R * N), 2 * R * N * k)
            rows[(label, R)] = dict(max_abs_err=err, ms=k_ms, device_ms=d_ms,
                                    plain_ms=p_ms, library_ms=lib_ms,
                                    library_device_ms=lib_d_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    plan=cuda_jet.last_plan)
            print(f"K3 basis_jet {label} R={R}: max|d| {err:.3e} "
                  f"(rtol 2e-5, atol 2e-4) | kernel_ms {k_ms:.4f} device_ms "
                  f"{d_ms:.4f} plain_ms {p_ms:.4f} library_ms {lib_ms:.4f} "
                  f"library_device_ms {lib_d_ms:.4f} (matmul of a built W) "
                  f"bound_ms {b_ms:.5f} ({b_by})", flush=True)
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
           'spline_eval_bwd_kernel')
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
    baseline, parameters, Adam state, generator, walkers, accept rates."""
    out = {'losses': torch.tensor(t.losses, dtype=torch.float64),
           'baseline': t.baseline, 'generator': t.generator.get_state()}
    out.update({f'param {k}': v for k, v in t.model.state_dict().items()})
    for i, st in t.step.optimizer.state_dict()['state'].items():
        out.update({f'adam {i} {k}': v for k, v in st.items()})
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


def graph_twins(torch, label, make, window_call, read=None, reset=None,
                required=('basis_jet',)):
    """A trainer on the graph path and its eager twin (``graph=False``),
    both from one state (``make(graph)``): turns of two windows of
    GRAPH_WINDOW epochs in the order eager, graph, graph, eager, each timed
    by CUDA events with its kernel launches counted (the first graph turn
    holds the warm-up epoch and the capture); then everything the two
    carry compared (to the bit, or within GRAPH_MAX_REL), launches per
    epoch compared, and 10 epochs of ``window_call(trainer, 10)`` (the
    graph replayed) profiled.  ``read`` / ``reset`` are the launch
    counters (K1 and K3 unless given), ``required`` the kernels the
    replays must launch."""
    eager, graphed = make(False), make(None)
    if eager.graph or not graphed.graph:
        fail(f"{label}: the twins' graph flags are {eager.graph}, "
             f"{graphed.graph}")
    read, reset = read or read_counts, reset or reset_counts
    n_turn = 2 * GRAPH_WINDOW
    ms = {'eager': [], 'graph': []}
    counts = {kind: dict.fromkeys(read(), 0) for kind in ms}
    for kind, t in (('eager', eager), ('graph', graphed), ('graph', graphed),
                    ('eager', eager)):
        reset()
        _, dt = events_ms(torch, lambda: t.train(n_turn, verbose=False))
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
    out = dict(eager_ms_per_epoch=eager_ms, graph_ms_per_epoch=graph_ms,
               graph_first_turn_ms_per_epoch=first_ms,
               eager_walkers_per_s=B / eager_ms * 1e3,
               graph_walkers_per_s=B / graph_ms * 1e3,
               speedup=eager_ms / graph_ms, turns_ms=ms, bitwise=bitwise,
               max_rel_diff=rel, rel_diff_by_group=by_group,
               launches_per_epoch=per_epoch)
    if graphed.accept_rates:
        out['accept_rate'] = sum(graphed.accept_rates[-n_ep:]) / n_ep
    print(f"{label}: eager, graph, graph, eager turns of 2 x "
          f"{GRAPH_WINDOW} epochs at batch {B} (CUDA events): "
          f"{' / '.join(f'{v:.1f}' for v in ms['eager'][:1] + ms['graph'] + ms['eager'][1:])} ms "
          f"| eager {eager_ms:.3f} ms per epoch, {out['eager_walkers_per_s']:.1f}"
          f" walkers/s | graph {graph_ms:.3f} ms per epoch (replays; "
          f"first turn {first_ms:.3f} with the warm-up and the capture), "
          f"{out['graph_walkers_per_s']:.1f} walkers/s, {out['speedup']:.2f}x "
          f"| graph against eager after {n_ep} epochs: "
          f"{'equal to the bit' if bitwise else 'NOT bitwise'} (largest "
          f"relative difference {rel:.3e}; by kind "
          f"{ {k: f'{v:.2e}' for k, v in by_group.items()} }) | launches per epoch eager "
          f"{per_epoch['eager']}, graph {per_epoch['graph']}"
          + (f" | mean accept rate {out['accept_rate']:.4f}"
             if 'accept_rate' in out else ""), flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: the graphed run produced non-finite losses")
    if not (bitwise or rel <= GRAPH_MAX_REL):
        fail(f"{label}: the graph differs from its eager twin by {by_group} "
             f"relative (limit {GRAPH_MAX_REL:g})")
    if per_epoch['graph'] != per_epoch['eager']:
        fail(f"{label}: launches per epoch differ: {per_epoch}")
    missing = [k for k in required if counts['graph'][k] == 0]
    if missing:
        fail(f"{label}: {missing} not launched by the graph's replays")
    out['profile'] = prof = profile_window(
        torch, lambda: window_call(graphed, 10), 10,
        f"{label} graphed window ", top=10)
    # the profiler slows the host's side of a replay: the idle share of an
    # unprofiled replay is the profiled busy time against the events' time
    out['idle_unprofiled'] = 1 - prof['busy_ms'] / 10 / graph_ms
    print(f"{label}: device busy {prof['busy_ms'] / 10:.3f} ms per replayed "
          f"epoch (profiler) against {graph_ms:.3f} ms per epoch unprofiled "
          f"(CUDA events): idle share {out['idle_unprofiled']:.4f}",
          flush=True)
    return counts['graph'], out


def graph_train_phase(torch):
    """The ancestral adam window as a CUDA graph against its eager twin,
    from the 100k checkpoint with its Adam moments: train-256 (the main
    path), reference-256 (the reference design, 'reference' + 'dense';
    its backward runs on the calling thread, vmc/estimators.py, so its first
    run of a process equals later ones) and the 'reference' estimator on
    the main path's Laplacian (its running baseline through the graph's
    buffer)."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    rows, total = {}, {'sampler': 0, 'basis_jet': 0}
    for label, extra in (
            ('train-256', {}),
            ('reference-256', dict(estimator='reference',
                                   laplacian_mode='dense')),
            ('reference-256 fwd_batched', dict(estimator='reference'))):
        def make(graph, extra=extra):
            t = VMCTrainer(VMCConfig(batch_size=256, window=GRAPH_WINDOW,
                                     log_every=GRAPH_WINDOW,
                                     eval_backend='poly_pallas',
                                     device='cuda', **extra), graph=graph)
            if not t.load_checkpoint(str(CHECKPOINT.parent)):
                fail(f"no checkpoint under {CHECKPOINT.parent}")
            return t
        launches, rows[label] = graph_twins(
            torch, f"graph-train {label}", make,
            lambda t, n: t.train_window(n, t.baseline))
        if launches['sampler'] == 0:
            fail(f"graph-train {label}: K1 was not launched by the replays")
        total = {k: total[k] + v for k, v in launches.items()}
    return total, rows


def graph_metropolis_phase(torch):
    """The Metropolis adam window as a CUDA graph against its eager twin,
    from he1d_metropolis_seed7 with its walkers and Adam moments."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    def make(graph):
        t = VMCTrainer(VMCConfig(batch_size=256, window=GRAPH_WINDOW,
                                 log_every=GRAPH_WINDOW, sampler='metropolis',
                                 eval_backend='poly_pallas', device='cuda'),
                       graph=graph)
        if not t.load_checkpoint(str(METROPOLIS_RUN)):
            fail(f"no checkpoint under {METROPOLIS_RUN}")
        return t
    launches, row = graph_twins(
        torch, "graph-metropolis metropolis-256", make,
        lambda t, n: t.mcmc_window(t.mcmc_state, n, t.baseline, t.generator))
    return launches, {'metropolis-256': row}


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
    with the kernel backend: finite losses, walkers/s (host clock), the
    MCMC accept rate, SPRING's counters, launches per epoch; ``profile``
    further epochs under the profiler."""
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
          f"walkers/s {wps:.1f} (host clock){extra} | launches per epoch: "
          f"sampler {launches['sampler'] / n_epochs:g}, basis_jet "
          f"{launches['basis_jet'] / n_epochs:g}", flush=True)
    if len(losses) != n_epochs or not all(math.isfinite(v) for v in losses):
        fail(f"{label} produced non-finite losses")
    if 'accept_rate' in out and not 0.3 <= out['accept_rate'] <= 0.7:
        fail(f"{label} mean accept rate {out['accept_rate']} outside "
             "[0.3, 0.7]")
    if launches['basis_jet'] == 0:
        fail(f"K3 was not launched in {label}")
    if profile:
        profile_window(torch, lambda: t.train(profile, verbose=False),
                       profile, f"{label} ")
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
    from the 100k checkpoint: one window of 20 epochs at batch 256, then
    5 epochs profiled; and one window of 20 of 'reference' on
    'fwd_batched'.  Every loss finite; the window's baseline equal to the
    bit to the mean of its losses; walkers/s and launches per epoch."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    rows, total = {}, {'sampler': 0, 'basis_jet': 0}
    for mode in ('dense', 'fwd_batched'):
        t = VMCTrainer(VMCConfig(batch_size=256, window=20, log_every=20,
                                 estimator='reference', laplacian_mode=mode,
                                 eval_backend='poly_pallas', device='cuda'))
        if not t.load_checkpoint(str(CHECKPOINT.parent)):
            fail(f"no checkpoint under {CHECKPOINT.parent}")
        n0 = len(t.losses)
        reset_counts()
        t0 = time.perf_counter()
        t.train(20, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        losses = t.losses[n0:]
        mean = torch.tensor(losses, device='cuda').mean()
        wps = 20 * 256 / wall
        rows[mode] = dict(walkers_per_s=wps, wall_s=wall, last_loss=losses[-1],
                          launches_per_epoch={k: v / 20
                                              for k, v in launches.items()})
        print(f"reference-256 {mode}: 20 epochs at batch 256 from the 100k "
              f"checkpoint, losses finite: "
              f"{all(math.isfinite(v) for v in losses)}, last "
              f"{losses[-1]:.5f}, baseline {t.baseline.item():.6f} "
              f"(= the window's mean loss: {torch.equal(t.baseline, mean)}) "
              f"| walkers/s {wps:.1f} (host clock) | launches per epoch: "
              f"sampler {launches['sampler'] / 20:g}, basis_jet "
              f"{launches['basis_jet'] / 20:g}", flush=True)
        if len(losses) != 20 or not all(math.isfinite(v) for v in losses):
            fail(f"reference-256 {mode} produced non-finite losses")
        if not torch.equal(t.baseline, mean):
            fail(f"reference-256 {mode}: baseline {t.baseline.item()} is not "
                 f"the window's mean loss {mean.item()}")
        if min(launches.values()) == 0:
            fail(f"a kernel of the path was not launched in reference-256 "
                 f"{mode}: {launches}")
        total = {k: total[k] + v for k, v in launches.items()}
        if mode == 'dense':
            profile_window(torch, lambda: t.train(5, verbose=False), 5,
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
        density_step, get_benchmark_model, metric_checkpoint)
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

    # where an epoch's time goes: host clock per stage, then a profiled window
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
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

    def epochs(n):
        for _ in range(n):
            density_step(model, opt, X_dev)

    # a second block of 100 epochs, warm, without its checkpoint
    ms_epoch = host_ms(torch, lambda: epochs(100), n=1) / 100
    print(f"density: points/s {DENSITY_POINTS / ms_epoch * 1e3:.1f} (a "
          f"further block of 100 epochs, {ms_epoch:.2f} ms per epoch)",
          flush=True)
    profile_window(torch, lambda: epochs(10), 10, "density ")
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


def graph_2d_phase(torch, label, run_dir, config, window_call, k1_per_epoch):
    """A 2D window as a CUDA graph against its eager twin from a committed
    run (``graph_twins``: turns eager, graph, graph, eager of 2 windows of
    GRAPH_WINDOW epochs, everything to the bit, launches per epoch equal,
    10 replays profiled), K1's launches per epoch held to
    ``k1_per_epoch``; then one graphed window of 100 epochs timed by CUDA
    events."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    def make(graph, window=GRAPH_WINDOW):
        t = VMCTrainer(VMCConfig(batch_size=256, window=window,
                                 log_every=window, eval_backend='poly_pallas',
                                 device='cuda', **config), graph=graph)
        if not t.load_checkpoint(str(run_dir)):
            fail(f"no checkpoint under {run_dir}")
        return t
    launches, row = graph_twins(torch, label, make, window_call)
    k1 = row['launches_per_epoch']['graph']['sampler']
    if k1 != k1_per_epoch:
        fail(f"{label}: K1 launched {k1} times per epoch, not {k1_per_epoch}")
    t = make(None, window=100)
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


def posterior_example():
    """examples/parameter_posterior_torch.py as a module: its model
    settings and ``run_posterior``."""
    import importlib.util
    path = ROOT / 'examples' / 'parameter_posterior_torch.py'
    spec = importlib.util.spec_from_file_location('parameter_posterior_torch',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    n, unit = (1, 'temperatures') if sampler == 'smc' else (2, 'steps')
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
             f"{fig['max_tree_depth']})" if sampler == 'nuts' else '')
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


def nuts_waveflow_phase(torch, params):
    """HMC and NUTS over He-1d walkers of the 100k checkpoint on the sorted
    sector (JAX's test_hmc_stationary_on_waveflow: the density clipped into
    the open box and sorted), 256 chains warm-started at K1 ancestral
    draws, depth cut: the pooled moments of the kept draws within 0.25 of
    4,096 ancestral draws'.  K3 launches per density call (4: the 3 IMADE
    layers and the prior) and chain-gradients per second: the rows of the
    density calls that take a gradient, over the wall."""
    from waveflow_tpu_torch.vmc import make_hmc_sampler, make_nuts_sampler
    m = flagship_model(torch, params, 'poly_pallas')
    L = 10.0
    reset_counts()
    with torch.no_grad():
        anc = m.sample(4096, generator=torch.Generator('cuda').manual_seed(1))
    launches = read_counts()
    calls = [0, 0]      # density calls; the rows of those under a gradient

    def log_prob(x):
        calls[0] += 1
        if torch.is_grad_enabled():
            calls[1] += x.shape[0]
        return m.log_pdf(torch.sort(torch.clamp(x, -L + 1e-3, L - 1e-3),
                                    -1).values)

    out = {}
    for name, make, kw, cut in (
            ('hmc', make_hmc_sampler, dict(n_leapfrog=8), (30, 45)),
            ('nuts', make_nuts_sampler, dict(max_tree_depth=5), (20, 30))):
        init_fn, _, run_fn = make(log_prob, **kw)
        before, calls[:] = read_counts()['basis_jet'], [0, 0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = init_fn(anc[:WAVEFLOW_CHAINS], step_size=0.3)
        state, trace, info = run_fn(state, torch.Generator('cuda')
                                    .manual_seed(3), cut[1], cut[0],
                                    return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = read_counts()['basis_jet'] - before
        mc = torch.sort(torch.clamp(trace[cut[1] // 3:].reshape(-1, 2),
                                    -L, L), -1).values
        d_mean = (mc.mean(0) - anc.mean(0)).abs().max().item()
        d_std = (mc.std(0) - anc.std(0)).abs().max().item()
        row = dict(wall_s=wall, density_calls=calls[0],
                   k3_per_call=k3 / calls[0],
                   chain_grads_per_s=calls[1] / wall,
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


def dp_world1_phase(torch, label, run_dir, config, window_call):
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
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    def make(dp):
        t = VMCTrainer(VMCConfig(batch_size=256, window=GRAPH_WINDOW,
                                 log_every=GRAPH_WINDOW,
                                 eval_backend='poly_pallas', device='cuda',
                                 data_parallel=dp, **config))
        if not t.load_checkpoint(str(run_dir)):
            fail(f"no checkpoint under {run_dir}")
        return t
    plain, sharded = make(False), make(True)
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
            _, dt = events_ms(torch, lambda: window_call(t, GRAPH_WINDOW))
            replays[kind].append(dt / GRAPH_WINDOW)
    med = {k: sorted(v)[len(v) // 2] for k, v in replays.items()}
    overhead = med['sharded'] - med['plain']
    prof = {kind: collective_profile(
        torch, lambda: window_call(t, GRAPH_WINDOW), GRAPH_WINDOW)
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
        torch, 'dp-nccl-1 train-256', CHECKPOINT.parent, {},
        lambda t, n: t.train_window(n, t.baseline))
    if launches['sampler'] == 0:
        fail("dp-nccl-1: K1 was not launched by the sharded replays")
    return launches, row


def dp_metropolis_phase(torch):
    return dp_world1_phase(
        torch, 'dp-metropolis-1 metropolis-256', METROPOLIS_RUN,
        dict(sampler='metropolis'),
        lambda t, n: t.mcmc_window(t.mcmc_state, n, t.baseline, t.generator))


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
    """K1 and K4's three entry points (forward, pair, backward)."""
    from waveflow_tpu_torch.ops import cuda_sampler, cuda_spline
    return {'sampler': cuda_sampler.launches,
            'spline_eval': cuda_spline.launches,
            'spline_eval_pair': cuda_spline.launches_pair,
            'spline_eval_bwd': cuda_spline.launches_bwd}


def reset_table_counts():
    from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler, cuda_spline
    cuda_sampler.launches = cuda_jet.launches = 0
    cuda_spline.launches = cuda_spline.launches_pair = 0
    cuda_spline.launches_bwd = 0


class evaluations:
    """Within the block, the table evaluator's three launch points
    (ops/spline_eval.py) call K4's plain versions when ``plain``, else
    their own wrappers, and every call is counted in ``calls``, by entry
    point: the plain chain on the card, and the chain's evaluations counted
    on the CPU.  ``plain_calls`` counts the plain functions of
    ops/cuda_spline.py however they are reached."""

    def __init__(self, plain: bool):
        self.plain = plain
        self.calls = {'spline_eval': 0, 'spline_eval_pair': 0,
                      'spline_eval_bwd': 0}
        self.plain_calls = 0

    def __enter__(self):
        from waveflow_tpu_torch.ops import cuda_spline
        from waveflow_tpu_torch.ops import spline_eval as se
        self.saved = (se.spline_eval, se.spline_eval_pair, se.spline_eval_bwd,
                      cuda_spline.lerp_basis)
        fwd, pair, bwd, lerp = self.saved

        def plain_pair(ta, tb, c, x, sa=False, sb=False):
            return (cuda_spline.spline_eval_plain(ta, c, x, sa),
                    cuda_spline.spline_eval_plain(tb, c, x, sb))

        def plain_bwd(td, tx, c, x, g, nc=True, nx=True, sd=False, sx=False):
            gc, gx = cuda_spline.spline_eval_bwd_plain(td, tx, c, x, g, sd, sx)
            return gc if nc else None, gx if nx else None

        def counting(name, fn):
            def call(*args, **kw):
                self.calls[name] += 1
                return fn(*args, **kw)
            return call

        def counting_lerp(*args, **kw):
            self.plain_calls += 1
            return lerp(*args, **kw)

        chosen = ((cuda_spline.spline_eval_plain, plain_pair, plain_bwd)
                  if self.plain else (fwd, pair, bwd))
        se.spline_eval, se.spline_eval_pair, se.spline_eval_bwd = (
            counting(n, f) for n, f in zip(self.calls, chosen))
        # every plain version of K4 goes through the lerp of its rows
        cuda_spline.lerp_basis = counting_lerp
        return self

    def __exit__(self, *exc):
        from waveflow_tpu_torch.ops import cuda_spline
        from waveflow_tpu_torch.ops import spline_eval as se
        (se.spline_eval, se.spline_eval_pair, se.spline_eval_bwd,
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
    the backward kernel with step-mode tables and without coefficients;
    then the chain itself (every order's value, first and second jvp with
    the coefficients moving with x, both outputs of ``pair``) against the
    same chain on the plain versions, and no plain lerp run by the kernel
    chain.  The pair entry is timed against its plain version."""
    from waveflow_tpu_torch.ops import cuda_spline
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
    worst = {'step': 0.0, 'pair': 0.0, 'bwd': 0.0, 'chain': 0.0}
    rows = {}
    for name, ev in evs.items():
        cc = coeffs[name].reshape(-1, ev.n_bases)[:N_max + 1].contiguous()
        n_b, nd = ev.n_bases, ev.n_derivatives
        for N in (1, 3, 31, 512, 513, N_max, N_max + 1):
            c, xx, gg = cc[:N], x[:N], g[:N]
            for d in range(nd):
                T, S = ev.tables[d], ev.slopes[d]
                worst['step'] = max(worst['step'], rel_err(
                    cuda_spline.spline_eval_cuda(S, c, xx, step=True),
                    cuda_spline.spline_eval_plain(S, c, xx, step=True),
                    magnitude(torch, S, c, xx, True)))
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
                                       (None, False, False, None)):
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
            # the backward kernel as the table backend launches it: g·B on
            # the value table with g_x from the slope table in step mode,
            # and g·B alone (no coefficients, no g_x); bound by
            # check_spline_eval's rule, the step table's rows read once
            gg = g[:N]
            rows_l = table_rows(torch, ev.n_mesh, xx)
            rows_s = table_rows(torch, ev.n_mesh, xx, step=True)
            for form, tx, cx, bytes_, ops_ in (
                    ('step g_x', S0, c,
                     4 * (N * (3 + 2 * n_b) + (rows_l + rows_s) * n_b),
                     N * (5 * n_b + 7)),
                    ('no coeffs', None, None,
                     4 * (N * (3 + n_b) + rows_l * n_b), N * (3 * n_b + 6))):
                def bwd(tx=tx, cx=cx):
                    return cuda_spline.spline_eval_bwd_cuda(
                        T0, tx, cx, xx, gg, step_d1=tx is not None)

                def bwd_plain(tx=tx, cx=cx):
                    return cuda_spline.spline_eval_bwd_plain(
                        T0, tx, cx, xx, gg, False, tx is not None)

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
          f"step mode {worst['step']:.3e}, pair {worst['pair']:.3e}, "
          f"backward with step-mode tables / without coefficients "
          f"{worst['bwd']:.3e} against their plain versions, of max(1, the "
          "largest row's Σ|c||B|) (limit 2e-5)", flush=True)
    bad = {k: v for k, v in worst.items() if k != 'bisect' and not v <= 2e-5}
    if bad:
        fail(f"table-kernels: K4 disagrees with its plain versions: {bad}")
    rows['max_abs_err'] = worst
    return None, rows


def table_hpsi_phase(torch, params):
    """The 100k checkpoint under 'table': Hψ ('fwd_batched') at 4,096
    walkers drawn by K1, the K4 chain against the plain chain on the card
    (TABLE_HPSI_RTOL of max|Hψ|); K4 launches per Hψ pass against the
    count the same pass makes on the CPU (the code's own evaluations, 8
    walkers: the count does not depend on the batch); every Laplacian
    form's launches and ms per pass; E_L 'table' against 'poly_pallas' on
    the same walkers (TABLE_POLY_EL_BOUND)."""
    from waveflow_tpu_torch.models import get_waveflow_model
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
            if mode == 'fwd_batched':
                with evaluations(plain=True):
                    hp = h(x)[:, 0]
                scale = hp.abs().max().item()
                row['rel_err'] = (hk - hp).abs().max().item() / scale
                hk_main = hk
            rows[mode] = row
            print(f"table-hpsi {mode}: K4 launches per Hpsi pass at 4096 "
                  f"walkers: forward {per_pass['spline_eval']}, pair "
                  f"{per_pass['spline_eval_pair']}, backward "
                  f"{per_pass['spline_eval_bwd']} (the code's evaluations "
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
    big = psi_p.abs() > 0.05 * psi_p.abs().max()
    d = (e_t - e_p).abs()[big]
    rows['el_table_vs_poly'] = dict(max=d.max().item(), mean=d.mean().item(),
                                    walkers=int(big.sum()),
                                    poly_pallas_ms=ms_poly, k1=k1)
    print(f"table-hpsi: E_L 'table' against 'poly_pallas' on the same 4096 "
          f"walkers (|psi| > 0.05 max|psi|: {int(big.sum())}): max "
          f"{d.max().item():.4e} (bound {TABLE_POLY_EL_BOUND:g}), mean "
          f"{d.mean().item():.4e} (bound {TABLE_POLY_EL_MEAN_BOUND:g}) | "
          f"'poly_pallas' Hpsi pass {ms_poly:.2f} ms | K1 {k1} launches for "
          "the walkers", flush=True)
    if not (d.max().item() <= TABLE_POLY_EL_BOUND
            and d.mean().item() <= TABLE_POLY_EL_MEAN_BOUND):
        fail("table-hpsi: E_L under 'table' is further from 'poly' than the "
             "float64 interpolation error allows")
    # the path: the walkers' draw and one 'fwd_batched' Hψ pass, each read
    # just after its own reset (the later passes and timings are not it)
    launches = dict(rows['fwd_batched']['launches_per_pass'], sampler=k1)
    return launches, rows


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
            and launches['spline_eval_pair']):
        fail(f"table-eval: a kernel of the path was not launched: {launches}")
    return launches, row


def graph_table_phase(torch):
    """train-256 under 'table' (the flagship config from the 100k
    checkpoint): the graphed adam window against its eager twin, to the
    bit, K1 and K4 launches per replayed epoch; then ms per replayed epoch
    against the 'poly_pallas' twin, windows of 2 x 10 in turns table,
    poly, poly, table (CUDA events)."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    def trainer(graph, backend='table'):
        t = VMCTrainer(VMCConfig(batch_size=256, window=GRAPH_WINDOW,
                                 log_every=GRAPH_WINDOW, eval_backend=backend,
                                 device='cuda'), graph=graph)
        if not t.load_checkpoint(str(CHECKPOINT.parent)):
            fail(f"no checkpoint under {CHECKPOINT.parent}")
        return t

    launches, row = graph_twins(
        torch, "graph-table train-256", trainer,
        lambda t, n: t.train_window(n, t.baseline),
        read=table_counts, reset=reset_table_counts,
        required=('sampler', 'spline_eval', 'spline_eval_pair',
                  'spline_eval_bwd'))
    twins = {'table': trainer(None), 'poly_pallas': trainer(None,
                                                            'poly_pallas')}
    for t in twins.values():
        t.train(2 * GRAPH_WINDOW, verbose=False)      # warm-up and capture
    ms = {k: [] for k in twins}
    for k in ('table', 'poly_pallas', 'poly_pallas', 'table'):
        _, dt = events_ms(torch, lambda: twins[k].train(2 * GRAPH_WINDOW,
                                                        verbose=False))
        ms[k].append(dt / (2 * GRAPH_WINDOW))
    row['ms_per_replayed_epoch'] = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"graph-table: ms per replayed epoch, turns table / poly_pallas / "
          f"poly_pallas / table: {ms['table'][0]:.3f} / "
          f"{ms['poly_pallas'][0]:.3f} / {ms['poly_pallas'][1]:.3f} / "
          f"{ms['table'][1]:.3f} | table over poly_pallas "
          f"{row['ms_per_replayed_epoch']['table'] / row['ms_per_replayed_epoch']['poly_pallas']:.3f}x",
          flush=True)
    return launches, row


def circles_split():
    """benchmarks/circles_parity.py's split: 1,000 train, 2,000 held out."""
    from waveflow_tpu_torch.benchmark import get_dataset
    X = get_dataset('circles', 3000, margin=0.025, seed=42)
    return X[:1000], X[1000:]


def density_cut_phase(torch, label, X, X_test, n_epochs, model_name, **kw):
    """A density model trained by MLE on 1,000 points, ``n_epochs`` epochs
    with a metric checkpoint at the end (20,000 draws): losses finite and
    falling, the metrics finite, the round trip under 1e-4; K2 and K4
    launches; points/s over a further warm block of 100 epochs."""
    from waveflow_tpu_torch.benchmark import train_density_model
    from waveflow_tpu_torch.benchmark.density import density_step
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
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    X_dev = torch.as_tensor(X, device='cuda')

    def block():
        for _ in range(100):
            density_step(model, opt, X_dev)

    ms_epoch = host_ms(torch, block, n=1) / 100
    row = dict(first10=first, last10=last, test_ll=hist['test_ll'][-1],
               kl=hist['kl'][-1], hellinger=hist['hellinger'][-1],
               reconstruction=hist['reconstruction'][-1], wall_s=wall,
               points_per_s=len(X) / ms_epoch * 1e3, launches=launches)
    print(f"{label}: {model_name}, {n_epochs} epochs at batch {len(X)}: "
          f"first-10 mean loss {first:.5f} -> last-10 {last:.5f} | held-out "
          f"LL {row['test_ll']:.4f} KL {row['kl']:.4f} H2 "
          f"{row['hellinger']:.4f} recon {row['reconstruction']:.3e} | "
          f"{wall:.2f} s | points/s {row['points_per_s']:.1f} ({ms_epoch:.3f}"
          f" ms per epoch, a further warm block of 100) | launches "
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
                'spline_eval_bwd', 'spline_eval_pair')


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


def phase_table(torch, params, jax_raw, jax_clipped, ancestral_wps=None,
                k3_b2b_ms=None):
    """Phases 23, 38-39, 30-31, 6-27 and 32-37, 40-45 in order, as (name,
    run): run() ->
    (the kernel
    launches on that path, or None, and the phase's figures)."""
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
        # ---- 6-8. graphs against eager, evaluation, resume, Metropolis ----
        ('graph-train', lambda: graph_train_phase(torch)),
        ('eval-4k', lambda: evaluation_phase(torch, jax_raw, jax_clipped)),
        ('graph-eval', lambda: graph_eval_phase(torch)),
        ('resume', lambda: resume_phase(torch)),
        ('metropolis-256', lambda: metropolis_phase(torch, ancestral_wps)),
        ('graph-metropolis', lambda: graph_metropolis_phase(torch)),
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
            torch, 'graph-antisym', ANTISYM_RUN, ANTISYM_CONFIG,
            lambda t, n: t.mcmc_window(t.mcmc_state, n, t.baseline,
                                       t.generator), 0)),
        ('paired2d-256', lambda: graph_2d_phase(
            torch, 'paired2d-256', PAIRED2D_RUN, PAIRED2D_CONFIG,
            lambda t, n: t.train_window(n, t.baseline), 4)),
        # ---- 23-27. the probprog samplers ----
        ('posterior-hmc', lambda: posterior_phase(torch, 'hmc')),
        ('posterior-nuts', lambda: posterior_phase(torch, 'nuts')),
        ('posterior-smc', lambda: posterior_phase(torch, 'smc')),
        ('nuts-waveflow', lambda: nuts_waveflow_phase(torch, params)),
        # ---- 32-33. two gloo ranks on the card; the sharded posterior ----
        ('dp-gloo-2', lambda: dp_gloo_phase(torch)),
        ('posterior-sharded-1', lambda: posterior_phase(torch, 'hmc',
                                                        sharded=True)),
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
        # ---- 40-43. the table backend's evaluation and window; the
        # density side's new model and dataset ----
        ('table-eval', lambda: table_eval_phase(torch, jax_raw,
                                                jax_clipped)),
        ('graph-table', lambda: graph_table_phase(torch)),
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
             "graph-metropolis, mala-eval, ..., poly-sample, antisym-eval, "
             "..., paired2d-256, k4-vmap, posterior-hmc, posterior-nuts, "
             "posterior-smc, nuts-waveflow, dp-nccl-1, dp-metropolis-1, "
             "dp-gloo-2, posterior-sharded-1, be4-eval, box4-eval, "
             "li-2d-eval, h2-2d-eval, table-kernels, table-hpsi, "
             "table-eval, graph-table, rqs-density, gm-density, compat, "
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
    k3 = check_basis_jet(torch, ops, tabs_i, tabs_b, gen)
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
                                 wps_second, k3[('I', 512)]['ms']):
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

    kernels = [
        sampler_row('sampler', k1, 256),
        sampler_row('sampler_linear', k2, DENSITY_POINTS),
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
             library_ms=None, vmap=rows['k4-vmap']['backward']),
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
