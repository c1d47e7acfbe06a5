#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile every CUDA kernel of the path (one nvcc each, in
               parallel) into waveflow_tpu_torch/build/;
  3. kernels — hold each kernel against its plain PyTorch version on the
               card at the main path's shapes, and time kernel, plain
               version and (where one exists) a single library call;
  4. checkpoint — load the committed JAX flagship checkpoint, draw 65,536
               ancestral walkers and compute the mean local energy, which
               must agree with the JAX evaluation −1.815872(12);
  5. training — VMCTrainer at the flagship config with the CUDA basis-jet
               backend, 2 windows of 100 epochs at batch 256; every loss
               finite, both kernels launched on that run;
  6. report  — one JSON line of kernels, then the final status line.

Imports torch and the port only.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / 'results' / 'r5_flagship_fwd_batched_100k' / 'checkpoints'
E_JAX = -1.815872          # JAX frozen-params Metropolis evaluation (RESULTS.md)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
FLAGSHIP = dict(spline_degree=6, num_knots=23, n_mesh=2000)


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def quantile_err(torch, table_t, c, u, x):
    """|F(x) − u| in float64: how much probability lies between each draw x
    and the exact u-quantile of its own density (c · T)², T the table."""
    psi = c.double() @ table_t.double()
    n_cells = psi.shape[-1] - 1
    h = 1.0 / n_cells
    p_l = psi[..., :-1]
    d = psi[..., 1:] - p_l
    m = h * (p_l * p_l + p_l * d + d * d / 3.0)
    cdf = torch.cat([torch.zeros_like(m[..., :1]), torch.cumsum(m, -1)], -1)
    xd = x.double()
    j = torch.clamp(torch.floor(xd / h).long(), 0, n_cells - 1)
    s = xd / h - j

    def at(a):
        return torch.gather(a, -1, j[..., None])[..., 0]

    a, dd = at(p_l), at(d)
    f = (at(cdf) + h * (a * a * s + a * dd * s * s + dd * dd * s ** 3 / 3.0)
         ) / cdf[..., -1]
    return (f - u.double()).abs()


def check_sampler(torch, model, gen):
    """K1 against the plain sampler on the inputs the main path gives it:
    the checkpoint model's conditional OB coefficients of both ancestral
    columns, at the training batch (256) and at 65,536 walkers, with the
    u = 0 and u = 1 − 1e-7 walls among the draws, plus 4,096 draws per
    column in the thin right tail u ∈ (1 − 1e-4, 1 − 1e-7].

    Draws with u ≤ 1 − 1e-4 are held to the f32 plain draw at 6e-5 (the
    prefix sum's association order, ~0.1 mesh cell).  For u > 1 − 1e-4 the
    target lies within a few f32 ulps of the CDF total, where the rounding
    of either f32 prefix sum spans whole cells; there both f32 versions are
    held to a float64 plain draw on the same inputs, measured as the
    probability between the draw and the exact quantile: K1's largest must
    not exceed the f32 plain path's by more than 2 ulps of u."""
    import types
    from waveflow_tpu_torch.ops import cuda_sampler
    from waveflow_tpu_torch.ops.sampling import sample_squared_amplitude
    ev_ob = model.ev_ob
    ev_64 = types.SimpleNamespace(
        density_on_mesh=lambda cc, t=ev_ob.table_t.double(): cc @ t)
    n_b, n_mesh = ev_ob.table_t.shape
    B_max, n_tail = 65536, 4096
    u = torch.rand((2, B_max), generator=gen, device='cuda')
    u[:, :3] = 0.0
    u[:, 3:6] = 1.0 - 1e-7
    u_tail = 1.0 - 10.0 ** -(4.0 + 3.0 * torch.rand(
        (2, n_tail), generator=gen, device='cuda', dtype=torch.float64))
    u_tail = torch.clamp(u_tail.float(), max=1.0 - 1e-7)
    with torch.no_grad():
        c0 = model.ob_coeffs(torch.zeros((B_max, 2), device='cuda'))[:, 0]
        x0 = sample_squared_amplitude(ev_ob, c0, u[0], impl='plain')
        c1 = model.ob_coeffs(torch.stack([x0, torch.zeros_like(x0)], -1))[:, 1]
    rows, tail = {}, {'dx': [], 'k64': [], 'p64': [], 'qk': [], 'qp': []}
    for B in (256, B_max, 'tail'):
        errs = []
        for col, c in enumerate((c0, c1)):
            if B == 'tail':
                c, uu = c[:n_tail].contiguous(), u_tail[col]
            else:
                c, uu = c[:B].contiguous(), u[col, :B]
            x_k = sample_squared_amplitude(ev_ob, c, uu, impl='cuda')
            x_p = sample_squared_amplitude(ev_ob, c, uu, impl='plain')
            torch.cuda.synchronize()
            if not (x_k.min() >= 0 and x_k.max() <= 1):
                fail(f"K1 draws outside [0, 1] at B={B}")
            diff = (x_k - x_p).abs()
            t = uu > 1.0 - 1e-4
            errs.append(diff[~t])
            if t.any():
                ct, ut = c[t], uu[t]
                x64 = sample_squared_amplitude(ev_64, ct.double(), ut.double(),
                                               impl='plain')
                tail['dx'].append(diff[t])
                tail['k64'].append((x_k[t] - x64).abs())
                tail['p64'].append((x_p[t] - x64).abs())
                tail['qk'].append(quantile_err(torch, ev_ob.table_t, ct, ut, x_k[t]))
                tail['qp'].append(quantile_err(torch, ev_ob.table_t, ct, ut, x_p[t]))
        if B == 'tail':
            continue
        diff = torch.cat(errs)
        err, med = diff.max().item(), diff.median().item()
        if err > 6e-5:
            fail(f"K1 disagrees with its plain version at B={B}: max {err:.3e} "
                 "for u <= 1 - 1e-4 (atol 6e-5)")
        k_ms = cuda_ms(torch, lambda: cuda_sampler.sample_squared_amplitude_cuda(
            ev_ob, c, uu))
        p_ms = cuda_ms(torch, lambda: sample_squared_amplitude(
            ev_ob, c, uu, impl='plain'))
        n_cells = n_mesh - 1
        b_ms, b_by = bound_ms(4 * (B * n_b + 2 * B + n_b * n_mesh),
                              B * (2 * n_b * n_mesh + 8 * n_cells))
        rows[B] = dict(max_abs_err=err, median_abs_err=med, ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"K1 sampler B={B}: max|dx| {err:.3e} over u <= 1 - 1e-4 (atol "
              f"6e-5), median {med:.3e} | kernel_ms {k_ms:.4f} plain_ms "
              f"{p_ms:.4f} bound_ms {b_ms:.5f} ({b_by})", flush=True)
    t = {k: torch.cat(v).max().item() for k, v in tail.items()}
    n = sum(v.numel() for v in tail['dx'])
    print(f"K1 sampler tail: {n} draws with u > 1 - 1e-4 (walls included) | "
          f"max|dx| against the f32 plain draw {t['dx']:.3e} | against a "
          f"float64 plain draw: K1 {t['k64']:.3e}, f32 plain {t['p64']:.3e} | "
          f"max |F64(x) - u|: K1 {t['qk']:.3e}, f32 plain {t['qp']:.3e}",
          flush=True)
    if not t['qk'] <= t['qp'] + 2.0 ** -23:
        fail("K1's tail draws lie farther from the float64 quantile than the "
             f"f32 plain path's: {t['qk']:.3e} > {t['qp']:.3e} + 2^-23")
    rows['tail'] = dict(n=n, max_abs_err=t['dx'], k64=t['k64'], p64=t['p64'],
                        quantile_err=t['qk'], plain_quantile_err=t['qp'])
    return rows


def check_basis_jet(torch, ops, tabs_i, tabs_b, gen):
    """K3 against the plain core, and its derivative rules against the
    plain backend, for the I-spline (29 bases) and OB (28 bases) jets."""
    from waveflow_tpu_torch.ops import cuda_jet
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
            p_ms = cuda_ms(torch, lambda: cuda_jet.basis_jet_plain(x, A, nc, k))
            lib_ms = cuda_ms(torch, lambda: torch.matmul(W, A))
            N = A.shape[1]
            b_ms, b_by = bound_ms(4 * (R + A.numel() + R * N), 2 * R * N * k)
            rows[(label, R)] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                    library_ms=lib_ms, bound_ms=b_ms,
                                    bound_by=b_by)
            print(f"K3 basis_jet {label} R={R}: max|d| {err:.3e} "
                  f"(rtol 2e-5, atol 2e-4) | kernel_ms {k_ms:.4f} plain_ms "
                  f"{p_ms:.4f} library_ms {lib_ms:.4f} (matmul of a built W) "
                  f"bound_ms {b_ms:.5f} ({b_by})", flush=True)
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


def main() -> int:
    import torch

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
    from waveflow_tpu_torch.models import get_waveflow_model
    from waveflow_tpu_torch.ops import cuda_build, cuda_jet, cuda_sampler
    from waveflow_tpu_torch.physics import (
        construct_hamiltonian_function, system_catalogue)
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    report = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, (secs, log) in report.items():
        print(f"  {name}.cu: {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f"    {line.strip()}", flush=True)

    # ---- 3. kernels against their plain versions --------------------------
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    tabs_b = ops.get_tables('B', deg, knots, n_mesh=mesh)
    tabs_i = ops.get_tables('I', deg, knots, n_mesh=mesh)
    ck = load_jax_checkpoint(CHECKPOINT)
    model = get_waveflow_model(
        2, base_spline_degree=deg, i_spline_degree=deg,
        n_prior_internal_knots=knots, n_i_internal_knots=knots,
        i_spline_reg=0.05, n_flow_layers=3, box_size=10.0,
        eval_backend='poly_pallas', generator=torch.Generator().manual_seed(0),
        device='cuda')
    model.load_state_dict(params_from_jax(ck['params']))
    gen = torch.Generator('cuda').manual_seed(0)
    k1 = check_sampler(torch, model, gen)
    k3 = check_basis_jet(torch, ops, tabs_i, tabs_b, gen)

    # ---- 4. checkpoint ----------------------------------------------------
    protons, _ = system_catalogue[1]['He']
    h_fn = construct_hamiltonian_function(model.psi, protons=protons,
                                          n_space_dimensions=1)
    t0 = time.perf_counter()
    with torch.no_grad():
        x = model.sample(65536, generator=torch.Generator('cuda').manual_seed(7))
        e_loc = h_fn(x)[:, 0] / model.psi(x)
    torch.cuda.synchronize()
    mean = e_loc.mean().item()
    stderr = (e_loc.std() / math.sqrt(e_loc.numel())).item()
    print(f"checkpoint (epoch {ck['epoch']}): E = {mean:.6f} +- {stderr:.6f} "
          f"over 65536 ancestral walkers ({time.perf_counter() - t0:.2f} s); "
          f"JAX evaluation {E_JAX}", flush=True)
    if not (math.isfinite(mean) and abs(mean - E_JAX) <= 5 * stderr + 2e-3):
        fail(f"checkpoint energy {mean} outside {E_JAX} +- (5 stderr + 2e-3)")

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

    def host_ms(fn, n=20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    with torch.no_grad():
        ms_sample = host_ms(lambda: trainer.sample(256))
        ms_energy = host_ms(lambda: trainer.h_fn(batch))
    ms_step = host_ms(lambda: trainer.step(batch))
    print(f"epoch stages (host clock, batch 256): sample {ms_sample:.2f} ms | "
          f"energy (nested-jvp Laplacian) {ms_energy:.2f} ms | train step "
          f"(loss incl. energy, backward, clip, adam) {ms_step:.2f} ms",
          flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(10, verbose=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profiled 10 epochs: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
          f"{sum(e.count for e in kern) / 10:.0f} kernel launches per epoch",
          flush=True)
    for e in kern[:8]:
        print(f"  {e.self_device_time_total / 1e3 / 10:8.4f} ms/epoch "
              f"{e.count / 10:6.1f}/epoch  {e.key[:90]}", flush=True)

    # ---- 6. report ---------------------------------------------------------
    k1_row, k3_row, k1_tail = k1[256], k3[('I', 512)], k1['tail']
    kernels = [
        # max_abs_err: every compared draw, the right tail's included;
        # tail_*: the u > 1 - 1e-4 draws alone, against the f32 plain draw
        # and as probability from the float64 quantile (K1, f32 plain)
        dict(name='sampler', route='cuda',
             source='waveflow_tpu_torch/csrc/sampler.cu',
             replaces='waveflow_tpu/ops/pallas_sampler.py:63',
             launches=launches['sampler'],
             max_abs_err=max(r['max_abs_err'] for r in k1.values()),
             ms=k1_row['ms'], plain_ms=k1_row['plain_ms'],
             bound_ms=k1_row['bound_ms'], bound_by=k1_row['bound_by'],
             library_ms=None, tail_max_abs_err=k1_tail['max_abs_err'],
             tail_quantile_err=k1_tail['quantile_err'],
             tail_plain_quantile_err=k1_tail['plain_quantile_err']),
        dict(name='basis_jet', route='cuda',
             source='waveflow_tpu_torch/csrc/basis_jet.cu',
             replaces='waveflow_tpu/ops/pallas_jet.py:63',
             launches=launches['basis_jet'],
             max_abs_err=max(r['max_abs_err'] for r in k3.values()),
             ms=k3_row['ms'], plain_ms=k3_row['plain_ms'],
             bound_ms=k3_row['bound_ms'], bound_by=k3_row['bound_by'],
             library_ms=k3_row['library_ms']),
    ]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
