"""Sweep the launch plans of the port's redesigned CUDA kernels on one card.

K3 (csrc/basis_jet.cu): both regimes, 'direct' and 'staged', over a range
of site counts R — where the wrapper's switch STAGED_MIN_SITES belongs.
K1 / K2 (csrc/sampler.cu): every walkers-per-group variant over a range of
batches B — which group size the wrapper's plan should take where
(GROUP_COST, per kind).
K4 (csrc/spline_eval.cu): forward and backward over N and lanes per row —
where lanes_per_row comes from; its jet entry (``spline_jet``) at the
table backend's two sites (an IMADE ``pair(0)`` on the flagship's I-spline
tables, 15 terms over 4 components; the prior's ``__call__`` on its OB
tables, 9 terms) over N = 512, 8,192, 40,000 and every block size of
JET_THREADS — where plan_jet's choice comes from — each point also held,
value for value, to the per-call launches it replaces, and timed beside
them; its backward jet entry (``spline_bwd_jet``) in the three forms the
table backend's grad-level sites launch (an IMADE site's backward, 2
kinds with g_x; the prior's, 1 kind; the IMADE site's tangent, 4 terms)
over the same N and every block size of BWD_THREADS — where
plan_bwd_jet's choice comes from — each point held, value for value, to
the per-call backward launches and sums it replaces, and timed beside
them.
Each point is first held against the kernel's plain version (the tolerances
of chip_smoke.py), then timed twice: back-to-back calls by CUDA events (host
path included) and the kernel alone by the profiler's device time.

Two more parts, timed only:
  host    the host path of K4's wrappers in pieces (allocation, ctypes
          call, stream getter, checks, Function.apply), host clock per call;
  inverse the exact table inverse's two forms (ops/inverse.py: dense, and
          node bisection) at the IMADE inverse's shapes (I-splines of the
          flagship on the 2000-point mesh, one column of the model's own
          conditioner, batch 256 to 65,536), by CUDA events in turns (dense,
          bisection, bisection, dense), with their largest difference —
          where DENSE_INVERSE_MAX_ELEMENTS_CUDA comes from.

Usage (needs a CUDA card and nvcc; a few seconds after the build):
  python examples/kernel_sweep_torch.py [--check-only] [--out FILE.json]
      [--only jet,sampler,sampler_linear,spline,spline_jet,spline_bwd_jet,
       host,inverse]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch

from chip_smoke import (DENSITY, FLAGSHIP, cuda_ms, device_ms, fail,
                        magnitude, nan_rel_err, per_call_bwd, per_call_site,
                        rel_err, same_values)
from waveflow_tpu_torch import ops
from waveflow_tpu_torch.ops import (cuda_build, cuda_jet, cuda_sampler,
                                    cuda_spline)
from waveflow_tpu_torch.ops.spline_eval import site_bwd, site_jet
from waveflow_tpu_torch.ops.sampling import (sample_linear_density,
                                             sample_squared_amplitude)


def sweep_jet(gen, timed):
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    tabs = ops.get_tables('I', deg, knots, n_mesh=mesh)
    ev = ops.make_poly_evaluator(tabs, jet_backend='pallas', device='cuda')
    A, nc, k = ev.A_jet, ev.n_cells, ev.ncoef
    rows = []
    for R in (1, 33, 512, 4096, 16384, 32768, 65536, 131072, 262144, 1048576):
        x = torch.rand((R,), generator=gen, device='cuda') * 1.1 - 0.05
        ref = cuda_jet.basis_jet_plain(x, A, nc, k)
        for regime in ('direct', 'staged'):
            def run():
                return cuda_jet.basis_jet_cuda(x, A, nc, k, regime=regime)
            out = run()
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, rtol=2e-5, atol=2e-4):
                fail(f"K3 {regime} R={R} disagrees: max "
                     f"{(out - ref).abs().max().item():.3e}")
            row = dict(kernel='basis_jet', R=R, regime=regime,
                       grid=cuda_jet.last_plan.grid,
                       max_abs_err=(out - ref).abs().max().item())
            if timed:
                row.update(ms=cuda_ms(torch, run), device_ms=device_ms(torch, run))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def sweep_sampler(gen, timed, kind):
    if kind == 'squared':
        tabs = ops.get_tables('B', FLAGSHIP['spline_degree'],
                              FLAGSHIP['num_knots'], n_mesh=FLAGSHIP['n_mesh'])
        ev = ops.make_evaluator(tabs, use_ob=True, device='cuda')
        sample, kernel = (sample_squared_amplitude,
                          cuda_sampler.sample_squared_amplitude_cuda)
        batches = (1, 5, 256, 1024, 4096, 65536)
    else:
        tabs = ops.get_tables('M', DENSITY['prior_spline_degree'],
                              DENSITY['prior_n_knots'],
                              n_mesh=DENSITY['n_mesh_points'])
        ev = ops.make_evaluator(tabs, device='cuda')
        sample, kernel = (sample_linear_density,
                          cuda_sampler.sample_linear_density_cuda)
        batches = (3, 256, 1000, 4096, 20000, 65536)
    n_b = ev.table_t.shape[0]
    rows = []
    for B in batches:
        if kind == 'squared':
            c = torch.randn((B, n_b), generator=gen, device='cuda')
            c = c / c.norm(dim=-1, keepdim=True)
        else:
            c = torch.rand((B, n_b), generator=gen, device='cuda')
            c = c / c.sum(-1, keepdim=True)
        u = torch.rand((B,), generator=gen, device='cuda')
        ref = sample(ev, c, u, impl='plain')
        body = u <= 1.0 - 1e-4
        for W in cuda_sampler.WALKERS_PER_BLOCK:
            def run():
                return kernel(ev, c, u, walkers_per_block=W)
            x = run()
            torch.cuda.synchronize()
            err = (x - ref).abs()[body].max().item() if body.any() else 0.0
            if not (x.min() >= 0 and x.max() <= 1 and err <= 6e-5):
                fail(f"sampler '{kind}' group {W} B={B} disagrees: max "
                     f"{err:.3e}")
            row = dict(kernel=f'sampler_{kind}', B=B, group=W,
                       grid=cuda_sampler.last_plan.grid,
                       smem_bytes=cuda_sampler.last_plan.smem_bytes,
                       max_abs_err=err)
            if timed:
                row.update(ms=cuda_ms(torch, run), device_ms=device_ms(torch, run))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def density_prior(gen, N):
    """The density model's M-spline prior evaluator with N rows of positive,
    normalised coefficients and points partly outside [0, 1]."""
    tabs = ops.get_tables('M', DENSITY['prior_spline_degree'],
                          DENSITY['prior_n_knots'],
                          n_mesh=DENSITY['n_mesh_points'])
    ev = ops.make_evaluator(tabs, device='cuda')
    c = torch.rand((N, ev.n_bases), generator=gen, device='cuda')
    c = c / c.sum(-1, keepdim=True)
    x = torch.rand((N,), generator=gen, device='cuda') * 1.04 - 0.02
    g = torch.randn((N,), generator=gen, device='cuda')
    return ev, c, x, g


def sweep_spline(gen, timed):
    """K4 forward (order 0) and backward (order 0 with the order-1 table)
    over N and lanes per row."""
    rows_out = []
    for N in (512, 40000, 400000, 4000000):
        ev, c, x, g = density_prior(gen, N)
        t0, t1 = ev.tables[0], ev.tables[1]
        ref = cuda_spline.spline_eval_plain(t0, c, x)
        ref_gc, ref_gx = cuda_spline.spline_eval_bwd_plain(t0, t1, c, x, g)
        tol = 2e-5 * max(1.0, ref.abs().max().item())
        tol_gc = 2e-5 * max(1.0, ref_gc.abs().max().item())
        tol_gx = 2e-5 * max(1.0, ref_gx.abs().max().item())
        for lanes in (2, 4, 8):
            def fwd():
                return cuda_spline.spline_eval_cuda(t0, c, x, lanes=lanes)

            def bwd():
                return cuda_spline.spline_eval_bwd_cuda(t0, t1, c, x, g,
                                                        lanes=lanes)
            y, (gc, gx) = fwd(), bwd()
            torch.cuda.synchronize()
            errs = ((y - ref).abs().max().item(),
                    (gc - ref_gc).abs().max().item(),
                    (gx - ref_gx).abs().max().item())
            if not (errs[0] <= tol and errs[1] <= tol_gc
                    and errs[2] <= tol_gx):
                fail(f"K4 lanes {lanes} N={N} disagrees: {errs}")
            for name, run, err in (('spline_eval', fwd, errs[0]),
                                   ('spline_eval_bwd', bwd, max(errs[1:]))):
                row = dict(kernel=name, N=N, lanes=lanes,
                           grid=cuda_spline.plan(
                               N, ev.n_bases, name.endswith('bwd'),
                               lanes).grid, max_abs_err=err)
                if timed:
                    row.update(ms=cuda_ms(torch, run),
                               device_ms=device_ms(torch, run))
                rows_out.append(row)
                print(json.dumps(row), flush=True)
    return rows_out


def sweep_spline_jet(gen, timed):
    """K4's jet entry over N and block sizes at the table backend's two
    sites, against its plain version (2e-5 of the largest Σ|c||B|, as the
    pair entry) and against the per-call launches of the same site, value
    for value; the per-call launches timed beside it."""
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    sites = {
        'I-spline pair(0)': (ops.make_evaluator(
            ops.get_tables('I', deg, knots, n_mesh=mesh), device='cuda'),
            (('G', 0), ('F', 1))),
        'OB prior call(0)': (ops.make_evaluator(
            ops.get_tables('B', deg, knots, n_mesh=mesh), use_ob=True,
            device='cuda'), (('F', 0),))}
    rows = []
    for site, (ev, kinds) in sites.items():
        requests, terms = site_jet(ev, kinds)
        for N in (512, 8192, 40000):
            comps = [torch.randn((N, ev.n_bases), generator=gen,
                                 device='cuda') for _ in range(4)]
            x = torch.rand((N,), generator=gen, device='cuda') * 1.1 - 0.05
            ref = cuda_spline.spline_eval_jet_plain(ev.tables, ev.slopes,
                                                    comps, x, terms)
            per = per_call_site(ev, requests, comps, x)
            scales = [magnitude(torch, ev.slopes[d] if st else ev.tables[d],
                                comps[m], x, st) for m, d, st in terms]
            chosen = cuda_spline.plan_jet(N, ev.n_bases, len(terms), 4,
                                          ev.n_derivatives)
            for threads in cuda_spline.JET_THREADS:
                def run(threads=threads):
                    return cuda_spline.spline_eval_jet_cuda(
                        ev.records, comps, x, terms, ev.n_bases, threads)
                out = run()
                torch.cuda.synchronize()
                err = max(rel_err(out[t], ref[t], scales[t])
                          for t in range(len(terms)))
                same = all(same_values(out[t], per[term])
                           for t, term in enumerate(terms))
                if not (err <= 2e-5 and same):
                    fail(f"K4 jet {site} N={N} threads={threads}: "
                         f"{err:.3e} against its plain version, per-call "
                         f"values {'equal' if same else 'NOT equal'}")
                row = dict(kernel='spline_eval_jet', site=site, N=N,
                           terms=len(terms), threads=threads,
                           grid=cuda_spline.plan_jet(
                               N, ev.n_bases, len(terms), 4,
                               ev.n_derivatives, threads).grid,
                           planned=threads == chosen.threads,
                           max_abs_err=err, per_call_equal=same)
                if timed:
                    row.update(ms=cuda_ms(torch, run),
                               device_ms=device_ms(torch, run))
                rows.append(row)
                print(json.dumps(row), flush=True)
            if timed:
                def per_call():
                    return per_call_site(ev, requests, comps, x)
                row = dict(kernel='spline_eval per-call launches', site=site,
                           N=N, launches=len(requests),
                           ms=cuda_ms(torch, per_call),
                           device_ms=device_ms(torch, per_call))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def sweep_spline_bwd_jet(gen, timed):
    """K4's backward jet entry over N and block sizes in the table
    backend's three forms, against its plain version (2e-5 of the largest
    sum of term magnitudes) and against the per-call backward launches and
    sums of the same form, value for value; those timed beside it."""
    deg, knots, mesh = (FLAGSHIP[k] for k in ('spline_degree', 'num_knots',
                                              'n_mesh'))
    ev_i = ops.make_evaluator(ops.get_tables('I', deg, knots, n_mesh=mesh),
                              device='cuda')
    ev_ob = ops.make_evaluator(ops.get_tables('B', deg, knots, n_mesh=mesh),
                               use_ob=True, device='cuda')
    i_forms = site_bwd(ev_i, (('G', 0), ('F', 1)))
    forms = {'I-spline backward': (ev_i, i_forms['backward']),
             'OB prior backward': (ev_ob, site_bwd(ev_ob,
                                                   (('F', 0),))['backward']),
             'I-spline tangent': (ev_i, i_forms['tangent'])}
    rows = []
    for form, (ev, (slots, c_groups, x_terms)) in forms.items():
        n_terms = sum(len(g) for g in c_groups)
        for N in (512, 8192, 40000):
            comps = ([torch.randn((N, ev.n_bases), generator=gen,
                                  device='cuda')] if x_terms else [])
            vecs = [torch.randn((N,), generator=gen, device='cuda')
                    for _ in slots]
            x = torch.rand((N,), generator=gen, device='cuda') * 1.1 - 0.05
            ref = cuda_spline.spline_eval_bwd_jet_plain(
                ev.tables, ev.slopes, comps, x, vecs, c_groups, x_terms)
            scale = cuda_spline.spline_eval_bwd_jet_plain(
                ev.tables.abs(), ev.slopes.abs(), [c.abs() for c in comps],
                x, [v.abs() for v in vecs], c_groups, x_terms)
            per = per_call_bwd(ev, comps, x, vecs, c_groups, x_terms)
            chosen = cuda_spline.plan_bwd_jet(N, ev.n_bases, n_terms,
                                              len(x_terms), len(vecs),
                                              len(comps))
            for threads in cuda_spline.BWD_THREADS:
                def run(threads=threads):
                    return cuda_spline.spline_eval_bwd_jet_cuda(
                        ev.records, comps, x, vecs, c_groups, x_terms,
                        ev.n_bases, threads)
                out = run()
                torch.cuda.synchronize()
                err = max(nan_rel_err(o, r, sc) for o, r, sc
                          in zip(out, ref, scale) if r is not None)
                same = all(same_values(o, pc) for o, pc in zip(out, per)
                           if pc is not None)
                if not (err <= 2e-5 and same):
                    fail(f"K4 backward jet {form} N={N} threads={threads}: "
                         f"{err:.3e} against its plain version, per-call "
                         f"values {'equal' if same else 'NOT equal'}")
                row = dict(kernel='spline_eval_bwd_jet', form=form, N=N,
                           g_c_terms=n_terms, g_x_terms=len(x_terms),
                           threads=threads,
                           grid=cuda_spline.plan_bwd_jet(
                               N, ev.n_bases, n_terms, len(x_terms),
                               len(vecs), len(comps), threads).grid,
                           planned=threads == chosen.threads,
                           max_abs_err=err, per_call_equal=same)
                if timed:
                    row.update(ms=cuda_ms(torch, run),
                               device_ms=device_ms(torch, run))
                rows.append(row)
                print(json.dumps(row), flush=True)
            if timed:
                def per_call():
                    return per_call_bwd(ev, comps, x, vecs, c_groups,
                                        x_terms)
                row = dict(kernel='spline_eval_bwd per-call launches and sums',
                           form=form, N=N,
                           launches=len(x_terms) or n_terms,
                           ms=cuda_ms(torch, per_call),
                           device_ms=device_ms(torch, per_call))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def host_us(fn, n=2000):
    """Mean host-clock microseconds of one call of ``fn`` (the device is
    left to run behind; synchronised before and after)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_path_pieces(gen):
    """Where the microseconds of one K4 launch go on the host, forward and
    backward, at the density path's shape (coeffs (20000, 2, 16))."""
    ev, c, x, g = density_prior(gen, 40000)
    c, x, g = c.reshape(20000, 2, -1), x.reshape(20000, 2), g.reshape(20000, 2)
    t0, t1 = ev.tables[0], ev.tables[1]
    lib = cuda_build.bind('spline_eval', cuda_spline.SIGNATURES)
    out = torch.empty_like(x)
    g_c, g_x = torch.empty_like(c), torch.empty_like(x)
    buf = torch.empty(40000 * 17, device='cuda')
    p = cuda_spline.plan(40000, ev.n_bases)
    pb = cuda_spline.plan(40000, ev.n_bases, True)
    stream = cuda_build.current_stream(0)
    cr, xr = c.clone().requires_grad_(), x.clone().requires_grad_()

    def through_function():
        y = ev(cr, xr)
        torch.autograd.grad(y, (cr, xr), g)

    pieces = {
        'torch.empty_like(x)': lambda: torch.empty_like(x),
        'torch.empty_like(coeffs) + torch.empty_like(x)': lambda: (
            torch.empty_like(c), torch.empty_like(x)),
        'one torch.empty for both backward outputs + two views': lambda: (
            buf[:640000].view(c.shape), buf[640000:].view(x.shape),
            torch.empty(40000 * 17, dtype=torch.float32, device=x.device)),
        'cuda_build.current_stream': lambda: cuda_build.current_stream(0),
        'torch.cuda.current_stream().cuda_stream':
            lambda: torch.cuda.current_stream(0).cuda_stream,
        'argument checks (_check)': lambda: cuda_spline._check(t0, c, x),
        'plan (cached)': lambda: cuda_spline.plan(40000, 16, False, None),
        'ctypes call, forward kernel': lambda: lib.spline_eval_launch(
            t0.data_ptr(), c.data_ptr(), x.data_ptr(), out.data_ptr(), 40000,
            2000, 16, p.group, p.grid, stream),
        'ctypes call, backward kernel': lambda: lib.spline_eval_bwd_launch(
            t0.data_ptr(), t1.data_ptr(), c.data_ptr(), x.data_ptr(),
            g.data_ptr(), g_c.data_ptr(), g_x.data_ptr(), 40000,
            2000, 16, pb.group, pb.grid, stream),
        'reshape(-1, n_bases) + reshape(-1) + reshape back': lambda: (
            c.reshape(-1, 16), x.reshape(-1), out.reshape(x.shape)),
        'spline_eval_cuda (whole forward wrapper)':
            lambda: cuda_spline.spline_eval_cuda(t0, c, x),
        'spline_eval_bwd_cuda (whole backward wrapper)':
            lambda: cuda_spline.spline_eval_bwd_cuda(t0, t1, c, x, g),
        'evaluator under no_grad (Function.apply + forward)':
            lambda: ev(c, x),
        'evaluator forward + autograd.grad (both Functions)': through_function,
    }
    rows = []
    for name, fn in pieces.items():
        n = 300 if 'Function' in name else 2000
        row = dict(kernel='spline_eval host path', piece=name,
                   host_us=host_us(fn, n))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def sweep_inverse(gen):
    """Dense against node-bisection exact inverse per batch, and the
    smallest swept batch from which bisection is the faster."""
    from waveflow_tpu_torch.bijections import IMADE, masked_conditioner
    from waveflow_tpu_torch.ops.inverse import (
        DENSE_INVERSE_MAX_ELEMENTS_CUDA, exact_node_bisect_inverse,
        exact_table_inverse)
    layer = IMADE(masked_conditioner(), 2,
                  spline_degree=FLAGSHIP['spline_degree'],
                  n_internal_knots=FLAGSHIP['num_knots'],
                  spline_regularization=0.05,
                  n_spline_base_mesh_points=FLAGSHIP['n_mesh'],
                  generator=torch.Generator().manual_seed(0), device='cuda')
    ev = layer.ev
    rows, crossover = [], None
    for B in (256, 1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144):
        with torch.no_grad():
            sp = layer.spline_params(
                torch.rand((B, 2), generator=gen, device='cuda'))[:, 0]
        y = torch.rand((B,), generator=gen, device='cuda')

        def dense():
            return exact_table_inverse(ev, sp, y)

        def bisect():
            return exact_node_bisect_inverse(ev, sp, y)

        err = (dense() - bisect()).abs().max().item()
        ms = {'dense': [], 'bisect': []}
        for name, fn in (('dense', dense), ('bisect', bisect),
                         ('bisect', bisect), ('dense', dense)):
            ms[name].append(cuda_ms(torch, fn, reps=20))
        d_ms, b_ms = (sum(v) / 2 for v in (ms['dense'], ms['bisect']))
        if crossover is None and b_ms < d_ms:
            crossover = B
        row = dict(part='inverse', B=B, elements=B * ev.n_mesh,
                   max_abs_diff=err, dense_ms=d_ms, bisect_ms=b_ms,
                   dense_takes=B * ev.n_mesh <= DENSE_INVERSE_MAX_ELEMENTS_CUDA)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(f"inverse: node bisection is faster from B = {crossover} "
          f"({None if crossover is None else crossover * ev.n_mesh} "
          f"elements) of the swept batches; DENSE_INVERSE_MAX_ELEMENTS_CUDA "
          f"= {DENSE_INVERSE_MAX_ELEMENTS_CUDA}", flush=True)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--check-only', action='store_true',
                   help='build and hold against the plain versions; no timing')
    p.add_argument('--out', default=None, help='write the rows here as JSON')
    p.add_argument('--only',
                   default='jet,sampler,sampler_linear,spline,spline_jet,'
                           'spline_bwd_jet,host',
                   help='comma-separated parts to run')
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for name, (secs, log) in cuda_build.build().items():
        print(f"{name}.cu: {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if any(w in line for w in ('Compiling entry', 'registers', 'spill',
                                         'warning', 'error')):
                print(f"  {line.strip()}", flush=True)
    gen = torch.Generator('cuda').manual_seed(0)
    timed = not args.check_only
    parts = {'jet': lambda: sweep_jet(gen, timed),
             'sampler': lambda: sweep_sampler(gen, timed, 'squared'),
             'sampler_linear': lambda: sweep_sampler(gen, timed, 'linear'),
             'spline': lambda: sweep_spline(gen, timed),
             'spline_jet': lambda: sweep_spline_jet(gen, timed),
             'spline_bwd_jet': lambda: sweep_spline_bwd_jet(gen, timed),
             'host': lambda: host_path_pieces(gen),
             'inverse': lambda: sweep_inverse(gen)}
    rows = []
    for part in args.only.split(','):
        if part not in parts:
            fail(f"unknown part {part!r}; one of {sorted(parts)}")
        rows += parts[part]()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({'card': card, 'rows': rows}, indent=1))
    print("kernel_sweep_torch: all checked points agree with the plain "
          "versions")
    return 0


if __name__ == '__main__':
    sys.exit(main())
