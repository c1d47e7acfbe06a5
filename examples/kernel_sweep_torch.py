"""Sweep the launch plans of the port's redesigned CUDA kernels on one card.

K3 (csrc/basis_jet.cu): both regimes, 'direct' and 'staged', over a range
of site counts R — where the wrapper's switch STAGED_MIN_SITES belongs.
K1 / K2 (csrc/sampler.cu): every walkers-per-group variant over a range of
batches B — which group size the wrapper's plan should take where
(GROUP_COST).  Each point is
first held against the kernel's plain version (the tolerances of
chip_smoke.py), then timed twice: back-to-back calls by CUDA events (host
path included) and the kernel alone by the profiler's device time.

Usage (needs a CUDA card and nvcc; a few seconds after the build):
  python examples/kernel_sweep_torch.py [--check-only] [--out FILE.json]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch

from chip_smoke import DENSITY, FLAGSHIP, cuda_ms, device_ms, fail
from waveflow_tpu_torch import ops
from waveflow_tpu_torch.ops import cuda_build, cuda_jet, cuda_sampler
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
        batches = (3, 256, 20000)
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


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--check-only', action='store_true',
                   help='build and hold against the plain versions; no timing')
    p.add_argument('--out', default=None, help='write the rows here as JSON')
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for name, (secs, log) in cuda_build.build(('sampler', 'basis_jet')).items():
        print(f"{name}.cu: {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if any(w in line for w in ('Compiling entry', 'registers', 'spill',
                                         'warning', 'error')):
                print(f"  {line.strip()}", flush=True)
    gen = torch.Generator('cuda').manual_seed(0)
    timed = not args.check_only
    rows = (sweep_jet(gen, timed) + sweep_sampler(gen, timed, 'squared')
            + sweep_sampler(gen, timed, 'linear'))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({'card': card, 'rows': rows}, indent=1))
    print("kernel_sweep_torch: all points agree with the plain versions")
    return 0


if __name__ == '__main__':
    sys.exit(main())
