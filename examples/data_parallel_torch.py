"""The flagship VMC trainer with its walkers sharded over every rank of a
torchrun world, one process per card (cf. examples/run_vqmc.py
--data-parallel on a TPU mesh).

Usage:
  torchrun --standalone --nproc-per-node 4 examples/data_parallel_torch.py
  torchrun --standalone --nproc-per-node 4 examples/data_parallel_torch.py \
      --device cpu --tiny          # the same checks on gloo, small widths

Each rank holds ``--per-rank`` walkers (the global batch is that times the
world).  Checks, each of which fails the run:
  * one sharded clipped-score step on the ranks' own walkers (K1 draws)
    against rank 0's single-process step on all of them gathered: loss
    rtol 1e-4, gradient cos > 0.999 and norm ratio in (0.95, 1.05) (the
    JAX package's tests/test_parallel.py gates);
  * 2 windows of ``--window`` epochs through ``VMCTrainer(data_parallel=
    True)`` (on the card: replayed CUDA graphs, NCCL's collectives inside
    them): finite losses, the losses and the parameters equal to the bit
    on every rank.
On the card it also reports ms per replayed epoch (CUDA events, the
median of 3 windows) and the NCCL kernels per replayed epoch (profiler).
Rank 0 prints the card and, as its last line, one JSON object of the
figures.
"""

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveflow_tpu_torch.parallel import all_gather, destroy_walker_mesh
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
from waveflow_tpu_torch.vmc.estimators import make_train_step

TINY = dict(spline_degree=3, num_knots=6, n_flow_layers=1,
            n_spline_base_mesh_points=300)
LOSS_RTOL, MIN_COS, RATIO = 1e-4, 0.999, (0.95, 1.05)


T0 = time.perf_counter()


def log(stage: str) -> None:
    """Each rank's progress on stderr, with seconds since its start."""
    print(f"[rank {os.environ.get('RANK', 0)} {time.perf_counter() - T0:.1f} s]"
          f" {stage}", file=sys.stderr, flush=True)


def flat_grads(model):
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in model.parameters()])


def flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def step_gate(cfg, fig):
    """The sharded step against the single-process one (rank 0)."""
    sharded = VMCTrainer(cfg)
    mesh = sharded.mesh
    log(f"process group: rank {mesh.rank} of {mesh.size} over {mesh.backend}"
        f" on {sharded.device}")
    zero = torch.zeros((), device=sharded.device)
    local = sharded.sample(sharded.local_batch)
    batch = all_gather(local, mesh.axis)
    log("first collective done")
    m = sharded.model
    step = make_train_step(m.psi, sharded.h_fn, m.parameters(), 1e-4,
                           grad_clip=None, pmean_axis=mesh.axis)
    loss = step(local, zero).item()
    grad = flat_grads(m)
    if mesh.rank == 0:
        one = VMCTrainer(VMCConfig(**{**cfg.__dict__, 'data_parallel': False,
                                      'device': str(sharded.device)}))
        m1 = one.model
        loss1 = make_train_step(m1.psi, one.h_fn, m1.parameters(), 1e-4,
                                grad_clip=None)(batch, zero).item()
        g1 = flat_grads(m1)
        log("single-process reference step done")
        fig.update(step_loss=loss, step_loss_one=loss1,
                   step_cos=(grad @ g1 / (grad.norm() * g1.norm())).item(),
                   step_ratio=(grad.norm() / g1.norm()).item())
    return mesh


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--device', default='cuda')
    p.add_argument('--per-rank', type=int, default=256)
    p.add_argument('--window', type=int, default=10)
    p.add_argument('--tiny', action='store_true',
                   help='small widths (a CPU rehearsal)')
    args = p.parse_args(argv)
    world = int(os.environ.get('WORLD_SIZE', 1))
    cuda = torch.device(args.device).type == 'cuda'
    cfg = VMCConfig(batch_size=args.per_rank * world, window=args.window,
                    log_every=args.window, data_parallel=True,
                    eval_backend='poly_pallas' if cuda else 'poly',
                    device=args.device, **(TINY if args.tiny else {}))
    fig = {}
    mesh = step_gate(cfg, fig)
    log("sharded step done")
    t = VMCTrainer(cfg)
    losses = torch.tensor(t.train(2 * args.window, verbose=False),
                          dtype=torch.float64, device=t.device)
    log(f"2 windows done (graph: {t.graph})")
    every = all_gather(torch.cat([losses, flat_params(t.model).double()]),
                       mesh.axis, tiled=False)
    same = bool((every == every[0]).all())
    fig.update(world=mesh.size, backend=mesh.backend, graph=t.graph,
               walkers_per_rank=t.local_batch, global_batch=cfg.batch_size,
               losses_finite=bool(torch.isfinite(losses).all()),
               replicated_to_the_bit=same, last_loss=losses[-1].item())
    if cuda:
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t.train_window(args.window, t.baseline)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / args.window)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t.train_window(args.window, t.baseline)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        fig.update(ms_per_replayed_epoch=sorted(ms)[1], ms_windows=ms,
                   nccl_kernels_per_epoch={
                       e.key[:70]: e.count / args.window for e in dev
                       if 'nccl' in e.key.lower()},
                   device_events_per_epoch=sum(e.count for e in dev)
                   / args.window)
    log("timed and profiled")
    # the captured windows hold NCCL's work: drop them before the process
    # group ends (destroy_walker_mesh)
    t._drop_graphs()
    del t
    gc.collect()
    failed = []
    if mesh.rank == 0 and not math.isclose(
            fig['step_loss'], fig['step_loss_one'], rel_tol=LOSS_RTOL):
        failed.append('step loss')
    if mesh.rank == 0 and not (fig['step_cos'] > MIN_COS
                               and RATIO[0] < fig['step_ratio'] < RATIO[1]):
        failed.append('step gradient')
    if not (fig['losses_finite'] and fig['replicated_to_the_bit']):
        failed.append('windows')
    if cuda and mesh.rank == 0:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
        fig['device'] = torch.cuda.get_device_name(0)
    fig['failed'] = failed
    if mesh.rank == 0:
        print(json.dumps(fig), flush=True)
    destroy_walker_mesh()
    log("process group ended")
    return 1 if failed and mesh.rank == 0 else 0


if __name__ == '__main__':
    sys.exit(main())
