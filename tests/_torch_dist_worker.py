"""Rank bodies of the port's multi-process tests, and the launcher.

    python tests/_torch_dist_worker.py <mode> <rank> <world> <port> <dir>
        [phase]

runs one rank of a gloo group on the CPU; ``spawn`` starts a whole group
and waits for it.  Modes (each rank reads ``<dir>/inputs.npz`` where the
mode needs inputs, and writes ``<dir>/<mode>[_<phase>]_<rank>.npz``):

  parallel  (world 2; tests/test_torch_parallel.py) — the sharded clipped-
            score step (both clip statistics), the chunked SPRING Gram,
            one SPRING and one SR step, a sharded SR window, the collective
            Metropolis and MALA step size, the sharded resample, and the
            trainer under data_parallel=True with SR (ancestral) and SPRING
            (MALA walkers);
  probprog  (world 2; tests/test_torch_probprog_sharded.py) — sharded HMC
            and NUTS on a Gaussian, sharded SMC, the sharded parameter
            posterior's HMC;
  hosts     (world 4 as 2 hosts × 2 chips, phases 'full' and 'resume';
            tests/test_torch_distributed.py) — the two-level reduction, the
            sharded step on the grid against the flat world, a Metropolis +
            SPRING window with a shard-local checkpoint, and the trainer
            under data_parallel='hosts' through its own checkpoints.

Imports torch, numpy and the port only: a rank pays no JAX import.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# the small He-1d Waveflow of the JAX package's tests/test_parallel.py
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=5.0, n_spline_base_mesh_points=400)
SGD_LR = 1e-3
SPRING = dict(learning_rate=0.05, momentum=0.9, damping=1e-3,
              max_update_norm=0.3)
SR = dict(learning_rate=1e-2, damping=1e-3, cg_iters=10)
GRAM_TEST_CHUNK = 256         # several column blocks at the small width
# the trainer's (optimizer, sampler) pairs the 2-rank group trains
TRAINER_PAIRS = (('sr', 'ancestral'), ('spring', 'mala'))
TRAINER = dict(system_name='He', box_length=5.0, batch_size=16, window=3,
               log_every=3, seed=5, spline_degree=4, num_knots=8,
               n_flow_layers=1, n_spline_base_mesh_points=300,
               sampler='metropolis', mcmc_sweeps=2, device='cpu')


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn(mode: str, world: int, out_dir: Path, phase: str = '',
          timeout: float = 150.0, local_world: int | None = None) -> float:
    """Run ``mode`` on ``world`` ranks (``local_world`` per host, torchrun's
    LOCAL_WORLD_SIZE) and wait for all; kill every rank and raise with
    their logs if one fails or the group outlives ``timeout`` seconds.
    Returns the group's wall seconds."""
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    if local_world is not None:
        env['LOCAL_WORLD_SIZE'] = str(local_world)
    port = free_port()
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(world):
        log = open(out_dir / f'{mode}{phase}_{rank}.log', 'w')
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, str(rank), str(world),
             str(port), str(out_dir), phase],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    failed = None
    try:
        for rank, p in enumerate(procs):
            left = timeout - (time.perf_counter() - t0)
            try:
                if p.wait(timeout=max(left, 0.1)) != 0:
                    failed = f'rank {rank} exited with {p.returncode}'
                    break
            except subprocess.TimeoutExpired:
                failed = f'the group ran past {timeout} s'
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed:
        text = '\n'.join(
            f'--- rank {r} ---\n'
            + (out_dir / f'{mode}{phase}_{r}.log').read_text()[-4000:]
            for r in range(world))
        raise RuntimeError(f'{mode}{phase}: {failed}\n{text}')
    return time.perf_counter() - t0


# ---- rank bodies ------------------------------------------------------------

def _small_model(torch, params, device='cpu'):
    from waveflow_tpu_torch.models import get_waveflow_model
    from waveflow_tpu_torch.physics import (
        construct_hamiltonian_function, system_catalogue)
    m = get_waveflow_model(2, **SMALL, device=device,
                           generator=torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    h = construct_hamiltonian_function(
        m.psi, protons=system_catalogue[1]['He'][0], n_space_dimensions=1)
    return m, h


def _params_of(inputs):
    return {k[len('param:'):]: inputs[k] for k in inputs.files
            if k.startswith('param:')}


def _flat(torch, model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _flat_grads(torch, model):
    """Every parameter's .grad, zeros for those off the path, flat."""
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in model.parameters()])


def parallel_body(torch, mesh, inputs, out_dir: Path) -> dict:
    from waveflow_tpu_torch.parallel import (
        make_sharded_sr_window, make_sharded_train_step,
        resample_walkers_sharded, shard_batch, walker_generator)
    from waveflow_tpu_torch.vmc.mala import make_mala_sampler
    from waveflow_tpu_torch.vmc.metropolis import (
        make_metropolis_sampler, sector_projection)
    from waveflow_tpu_torch.vmc.sr import (
        gram_matrix, make_score_fn, make_spring_train_step,
        make_sr_train_step)

    params = _params_of(inputs)
    out = {}
    t = lambda k: torch.as_tensor(inputs[k])               # noqa: E731
    rows = lambda k: shard_batch(t(k), mesh)               # noqa: E731
    # the clipped-score step, both clip statistics: its gradient (read
    # from .grad after the step) is the SGD update over -lr
    for stat in ('mean_abs', 'median_abs'):
        m, h = _small_model(torch, params)
        step = make_sharded_train_step(m.psi, h, m.parameters(), SGD_LR,
                                       mesh, grad_clip=None, clip_stat=stat)
        out[f'loss_{stat}'] = step(rows('batch64'), torch.zeros(())).numpy()
        out[f'grad_{stat}'] = _flat_grads(torch, m).numpy()
    # the chunked Gram of the score rows, and one SPRING step
    m, h = _small_model(torch, params)
    flatten, scores = make_score_fn(m)
    O = scores(flatten(), rows('batch32')).detach()
    out['gram'] = gram_matrix(O, mesh.axis, chunk=GRAM_TEST_CHUNK).numpy()
    out['n_params'] = np.asarray(O.shape[1])
    step = make_spring_train_step(m, h, pmean_axis=mesh.axis, **SPRING)
    step.optimizer.load_state_dict({**step.init_state(),
                                    'delta': t('spring_delta')})
    out['spring_loss'] = step(rows('batch32'), torch.zeros(())).numpy()
    out['spring_delta'] = step.optimizer.state_dict()['delta'].numpy()
    out['spring_params'] = _flat(torch, m).numpy()
    # one SR step, and a sharded SR window of 3 epochs at 64 walkers
    m, h = _small_model(torch, params)
    step = make_sr_train_step(m, h, pmean_axis=mesh.axis, **SR)
    out['sr_loss'] = step(rows('batch32'), torch.zeros(())).numpy()
    out['sr_params'] = _flat(torch, m).numpy()
    m, h = _small_model(torch, params)
    gen = walker_generator(3, mesh)
    window = make_sharded_sr_window(
        m, h, lambda n: m.sample(n, generator=gen), global_batch=64,
        window=3, mesh=mesh, **SR)
    before = _flat(torch, m)
    losses, _ = window(torch.zeros(()))
    out['sr_window_losses'] = losses.numpy()
    out['sr_window_moved'] = (_flat(torch, m) - before).abs().sum().numpy()
    # the collective step size from explicit draws
    m, _ = _small_model(torch, params)
    init, step_fn, _ = make_metropolis_sampler(
        m.log_pdf, axis_name=mesh.axis, bounds=(-5.0, 5.0),
        proposal_map=sector_projection(True))
    st = step_fn(init(rows('walkers'), step_size=0.5),
                 noise=rows('noise'), u=rows('u'))
    out['metropolis_step'] = st.step_size.numpy()
    out['metropolis_positions'] = st.positions.numpy()
    init, step_fn, _ = make_mala_sampler(m.log_pdf, axis_name=mesh.axis,
                                         bounds=(-5.0, 5.0))
    st = step_fn(init(rows('walkers'), step_size=0.3),
                 noise=rows('noise'), u=rows('u'))
    out['mala_step'] = st.step_size.numpy()
    out['mala_positions'] = st.positions.numpy()
    # the cross-rank resample, two weightings
    for name in ('lw_half', 'lw_random'):
        new, lw = resample_walkers_sharded(rows('resample_pos'), rows(name),
                                           t('resample_u'), mesh.axis)
        out[f'resampled_{name}'] = new.numpy()
        out[f'resampled_{name}_lw'] = lw.numpy()
    # the trainer's natural-gradient pairs (JAX's
    # test_vmc_trainer_sr_data_parallel), 2 windows of 2 epochs
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    for optimizer, sampler in TRAINER_PAIRS:
        tr = VMCTrainer(VMCConfig(**dict(TRAINER, sampler=sampler, window=2),
                                  optimizer=optimizer, learning_rate=1e-2,
                                  data_parallel=True))
        out[f'trainer_{optimizer}_{sampler}'] = np.asarray(
            tr.train(num_epochs=4, verbose=False))
    # save_artifacts over two ranks: checkpoints, and no artifacts (they
    # are written by a single-process run only, JAX's rule)
    art = out_dir / 'artifacts_run'
    tr = VMCTrainer(VMCConfig(**TRAINER, data_parallel=True,
                              save_artifacts=True, save_dir=str(art)))
    tr.train(num_epochs=3, verbose=False)
    out['artifacts_run_files'] = np.asarray(sorted(p.name
                                                   for p in art.iterdir()))
    return out


def probprog_body(torch, mesh, inputs) -> dict:
    from waveflow_tpu_torch.models.factory import get_model
    from waveflow_tpu_torch.parallel import (
        all_gather, make_sharded_chain_sampler, make_sharded_smc,
        walker_generator)
    from waveflow_tpu_torch.vmc import (
        make_hmc_sampler, make_nuts_sampler, make_parameter_posterior)

    out = {}
    t = lambda k: torch.as_tensor(inputs[k])               # noqa: E731

    def gauss_lp(x):
        return -0.5 * (x ** 2).sum(-1)

    def gathered_trace(trace):
        return all_gather(trace.transpose(0, 1), mesh.axis) \
            .transpose(0, 1).numpy()

    init, make_run = make_sharded_chain_sampler(make_hmc_sampler, gauss_lp,
                                                mesh, n_leapfrog=8)
    state, trace = make_run(300, 200)(init(t('hmc_pos'), step_size=0.2),
                                      walker_generator(1, mesh))
    out['hmc_trace'] = gathered_trace(trace)
    out['hmc_step'] = state.step_size.numpy()
    init, make_run = make_sharded_chain_sampler(make_nuts_sampler, gauss_lp,
                                                mesh, max_tree_depth=5)
    state, trace = make_run(200, 100)(init(t('nuts_pos'), step_size=0.3),
                                      walker_generator(3, mesh))
    out['nuts_trace'] = gathered_trace(trace)
    out['nuts_step'] = state.step_size.numpy()

    def log_prior(x):
        return -0.5 * (x ** 2).sum(-1) / 9.0

    def log_like(x):
        return -0.5 * (((x - 2.0) / 0.5) ** 2).sum(-1)

    init, run = make_sharded_smc(log_prior, log_like, mesh, n_temps=12,
                                 n_mcmc_moves=5, mcmc_step_size=0.4,
                                 ess_threshold=0.7)
    st, ess = run(init(t('smc_particles')), walker_generator(5, mesh),
                  torch.Generator().manual_seed(6))
    out['smc_particles'] = all_gather(st.particles, mesh.axis).numpy()
    out['smc_log_weights'] = all_gather(st.log_weights, mesh.axis).numpy()
    out['smc_ess'] = ess.numpy()

    # the parameter posterior of JAX's test_sharded_parameter_posterior_hmc
    model = get_model(2, base_spline_degree=3, i_spline_degree=3,
                      n_prior_internal_knots=5, n_i_internal_knots=5,
                      i_spline_reg=0.1, n_flow_layers=1,
                      n_spline_base_mesh_points=200, device='cpu',
                      generator=torch.Generator().manual_seed(6))
    log_prob, _, flat0 = make_parameter_posterior(model, t('posterior_data'),
                                                  prior_scale=2.0)
    init, make_run = make_sharded_chain_sampler(make_hmc_sampler, log_prob,
                                                mesh, n_leapfrog=4)
    theta0 = flat0[None].repeat(8, 1)
    state, trace = make_run(5, 5)(init(theta0, step_size=1e-3),
                                  walker_generator(8, mesh))
    out['posterior_log_prob'] = all_gather(state.log_prob, mesh.axis).numpy()
    out['posterior_trace_shape'] = np.asarray(gathered_trace(trace).shape)
    return out


def hosts_body(torch, mesh, inputs, out_dir: Path, phase: str) -> dict:
    """The 2 hosts × 2 chips group: the two-level reduction and the step
    on the grid against the flat world (phase 'full' only), then the
    Metropolis + SPRING window and the trainer, each run to a shard-local
    checkpoint ('full') or resumed from it ('resume')."""
    import torch.distributed as dist

    from waveflow_tpu_torch.parallel import (
        all_gather, axis_index, axis_size, make_sharded_mcmc_window,
        make_sharded_train_step, make_walker_mesh, psum, shard_batch,
        walker_generator)
    from waveflow_tpu_torch.utils import load_state, save_state
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    from waveflow_tpu_torch.vmc.metropolis import MetropolisState
    from waveflow_tpu_torch.vmc.sr import make_spring_train_step

    rank = dist.get_rank()
    flat_mesh = make_walker_mesh(device='cpu')
    params = _params_of(inputs)
    out = {}
    if phase == 'full':
        x = torch.arange(4.0) + 4 * rank              # this rank's 4 entries
        out['psum'] = psum(x.sum(), ('hosts', 'chips')).numpy()
        out['psum_chips'] = psum(x.sum(), 'chips').numpy()
        out['gathered'] = all_gather(x, mesh.axis).numpy()
        out['index'] = np.asarray([axis_index(mesh.axis),
                                   axis_size(mesh.axis),
                                   axis_index('hosts'), axis_index('chips')])
        for name, m_ in (('grid', mesh), ('flat', flat_mesh)):
            m, h = _small_model(torch, params)
            step = make_sharded_train_step(m.psi, h, m.parameters(), SGD_LR,
                                           m_, grad_clip=None)
            out[f'loss_{name}'] = step(
                shard_batch(torch.as_tensor(inputs['batch64']), m_),
                torch.zeros(())).numpy()
            out[f'grad_{name}'] = _flat_grads(torch, m).numpy()

    # the sharded Metropolis window driven by a SPRING step, resumed from a
    # shard-local checkpoint
    m, h = _small_model(torch, params)
    spring = make_spring_train_step(m, h, 0.02, damping=1e-2, momentum=0.9,
                                    pmean_axis=mesh.axis, max_update_norm=0.3)
    init, window = make_sharded_mcmc_window(None, m.log_pdf, 5.0, mesh,
                                            n_sweeps=2, train_step=spring)
    state_file = out_dir / f'spring_state_{rank}'
    if phase == 'full':
        gen = walker_generator(7, mesh)
        mstate = init(shard_batch(torch.as_tensor(inputs['walkers16']), mesh),
                      step_size=0.5)
        losses, baseline, _, mstate = window(mstate, 3, torch.zeros(()), gen)
        save_state(state_file, {
            'params': {k: v.numpy().copy() for k, v in m.state_dict().items()},
            'spring': {k: v.numpy().copy() for k, v in
                       spring.optimizer.state_dict().items()},
            'baseline': baseline.numpy(), 'generator': gen.get_state().numpy(),
            'mcmc': [f.numpy().copy() for f in mstate]})
    else:
        st = load_state(state_file)
        m.load_state_dict({k: torch.as_tensor(v)
                           for k, v in st['params'].items()})
        spring.optimizer.load_state_dict(st['spring'])
        baseline = torch.as_tensor(st['baseline'])
        gen = torch.Generator()
        gen.set_state(torch.as_tensor(st['generator']))
        mstate = MetropolisState(*(torch.as_tensor(f) for f in st['mcmc']))
    losses, _, _, mstate = window(mstate, 3, baseline, gen)
    out['spring_losses'] = losses.numpy()
    out['spring_params'] = _flat(torch, m).numpy()
    out['spring_step_size'] = mstate.step_size.numpy()
    out['spring_positions'] = mstate.positions.numpy()
    out['spring_skipped'] = spring.optimizer.state_dict()['skipped'].numpy()

    # the trainer under data_parallel='hosts', through its own checkpoints
    ckpt = out_dir / ('ckpt' if phase == 'full' else 'ckpt_A')
    t = VMCTrainer(VMCConfig(**TRAINER, data_parallel='hosts',
                             divergence_recovery=True, save_dir=str(ckpt)))
    if t.walker_axis != ('hosts', 'chips') or t.mesh.shape != (2, 2):
        raise RuntimeError(f"trainer mesh {t.mesh}")
    if phase == 'full':
        t.train(num_epochs=3, verbose=False)
        ckpt_a = out_dir / 'ckpt_A'
        ckpt_a.mkdir(exist_ok=True)
        shutil.copy(ckpt / f'checkpoints.shard{rank}', ckpt_a)
        if rank == 0:
            shutil.copy(ckpt / 'checkpoints', ckpt_a)
            shutil.copy(ckpt / 'loss.npy', ckpt_a)
        dist.barrier()
        losses = t.train(num_epochs=3, verbose=False)[3:]
    else:
        losses = t.train(num_epochs=3, restart=True, verbose=False)[3:]
    out['trainer_losses'] = np.asarray(losses)
    out['trainer_params'] = _flat(torch, t.model).numpy()
    out['trainer_step_size'] = t.mcmc_state.step_size.numpy()
    out['trainer_positions'] = t.mcmc_state.positions.numpy()
    out['trainer_files'] = np.asarray(sorted(p.name for p in ckpt.iterdir()))
    return out


def main(argv) -> int:
    import torch
    torch.set_num_threads(1)
    mode, rank, world, port, out_dir = argv[:5]
    phase = argv[5] if len(argv) > 5 else ''
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    from waveflow_tpu_torch.parallel import (
        destroy_walker_mesh, distributed_init, make_host_chip_mesh,
        make_walker_mesh)
    distributed_init(f'localhost:{port}', world, rank, device='cpu')
    inputs_path = out_dir / 'inputs.npz'
    inputs = np.load(inputs_path) if inputs_path.exists() else None
    try:
        if mode == 'hosts':
            out = hosts_body(torch, make_host_chip_mesh(device='cpu'),
                             inputs, out_dir, phase)
        else:
            mesh = make_walker_mesh(device='cpu')
            out = (parallel_body(torch, mesh, inputs, out_dir)
                   if mode == 'parallel' else
                   probprog_body(torch, mesh, inputs))
        np.savez(out_dir / f'{mode}{phase}_{rank}.npz', **out)
    finally:
        destroy_walker_mesh()
    print(f'rank {rank} of {world}: {mode} {phase} ok', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
