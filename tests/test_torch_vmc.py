"""Parity of the PyTorch port's VMC estimator, optimizer step and trainer
with the JAX package, on the CPU."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc.estimators import make_loss_fn as jmake_loss_fn
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, make_train_step
from waveflow_tpu_torch.vmc.estimators import _median, clip_by_global_norm

torch.set_num_threads(2)

CHECKPOINT = (Path(__file__).resolve().parents[1] / 'results'
              / 'r5_flagship_fwd_batched_100k' / 'checkpoints')
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)


@pytest.mark.parametrize('n', [7, 8, 256])
def test_median_is_jnp_median(n):
    """jnp.median averages the two middle values of an even count;
    torch.median would return the lower one."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    assert _median(torch.as_tensor(x)).item() == pytest.approx(
        float(jnp.median(jnp.asarray(x))), rel=1e-7)


@pytest.mark.parametrize('scale', [0.01, 100.0])
def test_clip_by_global_norm_is_optax(scale):
    """Below the limit the gradient is untouched, above it scaled by
    max/norm — optax.clip_by_global_norm, not clip_grad_norm_; rtol 1e-6."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) * scale
             for s in ((3, 4), (5,))]
    ref, _ = optax.clip_by_global_norm(10.0).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.as_tensor(g.copy())
    clip_by_global_norm(params, 10.0)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


def test_train_step_matches_jax():
    """(g) One clipped-score + global-norm-clip + adam step from the flagship
    checkpoint on a fixed batch: loss rtol 1e-4; clipped gradient, as one
    vector, relative L2 error 2e-3 (the score estimator is a centred sum,
    so per-element relative errors of E_L grow where it cancels); updated
    parameters rtol 1e-4.

    Adam's first step moves each parameter by lr * g / (|g| + 1e-8), i.e.
    by ±lr: where |g| is at the level of float noise its sign is not
    defined by either package, so there only |Δ| <= 2 lr is required."""
    with open(CHECKPOINT, 'rb') as f:
        jparams = pickle.load(f)['params']
    kw = dict(base_spline_degree=6, i_spline_degree=6,
              n_prior_internal_knots=23, n_i_internal_knots=23,
              i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
    _, jpsi, _, jsample = jget_waveflow_model(2, **kw)(jax.random.PRNGKey(0), 2)
    protons = system_catalogue[1]['He'][0]
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    lr = 1e-4
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    batch = jax.jit(jsample, static_argnums=2)(jax.random.PRNGKey(5), jparams, 64)
    # the JAX train step (vmc/estimators.py::make_train_step) unrolled, to
    # read its clipped gradient too
    loss, jgrads = jax.jit(jax.value_and_grad(jmake_loss_fn(jpsi, jh)))(
        jparams, batch, jnp.zeros(()))
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    jgrads, _ = optax.clip_by_global_norm(10.0).update(jgrads, None)

    m = get_waveflow_model(2, **kw, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jparams))
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    step = make_train_step(m.psi, h, m.parameters(), lr, grad_clip=10.0)
    t_loss = step(torch.as_tensor(np.array(batch)), torch.zeros(()))
    assert t_loss.item() == pytest.approx(float(loss), rel=1e-4)

    ref_g = params_from_jax(jax.device_get(jgrads))
    ref_p = params_from_jax(jax.device_get(new_params))
    g_max = max(v.abs().max().item() for v in ref_g.values())
    named = dict(m.named_parameters())
    g_t = torch.cat([torch.zeros_like(named[k]).ravel() if named[k].grad is None
                     else named[k].grad.ravel() for k in ref_g])
    g_j = torch.cat([v.ravel() for v in ref_g.values()])
    assert ((g_t - g_j).norm() / g_j.norm()).item() <= 2e-3
    for k in ref_p:
        defined = (ref_g[k].abs() > 1e-5 * g_max).numpy()
        got, want = named[k].detach().numpy(), ref_p[k].numpy()
        np.testing.assert_allclose(got[defined], want[defined], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 2 * lr + 1e-7, k


def test_trainer_smoke():
    """(h) A 4-epoch VMCTrainer run at a small size with the kernel backend
    (plain core on the CPU): finite losses, parameters moved."""
    cfg = VMCConfig(batch_size=32, window=2, num_knots=8, n_flow_layers=1,
                    spline_degree=4, n_spline_base_mesh_points=400,
                    eval_backend='poly_pallas', device='cpu')
    t = VMCTrainer(cfg)
    before = [p.detach().clone() for p in t.model.parameters()]
    losses = t.train(num_epochs=4, verbose=False)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert t.epoch == 4
    assert any(not torch.equal(a, b) for a, b in
               zip(before, t.model.parameters()))


def test_trainer_divergence_recovery():
    """A window with a non-finite loss restores the last good parameters
    and Adam state and is not counted; training then goes on."""
    cfg = VMCConfig(batch_size=16, window=2, num_knots=8, n_flow_layers=1,
                    spline_degree=4, n_spline_base_mesh_points=400,
                    device='cpu')
    t = VMCTrainer(cfg)
    good = [p.detach().clone() for p in t.model.parameters()]
    real_step, calls = t.step, []

    def diverging_step(batch, baseline):
        calls.append(1)
        if len(calls) <= 2:                    # the whole first window
            with torch.no_grad():
                next(t.model.parameters()).fill_(float('nan'))
            return torch.tensor(float('nan'))
        return real_step(batch, baseline)

    diverging_step.optimizer = real_step.optimizer
    t.step = diverging_step
    t.train(num_epochs=2, verbose=False)
    assert t.epoch == 0 and t.losses == []
    assert all(torch.equal(a, b) for a, b in zip(good, t.model.parameters()))
    losses = t.train(num_epochs=2, verbose=False)
    assert t.epoch == 2 and len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize('override', [
    dict(num_processes=2), dict(coordinator_address='localhost:1234'),
    dict(process_id=0),
    dict(sampler='metropolis', clip_stat='median_abs'),
    dict(data_parallel='chips'),
    dict(data_parallel=2), dict(divergence_recovery=False)])
def test_trainer_refuses_unported_config(override):
    """What the trainer does not run raises NotImplementedError instead of
    being ignored: the MCMC windows with a clip statistic the JAX ones
    ignore, no divergence recovery, a data_parallel mode other than False /
    True / 'hosts', and the process fields without data_parallel (the JAX
    trainer would train the same walkers in every process).  2D and the
    antisym ansatz are ported (tests/test_torch_coords2d.py), and so are
    data_parallel (tests/test_torch_parallel.py,
    tests/test_torch_distributed.py), the table eval backend
    (tests/test_torch_table_backend.py) and the artifacts
    (tests/test_torch_utils.py)."""
    with pytest.raises(NotImplementedError):
        VMCTrainer(device='cpu', **override)


def test_sampling_backend_poly_raises():
    """The port refuses sampling_backend='poly' under a table eval backend,
    where the JAX package silently ignores it (and draws from the table)."""
    with pytest.raises(NotImplementedError, match="sampling_backend='poly'"):
        get_waveflow_model(2, **SMALL, eval_backend='table',
                           sampling_backend='poly', device='cpu')


@pytest.mark.parametrize('n,log_every,saved', [(15, 12, [10, 12, 15]),
                                                (7, 3, [3, 6, 7])])
def test_train_runs_whole_windows_then_ancestral_epochs(tmp_path, n,
                                                        log_every, saved):
    """train(n) at window 10 with sampler='metropolis', as the JAX trainer:
    n // 10 whole windows with the sampler, then the remainder — all of n
    when n < 10 — as single epochs of exact ancestral walkers through the
    train step, leaving the walkers as the last window left them (never
    drawn when no window ran); checkpoints after every round(log_every /
    window) windows, at single epochs with epoch % log_every == 0, and at
    the end."""
    t = VMCTrainer(VMCConfig(batch_size=8, window=10, log_every=log_every,
                             num_knots=8, n_flow_layers=1, spline_degree=4,
                             n_spline_base_mesh_points=400,
                             sampler='metropolis', save_dir=str(tmp_path),
                             device='cpu'))
    windows, steps, epochs = [], [], []
    real_window, real_step, real_save = t.mcmc_window, t.step, t.save_checkpoint

    def window(mstate, n_epochs, baseline, generator=None):
        out = real_window(mstate, n_epochs, baseline, generator)
        windows.append(out[3])
        return out

    def step(batch, baseline):
        steps.append(batch)
        return real_step(batch, baseline)

    step.optimizer = real_step.optimizer
    t.mcmc_window, t.step = window, step
    t.save_checkpoint = lambda d: epochs.append(t.epoch) or real_save(d)
    losses = t.train(n, verbose=False)
    assert t.epoch == n and len(losses) == n and np.isfinite(losses).all()
    assert len(windows) == n // 10 and len(t.accept_rates) == 10 * (n // 10)
    # the window's own updates go through t.mcmc_window's step, so the
    # wrapper sees exactly the single ancestral epochs
    assert len(steps) == n % 10
    assert t.mcmc_state is (windows[-1] if windows else None)
    assert epochs == saved
    assert np.load(tmp_path / 'loss.npy').shape == (n,)


def test_epoch_after_a_diverged_window_follows_jax():
    """train(6) at window 2 whose second window diverges: it is dropped
    (its losses too), and the epoch after the third is start + 3 × 2 = 6 —
    the JAX trainer's start + (w + 1) × window, which counts a dropped
    window once a later one succeeds."""
    cfg = VMCConfig(batch_size=8, window=2, num_knots=8, n_flow_layers=1,
                    spline_degree=4, n_spline_base_mesh_points=400,
                    device='cpu')
    t = VMCTrainer(cfg)
    real_step, calls, epochs = t.step, [], []

    def diverging_step(batch, baseline):
        calls.append(1)
        if len(calls) in (3, 4):                  # the whole second window
            return torch.tensor(float('nan'))
        epochs.append(t.epoch)
        return real_step(batch, baseline)

    diverging_step.optimizer = real_step.optimizer
    t.step = diverging_step
    losses = t.train(6, verbose=False)
    assert len(calls) == 6 and t.epoch == 6
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert epochs == [0, 0, 2, 2]                 # the third window starts at 2
