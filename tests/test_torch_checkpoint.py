"""Checkpoints of the port's trainer: exact resume from its own files, and
the JAX trainer's checkpoints carried across (params, flat Adam moments,
Metropolis walkers), on the CPU."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.vmc import VMCConfig as JVMCConfig
from waveflow_tpu.vmc import VMCTrainer as JVMCTrainer
from waveflow_tpu_torch.convert import (
    adam_state_from_jax, load_jax_checkpoint, params_from_jax)
from waveflow_tpu_torch.utils import load_state, save_state
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

torch.set_num_threads(2)

RESULTS = Path(__file__).resolve().parents[1] / 'results'
FLAGSHIP_DIR = RESULTS / 'r5_flagship_fwd_batched_100k'
METROPOLIS_DIR = RESULTS / 'he1d_metropolis_seed7'
SMALL = dict(num_knots=8, spline_degree=4, n_flow_layers=1,
             n_spline_base_mesh_points=400, device='cpu')


def test_save_state_is_atomic(tmp_path):
    """save_state writes through a .tmp file and leaves none behind;
    load_state returns None where there is no file."""
    path = tmp_path / 'sub' / 'checkpoints'
    save_state(path, {'a': np.arange(3), 'epoch': 4})
    got = load_state(path)
    assert got['epoch'] == 4 and np.array_equal(got['a'], np.arange(3))
    assert sorted(p.name for p in path.parent.iterdir()) == ['checkpoints']
    assert load_state(tmp_path / 'missing') is None


@pytest.mark.parametrize('sampler,refresh', [
    ('ancestral', 'auto'), ('metropolis', 'auto'), ('metropolis', 2)])
def test_resume_is_bitwise(tmp_path, sampler, refresh):
    """4 windows straight equal 2 windows, save_checkpoint, a fresh trainer's
    load_checkpoint and 2 more windows, to the bit: losses, parameters,
    Adam state, walkers.  The third case refreshes the Metropolis walkers
    every window, which must follow the run's window count."""
    kw = dict(batch_size=16, window=2, log_every=4, sampler=sampler,
              mcmc_refresh_every=refresh, **SMALL)
    straight = VMCTrainer(VMCConfig(**kw))
    losses = straight.train(8, verbose=False)
    first = VMCTrainer(VMCConfig(save_dir=str(tmp_path), **kw))
    first.train(4, verbose=False)
    assert (tmp_path / 'checkpoints').exists()
    assert (tmp_path / 'system_info.json').exists()
    assert np.load(tmp_path / 'loss.npy').shape == (4,)
    second = VMCTrainer(VMCConfig(save_dir=str(tmp_path), **kw))
    resumed = second.train(4, restart=True, verbose=False)
    assert second.epoch == straight.epoch == 8
    assert resumed == losses and np.isfinite(losses).all()
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    sa = straight.step.optimizer.state_dict()['state']
    sb = second.step.optimizer.state_dict()['state']
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    if sampler == 'metropolis':
        for a, b in zip(straight.mcmc_state, second.mcmc_state):
            assert torch.equal(a, b)
    assert torch.equal(straight.generator.get_state(),
                       second.generator.get_state())


def test_jax_checkpoint_one_step_matches_jax():
    """The committed 100k checkpoint with its Adam moments (count 100,000),
    one step on a fixed batch of 64: the port's trainer after
    load_checkpoint against the JAX trainer's load_checkpoint + step_jit, at
    the tolerances of test_torch_vmc.py::test_train_step_matches_jax (loss
    rtol 1e-4; parameters rtol 1e-4, atol 1e-7, and |Δ| <= 2 lr).  The
    parameters with no torch gradient (the zero_params) carry zero moments
    in the checkpoint, so torch's Adam, which skips them, matches optax's."""
    t = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cpu'))
    assert t.load_checkpoint(str(FLAGSHIP_DIR))
    assert t.epoch == 100_000 and len(t.losses) == 100_000
    opt = t.step.optimizer
    named = dict(t.model.named_parameters())
    assert set(opt.state) == set(named.values())
    for name, p in named.items():
        assert opt.state[p]['step'].item() == 100_000
        if name.endswith('zero_params'):
            assert not opt.state[p]['exp_avg'].any()
            assert not opt.state[p]['exp_avg_sq'].any()
    batch = t.model.sample(64, generator=torch.Generator().manual_seed(5))
    before = {k: v.detach().clone() for k, v in named.items()}
    loss = t.step(batch, torch.zeros(()))

    jt = JVMCTrainer(JVMCConfig(compilation_cache_dir=None))
    assert jt.load_checkpoint(str(FLAGSHIP_DIR))
    new_params, _, jloss = jt.step_jit(jt.params, jt.opt_state,
                                       jnp.asarray(batch.numpy()),
                                       jnp.zeros(()))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    ref = params_from_jax(jax.device_get(new_params))
    moved = 0
    for k in ref:
        got = named[k].detach()
        np.testing.assert_allclose(got.numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        assert (got - ref[k]).abs().max().item() <= 2 * 1e-4 + 1e-7, k
        moved += int((got != before[k]).sum())
    assert moved > 0


def test_metropolis_state_round_trips(tmp_path):
    """he1d_metropolis_seed7's MetropolisState (256 walkers, adapted step
    1.2531267, rate 0.49409923) lands in the port's trainer bit for bit and
    survives the port's own save_checkpoint / load_checkpoint, with the
    params, Adam state, epoch and generator."""
    ck = load_jax_checkpoint(METROPOLIS_DIR / 'checkpoints')
    cfg = VMCConfig(sampler='metropolis', device='cpu')
    t = VMCTrainer(cfg)
    assert t.load_checkpoint(str(METROPOLIS_DIR))
    for got, want in zip(t.mcmc_state, ck['mcmc_state']):
        np.testing.assert_array_equal(got.numpy(), want)
    assert t.mcmc_state.positions.shape == (256, 2)
    assert t.mcmc_state.step_size.item() == np.float32(1.2531267)
    t.save_checkpoint(str(tmp_path))
    u = VMCTrainer(cfg)
    assert u.load_checkpoint(str(tmp_path))
    for a, b in zip(t.mcmc_state, u.mcmc_state):
        assert torch.equal(a, b)
    assert u.epoch == 100_000 and u.losses == t.losses
    for a, b in zip(t.model.parameters(), u.model.parameters()):
        assert torch.equal(a, b)
    sa = t.step.optimizer.state_dict()['state']
    sb = u.step.optimizer.state_dict()['state']
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert torch.equal(t.generator.get_state(), u.generator.get_state())


def test_pre_flatten_opt_state_reinitialises_adam(tmp_path, capsys):
    """A JAX checkpoint whose opt_state is the per-leaf chain(clip, adam)
    state (before the optax.flatten change) loads its params and epoch and
    starts Adam afresh with the JAX trainer's notice; adam_state_from_jax
    refuses it."""
    jparams, *_ = jget_waveflow_model(
        2, base_spline_degree=4, i_spline_degree=4, n_prior_internal_knots=8,
        n_i_internal_knots=8, i_spline_reg=0.05, n_flow_layers=1,
        box_size=10.0, n_spline_base_mesh_points=400)(jax.random.PRNGKey(1), 2)
    opt_state = optax.chain(optax.clip_by_global_norm(10.0),
                            optax.adam(1e-4)).init(jparams)
    with open(tmp_path / 'checkpoints', 'wb') as f:
        pickle.dump({'params': jax.device_get(jparams),
                     'opt_state': jax.device_get(opt_state), 'epoch': 7,
                     'rng': np.zeros(2, np.uint32), 'walker_keys': None,
                     'mcmc_state': None}, f)
    t = VMCTrainer(VMCConfig(**SMALL))
    assert t.load_checkpoint(str(tmp_path))
    assert "re-initializing adam moments" in capsys.readouterr().out
    assert len(t.step.optimizer.state) == 0 and t.epoch == 7
    assert t.mcmc_state is None
    ref = params_from_jax(jax.device_get(jparams))
    for k, v in t.model.named_parameters():
        assert torch.equal(v.detach(), ref[k]), k
    ck = load_jax_checkpoint(tmp_path / 'checkpoints')
    with pytest.raises(ValueError):
        adam_state_from_jax(ck['opt_state'], ck['params'],
                            t.model.named_parameters())
    assert np.isfinite(t.train(2, verbose=False)).all()
