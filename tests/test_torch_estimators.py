"""Parity of the port's estimators (vmc/estimators.py) with the JAX
package, on the CPU: ``local_energy``'s value and derivative rules, the
'reference' loss and its gradient under every Laplacian form, with and
without a baseline and an energy clip, the 'median_abs' clip statistic,
the parity variants ``loss_fn_uniform`` and ``make_policy_gradient_step``,
one adam step of the 'reference' estimator, and the window's baseline."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import estimators as jest
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import (
    local_energy, loss_fn_uniform, make_loss_fn, make_policy_gradient_step,
    make_train_step, run_window)

torch.set_num_threads(2)

SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)
PROTONS = system_catalogue[1]['He'][0]
B = 16


@pytest.fixture(scope='module')
def pair():
    """(JAX params, psi, log_pdf; port model; 16 walkers drawn by JAX)."""
    jparams, jpsi, jlog_pdf, jsample = jget_waveflow_model(2, **SMALL)(
        jax.random.PRNGKey(3), 2)
    m = get_waveflow_model(2, **SMALL, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, B))
    return jparams, jpsi, jlog_pdf, m, x


def _hamiltonians(jpsi, m, mode):
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode=mode)
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode=mode)
    return jh, h


def _grads(m, loss):
    """The loss's gradient as {name: tensor}, zeros where none flows."""
    named = dict(m.named_parameters())
    for p in named.values():
        p.grad = None
    loss.backward()
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in named.items()}


def _rel(got: dict, want: dict) -> float:
    """Relative global-norm error of one parameter dict against another."""
    g = torch.cat([got[k].ravel() for k in want])
    w = torch.cat([want[k].ravel() for k in want])
    return ((g - w).norm() / w.norm()).item()


def _energies_psi():
    """(B, 1) energies and ψ with walkers below PSI_EPS of both signs and
    exactly on a node (the ``_safe_psi`` branch)."""
    rng = np.random.default_rng(0)
    e = rng.normal(size=(12, 1)).astype(np.float32)
    p = rng.normal(size=(12, 1)).astype(np.float32)
    p[:4, 0] = [3e-9, -3e-9, 0.0, -1e-12]
    return e, p


def test_local_energy_value_and_rules():
    """Value, jvp and backward of ``local_energy`` against JAX's custom-JVP
    function (``jax.jvp``; ``jax.grad`` of a weighted sum for the
    backward): rtol 1e-6 — the walkers with |ψ| < 1e-8 included, where
    the rule divides by the clamped ψ and the baseline gets nothing."""
    e, p = _energies_psi()
    b = np.float32(0.37)
    rng = np.random.default_rng(1)
    te, tp, w = (rng.normal(size=e.shape).astype(np.float32)
                 for _ in range(3))
    j_val, j_tan = jax.jvp(jest.local_energy, (e, p, b),
                           (te, tp, np.float32(5.0)))
    jg_e, jg_p = jax.grad(
        lambda ee, pp: (w * jest.local_energy(ee, pp, b)).sum(),
        argnums=(0, 1))(e, p)

    E, P = torch.as_tensor(e), torch.as_tensor(p)
    val, tan = torch.func.jvp(
        lambda ee, pp: local_energy(ee, pp, torch.tensor(b)), (E, P),
        (torch.as_tensor(te), torch.as_tensor(tp)))
    E.requires_grad_(True)
    P.requires_grad_(True)
    base = torch.tensor(b, requires_grad=True)
    (torch.as_tensor(w) * local_energy(E, P, base)).sum().backward()
    for got, want in ((val, j_val), (tan, j_tan), (E.grad, jg_e),
                      (P.grad, jg_p)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6)
    assert base.grad is None
    assert np.isfinite(tan.numpy()).all()


# (laplacian_mode, energy_clip as a quantile of |E_L|); every case at
# baseline 0 and at a baseline near the batch's energy
REFERENCE_CASES = [('fwd_batched', None), ('fwd', None), ('hvp', None),
                   ('dense', None), ('dense', 0.75)]


@pytest.mark.parametrize('mode,clip_q', REFERENCE_CASES)
def test_reference_loss_and_gradient_match_jax(pair, mode, clip_q):
    """The 'reference' loss and its parameter gradient (reverse mode
    through the Laplacian and ``local_energy``'s rule) against
    ``jax.value_and_grad`` of JAX's loss on the same walkers: value rtol
    1e-5, gradient relative global-norm error 1e-4; with the fixed energy
    clip at the 75th percentile of |E_L| where ``clip_q`` is set."""
    jparams, jpsi, _, m, x = pair
    jh, h = _hamiltonians(jpsi, m, mode)
    energy_clip = None
    if clip_q is not None:
        e_loc = np.asarray(jax.jit(jh)(jparams, x))[:, 0] / np.asarray(
            jax.jit(jpsi)(jparams, x))
        energy_clip = float(np.quantile(np.abs(e_loc), clip_q))
    jloss = jax.jit(jax.value_and_grad(jest.make_loss_fn(
        jpsi, jh, estimator='reference', energy_clip=energy_clip)))
    loss_fn = make_loss_fn(m.psi, h, estimator='reference',
                           energy_clip=energy_clip)
    for baseline in (0.0, -1.5):
        j_val, j_grads = jloss(jparams, x, jnp.float32(baseline))
        loss = loss_fn(torch.as_tensor(x), torch.tensor(baseline))
        assert loss.item() == pytest.approx(float(j_val), rel=1e-5)
        grads = _grads(m, loss)
        assert _rel(grads, params_from_jax(jax.device_get(j_grads))) <= 1e-4


def test_median_abs_clip_matches_jax(pair):
    """clip_stat='median_abs' (median ± 5 × median|E_L − median|, jnp's
    median): the clipped-score loss value rtol 1e-5 and gradient relative
    global-norm error 1e-4 against JAX; the window is tighter than
    'mean_abs''s here, so the two losses differ."""
    jparams, jpsi, _, m, x = pair
    jh, h = _hamiltonians(jpsi, m, 'fwd_batched')
    j_val, j_grads = jax.jit(jax.value_and_grad(jest.make_loss_fn(
        jpsi, jh, clip_stat='median_abs')))(jparams, x, jnp.zeros(()))
    loss = make_loss_fn(m.psi, h, clip_stat='median_abs')(
        torch.as_tensor(x), torch.zeros(()))
    assert loss.item() == pytest.approx(float(j_val), rel=1e-5)
    assert _rel(_grads(m, loss),
                params_from_jax(jax.device_get(j_grads))) <= 1e-4
    mean_abs = make_loss_fn(m.psi, h)(torch.as_tensor(x), torch.zeros(()))
    assert mean_abs.item() != pytest.approx(loss.item(), rel=1e-4)


def test_loss_fn_uniform_matches_jax(pair):
    """The uniform-sampling Rayleigh quotient: value rtol 1e-5, gradient
    (the denominator held constant) relative global-norm error 1e-4."""
    jparams, jpsi, _, m, x = pair
    jh, h = _hamiltonians(jpsi, m, 'fwd_batched')
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jest.loss_fn_uniform(p, jpsi, jh, b)))(jparams, x)
    loss = loss_fn_uniform(m.psi, h, torch.as_tensor(x))
    assert loss.item() == pytest.approx(float(j_val), rel=1e-5)
    assert _rel(_grads(m, loss),
                params_from_jax(jax.device_get(j_grads))) <= 1e-4


def test_policy_gradient_step_matches_jax(pair):
    """One ``make_policy_gradient_step`` update with SGD (lr 1e-3) at a
    baseline of 0.4: loss rtol 1e-5; the update (energy gradient + the
    per-walker log-pdf Jacobian weighted by E_L − b, clipped to ±10)
    relative global-norm error 1e-4 and every parameter within 1e-7 of
    JAX's.  No leaf of the model is 0-d, so JAX's leaf-wise broadcast of
    (B, 1) weights meets only 1-D and 2-D leaves."""
    jparams, jpsi, jlog_pdf, m, x = pair
    jh, h = _hamiltonians(jpsi, m, 'fwd_batched')
    lr, baseline = 1e-3, 0.4
    opt = optax.sgd(lr)
    jstep = jax.jit(jest.make_policy_gradient_step(jpsi, jh, jlog_pdf, opt))
    new_params, _, j_loss = jstep(jparams, opt.init(jparams), x,
                                  jnp.float32(baseline))
    assert all(np.ndim(v) > 0 for v in jax.tree_util.tree_leaves(jparams))

    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    step = make_policy_gradient_step(
        m, h, torch.optim.SGD(m.parameters(), lr=lr))
    try:
        loss = step(torch.as_tensor(x), torch.tensor(baseline))
        assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
        ref = params_from_jax(jax.device_get(new_params))
        named = dict(m.named_parameters())
        d_t = {k: named[k].detach() - before[k] for k in ref}
        d_j = {k: ref[k] - before[k] for k in ref}
        assert _rel(d_t, d_j) <= 1e-4
        for k in ref:
            np.testing.assert_allclose(named[k].detach().numpy(),
                                       ref[k].numpy(), rtol=0, atol=1e-7,
                                       err_msg=k)
    finally:
        m.load_state_dict(before)


def test_reference_adam_step_matches_jax(pair):
    """One step of JAX's ``make_train_step`` (estimator='reference',
    optax.flatten(clip 10 + adam 1e-4)) against the port's from the same
    parameters, walkers and baseline (-1.2): loss rtol 1e-5; updated
    parameters rtol 1e-4 where |g| is above float noise (Adam's first step
    is sign-like), within 2 lr elsewhere."""
    jparams, jpsi, _, m, x = pair
    jh, h = _hamiltonians(jpsi, m, 'fwd_batched')
    lr, baseline = 1e-4, -1.2
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    jstep = jax.jit(jest.make_train_step(jpsi, jh, opt,
                                         estimator='reference'))
    new_params, _, j_loss = jstep(jparams, opt.init(jparams), x,
                                  jnp.float32(baseline))
    _, j_grads = jax.jit(jax.value_and_grad(jest.make_loss_fn(
        jpsi, jh, estimator='reference')))(jparams, x, jnp.float32(baseline))

    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    step = make_train_step(m.psi, h, m.parameters(), lr, grad_clip=10.0,
                           estimator='reference')
    try:
        loss = step(torch.as_tensor(x), torch.tensor(baseline))
        assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
        ref_g = params_from_jax(jax.device_get(j_grads))
        ref_p = params_from_jax(jax.device_get(new_params))
        g_max = max(v.abs().max().item() for v in ref_g.values())
        named = dict(m.named_parameters())
        for k in ref_p:
            defined = (ref_g[k].abs() > 1e-5 * g_max).numpy()
            got, want = named[k].detach().numpy(), ref_p[k].numpy()
            np.testing.assert_allclose(got[defined], want[defined],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
            assert np.abs(got - want).max() <= 2 * lr + 1e-7, k
    finally:
        m.load_state_dict(before)


def test_window_returns_the_mean_loss_as_baseline():
    """``run_window`` hands every step the baseline it was given and
    returns the losses and their mean — bit for bit ``losses.mean()``,
    and equal to the f32 mean JAX's ``make_window_from_step`` returns for
    the same losses."""
    losses = np.array([0.5, -1.25, 3.0, 2.0625, -0.75], np.float32)
    seen, it = [], iter(losses)

    def step(batch, baseline):
        seen.append(baseline)
        return torch.tensor(next(it))

    b0 = torch.tensor(0.3)
    got, base = run_window(step, lambda n: torch.zeros(n, 2), 4, 5, b0)
    assert all(s is b0 for s in seen)
    np.testing.assert_array_equal(got.numpy(), losses)
    assert torch.equal(base, got.mean())

    def jstep(params, opt_state, batch, baseline):
        return params, opt_state, jnp.asarray(losses)[opt_state]

    jwin = jest.make_window_from_step(
        lambda p, o, b, bl: (p, o + 1, jstep(p, o, b, bl)[2]),
        lambda k, p, n: jnp.zeros((n, 2)), 4, 5)
    *_, j_base, j_losses = jax.jit(jwin)(jnp.zeros(()), jnp.int32(0),
                                         jax.random.PRNGKey(0),
                                         jnp.float32(0.3))
    np.testing.assert_array_equal(np.asarray(j_losses), losses)
    assert base.item() == pytest.approx(float(j_base), rel=1e-7)
