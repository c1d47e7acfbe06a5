"""Replay helpers shared by the probprog parity tests
(tests/test_torch_probprog.py, tests/test_torch_posterior.py): the JAX
samplers' key trees turned into the port's explicit draws, JAX's NUTS tree
sizes read from its while_loop, and the step-by-step replays.

Tolerances are relative to the largest magnitude of the compared array
(``close``): f32 gradients taken in two frameworks differ in the last
bits, and a trajectory of leapfrog steps carries that on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from waveflow_tpu.vmc import hmc as jhmc
from waveflow_tpu.vmc import nuts as jnuts
from waveflow_tpu_torch.vmc import hmc, nuts, smc

GAUSS_RTOL = 1e-5        # HMC / NUTS / SMC on Gaussians (f32 arithmetic)
MODEL_RTOL = 1e-4        # through a flow: f32 gradients of two frameworks


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, rtol, what=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def close_state(got, ref, rtol):
    for i, (g, r) in enumerate(zip(got, ref)):
        close(g, r, rtol, getattr(ref, '_fields', range(99))[i])


def hmc_draws(key, shape):
    """The momentum and accept uniforms of JAX's HMC step_fn(state, key)
    (vmc/hmc.py:64-74)."""
    rng_mom, rng_acc = jax.random.split(key)
    return (t(jax.random.normal(rng_mom, shape)),
            t(jax.random.uniform(rng_acc, shape[:1])))


def replay_hmc(jlp, tlp, pos, n_leapfrog, step_size, n_warmup, n_plain,
               rtol):
    jinit, jstep, _ = jhmc.make_hmc_sampler(jlp, n_leapfrog=n_leapfrog)
    init, step, _ = hmc.make_hmc_sampler(tlp, n_leapfrog=n_leapfrog)
    js = jinit(jnp.asarray(pos), step_size=step_size)
    close_state(init(t(pos), step_size=step_size), js, rtol)
    jstep = jax.jit(jstep, static_argnums=2)
    keys = jax.random.split(jax.random.PRNGKey(1), n_warmup + n_plain)
    n_accepted = 0
    for n, key in enumerate(keys):
        warmup = n < n_warmup
        ts = hmc.HMCState(*(t(a) for a in js))
        js_next = jstep(js, key, warmup)
        got = step(ts, *hmc_draws(key, pos.shape), warmup)
        close_state(got, js_next, rtol)
        n_accepted += int((np.asarray(js_next.position)
                           != np.asarray(js.position)).any(-1).sum())
        js = js_next
    # the replay went through both branches of the accept rule
    assert 0 < n_accepted < len(keys) * pos.shape[0]


def nuts_draws(key, B, D, max_depth) -> nuts.NUTSDraws:
    """JAX's NUTS key tree (vmc/nuts.py) for step_fn(state, key) as the
    port's draw bundle: split(key, B) over chains; per chain
    (k_mom, k_loop); per doubling split(key, 4) = (key, k_dir, k_sub,
    k_merge); per leaf of the subtree split(key) = (key, k_acc) from k_sub.
    Every doubling's draws are taken, whether the tree reaches it or not."""
    def chain(k):
        k_mom, key = jax.random.split(k)
        dirs, merges, leaves = [], [], []
        for j in range(max_depth):
            key, k_dir, k_sub, k_merge = jax.random.split(key, 4)
            dirs.append(jax.random.bernoulli(k_dir))
            merges.append(jax.random.uniform(k_merge))
            for _ in range(2 ** j):
                k_sub, k_acc = jax.random.split(k_sub)
                leaves.append(jax.random.uniform(k_acc))
        leaves.append(jnp.zeros(()))        # the bundle's spare slot
        return (jax.random.normal(k_mom, (D,)), jnp.stack(dirs),
                jnp.stack(leaves), jnp.stack(merges))

    mom, dirs, leaves, merges = jax.jit(jax.vmap(chain))(
        jax.random.split(key, B))
    return nuts.NUTSDraws(t(mom), t(dirs), t(leaves), t(merges))


def record_jax_tree_sizes(monkeypatch):
    """Record the depth and leaf count of the trees JAX's NUTS builds: its
    outer while_loop carries them, a debug callback reads them (once per
    chain under vmap, in no fixed order), keyed by the chain's loop key."""
    rec = {}
    orig = jax.lax.while_loop

    def while_loop(cond, body, init):
        out = orig(cond, body, init)
        if isinstance(init, dict) and 'depth' in init:
            def record(k, d, n):
                rec[tuple(np.asarray(k).tolist())] = (int(d), int(n))
            jax.debug.callback(record, init['key'], out['depth'],
                               out['n_alpha'])
        return out

    monkeypatch.setattr(jax.lax, 'while_loop', while_loop)
    return rec


def replay_nuts(jlp, tlp, pos, max_depth, step_size, n_warmup, n_plain,
                rtol, rec, da_rtol=None):
    """Replay JAX's NUTS steps; positions and log densities within ``rtol``,
    the dual-averaging fields within ``da_rtol`` (default ``rtol``)."""
    jinit, jstep, _ = jnuts.make_nuts_sampler(jlp, max_tree_depth=max_depth)
    init, step, _ = nuts.make_nuts_sampler(tlp, max_tree_depth=max_depth)
    js = jinit(jnp.asarray(pos), step_size=step_size)
    close_state(init(t(pos), step_size=step_size), js, rtol)
    jstep = jax.jit(jstep, static_argnums=2)
    B, D = pos.shape
    depths = []
    for n, key in enumerate(jax.random.split(jax.random.PRNGKey(3),
                                             n_warmup + n_plain)):
        warmup = n < n_warmup
        ts = nuts.NUTSState(*(t(a) for a in js))
        rec.clear()
        js = jstep(js, key, warmup)
        jax.block_until_ready(js)
        jax.effects_barrier()
        got, info = step(ts, nuts_draws(key, B, D, max_depth), warmup,
                         return_info=True)
        loop_keys = [jax.random.split(k)[1]
                     for k in jax.random.split(key, B)]
        jdepth, jleaves = (np.asarray(a) for a in zip(
            *(rec[tuple(np.asarray(k).tolist())] for k in loop_keys)))
        np.testing.assert_array_equal(info.depth.numpy(), jdepth)
        np.testing.assert_array_equal(info.n_leaves.numpy(), jleaves)
        close_state(got[:2], js[:2], rtol)
        close_state(got[2:], js[2:], da_rtol or rtol)
        depths.append(jdepth)
    return np.stack(depths)


def smc_draws(key, n_temps, n_moves, N, D):
    """JAX's SMC key tree (vmc/smc.py): split(key, n_temps); per
    temperature (rng, rng_rs) then (rng, rng_mv); split(rng_mv, n_moves);
    per move (rng_p, rng_a)."""
    out = []
    for k in jax.random.split(key, n_temps):
        k, k_rs = jax.random.split(k)
        _, k_mv = jax.random.split(k)
        noise, u = [], []
        for km in jax.random.split(k_mv, n_moves):
            k_p, k_a = jax.random.split(km)
            noise.append(jax.random.normal(k_p, (N, D)))
            u.append(jax.random.uniform(k_a, (N,)))
        out.append(smc.SMCDraws(t(jax.random.uniform(k_rs)),
                                t(jnp.stack(noise)), t(jnp.stack(u))))
    return out
