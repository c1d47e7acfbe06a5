"""Stochastic reconfiguration (SR) and SPRING natural-gradient VMC updates.

Port of waveflow_tpu/vmc/sr.py.  Both precondition the
energy gradient g = 2 E[(E_L^clip − Ē) O] with the quantum geometric tensor
S = E[O Oᵀ] − E[O] E[O]ᵀ, O = ∂_θ log|ψ|:

* SR (``make_sr_train_step``) solves (S + λ) δ = g by matrix-free conjugate
  gradients, each S·v one ``torch.func.jvp`` and one ``torch.func.vjp`` of
  log|ψ| with respect to the parameters;
* SPRING (``make_spring_train_step``) solves the same update in sample
  space, δ = Ōᵀ (Ō Ōᵀ + Bλ)⁻¹ ζ + μ δ_prev, from the per-walker score matrix
  Ō = ``vmap(grad(log|ψ|))`` over the walkers, one (B, B) Cholesky with a
  retry ladder at 10× and 100× damping, and momentum μ.

Both steps have the port's step contract, ``step(batch, baseline) -> loss``
with the parameters living in the model (the baseline is ignored, as in
JAX), and keep their optimizer state behind
``step.optimizer`` with the ``state_dict`` / ``load_state_dict`` interface
of a ``torch.optim`` optimizer: SR's is ``()``, SPRING's the dict
{'delta': flat previous update, 'step', 'skipped', 'fallbacks'} of device
tensors, written in place by every step (so a CUDA graph can replay it),
its flat vector in the JAX ``ravel_pytree`` order (``convert.ravel_order``)
so that a JAX SPRING state resumes.  No step reads the device from the
host.

Walkers sharded over ranks (``pmean_axis``, parallel/mesh.py): the clip
window comes from every rank's local energies (an all-gather).  SR
``pmean``-reduces every batch expectation — g, Ō and the S·v of each of the
``cg_iters`` masked CG iterations, one flat all-reduce each — so every rank
runs the same CG on the global S and makes the same collectives.  SPRING
assembles the global (B, B) Gram matrix from column chunks of
``GRAM_CHUNK`` score columns, all-gathered, and projects the update as
``psum(O_localᵀ x_local)``: the global (B, P) score matrix is never built on
one rank.  Plain PyTorch, as in the reference; the kernels
on this path are the ones inside ψ (K3 under ``eval_backend='poly_pallas'``,
one launch per jet call for the whole vmapped batch).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from waveflow_tpu_torch.convert import ravel_layout
from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc.estimators import (
    PSI_EPS, _median, _safe_psi, clip_window, global_energies, run_window,
)

# score columns per all-gather when the sharded SPRING step assembles its
# Gram matrix (JAX sr.py:245): B_global × 4,096 floats in flight at a time
GRAM_CHUNK = 4096


def _vdot(xs, ys) -> torch.Tensor:
    """Σ over leaves of ⟨x, y⟩ (jax's ``_vdot_real_tree`` on real leaves)."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(xs, ys))


def _norm_cap(delta, learning_rate: float, max_update_norm: float | None):
    """Trust region on a list of tensors: shrink δ so ‖lr·δ‖₂ ≤
    max_update_norm.  A non-finite solve zeroes the step (the batch is
    skipped, not the run): non-finite entries become 0 and a non-finite
    scale becomes 0."""
    if max_update_norm is None:
        return delta
    scale = torch.clamp(
        max_update_norm / (learning_rate * torch.sqrt(_vdot(delta, delta))
                           + 1e-30), max=1.0)
    scale = torch.where(torch.isfinite(scale), scale, 0.0)
    return [scale * torch.where(torch.isfinite(d), d, 0.0) for d in delta]


def cg(matvec, b, maxiter: int, tol: float = 1e-5):
    """``jax.scipy.sparse.linalg.cg(matvec, b, maxiter=maxiter)`` on a list
    of tensors, from x₀ = 0: stops once ‖r‖² ≤ tol² ‖b‖² or after
    ``maxiter`` iterations, with the reference's inner products and update
    order.  The stop is a mask (x, r, p and ‖r‖² frozen once it holds), so
    no iteration reads the device from the host; the iterations after it
    are computed and dropped."""
    x = [torch.zeros_like(v) for v in b]
    r, p = list(b), list(b)                 # r₀ = b − A(0) = b
    gamma = _vdot(r, r)
    atol2 = torch.square(torch.tensor(tol, dtype=gamma.dtype)) * gamma
    for _ in range(maxiter):
        active = gamma > atol2
        ap = matvec(p)
        alpha = gamma / _vdot(p, ap)
        x_new = [xi + alpha * pi for xi, pi in zip(x, p)]
        r_new = [ri - alpha * ai for ri, ai in zip(r, ap)]
        gamma_new = _vdot(r_new, r_new)
        beta = gamma_new / gamma
        p_new = [ri + beta * pi for ri, pi in zip(r_new, p)]
        x = [torch.where(active, a, o) for a, o in zip(x_new, x)]
        r = [torch.where(active, a, o) for a, o in zip(r_new, r)]
        p = [torch.where(active, a, o) for a, o in zip(p_new, p)]
        gamma = torch.where(active, gamma_new, gamma)
    return x


class StepState:
    """A natural-gradient step's optimizer state behind the ``state_dict``
    / ``load_state_dict`` interface of ``torch.optim``, which the trainer
    snapshots, saves and restores for every optimizer alike.  ``state`` is
    ``()`` (SR) or a dict of tensors on the step's device (SPRING), which
    every step writes in place, as Adam writes its moments: a CUDA graph
    captured on them reads and writes the same tensors at every replay.
    ``state_dict()`` hands out those tensors, as Adam's does."""

    def __init__(self, state):
        self.state = state

    def state_dict(self):
        return self.state

    def load_state_dict(self, state):
        """Tensors, or numpy arrays (checkpoints), copied into the step's
        own tensors (so none is shared with the caller's), each of the
        shape it has."""
        if not isinstance(state, dict):
            self.state = state
            return
        if state.keys() != self.state.keys():
            raise ValueError(f"optimizer state keys {sorted(state)}, "
                             f"expected {sorted(self.state)}")
        for k, v in state.items():
            v = torch.as_tensor(v)
            if v.shape != self.state[k].shape:
                raise ValueError(f"optimizer state {k!r} of shape "
                                 f"{tuple(v.shape)}, expected "
                                 f"{tuple(self.state[k].shape)}")
            self.state[k].copy_(v)


def make_score_fn(model):
    """(flatten, scores): ``flatten()`` is the model's parameters as one
    detached vector in ravel order, ``scores(flat, batch)`` the per-walker
    score matrix O[i] = ∂ log(|ψ(x_i)| + PSI_EPS) / ∂θ at θ = flat, (B, P),
    by ``vmap(grad(...))`` over the walkers — one vmapped backward, in
    which every basis-jet call is one core call for all walkers (the jet's
    vmap rule).  The parameters off the path (zero_params) get zero
    columns, as in JAX."""
    names, params = ravel_layout(model)
    shapes = [p.shape for p in params]
    sizes = [p.numel() for p in params]

    def flatten():
        return torch.cat([p.detach().reshape(-1) for p in params])

    def log_abs_psi_flat(flat, x):
        p = {n: t.view(s) for n, t, s in zip(names, flat.split(sizes),
                                             shapes)}
        return torch.log(torch.abs(functional_call(
            model, p, (x[None],)))[0] + PSI_EPS)

    return flatten, torch.func.vmap(torch.func.grad(log_abs_psi_flat),
                                    in_dims=(None, 0))


def _local_energies(model, h_fn, batch, clip_scale, pmean_axis=None):
    """(the clipped local energies of ``batch``, the clipped mean over the
    global population) — the clip window from ``global_energies``."""
    with torch.no_grad():
        energies = h_fn(batch)[:, 0]
        e_loc = energies / _safe_psi(model.psi(batch))
        e_stat = global_energies(e_loc, pmean_axis)
        lo, hi = clip_window(e_stat, clip_scale)
        return torch.clamp(e_loc, lo, hi), torch.clamp(e_stat, lo, hi).mean()


def gram_matrix(O: torch.Tensor, pmean_axis=None,
                chunk: int = GRAM_CHUNK) -> torch.Tensor:
    """O Oᵀ of the score rows of every rank, (B_global, B_global): without
    an axis O @ O.T, else the sum over column blocks of ``chunk`` of G Gᵀ,
    G the block all-gathered over the ranks (B_global, chunk), so that no
    rank holds the global (B, P) score matrix."""
    if pmean_axis is None:
        return O @ O.T
    return sum(g @ g.T for g in (mesh.all_gather(cols, pmean_axis)
                                 for cols in O.split(chunk, dim=1)))


def _pmean_leaves(leaves, pmean_axis):
    """Each tensor of ``leaves`` averaged over the ranks, one flat
    all-reduce; the leaves themselves without an axis."""
    if pmean_axis is None:
        return leaves
    flat = mesh.pmean(torch.cat([t.reshape(-1) for t in leaves]), pmean_axis)
    return [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in leaves]), leaves)]


def make_sr_train_step(model, h_fn, learning_rate: float,
                       damping: float = 1e-3, cg_iters: int = 20,
                       clip_scale: float = 5.0, pmean_axis=None,
                       max_update_norm: float | None = None):
    """step(batch, baseline) -> loss: one SR update of ``model``'s
    parameters (``baseline`` ignored).

    g = 2 E[(E_L^clip − Ē) O] and Ō = E[O] by the vjp of log|ψ| over the
    batch; δ = CG(S + λ, g) with S·v = E[O (O·v)] − Ō (Ō·v); δ capped by
    ``_norm_cap``; θ ← θ − lr·δ.  ``step.optimizer`` holds the state
    ``()``.  Under ``pmean_axis``: the clip window over every rank's
    energies, and Ē, g, Ō and each S·v averaged over the ranks (JAX's
    local mean, then ``pmean``)."""
    if pmean_axis is not None:
        mesh.check_axis(pmean_axis)
    names, params = ravel_layout(model)

    def log_abs_psi(p, batch):
        return torch.log(torch.abs(functional_call(model, p, (batch,)))
                         + PSI_EPS)

    def step(batch: torch.Tensor, baseline) -> torch.Tensor:
        B = batch.shape[0]
        p0 = {n: p.detach() for n, p in zip(names, params)}
        e_c, _ = _local_energies(model, h_fn, batch, clip_scale, pmean_axis)
        e_mean = e_c.mean()
        if pmean_axis is not None:
            e_mean = mesh.pmean(e_mean, pmean_axis)
        w = e_c - e_mean                          # centred clipped energies

        def f(p):
            return log_abs_psi(p, batch)

        _, vjp_fn = torch.func.vjp(f, p0)

        def batch_mean_vjp(cotangent):
            out = vjp_fn(cotangent / B)[0]
            return _pmean_leaves([out[n] for n in names], pmean_axis)

        g = batch_mean_vjp(2.0 * w)               # 2 E[(E_L − Ē) O]
        o_bar = batch_mean_vjp(torch.ones_like(w))   # E[O]

        def s_mv(v):
            # (O·v) per walker by one jvp, then E[O (O·v)] by one vjp
            _, ov = torch.func.jvp(f, (p0,), (dict(zip(names, v)),))
            first = batch_mean_vjp(ov)
            obar_dot_v = _vdot(o_bar, v)
            return [fi - ob * obar_dot_v + damping * vi
                    for fi, ob, vi in zip(first, o_bar, v)]

        with torch.no_grad():
            delta = _norm_cap(cg(s_mv, g, cg_iters), learning_rate,
                              max_update_norm)
            for p, d in zip(params, delta):
                p.copy_(p - learning_rate * d)
        return e_mean

    step.optimizer = StepState(())
    return step


def make_spring_train_step(model, h_fn, learning_rate: float,
                           damping: float = 1e-3, momentum: float = 0.99,
                           clip_scale: float = 5.0, pmean_axis=None,
                           max_update_norm: float | None = None,
                           score_row_clip: float | None = 10.0,
                           score_row_clip_warmup: int | None = 1000):
    """step(batch, baseline) -> loss: one min-SR / SPRING update of
    ``model``'s parameters (``baseline`` ignored; the reference's docstring
    has the derivation).

    O = vmap(grad(log|ψ|)) over the walkers on the flat parameter vector
    (B, P); while ``step < score_row_clip_warmup`` rows with ‖O_i‖ above
    ``score_row_clip`` × their median are shrunk onto that ball; O and
    2E_L^clip are centred; ζ = ε − O (μ δ_prev); x = (O Oᵀ + mBλ)⁻¹ ζ by
    Cholesky at m = 1, else 10, else 100 (a failed factorisation reads as
    NaN, as in JAX, and counts one ``fallbacks`` when m = 1 fails);
    δ = Oᵀx + μ δ_prev, zeroed when not finite (one ``skipped``), capped by
    ``_norm_cap``, applied and stored.

    Under ``pmean_axis`` (JAX's memory-lean sharded path): ε, the row
    norms and O·(μ δ_prev) are all-gathered, O is centred by the ``pmean``
    of the local column means, the Gram matrix is the sum over chunks of
    ``GRAM_CHUNK`` columns of G Gᵀ, G the all-gathered chunk (B, chunk),
    and δ = ``psum``(O_localᵀ x_local) + μ δ_prev, x_local this rank's
    rows of x; every rank solves the same (B, B) system."""
    if pmean_axis is not None:
        mesh.check_axis(pmean_axis)
    _, params = ravel_layout(model)
    sizes = [p.numel() for p in params]
    device = params[0].device
    flatten, scores = make_score_fn(model)

    def step(batch: torch.Tensor, baseline) -> torch.Tensor:
        state = step.optimizer.state
        flat0 = flatten()
        e_c, e_mean = _local_energies(model, h_fn, batch, clip_scale,
                                      pmean_axis)
        O = scores(flat0, batch).detach()                   # (B, P)
        with torch.no_grad():
            if score_row_clip is not None:
                rn_local = torch.linalg.vector_norm(O, dim=1)
                rn = global_energies(rn_local, pmean_axis)
                cap = score_row_clip * _median(rn)
                if score_row_clip_warmup is not None:
                    cap = torch.where(state['step'] < score_row_clip_warmup,
                                      cap, float('inf'))
                O = O * torch.clamp(cap / (rn_local + 1e-30),
                                    max=1.0)[:, None]
            prev = momentum * state['delta']
            if pmean_axis is None:
                O = O - O.mean(0, keepdim=True)
                eps = 2.0 * e_c
                zeta_of = O @ prev
            else:
                O = O - mesh.pmean(O.mean(0, keepdim=True), pmean_axis)
                eps = mesh.all_gather(2.0 * e_c, pmean_axis)
                zeta_of = mesh.all_gather(O @ prev, pmean_axis)
            gram0 = gram_matrix(O, pmean_axis)              # (B, B), full f32
            B = eps.shape[0]
            eps = eps - eps.mean()
            zeta = eps - zeta_of
            eye = torch.eye(B, dtype=O.dtype, device=O.device)
            # one factorisation and solve per damping: a single matrix runs
            # on cuSOLVER, which a CUDA graph captures; torch's batched
            # solve runs on MAGMA, which allocates under the capture
            xs = []
            for mult in (1.0, 10.0, 100.0):
                L, info = torch.linalg.cholesky_ex(
                    gram0 + (mult * B * damping) * eye)
                x_m = torch.cholesky_solve(zeta[:, None], L)[:, 0]
                xs.append(torch.where(info == 0, x_m, float('nan')))
            xs = torch.stack(xs)                            # (3, B)
            ok = torch.isfinite(xs).all(-1)
            fell_back = ~ok[0]
            x = torch.where(ok[0], xs[0], torch.where(ok[1], xs[1], xs[2]))
            if pmean_axis is None:
                delta = O.T @ x + prev
            else:
                B_l = O.shape[0]
                r = mesh.axis_index(pmean_axis)
                delta = mesh.psum(O.T @ x[r * B_l:(r + 1) * B_l],
                                  pmean_axis) + prev
            finite = torch.isfinite(delta).all()
            delta = torch.where(finite, delta, 0.0)
            (delta,) = _norm_cap([delta], learning_rate, max_update_norm)
            new_flat = flat0 - learning_rate * delta
            for p, t in zip(params, new_flat.split(sizes)):
                p.copy_(t.view(p.shape))
            state['delta'].copy_(delta)
            state['step'].add_(1)
            state['skipped'].add_((~finite).to(torch.int32))
            state['fallbacks'].add_(fell_back.to(torch.int32))
        return e_mean

    def init_state():
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return {'delta': torch.zeros(sum(sizes), device=device),
                'step': zero, 'skipped': zero.clone(),
                'fallbacks': zero.clone()}

    step.init_state = init_state
    step.n_params = sum(sizes)
    step.optimizer = StepState(init_state())
    return step


def make_sr_train_window(model, h_fn, sample_fn, learning_rate: float,
                         batch_size: int, window: int,
                         damping: float = 1e-3, cg_iters: int = 20,
                         pmean_axis=None,
                         max_update_norm: float | None = None):
    """``run_window(baseline) -> (losses (window,), next baseline)``:
    ``window`` epochs of exact draws ``sample_fn(batch_size)`` and one SR
    update each (the baseline passed through, unused), left on the device.
    The update is ``run_window.step``."""
    step = make_sr_train_step(model, h_fn, learning_rate, damping=damping,
                              cg_iters=cg_iters, pmean_axis=pmean_axis,
                              max_update_norm=max_update_norm)

    def run(baseline):
        return run_window(step, sample_fn, batch_size, window, baseline)

    run.step = step
    return run
