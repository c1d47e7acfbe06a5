"""VMC losses, train step and window loop.

Port of waveflow_tpu/vmc/estimators.py: ``_safe_psi``, ``local_energy``
(the reference's custom-derivative local energy), the 'clipped_score' and
'reference' losses, the train step, the window loop with its running
baseline, and the parity variants ``loss_fn_uniform`` and
``make_policy_gradient_step``.

On a CUDA device the window runs as a replayed CUDA graph of one epoch
(``TrainWindow``, vmc/graphs.py), the counterpart of JAX's jitted scan.

'clipped_score' (the default) is the score-only estimator
2 E[(E_L − E) ∂ log|ψ|] with E_L clipped to a batch-adaptive window around
the batch median; E_L carries no gradient, so the Laplacian runs outside
autograd.  'reference' differentiates E_L = Hψ/ψ itself — reverse mode
through the Laplacian — with the score term 2 ψ̇ (E_L − b)/ψ against the
running baseline b added by ``local_energy``'s derivative rules.

Walkers sharded over ranks (``pmean_axis``, parallel/mesh.py): the clip
window of 'clipped_score' comes from the local energies of every rank
(one all-gather), and the train step averages the loss and the gradients
over the ranks (one all-reduce) before the norm clip, as JAX averages in
``make_train_step`` ahead of its optax chain.

Two places where PyTorch's defaults differ from the JAX reference:
  * median — ``torch.median`` returns the LOWER middle value of an even
    batch, ``jnp.median`` the mean of the two middle values; ``_median``
    is the latter;
  * gradient clip — ``clip_grad_norm_`` scales by max/(norm + 1e-6)
    always; optax's ``clip_by_global_norm`` leaves g unchanged when
    norm < max and otherwise scales by max/norm; ``clip_by_global_norm``
    below is the optax form.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc import graphs

PSI_EPS = 1e-8


def _safe_psi(psi_val: torch.Tensor) -> torch.Tensor:
    """Sign-aware denominator guard: |ψ| clamped away from zero, sign kept."""
    sign = torch.where(psi_val >= 0, 1.0, -1.0).to(psi_val.dtype)
    return sign * torch.clamp(psi_val.abs(), min=PSI_EPS)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """A broadcast cotangent summed back to an input's shape."""
    return g if g.shape == shape else g.sum_to_size(shape)


class _LocalEnergy(torch.autograd.Function):
    """E_L = E / ψ_s with the reference's derivative (vqmc.py:208; JAX
    ``estimators.py:43-52``): Ė_L = 2 ψ̇ (E_L − b)/ψ_s + (Ė ψ_s − E ψ̇)/ψ_s²,
    ψ_s = ``_safe_psi(ψ)``.  The rule divides by ψ_s and does not
    differentiate the clamp inside it; the baseline b gets no derivative.
    ``jvp`` is that rule; ``backward`` its transpose."""

    generate_vmap_rule = True

    @staticmethod
    def forward(energies, psi_val, baseline):
        return energies / _safe_psi(psi_val)

    @staticmethod
    def setup_context(ctx, inputs, output):
        energies, psi_val, baseline = inputs
        ctx.save_for_backward(energies, psi_val, baseline, output)
        ctx.save_for_forward(energies, psi_val, baseline, output)
        ctx.shapes = (energies.shape, psi_val.shape)

    @staticmethod
    def jvp(ctx, t_energies, t_psi, _):
        energies, psi_val, baseline, e_loc = ctx.saved_tensors
        psi_s = _safe_psi(psi_val)
        t_energies = (torch.zeros_like(energies) if t_energies is None
                      else t_energies)
        t_psi = torch.zeros_like(psi_val) if t_psi is None else t_psi
        return (2 * t_psi * (e_loc - baseline) / psi_s
                + (t_energies * psi_s - energies * t_psi) / psi_s ** 2)

    @staticmethod
    def backward(ctx, g):
        energies, psi_val, baseline, e_loc = ctx.saved_tensors
        psi_s = _safe_psi(psi_val)
        g_energies = g / psi_s
        g_psi = g * (2 * (e_loc - baseline) / psi_s - energies / psi_s ** 2)
        e_shape, p_shape = ctx.shapes
        return _sum_to(g_energies, e_shape), _sum_to(g_psi, p_shape), None


def local_energy(energies: torch.Tensor, psi_val: torch.Tensor,
                 baseline) -> torch.Tensor:
    """E_L = E / ``_safe_psi(ψ)`` whose derivative carries the score term
    against ``baseline`` (``_LocalEnergy``)."""
    baseline = torch.as_tensor(baseline, dtype=energies.dtype,
                               device=energies.device)
    return _LocalEnergy.apply(energies, psi_val, baseline)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle order statistics of an even
    count (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def clip_window(e_stat: torch.Tensor, clip_scale: float = 5.0,
                clip_stat: str = 'mean_abs'):
    """(lo, hi) = median ± clip_scale × dev of the energies ``e_stat``, dev
    = mean|E_L − median| (``clip_stat='mean_abs'``, the JAX default) or
    median|E_L − median| ('median_abs', the conventional MAD; jnp's
    median)."""
    if clip_stat not in ('mean_abs', 'median_abs'):
        raise ValueError(f"unknown clip_stat {clip_stat!r}")
    center = _median(e_stat)
    dev = (e_stat - center).abs()
    mad = dev.mean() if clip_stat == 'mean_abs' else _median(dev)
    return center - clip_scale * mad, center + clip_scale * mad


def global_energies(e_loc: torch.Tensor, pmean_axis=None) -> torch.Tensor:
    """The local energies of every rank of ``pmean_axis`` (an all-gather),
    or ``e_loc`` itself without an axis: the population the clip window
    is taken over."""
    return e_loc if pmean_axis is None else mesh.all_gather(e_loc, pmean_axis)


def make_loss_fn(psi, h_fn, estimator: str = 'clipped_score',
                 clip_scale: float = 5.0, energy_clip: float | None = None,
                 clip_stat: str = 'mean_abs', pmean_axis=None):
    """loss(batch, baseline) -> scalar.

    'clipped_score': value = the clipped batch-mean energy, gradient = the
    clipped score-function estimator (``clip_window(..., clip_stat)`` of
    ``global_energies``: under ``pmean_axis`` the window, and the mean
    the weights are centred on, come from every rank's walkers, so that
    each rank's gradient is its share of the global estimator); the
    baseline is unused.
    'reference': the mean of ``local_energy`` (optionally clamped to
    ±``energy_clip`` in value and gradient), whose gradient differentiates
    Hψ/ψ and adds the score term against ``baseline``."""
    if estimator == 'reference':
        def loss_fn(batch: torch.Tensor, baseline) -> torch.Tensor:
            psi_val = psi(batch)[:, None]
            e_loc = local_energy(h_fn(batch), psi_val, baseline)
            if energy_clip is not None:
                e_loc = torch.clamp(e_loc, -energy_clip, energy_clip)
            return e_loc.mean()
        return loss_fn

    if estimator != 'clipped_score':
        raise ValueError(f"unknown estimator {estimator!r}")
    if clip_stat not in ('mean_abs', 'median_abs'):
        raise ValueError(f"unknown clip_stat {clip_stat!r}")

    def loss_fn(batch: torch.Tensor, baseline) -> torch.Tensor:
        psi_val = psi(batch)
        with torch.no_grad():
            energies = h_fn(batch)[:, 0]
            e_loc = energies / _safe_psi(psi_val)
            e_stat = global_energies(e_loc, pmean_axis)
            lo, hi = clip_window(e_stat, clip_scale, clip_stat)
            e_c_mean = torch.clamp(e_stat, lo, hi).mean()
            weights = torch.clamp(e_loc, lo, hi) - e_c_mean
        log_abs_psi = torch.log(psi_val.abs() + PSI_EPS)
        surrogate = 2.0 * (weights * log_abs_psi).mean()
        # value = robust energy estimate; gradient = score-only estimator
        return surrogate - surrogate.detach() + e_c_mean

    return loss_fn


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the .grad of ``params``, in place:
    g -> g when ||g|| < max_norm, else g / ||g|| * max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


@torch.no_grad()
def pmean_grads(params, loss: torch.Tensor, pmean_axis) -> torch.Tensor:
    """The loss and the ``.grad`` of ``params``, averaged in place over the
    ranks of ``pmean_axis`` as one flat all-reduce; returns the averaged
    loss.  Over one rank every value is unchanged, to the bit."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = mesh.pmean(torch.cat([loss.reshape(1)]
                                + [g.reshape(-1) for g in grads]), pmean_axis)
    offset = 1
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[0]


def make_train_step(psi, h_fn, params, learning_rate: float,
                    grad_clip: float | None = 10.0,
                    estimator: str = 'clipped_score',
                    energy_clip: float | None = None,
                    clip_stat: str = 'mean_abs', pmean_axis=None):
    """step(batch, baseline) -> loss: one estimator gradient, the
    optax-form global norm clip, and one Adam update (eps 1e-8 outside the
    square root, the optax placement) on ``params``.  ``step.optimizer``
    holds the Adam state.  Under ``pmean_axis`` the local loss and
    gradients are averaged over the ranks (``pmean_grads``) before the
    clip, so every rank applies the same update to its copy of the
    parameters.

    On a CUDA device Adam is ``capturable`` (its step count lives on the
    device, so an update can be captured in a CUDA graph), whether or not
    the window runs as a graph, so that the two compare like with like;
    on the CPU it is not (torch refuses a capturable Adam there).

    The step runs its backward passes — those nested in the Laplacian's
    forward ('hvp', 'dense') and the loss's — on the calling thread
    (``torch.autograd.set_multithreading_enabled(False)``).  On the card
    the autograd engine otherwise runs them on a worker thread, where the
    double-backward nodes get that thread's sequence numbers; the loss's
    backward orders its nodes by sequence number, so the order of its
    gradient sums followed the process's history, and the first 'reference'
    + 'dense' run of a process parted from later ones in the last bits."""
    params = list(params)
    if pmean_axis is not None:
        mesh.check_axis(pmean_axis)
    loss_fn = make_loss_fn(psi, h_fn, estimator=estimator,
                           energy_clip=energy_clip, clip_stat=clip_stat,
                           pmean_axis=pmean_axis)
    optimizer = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, capturable=params[0].is_cuda)

    def step(batch: torch.Tensor, baseline) -> torch.Tensor:
        with torch.autograd.set_multithreading_enabled(False):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(batch, baseline)
            loss.backward()
            if pmean_axis is not None:
                loss = pmean_grads(params, loss, pmean_axis)
            if grad_clip is not None:
                clip_by_global_norm(params, grad_clip)
            optimizer.step()
        return loss.detach()

    step.optimizer = optimizer
    return step


def run_window(step, sample_fn, batch_size: int, window: int, baseline):
    """``window`` sample + update epochs against ``baseline``; returns the
    (window,) losses and the next baseline, their mean, both left on the
    device (no host sync inside the window; JAX ``make_window_from_step``).
    ``TrainWindow`` is the same window as a replayed CUDA graph."""
    losses = torch.stack([step(sample_fn(batch_size), baseline)
                          for _ in range(window)])
    return losses, losses.mean()


class TrainWindow:
    """``run_window`` on a CUDA device as an object that keeps its CUDA
    graph across windows: ``window(n, baseline) -> (losses,
    losses.mean())``; ``generators`` are the CUDA generators ``sample_fn``
    draws from.

    The graphed epoch is ``loss ← step(sample_fn(batch_size), baseline)``
    over static tensors: the baseline is copied into a 0-d buffer before
    each window, and each epoch's loss leaves through its slot.  The first
    window's first epoch runs eagerly and the capture follows it
    (vmc/graphs.py); ``reset()`` drops the capture, as a swap of the
    optimizer's state tensors requires."""

    def __init__(self, step, sample_fn, batch_size: int, device,
                 generators=()):
        graphs.use_graph(True, device)
        self.baseline = torch.zeros((), device=device)
        loss = torch.zeros((), device=device)

        def epoch():
            loss.copy_(step(sample_fn(batch_size), self.baseline))
        self.epochs = graphs.EpochGraph(epoch, (loss,), generators)

    def reset(self) -> None:
        self.epochs.reset()

    def __call__(self, window: int, baseline):
        self.baseline.copy_(baseline)
        losses, = self.epochs.window(window)
        return losses, losses.mean()


# --- parity variants -------------------------------------------------------

def loss_fn_uniform(psi, h_fn, batch: torch.Tensor) -> torch.Tensor:
    """Uniform-sampling Rayleigh quotient E[ψ Hψ] / E[ψ²] with the
    denominator held constant (vqmc.py:143-148)."""
    psi_val = psi(batch)[:, None]
    return (psi_val * h_fn(batch)).mean() / (psi_val ** 2).mean().detach()


class _LogPdf(torch.nn.Module):
    """``model.log_pdf`` as a module's forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model.log_pdf(x)


def make_policy_gradient_step(model, h_fn, optimizer,
                              clip_energy: float = 100.0,
                              clip_grad: float = 10.0):
    """step(batch, baseline) -> loss: the explicit energy-gradient +
    REINFORCE estimator (vqmc.py:172-189), one ``optimizer.step()`` on
    ``model``'s parameters (the JAX ``psi`` / ``log_pdf`` are
    ``model.psi`` / ``model.log_pdf``; ``optimizer`` is a torch optimizer
    over ``model.parameters()``).

    grad = ∂ mean(Hψ/ψ) + mean_i[∂ log p(x_i) (E_L,i − b)] leaf by leaf,
    each leaf's per-walker Jacobian weighted as JAX's ``pdf_term``
    (E_L of shape (B, 1) for a leaf of < 2 dimensions, (B, 1, 1)
    otherwise, then broadcast), clipped elementwise to ±clip_grad; the
    loss is mean(clip(E_L, ±clip_energy)).  No ``_safe_psi`` guard, as in
    the reference."""
    named = dict(model.named_parameters())
    names = list(named)
    log_pdf_module = _LogPdf(model)

    def log_pdf_of(p, batch):
        return functional_call(log_pdf_module,
                               {f'model.{n}': t for n, t in p.items()},
                               (batch,))

    def step(batch: torch.Tensor, baseline) -> torch.Tensor:
        psi_val = model.psi(batch)[:, None]
        energies = h_fn(batch)
        energy_loss = (energies / psi_val).mean()
        energy_grad = torch.autograd.grad(
            energy_loss, [named[n] for n in names], allow_unused=True)
        e_loc = (energies / psi_val).detach()
        p0 = {n: named[n].detach() for n in names}
        jac = torch.func.jacrev(lambda p: log_pdf_of(p, batch))(p0)
        with torch.no_grad():
            for n, g_e in zip(names, energy_grad):
                g = jac[n]
                w = e_loc if g.ndim < 3 else e_loc[:, None]
                pdf = (g * (w - baseline)).mean(0)
                g_e = torch.zeros_like(pdf) if g_e is None else g_e
                named[n].grad = torch.clamp(g_e + pdf, -clip_grad, clip_grad)
        optimizer.step()
        return torch.clamp(e_loc, -clip_energy, clip_energy).mean()

    step.optimizer = optimizer
    return step
