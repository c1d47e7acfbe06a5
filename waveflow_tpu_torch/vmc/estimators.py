"""VMC loss, train step and window loop: the 'clipped_score' estimator.

Port of waveflow_tpu/vmc/estimators.py (``_safe_psi``, the
``clipped_score`` loss, the train step, the window loop).  The gradient is
the score-only estimator 2 E[(E_L − E) ∂ log|ψ|] with E_L clipped to a
batch-adaptive window around the batch median; E_L carries no gradient,
so the Laplacian runs outside autograd.

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

PSI_EPS = 1e-8


def _safe_psi(psi_val: torch.Tensor) -> torch.Tensor:
    """Sign-aware denominator guard: |ψ| clamped away from zero, sign kept."""
    sign = torch.where(psi_val >= 0, 1.0, -1.0).to(psi_val.dtype)
    return sign * torch.clamp(psi_val.abs(), min=PSI_EPS)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle order statistics of an even
    count (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def clip_local_energies(e_loc: torch.Tensor,
                        clip_scale: float = 5.0) -> torch.Tensor:
    """E_L clipped to median ± clip_scale × mean|E_L − median| (the JAX
    default ``clip_stat='mean_abs'``; 'median_abs' is not ported)."""
    center = _median(e_loc)
    mad = (e_loc - center).abs().mean()
    return torch.clamp(e_loc, center - clip_scale * mad,
                       center + clip_scale * mad)


def make_loss_fn(psi, h_fn, estimator: str = 'clipped_score',
                 clip_scale: float = 5.0):
    """loss(batch) -> scalar whose value is the clipped batch-mean energy and
    whose gradient is the clipped score-function estimator.

    The clip window is ``clip_local_energies``'s."""
    if estimator != 'clipped_score':
        raise NotImplementedError(
            f"estimator {estimator!r} is not ported; only 'clipped_score'")

    def loss_fn(batch: torch.Tensor) -> torch.Tensor:
        psi_val = psi(batch)
        with torch.no_grad():
            energies = h_fn(batch)[:, 0]
            e_c = clip_local_energies(energies / _safe_psi(psi_val),
                                      clip_scale)
            e_c_mean = e_c.mean()
            weights = e_c - e_c_mean
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


def make_train_step(psi, h_fn, params, learning_rate: float,
                    grad_clip: float | None = 10.0,
                    estimator: str = 'clipped_score'):
    """step(batch) -> loss: one estimator gradient, the optax-form global
    norm clip, and one Adam update (eps 1e-8 outside the square root, the
    optax placement) on ``params``.  ``step.optimizer`` holds the Adam
    state."""
    params = list(params)
    loss_fn = make_loss_fn(psi, h_fn, estimator=estimator)
    optimizer = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)

    def step(batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        if grad_clip is not None:
            clip_by_global_norm(params, grad_clip)
        optimizer.step()
        return loss.detach()

    step.optimizer = optimizer
    return step


def run_window(step, sample_fn, batch_size: int, window: int) -> torch.Tensor:
    """``window`` sample + update epochs; returns the (window,) losses,
    left on the device (no host sync inside the window)."""
    return torch.stack([step(sample_fn(batch_size)) for _ in range(window)])
