"""Soft-Coulomb Hamiltonian and the Laplacian forms.

Port of waveflow_tpu/physics/hamiltonian.py: ``get_potential``, every
Laplacian of the JAX package and ``construct_hamiltonian_function``.
Hψ = -½∇²ψ + Vψ with V = -Σ 1/√(1+|r_pe|²) + Σ 1/√(1+|r_ee|²).

The forms (``fn(x: (B, n)) -> (B,)`` with its parameters inside):
  * ``laplacian_and_value_batched`` ('fwd_batched'): nested
    ``torch.func.jvp`` on the whole batch, one coordinate at a time;
  * ``laplacian_and_value`` / ``laplacian`` ('fwd'): the same nested jvps
    per walker, under ``torch.func.vmap`` over walkers and directions;
  * ``laplacian_hvp`` ('hvp'): per walker, ``jvp`` of ``grad``;
  * ``laplacian_dense_hessian`` ('dense', the reference's form): per
    walker, the trace of ``torch.func.hessian``;
  * ``laplacian_numerical`` (``eps > 0``): central finite differences.
Kernels inside ψ (the basis jet) run once per jet call for the whole batch
in every form: at batch level directly, under ``vmap`` through their vmap
rules; their derivative rules supply every tangent without another launch.
"""

from __future__ import annotations

import numpy as np
import torch


def laplacian_and_value_batched(fn):
    """(lap, value) of a scalar field fn(x: (B, n)) -> (B,).

    Forward-over-forward on the whole batch: ∂²f/∂x_i² =
    jvp(jvp(f, e_i), e_i), one nested ``torch.func.jvp`` per coordinate.
    Kernels inside ψ (the basis jet) see the full (B, n) batch; their
    derivative rules supply every tangent without another launch."""

    def lap(x: torch.Tensor):
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        val = None
        for i in range(x.shape[-1]):
            e = torch.zeros_like(x)
            e[..., i] = 1.0

            def df(xx, e=e):
                return torch.func.jvp(fn, (xx,), (e,))

            (val, _), (_, dd) = torch.func.jvp(df, (x,), (e,))
            total = total + dd
        return total, val

    return lap


def _per_walker(fn):
    """fn on one walker: x (n,) -> scalar."""
    return lambda xx: fn(xx[None])[0]


def laplacian_and_value(fn):
    """(lap, value) per walker: for each walker, jvp(jvp(f, e_i), e_i)
    vmapped over the n directions, and that vmapped over the walkers (JAX
    ``laplacian_and_value``).  The value is the inner jvp's primal."""
    f = _per_walker(fn)

    def single(x):
        def d2(e):
            df = lambda xx: torch.func.jvp(f, (xx,), (e,))
            (val, _), (_, dd) = torch.func.jvp(df, (x,), (e,))
            return val, dd

        eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        vals, dds = torch.func.vmap(d2)(eye)
        return dds.sum(), vals[0]

    return torch.func.vmap(single)


def laplacian(fn):
    """Per-walker Laplacian x (B, n) -> (B,) ('fwd')."""
    lap_and_val = laplacian_and_value(fn)
    return lambda x: lap_and_val(x)[0]


def laplacian_hvp(fn):
    """Hessian diagonal by forward-over-reverse: per walker and direction
    e_i, ⟨e_i, jvp(grad f, e_i)⟩, vmapped over directions and walkers."""
    f = _per_walker(fn)

    def single(x):
        def hvp_diag(e):
            _, hv = torch.func.jvp(torch.func.grad(f), (x,), (e,))
            return torch.dot(e, hv)

        eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        return torch.func.vmap(hvp_diag)(eye).sum()

    return torch.func.vmap(single)


def laplacian_dense_hessian(fn):
    """The reference's full-Hessian trace (physics.py:50-52), per walker:
    x (B, n) -> (B,)."""
    f = _per_walker(fn)

    def single(x):
        return torch.trace(torch.func.hessian(f)(x))

    return torch.func.vmap(single)


def laplacian_numerical(fn, eps: float = 0.1, n_dims: int = 2):
    """Central finite-difference Laplacian (physics.py:36-46): Σ over the
    first ``n_dims`` coordinates of (f(x + ε e_i) + f(x − ε e_i) − 2f(x))
    / ε².  A coordinate index at or past x's width adds nothing (JAX's
    ``one_hot`` of it is zero), and coordinates from ``n_dims`` on are
    left out: the reference's default of 2, as
    ``construct_hamiltonian_function`` passes it."""

    def lap(x: torch.Tensor):
        n = x.shape[-1]
        diffs = 0.0
        for i in range(n_dims):
            e = (torch.arange(n, device=x.device) == i).to(x.dtype)
            diffs = diffs + (fn(x + e * eps) + fn(x - e * eps)
                             - 2 * fn(x))
        return diffs / eps ** 2

    return lap


def get_potential(protons, n_space_dimensions: int = 1,
                  interactions: bool = True):
    """V(x): (B, n_el * n_space_dimensions) -> (B,) soft-Coulomb potential."""
    protons = np.asarray(protons, dtype=np.float32)
    on_device: dict = {}

    def potential(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        xe = x.reshape(b, -1, n_space_dimensions)          # (B, n_el, D)
        v = torch.zeros((b,), dtype=x.dtype, device=x.device)
        if protons.size:
            if x.device not in on_device:
                on_device[x.device] = torch.as_tensor(
                    protons.reshape(1, 1, -1, n_space_dimensions),
                    device=x.device)
            pe_r2 = ((xe[:, :, None, :] - on_device[x.device]) ** 2).sum(-1)
            v = v - (1.0 / torch.sqrt(1.0 + pe_r2)).sum((-1, -2))
        n = xe.shape[1]
        if interactions and n > 1:
            diff = xe[:, :, None, :] - xe[:, None, :, :]    # (B, n, n, D)
            ee = 1.0 / torch.sqrt(1.0 + (diff ** 2).sum(-1))
            v = v + torch.tril(ee, diagonal=-1).sum((-1, -2))
        return v

    return potential


LAPLACIAN_MODES = ('fwd', 'fwd_batched', 'hvp', 'dense')


def construct_hamiltonian_function(fn, protons=((0.0, 0.0),),
                                   n_space_dimensions: int = 2,
                                   eps: float = 0.0,
                                   laplacian_mode: str = 'fwd',
                                   interactions: bool = True):
    """h(x) = -½∇²ψ + Vψ : (B, n) -> (B, 1) for ψ = fn(x).

    ``eps > 0`` takes the finite-difference Laplacian (whatever the mode);
    else ``laplacian_mode`` 'fwd' (per walker, the default as in JAX),
    'fwd_batched', 'hvp' or 'dense'.  The two 'fwd' forms reuse their
    inner primal for V·ψ; the others evaluate ψ once more for it.
    ``interactions=False`` drops the electron-electron repulsion."""
    if laplacian_mode not in LAPLACIAN_MODES:
        raise ValueError(f"unknown laplacian_mode {laplacian_mode!r}; "
                         f"one of {LAPLACIAN_MODES}")
    v_fn = get_potential(protons, n_space_dimensions=n_space_dimensions,
                         interactions=interactions)
    if eps > 0.0:
        lap_fn = laplacian_numerical(fn, eps=eps)
    elif laplacian_mode == 'dense':
        lap_fn = laplacian_dense_hessian(fn)
    elif laplacian_mode == 'hvp':
        lap_fn = laplacian_hvp(fn)
    else:
        lap_and_val = (laplacian_and_value_batched(fn)
                       if laplacian_mode == 'fwd_batched'
                       else laplacian_and_value(fn))

        def h_fused(x: torch.Tensor) -> torch.Tensor:
            lap, psi_val = lap_and_val(x)
            return (-0.5 * lap + v_fn(x) * psi_val)[:, None]

        return h_fused

    def h(x: torch.Tensor) -> torch.Tensor:
        lap = lap_fn(x).reshape(x.shape[0])
        return (-0.5 * lap + v_fn(x) * fn(x))[:, None]

    return h
