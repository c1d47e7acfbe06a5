"""Soft-Coulomb Hamiltonian and the batch-level forward-mode Laplacian.

Port of waveflow_tpu/physics/hamiltonian.py (``get_potential``,
``laplacian_and_value_batched`` and ``construct_hamiltonian_function``
with ``laplacian_mode='fwd_batched'``).  Hψ = -½∇²ψ + Vψ with
V = -Σ 1/√(1+|r_pe|²) + Σ 1/√(1+|r_ee|²).
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


def construct_hamiltonian_function(fn, protons=((0.0, 0.0),),
                                   n_space_dimensions: int = 2,
                                   laplacian_mode: str = 'fwd_batched',
                                   interactions: bool = True):
    """h(x) = -½∇²ψ + Vψ : (B, n) -> (B, 1) for ψ = fn(x).

    Only ``laplacian_mode='fwd_batched'`` is ported (the JAX package's
    default, and the only form its basis-jet kernel runs under)."""
    if laplacian_mode != 'fwd_batched':
        raise NotImplementedError(
            f"laplacian_mode {laplacian_mode!r} is not ported; only "
            "'fwd_batched'")
    v_fn = get_potential(protons, n_space_dimensions=n_space_dimensions,
                         interactions=interactions)
    lap_and_val = laplacian_and_value_batched(fn)

    def h(x: torch.Tensor) -> torch.Tensor:
        lap, psi_val = lap_and_val(x)
        return (-0.5 * lap + v_fn(x) * psi_val)[:, None]

    return h
