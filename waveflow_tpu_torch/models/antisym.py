"""The explicitly antisymmetrized square-flow ansatz.

Port of waveflow_tpu/models/antisym.py:

    ψ_A(r_1, …, r_n) = (1/√n!) Σ_P sign(P) φ(r_{P(1)}, …, r_{P(n)})

with φ a Waveflow over the 'independent' per-coordinate box map, whose
nodal surface is not forced onto a sorted sector.  ψ_A is exactly
antisymmetric under electron exchange.  The n! permuted copies of a batch
go through φ in one call on the (n!·B, D) batch, so every kernel inside φ
(the basis jet) runs on n! times the rows and not n! times as often.
|ψ_A|² is unnormalized: the Metropolis and MALA walkers need log|ψ_A|²
only up to a constant, and ``sample`` is a warm start, not an exact draw.

The parameters are φ's (JAX returns them unchanged): the module adopts
φ's ``transform`` and ``conditioner`` under the same names, so its state
dict is φ's and a JAX Waveflow's parameters load through
``convert.params_from_jax`` as they do into φ.  The permutation table and
its signs are buffers on the model's device: the gather reads no host
memory, and a CUDA graph can capture it.
"""

from __future__ import annotations

import math
from itertools import permutations

import numpy as np
import torch
from torch import nn

from waveflow_tpu_torch.models.factory import get_waveflow_model
from waveflow_tpu_torch.models.waveflow import Waveflow

# guard for log|ψ_A|²: additive in ψ² (~(1e-13)² in ψ), far below any
# walker the samplers visit, but keeps log_pdf finite on the node
LOG_PDF_EPS = 1e-26


def electron_permutation_table(n_el: int):
    """(perms (n!, n_el) int64, signs (n!,) float32), in
    ``itertools.permutations`` order; a sign is the parity of the
    permutation's inversion count."""
    perms, signs = [], []
    for p in permutations(range(n_el)):
        perms.append(p)
        inv = sum(1 for i in range(n_el) for j in range(i + 1, n_el)
                  if p[i] > p[j])
        signs.append(-1.0 if inv % 2 else 1.0)
    return (np.asarray(perms, dtype=np.int64),
            np.asarray(signs, dtype=np.float32))


class AntisymWaveflow(nn.Module):
    """ψ_A over the Waveflow ``phi`` of ``n_el`` electrons in
    ``n_space_dimension`` dimensions: ``psi``, ``log_pdf`` and ``sample``
    with the Waveflow's signatures."""

    def __init__(self, phi: Waveflow, n_el: int, n_space_dimension: int):
        super().__init__()
        if phi.input_dim != n_el * n_space_dimension:
            raise ValueError(
                f"phi takes {phi.input_dim} coordinates, not {n_el} x "
                f"{n_space_dimension}")
        # φ's modules, registered here under φ's own names: one set of
        # parameters, one state dict; φ itself is kept off the module tree
        self.transform = phi.transform
        self.conditioner = phi.conditioner
        self.__dict__['phi'] = phi
        self.n_el, self.n_space_dimension = n_el, n_space_dimension
        self.input_dim = phi.input_dim
        self.device = phi.device
        perms, signs = electron_permutation_table(n_el)
        self.n_perm = len(signs)
        self.register_buffer('perms', torch.as_tensor(perms, device=phi.device),
                             persistent=False)
        self.register_buffer('signs', torch.as_tensor(signs, device=phi.device),
                             persistent=False)
        self.norm = 1.0 / math.sqrt(float(self.n_perm))

    def psi(self, x: torch.Tensor) -> torch.Tensor:
        """ψ_A(x): (B, D) box coordinates -> (B,)."""
        if x.ndim == 1:
            x = x[None]
        b = x.shape[0]
        xe = x.reshape(b, self.n_el, self.n_space_dimension)
        # the permuted copies (B, n!, n_el, dim) in one call of φ
        xp = xe[:, self.perms, :].reshape(b * self.n_perm, self.input_dim)
        vals = self.phi.psi(xp).reshape(b, self.n_perm)
        return (vals * self.signs).sum(-1) * self.norm

    # torch.func.functional_call runs a module's forward (vmc/sr.py)
    forward = psi

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """log(ψ_A(x)² + LOG_PDF_EPS), unnormalized: (B, D) -> (B,)."""
        return torch.log(self.psi(x) ** 2 + LOG_PDF_EPS)

    @torch.no_grad()
    def sample(self, num_samples: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Warm-start walkers: exact draws from |φ|², then one uniformly
        drawn electron permutation per walker (an exchange-symmetric
        proposal, not exact draws from |ψ_A|²; the MCMC chains restore
        exactness).  Every draw comes from ``generator``."""
        x = self.phi.sample(num_samples, generator=generator)
        xe = x.reshape(num_samples, self.n_el, self.n_space_dimension)
        idx = torch.randint(0, self.n_perm, (num_samples,),
                            generator=generator, device=self.device)
        xe = torch.take_along_dim(xe, self.perms[idx][:, :, None], dim=1)
        return xe.reshape(num_samples, self.input_dim)


def get_antisym_waveflow_model(n_el: int, n_space_dimension: int,
                               box_size: float = 1.0, **waveflow_kwargs
                               ) -> AntisymWaveflow:
    """ψ_A over a Waveflow on the 'independent' box map of ``n_el`` ×
    ``n_space_dimension`` coordinates; ``waveflow_kwargs`` go to
    ``models.factory.get_waveflow_model`` (degrees, knots, layers,
    backends, ``generator``, ``device``)."""
    phi = get_waveflow_model(n_el * n_space_dimension, box_size=box_size,
                             xu_coord_type='independent', **waveflow_kwargs)
    return AntisymWaveflow(phi, n_el, n_space_dimension)
