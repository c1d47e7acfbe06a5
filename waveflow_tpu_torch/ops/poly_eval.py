"""Gather-free exact spline evaluation via local piecewise polynomials.

Port of waveflow_tpu/ops/poly_eval.py.  The knot vectors are uniform, so
between consecutive breakpoints every basis function is one polynomial of
degree < ncoef; those local polynomials are extracted exactly at init
(float64 Vandermonde solve at Chebyshev nodes, verified against the exact
recursions).  At run time the hot path is the *basis jet*

    basis_jet(x) = W(x) @ A_jet,   W = onehot(cell(x)) ⊗ (1, s, ..., s^{ncoef-1})

which yields the exact basis at derivative orders 0..3 in one contraction.
Its core is either the plain PyTorch matmul (``jet_backend='xla'``) or
kernel K3 (``jet_backend='pallas'``, ops/cuda_jet.py — the CUDA kernel on
a CUDA tensor); the backend names follow the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.forward_ad import _set_fwd_grad_enabled

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops import cuda_jet
from waveflow_tpu_torch.ops.sampling import _locate_in_masses
from waveflow_tpu_torch.ops.spline_tables import (
    BSplineTables, SplineTables, b_basis_with_derivs, i_basis_with_derivs,
    m_basis_with_derivs, make_knots,
)

_EXACT_BASIS = {
    'M': m_basis_with_derivs,
    'I': i_basis_with_derivs,
    'B': b_basis_with_derivs,
}
# total end-knot multiplicity per family (spline_tables.build_*_tables)
_MULTIPLICITY = {'M': lambda k: k, 'I': lambda k: k + 1, 'B': lambda k: k + 1}


def _chebyshev_nodes(n: int) -> np.ndarray:
    """Chebyshev nodes of the first kind on (0, 1), strictly interior."""
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos((2 * k + 1) * np.pi / (2 * n))


def build_local_polynomials(kind: str, degree: int, n_internal_knots: int,
                            basis_values_fn=None) -> np.ndarray:
    """(n_bases, n_cells, ncoef) float64 local polynomial coefficients.

    Cell m covers [m/n_cells, (m+1)/n_cells]; coefficients are in the local
    coordinate s = x*n_cells - m in [0, 1]:  T_j(x) = sum_k A[j,m,k] s^k.
    ``basis_values_fn(x) -> (n_bases, P)`` overrides the exact-recursion
    sampler (used for the orthonormalized B basis).
    """
    if basis_values_fn is None:
        t = make_knots(n_internal_knots, _MULTIPLICITY[kind](degree))
        exact = _EXACT_BASIS[kind]

        def basis_values_fn(x):
            return exact(np.asarray(x), t, degree, n_derivatives=1)[0]

    n_cells = n_internal_knots - 1
    ncoef = degree + 2          # covers M deg k-1, B deg k, I deg k+1
    nodes = _chebyshev_nodes(ncoef)
    V = nodes[:, None] ** np.arange(ncoef)[None, :]       # (ncoef, ncoef)
    h = 1.0 / n_cells
    xs = (np.arange(n_cells)[:, None] + nodes[None, :]) * h
    vals = basis_values_fn(xs.reshape(-1))                # (n_bases, n_cells*ncoef)
    n_bases = vals.shape[0]
    vals = vals.reshape(n_bases, n_cells, ncoef)
    A = np.linalg.solve(V, vals.transpose(1, 2, 0))       # (n_cells, ncoef, n_bases)
    A = np.ascontiguousarray(A.transpose(2, 0, 1))        # (n_bases, n_cells, ncoef)

    # the fit must reproduce the exact recursion at off-node interior
    # points: each basis IS a single polynomial per cell
    rng = np.random.default_rng(0)
    s_chk = rng.uniform(0.05, 0.95, size=7)
    x_chk = (np.arange(n_cells)[:, None] + s_chk[None, :]) * h
    exact_chk = basis_values_fn(x_chk.reshape(-1)).reshape(n_bases, n_cells, -1)
    powers = s_chk[:, None] ** np.arange(ncoef)[None, :]
    poly_chk = np.einsum('jmk,sk->jms', A, powers)
    scale = max(1.0, np.abs(exact_chk).max())
    err = np.abs(poly_chk - exact_chk).max() / scale
    if err > 1e-8:
        raise AssertionError(
            f"local-polynomial extraction failed for {kind} degree {degree} "
            f"({n_internal_knots} knots): relative residual {err:.2e}")
    return A


def _shift(B: torch.Tensor) -> torch.Tensor:
    """Orders d+1 moved into slot d (top slot zero): the x-derivative of a
    jet, given the jet."""
    return torch.cat([B[..., 1:, :], torch.zeros_like(B[..., :1, :])], dim=-2)


class _BasisJet(torch.autograd.Function):
    """basis_jet(x) with the self-referential derivative rule of the JAX
    custom JVP (poly_eval.py:217-228): the x-tangent of the jet is the
    shifted jet ITSELF, taken from the saved output — nested forward-mode
    Laplacians and parameter cotangents reuse the one core call.  The top
    order's x-tangent is truncated, as in the JAX package.  Under
    ``torch.func.vmap`` (the per-walker score matrix of SPRING) the batch
    folds into x's shape: one core call per jet, not one per walker."""

    @staticmethod
    def forward(x, ev):
        B = ev._core(x)                                   # (..., NJ, n_b)
        pos = x * ev.n_cells
        idx = torch.clamp(torch.floor(pos), 0, ev.n_cells - 1)
        s_full = pos - idx
        ds = (s_full - torch.clamp(s_full, 0.0, 1.0)) / ev.n_cells
        # linear extension outside the domain (ds == 0 inside)
        return B + _shift(B) * ds[..., None, None]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)
        ctx.save_for_backward(output)

    @staticmethod
    def jvp(ctx, t_x, _):
        (out,) = ctx.saved_tensors
        # functorch runs a Function's jvp rule with forward grad off; turn it
        # back on so that an OUTER jvp level differentiates this tangent
        # (else the Laplacian's second derivative comes out as zero)
        with _set_fwd_grad_enabled(True):
            return _shift(out) * t_x[..., None, None]

    @staticmethod
    def backward(ctx, grad_out):
        (out,) = ctx.saved_tensors
        return (grad_out * _shift(out)).sum((-2, -1)), None

    @staticmethod
    def vmap(info, in_dims, x, ev):
        # the jet is elementwise in x: the vmapped dimension is one more
        # leading dimension of x, so the whole batch is one core call (one
        # K3 launch) and the output keeps it where x has it
        return _BasisJet.apply(x, ev), in_dims[0]


class PolySplineEvaluator:
    """Gather-free batched evaluator: ``basis_jet`` (the hot path),
    ``value_and_derivative`` and ``__call__``."""

    N_JET = 4   # basis_jet orders 0..3 (all the Laplacian chain consumes)

    def __init__(self, A: np.ndarray, jet_backend: str = 'xla', device=None):
        if jet_backend not in ('xla', 'pallas'):
            raise ValueError(f"unknown jet_backend {jet_backend!r}")
        device = resolve_device(device)
        self.jet_backend = jet_backend
        self.n_bases, self.n_cells, self.ncoef = A.shape
        self.A = torch.as_tensor(A.reshape(self.n_bases, -1),
                                 dtype=torch.float32, device=device)
        # s^k term of T_j^{(d)} on cell m is A[j, m, k+d] * (k+d)!/k! * n^d;
        # assembled in float64, then cast to f32
        nd = min(self.N_JET, self.ncoef)
        A_jet = np.zeros((self.n_cells, self.ncoef, self.N_JET, self.n_bases))
        for d in range(nd):
            scale = float(self.n_cells) ** d
            for k in range(self.ncoef - d):
                fall = 1.0
                for j in range(d):
                    fall *= (k + d - j)
                A_jet[:, k, d, :] = (A[:, :, k + d] * (fall * scale)).T
        self.A_jet = torch.as_tensor(
            A_jet.reshape(self.n_cells * self.ncoef, -1), dtype=torch.float32,
            device=device)

    def _core(self, x: torch.Tensor) -> torch.Tensor:
        """Clamped in-domain jet (..., N_JET, n_bases)."""
        core = cuda_jet.basis_jet if self.jet_backend == 'pallas' \
            else cuda_jet.basis_jet_plain
        B = core(x, self.A_jet, self.n_cells, self.ncoef)
        return B.reshape(x.shape + (self.N_JET, self.n_bases))

    def basis_jet(self, x: torch.Tensor) -> torch.Tensor:
        """Exact basis at orders 0..3: x (...,) -> (..., 4, n_bases)."""
        return _BasisJet.apply(x, self)

    def _local(self, coeffs: torch.Tensor, x: torch.Tensor):
        """Per-sample local poly coeffs (..., ncoef), clamped coordinate
        s_c in [0,1], and overhang ds = s - s_c (nonzero only outside the
        domain, where the evaluation extends linearly)."""
        P = coeffs @ self.A
        P = P.reshape(P.shape[:-1] + (self.n_cells, self.ncoef))
        pos = x * self.n_cells
        idx = torch.clamp(torch.floor(pos), 0, self.n_cells - 1).detach()
        s = pos - idx
        s_c = torch.clamp(s, 0.0, 1.0)
        # a NaN x reads cell 0 and stays NaN through s, as in JAX (its
        # cast would be INT64_MIN: an error here, a device assert on a card)
        cell = torch.nan_to_num(idx, nan=0.0).long()
        local = torch.gather(
            P, -2, cell[..., None, None].expand(
                idx.shape + (1, self.ncoef)))[..., 0, :]
        return local, s_c, s - s_c

    def _horner(self, local: torch.Tensor, s: torch.Tensor, d: int):
        """d-th s-derivative of the local polynomial at s (s units)."""
        if d >= self.ncoef:
            return torch.zeros_like(s)
        fall = np.ones(self.ncoef - d)
        for i in range(self.ncoef - d):
            f = 1.0
            for j in range(d):
                f *= (i + d - j)
            fall[i] = f
        v = local[..., -1] * fall[-1]
        for k in range(self.ncoef - d - 2, -1, -1):
            v = v * s + local[..., k + d] * fall[k]
        return v

    def __call__(self, coeffs: torch.Tensor, x: torch.Tensor,
                 d: int = 0) -> torch.Tensor:
        """sum_j coeffs[..., j] T_j^{(d)}(x): coeffs (..., n_bases), x (...,)."""
        if d >= self.ncoef:
            return torch.zeros_like(x)
        local, s_c, ds = self._local(coeffs, x)
        v = self._horner(local, s_c, d) + self._horner(local, s_c, d + 1) * ds
        return v * float(self.n_cells) ** d

    def value_and_derivative(self, coeffs: torch.Tensor, x: torch.Tensor):
        """(f, df/dx) from one matmul + a triple-Horner chain."""
        local, s_c, ds = self._local(coeffs, x)
        v = local[..., -1]
        dv = torch.zeros_like(v)
        d2v = torch.zeros_like(v)
        for k in range(self.ncoef - 2, -1, -1):
            d2v = d2v * s_c + 2.0 * dv
            dv = dv * s_c + v
            v = v * s_c + local[..., k]
        return v + dv * ds, (dv + d2v * ds) * self.n_cells

    def pair(self, coeffs: torch.Tensor, x: torch.Tensor, d: int = 0):
        """The contract of ``SplineEvaluator.pair``: (order d, order d + 1);
        at d = 0 the fused ``value_and_derivative``."""
        if d == 0:
            return self.value_and_derivative(coeffs, x)
        return self(coeffs, x, d), self(coeffs, x, d + 1)


def sample_squared_amplitude_poly(ev: PolySplineEvaluator,
                                  coeffs: torch.Tensor, u: torch.Tensor,
                                  n_bisect: int = 12,
                                  n_newton: int = 3) -> torch.Tensor:
    """Exact inverse-CDF draw from p(x) ∝ (w·T(x))² under the POLYNOMIAL
    density — the one the poly backends' ψ / log_pdf / E_L evaluate (JAX
    ``poly_eval.py:307-386``); the table sampler draws from the
    piecewise-linear table interpolant instead, ~3.3e-3 away.

      1. local polynomials per cell l = c @ A: (B, n_cells, ncoef);
      2. exact cell masses h · lᵀ H l, H[k1, k2] = 1/(k1 + k2 + 1);
      3. the cell by the prefix-sum locate of ops/sampling.py, then the
         in-cell solve of the exact antiderivative F(s) = h Σ_m (l*l)_m
         s^{m+1}/(m+1): ``n_bisect`` bracketing steps, then ``n_newton``
         Newton steps clipped to the bracket.

    coeffs (..., n_bases), u (...,) uniforms in [0, 1) -> (...,) in [0, 1].
    Plain PyTorch at full f32 precision (the JAX package computes it
    outside any Pallas kernel)."""
    K, M = ev.ncoef, ev.n_cells
    h = 1.0 / M
    P = (coeffs @ ev.A.to(coeffs.dtype)).reshape(coeffs.shape[:-1] + (M, K))
    k = torch.arange(K, dtype=torch.float64, device=P.device)
    H = (1.0 / (k[:, None] + k[None, :] + 1.0)).to(P.dtype)
    masses = torch.clamp(h * torch.einsum('...mk,kl,...ml->...m', P, H, P),
                         min=0.0)
    j, q = _locate_in_masses(masses, u)
    l = torch.gather(P, -2, j[..., None, None].expand(
        j.shape + (1, K)))[..., 0, :]                      # (..., K)
    # squared-polynomial coefficients (l*l)_m = Σ_{k1+k2=m} l_k1 l_k2
    sq = [torch.zeros_like(l[..., 0])] * (2 * K - 1)
    for k1 in range(K):
        for k2 in range(K):
            sq[k1 + k2] = sq[k1 + k2] + l[..., k1] * l[..., k2]

    def F(s):
        """h ∫₀^s p(t)² dt — Horner on the antiderivative."""
        v = sq[2 * K - 2] / (2 * K - 1)
        for m in range(2 * K - 3, -1, -1):
            v = v * s + sq[m] / (m + 1)
        return h * v * s

    def dF(s):
        v = sq[2 * K - 2]
        for m in range(2 * K - 3, -1, -1):
            v = v * s + sq[m]
        return h * v

    lo = torch.zeros_like(q)
    hi = torch.ones_like(q)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        gt = F(mid) > q
        lo = torch.where(gt, lo, mid)
        hi = torch.where(gt, mid, hi)
    s = 0.5 * (lo + hi)
    for _ in range(n_newton):
        s = torch.minimum(torch.maximum(
            s - (F(s) - q) / torch.clamp(dF(s), min=1e-14), lo), hi)
    return (j + s) * h


_POLY_CACHE: dict = {}


def make_poly_evaluator(tables: SplineTables, use_ob: bool = False,
                        jet_backend: str = 'xla',
                        device=None) -> PolySplineEvaluator:
    """Polynomial evaluator consistent with a SplineTables set.

    ``use_ob`` builds the orthonormalized B basis OB = b_to_ob @ B with the
    table set's own basis-change matrix, so coefficients evaluate
    identically (to f32) against either the tables or the polynomials.
    """
    device = resolve_device(device)
    key = (tables.kind, tables.degree, tables.n_internal_knots,
           tables.n_mesh if use_ob else None, use_ob, jet_backend, str(device))
    if key in _POLY_CACHE:
        return _POLY_CACHE[key]
    if use_ob:
        if not isinstance(tables, BSplineTables):
            raise ValueError("use_ob requires B-spline tables")
        t = make_knots(tables.n_internal_knots, tables.degree + 1)
        b_to_ob = np.asarray(tables.b_to_ob, dtype=np.float64)

        def ob_values(x):
            b = b_basis_with_derivs(np.asarray(x), t, tables.degree,
                                    n_derivatives=1)[0]
            return b_to_ob @ b

        A = build_local_polynomials('B', tables.degree,
                                    tables.n_internal_knots,
                                    basis_values_fn=ob_values)
    else:
        A = build_local_polynomials(tables.kind, tables.degree,
                                    tables.n_internal_knots)
    if A.shape[0] != tables.n_bases:
        raise AssertionError(
            f"polynomial basis count {A.shape[0]} != table basis count "
            f"{tables.n_bases} for {tables.kind}")
    ev = PolySplineEvaluator(A, jet_backend=jet_backend, device=device)
    _POLY_CACHE[key] = ev
    return ev
