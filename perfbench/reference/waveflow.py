"""Plain reference of the square-flow wavefunction ψ, in plain PyTorch.

It imports torch and numpy only: nothing of the measured package, no kernel,
no table built by the program.  Everything is worked out from the
configuration file (perfbench/configs/<name>.json) in float64:

    ψ(x) = Π_d a_d(u_<d, u_d) · exp(½ log|det ∂u/∂x|),   u = T(x) ∈ [0, 1]^D

  * T: the box map ('mean' for sorted 1D electrons: gaps scaled by the
    space left, then a mean channel; 'paired2d': the x's by 'mean', the y's
    affinely), then n_flow_layers × (IMADE, reverse).
  * IMADE: a masked MLP (MADE degrees) emits per-coordinate I-spline
    weights; + i_spline_reg, edge de-biasing, the boundary projection
    (first and last weight zero), sum-normalisation; the coordinate moves
    to Σ_j w_j I_j(u_d); its log-det is Σ_d log(Σ_j w_j I'_j(u_d) + 1e-7).
  * the prior: a masked MLP (negative outputs allowed), sum-normalised,
    projected (first and last weight zero); a_d = (w·B(u_d)) / √(w S wᵀ),
    S the Gram matrix of the B-spline basis by the trapezoid rule on the
    configuration's mesh (so that a_d is w·OB(u_d) for the Löwdin-
    orthonormal basis OB = S^{-1/2} B with coefficients w S^{1/2} scaled to
    unit norm); a gap coordinate's amplitude is divided by √2.

B-splines and their first derivatives are evaluated by de Boor's triangle
on the cell of x, whose polynomial continues past [0, 1]; I_j = Σ_{m ≥ j}
B_m (and a last basis that is zero).  The Laplacian of ψ comes from
autograd, reverse over reverse.

Sampling is the algorithm the configuration names ('table'): per
coordinate, the amplitude on the mesh, linearly interpolated, its square
integrated cell by cell, the inverse CDF solved exactly in the cell; then
the flow inverted exactly (bisection in float64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_TOL = 1e-7        # log(derivative + LOG_TOL), log(amplitude² + LOG_TOL)
BOX_TOL = 1e-7        # the box map's guard on the space left
PSI_EPS = 1e-8        # |ψ| clamped away from zero as E_L's denominator


def clamped_knots(n_internal: int, degree: int) -> np.ndarray:
    """Uniform internal knots on [0, 1], each end repeated degree + 1 times."""
    return np.concatenate([np.zeros(degree), np.linspace(0.0, 1.0, n_internal),
                           np.ones(degree)])


class BSplines:
    """The degree-k B-spline basis on clamped uniform knots: x (...,) ->
    (..., n) with n = n_internal + k - 1."""

    def __init__(self, n_internal: int, degree: int, device, dtype):
        self.k = degree
        self.n_cells = n_internal - 1
        self.t = torch.as_tensor(clamped_knots(n_internal, degree),
                                 dtype=dtype, device=device)
        self.n = len(self.t) - degree - 1
        self.index = torch.arange(self.n, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.with_derivative(x)[0]

    def with_derivative(self, x: torch.Tensor):
        """(B(x), B'(x)), each (..., n): de Boor's triangle to degree k - 1,
        then one more step for the values and the derivative rule
        B'_i = k (B_{i,k-1} / (t_{i+k} - t_i) - B_{i+1,k-1} / (t_{i+k+1} - t_{i+1}))."""
        k, t = self.k, self.t
        # a NaN x (the flow of a proposal outside the box) reads cell 0 and
        # stays NaN
        j = torch.clamp(torch.floor(torch.nan_to_num(x.detach()) * self.n_cells),
                        0, self.n_cells - 1).long()
        mu = j + k                                  # t[mu] <= x < t[mu + 1]
        left = [None] + [x - t[mu + 1 - r] for r in range(1, k + 1)]
        right = [None] + [t[mu + r] - x for r in range(1, k + 1)]
        N = [torch.ones_like(x)]
        for d in range(1, k + 1):
            low = N                                 # degree d - 1
            saved = torch.zeros_like(x)
            N = []
            for r in range(d):
                temp = low[r] / (right[r + 1] + left[d - r])
                N.append(saved + right[r + 1] * temp)
                saved = left[d - r] * temp
            N.append(saved)
        zero = torch.zeros_like(x)
        dN = []
        for r in range(k + 1):                      # N[r] is B_{j + r}
            a = low[r - 1] / (t[mu + r] - t[mu + r - k]) if r >= 1 else zero
            b = low[r] / (t[mu + r + 1] - t[mu + r + 1 - k]) if r < k else zero
            dN.append(k * (a - b))
        out, dout = 0.0, 0.0
        for r in range(k + 1):
            onehot = (self.index == (j + r)[..., None]).to(x.dtype)
            out = out + onehot * N[r][..., None]
            dout = dout + onehot * dN[r][..., None]
        return out, dout


def i_splines(b: torch.Tensor) -> torch.Tensor:
    """I_j = Σ_{m >= j} B_m for j < n, and I_n = 0: (..., n) -> (..., n+1)."""
    suffix = torch.flip(torch.cumsum(torch.flip(b, [-1]), -1), [-1])
    return torch.cat([suffix, torch.zeros_like(b[..., :1])], -1)


def made_masks(D: int, hidden: int, n_hidden: int, n_out: int):
    """MADE masks (fan_in, fan_out): input degrees 0..D-1, hidden degrees
    i mod (D-1), output degrees (i mod D) - 1, a link where the downstream
    degree is at least the upstream one; the last mask tiled n_out times."""
    degs = [np.arange(D)] + [np.arange(hidden) % max(D - 1, 1)
                             for _ in range(n_hidden + 1)]
    degs.append(np.arange(D) % D - 1)
    masks = [(b[None, :] >= a[:, None]).astype(np.float64)
             for a, b in zip(degs[:-1], degs[1:])]
    masks[-1] = np.tile(masks[-1], n_out)
    return masks


def _mean_forward(x, L):
    gaps = x[:, 1:] - x[:, :-1]
    used = torch.cat([torch.zeros_like(gaps[:, :1]),
                      torch.cumsum(gaps[:, :-1], -1)], -1)
    space = 2 * L - used
    w = x[:, -1] - x[:, 0]
    u = torch.cat([gaps / (space + BOX_TOL),
                   ((x[:, 0] + L) / (2 * L - w + BOX_TOL))[:, None]], 1)
    return u, -torch.log(space + BOX_TOL).sum(-1) - torch.log(2 * L - w + BOX_TOL)


def _mean_inverse(u, L):
    keep = torch.cat([torch.ones_like(u[:, :1]),
                      torch.cumprod(1.0 - u[:, :-2], -1)], -1)
    gaps = 2 * L * u[:, :-1] * keep
    x0 = u[:, -1] * (2 * L - gaps.sum(-1)) - L
    return x0[:, None] + torch.cat([torch.zeros_like(x0[:, None]),
                                    torch.cumsum(gaps, -1)], -1)


def box_forward(x, L, kind):
    if kind == 'mean':
        return _mean_forward(x, L)
    if kind == 'paired2d':
        ys = x[:, 1::2]
        u, ld = _mean_forward(x[:, 0::2], L)
        return (torch.cat([u, (ys + L) / (2 * L)], 1),
                ld - ys.shape[1] * math.log(2 * L))
    raise ValueError(f"the reference has no coordinate map {kind!r}")


def box_inverse(u, L, kind):
    if kind == 'mean':
        return _mean_inverse(u, L)
    if kind == 'paired2d':
        n = u.shape[1] // 2
        return torch.stack([_mean_inverse(u[:, :n], L), u[:, n:] * 2 * L - L],
                           -1).reshape(u.shape)
    raise ValueError(f"the reference has no coordinate map {kind!r}")


def sector_sort(x, kind):
    """A proposal projected into the sorted sector of the coordinate map."""
    if kind == 'mean':
        return torch.sort(x, -1).values
    xe = x.reshape(x.shape[0], -1, 2)
    order = torch.argsort(xe[:, :, 0], 1, stable=True)
    return torch.gather(xe, 1, order[:, :, None].expand_as(xe)).reshape(x.shape)


class Waveflow:
    """ψ of one configuration; parameters are a dict of tensors keyed by
    their names in the checkpoint layout (``parameter_layout``)."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.n_el = cfg['n_electrons']
        self.dims = cfg['n_space_dimension']
        self.D = self.n_el * self.dims
        self.L = float(cfg['box_length'])
        self.kind = cfg['xu_coord_type']
        self.n_layers = cfg['n_flow_layers']
        self.hidden = cfg['hidden_dim']
        k = cfg['spline_degree']
        self.bs = BSplines(cfg['num_knots'], k, device, dtype)
        self.nB = self.bs.n
        self.nI = self.nB + 1
        self.reg = cfg['i_spline_reg']
        # edge de-biasing of the I-spline weights
        mult = np.ones(self.nI)
        for i in range(k):
            mult[i + 1] *= (i + 1) / k
            mult[self.nI - 2 - i] *= (i + 1) / k
        self.debias = torch.as_tensor(mult, dtype=dtype, device=device)
        self.masks_I = [torch.as_tensor(m, dtype=dtype, device=device)
                        for m in made_masks(self.D, self.hidden, 1, self.nI)]
        self.masks_B = [torch.as_tensor(m, dtype=dtype, device=device)
                        for m in made_masks(self.D, self.hidden, 1, self.nB)]
        # the Gram matrix of B by the trapezoid rule on the mesh
        n_mesh = cfg['n_spline_base_mesh_points']
        self.mesh = torch.linspace(0.0, 1.0, n_mesh, dtype=dtype, device=device)
        self.B_mesh = self.bs(self.mesh)                       # (P, nB)
        wq = torch.full((n_mesh,), 1.0 / (n_mesh - 1), dtype=dtype,
                        device=device)
        wq[0] = wq[-1] = 0.5 / (n_mesh - 1)
        self.gram = (self.B_mesh * wq[:, None]).T @ self.B_mesh
        self.gram = 0.5 * (self.gram + self.gram.T)
        # the gap coordinates carry ψ/√2
        self.gap = torch.zeros(self.D, dtype=torch.bool, device=device)
        n_gap = self.D - 1 if self.kind == 'mean' else self.D // 2 - 1
        self.gap[:n_gap] = True

    # -- conditioners ------------------------------------------------------

    def _mlp(self, params, prefix, masks, x):
        h = x
        for i, m in enumerate(masks):
            h = h @ (params[f'{prefix}mlp.W.{i}'] * m) + params[f'{prefix}mlp.b.{i}']
            if i < len(masks) - 1:
                h = torch.tanh(h)
        n_out = masks[-1].shape[1] // x.shape[1]
        return h.reshape(x.shape[0], n_out, x.shape[1]).transpose(-1, -2)

    def imade_weights(self, params, layer, u):
        """(B, D, nI) I-spline weights of IMADE layer ``layer`` at u."""
        p = torch.sigmoid(self._mlp(params, self.imade_prefix(layer),
                                    self.masks_I, u))
        w = p / p.sum(-1, keepdim=True) + self.reg
        w = w * self.debias
        w = w / w.sum(-1, keepdim=True)
        w = torch.cat([torch.zeros_like(w[..., :1]), w[..., 1:-1],
                       torch.zeros_like(w[..., :1])], -1)
        return w / w.sum(-1, keepdim=True)

    def prior_weights(self, params, u):
        """(B, D, nB) B-spline weights of the prior at u, unit S-norm."""
        p = self._mlp(params, 'conditioner.', self.masks_B, u)
        w = p / p.sum(-1, keepdim=True)
        w = torch.cat([torch.zeros_like(w[..., :1]), w[..., 1:-1],
                       torch.zeros_like(w[..., :1])], -1)
        norm = torch.sqrt(torch.einsum('...i,ij,...j->...', w, self.gram, w))
        return w / norm[..., None]

    @staticmethod
    def imade_prefix(layer):
        return f'transform.layers.{2 * layer + 1}.conditioner.'

    # -- ψ -----------------------------------------------------------------

    def forward(self, params, x):
        """(u, log_det): the flow T at x (B, D)."""
        u, log_det = box_forward(x, self.L, self.kind)
        for layer in range(self.n_layers):
            w = self.imade_weights(params, layer, u)
            b, db = self.bs.with_derivative(u)
            value = (w * i_splines(b)).sum(-1)
            deriv = (w * i_splines(db)).sum(-1)
            log_det = log_det + torch.log(deriv + LOG_TOL).sum(-1)
            u = value.flip(-1)
        return u, log_det

    def amplitudes(self, params, x):
        u, log_det = self.forward(params, x)
        w = self.prior_weights(params, u)
        amps = (w * self.bs(torch.clamp(u, 0.0, 1.0))).sum(-1)
        return amps, log_det

    def psi(self, params, x):
        amps, log_det = self.amplitudes(params, x)
        amps = torch.where(self.gap, amps / math.sqrt(2.0), amps)
        return amps.prod(-1) * torch.exp(0.5 * log_det)

    def log_pdf(self, params, x):
        amps, log_det = self.amplitudes(params, x)
        probs = torch.where(self.gap, amps ** 2 / 2, amps ** 2)
        return torch.log(probs + LOG_TOL).sum(-1) + log_det

    # -- sampling ----------------------------------------------------------

    def sample(self, params, u):
        """Exact ancestral draws: u (D, B) uniforms -> x (B, D)."""
        B = u.shape[1]
        out = torch.zeros((B, self.D), dtype=self.dtype, device=self.device)
        for d in range(self.D):
            w = self.prior_weights(params, out)[:, d]           # (B, nB)
            out = out.clone()
            out[:, d] = self._table_draw(w @ self.B_mesh.T, u[d].to(self.dtype))
        return self.inverse(params, out)

    def _table_draw(self, amp, u):
        """The u-quantile of the density ∝ (linear interpolant of amp)²."""
        h = 1.0 / (amp.shape[-1] - 1)
        a, delta = amp[:, :-1], amp[:, 1:] - amp[:, :-1]
        mass = h * (a * a + a * delta + delta * delta / 3.0)
        cdf = torch.cat([torch.zeros_like(mass[:, :1]), torch.cumsum(mass, -1)], -1)
        target = u * cdf[:, -1]
        j = torch.clamp((cdf <= target[:, None]).sum(-1) - 1, 0, mass.shape[-1] - 1)
        q = target - cdf.gather(1, j[:, None])[:, 0]
        a = a.gather(1, j[:, None])[:, 0]
        d = delta.gather(1, j[:, None])[:, 0]
        lo, hi = torch.zeros_like(q), torch.ones_like(q)
        for _ in range(60):
            s = 0.5 * (lo + hi)
            above = h * (a * a * s + a * d * s * s + d * d * s ** 3 / 3.0) > q
            lo, hi = torch.where(above, lo, s), torch.where(above, s, hi)
        return (j + 0.5 * (lo + hi)) * h

    def inverse(self, params, u):
        """x with T(x) = u, each IMADE inverted coordinate by coordinate by
        bisection of its monotone I-spline sum."""
        for layer in reversed(range(self.n_layers)):
            y = u.flip(-1)
            v = torch.zeros_like(y)
            for d in range(self.D):
                w = self.imade_weights(params, layer, v)[:, d]
                lo, hi = torch.zeros_like(y[:, d]), torch.ones_like(y[:, d])
                for _ in range(60):
                    mid = 0.5 * (lo + hi)
                    above = (w * i_splines(self.bs(mid))).sum(-1) > y[:, d]
                    lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
                v = v.clone()
                v[:, d] = 0.5 * (lo + hi)
            u = v
        return box_inverse(u, self.L, self.kind)

    # -- energy ------------------------------------------------------------

    def potential(self, x):
        protons = torch.as_tensor(np.asarray(self.cfg['protons'], np.float64),
                                  dtype=self.dtype, device=self.device)
        xe = x.reshape(x.shape[0], self.n_el, self.dims)
        r2 = ((xe[:, :, None, :] - protons[None, None]) ** 2).sum(-1)
        v = -(1.0 / torch.sqrt(1.0 + r2)).sum((-1, -2))
        for a in range(self.n_el):
            for b in range(a):
                v = v + 1.0 / torch.sqrt(1.0 + ((xe[:, a] - xe[:, b]) ** 2).sum(-1))
        return v

    def hpsi_and_psi(self, params, x):
        """(Hψ, ψ) at x (B, D): -½∇²ψ + Vψ, the Laplacian by reverse over
        reverse, one coordinate at a time (walkers are independent rows)."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            psi = self.psi(params, x)
            g, = torch.autograd.grad(psi.sum(), x, create_graph=True)
            lap = torch.zeros_like(psi)
            for d in range(self.D):
                gg, = torch.autograd.grad(g[:, d].sum(), x, retain_graph=True)
                lap = lap + gg[:, d]
        return (-0.5 * lap + self.potential(x) * psi).detach(), psi.detach()

    def local_energy(self, params, x, block: int = 4096):
        """E_L = Hψ / ψ (|ψ| clamped away from zero), in row blocks."""
        out = []
        for i in range(0, x.shape[0], block):
            h, psi = self.hpsi_and_psi(params, x[i:i + block])
            out.append(h / safe_psi(psi))
        return torch.cat(out)


def safe_psi(psi):
    sign = torch.where(psi >= 0, 1.0, -1.0).to(psi.dtype)
    return sign * torch.clamp(psi.abs(), min=PSI_EPS)


def parameter_layout(cfg: dict):
    """[(name, shape, bound)]: every parameter of the configuration with the
    half-width of the uniform law it is drawn from (the MADE layers'
    U(±1/√fan_in), the conditioners' free offsets U(±½)), in the order the
    weights are drawn."""
    D = cfg['n_electrons'] * cfg['n_space_dimension']
    H = cfg['hidden_dim']
    nB = cfg['num_knots'] + cfg['spline_degree'] - 1
    out = []

    def conditioner(prefix, n_out):
        out.append((f'{prefix}zero_params', (D, n_out), 0.5))
        widths = [(D, H), (H, H), (H, D * n_out)]
        for i, (fan_in, fan_out) in enumerate(widths):
            out.append((f'{prefix}mlp.W.{i}', (fan_in, fan_out), fan_in ** -0.5))
        for i, (fan_in, fan_out) in enumerate(widths):
            out.append((f'{prefix}mlp.b.{i}', (fan_out,), fan_in ** -0.5))

    for layer in range(cfg['n_flow_layers']):
        conditioner(Waveflow.imade_prefix(layer), nB + 1)
    conditioner('conditioner.', nB)
    return out
