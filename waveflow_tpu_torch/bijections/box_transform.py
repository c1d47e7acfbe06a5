"""Box <-> unit-hypercube coordinate transforms.

Port of waveflow_tpu/bijections/box_transform.py, every map with its
forward log-det (the inverse's is zero, as in JAX):

  * 'mean' — sorted 1D fermions: n-1 consecutive gaps scaled by shrinking
    free space, plus a mean-position channel, with the closed-form inverse
    for any n:

      forward:  s_0 = 2L, u_i = g_i / s_i, s_{i+1} = s_i - g_i  (gaps g)
                u_{n-1} = (x_0 + L) / (2L - w),  w = sum g_i
      inverse:  g_i = 2L u_i prod_{j<i} (1 - u_j)
                x_0 = u_{n-1} (2L - w) - L,  x_{i+1} = x_i + g_i

  * 'first' — the first coordinate anchored absolutely, each later one a
    gap scaled by the space left to the right wall;
  * 'independent' — the affine map (x + L) / 2L per coordinate, no order:
    one electron in n > 1 dimensions, or the φ of the antisym ansatz;
  * 'paired2d' — 2D fermions in the interleaved layout (x1, y1, x2, y2,
    ...), on the sector sorted by x: the x's through 'mean', the y's
    through 'independent'; output [x-gaps..., x-mean, y...].

JAX falls back to 'first' for any other name; the port raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

TOL = 1e-7


def _mean_forward(x: torch.Tensor, L: float):
    gaps = x[:, 1:] - x[:, :-1]                          # (B, n-1)
    consumed = torch.cat([torch.zeros_like(gaps[:, :1]),
                          torch.cumsum(gaps[:, :-1], dim=-1)], dim=-1)
    space_left = 2 * L - consumed
    u_gaps = gaps / (space_left + TOL)
    w = x[:, -1] - x[:, 0]
    u_last = (x[:, 0] + L) / (2 * L - w + TOL)
    outputs = torch.cat([u_gaps, u_last[:, None]], dim=1)
    log_det = (-torch.log(space_left + TOL).sum(-1)
               - torch.log(2 * L - w + TOL))
    return outputs, log_det


def _mean_inverse(u: torch.Tensor, L: float) -> torch.Tensor:
    one_minus = 1.0 - u[:, :-1]
    prods = torch.cat([torch.ones_like(one_minus[:, :1]),
                       torch.cumprod(one_minus[:, :-1], dim=-1)], dim=-1)
    gaps = 2 * L * u[:, :-1] * prods
    w = gaps.sum(-1)
    x0 = u[:, -1] * (2 * L - w) - L
    return x0[:, None] + torch.cat([torch.zeros_like(x0[:, None]),
                                    torch.cumsum(gaps, dim=-1)], dim=-1)


def _first_forward(x: torch.Tensor, L: float):
    prev = x[:, :-1]
    out0 = (x[:, 0] + L) / (2 * L)
    rest = (x[:, 1:] - prev) / (L - prev + TOL)
    outputs = torch.cat([out0[:, None], rest], dim=1)
    log_det = -math.log(2 * L) - torch.log(L - prev + TOL).sum(-1)
    return outputs, log_det


def _first_inverse(u: torch.Tensor, L: float) -> torch.Tensor:
    cols = [(u[:, 0] - 0.5) * 2 * L]
    for i in range(1, u.shape[-1]):
        prev = cols[-1]
        cols.append(u[:, i] * (L - prev) + prev)
    return torch.stack(cols, dim=1)


def _independent_forward(x: torch.Tensor, L: float):
    log_det = torch.full(x.shape[:-1], -x.shape[-1] * math.log(2 * L),
                         dtype=x.dtype, device=x.device)
    return (x + L) / (2 * L), log_det


def _independent_inverse(u: torch.Tensor, L: float) -> torch.Tensor:
    return u * (2 * L) - L


def _paired2d_forward(x: torch.Tensor, L: float):
    xs, ys = x[:, 0::2], x[:, 1::2]
    u_x, ld_x = _mean_forward(xs, L)
    u_y = (ys + L) / (2 * L)
    return (torch.cat([u_x, u_y], dim=1),
            ld_x - ys.shape[-1] * math.log(2 * L))


def _paired2d_inverse(u: torch.Tensor, L: float) -> torch.Tensor:
    n_el = u.shape[-1] // 2
    xs = _mean_inverse(u[:, :n_el], L)
    ys = u[:, n_el:] * (2 * L) - L
    return torch.stack([xs, ys], dim=-1).reshape(u.shape)


_MAPS = {'mean': (_mean_forward, _mean_inverse),
         'first': (_first_forward, _first_inverse),
         'independent': (_independent_forward, _independent_inverse),
         'paired2d': (_paired2d_forward, _paired2d_inverse)}
COORD_TYPES = tuple(_MAPS)


class BoxTransform(nn.Module):
    """Box coordinates in [-L, L]^n -> [0, 1]^n (forward, with its log-det)
    and back (inverse, log-det zero), by ``xu_coord_type``."""

    def __init__(self, box_side: float = 1.0, xu_coord_type: str = 'mean'):
        super().__init__()
        if xu_coord_type not in _MAPS:
            raise ValueError(
                f"unknown xu_coord_type {xu_coord_type!r}; one of "
                f"{COORD_TYPES} (JAX falls back to 'first')")
        self.L = float(box_side)
        self.xu_coord_type = xu_coord_type
        self._forward, self._inverse = _MAPS[xu_coord_type]

    def forward(self, x: torch.Tensor):
        return self._forward(x, self.L)

    def inverse(self, u: torch.Tensor):
        return self._inverse(u, self.L), torch.zeros(
            u.shape[:1], dtype=u.dtype, device=u.device)
