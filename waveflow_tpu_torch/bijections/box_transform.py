"""Box <-> unit-hypercube autoregressive coordinate transform ('mean' map).

Port of the 'mean' variant of waveflow_tpu/bijections/box_transform.py:
n-1 consecutive gaps scaled by shrinking free space, plus a mean-position
channel, with the closed-form inverse for any n:

  forward:  s_0 = 2L, u_i = g_i / s_i, s_{i+1} = s_i - g_i  (gaps g)
            u_{n-1} = (x_0 + L) / (2L - w),  w = sum g_i
  inverse:  g_i = 2L u_i prod_{j<i} (1 - u_j)
            x_0 = u_{n-1} (2L - w) - L,  x_{i+1} = x_i + g_i
"""

from __future__ import annotations

import torch
from torch import nn

TOL = 1e-7


class BoxTransform(nn.Module):
    """Sorted box coordinates in [-L, L]^n -> [0, 1]^n (forward) and back."""

    def __init__(self, box_side: float = 1.0, xu_coord_type: str = 'mean'):
        super().__init__()
        if xu_coord_type != 'mean':
            raise NotImplementedError(
                f"xu_coord_type {xu_coord_type!r} is not ported; only 'mean'")
        self.L = float(box_side)

    def forward(self, x: torch.Tensor):
        L = self.L
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

    def inverse(self, u: torch.Tensor):
        L = self.L
        one_minus = 1.0 - u[:, :-1]
        prods = torch.cat([torch.ones_like(one_minus[:, :1]),
                           torch.cumprod(one_minus[:, :-1], dim=-1)], dim=-1)
        gaps = 2 * L * u[:, :-1] * prods
        w = gaps.sum(-1)
        x0 = u[:, -1] * (2 * L - w) - L
        xs = x0[:, None] + torch.cat([torch.zeros_like(x0[:, None]),
                                      torch.cumsum(gaps, dim=-1)], dim=-1)
        return xs, torch.zeros(u.shape[:1], dtype=u.dtype, device=u.device)


