"""K1, the fused inverse-CDF sampler of p ∝ (c·T)² (csrc/sampler.cu,
``sampler_kernel`` of kind 0): per walker, the amplitude on every mesh
point (a dot of n_B coefficients), the cubic cell masses (6 operations), the
prefix scan and the compare (1 each), then the in-cell solve.

Per launch over B walkers: bytes = 4 (B n_B coefficients + B uniforms + B
draws + the n_B × n_mesh table); operations = B (2 n_B n_mesh + 8 (n_mesh
- 1)).  Ancestral sampling draws the D coordinates one after another: D
launches per draw of B walkers."""

from __future__ import annotations

from perfbench.kernels import bound_s, shapes

NAME = r'\bsampler_kernel<0,'


def launch(B: int, n_b: int, n_mesh: int):
    """(bytes, operations) of one launch over B walkers."""
    return (4 * (B * n_b + 2 * B + n_b * n_mesh),
            B * (2 * n_b * n_mesh + 8 * (n_mesh - 1)))


def bound_per_draw(cfg: dict, B: int, device_kind: str):
    """The least device seconds of the D launches of one draw of B walkers."""
    s = shapes(cfg)
    one = bound_s(*launch(B, s['n_B'], s['n_mesh']), device_kind)
    return None if one is None else s['D'] * one
