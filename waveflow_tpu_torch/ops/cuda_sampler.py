"""Kernels K1 and K2: the fused inverse-CDF sampler (csrc/sampler.cu).

One kernel template, two kinds.  K1 ('squared') replaces
waveflow_tpu/ops/pallas_sampler.py::pallas_sample_squared_amplitude and K2
('linear') ::pallas_sample_linear_density (``_sampler_kernel`` with kind
'squared' / 'linear').  Their plain versions are the plain paths of
ops/sampling.py::sample_squared_amplitude and ::sample_linear_density,
which route CUDA tensors here.  The kernel's in-cell solves (12 + 3
bisection/Newton for K1, the closed-form quadratic for K2) and clipping
walls are the plain paths'; its prefix sum associates differently, which
moves draws near cell edges by up to ~6e-5.  For u within ~1e-4 of 1 (a
thin right tail, where a few f32 ulps of the CDF span many cells) either
f32 version may land many cells from the exact quantile in x while staying
within ~1e-6 of it in probability; chip_smoke.py holds those draws to a
float64 plain draw.
"""

from __future__ import annotations

import ctypes

import torch

from waveflow_tpu_torch.ops import cuda_build
from waveflow_tpu_torch.ops.spline_eval import SplineEvaluator

# kernel launches since the last reset (chip_smoke.py), one count per kind
launches = 0          # K1, 'squared'
launches_linear = 0   # K2, 'linear'

CELLS_PER_THREAD = 8
THREADS = 256
MAX_BASES = 64


def _launch(entry: str, evaluator: SplineEvaluator, coeffs: torch.Tensor,
            u: torch.Tensor, *schedule: int) -> torch.Tensor:
    """Check the inputs, then call the C entry point ``entry`` of
    csrc/sampler.cu: (u, coeffs, table, out, B, n_bases, n_mesh, h,
    *schedule, stream).  Raises if the launch is refused."""
    table_t = evaluator.table_t                     # (n_bases, n_mesh)
    n_bases, n_mesh = table_t.shape
    if not (coeffs.is_cuda and u.device == coeffs.device
            and table_t.device == coeffs.device):
        raise ValueError("the sampler kernel needs coeffs, u and the table "
                         "on one CUDA device")
    if coeffs.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("the sampler kernel takes float32 tensors")
    if coeffs.ndim != 2 or coeffs.shape[1] != n_bases or u.shape != coeffs.shape[:1]:
        raise ValueError(f"expected coeffs (B, {n_bases}) and u (B,), got "
                         f"{tuple(coeffs.shape)} and {tuple(u.shape)}")
    if n_mesh - 1 > THREADS * CELLS_PER_THREAD or n_bases > MAX_BASES:
        raise ValueError(f"sampler kernel supports n_mesh <= "
                         f"{THREADS * CELLS_PER_THREAD + 1} and n_bases <= "
                         f"{MAX_BASES}")
    coeffs = coeffs.contiguous()
    u = u.contiguous()
    B = coeffs.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=coeffs.device)
    lib = cuda_build.load('sampler')
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * len(schedule) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # ctypes rounds h to f32, as the JAX package's f32 arithmetic does
    err = fn(u.data_ptr(), coeffs.data_ptr(), table_t.data_ptr(),
             out.data_ptr(), B, n_bases, n_mesh, 1.0 / (n_mesh - 1), *schedule,
             torch.cuda.current_stream(coeffs.device).cuda_stream)
    if err:
        lib.sampler_error_string.restype = ctypes.c_char_p
        raise RuntimeError("sampler kernel launch failed: "
                           + lib.sampler_error_string(err).decode())
    return out


def sample_squared_amplitude_cuda(evaluator: SplineEvaluator,
                                  coeffs: torch.Tensor, u: torch.Tensor,
                                  n_bisect: int = 12,
                                  n_newton: int = 3) -> torch.Tensor:
    """K1: coeffs (B, n_bases), u (B,) f32 on the card -> (B,) draws in
    [0, 1] from p ∝ (coeffs · T)²."""
    global launches
    out = _launch('sampler_launch', evaluator, coeffs, u, n_bisect, n_newton)
    launches += 1
    return out


def sample_linear_density_cuda(evaluator: SplineEvaluator,
                               coeffs: torch.Tensor,
                               u: torch.Tensor) -> torch.Tensor:
    """K2: coeffs (B, n_bases), u (B,) f32 on the card -> (B,) draws in
    [0, 1] from p ∝ max(coeffs · T, 0)."""
    global launches_linear
    out = _launch('sampler_linear_launch', evaluator, coeffs, u)
    launches_linear += 1
    return out
