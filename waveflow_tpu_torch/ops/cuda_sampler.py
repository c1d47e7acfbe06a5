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
import functools

import torch

from waveflow_tpu_torch.ops import cuda_build
from waveflow_tpu_torch.ops.spline_eval import SplineEvaluator

# kernel launches since the last reset (chip_smoke.py), one count per kind
launches = 0          # K1, 'squared'
launches_linear = 0   # K2, 'linear'

# the kernel's constants (csrc/sampler.cu checks a plan against its own)
HALF_THREADS = 256            # the threads that own one mesh
WARPS = HALF_THREADS // 32
CELLS_PER_THREAD = 8
PREFETCH_REGISTERS = 2        # G * n_bases <= PREFETCH_REGISTERS * threads
RING = 256                    # deferred in-cell solves per block
# walkers per group -> threads: 8 walkers are two halves of 4
WALKERS_PER_BLOCK = {8: 2 * HALF_THREADS, 4: HALF_THREADS, 2: HALF_THREADS}
# what a block spends on one group, in microseconds on an H100
# (examples/kernel_sweep_torch.py): kind 'squared' at the flagship's 28-base
# table, kind 'linear' at the density model's 16-base table; only the ratios
# within a kind matter
GROUP_COST = {'squared': {8: 6.5, 4: 4.1, 2: 3.0},
              'linear': {8: 4.6, 4: 2.9, 2: 1.9}}
STREAMED_GROUP = 8            # the one group size of a streamed table

# the C entry points of csrc/sampler.cu: (argtypes, restype)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_HEAD = [_PTR] * 4 + [_INT] * 3 + [ctypes.c_float]
SIGNATURES = {
    'sampler_launch': (_HEAD + [_INT] * 6 + [_PTR], _INT),
    'sampler_linear_launch': (_HEAD + [_INT] * 4 + [_PTR], _INT),
    'sampler_init': ([ctypes.POINTER(_INT)] * 2, _INT),
    'sampler_error_string': ([_INT], ctypes.c_char_p)}

last_plan = None      # the LaunchPlan of the latest launch, either kind


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(n_bases: int, n_mesh: int, walkers_per_block: int,
               staged: bool = True) -> int:
    """Dynamic shared memory of one block: the whole (n_bases, n_mesh) table
    where it is staged (padded so that every thread may read its 8 points of
    the last row), the group's coefficients, the scan's scratch, the ring of
    deferred solves and the mbarrier — the sum csrc/sampler.cu computes."""
    G = walkers_per_block
    table = _round4(n_bases * n_mesh
                    + max(HALF_THREADS * CELLS_PER_THREAD - n_mesh, 0))
    return 4 * (table * staged + _round4(n_bases * G) + G * (3 * WARPS + 4)
                + 3 * RING) + 16


@functools.lru_cache(maxsize=256)
def plan(B: int, n_bases: int, n_mesh: int,
         n_sm: int = cuda_build.N_SM,
         smem_limit: int = cuda_build.SMEM_PER_BLOCK,
         walkers_per_block: int | None = None,
         kind: str = 'squared') -> cuda_build.LaunchPlan:
    """The launch of csrc/sampler.cu for B walkers: persistent blocks, one
    per SM, taking groups of G walkers (the plan's ``group``) grid-stride;
    256 threads for G = 2 or 4, 512 (two halves of 4 walkers) for G = 8.

    Regime 'shared': the whole table sits in the block's shared memory.  G
    is the one of 8, 4, 2 that fits and costs the busiest block least: its
    rounds of groups times the GROUP_COST of the kernel's ``kind`` — small
    groups while they spread over idle SMs, large ones once every SM is
    busy.  ``walkers_per_block``
    forces it (measurements only).  Regime 'streamed': a table above the
    shared-memory limit stays in device memory and the same kernel reads it
    through L1/L2, in groups of 8.  Raises ValueError on a shape the kernel
    does not take, with the limit in its text."""
    if kind not in GROUP_COST:
        raise ValueError(f"kind must be one of {sorted(GROUP_COST)}, got "
                         f"{kind!r}")
    cost = GROUP_COST[kind]
    if B < 1 or n_bases < 1 or n_mesh < 2:
        raise ValueError(f"sampler kernel needs B, n_bases >= 1 and n_mesh "
                         f">= 2, got B={B}, n_bases={n_bases}, n_mesh={n_mesh}")
    if n_mesh - 1 > HALF_THREADS * CELLS_PER_THREAD:
        raise ValueError(f"sampler kernel supports n_mesh <= "
                         f"{HALF_THREADS * CELLS_PER_THREAD + 1}, got {n_mesh}")
    fitting = [G for G, threads in WALKERS_PER_BLOCK.items()
               if smem_bytes(n_bases, n_mesh, G) <= smem_limit
               and G * n_bases <= PREFETCH_REGISTERS * threads]
    if walkers_per_block is not None:
        if walkers_per_block not in fitting:
            raise ValueError(
                f"walkers_per_block must be one of {fitting} for a "
                f"({n_bases}, {n_mesh}) table in shared memory, got "
                f"{walkers_per_block}")
        G = walkers_per_block
    elif fitting:
        G = min(fitting, key=lambda G: (
            -(-(-(-B // G)) // n_sm) * cost[G], cost[G]))
    else:
        G = STREAMED_GROUP
        max_bases = PREFETCH_REGISTERS * WALKERS_PER_BLOCK[G] // G
        if (n_bases > max_bases
                or smem_bytes(n_bases, n_mesh, G, staged=False) > smem_limit):
            raise ValueError(
                f"the ({n_bases}, {n_mesh}) table needs "
                f"{smem_bytes(n_bases, n_mesh, min(WALKERS_PER_BLOCK))} bytes "
                f"of shared memory, above the block's limit of {smem_limit}, "
                f"and a streamed table takes at most {max_bases} bases")
    staged = bool(fitting)
    return cuda_build.LaunchPlan(
        min(-(-B // G), n_sm), WALKERS_PER_BLOCK[G],
        smem_bytes(n_bases, n_mesh, G, staged),
        'shared' if staged else 'streamed', G)


def _launch(entry: str, kind: str, evaluator: SplineEvaluator,
            coeffs: torch.Tensor, u: torch.Tensor, *schedule: int,
            walkers_per_block: int | None = None) -> torch.Tensor:
    """Check the inputs, then call the C entry point ``entry`` of
    csrc/sampler.cu: (u, coeffs, table, out, B, n_bases, n_mesh, h,
    *schedule, G, table staged or not, grid, shared bytes, stream).  Raises
    if the launch is refused."""
    global last_plan
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
    if not table_t.is_contiguous() or table_t.data_ptr() % 16:
        raise ValueError("the sampler kernel needs a contiguous, 16-byte "
                         "aligned table")
    if not coeffs.is_contiguous():
        coeffs = coeffs.contiguous()
    if not u.is_contiguous():
        u = u.contiguous()
    B = coeffs.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=coeffs.device)
    if B == 0:
        return out
    lib = cuda_build.bind('sampler', SIGNATURES)
    n_sm, smem_limit = cuda_build.device_limits(lib, 'sampler_init',
                                                coeffs.device.index)
    p = last_plan = plan(B, n_bases, n_mesh, n_sm, smem_limit,
                         walkers_per_block, kind)
    # ctypes rounds h to f32, as the JAX package's f32 arithmetic does
    err = getattr(lib, entry)(
        u.data_ptr(), coeffs.data_ptr(), table_t.data_ptr(), out.data_ptr(),
        B, n_bases, n_mesh, 1.0 / (n_mesh - 1), *schedule, p.group,
        p.regime == 'shared', p.grid, p.smem_bytes,
        cuda_build.current_stream(coeffs.device.index))
    if err:
        raise RuntimeError("sampler kernel launch failed: "
                           + lib.sampler_error_string(err).decode())
    return out


def sample_squared_amplitude_cuda(evaluator: SplineEvaluator,
                                  coeffs: torch.Tensor, u: torch.Tensor,
                                  n_bisect: int = 12,
                                  n_newton: int = 3,
                                  walkers_per_block: int | None = None
                                  ) -> torch.Tensor:
    """K1: coeffs (B, n_bases), u (B,) f32 on the card -> (B,) draws in
    [0, 1] from p ∝ (coeffs · T)²."""
    global launches
    out = _launch('sampler_launch', 'squared', evaluator, coeffs, u,
                  n_bisect, n_newton,
                  walkers_per_block=walkers_per_block)
    launches += bool(out.numel())
    return out


def sample_linear_density_cuda(evaluator: SplineEvaluator,
                               coeffs: torch.Tensor,
                               u: torch.Tensor,
                               walkers_per_block: int | None = None
                               ) -> torch.Tensor:
    """K2: coeffs (B, n_bases), u (B,) f32 on the card -> (B,) draws in
    [0, 1] from p ∝ max(coeffs · T, 0)."""
    global launches_linear
    out = _launch('sampler_linear_launch', 'linear', evaluator, coeffs, u,
                  walkers_per_block=walkers_per_block)
    launches_linear += bool(out.numel())
    return out
