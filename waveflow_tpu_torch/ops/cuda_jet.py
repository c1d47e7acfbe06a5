"""Kernel K3: the fused basis jet (csrc/basis_jet.cu) and its plain version.

Replaces waveflow_tpu/ops/pallas_jet.py::make_pallas_basis_jet.  Both
versions compute the CLAMPED in-domain jet

    out[..., d, j] = Σ_k s^k · A_jet[cell · ncoef + k, d · n_bases + j]

with cell = clip(floor(x · n_cells), 0, n_cells − 1) and s = clip(x · n_cells
− cell, 0, 1).  ``basis_jet_plain`` is the JAX 'xla' core: W = onehot(cell)
⊗ s-powers, then one W @ A_jet matmul.  ``basis_jet`` runs the CUDA kernel
on a CUDA tensor and the plain version on a CPU tensor — never the plain
version on the card.  The linear out-of-domain extension and the
derivative rules live in ops/poly_eval.py around either core.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from waveflow_tpu_torch.ops import cuda_build

launches = 0          # kernel launches since the last reset (chip_smoke.py)

# the kernel's constants (csrc/basis_jet.cu checks a plan against its own)
DIRECT_THREADS = 128
STAGED_THREADS = 512
STAGED_SITES = 2
# from this many sites on, staging A_jet in shared memory pays
STAGED_MIN_SITES = 65536

# the C entry points of csrc/basis_jet.cu: (argtypes, restype)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    'basis_jet_launch': ([_PTR] * 3 + [_INT] * 8 + [_PTR], _INT),
    'basis_jet_init': ([ctypes.POINTER(_INT)] * 2, _INT),
    'basis_jet_error_string': ([_INT], ctypes.c_char_p)}

last_plan = None      # the LaunchPlan of the latest launch


def basis_jet_plain(x: torch.Tensor, A_jet: torch.Tensor, n_cells: int,
                    ncoef: int) -> torch.Tensor:
    """Plain PyTorch core: x (...,) -> (..., A_jet.shape[1]), in x's
    dtype (a float64 x takes the f32 A_jet in float64)."""
    pos = x * n_cells
    idx = torch.clamp(torch.floor(pos), 0, n_cells - 1)
    s = torch.clamp(pos - idx, 0.0, 1.0)
    # a comparison, as in JAX: a NaN site (a diverged HMC / NUTS
    # trajectory) gives a zero row and a NaN jet; F.one_hot would raise on
    # the CPU and trip a device assert in its scatter on the card
    cells = torch.arange(n_cells, dtype=x.dtype, device=x.device)
    onehot = (idx[..., None] == cells).to(x.dtype)
    pows = [torch.ones_like(s)]
    for _ in range(ncoef - 1):
        pows.append(pows[-1] * s)
    powers = torch.stack(pows, dim=-1)                     # (..., ncoef)
    W = (onehot[..., :, None] * powers[..., None, :]).reshape(
        x.shape + (n_cells * ncoef,))
    return W @ A_jet.to(W.dtype)


@functools.lru_cache(maxsize=256)
def plan(R: int, n_cells: int, ncoef: int, n_out: int,
         n_sm: int = cuda_build.N_SM,
         smem_limit: int = cuda_build.SMEM_PER_BLOCK,
         regime: str | None = None) -> cuda_build.LaunchPlan:
    """The launch of csrc/basis_jet.cu for R sites: one warp per site in
    both regimes.  'direct' (R below STAGED_MIN_SITES, or an A_jet too large
    for a block's shared memory): blocks of 4 warps, one site each, A_jet
    read from L1/L2.  'staged': persistent blocks of 16 warps, A_jet in
    dynamic shared memory, 4 sites per warp in flight.  ``regime`` forces
    one of the two (measurements only).  Raises ValueError on a shape the
    kernel does not take."""
    if R < 1 or n_cells < 1 or ncoef < 1 or n_out < 4 or n_out % 4:
        raise ValueError(
            f"basis_jet kernel needs R, n_cells, ncoef >= 1 and n_out a "
            f"positive multiple of 4, got R={R}, n_cells={n_cells}, "
            f"ncoef={ncoef}, n_out={n_out}")
    staged_smem = 4 * n_cells * ncoef * n_out + 16      # A_jet + the mbarrier
    fits = staged_smem <= smem_limit
    if regime is None:
        regime = 'staged' if fits and R >= STAGED_MIN_SITES else 'direct'
    if regime == 'direct':
        warps = DIRECT_THREADS // 32
        return cuda_build.LaunchPlan(-(-R // warps), DIRECT_THREADS, 0,
                                     'direct', 1)
    if regime != 'staged':
        raise ValueError(f"unknown regime {regime!r}")
    if not fits:
        raise ValueError(
            f"A_jet needs {staged_smem} bytes of shared memory, above the "
            f"block's limit of {smem_limit}")
    resident = 2 if 2 * (staged_smem + cuda_build.SMEM_BLOCK_RESERVE) \
        <= cuda_build.SMEM_PER_SM else 1
    per_pass = STAGED_THREADS // 32 * STAGED_SITES
    grid = min(resident * n_sm, -(-R // per_pass))
    return cuda_build.LaunchPlan(grid, STAGED_THREADS, staged_smem, 'staged',
                                 STAGED_SITES)


def basis_jet_cuda(x: torch.Tensor, A_jet: torch.Tensor, n_cells: int,
                   ncoef: int, regime: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (...,) f32 on the card -> (..., n_out)."""
    global launches, last_plan
    n_out = A_jet.shape[1]
    if not (x.is_cuda and A_jet.device == x.device):
        raise ValueError("basis_jet_cuda needs x and A_jet on one CUDA device")
    if x.dtype != torch.float32 or A_jet.dtype != torch.float32:
        raise TypeError("basis_jet_cuda takes float32 tensors")
    if (A_jet.shape[0] != n_cells * ncoef or not A_jet.is_contiguous()
            or A_jet.data_ptr() % 16):
        raise ValueError(f"A_jet must be a contiguous, 16-byte aligned "
                         f"({n_cells * ncoef}, n_out) matrix, got "
                         f"{tuple(A_jet.shape)}")
    xf = x if x.is_contiguous() else x.contiguous()
    R = xf.numel()
    out = torch.empty((R, n_out) if x.ndim == 1 else (*x.shape, n_out),
                      dtype=torch.float32, device=x.device)
    if R == 0:
        return out
    lib = cuda_build.bind('basis_jet', SIGNATURES)
    n_sm, smem_limit = cuda_build.device_limits(lib, 'basis_jet_init',
                                                x.device.index)
    p = last_plan = plan(R, n_cells, ncoef, n_out, n_sm, smem_limit, regime)
    err = lib.basis_jet_launch(
        xf.data_ptr(), A_jet.data_ptr(), out.data_ptr(), R, n_cells, ncoef,
        n_out, p.regime == 'staged', p.grid, p.threads, p.smem_bytes,
        cuda_build.current_stream(x.device.index))
    launches += 1
    if err:
        raise RuntimeError("basis_jet kernel launch failed: "
                           + lib.basis_jet_error_string(err).decode())
    return out


def basis_jet(x: torch.Tensor, A_jet: torch.Tensor, n_cells: int,
              ncoef: int) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return basis_jet_cuda(x, A_jet, n_cells, ncoef)
    return basis_jet_plain(x, A_jet, n_cells, ncoef)
