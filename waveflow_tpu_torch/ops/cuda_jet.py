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

import torch
import torch.nn.functional as F

from waveflow_tpu_torch.ops import cuda_build

launches = 0          # kernel launches since the last reset (chip_smoke.py)


def basis_jet_plain(x: torch.Tensor, A_jet: torch.Tensor, n_cells: int,
                    ncoef: int) -> torch.Tensor:
    """Plain PyTorch core: x (...,) -> (..., A_jet.shape[1])."""
    pos = x * n_cells
    idx = torch.clamp(torch.floor(pos), 0, n_cells - 1)
    s = torch.clamp(pos - idx, 0.0, 1.0)
    onehot = F.one_hot(idx.long(), n_cells).to(x.dtype)
    pows = [torch.ones_like(s)]
    for _ in range(ncoef - 1):
        pows.append(pows[-1] * s)
    powers = torch.stack(pows, dim=-1)                     # (..., ncoef)
    W = (onehot[..., :, None] * powers[..., None, :]).reshape(
        x.shape + (n_cells * ncoef,))
    return W @ A_jet


def basis_jet_cuda(x: torch.Tensor, A_jet: torch.Tensor, n_cells: int,
                   ncoef: int) -> torch.Tensor:
    """Launch the CUDA kernel: x (...,) f32 on the card -> (..., n_out)."""
    global launches
    n_out = A_jet.shape[1]
    if not (x.is_cuda and A_jet.device == x.device):
        raise ValueError("basis_jet_cuda needs x and A_jet on one CUDA device")
    if x.dtype != torch.float32 or A_jet.dtype != torch.float32:
        raise TypeError("basis_jet_cuda takes float32 tensors")
    if A_jet.shape[0] != n_cells * ncoef or not A_jet.is_contiguous():
        raise ValueError(f"A_jet must be a contiguous ({n_cells * ncoef}, n_out) "
                         f"matrix, got {tuple(A_jet.shape)}")
    xf = x.contiguous().reshape(-1)
    out = torch.empty((xf.numel(), n_out), dtype=torch.float32,
                      device=x.device)
    lib = cuda_build.load('basis_jet')
    fn = lib.basis_jet_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xf.data_ptr(), A_jet.data_ptr(), out.data_ptr(), xf.numel(),
             n_cells, ncoef, n_out, torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if err:
        lib.basis_jet_error_string.restype = ctypes.c_char_p
        raise RuntimeError("basis_jet kernel launch failed: "
                           + lib.basis_jet_error_string(err).decode())
    return out.reshape(x.shape + (n_out,))


def basis_jet(x: torch.Tensor, A_jet: torch.Tensor, n_cells: int,
              ncoef: int) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return basis_jet_cuda(x, A_jet, n_cells, ncoef)
    return basis_jet_plain(x, A_jet, n_cells, ncoef)
