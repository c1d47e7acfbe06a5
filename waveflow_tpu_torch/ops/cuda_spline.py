"""Kernel K4: the table-lerp spline evaluation (csrc/spline_eval.cu) and its
plain versions.

Replaces waveflow_tpu/ops/pallas_spline.py::spline_eval_pallas
(``_spline_eval_kernel``).  All versions compute

    y[n] = Σ_i coeffs[n, i] · lerp(table[:, i], x[n])

with cell = clip(floor(x · n_cells), 0, n_cells − 1) and frac = x · n_cells −
cell left unclipped (linear extension of the edge cells outside [0, 1]).
``spline_eval`` runs the CUDA kernel on a CUDA tensor and the plain
gather-lerp on a CPU tensor — never the plain version on the card.
``onehot_matmul_eval`` is the gather-free formulation the TPU kernel uses
(the JAX package's function of the same name); tests and chip_smoke.py
hold the kernel against it, the port never calls it.
"""

from __future__ import annotations

import ctypes

import torch

from waveflow_tpu_torch.ops import cuda_build

launches = 0          # kernel launches since the last reset (chip_smoke.py)

# the kernel's constants (csrc/spline_eval.cu sets its own grid from them)
THREADS = 256
LANES_PER_ROW = 8

# the C entry points of csrc/spline_eval.cu: (argtypes, restype)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    'spline_eval_launch': ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
    'spline_eval_error_string': ([_INT], ctypes.c_char_p)}


def plan(N: int) -> cuda_build.LaunchPlan:
    """The launch of csrc/spline_eval.cu for N rows: 8 lanes gather and
    reduce one row, 32 rows per 256-thread block, no shared memory."""
    if N < 1:
        raise ValueError(f"spline_eval kernel needs N >= 1, got {N}")
    rows_per_block = THREADS // LANES_PER_ROW
    return cuda_build.LaunchPlan(-(-N // rows_per_block), THREADS, 0, 'gather')


def lerp_basis(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Table rows interpolated at x: table (n_mesh, n_bases), x (...,) ->
    (..., n_bases)."""
    n_cells = table.shape[0] - 1
    pos = x * n_cells
    idx = torch.clamp(torch.floor(pos), 0, n_cells - 1)
    frac = pos - idx
    idx = idx.long()
    y_l = table[idx]
    return y_l + (table[idx + 1] - y_l) * frac[..., None]


def spline_eval_plain(table: torch.Tensor, coeffs: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather-lerp: coeffs (..., n_bases), x (...,) -> (...,)."""
    return (lerp_basis(table, x) * coeffs).sum(-1)


def onehot_matmul_eval(table: torch.Tensor, coeffs: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """The same function as a dense lerp-weight matrix W (two non-zeros per
    row) times the table: rowsum((W @ table) ∘ coeffs)."""
    n_mesh = table.shape[0]
    n_cells = n_mesh - 1
    pos = x * n_cells
    idx = torch.clamp(torch.floor(pos), 0, n_cells - 1)
    frac = pos - idx
    col = torch.arange(n_mesh, dtype=x.dtype, device=x.device)
    zero = x.new_zeros(())
    w = (torch.where(col == idx[..., None], 1.0 - frac[..., None], zero)
         + torch.where(col == idx[..., None] + 1.0, frac[..., None], zero))
    return ((w @ table) * coeffs).sum(-1)


def spline_eval_cuda(table: torch.Tensor, coeffs: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: table (n_mesh, n_bases), coeffs (N, n_bases),
    x (N,), all f32 on the card -> (N,)."""
    global launches
    if not (x.is_cuda and coeffs.device == x.device and table.device == x.device):
        raise ValueError("spline_eval_cuda needs table, coeffs and x on one "
                         "CUDA device")
    if not (table.dtype == coeffs.dtype == x.dtype == torch.float32):
        raise TypeError("spline_eval_cuda takes float32 tensors")
    if (table.ndim != 2 or table.shape[0] < 2 or coeffs.ndim != 2
            or coeffs.shape[1] != table.shape[1]
            or x.shape != coeffs.shape[:1]):
        raise ValueError(
            "expected table (n_mesh >= 2, n_bases), coeffs (N, n_bases) and "
            f"x (N,), got {tuple(table.shape)}, {tuple(coeffs.shape)} and "
            f"{tuple(x.shape)}")
    table, coeffs, x = (a if a.is_contiguous() else a.contiguous()
                        for a in (table, coeffs, x))
    N = x.shape[0]
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    lib = cuda_build.bind('spline_eval', SIGNATURES)
    err = lib.spline_eval_launch(
        table.data_ptr(), coeffs.data_ptr(), x.data_ptr(), out.data_ptr(),
        N, table.shape[0], table.shape[1],
        cuda_build.current_stream(x.device.index))
    launches += 1
    if err:
        raise RuntimeError("spline_eval kernel launch failed: "
                           + lib.spline_eval_error_string(err).decode())
    return out


def spline_eval(table: torch.Tensor, coeffs: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """K4 on a CUDA tensor (leading dims flattened to one batch), its plain
    gather-lerp on a CPU tensor: coeffs (..., n_bases), x (...,) -> (...,)."""
    if x.shape != coeffs.shape[:-1]:
        raise ValueError(f"x {tuple(x.shape)} does not match the batch of "
                         f"coeffs {tuple(coeffs.shape)}")
    if x.is_cuda:
        y = spline_eval_cuda(table, coeffs.reshape(-1, coeffs.shape[-1]),
                             x.reshape(-1))
        return y.reshape(x.shape)
    return spline_eval_plain(table, coeffs, x)
