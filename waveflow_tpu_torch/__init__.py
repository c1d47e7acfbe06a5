"""waveflow_tpu_torch — the PyTorch/CUDA port of waveflow_tpu.

Square-flow wavefunctions trained by variational Monte Carlo, and spline
flows trained by maximum likelihood on 2D density benchmarks, in PyTorch,
with the Pallas TPU kernels rewritten as CUDA C++ kernels for Hopper
(sm_90a): the fused inverse-CDF sampler in its two kinds
(ops/cuda_sampler.py), the fused basis jet (ops/cuda_jet.py) and the
table-lerp spline evaluation (ops/cuda_spline.py).  The JAX package is the
reference; this package imports torch, numpy and scipy only.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``; on
a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

# f32 matmuls must stay full f32 on the card: TF32 keeps ~3 decimal digits,
# the same trap as the TPU's bf16 MXU passes that the JAX package pins
# Precision.HIGHEST against (ops/poly_eval.py, models/waveflow.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) and absent —
    there is no silent CPU fallback."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
