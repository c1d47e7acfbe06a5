"""The n = 4 sorted sector on the port: results/r5_be4_interacting (Be-1d,
4 electrons, L = 10, the flagship widths) loaded into a port trainer, ψ
and the median local energy at 64 walkers against the JAX package's on
the same parameters and walkers."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue,
)
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

torch.set_num_threads(2)

RUN = Path(__file__).resolve().parents[1] / 'results' / 'r5_be4_interacting'
# relative, against the largest |ψ| of the batch; relative, the median E_L
PSI_RTOL, E_MEDIAN_RTOL = 2e-5, 1e-5


def test_be4_sorted_sector_matches_jax():
    """ψ within 2e-5 of the largest |ψ| and the median E_L within 1e-5
    relative of JAX's (a CPU probe found 5.3e-6 on ψ and five digits of
    the median), on 64 walkers JAX draws from the committed parameters."""
    protons, n = system_catalogue[1]['Be']
    t = VMCTrainer(VMCConfig(system_name='Be', box_length=10.0,
                             device='cpu'))
    assert t.load_checkpoint(str(RUN)) and t.input_dim == n == 4
    with open(RUN / 'checkpoints', 'rb') as f:
        jparams = pickle.load(f)['params']
    _, jpsi, _, jsample = jget_waveflow_model(
        n, base_spline_degree=6, i_spline_degree=6, n_prior_internal_knots=23,
        n_i_internal_knots=23, i_spline_reg=0.05, n_flow_layers=3,
        box_size=10.0)(jax.random.PRNGKey(0), n)
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    x = np.asarray(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(3), jparams, 64))
    assert (np.diff(x, axis=1) >= 0).all()         # the sorted sector
    jx = jnp.asarray(x)
    psi_j = np.asarray(jax.jit(jpsi)(jparams, jx))
    e_j = np.asarray(jax.jit(jh)(jparams, jx))[:, 0] / psi_j
    xt = torch.as_tensor(x)
    with torch.no_grad():
        psi_t = t.model.psi(xt).numpy()
        e_t = t.h_fn(xt)[:, 0].numpy() / psi_t
    d_psi = np.abs(psi_t - psi_j).max() / np.abs(psi_j).max()
    d_med = abs(np.median(e_t) - np.median(e_j)) / abs(np.median(e_j))
    print(f"Be n=4: psi {d_psi:.3e} of max|psi|, median E_L "
          f"{np.median(e_t):.6f} / JAX {np.median(e_j):.6f} ({d_med:.3e})")
    assert d_psi <= PSI_RTOL
    assert d_med <= E_MEDIAN_RTOL
