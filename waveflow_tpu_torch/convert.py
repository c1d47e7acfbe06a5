"""Carry JAX parameters and checkpoints across to the PyTorch port.

``params_from_jax`` (Waveflow), ``mflow_params_from_jax`` (MFlow) and
``flow_params_from_jax`` (Flow / IFlow) map a JAX params pytree (numpy
arrays) onto the state-dict names of the port's module trees
(models/factory.py, benchmark/density.py):

    JAX                                       port
    transform_params[i], IMADE layer
        = (((W,b)...), zero)                  transform.layers.i.conditioner.*
    transform_params[i], affine MADE layer
        = ((W,b)...)                          transform.layers.i.transform.*
    sp_params = (((W,b)...), zero)            conditioner.*

with dense weights kept in the JAX (fan_in, fan_out) layout.  Waveflow and
MFlow params are the pair ``(transform_params, sp_params)``; Flow params
are ``transform_params`` alone (its priors have none).
``load_jax_checkpoint`` reads a checkpoint pickle written by the JAX
trainer without JAX or optax installed.
"""

from __future__ import annotations

import importlib
import pickle

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    """A float32 copy (arrays that come out of JAX are read-only)."""
    return torch.tensor(np.asarray(a, np.float32))


def _mlp_entries(prefix: str, mlp) -> dict:
    out = {}
    for k, (W, b) in enumerate(mlp):
        out[f'{prefix}W.{k}'] = _tensor(W)
        out[f'{prefix}b.{k}'] = _tensor(b)
    return out


def _conditioner_entries(prefix: str, cond) -> dict:
    mlp, zero = cond
    out = _mlp_entries(f'{prefix}mlp.', mlp)
    out[f'{prefix}zero_params'] = _tensor(zero)
    return out


def flow_params_from_jax(transform_params) -> dict:
    """JAX Serial params of a Flow / IFlow -> a state dict for
    ``Flow.load_state_dict`` (CPU tensors; ``load_state_dict`` copies them
    onto the model's device)."""
    state = {}
    for i, layer in enumerate(transform_params):
        if len(layer) == 0:              # BoxTransform / Reverse: no params
            continue
        prefix = f'transform.layers.{i}.'
        if hasattr(layer[1], 'shape'):   # (mlp, zero_params): a conditioner
            state.update(_conditioner_entries(f'{prefix}conditioner.', layer))
        else:                            # ((W, b), ...): an affine MADE net
            state.update(_mlp_entries(f'{prefix}transform.', layer))
    return state


def params_from_jax(tree) -> dict:
    """JAX Waveflow params -> a state dict for ``Waveflow.load_state_dict``."""
    transform_params, prior_params = tree
    state = flow_params_from_jax(transform_params)
    state.update(_conditioner_entries('conditioner.', prior_params))
    return state


# MFlow params have the Waveflow layout: (transform_params, sp_params)
mflow_params_from_jax = params_from_jax


class _Inert(tuple):
    """Stand-in for a pickled optax/JAX class: keeps its arguments."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)


class _CheckpointUnpickler(pickle.Unpickler):
    _stubs: dict = {}

    def find_class(self, module, name):
        root = module.split('.')[0]
        if root in ('optax', 'jax', 'jaxlib'):
            key = f'{module}.{name}'
            if key not in self._stubs:
                self._stubs[key] = type(name, (_Inert,), {'__module__': module})
            return self._stubs[key]
        if module.startswith('numpy._core'):
            try:
                importlib.import_module(module)
            except ImportError:          # numpy 1.x names it numpy.core
                module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def load_jax_checkpoint(path) -> dict:
    """Read a JAX trainer checkpoint (a pickle of numpy arrays whose
    optimizer state references optax classes) with neither JAX nor optax
    importable.  Returns {'params': pytree of numpy arrays, 'epoch': int}.
    Only load checkpoints this project wrote: unpickling runs code."""
    with open(path, 'rb') as f:
        state = _CheckpointUnpickler(f).load()
    return {'params': state['params'], 'epoch': int(state['epoch'])}
