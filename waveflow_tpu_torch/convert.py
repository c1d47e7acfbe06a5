"""Carry JAX parameters and checkpoints across to the PyTorch port.

``params_from_jax`` maps the JAX Waveflow params pytree (numpy arrays) onto
the state-dict names of the port's module tree (models/factory.py):

    JAX                                  port
    params[0][i] = ((W,b)..., zero)      transform.layers.i.conditioner.*
    params[1]    = ((W,b)..., zero)      conditioner.*

with dense weights kept in the JAX (fan_in, fan_out) layout.
``load_jax_checkpoint`` reads a checkpoint pickle written by the JAX
trainer without JAX or optax installed.
"""

from __future__ import annotations

import importlib
import pickle

import numpy as np
import torch


def _conditioner_entries(prefix: str, cond) -> dict:
    mlp, zero = cond
    out = {}
    for k, (W, b) in enumerate(mlp):
        out[f'{prefix}mlp.W.{k}'] = torch.as_tensor(np.asarray(W, np.float32))
        out[f'{prefix}mlp.b.{k}'] = torch.as_tensor(np.asarray(b, np.float32))
    out[f'{prefix}zero_params'] = torch.as_tensor(np.asarray(zero, np.float32))
    return out


def params_from_jax(tree) -> dict:
    """JAX Waveflow params -> a state dict for ``Waveflow.load_state_dict``
    (CPU tensors; ``load_state_dict`` copies them onto the model's device)."""
    transform_params, prior_params = tree
    state = {}
    for i, layer in enumerate(transform_params):
        if len(layer) == 0:              # BoxTransform / Reverse: no params
            continue
        state.update(_conditioner_entries(
            f'transform.layers.{i}.conditioner.', layer))
    state.update(_conditioner_entries('conditioner.', prior_params))
    return state


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
