"""Checkpoint files: an atomic pickle of plain numpy state.

Port of waveflow_tpu/utils/checkpoint.py (``save_state`` / ``load_state``,
and ``save_state_multihost``, where rank 0 of a process group writes).
The caller converts tensors to numpy arrays first.
``load_state`` also reads the JAX trainer's checkpoints with neither JAX,
optax nor the JAX package importable: their optax states and the JAX
package's NamedTuples come back as inert tuples of their fields.
"""

from __future__ import annotations

import importlib
import pickle
from pathlib import Path
from typing import Any

import torch.distributed as dist


class _Inert(tuple):
    """Stand-in for a pickled optax/JAX class: keeps its arguments."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)


class _CheckpointUnpickler(pickle.Unpickler):
    _stubs: dict = {}

    def find_class(self, module, name):
        root = module.split('.')[0]
        if root in ('optax', 'jax', 'jaxlib', 'waveflow_tpu'):
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


def save_state(path: str | Path, state: dict[str, Any]) -> None:
    """Write ``state`` to ``path`` atomically: ``<path>.tmp`` beside it,
    then a rename, so a reader never sees half a checkpoint (and ranks
    writing their own files into one directory never share a .tmp)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + '.tmp')
    with open(tmp, 'wb') as f:
        pickle.dump(state, f)
    tmp.replace(path)


def save_state_multihost(path: str | Path, state: dict[str, Any]) -> None:
    """``save_state`` on rank 0 of the process group (of a single process
    without one): the state is replicated, one copy is written.  Every rank
    calls it."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        save_state(path, state)


def load_state(path: str | Path) -> dict[str, Any] | None:
    """The state at ``path`` (written by either package), or None if there
    is none.  Only load files this project wrote: unpickling runs code."""
    path = Path(path)
    if not path.exists():
        return None
    with open(path, 'rb') as f:
        return _CheckpointUnpickler(f).load()
