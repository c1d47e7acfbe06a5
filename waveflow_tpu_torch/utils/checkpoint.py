"""Checkpoint files: an atomic pickle of plain numpy state.

Port of waveflow_tpu/utils/checkpoint.py (``save_state`` / ``load_state``,
``save_state_multihost``, where rank 0 of a process group writes, and
``OrbaxCheckpointer``'s versioned steps on the same pickle files).
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


class OrbaxCheckpointer:
    """Versioned checkpoints of a state under ``directory``: one file per
    step (``<step>.pkl``, written by ``save_state``), the ``max_to_keep``
    latest kept (None keeps every step).

    The JAX package's class of this name (``utils/checkpoint.py``) keeps
    its steps with orbax, which the port does not use: the name, the
    methods and orbax's rules carry across (a step at or below the latest
    is not saved; ``restore()`` reads the latest, None when there is
    none), the storage does not, so this class cannot read a directory
    that orbax wrote.  ``latest_step`` and ``all_steps`` are what JAX
    reaches through ``.manager``."""

    SUFFIX = '.pkl'

    def __init__(self, directory: str | Path, max_to_keep: int | None = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f'{step}{self.SUFFIX}'

    def all_steps(self) -> list[int]:
        """The saved steps, ascending."""
        return sorted(int(p.stem) for p in self.directory.glob(
            f'*{self.SUFFIX}') if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict[str, Any]) -> bool:
        """Write ``state`` as ``step`` and drop the steps beyond
        ``max_to_keep``; False (nothing written) when ``step`` is not
        above the latest saved step, as orbax's manager does."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        save_state(self._path(step), state)
        steps = self.all_steps()
        if self.max_to_keep is not None:
            for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                self._path(old).unlink()
        return True

    def restore(self, step: int | None = None):
        """The state saved as ``step`` (default: the latest), None when no
        step is saved; FileNotFoundError for a step that is not."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = load_state(self._path(step))
        if state is None:
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.directory}")
        return state

    def close(self) -> None:
        """Nothing is left open: every save is complete when it returns."""
