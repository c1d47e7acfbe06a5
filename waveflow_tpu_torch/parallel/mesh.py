"""Process groups for walker parallelism, and the collectives over them.

Port of waveflow_tpu/parallel/mesh.py on ``torch.distributed``.  The JAX
package runs one process per host with several devices and names a mesh
axis; the port runs one process (rank) per device and names a process
group: ``WALKER_AXIS`` is the whole world, and ``make_host_chip_mesh``
names the two axes of a hosts × devices grid, ``'hosts'`` and ``'chips'``.
The collectives below take such a name, or a tuple of names, where JAX's
``pmean`` / ``psum`` / ``all_gather`` / ``axis_index`` / ``axis_size``
take a mesh axis inside ``shard_map``.

The names are bound to their groups by the mesh constructors, in this
module's table: process groups are process-wide in ``torch.distributed``,
and the table lives beside them.  ``destroy_walker_mesh`` unbinds the
names and ends the process group.

Every collective works on a detached copy of its input and returns a new
tensor.  No collective of the JAX package sits under a gradient (every
``pmean`` of gradients follows ``grad``, and the gathered local energies
are under ``stop_gradient``), so none of these needs an autograd rule.

Backends: NCCL for CUDA tensors, gloo for the CPU.  NCCL's collectives are
captured inside a CUDA graph like any kernel (vmc/graphs.py); gloo's
cannot be, so a trainer under gloo runs its windows eagerly
(``vmc/trainer.py::graph_windows``).  JAX's ``replicated`` and
``walker_sharded`` placements have no counterpart: a rank holds its own
walkers and a full copy of the parameters, and nothing places them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

WALKER_AXIS = "walkers"
HOST_CHIP_AXES = ("hosts", "chips")

# axis name -> its process group (dist.group.WORLD for the walker axis)
_GROUPS: dict = {}


def backend_for(device) -> str:
    """NCCL on a CUDA device, gloo on the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def local_device(device=None) -> torch.device:
    """The device of this rank: a CUDA device without an index is
    ``cuda:{LOCAL_RANK}`` (torchrun's variable; 0 without it)."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return dev


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> None:
    """Join the process group of a multi-process run: a no-op for a single
    process (no ``coordinator_address`` and at most one process) and when
    the group exists already, as JAX's ``jax.distributed.initialize``
    wrapper.  ``coordinator_address`` is ``host:port`` (or a ``tcp://``
    URL) of rank 0; ``backend`` defaults to ``backend_for(device)``."""
    if dist.is_initialized():
        return
    if not ((num_processes is not None and num_processes > 1)
            or coordinator_address):
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs coordinator_address, num_processes "
            "and process_id (torchrun's environment is read by "
            "make_walker_mesh when none is given)")
    dev = local_device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    url = (coordinator_address if '://' in coordinator_address
           else f'tcp://{coordinator_address}')
    dist.init_process_group(backend or backend_for(dev), init_method=url,
                            world_size=num_processes, rank=process_id)


def _ensure_world(device, backend: str | None) -> None:
    """The default process group: the one that exists, else torchrun's
    (its environment), else a world of one process on a local store.  A
    world of one still runs every collective through the backend."""
    if dist.is_initialized():
        return
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    backend = backend or backend_for(device)
    if 'WORLD_SIZE' in os.environ and 'MASTER_ADDR' in os.environ:
        dist.init_process_group(backend, init_method='env://')
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@dataclass(frozen=True)
class WalkerMesh:
    """The walker axis of a run: ``axis`` (a name or a tuple of names, as
    the collectives take it), ``shape`` (ranks along each name), this
    rank's index along the axis, its device and the backend."""
    axis: str | tuple
    shape: tuple
    rank: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_walker_mesh(device=None, axis_name: str = WALKER_AXIS,
                     backend: str | None = None) -> WalkerMesh:
    """The 1-D walker axis over every rank of the world (``_ensure_world``
    makes a world of one where there is none)."""
    dev = local_device(device)
    _ensure_world(dev, backend)
    _GROUPS[axis_name] = dist.group.WORLD
    return WalkerMesh(axis_name, (dist.get_world_size(),), dist.get_rank(),
                      dev, dist.get_backend())


def make_host_chip_mesh(axis_names=HOST_CHIP_AXES, device=None,
                        backend: str | None = None) -> WalkerMesh:
    """The 2-D hosts × chips axis: rank r is chip r mod local of host
    r div local, local = ``LOCAL_WORLD_SIZE`` (torchrun's variable; the
    whole world, one host, without it).  Walkers shard over both names,
    and a reduction over ``axis_names`` runs inside each host first
    (``psum``), the two-level reduction of JAX's host × chip mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = local_device(device)
    _ensure_world(dev, backend)
    world = dist.get_world_size()
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if local < 1 or world % local:
        raise ValueError(f"world {world} is not a whole number of hosts of "
                         f"{local} ranks")
    grid = init_device_mesh(dev.type, (world // local, local),
                            mesh_dim_names=tuple(axis_names))
    for name in axis_names:
        _GROUPS[name] = grid.get_group(name)
    axis = tuple(axis_names)
    return WalkerMesh(axis, (world // local, local), axis_index(axis), dev,
                      dist.get_backend())


def destroy_walker_mesh() -> None:
    """Unbind every axis name and end the process group.  Drop the CUDA
    graphs that captured its collectives first (a trainer's windows:
    ``_drop_graphs()``, or the trainer itself): over 4 ranks on NCCL the
    end of the group waited on them and did not return."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- collectives ------------------------------------------------------------

def _names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(name: str):
    try:
        return _GROUPS[name]
    except KeyError:
        raise ValueError(
            f"no process group is bound to the axis {name!r}: build it with "
            "make_walker_mesh or make_host_chip_mesh") from None


def check_axis(axis) -> None:
    """Raise ValueError unless every name of ``axis`` has a group."""
    for name in _names(axis):
        _group(name)


def axis_size(axis) -> int:
    """Ranks along ``axis`` (the product over a tuple of names)."""
    return math.prod(dist.get_world_size(_group(n)) for n in _names(axis))


def axis_index(axis) -> int:
    """This rank's index along ``axis``; a tuple counts in its order
    (('hosts', 'chips'): host × chips + chip)."""
    index = 0
    for name in _names(axis):
        g = _group(name)
        index = index * dist.get_world_size(g) + dist.get_rank(g)
    return index


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``; a tuple of names
    reduces over its last name first (('hosts', 'chips'): inside each host,
    then across hosts)."""
    out = x.detach().clone()
    for name in reversed(_names(axis)):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(name))
    return out


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """``psum(x, axis) / axis_size(axis)``, as ``jax.lax.pmean``: over one
    rank it is ``x`` itself, to the bit."""
    return psum(x, axis) / axis_size(axis)


def all_gather(x: torch.Tensor, axis, tiled: bool = True) -> torch.Tensor:
    """``x`` of every rank of ``axis`` in rank order, (hosts, chips) order
    for a tuple: concatenated along dim 0 (``tiled``) or stacked on a new
    leading dim, as ``jax.lax.all_gather``."""
    names = _names(axis)
    out = x.detach().contiguous()
    for name in reversed(names):
        g = _group(name)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, out, group=g)
        out = torch.stack(parts)
    out = out.reshape(-1, *x.shape)
    return out.reshape(-1, *x.shape[1:]) if tiled else out
