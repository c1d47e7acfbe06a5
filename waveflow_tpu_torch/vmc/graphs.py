"""Windows as replayed CUDA graphs: the port's counterpart of the JAX
package's jitted ``lax.scan`` windows.

The JAX package runs each training window, and each half of an evaluation,
as one compiled dispatch.  Eager PyTorch dispatches an epoch as thousands
of small launches, one Python call at a time, and the host sets the pace.
``EpochGraph`` captures one epoch (or one sweep, or one evaluation block)
of a body that reads and writes only static tensors — the parameters, the
optimizer state, the walkers, the baseline and an output slot — and
replays it:

  * the first call runs the body eagerly on a side stream: a real epoch,
    which also builds what is built lazily (Adam's moments, the kernels'
    libraries and their shared-memory limits, cached constants, cuBLAS's
    workspace for that stream) and launches every kernel at the shapes the
    capture will record; then it captures the body on the same stream.
    The capture runs nothing;
  * every later call replays the capture.

So n calls do the work of n eager epochs.  Random draws come from
generators registered with the graph (the default CUDA generator is
registered by the capture itself): a replay advances a generator's Philox
offset by what the epoch drew, as the eager epoch does, so ``get_state``,
``set_state`` and ``manual_seed`` between calls read and steer the stream
as they do eagerly.

The kernel wrappers (ops/cuda_*.py) count their launches in Python, and a
replay launches without passing through them: ``EpochGraph`` keeps what the
capture counted, puts the counters back (the capture launched nothing), and
adds that count on every replay (``ops.add_launches``).  A count that
must hold across replays of a caller's body lives on the device, and the
body adds to it.

A window states only its body and the static tensors it writes each epoch
(a loss, an accept rate, a row of block values): ``window(n)`` runs n
epochs and stacks those slots, eagerly (``Epochs``) or replayed
(``EpochGraph``); ``make_window`` picks one.

A failed capture or replay raises.  Nothing here falls back to eager
execution, and a graph needs a CUDA device (``use_graph``).
"""

from __future__ import annotations

import gc

import torch

from waveflow_tpu_torch import ops


def use_graph(graph: bool | None, device) -> bool:
    """A window's ``graph`` argument resolved on ``device``: None means
    True on a CUDA device and False on the CPU; True on the CPU raises
    ValueError."""
    device = torch.device(device)
    if graph is None:
        return device.type == 'cuda'
    if graph and device.type != 'cuda':
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    return bool(graph)


def check_leaves_free(leaves) -> None:
    """Raise RuntimeError if an autograd graph made outside a window still
    holds the grad accumulator of one of ``leaves`` (the tensors a body
    differentiates), as a loss kept from an eager forward does.  A capture
    whose backward met such an accumulator would wait on the stream it was
    made on, which CUDA refuses; once nothing holds it, the window's own
    forward makes it anew on the capture's stream.  The probe tags the
    accumulator, lets go of it and asks again: the tag survives only if
    something else held it."""
    with torch.enable_grad():
        for t in (t for t in leaves if t.requires_grad):
            t.view_as(t).grad_fn.next_functions[0][0].metadata['probe'] = 1
            acc = t.view_as(t).grad_fn.next_functions[0][0]
            if acc.metadata.pop('probe', None):
                raise RuntimeError(
                    "an autograd graph over the parameters is still alive "
                    "(a loss kept from an eager forward?): a CUDA graph "
                    "cannot capture a backward through it; drop it before "
                    "training graphed, or pass graph=False")


def copy_into(buffers, values) -> None:
    """Copy each of ``values`` into the static tensor beside it."""
    for buf, v in zip(buffers, values):
        buf.copy_(v)


class Epochs:
    """``body()`` run once per call, eagerly.  ``window(n)`` makes n calls
    and returns, for each of ``outputs`` (static tensors the body writes),
    its n values stacked on the device."""

    def __init__(self, body, outputs=()):
        self.body, self.outputs = body, tuple(outputs)

    def __call__(self) -> None:
        self.body()

    def window(self, n: int) -> list:
        rows = [torch.empty((n, *o.shape), dtype=o.dtype, device=o.device)
                for o in self.outputs]
        for e in range(n):
            self()
            for row, o in zip(rows, self.outputs):
                row[e] = o
        return rows


class EpochGraph(Epochs):
    """``body()`` run once eagerly, then captured, then replayed: one call
    per epoch.  ``generators`` are the CUDA generators the body draws
    from."""

    def __init__(self, body, outputs=(), generators=()):
        super().__init__(body, outputs)
        self.generators = tuple(generators)
        self.graph = None
        self.launches = None      # kernel launches per replay
        self.stream = None

    def __call__(self) -> None:
        if self.graph is None:
            self._warm_up()
            self.graph, self.launches = self._capture()
        else:
            self.graph.replay()
            ops.add_launches(self.launches)

    def reset(self) -> None:
        """Drop the capture: the next call warms up and captures again
        (after the body's tensors were swapped for others)."""
        self.graph = self.launches = None

    # what touches the card, apart from replay
    def new_graph(self):
        return torch.cuda.CUDAGraph()

    def capturing(self, graph):
        return torch.cuda.graph(graph, stream=self.stream)

    def _warm_up(self) -> None:
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self.body()
        torch.cuda.current_stream().wait_stream(self.stream)

    def _capture(self):
        """(the captured graph, the kernel launches it holds).

        Python's cyclic collector must not run inside a capture: it may
        destroy a window dropped earlier (a trainer, its graph and its
        memory pool, held in reference cycles) in the middle of it, and
        CUDA then invalidates the capture ("operation failed due to a
        previous error during capture").  torch's ``graph`` context no
        longer collects first, so the capture collects, then holds the
        collector off."""
        graph = self.new_graph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = ops.read_launches()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with self.capturing(graph):
                self.body()
        finally:
            if was_enabled:
                gc.enable()
        counted = tuple(a - b for a, b in zip(ops.read_launches(), before))
        ops.set_launches(before)
        return graph, counted


def make_window(body, outputs=(), generators=(), graph: bool = False):
    """``body`` as a window: replayed as a CUDA graph (``EpochGraph``) when
    ``graph``, else eager (``Epochs``)."""
    if graph:
        return EpochGraph(body, outputs, generators)
    return Epochs(body, outputs)
