"""Carry JAX parameters and checkpoints across to the PyTorch port.

``params_from_jax`` (Waveflow), ``mflow_params_from_jax`` (MFlow),
``flow_params_from_jax`` (Flow / IFlow) and ``module_state_from_jax`` (any
tree of the bijections: RQSFlow's couplings, the core combinators) map a
JAX params pytree (numpy arrays) onto the state-dict names of the port's
module trees (models/factory.py, benchmark/density.py):

    JAX                                       port
    transform_params[i], IMADE layer
        = (((W,b)...), zero)                  transform.layers.i.conditioner.*
    transform_params[i], affine MADE layer
        = ((W,b)...)                          transform.layers.i.transform.*
    sp_params = (((W,b)...), zero)            conditioner.*

with dense weights kept in the JAX (fan_in, fan_out) layout.  Waveflow and
MFlow params are the pair ``(transform_params, sp_params)``; Flow params
are ``transform_params`` alone (its priors have none).  The antisymmetrized
Waveflow's parameters are its φ's, under φ's names (models/antisym.py), so
``params_from_jax`` loads a JAX antisym run as it loads a Waveflow.
``params_to_jax`` is the way back: a port Waveflow's parameters as the
JAX pytree, so that the JAX package can evaluate weights the port trained.
``load_jax_checkpoint`` reads a checkpoint pickle written by the JAX
trainer without JAX or optax installed; ``adam_state_from_jax`` and
``mcmc_state_from_jax`` carry its optimizer moments and Metropolis or MALA
walkers across; ``ravel_order`` (``ravel_layout`` for a module) gives the
flat parameter layout of its natural-gradient states and of the parameter
posterior (vmc/hmc.py).  Its PRNG key is not carried: the two packages'
generators differ.
"""

from __future__ import annotations

import numpy as np
import torch

from waveflow_tpu_torch.bijections.masks import MaskedMLP
from waveflow_tpu_torch.utils.checkpoint import load_state


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


def module_state_from_jax(module, params, prefix: str = '') -> dict:
    """The JAX params of one layer protocol tree (``Serial`` of any of the
    bijections, or one bijection) -> state-dict entries of the port's
    module of the same structure: ActNorm (log_weight, bias), BatchNorm
    (log_weight, bias, mean, var), InvertibleLinear (L, U, S),
    AffineCoupling (its network's params), AffineCouplingSplit (scale's,
    translate's), NeuralSplineCoupling and MADE ((W, b) per layer), IMADE
    (its conditioner), Invert (the inner layer's), and none for the
    parameter-free layers.  A network the port builds from another module
    takes the JAX leaves in the order of its parameters."""
    from waveflow_tpu_torch import bijections as bj
    if isinstance(module, bj.Serial):
        out = {}
        for i, (layer, p) in enumerate(zip(module.layers, params)):
            out.update(module_state_from_jax(layer, p, f'{prefix}layers.{i}.'))
        return out
    if isinstance(module, bj.Invert):
        return module_state_from_jax(module.layer, params, f'{prefix}layer.')
    names = {bj.ActNorm: ('log_weight', 'bias'),
             bj.BatchNorm: ('log_weight', 'bias', 'mean', 'var'),
             bj.InvertibleLinear: ('L', 'U', 'S')}.get(type(module))
    if names is not None:
        return {f'{prefix}{n}': _tensor(a) for n, a in zip(names, params)}
    if isinstance(module, bj.AffineCouplingSplit):
        s_params, t_params = params
        return {**_network_entries(module.scale, s_params, f'{prefix}scale.'),
                **_network_entries(module.translate, t_params,
                                   f'{prefix}translate.')}
    if isinstance(module, bj.AffineCoupling):
        return _network_entries(module.transform, params,
                                f'{prefix}transform.')
    if isinstance(module, bj.NeuralSplineCoupling):
        return _mlp_entries(prefix, params)
    if isinstance(module, bj.MADE):
        return _mlp_entries(f'{prefix}transform.', params)
    if isinstance(module, bj.IMADE):
        return _conditioner_entries(f'{prefix}conditioner.', params)
    return {}


def _network_entries(net, params, prefix: str) -> dict:
    if isinstance(net, (MaskedMLP,)):
        return _mlp_entries(prefix, params)
    leaves = _leaves(params)
    names = [n for n, _ in net.named_parameters()]
    if len(names) != len(leaves):
        raise ValueError(f"{type(net).__name__} has {len(names)} parameters, "
                         f"the JAX network {len(leaves)} leaves")
    return {f'{prefix}{n}': _tensor(a) for n, a in zip(names, leaves)}


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def params_from_jax(tree) -> dict:
    """JAX Waveflow params -> a state dict for ``Waveflow.load_state_dict``."""
    transform_params, prior_params = tree
    state = flow_params_from_jax(transform_params)
    state.update(_conditioner_entries('conditioner.', prior_params))
    return state


# MFlow params have the Waveflow layout: (transform_params, sp_params)
mflow_params_from_jax = params_from_jax


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, np.float32)


def _mlp_tree(state: dict, prefix: str) -> list:
    n = sum(1 for name in state if name.startswith(f'{prefix}W.'))
    return [(_array(state[f'{prefix}W.{k}']), _array(state[f'{prefix}b.{k}']))
            for k in range(n)]


def params_to_jax(source, n_layers: int | None = None):
    """The inverse of ``params_from_jax``: a Waveflow's (or MFlow's)
    parameters as the JAX package's pytree, ``(transform_params,
    (mlp, zero_params))`` of numpy float32 arrays in JAX's containers: a
    list of layers, ``()`` for a layer without parameters, an IMADE
    layer's conditioner ``(mlp, zero_params)`` with ``mlp`` a list of
    ``(W, b)``, an affine MADE layer a tuple of ``(W, b)``.

    ``source`` is the module (its ``transform.layers`` give the layer
    count) or a state dict (a module's, or a port checkpoint's
    ``params``); for a state dict the count is ``n_layers``, by default
    the factory's layout, BoxTransform then (IMADE, Reverse) per flow
    layer.  Imports no JAX: the JAX side reads the tree as it reads its
    own checkpoints."""
    if isinstance(source, torch.nn.Module):
        n_layers = len(source.transform.layers)
        source = source.state_dict()
    state = dict(source)
    indices = {int(name.split('.')[2]) for name in state
               if name.startswith('transform.layers.')}
    if n_layers is None:
        n_layers = 2 * len(indices) + 1
    layers = []
    for i in range(n_layers):
        prefix = f'transform.layers.{i}.'
        if f'{prefix}conditioner.zero_params' in state:
            layers.append((_mlp_tree(state, f'{prefix}conditioner.mlp.'),
                           _array(state[f'{prefix}conditioner.zero_params'])))
        elif f'{prefix}transform.W.0' in state:
            layers.append(tuple(_mlp_tree(state, f'{prefix}transform.')))
        else:
            layers.append(())
    if indices - set(range(n_layers)):
        raise ValueError(f"layers {sorted(indices - set(range(n_layers)))} "
                         f"lie past n_layers={n_layers}")
    prior = (_mlp_tree(state, 'conditioner.mlp.'),
             _array(state['conditioner.zero_params']))
    return (layers, prior)


def load_jax_checkpoint(path) -> dict:
    """Read a JAX trainer checkpoint (a pickle of numpy arrays whose
    optimizer state references optax classes).  Returns {'params': pytree
    of numpy arrays, 'epoch': int, 'opt_state': the optax state as nested
    tuples, 'mcmc_state': tuple of numpy arrays or None}.  The PRNG key is
    dropped: a run resumed in the port continues on the port's own stream."""
    state = load_state(path)
    if state is None:
        raise FileNotFoundError(path)
    mcmc = state.get('mcmc_state')
    return {'params': state['params'], 'epoch': int(state['epoch']),
            'opt_state': state.get('opt_state'),
            'mcmc_state': (None if mcmc is None
                           else tuple(np.asarray(f) for f in mcmc))}


def _find_adam_state(tree):
    """The ScaleByAdamState node of an optax state tree, or None."""
    if type(tree).__name__ == 'ScaleByAdamState':
        return tree
    if isinstance(tree, tuple):
        for node in tree:
            found = _find_adam_state(node)
            if found is not None:
                return found
    return None


def ravel_order(names) -> list:
    """State-dict names in JAX ``ravel_pytree`` order — tree-leaf order,
    the order ``params_from_jax`` writes: the transform layers by index,
    then the prior's conditioner; inside a conditioner the MLP's (W, b)
    pairs by layer, then ``zero_params``.  The natural-gradient steps lay
    their flat parameter vector out in this order (vmc/sr.py), so that a
    JAX SPRING state lands on the right parameters."""
    def key(name):
        parts = name.split('.')
        head = (0, int(parts[2])) if parts[0] == 'transform' else (1, 0)
        if parts[-1] == 'zero_params':
            return head + (1, 0, 0)
        return head + (0, int(parts[-1]), 0 if parts[-2] == 'W' else 1)
    return sorted(names, key=key)


def ravel_layout(model) -> tuple:
    """(names, parameters) of a module in flat order: a flow's (its names
    under ``transform`` and ``conditioner``) in JAX ``ravel_pytree`` order
    (``ravel_order``), any other module's in its own order."""
    named = dict(model.named_parameters())
    names = list(named)
    if all(n.split('.')[0] in ('transform', 'conditioner') for n in names):
        names = ravel_order(names)
    return names, [named[n] for n in names]


def adam_state_from_jax(opt_state, params_tree, named_parameters,
                        capturable: bool = False) -> dict:
    """The JAX trainer's flat Adam moments as ``torch.optim.Adam`` state.

    ``opt_state`` is ``optax.flatten(chain(clip_by_global_norm, adam))``'s
    state (or ``optax.flatten(adam)``'s): one ``ScaleByAdamState(count, mu,
    nu)`` whose moments are single vectors in ``ravel_pytree`` order —
    tree-leaf order, each leaf C-raveled, the order ``params_from_jax``
    walks.  Returns {parameter name: {'step', 'exp_avg', 'exp_avg_sq'}} for
    every entry of ``named_parameters`` ((name, tensor) pairs), on each
    tensor's device.  step = count: optax corrects the bias with count + 1
    after its update, torch with step after its increment; it is a float32
    host tensor, or with ``capturable`` (the form of a capturable Adam,
    whose count lives on the card) a float32 tensor on the parameter's
    device.  Raises ValueError when the moments are not flat vectors of
    the parameter count (a checkpoint from before the flatten change)."""
    adam = _find_adam_state(opt_state)
    named = dict(named_parameters)
    leaves = params_from_jax(params_tree)
    n_params = sum(v.numel() for v in leaves.values())
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    count, mu, nu = adam
    if not (isinstance(mu, np.ndarray) and mu.shape == (n_params,)):
        raise ValueError(
            "the Adam moments are not one flat vector of the "
            f"{n_params} parameters (a pre-flatten checkpoint?)")
    if set(leaves) != set(named):
        raise ValueError(
            f"parameter names differ: {sorted(set(leaves) ^ set(named))}")
    out, at = {}, 0
    for name, leaf in leaves.items():
        p, n = named[name], leaf.numel()
        moments = [torch.as_tensor(np.array(m[at:at + n], np.float32))
                   .reshape(leaf.shape).to(p.device) for m in (mu, nu)]
        step = torch.tensor(float(count), dtype=torch.float32,
                            device=p.device if capturable else None)
        out[name] = {'step': step,
                     'exp_avg': moments[0], 'exp_avg_sq': moments[1]}
        at += n
    return out


def mcmc_state_from_jax(fields, device=None):
    """A JAX ``MetropolisState`` (positions (B, D), log_prob (B,),
    step_size (), accept_rate ()) or ``MALAState`` (positions, log_prob,
    grad (B, D), step_size, accept_rate) as the port's, on ``device`` —
    told apart by the number of fields, as the JAX trainer does."""
    from waveflow_tpu_torch.vmc.mala import MALAState
    from waveflow_tpu_torch.vmc.metropolis import MetropolisState
    kind = MALAState if len(fields) == len(MALAState._fields) \
        else MetropolisState
    if len(fields) != len(kind._fields):
        raise ValueError(f"an MCMC state of {len(fields)} fields is neither "
                         "a MetropolisState nor a MALAState")
    return kind(*(torch.as_tensor(np.array(f, np.float32), device=device)
                  for f in fields))
