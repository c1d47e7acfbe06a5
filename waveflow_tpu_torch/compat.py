"""Reference-API compatibility layer.

Port of waveflow_tpu/compat.py: the entry points of the original
``aspuru-guzik-group/waveflow`` package, with its signatures and return
conventions, on the port's modules and kernels.

Covered surfaces:
  * waveflow.splines.{MSpline_fun, ISpline_fun, BSpline_fun}: the spline
    ``init_fun`` factories.  ``apply_fun_vec`` and ``apply_fun_vec_grad``
    are one table evaluation (kernel K4 on the card, orders 0 and 1),
    ``reverse_fun_vec`` the exact table inverse, ``sample_fun_vec`` one
    fused inverse-CDF draw over all rows × samples (K2 for 'M', K1 for
    'B');
  * waveflow.vqmc.ModelTrainer (the VMC trainer);
  * waveflow.benchmark_tests.{get_dataset, get_model, train_model};
  * the flows / bijections / model-factory names, re-exported 1:1.

The port's idiom where the reference passes PRNG keys: an int seed or a
``torch.Generator``.  Every entry point runs on ``cuda`` unless given
``device='cpu'``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops import (
    batched_monotone_inverse, get_tables, make_bias_remover,
    make_boundary_projector, make_evaluator, sample_linear_density,
    sample_squared_amplitude,
)

# --- bijections / models / factory: same names as the reference -----------
from waveflow_tpu_torch.bijections import (                 # noqa: F401
    ActNorm, AffineCoupling, AffineCouplingSplit, BatchNorm, BoxTransformLayer,
    FixedInvertibleLinear, IMADE, Invert, InvertibleLinear, Logit, MADE,
    NeuralSplineCoupling, Reverse, Serial, Shuffle, Sigmoid,
)
from waveflow_tpu_torch.models import (                     # noqa: F401
    Flow, GMM, InvFlow, MFlow, Normal, Uniform, Waveflow, get_waveflow_model,
)
from waveflow_tpu_torch.bijections.masks import (
    masked_conditioner, simple_masked_transform,
)


def get_masked_transform(return_simple_masked_transform=False,
                         allow_negative_params=False):
    """The reference's ``model_factory.get_masked_transform``: the affine
    MADE's plain masked network, or the spline conditioner."""
    if return_simple_masked_transform:
        return simple_masked_transform()
    return masked_conditioner(allow_negative_params=allow_negative_params)


def _generator(rng, device) -> torch.Generator:
    """``rng`` as a torch.Generator: itself, or a new one on ``device``
    seeded with the int ``rng``."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device).manual_seed(int(rng))


# --- spline init_fun factories (the reference's spline interface) ----------

def _spline_init(kind):
    def factory():
        def init_fun(rng, k, n_internal_knots, cardinal_splines=True,
                     zero_border=False, reverse_fun_tol=1e-6,
                     use_cached_bases=True, cached_bases_path_root=None,
                     n_mesh_points=1000, constraints_dict_left=None,
                     constraints_dict_right=None, *, device=None):
            """The reference's tuple for ``kind``: 'I' (initial,
            apply_fun_vec, apply_fun_vec_grad, reverse_fun_vec, knots,
            enforce, remove_bias), 'M' the same with sample_fun_vec in
            place of reverse_fun_vec, 'B' the 'M' tuple without
            remove_bias.  ``rng`` (an int seed or a torch.Generator) draws
            ``initial``."""
            del cardinal_splines, reverse_fun_tol, use_cached_bases
            del cached_bases_path_root
            device = resolve_device(device)
            if constraints_dict_left is None:
                constraints_dict_left = {0: 0.0}
            if constraints_dict_right is None:
                constraints_dict_right = {0: 1.0} if kind == 'I' else {0: 0.0}

            tabs = get_tables(kind, k, n_internal_knots, n_mesh=n_mesh_points)
            use_ob = kind == 'B'
            ev = make_evaluator(tabs, use_ob=False, device=device)
            ev_eval = (make_evaluator(tabs, use_ob=True, device=device)
                       if use_ob else ev)
            project = make_boundary_projector(
                ev, constraints_dict_left, constraints_dict_right,
                normalization='l2' if kind == 'B' else 'sum',
                ispline_right_convention=(kind == 'I'))

            n_b = ev.n_bases
            n_params = n_b - 2 if zero_border else n_b
            gen = _generator(rng, 'cpu')
            initial = torch.rand((n_params,), generator=gen,
                                 device=gen.device)
            if kind == 'B':
                initial = 2 * initial - 1
                initial = initial / torch.sqrt(torch.sum(initial ** 2))
            else:
                initial = initial / torch.sum(initial)
            initial = initial.to(device)

            ob_to_b = (torch.as_tensor(tabs.ob_to_b, device=device)
                       if use_ob else None)

            def full_params(p):
                if zero_border:
                    z = torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype,
                                    device=p.device)
                    return torch.cat([z, p, z], dim=-1)
                return p

            def eval_coeffs(p):
                p = full_params(p)
                if kind == 'B':
                    c = p @ ob_to_b
                    return c / torch.sqrt(torch.sum(c ** 2, dim=-1,
                                                    keepdim=True))
                return p

            def apply_fun_vec(params, x):
                return ev_eval(eval_coeffs(params), x)

            def apply_fun_vec_grad(params, x):
                return ev_eval(eval_coeffs(params), x, d=1)

            knots = torch.as_tensor(tabs.knots, dtype=torch.float32,
                                    device=device)

            if kind == 'I':
                def reverse_fun_vec(params, y):
                    return batched_monotone_inverse(ev, full_params(params), y)
                remove_bias = make_bias_remover(n_b, k, 'I', device=device)
                return (initial, apply_fun_vec, apply_fun_vec_grad,
                        reverse_fun_vec, knots, project, remove_bias)

            if kind == 'M':
                def draw(cc, uu):
                    return sample_linear_density(ev, cc, uu)
                coeffs_of = full_params
            else:
                def draw(cc, uu):
                    return sample_squared_amplitude(ev_eval, cc, uu)
                coeffs_of = eval_coeffs

            def sample_from_uniforms(params, u):
                """The draws of ``sample_fun_vec`` from explicit uniforms u
                (B, num_samples): one fused launch over all B·num_samples
                draws, row-major (row b's draws contiguous)."""
                c = coeffs_of(params)
                if c.ndim == 1:
                    c = c.expand(u.shape[0], c.shape[-1])
                cc = torch.repeat_interleave(c, u.shape[1], dim=0)
                return draw(cc, u.reshape(-1)).reshape(u.shape)

            def sample_fun_vec(rng, params, num_samples):
                """``num_samples`` draws per row of ``params`` (B, n), or B
                = 1 for one row (n,): (B, num_samples), the uniforms drawn
                from ``rng`` (an int seed or a torch.Generator) where the
                reference takes one key per row."""
                B = params.shape[0] if params.ndim == 2 else 1
                u = torch.rand((B, num_samples),
                               generator=_generator(rng, params.device),
                               device=params.device)
                return sample_from_uniforms(params, u)

            sample_fun_vec._from_uniforms = sample_from_uniforms
            if kind == 'M':
                remove_bias = make_bias_remover(n_b, k, 'M', device=device)
                return (initial, apply_fun_vec, apply_fun_vec_grad,
                        sample_fun_vec, knots, project, remove_bias)
            return (initial, apply_fun_vec, apply_fun_vec_grad,
                    sample_fun_vec, knots, project)

        return init_fun

    return factory


MSpline_fun = _spline_init('M')
ISpline_fun = _spline_init('I')
BSpline_fun = _spline_init('B')


# --- trainer ---------------------------------------------------------------

class ModelTrainer:
    """The reference's ``vqmc.ModelTrainer``: attribute pokes like
    ``trainer.num_knots = 23`` keep working because the config is built
    at ``start_training()``.  ``device`` is the port's one addition."""

    def __init__(self, system_name='He', learning_rate=1e-4, box_length=10,
                 num_epochs=200000, batch_size=128, log_every=2000, *,
                 device='cuda'):
        self.system_name = system_name
        self.learning_rate = learning_rate
        self.box_length = box_length
        self.num_epochs = num_epochs
        self.batch_size = batch_size
        self.log_every = log_every
        self.n_space_dimension = 1
        self.xu_coord_type = 'mean'
        self.spline_degree = 6
        self.num_knots = 23
        self.n_flow_layer = 3
        self.window = 100
        self.save_dir = None
        self.device = device

    def config(self):
        """The VMCConfig of the attributes as they stand, field for field
        as the JAX package builds it (``n_space_dimension`` is not passed
        there either)."""
        from waveflow_tpu_torch.vmc import VMCConfig
        return VMCConfig(
            system_name=self.system_name,
            learning_rate=self.learning_rate,
            box_length=self.box_length, num_epochs=self.num_epochs,
            batch_size=self.batch_size, log_every=self.log_every,
            xu_coord_type=self.xu_coord_type,
            spline_degree=self.spline_degree, num_knots=self.num_knots,
            n_flow_layers=self.n_flow_layer, window=self.window,
            save_dir=self.save_dir, device=self.device)

    def start_training(self, restart=False):
        """Train ``num_epochs`` epochs; returns the per-epoch losses."""
        from waveflow_tpu_torch.vmc import VMCTrainer
        return VMCTrainer(self.config()).train(restart=restart)


# --- benchmark trainer (benchmark_tests.py) ---------------------------------

def get_dataset(dataset_name, n_samples, margin, rng=None):
    """The reference's ``benchmark_tests.get_dataset``, on
    ``benchmark.get_dataset``.  The seed is the last element of an
    array-like key, an int itself, or 0 for None."""
    from waveflow_tpu_torch.benchmark import get_dataset as _get
    seed = 0 if rng is None else int(np.asarray(rng).reshape(-1)[-1])
    return _get(dataset_name, n_samples=n_samples, margin=margin, seed=seed)


class _Method(nn.Module):
    """One method of ``model`` as a forward, so that ``functional_call``
    runs it under the given parameters (keys prefixed ``model.``)."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def _functional(model):
    """(params, log_pdf, sample) of a density module: its state as a dict
    of tensors, and its two methods under any such dict."""
    log_pdf_m, sample_m = _Method(model, 'log_pdf'), _Method(model, 'sample')

    def prefixed(params):
        return {f'model.{k}': v for k, v in params.items()}

    def log_pdf(params, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
        return functional_call(log_pdf_m, prefixed(params), (x,))

    def sample(rng, params, num_samples):
        return functional_call(sample_m, prefixed(params), (num_samples,),
                               {'generator': _generator(rng, model.device)})

    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return params, log_pdf, sample


def get_model(model_type, spline_reg, spline_degree=3, num_knots=15,
              num_layers=5, reverse_tol=1e-6, prior_spline_degree=3,
              prior_num_knots=15, *, device=None):
    """The reference's ``benchmark_tests.get_model``: an ``init_fun(rng,
    input_dim) -> (params, log_pdf, sample)`` over the port's benchmark
    model ('Flow', 'IFlow' or 'MFlow').  ``rng`` (an int seed or a CPU
    torch.Generator) draws the weights; ``params`` is a dict of tensors,
    ``log_pdf(params, x)`` and ``sample(rng, params, n)`` run the model
    under any such dict (``torch.func.functional_call``)."""
    from waveflow_tpu_torch.benchmark.density import get_benchmark_model
    del reverse_tol
    if model_type not in ('Flow', 'IFlow', 'MFlow'):
        raise ValueError(f"unknown model type {model_type!r}")
    device = resolve_device(device)

    def init_fun(rng, input_dim):
        model = get_benchmark_model(
            model_type, spline_reg=spline_reg, n_flow_layers=num_layers,
            spline_degree=spline_degree, n_knots=num_knots,
            prior_spline_degree=prior_spline_degree,
            prior_n_knots=prior_num_knots, input_dim=input_dim,
            generator=_generator(rng, 'cpu'), device=device)
        return _functional(model)

    return init_fun


def train_model(target, num_epochs, n_model_sample, model_type='IFlow',
                dataset_name='halfmoon', check_step=5000, spline_reg=0.1,
                input_dim=2, save_dir="./results/benchmarks/", ngrid=300,
                num_flow_layer=3, spline_degree=5, num_knots=23,
                prior_spline_degree=3, prior_num_knots=15, *, device=None):
    """The reference's ``benchmark_tests.train_model``, with its positional
    and keyword signature (an unknown keyword raises TypeError) and its
    save-dir naming scheme: MLE training by ``train_density_model`` with a
    metric checkpoint every ``check_step`` epochs, writing the reference's
    files (losses.txt, kl_divergences.txt, ...).  Returns (params, log_pdf,
    sample) as ``get_model``'s init_fun does."""
    from waveflow_tpu_torch.benchmark.density import train_density_model
    del input_dim, ngrid    # fixed by the data and the metric grid here
    if model_type == 'Flow':
        data_save_dir = f"{save_dir}/{dataset_name}/{model_type}_{num_flow_layer}"
    else:
        data_save_dir = (f"{save_dir}/{dataset_name}/{model_type}_{spline_reg}"
                         f"_{num_flow_layer}_{spline_degree}_{num_knots}")
    model, _hist = train_density_model(
        target, model_name=model_type, num_epochs=num_epochs,
        spline_reg=spline_reg, n_flow_layers=num_flow_layer,
        spline_degree=spline_degree, n_knots=num_knots,
        log_every=check_step, save_dir=data_save_dir,
        n_model_sample=n_model_sample,
        prior_spline_degree=prior_spline_degree,
        prior_n_knots=prior_num_knots, device=device)
    return _functional(model)
