"""Parity of the port's last utility modules with the JAX package's, on
the CPU: the evaluation artifacts and the trainer's ``save_artifacts``
(vmc/artifacts.py), the versioned checkpointer (utils/checkpoint.py::
OrbaxCheckpointer), profiling (utils/profiling.py), the figures
(utils/figures.py), the reference names ``antisymmetrize_model`` and
``BoxTransformLayer``, and examples/exact_reference_torch.py.

The flagship 100k checkpoint crosses to the port by convert.py; both
packages' artifacts are drawn from one fixed sample stub.  On CPU tensors
every kernel wrapper runs its plain PyTorch version.
"""

import importlib.util
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.utils import checkpoint as jcheckpoint
from waveflow_tpu.utils import figures as jfigures
from waveflow_tpu.vmc import artifacts as jartifacts
from waveflow_tpu_torch.bijections import BoxTransform, BoxTransformLayer
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import (
    antisymmetrize_model, get_antisym_waveflow_model, get_waveflow_model,
)
from waveflow_tpu_torch.physics import system_catalogue
from waveflow_tpu_torch.utils import (
    OrbaxCheckpointer, enable_persistent_compilation_cache, figures,
    profiling, time_fn, trace,
)
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, artifacts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / 'results' / 'r5_flagship_fwd_batched_100k' / 'checkpoints'
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
# a small trainer, two windows with a checkpoint (and artifacts) after each
SMALL_RUN = dict(system_name='He', box_length=5.0, batch_size=16, window=3,
                 log_every=3, seed=5, spline_degree=4, num_knots=8,
                 n_flow_layers=1, n_spline_base_mesh_points=300,
                 device='cpu')


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Stub:
    """A model whose ``sample`` hands out fixed rows: the port's side of
    the one sample stub both packages' artifacts are drawn from."""

    def __init__(self, model, rows):
        self.psi, self.device, self.rows = model.psi, model.device, rows

    def sample(self, n, generator=None):
        return torch.as_tensor(self.rows[:n])


@pytest.fixture(scope='module')
def flagship():
    """(JAX params, JAX psi, the port's 'poly_pallas' model) on the 100k
    checkpoint."""
    with open(CHECKPOINT, 'rb') as f:
        jparams = pickle.load(f)['params']
    _, jpsi, _, _ = jget_waveflow_model(2, **FLAGSHIP)(jax.random.PRNGKey(0),
                                                       2)
    m = get_waveflow_model(2, **FLAGSHIP, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jparams))
    return jparams, jax.jit(jpsi), m


def _listing(root: Path) -> dict:
    return {str(p.relative_to(root)): np.load(p)
            for p in sorted(root.rglob('*.npy'))}


def test_artifacts_equal_jax(flagship, tmp_path):
    """save_wavefunction_artifacts of both packages on the 100k checkpoint
    (ngrid 30, 40 draws), from one fixed sample stub: the same files, the
    same shapes and dtypes, coordinates equal, ψ values within rtol 1e-5 /
    atol ARTIFACTS_PSI_RTOL × max|ψ| (two f32 orderings of ψ: JAX's and
    the port's read 9.7e-6 × max|ψ| apart at two grid points, the port's
    3.8e-6 from float64).  The grid's two corners x = (±L, ∓L), both
    electrons at opposite walls, are NaN in JAX and 0 in the port."""
    jparams, jpsi, m = flagship
    rows = np.random.default_rng(3).uniform(-10, 10, (40, 2)).astype(
        np.float32)
    protons = system_catalogue[1]['He'][0]
    kw = dict(epoch=7, box_length=10.0, n_particle=2, protons=protons,
              ngrid=30, nsample=40)
    jartifacts.save_wavefunction_artifacts(
        str(tmp_path / 'jax'), jpsi, lambda rng, p, n: jnp.asarray(rows[:n]),
        jparams, rng=jax.random.PRNGKey(0), **kw)
    artifacts.save_wavefunction_artifacts(
        str(tmp_path / 'port'), _Stub(m, rows), generator=None, **kw)
    ref, got = _listing(tmp_path / 'jax'), _listing(tmp_path / 'port')
    assert sorted(got) == sorted(ref) == [
        'outputs/density_1e/onproton_coord_epoch7.npy',
        'outputs/density_1e/onproton_values_epoch7.npy',
        'outputs/density_1e/random_coord_epoch7.npy',
        'outputs/density_1e/random_values_epoch7.npy',
        'outputs/sample_points/values_epoch7.npy',
        'outputs/wavefunctions_2d/values_epoch7.npy']
    grid = 'outputs/wavefunctions_2d/values_epoch7.npy'
    walls = np.isnan(ref[grid])
    assert np.flatnonzero(walls).tolist() == [29, 870]
    assert (got[grid][walls] == 0).all()
    ref[grid][walls] = 0.0
    scale = np.abs(ref[grid]).max()
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == r.dtype, name
        np.testing.assert_allclose(
            g, r, rtol=1e-5, atol=_chip_smoke().ARTIFACTS_PSI_RTOL * scale,
            err_msg=name)


def test_eval_psi_antisymmetrized(flagship):
    """ψ_A(x) = sign(sort) ψ(sorted x): antisymmetric under the exchange
    of the two coordinates, and ψ itself on the sorted sector."""
    m = flagship[2]
    x = torch.as_tensor(np.random.default_rng(1).uniform(-9, 9, (64, 2)),
                        dtype=torch.float32)
    with torch.no_grad():
        a = artifacts.eval_psi_antisymmetrized(m.psi, x)
        b = artifacts.eval_psi_antisymmetrized(m.psi, x.flip(-1))
        s = m.psi(torch.sort(x, -1).values).numpy()
    np.testing.assert_array_equal(a, -b)
    np.testing.assert_array_equal(np.abs(a), np.abs(s))


def test_artifacts_psi_f32_against_float64(flagship):
    """The float64 run behind chip_smoke's ARTIFACTS_PSI_RTOL: the f32 ψ of
    the 100k checkpoint on the artifacts' grid (100², 10,000 points) and
    on both density slices against the same model in float64, as a share
    of max|ψ|, within half the tolerance (so the kernel and the plain core
    on the card, each within it of float64, agree to the tolerance).
    Prints the error."""
    m = flagship[2]
    rtol = _chip_smoke().ARTIFACTS_PSI_RTOL
    line = np.linspace(-10.0, 10.0, 100)
    X, Y = np.meshgrid(line, line)
    anchor = m.sample(1, generator=torch.Generator().manual_seed(2)).numpy()
    slices = [np.stack([X, Y], -1).reshape(-1, 2),
              np.column_stack([line, np.full(100, anchor[0, 1])]),
              np.column_stack([line, np.zeros(100)])]
    x = torch.as_tensor(np.concatenate(slices), dtype=torch.float32)
    with torch.no_grad():
        f32 = torch.as_tensor(artifacts.eval_psi_antisymmetrized(m.psi, x))
        m.double()
        try:
            f64 = torch.as_tensor(artifacts.eval_psi_antisymmetrized(
                m.psi, x.double()))
        finally:
            m.float()
    err = ((f32.double() - f64).abs().max() / f64.abs().max()).item()
    print(f"artifact psi, f32 against float64: {err:.3e} of max|psi| "
          f"(limit {rtol / 2:.1e})")
    assert err <= rtol / 2


def _trainer_state(t):
    return (t.losses, {k: v.clone() for k, v in t.model.state_dict().items()},
            t.step.optimizer.state_dict())


@pytest.fixture(scope='module')
def artifact_run(tmp_path_factory):
    """The small trainer trained 6 epochs (2 windows, a checkpoint after
    each) with save_artifacts, and the same run without: (directory with
    artifacts, state with, state without)."""
    out = {}
    for flag in (True, False):
        d = tmp_path_factory.mktemp(f'artifacts_{flag}')
        t = VMCTrainer(VMCConfig(**SMALL_RUN, save_dir=str(d),
                                 save_artifacts=flag))
        t.train(6, verbose=False)
        out[flag] = (d, _trainer_state(t))
    return out[True][0], out[True][1], out[False][1]


def test_save_artifacts_leaves_the_run_unchanged(artifact_run):
    """A trainer with save_artifacts=True equals the same trainer without,
    to the bit: losses, parameters, Adam state (the artifacts draw from a
    stream of their own)."""
    _, (losses, params, opt), (losses0, params0, opt0) = artifact_run
    assert losses == losses0 and len(losses) == 6
    assert all(torch.equal(params[k], params0[k]) for k in params0)
    for a, b in zip(opt['state'].values(), opt0['state'].values()):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_save_artifacts_files(artifact_run):
    """The trainer wrote each checkpoint's artifacts (epochs 3 and 6) at
    JAX's names and shapes: the 100² grid, both 100-point slices, 250
    draws in the box."""
    d = artifact_run[0] / 'outputs'
    for e in (3, 6):
        assert np.load(d / 'wavefunctions_2d' / f'values_epoch{e}.npy'
                       ).shape == (10000,)
        for kind in ('random', 'onproton'):
            assert np.load(d / 'density_1e' / f'{kind}_values_epoch{e}.npy'
                           ).shape == (100,)
            assert np.load(d / 'density_1e' / f'{kind}_coord_epoch{e}.npy'
                           ).shape == (100, 2)
        pts = np.load(d / 'sample_points' / f'values_epoch{e}.npy')
        assert pts.shape == (250, 2) and np.abs(pts).max() <= 5.0
    # the draws depend on the epoch's own stream, not on the walkers'
    a, b = (np.load(d / 'sample_points' / f'values_epoch{e}.npy')
            for e in (3, 6))
    assert not np.array_equal(a, b)


def test_orbax_checkpointer_equals_jax(tmp_path):
    """The same save / restore sequence on JAX's OrbaxCheckpointer (orbax)
    and the port's, max_to_keep=2 over 4 steps: the same steps kept, the
    same latest_step, equal arrays restored; a step at or below the latest
    is not saved by either; restore() on an empty directory returns None
    and a missing step raises FileNotFoundError."""
    state = lambda s: {'a': np.arange(3.0) + s,             # noqa: E731
                       'b': {'c': np.int32(s), 'd': np.eye(2) * s}}
    jc = jcheckpoint.OrbaxCheckpointer(tmp_path / 'jax', max_to_keep=2)
    pc = OrbaxCheckpointer(tmp_path / 'port', max_to_keep=2)
    assert jc.restore() is None and pc.restore() is None
    assert pc.latest_step() is None and pc.all_steps() == []
    for s in range(4):
        jc.save(s, state(s))
        assert pc.save(s, state(s))
    jc.manager.wait_until_finished()
    assert not pc.save(1, state(9))
    jc.save(1, state(9))
    jc.manager.wait_until_finished()
    assert pc.all_steps() == list(jc.manager.all_steps()) == [2, 3]
    assert pc.latest_step() == jc.manager.latest_step() == 3
    for step in (None, 2, 3):
        ref, got = jc.restore(step), pc.restore(step)
        for leaf_ref, leaf in zip(jax.tree_util.tree_leaves(ref),
                                  jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(leaf),
                                          np.asarray(leaf_ref))
    with pytest.raises(FileNotFoundError):
        pc.restore(0)
    jc.close()
    pc.close()
    assert OrbaxCheckpointer(tmp_path / 'port').latest_step() == 3


def test_time_fn_and_trace(tmp_path):
    """time_fn runs fn warmup + iters times and returns seconds per call
    (a positive float, the host clock for CPU outputs); trace writes one
    profiler trace file under its logdir and yields it; the compilation
    cache function makes and returns its directory."""
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    secs = time_fn(fn, torch.ones(16, 16), iters=5, warmup=3)
    assert len(calls) == 8 and isinstance(secs, float) and secs > 0
    assert time_fn(fn, torch.ones(4, 4), iters=2, warmup=0) > 0
    assert not profiling._on_cuda((torch.ones(1), {'a': [torch.ones(1)]}))
    with trace(str(tmp_path / 'trace')) as logdir:
        fn(torch.ones(32, 32))
    assert logdir == str(tmp_path / 'trace')
    files = list(Path(logdir).glob('*.pt.trace.json*'))
    assert len(files) == 1 and files[0].stat().st_size > 0
    path = enable_persistent_compilation_cache(str(tmp_path / 'c' / 'xla'))
    assert path == str(tmp_path / 'c' / 'xla') and Path(path).is_dir()


def _same_png(a: Path, b: Path):
    import matplotlib.image as mpimg
    ia, ib = mpimg.imread(a), mpimg.imread(b)
    assert ia.shape == ib.shape
    np.testing.assert_array_equal(ia, ib)


def _bench_dirs(root: Path) -> list:
    """Two benchmark result directories with the metric files."""
    rng = np.random.default_rng(4)
    dirs = []
    for name in ('MFlow_0.05_1_3_8', 'IFlow_0.1_1_3_8'):
        d = root / name
        d.mkdir(parents=True)
        for m in ('losses', 'kl_divergences', 'hellinger_divergences',
                  'reconstruction_distances', 'test_ll'):
            np.savetxt(d / f'{m}.txt', rng.normal(size=20).cumsum())
        dirs.append(str(d))
    return dirs


FIGURES = ['plot_wavefunction_2d', 'plot_one_electron_density',
           'plot_pdf_grid', 'plot_energy_trace', 'plot_wavefunction_2d_multi',
           'plot_two_particle_box_comparison', 'create_vmc_report',
           'create_report']


@pytest.mark.parametrize('name', FIGURES)
def test_figures_pixel_equal_to_jax(name, tmp_path, artifact_run):
    """Every figure function of both packages from the same arrays: the PNGs
    read back by matplotlib are equal pixel for pixel.  create_vmc_report
    reads the directory the trainer with save_artifacts wrote."""
    rng = np.random.default_rng(5)
    grid = rng.normal(size=900)
    args = {
        'plot_wavefunction_2d': (grid, 5.0),
        'plot_one_electron_density': (np.linspace(-5, 5, 50),
                                      rng.normal(size=50)),
        'plot_pdf_grid': (rng.uniform(size=(30, 30)),),
        'plot_energy_trace': (rng.normal(-2.0, 0.5, size=400),),
        'plot_wavefunction_2d_multi': ({'a': grid, 'b': -grid[::-1]}, 5.0),
        'plot_two_particle_box_comparison': (grid, 5.0),
        'create_vmc_report': (str(artifact_run[0]),),
        'create_report': (_bench_dirs(tmp_path / 'bench'),),
    }[name]
    kwargs = {'plot_pdf_grid': dict(samples=rng.uniform(size=(60, 2))),
              'plot_energy_trace': dict(window=50, exact_energy=-2.9),
              'create_vmc_report': dict(box_length=5.0, window=2),
              'plot_one_electron_density': dict(title='slice')}.get(name, {})
    out = {}
    for pkg, mod in (('jax', jfigures), ('port', figures)):
        out[pkg] = tmp_path / f'{pkg}.png'
        if name in ('create_vmc_report', 'create_report'):
            getattr(mod, name)(args[0], str(out[pkg]), *args[1:], **kwargs)
        else:
            getattr(mod, name)(*args, str(out[pkg]), **kwargs)
    _same_png(out['jax'], out['port'])


def test_two_particle_box_analytic_equals_jax():
    """The analytic two-fermion box state: equal to JAX's to the bit."""
    for L, n in ((5.0, 40), (1.0, 7)):
        grid, x = figures.two_particle_box_analytic(L, n)
        jgrid, jx = jfigures.two_particle_box_analytic(L, n)
        np.testing.assert_array_equal(grid, jgrid)
        np.testing.assert_array_equal(x, jx)


def test_reference_names_build_the_ports_modules():
    """antisymmetrize_model(φ) is the AntisymWaveflow that
    get_antisym_waveflow_model builds from the same seed (equal state dicts
    and ψ_A); BoxTransformLayer is BoxTransform, map for map."""
    kw = dict(base_spline_degree=4, i_spline_degree=4,
              n_prior_internal_knots=8, n_i_internal_knots=8,
              n_flow_layers=1, box_size=3.0, n_spline_base_mesh_points=300,
              device='cpu')
    phi = get_waveflow_model(2, xu_coord_type='independent',
                             generator=torch.Generator().manual_seed(4), **kw)
    a = antisymmetrize_model(phi, 2, 1)
    b = get_antisym_waveflow_model(
        2, 1, generator=torch.Generator().manual_seed(4),
        **{k: v for k, v in kw.items() if k != 'box_size'}, box_size=3.0)
    assert type(a) is type(b)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = torch.rand((16, 2), generator=torch.Generator().manual_seed(1)) * 6 - 3
    with torch.no_grad():
        assert torch.equal(a.psi(x), b.psi(x))
    x = torch.sort(x, -1).values
    for kind in ('mean', 'first', 'independent'):
        layer, ref = BoxTransformLayer(3.0, kind), BoxTransform(3.0, kind)
        assert type(layer) is BoxTransform
        for got, want in zip(layer(x), ref(x)):
            assert torch.equal(got, want)
    assert BoxTransformLayer().L == 1.0
    assert BoxTransformLayer().xu_coord_type == 'mean'


EXAMPLE = ROOT / 'examples' / 'exact_reference_torch.py'


def test_exact_reference_example_equals_jax(tmp_path):
    """examples/exact_reference_torch.py --n-grid 40 prints the He energy
    of JAX's physics.exact at the same grid to 1e-6, and --plot writes a
    figure."""
    from waveflow_tpu.physics import system_catalogue as jcatalogue
    from waveflow_tpu.physics.exact import exact_ground_state_2p
    out = subprocess.run(
        [sys.executable, str(EXAMPLE), '--n-grid', '40', '--plot',
         str(tmp_path / 'he.png')], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.splitlines()[0]
    E = float(line.rsplit('=', 1)[1])
    ref = exact_ground_state_2p(np.asarray(jcatalogue[1]['He'][0]), 10.0,
                                40)[0]
    assert abs(E - ref) < 1e-6, (line, ref)
    assert (tmp_path / 'he.png').stat().st_size > 0


def test_exact_reference_plot_without_matplotlib(tmp_path):
    """Without matplotlib, --plot stops with a plain message (and the
    energy has been printed)."""
    code = ("import runpy, sys; sys.modules['matplotlib'] = None; "
            f"sys.argv = ['x', '--n-grid', '20', '--plot', "
            f"{str(tmp_path / 'x.png')!r}]; "
            f"runpy.run_path({str(EXAMPLE)!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert 'exact ground-state energy' in out.stdout
    assert '--plot needs matplotlib' in out.stderr
    assert not (tmp_path / 'x.png').exists()
