"""Parity of the PyTorch port's ops (waveflow_tpu_torch.ops) with the JAX
package on the CPU: tables, the basis jet (K3's function), the inverse-CDF
samplers (K1's and K2's functions), the table-lerp evaluation (K4's
function), the table inverse and the boundary projector.

Where the JAX function reaches a Pallas kernel it runs as the JAX tests run
it here: the basis jet, the table-lerp kernel and the linear-density
sampler in interpret mode, the squared-amplitude sampler on its XLA path.
On CPU tensors the port's kernel wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu import ops as jops
from waveflow_tpu.ops import sampling as jsampling
from waveflow_tpu_torch import ops as tops
from waveflow_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(2)

FAMILIES = [('I', 6, 23, 2000, False), ('B', 6, 23, 2000, True),
            ('I', 4, 12, 400, False)]


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('kind,deg,knots,mesh,use_ob', FAMILIES)
def test_tables_and_A_jet_equal(kind, deg, knots, mesh, use_ob):
    """(a) Host-built tables and the basis-jet matrix equal the JAX ones
    exactly (same float64 construction, same f32 cast)."""
    jt = jops.get_tables(kind, deg, knots, n_mesh=mesh)
    tt = tops.get_tables(kind, deg, knots, n_mesh=mesh)
    np.testing.assert_array_equal(tt.tables, jt.tables)
    np.testing.assert_array_equal(tt.knots, jt.knots)
    if kind == 'B':
        np.testing.assert_array_equal(tt.ob_tables, jt.ob_tables)
        np.testing.assert_array_equal(tt.ob_to_b, jt.ob_to_b)
    jev = jops.make_poly_evaluator(jt, use_ob=use_ob)
    tev = tops.make_poly_evaluator(tt, use_ob=use_ob, device='cpu')
    np.testing.assert_array_equal(tev.A_jet.numpy(), np.asarray(jev.A_jet))
    np.testing.assert_array_equal(tev.A.numpy(), np.asarray(jev.A))


@pytest.fixture(scope='module')
def jets():
    jt = jops.get_tables('I', 4, 12, n_mesh=400)
    tt = tops.get_tables('I', 4, 12, n_mesh=400)
    return (jops.make_poly_evaluator(jt, jet_backend='pallas'),
            tops.make_poly_evaluator(tt, jet_backend='xla', device='cpu'),
            tops.make_poly_evaluator(tt, jet_backend='pallas', device='cpu'))


@pytest.mark.parametrize('where', ['inside', 'outside'])
def test_basis_jet_orders_0_to_3(jets, where):
    """(b) The jet at orders 0..3, in and out of the domain (linear
    extension), against the JAX Pallas kernel in interpret mode; rtol 2e-5 /
    atol 2e-4 as tests/test_pallas_jet.py."""
    jev, tev_x, tev_p = jets
    rng = np.random.default_rng(0)
    if where == 'inside':
        x = rng.uniform(0, 1, (37, 3)).astype(np.float32)
    else:
        x = np.array([-0.05, -0.001, 1.001, 1.08], np.float32)
    ref = np.asarray(jev.basis_jet(jnp.asarray(x)))
    for tev in (tev_x, tev_p):
        got = tev.basis_jet(_t(x)).numpy()
        assert got.shape == ref.shape == x.shape + (4, jev.n_bases)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)


def test_basis_jet_derivative_rules(jets):
    """(b) First and second x-derivatives by nested forward mode, and the
    first by backward, through the port's autograd.Function against JAX's
    custom JVP; rtol 1e-4 / atol 1e-3 as tests/test_pallas_jet.py."""
    jev, tev_x, _ = jets
    rng = np.random.default_rng(1)
    c = rng.uniform(0.1, 1, (5, jev.n_bases)).astype(np.float32)
    x = rng.uniform(0.05, 0.95, (5,)).astype(np.float32)

    def jg(xx):
        return (jnp.asarray(c) * jev.basis_jet(xx)[..., 0, :]).sum(-1)

    def jd1(xx):
        return jax.jvp(jg, (xx,), (jnp.ones_like(xx),))[1]

    j1, j2 = jax.jvp(jd1, (jnp.asarray(x),), (jnp.ones(5),))
    jgrad = jax.grad(lambda xx: jg(xx).sum())(jnp.asarray(x))

    tc = _t(c)

    def tg(xx):
        return (tc * tev_x.basis_jet(xx)[..., 0, :]).sum(-1)

    def td1(xx):
        return torch.func.jvp(tg, (xx,), (torch.ones_like(xx),))[1]

    t1, t2 = torch.func.jvp(td1, (_t(x),), (torch.ones(5),))
    xr = _t(x).clone().requires_grad_()
    (tgrad,) = torch.autograd.grad(tg(xr).sum(), xr)
    for got, ref in ((t1, j1), (t2, j2), (tgrad, jgrad)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('d', [0, 1, 2])
def test_poly_call_and_value_and_derivative(d):
    """PolySplineEvaluator.__call__ and value_and_derivative (the IMADE
    inverse's Newton step) against JAX, in and out of domain; rtol 1e-5."""
    jt = jops.get_tables('I', 6, 23, n_mesh=2000)
    jev = jops.make_poly_evaluator(jt)
    tev = tops.make_poly_evaluator(tops.get_tables('I', 6, 23, n_mesh=2000),
                                   device='cpu')
    rng = np.random.default_rng(2)
    c = rng.uniform(0, 1, (40, jev.n_bases)).astype(np.float32)
    x = rng.uniform(-0.02, 1.02, (40,)).astype(np.float32)
    np.testing.assert_allclose(tev(_t(c), _t(x), d).numpy(),
                               np.asarray(jev(jnp.asarray(c), jnp.asarray(x), d)),
                               rtol=1e-5, atol=1e-5 * 22.0 ** d)
    if d == 0:
        for got, ref in zip(tev.value_and_derivative(_t(c), _t(x)),
                            jev.value_and_derivative(jnp.asarray(c),
                                                     jnp.asarray(x))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-4)


@pytest.fixture(scope='module')
def ob_evaluators():
    jt = jops.get_tables('B', 6, 23, n_mesh=2000)
    tt = tops.get_tables('B', 6, 23, n_mesh=2000)
    return (jops.make_evaluator(jt, use_ob=True),
            tops.make_evaluator(tt, use_ob=True, device='cpu'))


@pytest.mark.parametrize('branch', ['flat', 'two_level'])
def test_sample_squared_amplitude(ob_evaluators, branch, monkeypatch):
    """(c) Same coefficients and uniforms give the same draws as the JAX XLA
    sampler, through both branches of _locate_in_masses (the two-level one
    forced by lowering its size threshold in both packages): atol 6e-5
    (f32 prefix-sum association order, ~0.1 mesh cell), median 2e-6."""
    if branch == 'two_level':
        monkeypatch.setattr(jsampling, 'TWO_LEVEL_MIN_ELEMENTS', 0)
        monkeypatch.setattr(tsampling, 'TWO_LEVEL_MIN_ELEMENTS', 0)
    jev, tev = ob_evaluators
    rng = np.random.default_rng(3)
    B = 300
    c = rng.normal(size=(B, jev.n_bases)).astype(np.float32)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    u = rng.uniform(0, 1, B).astype(np.float32)
    u[:3] = 0.0
    u[3:6] = np.float32(1.0 - 1e-7)
    ref = np.asarray(jsampling.sample_squared_amplitude(
        jev, jnp.asarray(c), jnp.asarray(u), impl='xla'))
    got = tsampling.sample_squared_amplitude(tev, _t(c), _t(u)).numpy()
    assert ((got >= 0) & (got <= 1)).all()
    diff = np.abs(got - ref)
    assert diff.max() <= 6e-5, diff.max()
    assert np.median(diff) <= 2e-6, np.median(diff)


@pytest.mark.parametrize('impl', ['auto', 'cuda'])
def test_sampler_batch_of_any_rank(ob_evaluators, impl, monkeypatch):
    """A (S, B, n_b) batch: 'auto' on a CPU tensor takes the plain path;
    the kernel route hands K1 one flattened (S*B, n_b) batch and reshapes
    its draws back (the kernel is stood in for by the plain path here, and
    the real wrapper refuses CPU tensors).  Both equal the draws of the
    flattened batch exactly."""
    from waveflow_tpu_torch.ops import cuda_sampler
    _, tev = ob_evaluators
    rng = np.random.default_rng(7)
    c = _t(rng.normal(size=(3, 5, tev.n_bases)).astype(np.float32))
    u = _t(rng.uniform(0, 1, (3, 5)).astype(np.float32))
    flat = tsampling.sample_squared_amplitude(
        tev, c.reshape(15, -1), u.reshape(15), impl='plain')
    if impl == 'cuda':
        with pytest.raises(ValueError):
            tsampling.sample_squared_amplitude(tev, c, u, impl='cuda')
        seen = []

        def stand_in(ev, cc, uu, n_bisect, n_newton):
            seen.append((tuple(cc.shape), tuple(uu.shape)))
            return tsampling.sample_squared_amplitude(ev, cc, uu, n_bisect,
                                                      n_newton, impl='plain')

        monkeypatch.setattr(cuda_sampler, 'sample_squared_amplitude_cuda',
                            stand_in)
    got = tsampling.sample_squared_amplitude(tev, c, u, impl=impl)
    assert got.shape == (3, 5)
    torch.testing.assert_close(got.reshape(15), flat, rtol=0, atol=0)
    if impl == 'cuda':
        assert seen == [((15, tev.n_bases), (15,))]
        with pytest.raises(ValueError):
            tsampling.sample_squared_amplitude(tev, c, u[:2], impl='cuda')


def test_locate_branches_agree(monkeypatch):
    """The two-level locate returns the flat locate's cell and residual on
    the same masses (port only; both are plain PyTorch)."""
    rng = np.random.default_rng(4)
    masses = _t(rng.uniform(0, 1, (64, 999)).astype(np.float32))
    u = _t(rng.uniform(0, 1, 64).astype(np.float32))
    j_flat, q_flat = tsampling._locate_in_masses(masses, u)
    monkeypatch.setattr(tsampling, 'TWO_LEVEL_MIN_ELEMENTS', 0)
    j_two, q_two = tsampling._locate_in_masses(masses, u)
    assert (j_flat == j_two).float().mean() > 0.95
    np.testing.assert_allclose(
        (j_two + q_two / masses.gather(-1, j_two[:, None])[:, 0]).numpy(),
        (j_flat + q_flat / masses.gather(-1, j_flat[:, None])[:, 0]).numpy(),
        atol=1e-3)


@pytest.mark.parametrize('method', ['exact_dense', 'exact_bisect'])
def test_table_inverse(method):
    """The exact table inverse (both forms) against JAX; atol 1e-6."""
    jt = jops.get_tables('I', 6, 23, n_mesh=2000)
    jev = jops.make_evaluator(jt)
    tev = tops.make_evaluator(tops.get_tables('I', 6, 23, n_mesh=2000),
                              device='cpu')
    rng = np.random.default_rng(5)
    w = rng.uniform(0.1, 1, (50, jev.n_bases)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    y = rng.uniform(0, 1, 50).astype(np.float32)
    ref = np.asarray(jops.batched_monotone_inverse(
        jev, jnp.asarray(w), jnp.asarray(y), method=method))
    form = (tops.exact_table_inverse if method == 'exact_dense'
            else tops.exact_node_bisect_inverse)
    got = form(tev, _t(w), _t(y))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    if method == 'exact_dense':     # the size switch picks the dense form here
        np.testing.assert_array_equal(
            tops.batched_monotone_inverse(tev, _t(w), _t(y)).numpy(),
            got.numpy())


@pytest.mark.parametrize('cuda,batch,form', [
    (False, 4096, 'dense'), (False, 4200, 'bisect'), (True, 8192, 'dense'),
    (True, 65536, 'dense'), (True, 131072, 'bisect')])
def test_inverse_form_follows_the_device(monkeypatch, cuda, batch, form):
    """batched_monotone_inverse on the 2000-point mesh: CPU tensors switch
    to node bisection above the JAX package's 2**23 elements (4,194
    walkers); CUDA tensors above DENSE_INVERSE_MAX_ELEMENTS_CUDA, the
    crossover measured on the H100 (dense faster through 65,536 walkers,
    bisection from 131,072)."""
    from types import SimpleNamespace
    from waveflow_tpu_torch.ops import inverse
    monkeypatch.setattr(inverse, 'exact_table_inverse', lambda *a: 'dense')
    monkeypatch.setattr(inverse, 'exact_node_bisect_inverse',
                        lambda *a: 'bisect')
    y = SimpleNamespace(numel=lambda: batch, is_cuda=cuda)
    got = inverse.batched_monotone_inverse(SimpleNamespace(n_mesh=2000),
                                           None, y)
    assert got == form


@pytest.mark.parametrize('kind,norm', [('I', 'sum'), ('B', 'l2')])
def test_boundary_projector_and_bias_remover(kind, norm):
    """Constraint projection and (I-spline) bias removal against JAX;
    rtol 1e-6."""
    jt = jops.get_tables(kind, 6, 23, n_mesh=2000)
    tt = tops.get_tables(kind, 6, 23, n_mesh=2000)
    jev, tev = jops.make_evaluator(jt), tops.make_evaluator(tt, device='cpu')
    cl, cr = ({0: 0.0}, {0: 1.0}) if kind == 'I' else ({0: 0.0}, {0: 0.0})
    jp = jops.make_boundary_projector(jev, cl, cr, normalization=norm,
                                      ispline_right_convention=kind == 'I')
    tp = tops.make_boundary_projector(tev, cl, cr, normalization=norm,
                                      ispline_right_convention=kind == 'I')
    w = np.random.default_rng(6).uniform(0.1, 1, (8, 2, jev.n_bases)
                                         ).astype(np.float32)
    np.testing.assert_allclose(tp(_t(w)).numpy(),
                               np.asarray(jp(jnp.asarray(w))), rtol=1e-6,
                               atol=1e-7)
    if kind == 'I':
        jb = jops.make_bias_remover(jev.n_bases, 6, 'I')
        tb = tops.make_bias_remover(tev.n_bases, 6, 'I')
        np.testing.assert_allclose(tb(_t(w)).numpy(),
                                   np.asarray(jb(jnp.asarray(w))), rtol=1e-6)


@pytest.fixture(scope='module')
def m_evaluators():
    jt = jops.get_tables('M', 3, 8, n_mesh=300)
    tt = tops.get_tables('M', 3, 8, n_mesh=300)
    return jops.make_evaluator(jt), tops.make_evaluator(tt, device='cpu')


def _eval_inputs(n_bases, seed=8):
    """Coefficients and points with the troublesome ones among them: both
    walls, a cell edge, and points outside [0, 1] (linear extension)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1, (64, n_bases)).astype(np.float32)
    x = rng.uniform(0, 1, 64).astype(np.float32)
    x[:6] = np.array([0.0, 1.0, -0.03, 1.04, 150 / 299, 299 / 299], np.float32)
    return w, x


@pytest.mark.parametrize('d', [0, 1, 3])
def test_table_eval_value_and_gradients(m_evaluators, d):
    """(a) SplineEvaluator.__call__: value, coeffs-gradient (the lerped
    basis) and x-gradient (the order-(d+1) table evaluation, zero at the top
    order d = 3) against jax.grad of the JAX evaluator; atol 2e-5, scaled
    by the size of the derivative tables."""
    jev, tev = m_evaluators
    w, x = _eval_inputs(jev.n_bases)
    g = np.random.default_rng(9).normal(size=64).astype(np.float32)

    def jf(ww, xx):
        return (jev(ww, xx, d) * jnp.asarray(g)).sum()

    ref = np.asarray(jev(jnp.asarray(w), jnp.asarray(x), d))
    ref_gw, ref_gx = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w),
                                                  jnp.asarray(x))
    tw = _t(w).requires_grad_()
    tx = _t(x).requires_grad_()
    out = tev(tw, tx, d)
    gw, gx = torch.autograd.grad((out * _t(g)).sum(), (tw, tx))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5 * scale)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ref_gw),
                               atol=2e-5 * scale)
    gx_scale = max(1.0, float(np.abs(np.asarray(ref_gx)).max()))
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref_gx),
                               atol=2e-5 * gx_scale)
    if d == 3:
        assert not gx.any() and not np.asarray(ref_gx).any()
    np.testing.assert_array_equal(
        tev.basis(_t(x), d).numpy(), np.asarray(jev.basis(jnp.asarray(x), d)))


def test_table_eval_takes_any_batch_rank(m_evaluators):
    """A (B, D, n_b) / (B, D) batch, as the density model's prior passes it,
    equals the flattened batch exactly, and a mismatched x is refused."""
    _, tev = m_evaluators
    w, x = _eval_inputs(tev.n_bases)
    flat = tev(_t(w), _t(x))
    got = tev(_t(w).reshape(32, 2, -1), _t(x).reshape(32, 2))
    torch.testing.assert_close(got.reshape(64), flat, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tev(_t(w), _t(x)[:5])


@pytest.mark.parametrize('d', [0, 1, 3])
def test_spline_eval_bwd_plain_matches_jax_vjp(m_evaluators, d):
    """(b) The plain version beside K4's backward kernel against jax.vjp of
    the JAX evaluator's custom-JVP chain, on the same numpy inputs (walls, a
    cell edge and out-of-domain points among them) and the same cotangent:
    the coefficient gradient is the lerped order-d basis, the x-gradient the
    order-(d+1) evaluation, zero at the top order d = 3.  rtol 2e-5, atol
    2e-5 of the largest value (f32 sums in another order)."""
    from waveflow_tpu_torch.ops import cuda_spline
    jev, tev = m_evaluators
    w, x = _eval_inputs(jev.n_bases, seed=21)
    g = np.random.default_rng(22).normal(size=64).astype(np.float32)
    _, vjp = jax.vjp(lambda ww, xx: jev(ww, xx, d), jnp.asarray(w),
                     jnp.asarray(x))
    ref_gw, ref_gx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    table_d1 = tev.tables[d + 1] if d + 1 < tev.n_derivatives else None
    gw, gx = cuda_spline.spline_eval_bwd_plain(tev.tables[d], table_d1,
                                               _t(w), _t(x), _t(g))
    np.testing.assert_allclose(gw.numpy(), ref_gw, rtol=2e-5,
                               atol=2e-5 * max(1.0, np.abs(ref_gw).max()))
    np.testing.assert_allclose(gx.numpy(), ref_gx, rtol=2e-5,
                               atol=2e-5 * max(1.0, np.abs(ref_gx).max()))
    if d == 3:
        assert table_d1 is None and not gx.any() and not ref_gx.any()
    else:
        assert gx.abs().max() > 0


@pytest.mark.parametrize('needs', ['both', 'coeffs', 'x'])
@pytest.mark.parametrize('d', [0, 3])
def test_table_eval_autograd_is_the_plain_backward(m_evaluators, d, needs):
    """On the CPU the evaluator's Function differentiates through
    spline_eval_bwd_plain: torch.autograd.grad equals it exactly, for a
    (B, D) batch too, and a gradient nobody needs is not returned."""
    from waveflow_tpu_torch.ops import cuda_spline
    _, tev = m_evaluators
    w, x = _eval_inputs(tev.n_bases, seed=23)
    g = _t(np.random.default_rng(24).normal(size=64).astype(np.float32))
    table_d1 = tev.tables[d + 1] if d + 1 < tev.n_derivatives else None
    ref = dict(zip(('coeffs', 'x'), cuda_spline.spline_eval_bwd_plain(
        tev.tables[d], table_d1, _t(w), _t(x), g)))
    for shape in ((64,), (32, 2)):
        leaves = {'coeffs': _t(w).reshape(*shape, -1), 'x': _t(x).reshape(shape)}
        wanted = ('coeffs', 'x') if needs == 'both' else (needs,)
        for name in wanted:
            leaves[name].requires_grad_()
        out = tev(leaves['coeffs'], leaves['x'], d)
        grads = torch.autograd.grad(out, [leaves[n] for n in wanted],
                                    g.reshape(shape))
        for name, got in zip(wanted, grads):
            torch.testing.assert_close(got.reshape(ref[name].shape),
                                       ref[name], rtol=0, atol=0)
    got = cuda_spline.spline_eval_bwd(
        tev.tables[d], table_d1, _t(w), _t(x), g,
        need_coeffs=needs != 'x', need_x=needs != 'coeffs')
    assert (got[0] is None) == (needs == 'x')
    assert (got[1] is None) == (needs == 'coeffs')


@pytest.mark.parametrize('twin', ['gather_lerp', 'onehot_matmul'])
@pytest.mark.parametrize('d', [0, 1])
def test_spline_eval_twins_match_pallas_interpret(twin, d):
    """(b) The plain versions beside kernel K4 against the JAX Pallas kernel
    in interpret mode, run as tests/test_spline_eval.py runs it; atol 2e-5
    (scaled by the table's size for the derivative order)."""
    import jax.experimental.pallas as pl
    from waveflow_tpu.ops.pallas_spline import _spline_eval_kernel
    from waveflow_tpu_torch.ops import cuda_spline
    jt = jops.get_tables('I', 4, 8, n_mesh=300)
    table = np.asarray(jt.tables[d])
    N, block = 128, 64
    rng = np.random.default_rng(11)
    w = rng.uniform(0.1, 1, (N, table.shape[1])).astype(np.float32)
    x = rng.uniform(0, 1, N).astype(np.float32)
    x[:4] = np.array([0.0, 1.0, -0.02, 1.03], np.float32)
    ref = pl.pallas_call(
        _spline_eval_kernel,
        grid=(N // block,),
        in_specs=[
            pl.BlockSpec((block, 1), lambda i: (i, 0)),
            pl.BlockSpec((block, table.shape[1]), lambda i: (i, 0)),
            pl.BlockSpec(table.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((block, 1), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(x).reshape(-1, 1), jnp.asarray(w), jnp.asarray(table))
    fn = (cuda_spline.spline_eval if twin == 'gather_lerp'
          else cuda_spline.onehot_matmul_eval)
    got = fn(_t(table), _t(w), _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref[:, 0]),
                               atol=2e-5 * max(1.0, np.abs(table).max()))


@pytest.mark.parametrize('branch', ['flat', 'two_level'])
def test_sample_linear_density(branch, monkeypatch):
    """(c) Plain sample_linear_density, through both branches of
    _locate_in_masses, against the JAX XLA path (atol 2e-6 as
    tests/test_pallas_sampler.py) and the JAX Pallas kernel (kind 'linear')
    in interpret mode on the same uniforms, walls included.  The Pallas
    kernel sums its trapezoids and its prefix in another order than the XLA
    path, and the quadratic's (disc − a) / d amplifies an ulp of the
    residual mass by a / |d|: on these inputs the two JAX paths themselves
    differ by 3.7e-6 (one draw, d / a = 2e-4), so the kernel is held to
    atol 5e-6."""
    from waveflow_tpu.ops.pallas_sampler import pallas_sample_linear_density
    if branch == 'two_level':
        monkeypatch.setattr(jsampling, 'TWO_LEVEL_MIN_ELEMENTS', 0)
        monkeypatch.setattr(tsampling, 'TWO_LEVEL_MIN_ELEMENTS', 0)
    jev = jops.make_evaluator(jops.get_tables('M', 4, 12, n_mesh=1000))
    tev = tops.make_evaluator(tops.get_tables('M', 4, 12, n_mesh=1000),
                              device='cpu')
    rng = np.random.default_rng(12)
    B = 200
    w = rng.uniform(0, 1, (B, jev.n_bases)).astype(np.float32)
    c = w / w.sum(-1, keepdims=True)
    u = rng.uniform(0, 1, B).astype(np.float32)
    u[:3] = 0.0
    u[3:6] = np.float32(1.0 - 1e-7)
    ref = np.asarray(jsampling.sample_linear_density(
        jev, jnp.asarray(c), jnp.asarray(u), impl='xla'))
    ref_pallas = np.asarray(pallas_sample_linear_density(
        jev, jnp.asarray(c), jnp.asarray(u), interpret=True))
    got = tsampling.sample_linear_density(tev, _t(c), _t(u)).numpy()
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(got, ref_pallas, atol=5e-6)


def test_linear_sampler_kernel_route(monkeypatch):
    """'auto' on a CPU tensor takes the plain path; the kernel route hands
    K2 one flattened batch and reshapes its draws back (the kernel is stood
    in for by the plain path here), and the real wrapper refuses CPU
    tensors."""
    from waveflow_tpu_torch.ops import cuda_sampler
    tev = tops.make_evaluator(tops.get_tables('M', 3, 8, n_mesh=300),
                              device='cpu')
    rng = np.random.default_rng(13)
    c = _t(rng.uniform(0, 1, (3, 5, tev.n_bases)).astype(np.float32))
    u = _t(rng.uniform(0, 1, (3, 5)).astype(np.float32))
    flat = tsampling.sample_linear_density(tev, c.reshape(15, -1),
                                           u.reshape(15), impl='plain')
    with pytest.raises(ValueError):
        tsampling.sample_linear_density(tev, c, u, impl='cuda')
    seen = []

    def stand_in(ev, cc, uu):
        seen.append((tuple(cc.shape), tuple(uu.shape)))
        return tsampling.sample_linear_density(ev, cc, uu, impl='plain')

    monkeypatch.setattr(cuda_sampler, 'sample_linear_density_cuda', stand_in)
    got = tsampling.sample_linear_density(tev, c, u, impl='cuda')
    torch.testing.assert_close(got.reshape(15), flat, rtol=0, atol=0)
    assert seen == [((15, tev.n_bases), (15,))]
    torch.testing.assert_close(tsampling.sample_linear_density(tev, c, u),
                               got, rtol=0, atol=0)
