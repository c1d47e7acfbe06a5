"""Walker parallelism of the port (waveflow_tpu_torch/parallel/) against the
JAX package's tests/test_parallel.py, on the CPU.

One gloo group of 2 ranks (tests/_torch_dist_worker.py, mode 'parallel')
runs every 2-rank gate in one go; this process holds the references: the
port's single-process steps on the concatenated walkers, and JAX's sharded
functions on a 2-device mesh of its 8 virtual CPU devices, on the same
parameters (through convert.py) and the same numpy inputs.  A world of one
process, over gloo in this process, is the unsharded trainer to the bit.
Each gate prints the largest difference it measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.parallel import (
    make_sharded_train_step as jmake_sharded_train_step,
    make_walker_mesh as jmake_walker_mesh, shard_batch as jshard_batch,
    systematic_indices as jsystematic_indices,
)
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue,
)
from waveflow_tpu.vmc.estimators import make_train_step as jmake_train_step
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.parallel import (
    WalkerMesh, all_gather, axis_index, axis_size, destroy_walker_mesh,
    make_sharded_sampler, make_walker_mesh, pmean, psum,
)
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
from waveflow_tpu_torch.vmc.mala import make_mala_sampler
from waveflow_tpu_torch.vmc.metropolis import (
    make_metropolis_sampler, sector_projection,
)
from waveflow_tpu_torch.vmc.smc import systematic_resample
from waveflow_tpu_torch.vmc.sr import (
    make_score_fn, make_spring_train_step, make_sr_train_step,
)

torch.set_num_threads(2)

WORLD = 2
# tests/test_parallel.py::test_sharded_step_matches_single_device's gates
LOSS_RTOL, MIN_COS, RATIO = 1e-4, 0.999, (0.95, 1.05)
GRAM_RTOL = 1e-5
# tests/test_torch_sr.py's tolerance for a natural-gradient update driven
# by the same energies (relative L2 of the update vector)
NG_UPDATE_TOL = 2e-3
STEP_SIZE_RTOL = 1e-6


@pytest.fixture(scope='module')
def setup():
    """The JAX package's small He-1d model, its port twin and the inputs."""
    protons, n = system_catalogue[1]['He']
    jparams, jpsi, _, jsample = jget_waveflow_model(n, **worker.SMALL)(
        jax.random.PRNGKey(0), n)
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1, eps=0.0)
    params = {k: v.numpy() for k, v in
              params_from_jax(jax.device_get(jparams)).items()}
    rng = np.random.default_rng(11)
    walkers = np.sort(rng.uniform(-4.5, 4.5, (32, 2)), -1).astype(np.float32)
    inputs = dict(
        batch64=np.asarray(jsample(jax.random.PRNGKey(1), jparams, 64)),
        batch32=np.asarray(jsample(jax.random.PRNGKey(2), jparams, 32)),
        spring_delta=(rng.normal(size=sum(v.size for v in params.values()))
                      * 1e-3).astype(np.float32),
        walkers=walkers,
        noise=rng.normal(size=(32, 2)).astype(np.float32),
        u=rng.uniform(size=32).astype(np.float32),
        resample_pos=np.arange(32, dtype=np.float32)[:, None],
        lw_half=np.where(np.arange(32) >= 16, 0.0, -1e9).astype(np.float32),
        lw_random=rng.normal(size=32).astype(np.float32) * 2,
        resample_u=np.float32(rng.uniform()),
        **{f'param:{k}': v for k, v in params.items()})
    return dict(jparams=jparams, jpsi=jpsi, jh=jh, params=params,
                inputs=inputs)


@pytest.fixture(scope='module')
def world2(setup, tmp_path_factory):
    """Every rank's outputs of one 2-rank gloo group."""
    out = tmp_path_factory.mktemp('parallel')
    np.savez(out / 'inputs.npz', **setup['inputs'])
    secs = worker.spawn('parallel', WORLD, out)
    print(f"2-rank gloo group: {secs:.1f} s wall")
    return [dict(np.load(out / f'parallel_{r}.npz')) for r in range(WORLD)]


def port_model(setup):
    return worker._small_model(torch, setup['params'])


def compare_updates(a, b, label):
    """JAX's test_sharded_step_matches_single_device check on two update
    vectors: direction (cos) and magnitude (norm ratio)."""
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    ratio = float(np.linalg.norm(a) / np.linalg.norm(b))
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"{label}: cos {cos:.8f}, norm ratio {ratio:.8f}, largest "
          f"difference {rel:.3e} of the largest entry")
    assert cos > MIN_COS, (label, cos)
    assert RATIO[0] < ratio < RATIO[1], (label, ratio)


def jax_sharded_sgd_update(setup, stat):
    """JAX's sharded step with SGD on a 2-device mesh: (loss, gradient as
    the update over -lr, in the port's flat parameter order)."""
    jmesh = jmake_walker_mesh(WORLD)
    opt = optax.sgd(worker.SGD_LR)
    jp = setup['jparams']
    if stat == 'mean_abs':
        step = jmake_sharded_train_step(setup['jpsi'], setup['jh'], opt, jmesh)
    else:          # make_sharded_train_step takes no clip statistic
        step = jax.jit(jax.shard_map(
            jmake_train_step(setup['jpsi'], setup['jh'], opt,
                             pmean_axis='walkers', clip_stat=stat),
            mesh=jmesh, in_specs=(P(), P(), P('walkers'), P()),
            out_specs=(P(), P(), P()), check_vma=False))
    batch = jshard_batch(jnp.asarray(setup['inputs']['batch64']), jmesh)
    new, _, loss = step(jp, opt.init(jp), batch, jnp.zeros(()))
    old = params_from_jax(jax.device_get(jp))
    new = params_from_jax(jax.device_get(new))
    m, _ = port_model(setup)
    names = [n for n, _ in m.named_parameters()]
    upd = np.concatenate([(new[n] - old[n]).numpy().ravel() for n in names])
    return float(loss), upd / -worker.SGD_LR


@pytest.mark.parametrize('stat', ['mean_abs', 'median_abs'])
def test_sharded_step_matches_single_process_and_jax(setup, world2, stat):
    """The clipped-score step on 2 × 32 walkers (the clip window over both
    ranks' energies, the loss and gradients averaged) against the port's
    single-process step on the 64 concatenated walkers and JAX's sharded
    step: loss rtol 1e-4, the SGD update by cos > 0.999 and norm ratio in
    (0.95, 1.05), JAX's gates; both ranks hold the same loss and update."""
    from waveflow_tpu_torch.vmc.estimators import make_train_step
    r0, r1 = world2
    np.testing.assert_array_equal(r0[f'grad_{stat}'], r1[f'grad_{stat}'])
    assert r0[f'loss_{stat}'] == r1[f'loss_{stat}']
    m, h = port_model(setup)
    step = make_train_step(m.psi, h, m.parameters(), worker.SGD_LR,
                           grad_clip=None, clip_stat=stat)
    loss1 = float(step(torch.as_tensor(setup['inputs']['batch64']),
                       torch.zeros(())))
    g1 = worker._flat_grads(torch, m).numpy()
    jloss, jg = jax_sharded_sgd_update(setup, stat)
    loss2 = float(r0[f'loss_{stat}'])
    print(f"{stat}: loss world 2 {loss2:.7f}, single process {loss1:.7f}, "
          f"JAX sharded {jloss:.7f}")
    assert loss2 == pytest.approx(loss1, rel=LOSS_RTOL)
    assert loss2 == pytest.approx(jloss, rel=LOSS_RTOL)
    compare_updates(r0[f'grad_{stat}'], g1, f"{stat} world 2 vs one process")
    compare_updates(r0[f'grad_{stat}'], jg, f"{stat} world 2 vs JAX sharded")


def test_chunked_gram_matches_concatenated_scores(setup, world2):
    """SPRING's Gram from column blocks of 256 all-gathered score columns
    equals O Oᵀ of the concatenated (32, P) score matrix, relative 1e-5."""
    r0, r1 = world2
    np.testing.assert_array_equal(r0['gram'], r1['gram'])
    m, _ = port_model(setup)
    flatten, scores = make_score_fn(m)
    O = scores(flatten(), torch.as_tensor(setup['inputs']['batch32']))
    want = (O @ O.T).detach().numpy()
    assert int(r0['n_params']) > 2 * worker.GRAM_TEST_CHUNK
    rel = np.abs(r0['gram'] - want).max() / np.abs(want).max()
    print(f"chunked Gram ({int(r0['n_params'])} columns in blocks of "
          f"{worker.GRAM_TEST_CHUNK}): largest difference {rel:.3e}")
    assert rel <= GRAM_RTOL


def test_sharded_spring_step_matches_single_process(setup, world2):
    """One SPRING step (momentum on a random previous update) on 2 × 16
    walkers against the single-process step on the 32 concatenated ones:
    loss rtol 1e-4, the new update and the parameters' change each within
    a relative L2 error of 2e-3 (tests/test_torch_sr.py's tolerance)."""
    r0, r1 = world2
    np.testing.assert_array_equal(r0['spring_delta'], r1['spring_delta'])
    m, h = port_model(setup)
    before = worker._flat(torch, m).numpy()
    step = make_spring_train_step(m, h, **worker.SPRING)
    step.optimizer.load_state_dict({
        **step.init_state(), 'delta': setup['inputs']['spring_delta']})
    loss = float(step(torch.as_tensor(setup['inputs']['batch32']),
                      torch.zeros(())))
    delta = step.optimizer.state_dict()['delta'].numpy()
    after = worker._flat(torch, m).numpy()
    d_rel = np.linalg.norm(r0['spring_delta'] - delta) / np.linalg.norm(delta)
    u_rel = (np.linalg.norm((r0['spring_params'] - before) - (after - before))
             / np.linalg.norm(after - before))
    print(f"SPRING world 2 vs one process: loss {float(r0['spring_loss'])} / "
          f"{loss}, delta {d_rel:.3e}, update {u_rel:.3e} (relative L2)")
    assert float(r0['spring_loss']) == pytest.approx(loss, rel=LOSS_RTOL)
    assert d_rel <= NG_UPDATE_TOL and u_rel <= NG_UPDATE_TOL


def test_sharded_sr_step_and_window(setup, world2):
    """One SR step (10 CG iterations on the pmean-reduced S) on 2 × 16
    walkers against the single-process step on 32: loss rtol 1e-4, and the
    update within 3 × the relative L2 difference that merely reordering the
    same 32 walkers makes in one process (the largest of 3 orders: the f32
    sum order is all that the ranks change, and 10 CG iterations at damping
    1e-3 amplify it to ~1e-3); and JAX's test_sharded_sr_window_trains: a
    sharded SR window of 3 epochs at 64 walkers has finite losses, moves
    the parameters, and leaves both ranks with the same losses."""
    r0, r1 = world2
    batch = torch.as_tensor(setup['inputs']['batch32'])

    def update(rows):
        m, h = port_model(setup)
        before = worker._flat(torch, m).numpy()
        loss = float(make_sr_train_step(m, h, **worker.SR)(rows,
                                                           torch.zeros(())))
        return loss, worker._flat(torch, m).numpy() - before, before

    loss, want, before = update(batch)
    floor = max(np.linalg.norm(update(batch[torch.randperm(
        32, generator=torch.Generator().manual_seed(s))])[1] - want)
        for s in range(3)) / np.linalg.norm(want)
    u_rel = np.linalg.norm(r0['sr_params'] - before - want) \
        / np.linalg.norm(want)
    print(f"SR world 2 vs one process: loss {float(r0['sr_loss'])} / {loss}, "
          f"update {u_rel:.3e} (reordered walkers in one process: "
          f"{floor:.3e}); window losses {r0['sr_window_losses']}")
    assert float(r0['sr_loss']) == pytest.approx(loss, rel=LOSS_RTOL)
    assert u_rel <= 3 * floor
    assert np.isfinite(r0['sr_window_losses']).all()
    np.testing.assert_array_equal(r0['sr_window_losses'],
                                  r1['sr_window_losses'])
    assert float(r0['sr_window_moved']) > 0


@pytest.mark.parametrize('kind', ['metropolis', 'mala'])
def test_collective_step_size(setup, world2, kind):
    """One sweep from explicit noise and uniforms on 2 × 16 walkers: both
    ranks end with the same step size, equal (rtol 1e-6) to one sweep of
    the 32 concatenated walkers in one process; the walkers move alike."""
    r0, r1 = world2
    assert r0[f'{kind}_step'] == r1[f'{kind}_step']
    m, _ = port_model(setup)
    inp = {k: torch.as_tensor(setup['inputs'][k])
           for k in ('walkers', 'noise', 'u')}
    if kind == 'metropolis':
        init, step_fn, _ = make_metropolis_sampler(
            m.log_pdf, bounds=(-5.0, 5.0),
            proposal_map=sector_projection(True))
        st = step_fn(init(inp['walkers'], step_size=0.5), noise=inp['noise'],
                     u=inp['u'])
    else:
        init, step_fn, _ = make_mala_sampler(m.log_pdf, bounds=(-5.0, 5.0))
        st = step_fn(init(inp['walkers'], step_size=0.3), noise=inp['noise'],
                     u=inp['u'])
    pos = np.concatenate([r0[f'{kind}_positions'], r1[f'{kind}_positions']])
    diff = abs(float(r0[f'{kind}_step']) - float(st.step_size))
    print(f"{kind}: step size world 2 {float(r0[f'{kind}_step']):.9f}, one "
          f"process {float(st.step_size):.9f} (difference {diff:.3e}); "
          f"walkers {np.abs(pos - st.positions.numpy()).max():.3e}")
    assert float(r0[f'{kind}_step']) == pytest.approx(
        float(st.step_size), rel=STEP_SIZE_RTOL)
    np.testing.assert_allclose(pos, st.positions.numpy(), rtol=0, atol=1e-5)


def test_systematic_indices_match_jax():
    """parallel/resample.py::systematic_indices at JAX's uniform equals
    JAX's systematic_indices (which draws it from its key), to the index."""
    from waveflow_tpu_torch.parallel import systematic_indices
    rng = np.random.default_rng(3)
    for seed in range(5):
        lw = rng.normal(size=64).astype(np.float32) * 3
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsystematic_indices(key, jnp.asarray(lw), 64))
        u = torch.tensor(float(jax.random.uniform(key)))
        got = systematic_indices(u, torch.as_tensor(lw), 64).numpy()
        np.testing.assert_array_equal(got, np.minimum(want, 63))


@pytest.mark.parametrize('weights', ['lw_half', 'lw_random'])
def test_sharded_resample_matches_single_process(setup, world2, weights):
    """The resample of a 2 × 16 population from a shared uniform equals the
    single-process systematic resample of the 32 concatenated walkers, to
    the bit; JAX's test_sharded_walker_resampling: all weight on the upper
    half leaves only upper-half walkers, with uniform log-weights."""
    inp = setup['inputs']
    got = np.concatenate([r[f'resampled_{weights}'] for r in world2])
    idx = systematic_resample(torch.as_tensor(inp['resample_u']),
                              torch.as_tensor(inp[weights]), 32)
    np.testing.assert_array_equal(got, inp['resample_pos'][idx.numpy()])
    for r in world2:
        np.testing.assert_array_equal(r[f'resampled_{weights}_lw'], 0.0)
    if weights == 'lw_half':
        assert (got[:, 0] >= 16).all()


@pytest.mark.parametrize('pair', worker.TRAINER_PAIRS,
                         ids=lambda p: '-'.join(p))
def test_vmc_trainer_data_parallel(world2, pair):
    """JAX's test_vmc_trainer_sr_data_parallel: VMCTrainer(data_parallel=
    True) with SR on ancestral walkers and SPRING on MALA walkers, over 2
    ranks of 8 walkers, 2 windows of 2 epochs: 4 finite losses, the same on
    both ranks (the loss is averaged over them)."""
    key = 'trainer_{}_{}'.format(*pair)
    r0, r1 = world2
    print(f"{key}: losses {r0[key]}")
    assert r0[key].shape == (4,) and np.isfinite(r0[key]).all()
    np.testing.assert_array_equal(r0[key], r1[key])


def test_no_artifacts_over_two_ranks(world2):
    """save_artifacts=True under data_parallel over two ranks: the
    checkpoints are written (rank 0's and each rank's shard), the
    artifacts are not, as JAX writes them only when a single process
    runs."""
    for r in world2:
        files = r['artifacts_run_files'].tolist()
        assert 'outputs' not in files
        assert {'checkpoints', 'checkpoints.shard0', 'checkpoints.shard1',
                'loss.npy'} <= set(files), files


def test_sharded_sampler_rejects_indivisible():
    """JAX's test_sharded_sampler_rejects_indivisible: 100 walkers over 8
    ranks raise ValueError; 64 give each rank 8."""
    mesh = WalkerMesh('walkers', (8,), 3, torch.device('cpu'), 'gloo')
    sample = make_sharded_sampler(lambda n, generator=None: torch.zeros(n),
                                  mesh)
    with pytest.raises(ValueError, match='not divisible'):
        sample(100)
    assert sample(64)().shape == (8,)


# ---- a world of one process, in this process --------------------------------

@pytest.fixture
def world1():
    mesh = make_walker_mesh(device='cpu')
    yield mesh
    destroy_walker_mesh()


def test_collectives_over_a_world_of_one(world1):
    """Over one rank every collective returns its input, to the bit, and
    the axis has size 1 and index 0."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    assert world1.size == 1 and world1.backend == 'gloo'
    assert axis_size('walkers') == 1 and axis_index('walkers') == 0
    assert torch.equal(psum(x, 'walkers'), x)
    assert torch.equal(pmean(x, 'walkers'), x)
    assert torch.equal(all_gather(x, 'walkers'), x)
    assert torch.equal(all_gather(x, 'walkers', tiled=False), x[None])


def trainer_state(t):
    out = {'losses': torch.tensor(t.losses, dtype=torch.float64),
           'generator': t.generator.get_state(),
           **{f'param {k}': v for k, v in t.model.state_dict().items()}}
    for i, st in t.step.optimizer.state_dict()['state'].items():
        out.update({f'adam {i} {k}': v for k, v in st.items()})
    if t.mcmc_state is not None:
        out.update({f'walkers {k}': v for k, v in
                    zip(t.mcmc_state._fields, t.mcmc_state)})
    return out


@pytest.mark.parametrize('sampler', ['ancestral', 'metropolis'])
def test_world_of_one_equals_unsharded(world1, sampler):
    """data_parallel=True over a world of one (every collective run through
    gloo) trains as the unsharded trainer to the bit: two windows of 3
    epochs, then a single epoch; losses, parameters, Adam state, walkers
    and the generator compared.  The CPU twin of chip_smoke's dp-nccl-1 and
    dp-metropolis-1."""
    cfg = dict(worker.TRAINER, sampler=sampler)
    plain = VMCTrainer(VMCConfig(**cfg))
    sharded = VMCTrainer(VMCConfig(**cfg, data_parallel=True))
    assert sharded.mesh.size == 1 and plain.mesh is None
    for t in (plain, sharded):
        t.train(num_epochs=7, verbose=False)
    a, b = trainer_state(plain), trainer_state(sharded)
    assert a.keys() == b.keys()
    diff = {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if a[k].is_floating_point()}
    print(f"world of one vs unsharded ({sampler}): largest difference "
          f"{max(diff.values()):.3e}")
    for k in a:
        assert torch.equal(a[k], b[k]), k
