"""The port's multi-process runs (the JAX package's tests/test_distributed.py)
on a 4-rank gloo group laid out as 2 hosts × 2 chips
(tests/_torch_dist_worker.py, mode 'hosts', LOCAL_WORLD_SIZE=2), run
twice: phase 'full' trains to a shard-local checkpoint and on, phase
'resume' starts four fresh processes from that checkpoint.  Gates: the
two-level reduction; the sharded step on the grid against the flat
world-4 step (JAX's SGD gates); a Metropolis + SPRING window and the
trainer under data_parallel='hosts' resumed to the bit."""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu_torch.convert import params_from_jax
from test_torch_parallel import compare_updates, LOSS_RTOL

torch.set_num_threads(2)

WORLD, LOCAL = 4, 2


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{phase: every rank's outputs} of the two runs of the 4-rank group."""
    jparams = jget_waveflow_model(2, **worker.SMALL)(
        jax.random.PRNGKey(0), 2)[0]
    params = params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(5)
    out = tmp_path_factory.mktemp('hosts')
    np.savez(out / 'inputs.npz',
             batch64=np.sort(rng.uniform(-4.5, 4.5, (64, 2)), -1)
             .astype(np.float32),
             walkers16=np.sort(rng.uniform(-4.5, 4.5, (16, 2)), -1)
             .astype(np.float32),
             **{f'param:{k}': v.numpy() for k, v in params.items()})
    result = {}
    for phase in ('full', 'resume'):
        secs = worker.spawn('hosts', WORLD, out, phase, local_world=LOCAL)
        print(f"4-rank gloo group, phase {phase}: {secs:.1f} s wall")
        result[phase] = [dict(np.load(out / f'hosts{phase}_{r}.npz'))
                         for r in range(WORLD)]
    return result


def test_host_chip_two_level_reduction(runs):
    """psum over ('hosts', 'chips') — inside each host, then across — is
    the global sum on every rank; over 'chips' alone, the host's sum; the
    gather runs in (hosts, chips) order; rank r is chip r mod 2 of host
    r div 2."""
    x = np.arange(16.0)
    for r, o in enumerate(runs['full']):
        assert float(o['psum']) == x.sum()
        assert float(o['psum_chips']) == x[8 * (r // 2):8 * (r // 2 + 1)].sum()
        np.testing.assert_array_equal(o['gathered'], x)
        assert list(o['index']) == [r, WORLD, r // LOCAL, r % LOCAL]


def test_grid_step_matches_flat_world(runs):
    """The clipped-score step on 4 × 16 walkers over the 2 × 2 grid (the
    two-level reductions) against the flat world-4 walker axis: loss rtol
    1e-4, the SGD update by cos > 0.999 and norm ratio in (0.95, 1.05)."""
    for o in runs['full']:
        assert float(o['loss_grid']) == pytest.approx(float(o['loss_flat']),
                                                      rel=LOSS_RTOL)
        compare_updates(o['grad_grid'], o['grad_flat'], "2 x 2 vs flat 4")


@pytest.mark.parametrize('what', ['spring', 'trainer'])
def test_four_process_resume_is_bitwise(runs, what):
    """JAX's test_four_process_mcmc_spring_resume and
    test_two_process_trainer_hosts: 'spring' — a sharded Metropolis window
    driven by the SPRING step, checkpointed shard-locally after window A;
    'trainer' — VMCTrainer(data_parallel='hosts', sampler='metropolis')
    through its own checkpoints (rank 0's replicated file, one shard per
    rank).  Window B after the resume equals window B of the unbroken run
    byte for byte on every rank: losses, parameters, walkers and the
    collective step size."""
    for r in range(WORLD):
        a, b = runs['full'][r], runs['resume'][r]
        for k in ('losses', 'params', 'step_size', 'positions'):
            np.testing.assert_array_equal(a[f'{what}_{k}'], b[f'{what}_{k}'],
                                          err_msg=f"rank {r} {k}")
        assert np.isfinite(a[f'{what}_losses']).all()
        # every rank holds the same replicated state
        np.testing.assert_array_equal(a[f'{what}_params'],
                                      runs['full'][0][f'{what}_params'])
        np.testing.assert_array_equal(a[f'{what}_step_size'],
                                      runs['full'][0][f'{what}_step_size'])
    if what == 'spring':
        assert int(runs['resume'][0]['spring_skipped']) == 0
    else:
        assert set(runs['full'][0]['trainer_files']) == {
            'checkpoints', 'loss.npy', 'system_info.json',
            *(f'checkpoints.shard{r}' for r in range(WORLD))}
