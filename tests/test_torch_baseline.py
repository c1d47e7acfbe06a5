"""The port's trainer around the 'reference' estimator, on the CPU: the
running baseline's life cycle in every window kind (adam, SR, SPRING,
Metropolis, MALA) and on the per-epoch path, its reset after a divergence
recovery, ``train(callback=...)``, the four JAX config fields, the
trainer's 'fwd' → 'fwd_batched' rule under the kernel backend, the
combinations the JAX trainer ignores (refused), and a resume of a
'reference' run, which parts from the unbroken one since the baseline is
not checkpointed (as in JAX)."""

import numpy as np
import pytest
import torch

from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
from waveflow_tpu_torch.vmc import trainer as trainer_module

torch.set_num_threads(2)

SMALL = dict(batch_size=8, num_knots=8, n_flow_layers=1, spline_degree=4,
             n_spline_base_mesh_points=400, device='cpu')


def _record_windows(t, monkeypatch):
    """Wrap the trainer's window — its MCMC window, or the ancestral
    ``run_window`` it calls — to record (baseline handed, baseline
    returned, losses) per window."""
    seen = []

    def wrap(real, at):
        """``real`` with the baseline as its positional argument ``at``."""
        def window(*args):
            out = real(*args)
            seen.append((args[at], out[1], out[0]))
            return out
        return window

    if t.config.sampler != 'ancestral':
        # (mstate, n_epochs, baseline, generator)
        t.mcmc_window = wrap(t.mcmc_window, 2)
    else:
        # (step, sample_fn, batch_size, window, baseline)
        monkeypatch.setattr(trainer_module, 'run_window',
                            wrap(trainer_module.run_window, 4))
    return seen


@pytest.mark.parametrize('kind', [
    dict(), dict(optimizer='sr'), dict(optimizer='spring'),
    dict(sampler='metropolis'), dict(sampler='mala')])
def test_baseline_life_cycle(kind, monkeypatch):
    """train(6) at window 2 with the 'reference' estimator (adam) or the
    SR / SPRING step (which take the baseline and ignore it): the first
    window gets 0, each later window the previous window's mean loss —
    the very tensor that window returned, equal to losses.mean() to the
    bit — and the trainer keeps the last one; a second train() call
    starts from 0 again."""
    extra = dict(estimator='reference') if not kind.get('optimizer') else {}
    t = VMCTrainer(VMCConfig(window=2, **SMALL, **kind, **extra))
    seen = _record_windows(t, monkeypatch)
    t.train(6, verbose=False)
    assert len(seen) == 3
    assert seen[0][0].item() == 0.0
    for (_, returned, losses), (handed, _, _) in zip(seen, seen[1:]):
        assert handed is returned
        assert torch.equal(returned, losses.mean())
    assert t.baseline is seen[-1][1]
    seen.clear()
    t.train(2, verbose=False)
    assert seen[0][0].item() == 0.0


def test_baseline_resets_after_divergence():
    """A window with a non-finite loss is dropped and the baseline goes
    back to 0 (JAX trainer.py:790): the window after it is handed 0, not
    the mean of the window before."""
    t = VMCTrainer(VMCConfig(window=2, estimator='reference',
                             sampler='metropolis', **SMALL))
    real, calls = t.mcmc_window, []

    def window(mstate, n_epochs, baseline, generator=None):
        calls.append(baseline)
        losses, base, rates, new = real(mstate, n_epochs, baseline,
                                        generator)
        if len(calls) == 2:
            losses = losses * float('nan')
        return losses, base, rates, new

    t.mcmc_window = window
    t.train(6, verbose=False)
    assert [c.item() == 0.0 for c in calls] == [True, False, True]
    assert len(t.losses) == 4


def test_per_epoch_path_and_callback():
    """train(5, callback=cb) at window 2 takes the per-epoch path for every
    epoch (no window runs), calls cb(trainer, epoch, loss) after each, and
    sets the baseline to the f32 host mean of the last 2 losses at epochs
    2 and 4 (JAX trainer.py:813-815), handing it to the following steps."""
    t = VMCTrainer(VMCConfig(window=2, estimator='reference', **SMALL))
    real_step, handed, calls = t.step, [], []

    def step(batch, baseline):
        handed.append(float(baseline))
        return real_step(batch, baseline)

    step.optimizer = real_step.optimizer
    t.step = step
    t.mcmc_window = None                  # a window call would fail

    def cb(trainer, epoch, loss):
        calls.append((trainer, epoch, loss))

    losses = t.train(5, callback=cb, verbose=False)
    assert [c[1] for c in calls] == [1, 2, 3, 4, 5]
    assert all(c[0] is t for c in calls)
    assert [c[2] for c in calls] == losses
    m2 = float(np.float32(np.mean(losses[:2])))
    m4 = float(np.float32(np.mean(losses[2:4])))
    assert handed == [0.0, 0.0, m2, m2, m4]
    assert t.baseline.item() == m4


def test_jax_config_fields_accepted():
    """energy_clip, i_spline_reverse_fun_tol, matmul_precision and
    compilation_cache_dir are VMCConfig fields: accepted by name,
    energy_clip reaching the loss (a tiny clip caps every loss);
    matmul_precision maps JAX's names onto torch's process-wide setting
    ('bfloat16' -> 'medium'), 'highest' keeps the package's pin."""
    t = VMCTrainer(estimator='reference', energy_clip=1e-3,
                   i_spline_reverse_fun_tol=1e-5,
                   compilation_cache_dir='/nonexistent/cache', **SMALL)
    losses = t.train(2, verbose=False)
    assert np.abs(losses).max() <= 1e-3
    try:
        VMCTrainer(matmul_precision='bfloat16', **SMALL)
        assert torch.get_float32_matmul_precision() == 'medium'
        VMCTrainer(matmul_precision='high', **SMALL)
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        VMCTrainer(matmul_precision='highest', **SMALL)
    assert torch.get_float32_matmul_precision() == 'highest'
    with pytest.raises(ValueError):
        VMCTrainer(matmul_precision='fp8', **SMALL)


@pytest.mark.parametrize('backend,expected', [('poly_pallas', 'fwd_batched'),
                                              ('poly', 'fwd')])
def test_fwd_runs_batched_under_the_kernel_backend(backend, expected):
    """laplacian_mode='fwd' becomes 'fwd_batched' under 'poly_pallas' in
    the trainer (JAX trainer.py:281-283), and stays per walker under
    'poly'; either trains."""
    t = VMCTrainer(VMCConfig(window=2, laplacian_mode='fwd',
                             eval_backend=backend, **SMALL))
    assert t.laplacian_mode == expected
    assert np.isfinite(t.train(2, verbose=False)).all()


@pytest.mark.parametrize('override', [
    dict(optimizer='sr', estimator='reference'),
    dict(optimizer='spring', energy_clip=5.0),
    dict(sampler='metropolis', clip_stat='median_abs')])
def test_ignored_combinations_refused(override):
    """What the JAX trainer accepts and silently ignores raises: the SR and
    SPRING steps take no estimator or energy clip, and the JAX MCMC
    windows build their step without clip_stat."""
    with pytest.raises(NotImplementedError):
        VMCTrainer(**override, **SMALL)


def test_reference_resume_parts_from_the_unbroken_run(tmp_path):
    """'reference' at window 2: 2 windows, save, load, 2 more, against 4
    straight.  The resumed run's third window is handed baseline 0 where
    the unbroken one has the second window's mean (the baseline is not
    checkpointed, as in JAX), so the runs share the first epoch after the
    resume (its loss is E_L's mean) and part after it."""
    cfg = VMCConfig(window=2, estimator='reference', save_dir=str(tmp_path),
                    **SMALL)
    straight = VMCTrainer(cfg)
    straight.train(8, verbose=False)
    first = VMCTrainer(cfg)
    first.train(4, verbose=False)
    second = VMCTrainer(cfg)
    assert second.load_checkpoint(str(tmp_path))
    second.train(4, verbose=False)
    a, b = straight.losses, second.losses
    assert a[:5] == b[:5] and a[5:] != b[5:]
