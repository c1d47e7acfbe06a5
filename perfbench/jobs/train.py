"""The training job: the port's ``VMCTrainer`` at the cell's batch, its
windows replayed as CUDA graphs, for ``--seconds``.

Set-up builds one trainer from the configuration, loads the benchmark's
weights, seeds its walker stream from the run's seed, and drives its first
``first_steps`` epochs through the window's own call (the first call warms
up and captures the epoch), reading the walkers and the loss of each,
Adam's first moment after the first and the parameters after the last.
The same trainer then trains whole windows of ``window`` epochs
(``trainer.train``) until the seconds are up; the rate is walkers × epochs
completed over the seconds taken.  Afterwards the plain reference draws
the first step's walkers from the same weights and uniforms, and follows
the steps at the program's own walkers (checks.py).

Traffic keys: ``batch_size``, ``window`` (handed to the trainer),
``first_steps``, ``trace_epochs`` (the epochs of the traced window).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from perfbench import checks, harness, trace as tracing
from perfbench.reference import vmc as ref_vmc
from perfbench.reference.waveflow import Waveflow


def recording(trainer_cls):
    """``trainer_cls`` keeping the walkers its epochs draw: ``drawn``, a
    copy of the last eager draw; ``captured``, the tensor a captured epoch
    draws into, which each replay rewrites (kept alive, so the graph's
    memory pool never hands it to another tensor; no kernel is added)."""
    class Recording(trainer_cls):
        def sample(self, num_samples: int) -> torch.Tensor:
            x = super().sample(num_samples)
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                self.captured = x
            else:
                self.drawn = x.detach().clone()
            return x
    return Recording


def window_call(trainer):
    """n -> the losses of n epochs of the trainer's window, as its ``train``
    runs one: the replayed graph on the card, the eager window elsewhere."""
    if trainer.graph:
        return lambda n: trainer.train_window(n, trainer.baseline)[0]
    from waveflow_tpu_torch.vmc.estimators import run_window
    return lambda n: run_window(trainer.step, trainer.sample,
                                trainer.local_batch, n, trainer.baseline)[0]


def first_steps(trainer, n_steps: int, spans):
    """(p0, walkers, losses, first gradient, change) of the trainer's first
    steps.  The first call runs its epoch eagerly (then captures it); the
    later ones replay it on the card."""
    call = window_call(trainer)
    params = dict(trainer.model.named_parameters())
    p0 = {k: v.detach().double().cpu() for k, v in params.items()}
    with spans('first_window'):
        losses = [float(call(1)[0])]
    walkers = [trainer.drawn.double().cpu()]
    opt = trainer.step.optimizer
    beta1 = opt.param_groups[0]['betas'][0]
    grad1 = {k: opt.state[p]['exp_avg'].double().cpu() / (1 - beta1)
             if 'exp_avg' in opt.state.get(p, {}) else torch.zeros_like(p0[k])
             for k, p in params.items()}
    for _ in range(n_steps - 1):
        losses.append(float(call(1)[0]))
        walkers.append((trainer.captured if trainer.graph else trainer.drawn)
                       .detach().double().cpu())
    change = {k: v.detach().double().cpu() - p0[k] for k, v in params.items()}
    return p0, walkers, losses, grad1, change


def build(cell, seed: int, device, spans, t0: float = None, **overrides):
    """The trainer of the cell with the benchmark's weights and walker
    stream, and those weights; the set-up's spans from ``t0`` on."""
    if t0 is not None:
        spans.seconds['interpreter and torch'] = time.perf_counter() - t0
    with spans('import'):
        from waveflow_tpu_torch.ops import cuda_build
        from waveflow_tpu_torch.vmc import VMCTrainer
    if device.type == 'cuda':
        with spans('build'):
            cuda_build.build()
    with spans('model'):
        trainer = recording(VMCTrainer)(
            harness.vmc_config(cell, seed, device, **overrides))
    with spans('weights'):
        weights = harness.make_weights(cell.cfg, seed, device)
        harness.load_weights(trainer.model, weights)
        trainer.generator.manual_seed(harness.derive_seed(seed, 'walkers'))
    return trainer, weights


def compare(cell, seed, device, weights, p0, walkers, losses, grad1, change):
    """The reference's draw of the first step's walkers, from the same
    weights and (D, B) uniforms as the program's, and its steps at the
    program's walkers; the numbers of checks.py."""
    model = Waveflow(cell.cfg, device)
    gen = torch.Generator(device=device).manual_seed(harness.derive_seed(seed, 'walkers'))
    u = torch.rand((model.D, cell.traffic['batch_size']), generator=gen, device=device)
    params = {k: v.double() for k, v in weights.items()}
    x_ref = model.sample(params, u)
    ref_losses, ref_mads, ref_grad1, ref_params = ref_vmc.train_steps(
        model, params, [x.to(device) for x in walkers], cell.cfg)
    return {'sample_dx': checks.draw_gap(walkers[0], x_ref.cpu(), cell.cfg['box_length']),
            **checks.train_numbers(
                losses, grad1, change, ref_losses, ref_mads,
                {k: v.cpu() for k, v in ref_grad1.items()},
                {k: ref_params[k].cpu() - p0[k] for k in p0})}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        **overrides) -> dict:
    sync = torch.cuda.synchronize if device.type == 'cuda' else None
    spans = harness.Spans(sync)
    traffic = cell.traffic
    B, window = traffic['batch_size'], traffic['window']
    trainer, weights = build(cell, seed, device, spans, t0, **overrides)
    p0, walkers, losses, grad1, change = first_steps(trainer, traffic['first_steps'], spans)
    setup_s = time.perf_counter() - t0

    windows, epoch0 = [], trainer.epoch
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        trainer.train(window, verbose=False)
        if sync:
            sync()
        windows.append(time.perf_counter() - t)
        if time.perf_counter() - start >= seconds:
            break
    elapsed = time.perf_counter() - start
    epochs = trainer.epoch - epoch0

    tr = None
    if trace:
        n = traffic['trace_epochs']
        call = window_call(trainer)
        tr = tracing.traced(lambda: call(n), n, warm=lambda: call(2))
        del call
    peak = torch.cuda.max_memory_allocated(device) if sync else 0
    del trainer
    gc.collect()
    if sync:
        torch.cuda.empty_cache()
    numbers = compare(cell, seed, device, weights, p0, walkers, losses, grad1, change)
    context = SimpleNamespace(
        job='train', cfg=cell.cfg, traffic=traffic, walkers=B,
        spans=spans.seconds, windows=windows, epochs=epochs, elapsed_s=elapsed,
        trace=tr,
        device_kind=torch.cuda.get_device_name(device) if sync else 'cpu')
    return {'metrics': {'train_walkers_per_s': B * epochs / elapsed,
                        'setup_s': setup_s},
            'attempted': len(windows), 'failed': len(windows) - epochs // window,
            'memory_peak_bytes': peak, 'numbers': numbers, 'context': context}
