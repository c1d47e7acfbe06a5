"""Both packages trained from one initial state, on the CPU (the JAX side):
a round-5 row's configuration (examples/round5_quality_torch.py's plan)
at a seed, JAX's initial parameters or the port's.

    JAX_PLATFORMS=cpu python tests/_jax_shared_init.py init h2_2d2e_antisym 2 DIR
        JAX's VMCTrainer at that seed, untrained, saved as a JAX checkpoint
        in DIR (epoch 0, zero Adam moments, no walkers): the port's trainer
        loads it (round5_quality_torch.py --init-from DIR) and trains from
        JAX's initial parameters.
    JAX_PLATFORMS=cpu python tests/_jax_shared_init.py train h2_2d2e_antisym 2 3000 [--port-init]
        JAX's trainer trains that many epochs from its own initial
        parameters, or (--port-init) from the port's at the same seed
        (``VMCTrainer(..., device='cpu')``'s model, carried across by
        ``convert.params_to_jax``).
    JAX_PLATFORMS=cpu python tests/_jax_shared_init.py train flagship_fwd_batched_100k 4 100000 \
            --chunk 10000 --evaluate --save-dir runs/jaxcpu/flagship_s4
        the same for the reference's own seed spread: ``--evaluate`` adds
        JAX's frozen-parameter evaluation at the JAX protocol
        (``evaluate_trainer(n_blocks=64, sweeps_per_block=25,
        n_warmup_sweeps=250)``), ``--save-dir`` keeps the checkpoint (the
        port evaluates it as it evaluates any JAX run).  ``--decay N LR``
        then resumes a second trainer at learning rate LR from the first's
        checkpoint for N epochs (the round-5 script's decay), and
        ``--fidelity`` adds an antisym row's ``fidelity_2d_2e`` against the
        committed 40-point ED.

``train`` prints one JSON line: the first loss, the median of each
``--chunk`` epochs (default 500), of the last 2,000 and of the last 20%,
and with ``--evaluate`` the evaluation's figures.  Not a test module: a
helper the test suite does not collect."""

import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHUNK = 500


def _job(key: str):
    spec = importlib.util.spec_from_file_location(
        'round5_quality_torch', ROOT / 'examples' / 'round5_quality_torch.py')
    r5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(r5)
    return {j.key: j for j in r5.plan()}[key]


def _config(key: str, seed: int) -> dict:
    return dict(_job(key).cfg, seed=seed, log_every=10 ** 9)


def main(argv) -> None:
    import jax
    import numpy as np
    from waveflow_tpu.vmc import VMCConfig, VMCTrainer
    jax.config.update('jax_default_matmul_precision', 'highest')
    mode, key, seed = argv[0], argv[1], int(argv[2])
    cfg = _config(key, seed)
    if mode == 'init':
        trainer = VMCTrainer(VMCConfig(save_dir=argv[3], **cfg))
        trainer.save_checkpoint(argv[3])
        print(json.dumps({'key': key, 'seed': seed, 'saved': argv[3]}))
        return
    epochs = int(argv[3])
    port_init = '--port-init' in argv
    chunk = int(argv[argv.index('--chunk') + 1]) if '--chunk' in argv \
        else CHUNK
    keep = argv[argv.index('--save-dir') + 1] if '--save-dir' in argv \
        else None
    with tempfile.TemporaryDirectory() as tmp:
        trainer = VMCTrainer(VMCConfig(save_dir=keep or tmp, **cfg))
        if port_init:
            import jax.numpy as jnp
            from waveflow_tpu_torch.convert import params_to_jax
            from waveflow_tpu_torch.vmc import VMCConfig as TConfig
            from waveflow_tpu_torch.vmc import VMCTrainer as TTrainer
            port = TTrainer(TConfig(device='cpu', **cfg))
            trainer.params = jax.tree_util.tree_map(
                jnp.asarray, params_to_jax(port.model))
            trainer.opt_state = trainer.optimizer.init(trainer.params)
        t0 = time.time()
        losses = np.asarray(trainer.train(num_epochs=epochs, verbose=False))
        if '--decay' in argv:
            at = argv.index('--decay')
            decay_epochs, decay_lr = int(argv[at + 1]), float(argv[at + 2])
            trainer.save_checkpoint(keep or tmp)
            trainer = VMCTrainer(VMCConfig(save_dir=keep or tmp, **dict(
                cfg, learning_rate=decay_lr)))
            assert trainer.load_checkpoint(keep or tmp)
            losses = np.asarray(trainer.train(num_epochs=decay_epochs,
                                              verbose=False))
        row = {
            'key': key, 'seed': seed, 'init': 'port' if port_init else 'jax',
            'epochs': epochs, 'first_loss': float(losses[0]),
            'chunk': chunk,
            'chunks': [float(np.median(losses[i:i + chunk]))
                       for i in range(0, len(losses), chunk)],
            'last_2000': float(np.median(losses[-2000:])),
            'last_20pct': float(np.median(losses[int(len(losses) * 0.8):])),
            'wall_s': time.time() - t0}
        if '--evaluate' in argv:
            from waveflow_tpu.vmc import evaluate_trainer
            ev = evaluate_trainer(trainer, n_blocks=64, sweeps_per_block=25,
                                  n_warmup_sweeps=250)
            row.update(eval_mean=ev.e_mean, eval_stderr=ev.e_stderr,
                       eval_clipped=ev.e_clipped,
                       eval_clipped_stderr=ev.e_clipped_stderr,
                       accept_rate=ev.accept_rate)
        if '--fidelity' in argv:
            from waveflow_tpu.utils.fidelity import fidelity_2d_2e
            job = _job(key)
            ed = np.load(ROOT / 'results' / f"ed40_{job.post['ed']}_2d2e.npz")
            psi_ed = (ed['psi'][:, 0] if job.post['n_states'] == 1
                      else ed['psi'])
            row['fidelity_ed40'] = float(fidelity_2d_2e(
                trainer.psi, trainer.params, psi_ed, ed['sites'], ed['x']))
        if keep:
            trainer.save_checkpoint(keep)
    print(json.dumps(row), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 4:
        sys.exit(__doc__)
    main(sys.argv[1:])
