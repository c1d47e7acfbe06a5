"""The JAX package's verdict on weights the port trained, on the CPU:

    JAX_PLATFORMS=cpu python tests/_jax_port_weights.py \\
        runs/r5/round5_quality.json flagship_fwd_batched_100k [h2_2d2e_antisym ...]
    JAX_PLATFORMS=cpu python tests/_jax_port_weights.py \\
        runs/sr_study/sr_study.json big_sr_cg_0.05_tr

For each row of examples/round5_quality_torch.py's rows file: the port's
checkpoint beside it (``<dir>/r5_<key>/checkpoints``) carried to the JAX
pytree by ``convert.params_to_jax``, loaded into a JAX ``VMCTrainer`` of
the row's configuration (the plan's, the row's seed), and then

  * at every walker of every tail the row holds (``tail`` and
    ``eval_seeds.<seed>.tail``, vmc/evaluate.py::record_tail), JAX's local
    energy ``h_fn(params, x) / _safe_psi(psi(params, x))`` beside the
    port's (``el``) and the port's float64 one (``el_float64``);
  * for an antisym row, JAX's ``fidelity_2d_2e`` of the weights against
    the committed 40-point ED state, beside the port's ``fidelity_ed40``.

For a rows file of examples/sr_study_torch.py (``sr_study.json``, its
checkpoints in ``<dir>/sr_study_<key>``), the weights go into JAX's
trainer of the row's ansatz, and JAX's and the port's local energies are
taken at SR_WALKERS walkers drawn from the port's model (generator seed 0),
with both packages' ``fidelity_2p`` against the 120-point two-electron ED
of the row's system.

One JSON line per row.  Writes no file.  Not a test module: a helper the
test suite does not collect."""

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _round5():
    spec = importlib.util.spec_from_file_location(
        'round5_quality_torch', ROOT / 'examples' / 'round5_quality_torch.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SR_WALKERS = 4096


def _example(stem: str):
    spec = importlib.util.spec_from_file_location(
        stem, ROOT / 'examples' / f'{stem}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main_sr(rows_path: Path, keys: list) -> None:
    """The JAX verdict on SR-study weights: local energies at the port's
    walkers and the fidelity to the two-electron ED, both packages."""
    import argparse
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from waveflow_tpu.physics import exact_ground_state_2p
    from waveflow_tpu.utils.fidelity import fidelity_2p as jax_fidelity_2p
    from waveflow_tpu.vmc import VMCConfig, VMCTrainer
    from waveflow_tpu.vmc.estimators import _safe_psi
    from waveflow_tpu_torch.convert import params_to_jax
    from waveflow_tpu_torch.utils.checkpoint import load_state
    from waveflow_tpu_torch.utils.fidelity import fidelity_2p
    from waveflow_tpu_torch.vmc import VMCTrainer as PortTrainer

    jax.config.update('jax_default_matmul_precision', 'highest')
    sr = _example('sr_study_torch')
    for key in keys:
        cfg = sr.config(key, argparse.Namespace(device='cpu',
                                                out_dir=rows_path.parent))
        port = PortTrainer(dataclasses.replace(cfg, save_dir=None))
        # the parameters alone: the card's generator state has no CPU form
        state = load_state(Path(cfg.save_dir) / 'checkpoints')
        port.model.load_state_dict({k: torch.as_tensor(v)
                                    for k, v in state['params'].items()})
        ansatz = sr.ANSATZE[key.split('_', 1)[0]]
        trainer = VMCTrainer(VMCConfig(system_name=cfg.system_name,
                                       box_length=cfg.box_length,
                                       save_dir=None, **ansatz))
        params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(
            {k: v.numpy() for k, v in port.model.state_dict().items()}))

        @jax.jit
        def local_energy(x):
            return (trainer.h_fn(params, x)[:, 0]
                    / _safe_psi(trainer.psi(params, x)))

        x = port.model.sample(SR_WALKERS,
                              generator=torch.Generator().manual_seed(0))
        el = (port.h_fn(x)[:, 0] / port.model.psi(x)).detach().double().numpy()
        el_jax = np.asarray(local_energy(jnp.asarray(x.detach().numpy())),
                            np.float64)
        e_ed, psi_pairs, grid = exact_ground_state_2p(port.protons,
                                                      cfg.box_length)
        print(json.dumps({
            'key': key, 'epoch': int(state['epoch']), 'walkers': SR_WALKERS,
            'el_mean_port': float(el.mean()),
            'el_mean_jax': float(el_jax.mean()),
            'max_rel_jax_minus_port': float(
                (np.abs(el_jax - el) / np.maximum(np.abs(el), 1.0)).max()),
            'ed120_energy': float(e_ed),
            'fidelity_port': float(fidelity_2p(port.model.psi, psi_pairs,
                                               grid, device='cpu')),
            'fidelity_jax': float(jax_fidelity_2p(trainer.psi, params,
                                                  psi_pairs, grid))}),
            flush=True)


def _tails(row: dict) -> dict:
    out = {}
    if 'tail' in row:
        out['row'] = row['tail']
    for seed, entry in row.get('eval_seeds', {}).items():
        if 'tail' in entry:
            out[f'seed{seed}'] = entry['tail']
    return out


def main(rows_path: str, keys: list) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from waveflow_tpu.utils.fidelity import fidelity_2d_2e
    from waveflow_tpu.vmc import VMCConfig, VMCTrainer
    from waveflow_tpu.vmc.estimators import _safe_psi
    from waveflow_tpu_torch.convert import params_to_jax
    from waveflow_tpu_torch.utils.checkpoint import load_state

    jax.config.update('jax_default_matmul_precision', 'highest')
    r5 = _round5()
    plan = {job.key: job for job in r5.plan()}
    rows_path = Path(rows_path)
    rows = json.loads(rows_path.read_text())
    for key in keys:
        row = rows[key]
        job = plan[key.split('_seed')[0]]
        cfg = dict(job.cfg, seed=row.get('seed', job.cfg.get('seed')))
        state = load_state(rows_path.parent / f'r5_{key}' / 'checkpoints')
        trainer = VMCTrainer(VMCConfig(save_dir=None, **cfg))
        params = jax.tree_util.tree_map(jnp.asarray,
                                        params_to_jax(state['params']))
        trainer.params = params

        @jax.jit
        def local_energy(x):
            return (trainer.h_fn(params, x)[:, 0]
                    / _safe_psi(trainer.psi(params, x)))

        out = {'key': key, 'epoch': int(state['epoch'])}
        for name, tail in _tails(row).items():
            x = np.asarray([r['x'] for r in tail['rows']], np.float32)
            el_jax = np.asarray(local_energy(jnp.asarray(x)), np.float64)
            el = np.asarray([r['el'] for r in tail['rows']])
            el64 = np.asarray([r.get('el_float64', np.nan)
                               for r in tail['rows']])
            out[name] = {
                'el_jax': el_jax.tolist(),
                'max_abs_jax_minus_port': float(np.abs(el_jax - el).max()),
                'max_abs_jax_minus_port_float64':
                    float(np.abs(el_jax - el64).max()),
                'max_rel_jax_minus_port': float(
                    (np.abs(el_jax - el) / np.maximum(np.abs(el), 1.0))
                    .max())}
        if 'fidelity_ed40' in row:
            ed = np.load(ROOT / 'results' / f"ed40_{job.post['ed']}_2d2e.npz")
            psi_ed = (ed['psi'][:, 0] if job.post['n_states'] == 1
                      else ed['psi'])
            out['fidelity_jax'] = float(fidelity_2d_2e(
                trainer.psi, params, psi_ed, ed['sites'], ed['x']))
            out['fidelity_port'] = row['fidelity_ed40']
        print(json.dumps(out), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    if Path(sys.argv[1]).name == 'sr_study.json':
        main_sr(Path(sys.argv[1]), sys.argv[2:])
    else:
        main(sys.argv[1], sys.argv[2:])
