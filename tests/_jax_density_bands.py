"""The JAX package's side of the density bands that the port's card runs
are held to (examples/rqs_row_torch.py), on the CPU:

    JAX_PLATFORMS=cpu python tests/_jax_density_bands.py rqs 5,1,3,11
    JAX_PLATFORMS=cpu python tests/_jax_density_bands.py gm 5,1,3

'rqs': RQSFlow (3 layers) on benchmarks/circles_parity.py's circles split
(1,000 train, 2,000 held out), 12,000 epochs at lr 1e-4, as
benchmarks/rqs_row.py trains it; 'gm': MFlow (reg 0.05, degree 5, 15
knots) on the same split of ``get_dataset('gaussian_mixtures', 3000,
seed=42)``.  One JSON line per seed: the last training loss, the held-out
mean log-likelihood at the end and at each metric checkpoint, wall
seconds.  Writes no file.  Not a test module: a helper the test suite does
not collect."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'benchmarks'))


def main(which: str, seeds: str) -> None:
    from circles_parity import get_split
    from waveflow_tpu.benchmark import get_dataset
    from waveflow_tpu.benchmark.density import train_density_model
    from waveflow_tpu.benchmark.metrics import held_out_log_likelihood
    if which == 'rqs':
        X, X_test = get_split()
        kw = dict(model_name='RQSFlow', n_flow_layers=3, log_every=3000)
    elif which == 'gm':
        Z = get_dataset('gaussian_mixtures', n_samples=3000, margin=0.025,
                        seed=42)
        X, X_test = Z[:1000], Z[1000:]
        kw = dict(model_name='MFlow', spline_reg=0.05, n_flow_layers=3,
                  spline_degree=5, n_knots=15, log_every=6000)
    else:
        raise SystemExit(f"unknown band {which!r}: 'rqs' or 'gm'")
    for seed in (int(s) for s in seeds.split(',')):
        t0 = time.time()
        params, log_pdf, _, hist = train_density_model(
            X, num_epochs=12000, learning_rate=1e-4, seed=seed,
            X_test=X_test, verbose=False, **kw)
        print(json.dumps({
            'band': which, 'seed': seed,
            'train_loss': float(hist['losses'][-1]),
            'test_ll': float(held_out_log_likelihood(log_pdf, params,
                                                     X_test)),
            'test_ll_hist': [float(v) for v in hist['test_ll']],
            'wall_s': round(time.time() - t0, 1)}), flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:3])
