"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine's
card and print its result line (see README.md):

    python3 perfbench/run.py --workload he1d-train-b256 --seed 7 \
        --seconds 30 --trace 0

Exits with a code other than 0, and prints no result, where there is no
card (or fewer than the cell asks for), or where the run loaded JAX or the
JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / 'perfbench' / '.cache'


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # kernel caches at fixed places inside the checkout
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    return harness.run(args, T0)


if __name__ == '__main__':
    sys.exit(main())
