from waveflow_tpu_torch.benchmark.datasets import get_dataset
from waveflow_tpu_torch.benchmark.metrics import (
    held_out_log_likelihood, kde_bandwidth_sweep, kde_metrics,
    reconstruction_distance,
)
from waveflow_tpu_torch.benchmark.density import (
    get_benchmark_model, train_density_model,
)
