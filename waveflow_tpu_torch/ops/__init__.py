from waveflow_tpu_torch.ops.spline_tables import (
    SplineTables, BSplineTables, get_tables,
    build_mspline_tables, build_ispline_tables, build_bspline_tables,
    make_knots,
)
from waveflow_tpu_torch.ops.spline_eval import SplineEvaluator, make_evaluator
from waveflow_tpu_torch.ops.poly_eval import (
    PolySplineEvaluator, build_local_polynomials, make_poly_evaluator,
    sample_squared_amplitude_poly,
)
from waveflow_tpu_torch.ops.boundary import (
    make_boundary_projector, make_bias_remover,
)
from waveflow_tpu_torch.ops.inverse import (
    batched_monotone_inverse, bisection_inverse, exact_node_bisect_inverse,
    exact_table_inverse,
)
from waveflow_tpu_torch.ops.sampling import (
    sample_linear_density, sample_squared_amplitude,
)
from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler, cuda_spline

# the kernel wrappers' launch counters, as (module, attribute): each wrapper
# adds one where it launches its kernel; a replayed CUDA graph launches
# without passing through them, so vmc/graphs.py adds a replay's count here
LAUNCH_COUNTERS = ((cuda_jet, 'launches'), (cuda_sampler, 'launches'),
                   (cuda_sampler, 'launches_linear'), (cuda_spline, 'launches'),
                   (cuda_spline, 'launches_bwd'), (cuda_spline, 'launches_pair'),
                   (cuda_spline, 'launches_jet'),
                   (cuda_spline, 'launches_bwd_jet'))


def read_launches() -> tuple:
    return tuple(getattr(m, a) for m, a in LAUNCH_COUNTERS)


def set_launches(counts) -> None:
    for (m, a), n in zip(LAUNCH_COUNTERS, counts):
        setattr(m, a, n)


def add_launches(counts) -> None:
    set_launches(a + b for a, b in zip(read_launches(), counts))
