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
    batched_monotone_inverse, exact_node_bisect_inverse, exact_table_inverse,
)
from waveflow_tpu_torch.ops.sampling import (
    sample_linear_density, sample_squared_amplitude,
)
