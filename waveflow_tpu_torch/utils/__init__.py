from waveflow_tpu_torch.utils.checkpoint import (
    load_state, save_state, save_state_multihost,
)
from waveflow_tpu_torch.utils.observables import (
    clipped_energy_estimate, median_energy_estimate, moving_average,
    uniform_sliding_average, uniform_sliding_stdev,
)
from waveflow_tpu_torch.utils.fidelity import (
    fidelity_2d_1e, fidelity_2d_2e, fidelity_2p, fidelity_3p,
)
