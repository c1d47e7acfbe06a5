from waveflow_tpu_torch.physics.systems import system_catalogue
from waveflow_tpu_torch.physics.hamiltonian import (
    construct_hamiltonian_function, get_potential,
    laplacian_and_value_batched,
)
