from waveflow_tpu_torch.physics.systems import system_catalogue
from waveflow_tpu_torch.physics.hamiltonian import (
    construct_hamiltonian_function, get_potential, laplacian,
    laplacian_and_value, laplacian_and_value_batched,
    laplacian_dense_hessian, laplacian_hvp, laplacian_numerical,
)
from waveflow_tpu_torch.physics.fermion import (
    abs2rel, antisymmetrize, inversion_count, parity, rel2abs,
    sort_and_parity,
)
from waveflow_tpu_torch.physics.exact import (
    exact_free_fermion_energy, exact_free_fermion_energy_2d,
    exact_ground_state_1d, exact_ground_state_1p,
    richardson_ground_energy_1d,
    exact_ground_state_2d_1e, exact_ground_state_2d_2e,
    exact_ground_state_2p, exact_ground_state_3p,
)
