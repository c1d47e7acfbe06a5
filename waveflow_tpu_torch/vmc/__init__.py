from waveflow_tpu_torch.vmc.estimators import (
    local_energy, loss_fn_uniform, make_loss_fn, make_policy_gradient_step,
    make_train_step, run_window,
)
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_mcmc_train_window, make_metropolis_sampler,
    sector_projection,
)
from waveflow_tpu_torch.vmc.mala import MALAState, make_mala_sampler
from waveflow_tpu_torch.vmc.evaluate import (
    EnergyEvaluation, block_statistics, evaluate_energy, evaluate_trainer,
)
from waveflow_tpu_torch.vmc.trainer import VMCConfig, VMCTrainer
