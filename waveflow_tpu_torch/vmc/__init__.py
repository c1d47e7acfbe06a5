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
    record_tail,
)
from waveflow_tpu_torch.vmc.hmc import (
    HMCState, make_hmc_sampler, make_parameter_posterior,
)
from waveflow_tpu_torch.vmc.nuts import NUTSDraws, NUTSState, make_nuts_sampler
from waveflow_tpu_torch.vmc.smc import (
    SMCDraws, SMCState, make_smc_sampler, systematic_resample,
)
from waveflow_tpu_torch.vmc.trainer import VMCConfig, VMCTrainer
