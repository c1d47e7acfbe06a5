from waveflow_tpu_torch.vmc.estimators import (
    make_loss_fn, make_train_step, run_window,
)
from waveflow_tpu_torch.vmc.trainer import VMCConfig, VMCTrainer
