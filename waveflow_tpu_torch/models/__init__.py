from waveflow_tpu_torch.models.flow import Flow, InvFlow
from waveflow_tpu_torch.models.priors import GMM, Normal, Uniform
from waveflow_tpu_torch.models.mflow import MFlow
from waveflow_tpu_torch.models.waveflow import Waveflow
from waveflow_tpu_torch.models.factory import get_model, get_waveflow_model
from waveflow_tpu_torch.models.antisym import (
    AntisymWaveflow, electron_permutation_table, get_antisym_waveflow_model,
)
