from waveflow_tpu_torch.bijections.core import MADE, Reverse, Serial
from waveflow_tpu_torch.bijections.imade import IMADE
from waveflow_tpu_torch.bijections.box_transform import BoxTransform
from waveflow_tpu_torch.bijections.masks import (
    MaskedConditioner, MaskedMLP, made_masks, masked_conditioner,
    simple_masked_transform,
)
