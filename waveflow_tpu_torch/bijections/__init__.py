from waveflow_tpu_torch.bijections.core import (
    ActNorm, AffineCoupling, AffineCouplingSplit, BatchNorm,
    FixedInvertibleLinear, Invert, InvertibleLinear, Logit, MADE, Reverse,
    Serial, Shuffle, Sigmoid, batchnorm_update_stats,
)
from waveflow_tpu_torch.bijections.imade import IMADE
from waveflow_tpu_torch.bijections.box_transform import (
    BoxTransform, BoxTransformLayer,
)
from waveflow_tpu_torch.bijections.masks import (
    MaskedConditioner, MaskedMLP, made_masks, masked_conditioner, masked_mlp,
    simple_masked_transform,
)
from waveflow_tpu_torch.bijections.rqs import (
    NeuralSplineCoupling, rational_quadratic_spline,
)
