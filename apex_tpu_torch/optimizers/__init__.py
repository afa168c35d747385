"""Fused optimizers of the port: FusedSGD (the ImageNet path's),
FusedLAMB (BERT's) and FusedAdam (the GPT block's)."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB, FusedMixedPrecisionLamb)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
