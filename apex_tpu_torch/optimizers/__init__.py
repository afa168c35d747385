"""Fused optimizers of the port: FusedSGD (the ImageNet path's) and
FusedLAMB (BERT's)."""

from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB, FusedMixedPrecisionLamb)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
