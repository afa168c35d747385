"""Fused optimizers of the port: FusedSGD (the ImageNet path's),
FusedLAMB (BERT's), FusedAdam (the GPT block's), and FusedNovoGrad and
FusedAdagrad (the optimizer tail)."""

from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB, FusedMixedPrecisionLamb)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
