"""The legacy manual mixed-precision API (the port of
``apex_tpu.fp16_utils``): FP16_Optimizer, the loss scalers and the
fp16util tree helpers."""

from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    BN_convert_float, master_params_to_model_params,
    model_grads_to_master_grads, network_to_half, prep_param_lists,
    to_python_float, tree_to_half)
from apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    DynamicLossScaler, LossScaler)
from apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer)

__all__ = [
    "BN_convert_float", "DynamicLossScaler", "FP16_Optimizer",
    "LossScaler", "master_params_to_model_params",
    "model_grads_to_master_grads", "network_to_half", "prep_param_lists",
    "to_python_float", "tree_to_half",
]
