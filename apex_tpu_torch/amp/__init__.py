"""Mixed precision (port of ``apex_tpu.amp``): the O0-O3 policies, the
O1 op-list rewrite (:func:`auto_cast`), dynamic loss scaling on the
device, and the flat gradient pipeline."""

from apex_tpu_torch.amp.flat_pipeline import (FlatGradPipeline,  # noqa: F401
                                              FlatGrads, GradAccum)
from apex_tpu_torch.amp import lists  # noqa: F401
from apex_tpu_torch.amp.frontend import (AmpState, initialize,  # noqa: F401
                                         load_state_dict,
                                         master_params_to_model_params,
                                         state_dict, update_scaler)
from apex_tpu_torch.amp.policies import (Policy, Properties,  # noqa: F401
                                         opt_level_properties)
from apex_tpu_torch.amp.scaler import (LossScaleConfig,  # noqa: F401
                                       LossScaleState, check_finite,
                                       scale_loss, scaled_value_and_grad,
                                       unscale_grads, update_state,
                                       value_and_grad)
from apex_tpu_torch.amp.wrap import auto_cast, cast_inputs  # noqa: F401
