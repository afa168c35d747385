"""Mixed precision (port of ``apex_tpu.amp``): O0/O2/O3 policies,
dynamic loss scaling on the device, and the flat gradient pipeline."""

from apex_tpu_torch.amp.flat_pipeline import (FlatGradPipeline,  # noqa: F401
                                              FlatGrads, GradAccum)
from apex_tpu_torch.amp.frontend import (AmpState, cast_inputs,  # noqa: F401
                                         initialize,
                                         master_params_to_model_params,
                                         update_scaler)
from apex_tpu_torch.amp.policies import (Properties,  # noqa: F401
                                         opt_level_properties)
from apex_tpu_torch.amp.scaler import (LossScaleConfig,  # noqa: F401
                                       LossScaleState, check_finite,
                                       scale_loss, scaled_value_and_grad,
                                       unscale_grads, update_state,
                                       value_and_grad)
