"""Operators of the port whose TPU counterparts are Pallas kernels."""

from apex_tpu_torch.ops.attention import (attention_ref,  # noqa: F401
                                          flash_attention,
                                          flash_attention_ref,
                                          packed_segment_ids)
from apex_tpu_torch.ops.layer_norm import (fused_layer_norm,  # noqa: F401
                                           fused_rms_norm, layer_norm_ref,
                                           rms_norm_ref)
from apex_tpu_torch.ops.multi_tensor import (flat_accumulate,  # noqa: F401
                                             flat_accumulate_ref, flat_adagrad,
                                             flat_adagrad_ref, flat_adam,
                                             flat_adam_ref, flat_axpby,
                                             flat_axpby_ref, flat_l2norm,
                                             flat_l2norm_ref, flat_lamb,
                                             flat_lamb_ref, flat_novograd,
                                             flat_novograd_ref, flat_scale,
                                             flat_scale_ref,
                                             flat_segment_sumsq, flat_sgd,
                                             flat_sgd_ref, flat_unscale_norm,
                                             flat_unscale_norm_ref)
from apex_tpu_torch.ops.xentropy import (softmax_cross_entropy,  # noqa: F401
                                         softmax_cross_entropy_ref)
