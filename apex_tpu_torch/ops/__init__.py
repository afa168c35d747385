"""Operators of the port whose TPU counterparts are Pallas kernels."""

from apex_tpu_torch.ops.attention import (attention_ref,  # noqa: F401
                                          dropout_keep_ref, flash_attention,
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
from apex_tpu_torch.ops.rope import (fused_apply_rotary_pos_emb,  # noqa: F401
                                     rope_ref)
from apex_tpu_torch.ops.softmax import (  # noqa: F401
    generic_scaled_masked_softmax, scaled_masked_softmax,
    scaled_masked_softmax_ref, scaled_upper_triang_masked_softmax,
    scaled_upper_triang_masked_softmax_ref, softmax_vjp_ref)
from apex_tpu_torch.ops.welford import (welford_combine,  # noqa: F401
                                        welford_mean_var,
                                        welford_mean_var_ref)
from apex_tpu_torch.ops.xentropy import (softmax_cross_entropy,  # noqa: F401
                                         softmax_cross_entropy_ref,
                                         xent_bwd_ref, xent_fwd_ref)
