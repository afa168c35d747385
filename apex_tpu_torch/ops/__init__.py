"""Operators of the port whose TPU counterparts are Pallas kernels."""

from apex_tpu_torch.ops.attention import (attention_ref,  # noqa: F401
                                          flash_attention,
                                          flash_attention_ref,
                                          packed_segment_ids)
from apex_tpu_torch.ops.multi_tensor import (flat_accumulate,  # noqa: F401
                                             flat_accumulate_ref, flat_sgd,
                                             flat_sgd_ref, flat_unscale_norm,
                                             flat_unscale_norm_ref)
