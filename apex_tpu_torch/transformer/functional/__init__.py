"""The port of ``apex_tpu.transformer.functional``: the fused softmax
(with its kernels) and RoPE.  The reference's ``fp8_matmul`` waits for
the fp8 work (ROADMAP Queue 1, item 17)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_cached,
)

__all__ = [
    "FusedScaleMaskSoftmax",
    "generic_scaled_masked_softmax",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
    "fused_apply_rotary_pos_emb",
    "fused_apply_rotary_pos_emb_cached",
]
