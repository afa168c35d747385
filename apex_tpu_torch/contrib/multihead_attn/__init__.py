"""Fused multihead attention (port of ``apex_tpu.contrib.multihead_attn``):
``SelfMultiheadAttn`` and ``EncdecMultiheadAttn``."""

from apex_tpu_torch.contrib.multihead_attn.encdec_multihead_attn import \
    EncdecMultiheadAttn  # noqa: F401
from apex_tpu_torch.contrib.multihead_attn.self_multihead_attn import \
    SelfMultiheadAttn  # noqa: F401

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]
