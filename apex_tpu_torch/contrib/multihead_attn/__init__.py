"""Fused multihead attention (port of ``apex_tpu.contrib.multihead_attn``):
``SelfMultiheadAttn`` so far; ``EncdecMultiheadAttn`` is ROADMAP Queue 1
slice 4 item 11b."""

from apex_tpu_torch.contrib.multihead_attn.self_multihead_attn import \
    SelfMultiheadAttn  # noqa: F401

__all__ = ["SelfMultiheadAttn"]
