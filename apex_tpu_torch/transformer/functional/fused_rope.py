"""Fused RoPE wrappers: the port of
``apex_tpu.transformer.functional.fused_rope``."""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb, rope_ref


def fused_apply_rotary_pos_emb_cached(t, cos, sin, interleaved=False):
    """Variant taking precomputed cos/sin (the reference's cached API):
    the angles are recovered as ``atan2(sin, cos)`` in f32.

    cos/sin: (s, 1, 1, hn)."""
    freqs = torch.atan2(sin.float(), cos.float())
    return fused_apply_rotary_pos_emb(t, freqs, interleaved)


__all__ = ["fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached", "rope_ref"]
