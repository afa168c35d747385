"""FusedScaleMaskSoftmax: the port of
``apex_tpu.transformer.functional.fused_softmax``.

A stateless callable with the reference's constructor surface and
routing: the causal mask type goes to the upper-triangular op on a
``(b * np, sq, sk)`` view (sq must equal sk); a ``mask_func`` with a
mask and fusion off is plain torch (the reference's "torch fallback");
everything else goes to the masked op, which takes ``mask=None`` too.
The ops run the kernels of :mod:`apex_tpu_torch.ops.softmax` on their
gate for a tensor on the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops import softmax as softmax_ops
from apex_tpu_torch.transformer.enums import AttnMaskType


class FusedScaleMaskSoftmax:
    """``x`` (b, np, sq, sk) -> softmax over sk of ``x * scale`` (scale 1
    when None) under the mask type's mask.  The two flags and
    ``softmax_in_fp32`` are checked as the reference checks them and not
    read otherwise: every path computes in f32 and returns x's dtype."""

    def __init__(self,
                 input_in_fp16: bool = False,
                 input_in_bf16: bool = True,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        if input_in_fp16 and input_in_bf16:
            raise AssertionError(
                "both fp16 and bf16 flags cannot be active at the same time.")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if not (self.scale is None or softmax_in_fp32):
            raise AssertionError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        return (self.scaled_masked_softmax_fusion
                and sk % 128 == 0 and sk <= softmax_ops._MAX_SK)

    def __call__(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        scale = self.scale if self.scale is not None else 1.0
        b, np_, sq, sk = x.shape
        if self.attn_mask_type == AttnMaskType.causal:
            # a silent fall-through would drop causality entirely
            if sq != sk:
                raise AssertionError(
                    "causal mask requires square attention (sq == sk)")
            y = softmax_ops.scaled_upper_triang_masked_softmax(
                x.reshape(-1, sq, sk), scale)
            return y.reshape(x.shape)
        if self.mask_func is not None and mask is not None and \
                not self.scaled_masked_softmax_fusion:
            xf = self.mask_func(x.float() * scale, mask)
            return torch.softmax(xf, dim=-1).to(x.dtype)
        return softmax_ops.scaled_masked_softmax(x, mask, scale)


scaled_masked_softmax = softmax_ops.scaled_masked_softmax
scaled_upper_triang_masked_softmax = \
    softmax_ops.scaled_upper_triang_masked_softmax
generic_scaled_masked_softmax = softmax_ops.generic_scaled_masked_softmax
