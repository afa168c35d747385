"""apex.contrib.xentropy's API: the port of
``apex_tpu.contrib.xentropy.softmax_xentropy``.

Losses at ``padding_idx`` are zeroed with a ``torch.where`` outside the
fused op, which differentiates to the reference's masked backward.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.xentropy import softmax_cross_entropy


def softmax_cross_entropy_loss(logits, labels, smoothing=0.0, padding_idx=0,
                               half_to_float=False):
    """Per-example losses ``(N,)``, zero where ``labels == padding_idx``."""
    losses = softmax_cross_entropy(logits, labels, smoothing, half_to_float)
    return torch.where(labels == padding_idx, torch.zeros_like(losses),
                       losses)


class SoftmaxCrossEntropyLoss:
    """The reference's autograd.Function surface:
    ``SoftmaxCrossEntropyLoss.apply(logits, labels, ...)``."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)
