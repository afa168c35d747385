"""Shared core of the fused multihead-attention family: the port of
``apex_tpu.contrib.multihead_attn._common``.

Every variant shares one attention core: :func:`flash_attention` (the
hand-written kernels on the card) when no key-padding mask and no
attention weights are asked for; :func:`attention_ref` with a boolean
or additive key-padding mask; and an inline softmax when the weights
are returned.  Probability dropout takes the kernels' counter hash on
all three (:func:`dropout_keep_ref`), so turning ``need_weights`` on or
off never changes which pairs drop.  Inputs are (T, B, E) seq-first,
the reference's contract; heads are split and merged here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch.ops.attention import (attention_ref, dropout_keep_ref,
                                          flash_attention)

_NEG = -10000.0


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(T, B, E) -> (B, H, T, Dh), a view."""
    t, b, e = x.shape
    return x.reshape(t, b, num_heads, e // num_heads).permute(1, 2, 0, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (T, B, E)."""
    b, h, t, d = x.shape
    return x.permute(2, 0, 1, 3).reshape(t, b, h * d)


def attention_core(q, k, v, *, causal: bool,
                   key_padding_mask: Optional[torch.Tensor],
                   mask_additive: bool, dropout_rate: float = 0.0,
                   dropout_seed=None, need_weights: bool = False):
    """(B, H, T, Dh) attention with the reference's masking semantics.

    ``key_padding_mask``: (B, Sk), boolean (nonzero = masked) or, with
    ``mask_additive``, an additive float mask.  ``dropout_seed``: an
    int32 (int or one-element tensor), needed when ``dropout_rate >
    0``.  Returns ``(out (B, H, Tq, Dh), probs (B, H, Tq, Sk) f32 or
    None)``; the probabilities returned are the undropped ones."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if key_padding_mask is None and not need_weights:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed), None

    mask = None
    if key_padding_mask is not None:
        if mask_additive:
            mask = key_padding_mask.float()[:, None, None, :]
        else:
            mask = torch.where(key_padding_mask[:, None, None, :] != 0,
                               _NEG, 0.0)
    if not need_weights:
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             mask=mask, dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed), None

    # the weights are returned: the inline softmax
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask
    if causal:
        sq, sk = s.shape[-2:]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(col > row, _NEG)
    p = torch.softmax(s, dim=-1)
    p_drop = p
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("attention_core: dropout_rate > 0 requires "
                             "dropout_seed")
        keep = dropout_keep_ref(dropout_seed, *p.shape, dropout_rate,
                                p.device)
        # the reference divides by the f32 (1 - rate); a 0-dim tensor on
        # p's device keeps it a division on the card too
        p_drop = torch.where(keep, p / torch.full(
            (), 1.0 - dropout_rate, device=p.device), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p_drop, v.float()).to(q.dtype)
    return out, p
