"""contrib.fmha: fused multihead attention on packed variable-length
batches, the port of ``apex_tpu.contrib.fmha`` (the reference's
``apex/contrib/fmha``).

qkv is packed as (total_tokens, 3, H, D) with ``cu_seqlens`` (B+1,)
prefix offsets, and attention runs inside each sequence.  The packed
layout stays whole: the sequences become segment ids, and one
:func:`flash_attention` call over (1, H, total, D) masks the pairs
across sequences and, in training, drops probabilities with the
kernels' counter hash.  Tokens past ``cu_seqlens[-1]`` (the buffer's
padding) get the ids -1 on the q side and -2 on the kv side, so they see
nothing and output exact zeros.  The (1, H, total, D) views are strided;
the kernels' wrapper copies them.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import draw_seed, flash_attention


def _segment_ids(cu_seqlens: torch.Tensor, total: int) -> torch.Tensor:
    """token index -> sequence index, from (B+1,) prefix offsets."""
    pos = torch.arange(total, device=cu_seqlens.device,
                       dtype=cu_seqlens.dtype)
    return torch.searchsorted(cu_seqlens[1:], pos, right=True)


def fmha_packed(qkv: torch.Tensor, cu_seqlens: torch.Tensor,
                p_dropout: float = 0.0, *, is_training: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_seed=None, causal: bool = False) -> torch.Tensor:
    """qkv (total, 3, H, D), cu_seqlens (B+1,) integer -> (total, H, D).

    Dropout (``p_dropout > 0`` and ``is_training``) takes
    ``dropout_seed`` (an int32) or one seed drawn from ``generator``, as
    ``SelfMultiheadAttn`` does."""
    total, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"fmha_packed takes qkv as (total, 3, H, D), got "
                         f"{tuple(qkv.shape)}")
    cu = cu_seqlens.to(qkv.device)
    seg = _segment_ids(cu, total).to(torch.int32)
    valid = torch.arange(total, device=qkv.device) < cu[-1]
    q_ids = torch.where(valid, seg, -1)[None]          # (1, total)
    kv_ids = torch.where(valid, seg, -2)[None]
    q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
    rate = float(p_dropout) if is_training else 0.0
    out = flash_attention(q, k, v, causal=causal,
                          segment_ids=(q_ids, kv_ids), dropout_rate=rate,
                          dropout_seed=draw_seed(rate, generator,
                                                 dropout_seed))
    return out[0].transpose(0, 1).to(qkv.dtype)


class FMHAFun:
    """The reference's ``apex.contrib.fmha.FMHAFun.apply`` facade;
    differentiable through autograd."""

    @staticmethod
    def apply(qkv, cu_seqlens, p_dropout=0.0, max_s=None, is_training=True,
              generator=None, dropout_seed=None):
        del max_s   # one flash call over the packed buffer needs no max_s
        return fmha_packed(qkv, cu_seqlens, p_dropout,
                           is_training=is_training, generator=generator,
                           dropout_seed=dropout_seed)
