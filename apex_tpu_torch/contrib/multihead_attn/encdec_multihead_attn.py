"""EncdecMultiheadAttn: the port of
``apex_tpu.contrib.multihead_attn.encdec_multihead_attn`` (the
reference's ``apex/contrib/multihead_attn/encdec_multihead_attn.py``).

Cross-attention: q projected from the decoder's query (``q_proj``), k
and v from the encoder's memory through one packed (E, 2E) projection
(``kv_proj``): value must be key, as the reference asserts.  The rest is
``SelfMultiheadAttn``'s: 1/sqrt(Dh) scaling, probability dropout in
training, the optional norm-add, boolean or additive key-padding masks
and ``attn_mask="causal"`` as the only attention mask.  Parameters carry
flax's names (``weight`` for a projection's ``(in, out)`` kernel,
``norm`` for the norm-add LayerNorm); ``convert.gpt_block_from_jax``'s
renames convert the flax module's params.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn._common import (attention_core,
                                                           merge_heads,
                                                           split_heads)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import draw_seed
from apex_tpu_torch.transformer.tensor_parallel import ColumnParallelLinear


class EncdecMultiheadAttn:
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 mask_additive: bool = False, impl: str = "fast",
                 param_dtype: torch.dtype = torch.float32):
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.mask_additive = mask_additive
        self.impl = impl        # accepted for parity; both map to the core
        self.param_dtype = param_dtype
        self.norm = FusedLayerNorm(embed_dim, param_dtype=param_dtype)
        self.proj = ColumnParallelLinear(embed_dim, embed_dim, bias=bias,
                                         params_dtype=param_dtype)
        self.kv = ColumnParallelLinear(embed_dim, 2 * embed_dim, bias=bias,
                                       params_dtype=param_dtype)

    def init(self, generator: torch.Generator, device=None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        """f32 (``param_dtype``) parameters, drawn on the CPU from
        ``generator`` in flax's order of creation."""
        dev = resolve_device(device)
        p = {}
        if self.include_norm_add:
            p["norm"] = self.norm.init(dev)
        p["q_proj"] = self.proj.init(generator, dev)
        p["kv_proj"] = self.kv.init(generator, dev)
        p["out_proj"] = self.proj.init(generator, dev)
        return p

    def __call__(self, params: Dict, query: torch.Tensor, key: torch.Tensor,
                 value=None, *,
                 key_padding_mask: Optional[torch.Tensor] = None,
                 need_weights: bool = False, attn_mask: Optional[str] = None,
                 is_training: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed=None):
        """``query`` (Tq, B, E), ``key`` (Tk, B, E), ``value`` None or
        ``key``.  ``key_padding_mask`` (B, Tk).  The rest as
        ``SelfMultiheadAttn.__call__``.  Returns ``(out (Tq, B, E),
        probs or None)``."""
        if value is not None and value is not key:
            raise ValueError("EncdecMultiheadAttn packs k and v from the "
                             "same memory: value must be key")
        residual = x = query
        if self.include_norm_add:
            x = self.norm(params["norm"], x)
        q = self.proj(params["q_proj"], x)
        k, v = torch.chunk(self.kv(params["kv_proj"], key), 2, dim=-1)
        q, k, v = (split_heads(t, self.num_heads) for t in (q, k, v))
        rate = self.dropout if is_training else 0.0
        out, probs = attention_core(
            q, k, v, causal=attn_mask == "causal",
            key_padding_mask=key_padding_mask,
            mask_additive=self.mask_additive, dropout_rate=rate,
            dropout_seed=draw_seed(rate, generator, dropout_seed),
            need_weights=need_weights)
        out = self.proj(params["out_proj"], merge_heads(out))
        if self.include_norm_add:
            out = out + residual
        return out, probs
