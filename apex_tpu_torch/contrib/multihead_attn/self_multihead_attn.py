"""SelfMultiheadAttn: the port of
``apex_tpu.contrib.multihead_attn.self_multihead_attn`` (the reference's
``apex/contrib/multihead_attn/self_multihead_attn.py``).

(T, B, E) inputs; one packed (E, 3E) in-projection, or separate q/k/v
projections; 1/sqrt(Dh) scaling; the optional fused "norm-add"
(LayerNorm on the input, residual add on the output); boolean or
additive key-padding masks; an optional causal attention mask.  As in
the port's models, the module is an object holding its settings:
``init(generator, device)`` returns its parameters as a nested dict
(flax's names, with ``weight`` for a projection's ``(in, out)`` kernel
and ``norm`` for the norm-add LayerNorm), and ``__call__(params,
query, ...)`` applies it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn._common import (attention_core,
                                                           merge_heads,
                                                           split_heads)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.transformer.tensor_parallel import ColumnParallelLinear


class SelfMultiheadAttn:
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False,
                 mask_additive: bool = False, impl: str = "fast",
                 param_dtype: torch.dtype = torch.float32):
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive = mask_additive
        self.impl = impl        # accepted for parity; both map to the core
        self.param_dtype = param_dtype
        self.norm = FusedLayerNorm(embed_dim, param_dtype=param_dtype)
        # flax Dense(dtype=x.dtype): the layers compute in the input's dtype
        self.proj = ColumnParallelLinear(embed_dim, embed_dim, bias=bias,
                                         params_dtype=param_dtype)
        self.qkv = ColumnParallelLinear(embed_dim, 3 * embed_dim, bias=bias,
                                        params_dtype=param_dtype)

    def init(self, generator: torch.Generator, device=None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        """f32 (``param_dtype``) parameters, drawn on the CPU from
        ``generator`` in flax's order of creation."""
        dev = resolve_device(device)
        p = {}
        if self.include_norm_add:
            p["norm"] = self.norm.init(dev)
        if self.separate_qkv_params:
            for name in ("q_proj", "k_proj", "v_proj"):
                p[name] = self.proj.init(generator, dev)
        else:
            p["qkv_proj"] = self.qkv.init(generator, dev)
        p["out_proj"] = self.proj.init(generator, dev)
        return p

    def __call__(self, params: Dict, query: torch.Tensor, key=None,
                 value=None, *,
                 key_padding_mask: Optional[torch.Tensor] = None,
                 need_weights: bool = False, attn_mask: Optional[str] = None,
                 is_training: bool = True):
        """``query`` (T, B, E); ``key``/``value`` are accepted for the
        reference's signature (self-attention uses ``query`` for all
        three).  ``attn_mask``: None or ``"causal"``.  Returns ``(out (T,
        B, E), probs or None)``."""
        if attn_mask not in (None, "causal"):
            raise ValueError(f"attn_mask must be None or 'causal', got "
                             f"{attn_mask!r}")
        residual = x = query
        if self.include_norm_add:
            x = self.norm(params["norm"], x)
        if self.separate_qkv_params:
            q, k, v = (self.proj(params[n], x)
                       for n in ("q_proj", "k_proj", "v_proj"))
        else:
            q, k, v = torch.chunk(self.qkv(params["qkv_proj"], x), 3, dim=-1)
        q, k, v = (split_heads(t, self.num_heads) for t in (q, k, v))
        out, probs = attention_core(
            q, k, v, causal=attn_mask == "causal",
            key_padding_mask=key_padding_mask,
            mask_additive=self.mask_additive,
            dropout_rate=self.dropout if is_training else 0.0,
            need_weights=need_weights)
        out = self.proj(params["out_proj"], merge_heads(out))
        if self.include_norm_add:
            out = out + residual
        return out, probs
