"""The BERT encoder family as functions of a parameter tree.

The port of ``apex_tpu.models.bert`` (BASELINE config 3, BERT-Large
pretraining with FusedLAMB + FusedLayerNorm + contrib.xentropy): post-LN
residuals, tanh-GELU, learned positions, segment ("token type")
embeddings only when ``token_type_ids`` are given, and an MLM head tied
to the word embedding.  The parameters are a nested dict with the flax
model's names and layouts (``embed/weight`` ``(V, h)``,
``pos_embedding``, ``embed_layernorm``, ``layer_<i>/{attn_qkv,
attn_proj, attn_layernorm, mlp_fc1, mlp_fc2, mlp_layernorm}``, linear
weights ``(in, out)``), so the tree flattens, packs and checkpoints as
the reference's.

Attention: with an ``attention_mask`` (the padded batch) the additive
mask ``(1 - m) * -10000`` goes through :func:`attention_ref` (plain
f32, as in the reference); without one, or with a packed batch's
``segment_ids``, through :func:`flash_attention`, which on the card is
forward only until its backward kernels are ported (ROADMAP Queue 2 rows
2-3).

Precision is the reference's: every layer computes in ``dtype`` (bf16
under amp O2), the norms in f32 with the input's storage dtype, the
attention scores and the MLM logits in f32 from operands in ``dtype``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import (attention_ref, flash_attention,
                                          packed_segment_ids)
from apex_tpu_torch.transformer import tensor_parallel as tp

@functools.lru_cache(maxsize=None)
def _mm_has_out_dtype() -> bool:
    """Whether this torch's ``mm`` takes ``out_dtype`` (the ``mm.dtype``
    overload: an f32 result from bf16 operands on CUDA)."""
    return any(s.overload_name == "dtype"
               for s in torch._C._jit_get_schemas_for_operator("aten::mm"))


def f32_out_matmul_route(x: torch.Tensor) -> str:
    """How :func:`matmul_f32_out` computes for operands like ``x``:
    ``"mm_out_dtype"`` (one GEMM on the operands, f32 result) or
    ``"f32_gemm"`` (an f32 GEMM of the upcast operands)."""
    if (x.device.type == "cuda" and x.dtype != torch.float32
            and _mm_has_out_dtype()):
        return "mm_out_dtype"
    return "f32_gemm"


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w`` with an f32 result from operands in the compute dtype:
    the reference's ``jnp.dot(..., preferred_element_type=f32)``.  A
    bf16 ``torch.matmul`` would round the result to bf16.  The backward
    takes the f32 gradient through f32 GEMMs (the reference's transpose
    rule promotes the bf16 operand to f32) and returns each gradient in
    its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if f32_out_matmul_route(x) == "mm_out_dtype":
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.float().t(), g).to(w.dtype)
        return dx, dw


def matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(M, K) @ (K, N)`` -> f32 ``(M, N)``, operands as given."""
    return _MatmulF32Out.apply(x, w)


def _normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


class BertLayer:
    def __init__(self, hidden_size: int, num_heads: int,
                 ffn_hidden_size: Optional[int] = None,
                 sequence_parallel: bool = False,
                 dtype: torch.dtype = torch.float32):
        h = hidden_size
        ffn = ffn_hidden_size or 4 * h
        self.hidden_size, self.num_heads, self.dtype = h, num_heads, dtype
        sp = dict(sequence_parallel_enabled=sequence_parallel,
                  compute_dtype=dtype)
        self.attn_qkv = tp.ColumnParallelLinear(h, 3 * h, gather_output=False,
                                                **sp)
        self.attn_proj = tp.RowParallelLinear(h, h, input_is_parallel=True,
                                              **sp)
        self.mlp_fc1 = tp.ColumnParallelLinear(h, ffn, gather_output=False,
                                               **sp)
        self.mlp_fc2 = tp.RowParallelLinear(ffn, h, input_is_parallel=True,
                                            **sp)
        self.attn_layernorm = FusedLayerNorm(
            h, sequence_parallel=sequence_parallel)
        self.mlp_layernorm = FusedLayerNorm(
            h, sequence_parallel=sequence_parallel)

    def init(self, generator: torch.Generator, device=None) -> Dict:
        return {"attn_qkv": self.attn_qkv.init(generator, device),
                "attn_proj": self.attn_proj.init(generator, device),
                "attn_layernorm": self.attn_layernorm.init(device),
                "mlp_fc1": self.mlp_fc1.init(generator, device),
                "mlp_fc2": self.mlp_fc2.init(generator, device),
                "mlp_layernorm": self.mlp_layernorm.init(device)}

    def __call__(self, params: Dict, x: torch.Tensor,
                 attn_mask: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """x: (s, b, h); attn_mask: additive (b, 1, 1|s, s) or None;
        segment_ids: (b, s) packed-batch form (exclusive with
        attn_mask)."""
        if attn_mask is not None and segment_ids is not None:
            raise ValueError(
                "pass attn_mask OR segment_ids, not both (packed "
                "batches carry their mask in the segment ids)")
        head_dim = self.hidden_size // self.num_heads
        y = self.attn_qkv(params["attn_qkv"], x.to(self.dtype))
        s, b = y.shape[0], y.shape[1]
        y = y.reshape(s, b, self.num_heads, 3 * head_dim)
        q, k, v = (t.permute(1, 2, 0, 3) for t in torch.split(y, head_dim, -1))
        if attn_mask is None:
            seg = (None if segment_ids is None
                   else packed_segment_ids(segment_ids))
            attn = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), False, segment_ids=seg)
        else:
            attn = attention_ref(q, k, v, mask=attn_mask)
        attn = attn.permute(2, 0, 1, 3).reshape(s, b, self.hidden_size)
        x = self.attn_layernorm(
            params["attn_layernorm"],
            x + self.attn_proj(params["attn_proj"], attn).to(x.dtype))
        y = F.gelu(self.mlp_fc1(params["mlp_fc1"], x.to(self.dtype)),
                   approximate="tanh")
        return self.mlp_layernorm(
            params["mlp_layernorm"],
            x + self.mlp_fc2(params["mlp_fc2"], y).to(x.dtype))


class BertModel:
    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 num_layers: int, max_seq_len: int = 512,
                 type_vocab_size: int = 2, dtype: torch.dtype = torch.float32,
                 sequence_parallel: bool = False):
        self.vocab_size, self.hidden_size = vocab_size, hidden_size
        self.num_heads, self.num_layers = num_heads, num_layers
        self.max_seq_len, self.type_vocab_size = max_seq_len, type_vocab_size
        self.dtype = dtype
        self.embed = tp.VocabParallelEmbedding(vocab_size, hidden_size)
        self.embed_layernorm = FusedLayerNorm(hidden_size)
        self.layer = BertLayer(hidden_size, num_heads,
                               sequence_parallel=sequence_parallel,
                               dtype=dtype)

    def init(self, seed: int = 0, device=None,
             token_type_ids: bool = False) -> Dict:
        """f32 parameters on ``device`` (default: the card), drawn on the
        CPU from ``seed`` with flax's initializers.  The segment
        embedding exists only when ``token_type_ids`` (as flax creates it
        only when the init call passes them)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        h = self.hidden_size
        params = {"embed": self.embed.init(gen, dev),
                  "pos_embedding": _normal((self.max_seq_len, h), 0.02,
                                           gen).to(dev)}
        if token_type_ids:
            params["segment_embedding"] = _normal(
                (self.type_vocab_size, h), 0.02, gen).to(dev)
        params["embed_layernorm"] = self.embed_layernorm.init(dev)
        for i in range(self.num_layers):
            params[f"layer_{i}"] = self.layer.init(gen, dev)
        return params

    def apply(self, params: Dict, tokens: torch.Tensor,
              token_type_ids: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) -> the sequence output (s, b, h).

        ``attention_mask`` (b, s), 1 on real tokens: a padded batch.
        ``segment_ids`` / ``positions`` (both (b, s)): a packed batch,
        BOTH or NEITHER, exclusive with ``attention_mask``."""
        if (segment_ids is None) != (positions is None):
            raise ValueError(
                "packed batches need BOTH segment_ids and positions")
        if segment_ids is not None and attention_mask is not None:
            raise ValueError("pass attention_mask OR segment_ids, not both")
        b, s = tokens.shape
        if positions is not None and s > self.max_seq_len:
            raise ValueError(
                f"packed rows of length {s} exceed max_seq_len="
                f"{self.max_seq_len}; pack at max_len <= max_seq_len")
        x = self.embed(params["embed"], tokens)
        pos = params["pos_embedding"]
        x = x + (pos[positions] if positions is not None else pos[:s][None])
        if token_type_ids is not None:
            x = x + params["segment_embedding"][token_type_ids]
        x = self.embed_layernorm(params["embed_layernorm"], x)
        x = x.transpose(0, 1).to(self.dtype)              # (s, b, h)
        mask = None
        if attention_mask is not None:
            # (b, s) 1=keep -> additive (b, 1, 1, s)
            mask = (1.0 - attention_mask[:, None, None, :].float()) \
                * -10000.0
        for i in range(self.num_layers):
            x = self.layer(params[f"layer_{i}"], x, mask,
                           segment_ids=segment_ids)
        return x

    def mlm_logits(self, params: Dict, tokens: torch.Tensor, **kw
                   ) -> torch.Tensor:
        """f32 logits (s, b, V) of the head tied to the word embedding."""
        x = self.apply(params, tokens, **kw)
        s, b, h = x.shape
        w = params["embed"]["weight"]
        logits = matmul_f32_out(x.to(self.dtype).reshape(s * b, h),
                                w.to(self.dtype).t())
        return logits.reshape(s, b, -1)


def bert_large(**kw) -> BertModel:
    return BertModel(vocab_size=kw.pop("vocab_size", 30528),
                     hidden_size=1024, num_heads=16, num_layers=24, **kw)


def bert_base(**kw) -> BertModel:
    return BertModel(vocab_size=kw.pop("vocab_size", 30528),
                     hidden_size=768, num_heads=12, num_layers=12, **kw)
