"""The GPT (Megatron-style causal transformer) family as functions of a
parameter tree: the port of ``apex_tpu.models.gpt`` at a tensor-parallel
size of one.

``GPTLayer`` (pre-LN: LayerNorm, fused qkv split per head, causal flash
attention, projection; LayerNorm, tanh-GELU MLP), ``GPTStage`` (k
consecutive layers) and ``GPTModel`` (token embedding, learned positions
or RoPE, the layers, a final LayerNorm and the head tied to the
embedding, f32 logits, and :meth:`GPTModel.loss` through the
vocab-parallel cross entropy).  Layout is Megatron's (s, b, h) between
layers; attention takes (b, heads, s, d).  The parameters are a nested
dict with the flax model's names and layouts (``embed/weight`` (V, h),
``pos_embedding`` (max_seq_len, h) without RoPE, ``layer_<i>/
{input_layernorm, attn_qkv, attn_proj, post_attn_layernorm, mlp_fc1,
mlp_fc2}``, ``final_layernorm``; linear weights (in, out)), so the tree
flattens, packs and checkpoints as the reference's
(``convert.gpt_from_jax``).

Packed batches (``data.pack_sequences`` / ``data.pack_dataset``) pass
``segment_ids`` and ``positions`` (both (b, s)), BOTH or NEITHER:
attention is segment-masked (``packed_segment_ids``: pad rows attend
nowhere and give exact zeros) and the positions, learned or rotary, are
the within-sequence ones (RoPE's ``freqs`` then differ per row: (s, b,
1, d)).

Precision is the reference's: every layer computes in ``dtype`` (bf16
under amp O2), the norms in f32 with the input's storage dtype, the
residual stream in ``dtype``, the head a GEMM of ``dtype`` operands
with an f32 result.  On the card the attention runs the hand-written
flash kernels and the norms the LayerNorm kernels, forward and backward.

Sequence parallelism and context parallelism raise (:data:`TP_TODO`,
:data:`CP_TODO`: the multi-process slice), and so do the tensor-parallel
layers and region mappings over a group of more than one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.bert import _normal, matmul_f32_out
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.offload import checkpoint_name
from apex_tpu_torch.ops.attention import flash_attention, packed_segment_ids
from apex_tpu_torch.ops.rope import fused_apply_rotary_pos_emb
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.tensor_parallel.layers import TP_TODO

CP_TODO = ("context parallelism (ring and ulysses attention over the "
           "context axis) is not ported yet: ROADMAP Queue 1 item 9 "
           "(slice 9)")

ROPE_BASE = 10000.0


def _no_sequence_parallel(sequence_parallel: bool) -> None:
    if sequence_parallel:
        raise NotImplementedError(TP_TODO)


def rope_freqs(head_dim: int, s: int, positions: Optional[torch.Tensor],
               device) -> torch.Tensor:
    """RoPE's angles in f32: (s, 1, 1, d) for the positions 0..s-1, or
    (s, b, 1, d) for a packed batch's within-sequence ``positions`` (b,
    s); each half of d repeats the frequencies ``base^(-2i/d)``."""
    inv = 1.0 / (ROPE_BASE ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    if positions is not None:
        pos = positions.t().to(torch.float32)                 # (s, b)
        freqs = pos[..., None] * inv
        return torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
    pos = torch.arange(s, dtype=torch.float32, device=device)
    freqs = pos[:, None] * inv
    return torch.cat([freqs, freqs], dim=-1)[:, None, None, :]


class GPTLayer:
    def __init__(self, hidden_size: int, num_heads: int,
                 ffn_hidden_size: Optional[int] = None,
                 sequence_parallel: bool = False, use_rope: bool = False,
                 context_parallel: bool = False,
                 dtype: torch.dtype = torch.float32):
        _no_sequence_parallel(sequence_parallel)
        if context_parallel:
            raise NotImplementedError(CP_TODO)
        h = hidden_size
        ffn = ffn_hidden_size or 4 * h
        self.hidden_size, self.num_heads = h, num_heads
        self.use_rope, self.dtype = use_rope, dtype
        self.input_layernorm = FusedLayerNorm(h)
        self.attn_qkv = tp.ColumnParallelLinear(h, 3 * h, gather_output=False,
                                                compute_dtype=dtype)
        self.attn_proj = tp.RowParallelLinear(h, h, input_is_parallel=True,
                                              compute_dtype=dtype)
        self.post_attn_layernorm = FusedLayerNorm(h)
        self.mlp_fc1 = tp.ColumnParallelLinear(h, ffn, gather_output=False,
                                               compute_dtype=dtype)
        self.mlp_fc2 = tp.RowParallelLinear(ffn, h, input_is_parallel=True,
                                            compute_dtype=dtype)

    def init(self, generator: torch.Generator, device=None) -> Dict:
        return {"input_layernorm": self.input_layernorm.init(device),
                "attn_qkv": self.attn_qkv.init(generator, device),
                "attn_proj": self.attn_proj.init(generator, device),
                "post_attn_layernorm": self.post_attn_layernorm.init(device),
                "mlp_fc1": self.mlp_fc1.init(generator, device),
                "mlp_fc2": self.mlp_fc2.init(generator, device)}

    def __call__(self, params: Dict, x: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (s, b, h) -> the same shape.  ``segment_ids`` / ``positions``
        (b, s): the packed form, both or neither (one-sided packing would
        leave segments unmasked, or give every later segment its offset
        in the row as its positions)."""
        if (segment_ids is None) != (positions is None):
            raise ValueError(
                "packed batches need BOTH segment_ids and positions "
                "(apex_tpu_torch.data.pack_sequences emits both)")
        head_dim = self.hidden_size // self.num_heads
        y = self.input_layernorm(params["input_layernorm"], x).to(self.dtype)
        y = self.attn_qkv(params["attn_qkv"], y)              # (s, b, 3h)
        s, b = y.shape[0], y.shape[1]
        y = y.reshape(s, b, self.num_heads, 3 * head_dim)
        # (s, b, heads, d) each: the per-head split of the reference
        q, k, v = torch.split(y, head_dim, dim=-1)
        if self.use_rope:
            freqs = rope_freqs(head_dim, s, positions, x.device)
            q = fused_apply_rotary_pos_emb(q, freqs)
            k = fused_apply_rotary_pos_emb(k, freqs)
        q, k, v = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))
        seg = None if segment_ids is None else packed_segment_ids(segment_ids)
        attn = flash_attention(q, k, v, causal=True, segment_ids=seg)
        attn = attn.permute(2, 0, 1, 3).reshape(s, b, self.hidden_size)
        # offload tags (the identity outside an offload scope): the two
        # largest activations, for apex_tpu_torch.offload.offload_checkpoint
        attn = checkpoint_name(attn, "attn_out")
        x = x + self.attn_proj(params["attn_proj"], attn).to(x.dtype)

        y = self.post_attn_layernorm(params["post_attn_layernorm"],
                                     x).to(self.dtype)
        y = checkpoint_name(F.gelu(self.mlp_fc1(params["mlp_fc1"], y),
                                   approximate="tanh"), "ffn_hidden")
        return x + self.mlp_fc2(params["mlp_fc2"], y).to(x.dtype)


class GPTStage:
    """A pipeline stage: ``num_layers`` consecutive GPT layers, params
    ``layer_<i>``."""

    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 ffn_hidden_size: Optional[int] = None,
                 sequence_parallel: bool = False, use_rope: bool = False,
                 dtype: torch.dtype = torch.float32):
        self.num_layers = num_layers
        self.layer = GPTLayer(hidden_size, num_heads, ffn_hidden_size,
                              sequence_parallel=sequence_parallel,
                              use_rope=use_rope, dtype=dtype)

    def init(self, generator: torch.Generator, device=None) -> Dict:
        return {f"layer_{i}": self.layer.init(generator, device)
                for i in range(self.num_layers)}

    def __call__(self, params: Dict, x: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = self.layer(params[f"layer_{i}"], x, segment_ids, positions)
        return x


class GPTModel:
    """Embedding -> layers -> final LayerNorm -> the tied head.

    ``apply(params, tokens (b, s))`` gives f32 logits (s, b, V);
    ``loss(params, tokens, labels)`` the mean cross entropy through
    :func:`~apex_tpu_torch.transformer.tensor_parallel.
    vocab_parallel_cross_entropy`."""

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 num_layers: int, max_seq_len: int = 2048,
                 ffn_hidden_size: Optional[int] = None,
                 sequence_parallel: bool = False, use_rope: bool = False,
                 dtype: torch.dtype = torch.float32):
        _no_sequence_parallel(sequence_parallel)
        self.vocab_size, self.hidden_size = vocab_size, hidden_size
        self.num_heads, self.num_layers = num_heads, num_layers
        self.max_seq_len, self.use_rope, self.dtype = (max_seq_len, use_rope,
                                                       dtype)
        self.embed = tp.VocabParallelEmbedding(vocab_size, hidden_size)
        self.stage = GPTStage(hidden_size, num_heads, num_layers,
                              ffn_hidden_size, use_rope=use_rope,
                              dtype=dtype)
        self.final_layernorm = FusedLayerNorm(hidden_size)

    def init(self, seed: int = 0, device=None) -> Dict:
        """f32 parameters on ``device`` (default: the card), drawn on the
        CPU from ``seed`` with flax's initializers."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = {"embed": self.embed.init(gen, dev)}
        if not self.use_rope:
            params["pos_embedding"] = _normal(
                (self.max_seq_len, self.hidden_size), 0.02, gen).to(dev)
        params.update(self.stage.init(gen, dev))
        params["final_layernorm"] = self.final_layernorm.init(dev)
        return params

    def apply(self, params: Dict, tokens: torch.Tensor,
              segment_ids: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) -> f32 logits (s, b, V).  A packed batch's pad
        rows (segment 0) give logits that the loss masks out."""
        b, s = tokens.shape
        if positions is not None and s > self.max_seq_len:
            # a gather of the position table would read past its end
            raise ValueError(
                f"packed rows of length {s} exceed max_seq_len="
                f"{self.max_seq_len}; pack at max_len <= max_seq_len")
        x = self.embed(params["embed"], tokens)                # (b, s, h)
        if not self.use_rope:
            pos = params["pos_embedding"]
            x = x + (pos[positions] if positions is not None
                     else pos[:s][None])
        x = x.transpose(0, 1).to(self.dtype)                   # (s, b, h)
        x = self.stage(params, x, segment_ids, positions)
        x = self.final_layernorm(params["final_layernorm"], x)
        w = params["embed"]["weight"]
        logits = matmul_f32_out(x.to(self.dtype).reshape(s * b, -1),
                                w.to(self.dtype).t())
        return logits.reshape(s, b, -1)

    def loss(self, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
             segment_ids: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean cross entropy over (b, s) ``labels``.  A packed batch
        leaves out two kinds of position: padding (segment 0) and each
        segment's final position, whose shifted label (``labels[i] =
        tokens[i + 1]``) would be the next segment's first token."""
        logits = self.apply(params, tokens, segment_ids, positions)
        per_tok = tp.vocab_parallel_cross_entropy(logits, labels.t())
        if segment_ids is None:
            return per_tok.mean()
        seg = segment_ids.t()                                  # (s, b)
        next_seg = torch.cat([seg[1:], torch.zeros_like(seg[:1])], dim=0)
        keep = (seg > 0) & (next_seg == seg)
        return (per_tok * keep).sum() / torch.clamp(keep.sum(), min=1)
