"""Tensor-parallel layers at a tensor-parallel size of 1: the port of
``apex_tpu.transformer.tensor_parallel.layers``.

``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` with the reference's constructor surface and
flax's parameter names and layouts (``weight`` ``(in, out)``, ``bias``
``(out,)``; the embedding ``weight`` ``(vocab, h)``).  Each object holds
its settings; ``init(generator, device)`` draws its parameters with
flax's initializers (``lecun_normal`` for the linears, ``normal(0.02)``
for the embedding, zero biases), and ``__call__(params, x)`` applies it.

A linear computes ``x @ w`` in ``compute_dtype`` (the input's dtype when
None), then adds the bias in that dtype — the reference's ``jnp.dot(...,
preferred_element_type=f32).astype(dtype)``: a bf16 ``torch.matmul``
accumulates in f32 and rounds its result to bf16, the same function.

A tensor-parallel size above 1, sequence parallelism, ``skip_bias_add``
and fp8 wait for the tensor-parallel slice (ROADMAP slice 4 item 12).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from apex_tpu_torch._device import resolve_device

TP_TODO = ("tensor parallelism above size 1, sequence parallelism, "
           "skip_bias_add and fp8 are not ported yet: ROADMAP slice 4 item "
           "12")


def _require_tp1(tensor_model_parallel_size, sequence_parallel_enabled,
                 skip_bias_add=False, fp8=None) -> None:
    if (tensor_model_parallel_size != 1 or sequence_parallel_enabled
            or skip_bias_add or fp8 is not None):
        raise NotImplementedError(TP_TODO)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` (a truncated normal scaled to fan-in; the
    fan-in is every axis but the last), drawn on the CPU."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


class _Linear:
    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None):
        self.input_size = input_size
        self.output_size = output_size
        self.bias = bias
        self.params_dtype = params_dtype
        self.compute_dtype = compute_dtype

    def init(self, generator: torch.Generator, device=None
             ) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        p = {"weight": lecun_normal((self.input_size, self.output_size),
                                    generator).to(dev, self.params_dtype)}
        if self.bias:
            p["bias"] = torch.zeros(self.output_size, dtype=self.params_dtype,
                                    device=dev)
        return p

    def __call__(self, params: Dict[str, torch.Tensor], x: torch.Tensor
                 ) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = torch.matmul(x.to(dt), params["weight"].to(dt))
        if "bias" in params:
            y = y + params["bias"].to(dt)
        return y


class ColumnParallelLinear(_Linear):
    """``Y = X A + b``, A split by its output dim over the tensor-parallel
    group (here a group of one)."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True, skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 params_dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None, fp8=None,
                 tensor_model_parallel_size: int = 1):
        _require_tp1(tensor_model_parallel_size, sequence_parallel_enabled,
                     skip_bias_add, fp8)
        super().__init__(input_size, output_size, bias, params_dtype,
                         compute_dtype)
        self.gather_output = gather_output


class RowParallelLinear(_Linear):
    """``Y = X A + b``, A split by its input dim over the tensor-parallel
    group (here a group of one); the bias is added once, after the
    (here trivial) reduction."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = False, skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 params_dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None, fp8=None,
                 tensor_model_parallel_size: int = 1):
        _require_tp1(tensor_model_parallel_size, sequence_parallel_enabled,
                     skip_bias_add, fp8)
        super().__init__(input_size, output_size, bias, params_dtype,
                         compute_dtype)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding:
    """An embedding table split by vocabulary over the tensor-parallel
    group (here a group of one): a row lookup."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 params_dtype: torch.dtype = torch.float32,
                 tensor_model_parallel_size: int = 1):
        _require_tp1(tensor_model_parallel_size, False)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.params_dtype = params_dtype

    def init(self, generator: torch.Generator, device=None
             ) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        w = torch.randn(self.num_embeddings, self.embedding_dim,
                        generator=generator) * 0.02
        return {"weight": w.to(dev, self.params_dtype)}

    def __call__(self, params: Dict[str, torch.Tensor], ids: torch.Tensor
                 ) -> torch.Tensor:
        return torch.nn.functional.embedding(ids, params["weight"])
