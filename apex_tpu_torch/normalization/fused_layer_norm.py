"""Module-level normalization API: the port of
``apex_tpu.normalization.fused_layer_norm``.

The reference's modules are flax modules; here each is a small object
holding the constructor's settings, with ``init(device)`` returning its
parameters as a dict under flax's names (``weight``, ``bias``: ``(h,)``
in ``param_dtype``) and ``__call__(params, x)`` applying it, so a model
keeps its parameters as the reference's nested dict.  The "Mixed"
variants keep the reference's meaning (f32 params under a bf16 input):
the kernels compute in f32 whatever the dtypes.

``sequence_parallel=True`` (the tensor-parallel grad sync of the affine
params) waits for the tensor-parallel slice (ROADMAP slice 4 item 12).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.layer_norm import (fused_layer_norm,  # noqa: F401
                                           fused_rms_norm, layer_norm_ref,
                                           rms_norm_ref)

Shape = Union[int, Iterable[int]]

SP_TODO = ("sequence-parallel norms (the affine params' grad sync over the "
           "tensor-parallel group) are not ported yet: ROADMAP slice 4 "
           "item 12")


def _normalize_shape(s: Shape) -> Tuple[int, ...]:
    return (s,) if isinstance(s, int) else tuple(s)


class FusedLayerNorm:
    rms = False

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 sequence_parallel: bool = False):
        if sequence_parallel:
            raise NotImplementedError(SP_TODO)
        self.normalized_shape = _normalize_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        self.param_dtype = param_dtype

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        """flax's initializers: weight ones, bias zeros."""
        if not self.elementwise_affine:
            return {}
        h = math.prod(self.normalized_shape)
        dev = resolve_device(device)
        p = {"weight": torch.ones(h, dtype=self.param_dtype, device=dev)}
        if not self.rms:
            p["bias"] = torch.zeros(h, dtype=self.param_dtype, device=dev)
        return p

    def _norm(self, x2, w: Optional[torch.Tensor], b: Optional[torch.Tensor]):
        return fused_layer_norm(x2, w, b, self.eps, self.memory_efficient)

    def __call__(self, params: Dict[str, torch.Tensor], x: torch.Tensor
                 ) -> torch.Tensor:
        n = len(self.normalized_shape)
        h = math.prod(self.normalized_shape)
        x2 = x.reshape(tuple(x.shape[:x.dim() - n]) + (h,))
        y = self._norm(x2, params.get("weight"), params.get("bias"))
        return y.reshape(x.shape)


class FusedRMSNorm(FusedLayerNorm):
    rms = True

    def _norm(self, x2, w, b):
        return fused_rms_norm(x2, w, self.eps, self.memory_efficient)


class MixedFusedLayerNorm(FusedLayerNorm):
    """bf16-input / f32-param LayerNorm (reference MixedFusedLayerNorm)."""


class MixedFusedRMSNorm(FusedRMSNorm):
    """bf16-input / f32-param RMSNorm (reference MixedFusedRMSNorm)."""


__all__ = [
    "FusedLayerNorm", "FusedRMSNorm",
    "MixedFusedLayerNorm", "MixedFusedRMSNorm",
    "fused_layer_norm", "fused_rms_norm",
    "layer_norm_ref", "rms_norm_ref",
]
