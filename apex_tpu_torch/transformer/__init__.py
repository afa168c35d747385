"""Transformer building blocks of the port: the tensor-parallel layers at
a tensor-parallel size of 1, the enums, and ``functional`` (the fused
softmax and RoPE)."""

from apex_tpu_torch.transformer import functional  # noqa: F401
from apex_tpu_torch.transformer.enums import (AttnMaskType,  # noqa: F401
                                              AttnType, LayerType, ModelType)
