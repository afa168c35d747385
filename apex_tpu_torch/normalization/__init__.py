"""Normalization modules of the port (FusedLayerNorm, FusedRMSNorm and
their Mixed variants)."""

from apex_tpu_torch.normalization.fused_layer_norm import (  # noqa: F401
    FusedLayerNorm, FusedRMSNorm, MixedFusedLayerNorm, MixedFusedRMSNorm,
    fused_layer_norm, fused_rms_norm, layer_norm_ref, rms_norm_ref)
