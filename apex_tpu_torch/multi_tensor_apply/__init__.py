"""Bucket packing of parameter trees (port of
``apex_tpu.multi_tensor_apply``'s packer)."""

from apex_tpu_torch.multi_tensor_apply.packer import (  # noqa: F401
    Bucket, BucketPlan, LeafSpec, cached_plan)
