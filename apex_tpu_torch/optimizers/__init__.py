"""Fused optimizers of the port (so far: FusedSGD, the training path's)."""

from apex_tpu_torch.optimizers.fused_sgd import FusedSGD  # noqa: F401
