from apex_tpu_torch.contrib.clip_grad.clip_grad import (  # noqa: F401
    clip_grad_norm, clip_grad_norm_)

__all__ = ["clip_grad_norm_", "clip_grad_norm"]
