from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss, softmax_cross_entropy_loss)

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]
