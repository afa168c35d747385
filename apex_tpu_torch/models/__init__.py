"""Models of the port (so far: the ResNet family of the training path)."""

from apex_tpu_torch.models.resnet import (ResNet, batch_norm,  # noqa: F401
                                          resnet18, resnet34, resnet50,
                                          resnet101, resnet152)
