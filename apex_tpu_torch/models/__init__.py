"""Models of the port: the ResNet family (the ImageNet path) and BERT
(the MLM pretraining path)."""

from apex_tpu_torch.models.bert import (BertLayer, BertModel,  # noqa: F401
                                        bert_base, bert_large)
from apex_tpu_torch.models.resnet import (ResNet, batch_norm,  # noqa: F401
                                          resnet18, resnet34, resnet50,
                                          resnet101, resnet152)
