"""Models of the port: the ResNet family (the ImageNet path), BERT (the
MLM pretraining path) and GPT (causal LM training at a tensor-parallel
size of one)."""

from apex_tpu_torch.models.bert import (BertLayer, BertModel,  # noqa: F401
                                        bert_base, bert_large)
from apex_tpu_torch.models.gpt import (GPTLayer, GPTModel,  # noqa: F401
                                       GPTStage)
from apex_tpu_torch.models.resnet import (ResNet, batch_norm,  # noqa: F401
                                          resnet18, resnet34, resnet50,
                                          resnet101, resnet152)
