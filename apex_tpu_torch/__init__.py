"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for one NVIDIA H100.

The JAX package ``apex_tpu`` is the reference; this package computes
the same functions in PyTorch, and every Pallas kernel on a ported path
becomes a kernel written by hand for Hopper (``csrc/``, built with
``nvcc`` at first use).  It imports neither ``jax`` nor ``apex_tpu``.

Ported so far: the serving path (:mod:`apex_tpu_torch.serving`) with
the flash-attention forward kernel; the ImageNet training path (amp,
bucketed :class:`~apex_tpu_torch.optimizers.FusedSGD`, the flat
gradient pipeline, ResNet) with the flat accumulate / unscale-norm / SGD
kernels; BERT MLM pretraining (:mod:`apex_tpu_torch.models.bert`,
:class:`~apex_tpu_torch.optimizers.FusedLAMB`, FusedLayerNorm,
contrib.xentropy, ``examples.bert_pretrain_mlm``) with the LayerNorm,
l2norm and LAMB kernels; GPT block training
(``examples.gpt_train_block``: contrib.multihead_attn,
:class:`~apex_tpu_torch.optimizers.FusedAdam`) with the flash-attention
backward and Adam kernels; and the optimizer tail
(:class:`~apex_tpu_torch.optimizers.FusedNovoGrad`,
:class:`~apex_tpu_torch.optimizers.FusedAdagrad`, contrib.clip_grad,
:mod:`apex_tpu_torch.fp16_utils`) with the NovoGrad, Adagrad, scale and
axpby kernels.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from apex_tpu_torch._device import resolve_device  # noqa: F401
