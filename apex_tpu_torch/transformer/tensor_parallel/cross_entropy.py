"""The vocab-parallel cross entropy at a tensor-parallel size of one:
the port of ``apex_tpu.transformer.tensor_parallel.cross_entropy``.

Plain PyTorch in f32, as the reference's is plain ``jnp`` (it never
reaches the fused cross-entropy kernel): the stable log-sum-exp with the
row max taken out of the gradient path (the shift cancels in the loss),
the target logit gathered from the shard that owns it (here the only
one; a label outside ``[0, V)`` has no target term), and the
reference's label smoothing, ``(1 - eps) * nll + eps * mean_i(-log
p_i)``.  Autograd gives the reference's gradient, softmax minus the
(smoothed) one-hot.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    _group_of_one)
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 group=None) -> torch.Tensor:
    """Per-token loss (...) in f32 from logits (..., V) (f32 or bf16)
    and int targets (...) in ``[0, V)``."""
    _group_of_one(group)
    logits = vocab_parallel_logits.float()
    v_local = logits.shape[-1]
    gmax = logits.detach().amax(dim=-1)
    shifted = logits - gmax[..., None]
    logz = torch.log(torch.exp(shifted).sum(dim=-1))

    first, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
        v_local, 0, 1)
    local_t = target.long() - first
    in_range = (local_t >= 0) & (local_t < v_local)
    local_t = torch.where(in_range, local_t, 0)
    tgt = torch.gather(shifted, -1, local_t[..., None])[..., 0]
    tgt = torch.where(in_range, tgt, 0.0)
    loss = logz - tgt

    if label_smoothing > 0.0:
        eps = label_smoothing
        mean_logprob = shifted.sum(dim=-1) / v_local - logz
        loss = (1.0 - eps) * loss - eps * mean_logprob
    return loss


def cross_entropy_ref(logits: torch.Tensor, target: torch.Tensor,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """The full-vocabulary oracle: ``log_softmax`` in f32 and a gather."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        eps = label_smoothing
        nll = (1 - eps) * nll - eps * logp.mean(dim=-1)
    return nll
