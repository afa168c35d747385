"""The tensor- and sequence-parallel region mappings at a group of one:
the port of ``apex_tpu.transformer.tensor_parallel.mappings``.

Each pairs a forward collective with its transpose in the backward (the
f and g of the Megatron paper).  Over a group of one every collective is
the identity, so each mapping returns its input; ``group`` is a
``torch.distributed`` process group, and one of more than one rank
raises :data:`~apex_tpu_torch.transformer.tensor_parallel.layers.TP_TODO`
(the collectives come with the multi-process slice).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer.tensor_parallel.layers import TP_TODO


def _group_of_one(group) -> None:
    if group is not None and torch.distributed.get_world_size(group) != 1:
        raise NotImplementedError(TP_TODO)


def copy_to_tensor_model_parallel_region(x, group=None):
    """fwd identity / bwd all-reduce."""
    _group_of_one(group)
    return x


def reduce_from_tensor_model_parallel_region(x, group=None):
    """fwd all-reduce / bwd identity."""
    _group_of_one(group)
    return x


def scatter_to_tensor_model_parallel_region(x, group=None):
    """fwd split of the last dim / bwd all-gather."""
    _group_of_one(group)
    return x


def gather_from_tensor_model_parallel_region(x, group=None):
    """fwd all-gather of the last dim / bwd split."""
    _group_of_one(group)
    return x


def scatter_to_sequence_parallel_region(x, group=None):
    """fwd split of the sequence dim (0) / bwd all-gather."""
    _group_of_one(group)
    return x


def gather_from_sequence_parallel_region(x, group=None,
                                         tensor_parallel_output_grad=True):
    """fwd all-gather of the sequence dim / bwd reduce-scatter (a split
    when ``tensor_parallel_output_grad`` is False)."""
    _group_of_one(group)
    return x


def reduce_scatter_to_sequence_parallel_region(x, group=None):
    """fwd reduce-scatter of the sequence dim / bwd all-gather."""
    _group_of_one(group)
    return x
