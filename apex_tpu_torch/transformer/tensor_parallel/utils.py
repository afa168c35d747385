"""Shard arithmetic of the tensor-parallel layers: the port of
``apex_tpu.transformer.tensor_parallel.utils``."""

from __future__ import annotations

from typing import Tuple

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    assert numerator % denominator == 0, (
        f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int):
    """The last dim split into ``num_partitions`` equal views."""
    return torch.split(x, divide(x.shape[-1], num_partitions), dim=-1)


class VocabUtility:
    """The vocabulary range ``[first, last)`` a rank's shard holds."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int,
                                           rank: int, world_size: int
                                           ) -> Tuple[int, int]:
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size)
