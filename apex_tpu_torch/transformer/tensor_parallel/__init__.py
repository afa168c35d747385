"""The port of ``apex_tpu.transformer.tensor_parallel`` at a
tensor-parallel size of one: the layers, the region mappings, the
vocab-parallel cross entropy and the shard arithmetic."""

from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa
    cross_entropy_ref, vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.utils import (  # noqa: F401
    VocabUtility, divide, ensure_divisibility, split_tensor_along_last_dim)
