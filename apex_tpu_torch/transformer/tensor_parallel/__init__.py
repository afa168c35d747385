from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
