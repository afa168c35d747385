"""apex.parallel's counterpart (the port of ``apex_tpu.parallel``): so
far SyncBatchNorm at world size 1.  DistributedDataParallel, the
merge of SyncBatchNorm's statistics across processes, and LARC are
ROADMAP Queue 1 slice 9."""

from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm, convert_syncbn_model, sync_batch_norm_stats)

__all__ = ["SyncBatchNorm", "convert_syncbn_model", "sync_batch_norm_stats"]
