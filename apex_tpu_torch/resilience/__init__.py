"""Crash-safe checkpoint rotation and preemption-safe restart (port of the
single-process half of ``apex_tpu.resilience``):

- :class:`~apex_tpu_torch.resilience.manager.CheckpointManager`: a
  rotating window of checkpoints (``step-<N>.ckpt``) written on a worker
  thread, bucket-native v2 when the optimizer runs bucketed, resume from
  the newest valid one, last-known-good pinning;
- :class:`~apex_tpu_torch.resilience.preemption.PreemptionGuard`: SIGTERM,
  ``preempt_at_step`` or ``notice()`` seen at the next step boundary,
  where the loop saves and exits cleanly.

Not ported yet (ROADMAP Queue 1): ``run_elastic``, the retry policy, the
watchdog, the fleet monitor and the fault injector, and the multi-host
agreement of ``CheckpointManager``.
"""

from apex_tpu_torch.resilience.manager import CheckpointManager
from apex_tpu_torch.resilience.preemption import PreemptionGuard

__all__ = ["CheckpointManager", "PreemptionGuard"]
