"""SyncBatchNorm: the port of ``apex_tpu.parallel.sync_batchnorm``.

The reference takes local statistics from the differentiable plain
Welford (``welford_mean_var_ref``), merges them across the ``data`` mesh
axis with Chan's combine when that axis is bound, and otherwise uses the
local ones: plain BatchNorm with torch's conventions.  The port does the
same at world size 1: when ``torch.distributed`` is not initialized, or
its group has one process, the statistics are the local ones.  A larger
world raises ``NotImplementedError`` naming ROADMAP slice 9 (the merge
over NCCL is not ported yet).  The Welford kernel is the public op of
:mod:`apex_tpu_torch.ops.welford`; as in the reference it is not on this
path.

Semantics copied from the reference module: the variance is clamped at
0; the running statistics move torch-style, ``(1 - m) * old + m * new``
with the UNBIASED variance ``var * n / max(n - 1, 1)``; ``y`` is computed
in f32 and returned in x's dtype; params ``weight``/``bias``, statistics
``running_mean``/``running_var``.  Like the port's ResNet norms, a
:class:`SyncBatchNorm` is a function of a parameter tree:
``bn(x, params, stats, train) -> (y, new_stats)`` (``new_stats`` None
when the running averages are used), with :meth:`SyncBatchNorm.init`
for the leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.welford import welford_mean_var_ref

MULTI_PROCESS_TODO = ("SyncBatchNorm across processes (the Chan merge of the "
                      "local statistics over NCCL) is ROADMAP Queue 1 slice "
                      "9, not ported yet")


def _world_size(process_group) -> int:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(process_group)


def sync_batch_norm_stats(x2d: torch.Tensor, process_group=None):
    """Global ``(mean, biased var, count)`` of an ``(N, C)`` array over
    ``process_group`` (default: the default group); at world size 1 the
    local statistics, differentiable, as the reference's unbound axis
    gives them."""
    world = _world_size(process_group)
    if world > 1:
        raise NotImplementedError(
            f"sync_batch_norm_stats over {world} processes: "
            f"{MULTI_PROCESS_TODO}")
    mean, var_l, n = welford_mean_var_ref(x2d)
    # the reference's arithmetic: M2 = var * n, then var = M2 / n
    var = (var_l * n) / n
    return mean, torch.clamp_min(var, 0.0), n


def _merge_param(name: str, a, b):
    """flax's ``nn.merge_param``: exactly one of the two is set."""
    if a is not None and b is not None:
        raise ValueError(f'Parameter "{name}" was passed to the constructor '
                         "and at call time. Should be passed just once.")
    if a is None and b is None:
        raise ValueError(f'Parameter "{name}" must be passed to the '
                         "constructor or at call time.")
    return a if a is not None else b


class SyncBatchNorm:
    """The reference's fields: ``num_features`` (None infers it from the
    input), ``eps``, ``momentum`` (torch's: the weight of the NEW value),
    ``affine``, ``track_running_stats``, ``process_group`` (a
    ``torch.distributed`` group, None for the default), ``channel_last``
    (channels on the last axis; else axis 1, the NCHW layout) and
    ``use_running_average``."""

    # the name flax gives its instances in a parent: SyncBatchNorm_<k>
    name = "SyncBatchNorm"

    def __init__(self, num_features: Optional[int] = None, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_group: Any = None, channel_last: bool = False,
                 use_running_average: Optional[bool] = None):
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_group = process_group
        self.channel_last = channel_last
        self.use_running_average = use_running_average

    def init(self, num_features: Optional[int] = None, device=None
             ) -> Tuple[Dict, Dict]:
        """``(params, stats)`` in f32 on ``device`` (default: the card):
        weight 1 and bias 0 (when ``affine``), running mean 0 and var 1."""
        c = num_features if num_features is not None else self.num_features
        if c is None:
            raise ValueError("SyncBatchNorm.init needs num_features")
        dev = resolve_device(device)
        params = ({"weight": torch.ones(c, device=dev),
                   "bias": torch.zeros(c, device=dev)} if self.affine else {})
        stats = {"running_mean": torch.zeros(c, device=dev),
                 "running_var": torch.ones(c, device=dev)}
        return params, stats

    def running_update(self, stats: Dict, mean, var, n) -> Dict:
        """torch's update with the unbiased batch variance."""
        m = self.momentum
        with torch.no_grad():
            unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
            return {"running_mean": (1 - m) * stats["running_mean"] + m * mean,
                    "running_var": (1 - m) * stats["running_var"]
                    + m * unbiased}

    def __call__(self, x: torch.Tensor, params: Dict, stats: Dict,
                 train: Optional[bool] = None):
        use_ra = _merge_param("use_running_average", self.use_running_average,
                              None if train is None else not train)
        if self.num_features is not None:
            c = self.num_features
        else:
            c = x.shape[-1] if self.channel_last or x.dim() == 2 \
                else x.shape[1]
        if self.channel_last or x.dim() == 2:
            xc = x.reshape(-1, c)

            def restore(y2d):
                return y2d.reshape(x.shape)
        else:
            # channels on axis 1: reduce over every other axis
            perm = (0,) + tuple(range(2, x.dim())) + (1,)
            xt = x.permute(perm)
            xc = xt.reshape(-1, c)
            inv = tuple(perm.index(i) for i in range(x.dim()))

            def restore(y2d):
                return y2d.reshape(xt.shape).permute(inv)

        new = None
        if use_ra:
            mean, var = stats["running_mean"], stats["running_var"]
        else:
            mean, var, n = sync_batch_norm_stats(xc, self.process_group)
            new = (self.running_update(stats, mean, var, n)
                   if self.track_running_stats else dict(stats))
        y = (xc.float() - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * params["weight"].float() + params["bias"].float()
        return restore(y.to(x.dtype)), new


def convert_syncbn_model(module: Any, process_group: Any = None,
                         channel_last: bool = False):
    """apex.parallel.convert_syncbn_model's counterpart, as the
    reference shapes it: a ``torch.nn`` BatchNorm module (the counterpart
    of flax's ``nn.BatchNorm``) becomes the configured
    :class:`SyncBatchNorm` (its ``weight``, ``bias``, ``running_mean``
    and ``running_var`` are the leaf names that takes); an object with
    ``replace_norm`` returns ``replace_norm(SyncBatchNorm)``; anything
    else raises ``TypeError``.  The port's models take a ``norm_cls``
    instead: pass ``SyncBatchNorm`` there."""
    if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
        if module.momentum is None:
            raise ValueError("convert_syncbn_model: a BatchNorm with "
                             "momentum=None (a cumulative average) has no "
                             "SyncBatchNorm counterpart")
        return SyncBatchNorm(
            num_features=module.num_features, eps=module.eps,
            momentum=module.momentum, affine=module.affine,
            track_running_stats=module.track_running_stats,
            process_group=process_group, channel_last=channel_last)
    if hasattr(module, "replace_norm"):
        return module.replace_norm(SyncBatchNorm)
    raise TypeError(
        "convert_syncbn_model supports torch.nn BatchNorm modules or "
        "modules exposing replace_norm(); build apex_tpu_torch models with "
        "norm_cls=SyncBatchNorm instead.")
