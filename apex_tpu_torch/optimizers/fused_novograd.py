"""FusedNovoGrad: a per-tensor (layer-wise) second moment normalizing
the gradient before the first-moment EMA, as one ``flat_novograd`` per
bucket.

The port of ``apex_tpu.optimizers.fused_novograd``.  The per-tensor
second moment lives packed as one f32 ``(num leaves,)`` vector per
bucket (:meth:`BucketPlan.pack_state_field`) and serializes as per-leaf
0-d tensors.  The first step (``step == 1``, which seeds the moments) is
read from the device step clock, so a skipped first step is first again
and the step never reads back to the host.  A pipeline ``clip_coef``
folds into ``grad_scale`` (``_base._fold_clip``), so the per-tensor
norms are norms of the CLIPPED gradients, as the per-leaf oracle fed
pre-clipped grads computes them.  The per-leaf path is the plain twin
leaf by leaf, on the CPU only (the oracle the bucketed step is held
to).  ``amsgrad=True`` and ``norm_type != 2`` raise as the reference
does; its ``set_grad_none`` is read by nothing and not accepted.
"""

from __future__ import annotations

import torch

from apex_tpu_torch._tree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._base import FusedOptimizerBase

NORM_TYPE_ONLY_2 = "FusedNovoGrad only supports norm_type=2"


class FusedNovoGrad(FusedOptimizerBase):
    defaults = dict(lr=1e-3, beta1=0.95, beta2=0.98, eps=1e-8,
                    weight_decay=0.0, grad_averaging=True,
                    bias_correction=True, reg_inside_moment=False,
                    norm_type=2, init_zero=False)

    def __init__(self, params, betas=None, **kw):
        if betas is not None:
            kw["beta1"], kw["beta2"] = betas
        if kw.pop("amsgrad", False):
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")  # the reference raises the same
        super().__init__(params, **kw)

    def init_state(self, params):
        return {"exp_avg": tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
                "exp_avg_sq": tree_map(
                    lambda p: torch.zeros((), dtype=torch.float32,
                                          device=p.device), params)}

    def _kw(self, h, step, grad_scale):
        if h["norm_type"] != 2:
            raise ValueError(NORM_TYPE_ONLY_2)
        return dict(lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
                    eps=h["eps"], weight_decay=h["weight_decay"],
                    first_run=step == 1, grad_averaging=h["grad_averaging"],
                    init_zero=h["init_zero"],
                    reg_inside_moment=h["reg_inside_moment"],
                    grad_scale=grad_scale)

    def _step_math(self, params, grads, opt_state, step, grad_scale, hypers):
        kw = self._kw(hypers, step, grad_scale)
        ps, treedef = tree_flatten(params)
        out = [mt.flat_novograd_ref(
            p.reshape(-1), g.reshape(-1), m.reshape(-1), v.reshape(1),
            (p.numel(),), **kw) for p, g, m, v in zip(
                ps, tree_leaves(grads), tree_leaves(opt_state["exp_avg"]),
                tree_leaves(opt_state["exp_avg_sq"]))]
        new_p = tree_unflatten(treedef, [o[0].reshape(p.shape)
                                         for o, p in zip(out, ps)])
        new_m = tree_unflatten(treedef, [o[1].reshape(p.shape)
                                         for o, p in zip(out, ps)])
        new_v = tree_unflatten(treedef, [o[2].reshape(()) for o in out])
        return new_p, {"exp_avg": new_m, "exp_avg_sq": new_v}

    def _flat_bucket_step(self, bucket_index, p, g, state, step, grad_scale,
                          hypers, found_inf, extra):
        mt.flat_novograd(p, g, state["exp_avg"], state["exp_avg_sq"],
                         self._plan.segment_sizes(bucket_index),
                         seg_offsets=self._plan.segment_offsets(bucket_index),
                         found_inf=found_inf,
                         **self._kw(hypers, step, grad_scale))
