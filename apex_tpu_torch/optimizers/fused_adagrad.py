"""FusedAdagrad as one ``flat_adagrad`` kernel per bucket.

The port of ``apex_tpu.optimizers.fused_adagrad``: the running sum of
squared (decayed) gradients is the f32 state field ``sum``; a pipeline
``clip_coef`` folds into ``grad_scale`` (``_base._fold_clip``), which
the kernel reads as ``1 / grad_scale``.  The per-leaf path is the plain
twin leaf by leaf, on the CPU only.  The reference's ``adagrad_w_mode``
and ``set_grad_none`` are read by nothing, so they are not accepted.
"""

from __future__ import annotations

import torch

from apex_tpu_torch._tree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._base import FusedOptimizerBase


class FusedAdagrad(FusedOptimizerBase):
    defaults = dict(lr=1e-2, eps=1e-10, weight_decay=0.0)

    def init_state(self, params):
        return {"sum": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    @staticmethod
    def _kw(h, grad_scale):
        return dict(lr=h["lr"], eps=h["eps"], weight_decay=h["weight_decay"],
                    grad_scale=grad_scale)

    def _step_math(self, params, grads, opt_state, step, grad_scale, hypers):
        kw = self._kw(hypers, grad_scale)
        ps, treedef = tree_flatten(params)
        out = [mt.flat_adagrad_ref(p, g, s, **kw) for p, g, s in zip(
            ps, tree_leaves(grads), tree_leaves(opt_state["sum"]))]
        new_p, new_s = (tree_unflatten(treedef, [o[i] for o in out])
                        for i in range(2))
        return new_p, {"sum": new_s}

    def _flat_bucket_step(self, bucket_index, p, g, state, step, grad_scale,
                          hypers, found_inf, extra):
        mt.flat_adagrad(p, g, state["sum"], found_inf=found_inf,
                        **self._kw(hypers, grad_scale))
