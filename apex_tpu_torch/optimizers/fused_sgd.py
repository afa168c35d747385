"""FusedSGD: torch.optim.SGD semantics (momentum, dampening, nesterov,
weight decay) as one ``flat_sgd`` kernel per bucket.

The port of ``apex_tpu.optimizers.fused_sgd``.  ``first_run`` is the
device-side ``step == 1``, read by the kernel through its pointer.
"""

from __future__ import annotations

import torch

from apex_tpu_torch._tree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._base import FusedOptimizerBase


class FusedSGD(FusedOptimizerBase):
    defaults = dict(lr=1e-3, momentum=0.0, dampening=0.0, weight_decay=0.0,
                    nesterov=False)

    def __init__(self, params, **kw):
        if kw.get("nesterov") and (
                kw.get("momentum", 0.0) <= 0 or kw.get("dampening", 0.0) != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        super().__init__(params, **kw)

    def init_state(self, params):
        return {"momentum_buffer": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def _kw(self, h, step, grad_scale):
        return dict(lr=h["lr"], momentum=h["momentum"],
                    dampening=h["dampening"],
                    weight_decay=h["weight_decay"], nesterov=h["nesterov"],
                    first_run=step == 1, grad_scale=grad_scale)

    def _step_math(self, params, grads, opt_state, step, grad_scale, hypers):
        kw = self._kw(hypers, step, grad_scale)
        ps, treedef = tree_flatten(params)
        gs, bs = tree_leaves(grads), tree_leaves(opt_state["momentum_buffer"])
        # the per-leaf oracle: the flat kernel's plain twin, leaf by leaf
        out = [mt.flat_sgd_ref(p, g, b, **kw) for p, g, b in zip(ps, gs, bs)]
        return (tree_unflatten(treedef, [p for p, _ in out]),
                {"momentum_buffer": tree_unflatten(treedef,
                                                   [b for _, b in out])})

    def _flat_bucket_step(self, bucket_index, p, g, state, step, grad_scale,
                          hypers, found_inf, extra):
        mt.flat_sgd(p, g, state["momentum_buffer"], found_inf=found_inf,
                    **self._kw(hypers, step, grad_scale))
