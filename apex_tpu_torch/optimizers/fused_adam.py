"""FusedAdam: Adam, or AdamW (decoupled weight decay, the default as in
the reference), as one ``flat_adam`` kernel per bucket.

The port of ``apex_tpu.optimizers.fused_adam``.  The bias corrections
come from the device-side step clock, so the step never reads back to
the host; a pipeline ``clip_coef`` folds into ``grad_scale``, which the
kernel reads as ``1/grad_scale``.  The per-leaf path is the plain twin
leaf by leaf, on the CPU only (the oracle the bucketed step is held
to).  ``capturable`` is accepted for parity and changes nothing (the
step is already free of host reads); ``amsgrad=True`` raises as the
reference does.
"""

from __future__ import annotations

import torch

from apex_tpu_torch._tree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._base import FusedOptimizerBase


class FusedAdam(FusedOptimizerBase):
    defaults = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                    capturable=False, set_grad_none=True)

    def __init__(self, params, betas=None, **kw):
        if betas is not None:
            kw["beta1"], kw["beta2"] = betas
        if kw.pop("amsgrad", False):
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")  # the reference raises the same
        super().__init__(params, **kw)

    def init_state(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"exp_avg": tree_map(zeros, params),
                "exp_avg_sq": tree_map(zeros, params)}

    def _kw(self, h, step, grad_scale):
        return dict(lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
                    eps=h["eps"], weight_decay=h["weight_decay"], step=step,
                    adam_w_mode=h["adam_w_mode"],
                    bias_correction=h["bias_correction"],
                    grad_scale=grad_scale)

    def _step_math(self, params, grads, opt_state, step, grad_scale, hypers):
        kw = self._kw(hypers, step, grad_scale)
        ps, treedef = tree_flatten(params)
        out = [mt.flat_adam_ref(p, g, m, v, **kw) for p, g, m, v in zip(
            ps, tree_leaves(grads), tree_leaves(opt_state["exp_avg"]),
            tree_leaves(opt_state["exp_avg_sq"]))]
        new_p, new_m, new_v = ([tree_unflatten(treedef, [o[i] for o in out])
                                for i in range(3)])
        return new_p, {"exp_avg": new_m, "exp_avg_sq": new_v}

    def _flat_bucket_step(self, bucket_index, p, g, state, step, grad_scale,
                          hypers, found_inf, extra):
        mt.flat_adam(p, g, state["exp_avg"], state["exp_avg_sq"],
                     found_inf=found_inf,
                     **self._kw(hypers, step, grad_scale))
