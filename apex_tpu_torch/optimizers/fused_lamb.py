"""FusedLAMB: Adam moments plus a per-tensor trust ratio
(``||p|| / ||update||``), after a global-gradient-norm clip.

The port of ``apex_tpu.optimizers.fused_lamb``, the reference's
two-stage ``multi_tensor_lamb`` with a ``multi_tensor_l2norm``
prologue.  On the bucketed path the prologue is one ``flat_l2norm`` per
bucket, root-sum-square combined across buckets into the clip factor on
the device; each bucket then takes one ``flat_lamb`` (two kernels, the
trust ratios between them).  The per-leaf path is the plain twin leaf
by leaf, on the CPU only (the oracle the bucketed step is held to).

As in the reference, the two clips compose: a pipeline ``clip_coef``
folds into ``grad_scale`` before the prologue, which then judges the
gradients as already clipped.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _numerics
from apex_tpu_torch._tree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._base import FusedOptimizerBase


def _clip_coeff(gnorm, grad_scale, max_grad_norm):
    """``max_norm / norm`` when the unscaled norm exceeds a positive
    ``max_grad_norm``, else 1 (a 0-d device tensor; no host read)."""
    if isinstance(grad_scale, torch.Tensor):
        grad_scale = grad_scale.to(device=gnorm.device, dtype=torch.float32)
    gnorm = gnorm / grad_scale
    maxn = float(max_grad_norm)
    if maxn <= 0:
        return torch.ones_like(gnorm)
    return torch.where(gnorm > maxn, maxn / gnorm, torch.ones_like(gnorm))


class FusedLAMB(FusedOptimizerBase):
    defaults = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6,
                    weight_decay=0.01, bias_correction=True,
                    max_grad_norm=1.0, use_nvlamb=False)

    def __init__(self, params, betas=None, **kw):
        if betas is not None:
            kw["beta1"], kw["beta2"] = betas
        if kw.pop("amsgrad", False):
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        super().__init__(params, **kw)

    def init_state(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"exp_avg": tree_map(zeros, params),
                "exp_avg_sq": tree_map(zeros, params)}

    def _kw(self, h, step, grad_scale, clip):
        return dict(lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
                    eps=h["eps"], weight_decay=h["weight_decay"], step=step,
                    bias_correction=h["bias_correction"],
                    grad_scale=grad_scale, clip_coeff=clip,
                    use_nvlamb=h["use_nvlamb"])

    def _step_math(self, params, grads, opt_state, step, grad_scale, hypers):
        ps, treedef = tree_flatten(params)
        gs = tree_leaves(grads)
        ms = tree_leaves(opt_state["exp_avg"])
        vs = tree_leaves(opt_state["exp_avg_sq"])
        # the global norm over every leaf (reference _functional
        # .global_grad_norm), then the flat kernel's plain twin leaf by
        # leaf, each leaf one segment
        gnorm = _numerics.sqrt(
            sum(torch.sum(g.float() * g.float()) for g in gs))
        kw = self._kw(hypers, step, grad_scale,
                      _clip_coeff(gnorm, grad_scale, hypers["max_grad_norm"]))
        out = [mt.flat_lamb_ref(
            p.reshape(-1), g.reshape(-1), m.reshape(-1), v.reshape(-1),
            (p.numel(),), **kw)
            for p, g, m, v in zip(ps, gs, ms, vs)]
        shaped = [[t.reshape(p.shape) for t in o] for o, p in zip(out, ps)]
        new_p, new_m, new_v = ([tree_unflatten(treedef, [o[i] for o in shaped])
                                for i in range(3)])
        return new_p, {"exp_avg": new_m, "exp_avg_sq": new_v}

    def _flat_prologue(self, work_bufs, grad_bufs, step, grad_scale,
                       hypers):
        """The clip factor from the global gradient norm, once across ALL
        buckets: one ``flat_l2norm`` per bucket, root-sum-square
        combined."""
        gnorm = _numerics.sqrt(
            sum(mt.flat_l2norm(g) ** 2 for g in grad_bufs))
        return _clip_coeff(gnorm, grad_scale, hypers["max_grad_norm"])

    def _flat_bucket_step(self, bucket_index, p, g, state, step, grad_scale,
                          hypers, found_inf, extra):
        mt.flat_lamb(p, g, state["exp_avg"], state["exp_avg_sq"],
                     self._plan.segment_sizes(bucket_index),
                     seg_offsets=self._plan.segment_offsets(bucket_index),
                     found_inf=found_inf,
                     **self._kw(hypers, step, grad_scale, extra))


class FusedMixedPrecisionLamb(FusedLAMB):
    """LAMB stepping f32 masters for low-precision params (reference
    ``apex/optimizers/fused_mixed_precision_lamb.py``): the base class
    keeps masters whenever the params are half; this forces it on."""

    def __init__(self, params, **kw):
        kw["master_weights"] = True
        super().__init__(params, **kw)
