"""Flat AMP gradient pipeline: pack once, one fused pass per bucket.

The port of ``apex_tpu.amp.flat_pipeline``:

    scaled value-and-grad             grads w.r.t. the model params
        └─ pack_grads                 one torch.cat per dtype bucket
            └─ flat_unscale_norm      unscale + non-finite + sum of
                                      squares, one read per bucket
                └─ tiny combine       global norm, found_inf, clip_coef
                    └─ optimizer.step(FlatGrads)

and, under ``microbatches=N``, each microbatch's packed grads add into
persistent f32 accumulator buckets with ``flat_accumulate`` (the flag
latches), then ONE unscale+norm at :meth:`FlatGradPipeline.finalize`
with the loss scale and the microbatch count folded into one
``inv_scale``.  Everything stays on the device.

Not ported yet (each raises ``NotImplementedError`` naming its item):
the data-parallel ``reduce`` and ``interleave`` (ROADMAP Queue 1,
slice 2 item T2), fp8 delayed scaling (T5), and the autotuned
``"auto"`` knobs (T6).
"""

from __future__ import annotations

import functools
from typing import Any, List, NamedTuple, Optional

import torch

from apex_tpu_torch import _numerics
from apex_tpu_torch._tree import tree_leaves
from apex_tpu_torch.amp.scaler import (LossScaleState, scale_loss,
                                       split_microbatch_args, stack_trees,
                                       value_and_grad)
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan, cached_plan
from apex_tpu_torch.ops import multi_tensor as mt

Tree = Any

DDP_TODO = ("the flat pipeline's data-parallel reduce/interleave is not "
            "ported yet: ROADMAP Queue 1, slice 2 item T2")


class FlatGrads(NamedTuple):
    """The flat pipeline's gradient bundle: unscaled per-bucket buffers,
    the PRE-clip global L2 norm (f32), the i32 overflow flag and the f32
    clip coefficient (exactly 1.0 when no clipping applies; it folds into
    the optimizer step, never into the buffers)."""
    bufs: List[torch.Tensor]
    grad_norm: torch.Tensor
    found_inf: torch.Tensor
    clip_coef: torch.Tensor


class GradAccum(NamedTuple):
    """Microbatch accumulation state: per-bucket f32 accumulators of the
    SCALED grads, the i32 overflow latch, and the number of microbatches
    accumulated (a host count: the schedule is static)."""
    bufs: List[torch.Tensor]
    found_inf: torch.Tensor
    count: int

    @staticmethod
    def zeros(plan: BucketPlan, device) -> "GradAccum":
        return GradAccum(
            bufs=[torch.zeros(b.size, dtype=torch.float32, device=device)
                  for b in plan.buckets],
            found_inf=torch.zeros((), dtype=torch.int32, device=device),
            count=0)


def _scaler_state(state) -> LossScaleState:
    return getattr(state, "scaler", state)


class FlatGradPipeline:
    """Pack-once gradient pipeline over a :class:`BucketPlan`.

    Construct from a bucketed fused optimizer (its plan; the buffers then
    feed ``optimizer.step`` with no re-pack) or from a params tree (a
    cached standalone plan).  ``max_grad_norm > 0`` enables global-norm
    clipping through the clip coefficient."""

    def __init__(self, optimizer=None, plan: Optional[BucketPlan] = None,
                 params: Optional[Tree] = None, max_grad_norm: float = 0.0,
                 axis_name: Optional[str] = None, eps: float = 1e-6,
                 interleave: bool = False,
                 reduce_decompose: str = "psum", max_bucket_bytes=None,
                 fp8=None):
        if axis_name is not None or interleave \
                or reduce_decompose != "psum":
            raise NotImplementedError(DDP_TODO)
        if fp8 is not None:
            raise NotImplementedError(
                "fp8 gradient scaling is not ported yet: ROADMAP Queue 1, "
                "slice 2 item T5")
        if max_bucket_bytes == "auto":
            raise NotImplementedError(
                "autotuned pipeline knobs are not ported yet: ROADMAP "
                "Queue 1, slice 2 item T6")
        if plan is None and optimizer is not None:
            plan = getattr(optimizer, "_plan", None)
            if plan is None:
                raise ValueError(
                    "optimizer has no bucket plan (fuse_buckets=False or "
                    "the packer declined its tree) — the flat pipeline "
                    "needs the bucketed path; use the per-leaf amp "
                    "surface instead")
        if plan is not None and max_bucket_bytes is not None \
                and plan.max_bucket_bytes != max_bucket_bytes:
            raise ValueError(
                "max_bucket_bytes conflicts with the supplied plan (built "
                f"with max_bucket_bytes={plan.max_bucket_bytes}) — chunk "
                "at the source instead, or omit it here")
        self.device = None
        if optimizer is not None:
            self.device = optimizer.device
        if plan is None and params is not None:
            plan = cached_plan(params, max_bucket_bytes=max_bucket_bytes)
            self.device = tree_leaves(params)[0].device
        if plan is None:
            raise ValueError("need one of optimizer=, plan= or params=")
        self.plan = plan
        self.optimizer = optimizer
        self.max_grad_norm = float(max_grad_norm)
        self.eps = float(eps)

    def _resolve_device(self, tree: Tree) -> None:
        if self.device is None:
            self.device = tree_leaves(tree)[0].device

    # ---- stages ----------------------------------------------------------
    def pack(self, grads: Tree) -> List[torch.Tensor]:
        """Tree -> per-bucket flat buffers (the ONE gradient pack);
        already-packed input passes through."""
        if self.plan.is_packed(grads):
            return list(grads)
        self._resolve_device(grads)
        return self.plan.pack_grads(grads)

    def reduce(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The data-parallel reduce: the identity without ``axis_name``
        (the only construction the port takes so far)."""
        return bufs

    def unscale_and_norm(self, bufs: List[torch.Tensor], state=None,
                         inv_scale=None) -> FlatGrads:
        """One ``flat_unscale_norm`` per bucket plus the tiny combine.
        Pass a scaler ``state`` or an explicit ``inv_scale`` (default 1)."""
        if inv_scale is None:
            inv_scale = (1.0 / _scaler_state(state).loss_scale
                         if state is not None else 1.0)
        outs, norm_sqs, flags = [], [], []
        for buf in bufs:
            o, nsq, flag = mt.flat_unscale_norm(buf, inv_scale)
            outs.append(o)
            norm_sqs.append(nsq)
            flags.append(flag)
        found_inf = functools.reduce(torch.maximum, flags)
        norm = _numerics.sqrt(functools.reduce(torch.add, norm_sqs))
        maxn = self.max_grad_norm
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        if maxn > 0:
            clip = torch.where(norm > maxn, maxn / (norm + self.eps), one)
        else:
            clip = one
        # overflow: the step is skipped through found_inf regardless, so
        # pin clip_coef to the neutral 1.0 (never 0 or NaN)
        clip = torch.where(found_inf > 0, one, clip)
        return FlatGrads(bufs=outs, grad_norm=norm, found_inf=found_inf,
                         clip_coef=clip)

    # ---- microbatch accumulation -----------------------------------------
    def init_accum(self) -> GradAccum:
        return GradAccum.zeros(self.plan, self.device)

    def accumulate(self, acc: GradAccum, grads: Tree) -> GradAccum:
        """Add one microbatch's (still scaled) grads into the accumulator,
        in place: pack if needed, then ONE ``flat_accumulate`` per bucket.
        The overflow flag latches."""
        bufs = self.pack(grads)
        flags = [acc.found_inf]
        for a, g in zip(acc.bufs, bufs):
            flags.append(mt.flat_accumulate(a, g)[1])
        return GradAccum(bufs=acc.bufs,
                         found_inf=functools.reduce(torch.maximum, flags),
                         count=acc.count + 1)

    def finalize(self, acc: GradAccum, state=None, inv_scale=None,
                 average: bool = True) -> FlatGrads:
        """Accumulator -> FlatGrads: the fused unscale+norm+clip with the
        loss scale and (``average``) the microbatch count folded into one
        ``inv_scale``; the latched flag ORs into the epilogue's own."""
        bufs = self.reduce(acc.bufs)
        if inv_scale is None:
            inv_scale = (1.0 / _scaler_state(state).loss_scale
                         if state is not None
                         else torch.ones((), dtype=torch.float32,
                                         device=acc.found_inf.device))
        elif not isinstance(inv_scale, torch.Tensor):
            inv_scale = torch.full((), inv_scale, dtype=torch.float32,
                                   device=acc.found_inf.device)
        if average:
            inv_scale = inv_scale / float(max(acc.count, 1))
        flat = self.unscale_and_norm(bufs, inv_scale=inv_scale)
        return flat._replace(
            found_inf=torch.maximum(flat.found_inf, acc.found_inf))

    def reset_accum(self, acc: GradAccum) -> GradAccum:
        """The accumulator zeroed in place for the next step."""
        for b in acc.bufs:
            b.zero_()
        return GradAccum(bufs=acc.bufs, found_inf=torch.zeros_like(
            acc.found_inf), count=0)

    # ---- end-to-end ------------------------------------------------------
    def scaled_value_and_grad(self, loss_fn, state, *args,
                              has_aux: bool = False, microbatches: int = 1,
                              **kwargs):
        """value-and-grad of the LOSS-SCALED objective, gradients flat:
        ``((loss, aux?), FlatGrads)``.  ``microbatches=N`` splits the
        batch arguments (``args[1:]``) into N and accumulates flat; the
        loss is the mean over microbatches and the aux comes back
        stacked along a leading axis."""
        sstate = _scaler_state(state)
        if microbatches > 1:
            return self._microbatched(loss_fn, sstate, args, has_aux,
                                      int(microbatches), kwargs)

        def scaled_fn(*a, **kw):
            out = loss_fn(*a, **kw)
            if has_aux:
                loss, aux = out
                return scale_loss(loss, sstate), aux
            return scale_loss(out, sstate)

        (scaled, aux), grads = value_and_grad(scaled_fn, *args,
                                              has_aux=has_aux, **kwargs)
        bufs = self.reduce(self.pack(grads))
        flat = self.unscale_and_norm(bufs, sstate)
        loss = scaled / sstate.loss_scale
        return ((loss, aux) if has_aux else loss), flat

    def _microbatched(self, loss_fn, sstate, args, has_aux, n, kwargs):
        params, micros = split_microbatch_args(args, n)
        self._resolve_device(params)

        def scaled_fn(p, *b):
            out = loss_fn(p, *b, **kwargs)
            if has_aux:
                loss, aux = out
                return scale_loss(loss, sstate), aux
            return scale_loss(out, sstate), None

        acc = self.init_accum()
        scaled_sum = torch.zeros((), dtype=torch.float32,
                                 device=self.device)
        auxes = []
        for micro in micros:
            (scaled, aux), grads = value_and_grad(scaled_fn, params, *micro,
                                                  has_aux=True)
            acc = self.accumulate(acc, grads)
            scaled_sum = scaled_sum + scaled
            auxes.append(aux)
        flat = self.finalize(acc, sstate, average=True)
        loss = scaled_sum / (float(n) * sstate.loss_scale)
        if has_aux:
            return (loss, stack_trees(auxes)), flat
        return loss, flat

    def step(self, flat: FlatGrads, grad_scale=1.0) -> Tree:
        """``optimizer.step`` on the packed buffers."""
        if self.optimizer is None:
            raise ValueError("pipeline was built without an optimizer")
        return self.optimizer.step(flat, grad_scale=grad_scale)

    def grads_tree(self, flat: FlatGrads) -> Tree:
        """The buffers as a tree of views (inspection and tests)."""
        return self.plan.unpack_grads(flat.bufs)
