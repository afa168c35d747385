"""Shared machinery of the fused optimizer facades.

The port of ``apex_tpu.optimizers._base``.  Construct with a params tree,
call ``step(grads)``.  On the bucketed path (the default) a one-time
:class:`~apex_tpu_torch.multi_tensor_apply.packer.BucketPlan` packs the
params, the f32 masters (O2) and the optimizer state into flat buckets
that stay packed between steps; ``step`` runs ONE flat kernel per bucket,
in place, then refreshes the model bucket from the masters with one
cast-copy.  The params the model computes with (:attr:`params`) are
views into the model bucket, so they see every step without an unpack.
``fuse_buckets=False`` (or a tree the packer declines) runs the per-leaf
update instead, out of place, in plain PyTorch: the oracle the bucketed
step is held to.  It runs only on the CPU; on the card the step goes
through the flat kernels, so an optimizer there without a plan raises.

The overflow skip is branch-free and stays on the device: the flat
kernels take ``found_inf`` and write nothing when it is set, the
per-leaf path selects the old values with ``torch.where``, and the step
clock (a device i32) steps back on a skipped step.

Not ported yet (each raises ``NotImplementedError`` naming its item):
``offload_state``, ``rechunk`` and the fp8 slots (ROADMAP Queue 1,
slice 2 item T4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from apex_tpu_torch._tree import (tree_leaves, tree_map, tree_structure)
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan

Tree = Any

STATE_TODO = ("optimizer state offload, rechunk and fp8 slots are not "
              "ported yet: ROADMAP Queue 1, slice 2 item T4")
PER_LEAF_CPU_ONLY = (
    "the per-leaf optimizer step is plain PyTorch and runs only on the "
    "CPU; on {device} the step runs through the flat kernels, which need "
    "a bucket plan: pass fuse_buckets=True and a non-empty tree of "
    "floating-point leaves, or put the params on the CPU (device='cpu')")


def _is_low_precision(tree) -> bool:
    return any(l.dtype in (torch.bfloat16, torch.float16)
               for l in tree_leaves(tree) if l.is_floating_point())


def _select(keep, new_tree, old_tree):
    """Branch-free elementwise keep ? new : old over matching trees."""
    return tree_map(lambda a, b: torch.where(keep, a, b), new_tree, old_tree)


def _skip_on_overflow(found_inf, new_work, old_work, new_state, old_state):
    """The found_inf skip of the per-leaf path: the old values when the
    flag is set."""
    keep = found_inf == 0
    return (_select(keep, new_work, old_work),
            _select(keep, new_state, old_state))


def _fold_clip(grad_scale, clip_coef):
    """Fold a global-norm clip coefficient into the gradient scale: the
    kernels multiply grads by ``1/grad_scale``, so ``grad_scale/clip``
    clips with no extra pass over the gradients."""
    if clip_coef is None:
        return grad_scale
    gs = (grad_scale.to(torch.float32) if isinstance(grad_scale, torch.Tensor)
          else torch.full((), grad_scale, dtype=torch.float32,
                          device=clip_coef.device))
    return gs / clip_coef.to(torch.float32)


class FusedOptimizerBase:
    """Subclasses set ``defaults`` and implement ``init_state``,
    ``_step_math`` (per-leaf path) and ``_flat_bucket_step`` (bucketed
    path)."""

    defaults: Dict[str, Any] = {}

    def __init__(self, params: Tree, master_weights: Optional[bool] = None,
                 masters: Optional[Tree] = None, offload_state: bool = False,
                 fuse_buckets: bool = True,
                 max_bucket_bytes: Optional[int] = None, **hypers):
        self.hypers: Dict[str, Any] = dict(self.defaults)
        unknown = set(hypers) - set(self.hypers)
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        self.hypers.update(hypers)
        if offload_state:
            raise NotImplementedError(STATE_TODO)
        if masters is not None:
            # masters from amp.initialize, taken from the ORIGINAL f32
            # values (upcasting the rounded half params would lose bits)
            if master_weights is False:
                raise ValueError("masters= provided together with "
                                 "master_weights=False — contradictory")
            if not _is_low_precision(params):
                raise ValueError(
                    "masters= provided but params are not low-precision"
                    " — masters only apply to half-precision params")
            if tree_structure(masters) != tree_structure(params):
                raise ValueError(
                    "masters tree structure does not match params")
            master_weights = True
        if master_weights is None:
            master_weights = _is_low_precision(params)
        self.master_weights = master_weights and _is_low_precision(params)
        if not self.master_weights:
            masters = None
        else:
            masters = tree_map(lambda x: x.detach().to(torch.float32),
                               masters if masters is not None else params)
        work = masters if masters is not None else params
        self.device = tree_leaves(params)[0].device

        self._plan = (BucketPlan.from_tree(
            work, params if masters is not None else None,
            max_bucket_bytes=max_bucket_bytes) if fuse_buckets else None)
        if self._plan is None and self.device.type != "cpu":
            raise ValueError(PER_LEAF_CPU_ONLY.format(device=self.device))
        self.fuse_buckets = self._plan is not None
        if self._plan is not None:
            self._param_bufs = self._plan.pack_model(params)
            self._master_bufs = (self._plan.pack_work(masters)
                                 if masters is not None else None)
            # persistent views: the model computes with these, and every
            # in-place step shows through them
            self._params_view = self._plan.unpack_model(self._param_bufs)
            self._masters_view = (self._plan.unpack(self._master_bufs)
                                  if masters is not None else None)
            self.opt_state = self.init_state_packed(self._plan, work)
        else:
            self._params_tree = tree_map(lambda x: x.detach(), params)
            self._masters_tree = masters
            self.opt_state = self.init_state(work)
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)

    # ---- views -------------------------------------------------------------
    @property
    def params(self) -> Tree:
        """The current params.  Bucketed: views into the model bucket
        (the same tensors every step)."""
        if self._plan is None:
            return self._params_tree
        return self._params_view

    @params.setter
    def params(self, value: Tree):
        if self._plan is None:
            self._params_tree = value
        else:
            for buf, new in zip(self._param_bufs,
                                self._plan.pack_model(value)):
                buf.copy_(new)

    @property
    def masters(self) -> Optional[Tree]:
        if self._plan is None:
            return self._masters_tree
        return self._masters_view

    @masters.setter
    def masters(self, value: Optional[Tree]):
        if self._plan is None:
            self._masters_tree = value
            return
        if value is None or self._master_bufs is None:
            raise ValueError("masters exist exactly when the optimizer was "
                             "built with master weights")
        for buf, new in zip(self._master_bufs, self._plan.pack_work(value)):
            buf.copy_(new)

    # ---- functional core ---------------------------------------------------
    def init_state(self, params: Tree) -> Tree:
        raise NotImplementedError

    def init_state_packed(self, plan: BucketPlan, work: Tree) -> Dict:
        """Each field of the per-leaf state, bucket-packed."""
        state = self.init_state(work)
        return {k: plan.pack_state_field(v) for k, v in state.items()}

    def _step_math(self, params, grads, opt_state, step, grad_scale, hypers):
        """Pure per-leaf update on the (possibly master) params."""
        raise NotImplementedError

    def _flat_bucket_step(self, bucket_index: int, p, g, state, step,
                          grad_scale, hypers, found_inf) -> None:
        """One bucket's kernel, in place on ``p`` and ``state``; writes
        nothing when ``found_inf`` is set."""
        raise NotImplementedError

    def _full_step(self, params, masters, opt_state, grads, step,
                   grad_scale, hypers, found_inf=None):
        work = masters if masters is not None else params
        new_work, new_state = self._step_math(
            work, grads, opt_state, step, grad_scale, hypers)
        if found_inf is not None:
            new_work, new_state = _skip_on_overflow(
                found_inf, new_work, work, new_state, opt_state)
        if masters is not None:
            new_params = tree_map(lambda p, m: m.to(p.dtype), params,
                                  new_work)
            return new_params, new_work, new_state
        return new_work, None, new_state

    def _full_step_flat(self, grads, step, grad_scale, hypers,
                        found_inf=None) -> None:
        """Bucketed step: grads pack (one concatenate per bucket) unless
        they arrive packed from the flat pipeline; then ONE kernel per
        bucket in place, then the model buckets refresh from the
        masters."""
        work_bufs = (self._master_bufs if self._master_bufs is not None
                     else self._param_bufs)
        grad_bufs = (list(grads) if self._plan.is_packed(grads)
                     else self._plan.pack(grads))
        for bi, (p, g) in enumerate(zip(work_bufs, grad_bufs)):
            state = {k: v[bi] for k, v in self.opt_state.items()}
            self._flat_bucket_step(bi, p, g, state, step, grad_scale,
                                   hypers, found_inf)
        if self._master_bufs is not None:
            for pb, wb in zip(self._param_bufs, self._master_bufs):
                pb.copy_(wb)

    # ---- stateful facade -------------------------------------------------
    def step(self, grads: Tree, grad_scale=1.0, found_inf=None,
             clip_coef=None) -> Tree:
        """Apply one update; returns the new params.

        ``grads``: a tree, the plan's per-bucket flat buffers, or a
        ``FlatGrads`` bundle (whose ``found_inf`` and ``clip_coef`` are
        used unless given here).  ``found_inf``: optional device i32/bool
        scalar; when set, params, masters and state keep their values and
        the step clock does not advance — on the device, no host read."""
        if hasattr(grads, "bufs") and hasattr(grads, "found_inf"):
            if self._plan is None:
                raise ValueError(
                    "FlatGrads/packed gradients require the bucketed "
                    "path — this optimizer runs per-leaf "
                    "(fuse_buckets=False or the packer declined its "
                    "tree); pass a gradient tree instead")
            if found_inf is None:
                found_inf = grads.found_inf
            if clip_coef is None:
                clip_coef = grads.clip_coef
            grads = grads.bufs
        grad_scale = _fold_clip(grad_scale, clip_coef)
        if found_inf is not None:
            found_inf = found_inf.to(torch.int32)
        self.step_count = self.step_count + 1
        hypers = dict(self.hypers)
        if self._plan is not None:
            self._full_step_flat(grads, self.step_count, grad_scale, hypers,
                                 found_inf)
        else:
            self._params_tree, self._masters_tree, self.opt_state = \
                self._full_step(self._params_tree, self._masters_tree,
                                self.opt_state, grads, self.step_count,
                                grad_scale, hypers, found_inf)
        if found_inf is not None:
            # a skipped step does not advance the clock
            self.step_count = torch.where(found_inf > 0,
                                          self.step_count - 1,
                                          self.step_count)
        return self.params

    def rechunk(self, max_bucket_bytes) -> bool:
        raise NotImplementedError(STATE_TODO)

    def enable_fp8(self, policy=None) -> None:
        raise NotImplementedError(STATE_TODO)

    # ---- serialization (torch Optimizer.state_dict shape) ---------------
    def state_dict(self):
        """Per-leaf checkpoint layout (the same for both paths), copied
        out of the live buffers.  Reads the step clock to the host."""
        if self._plan is not None:
            state = {k: tree_map(torch.clone,
                                 self._plan.unpack_state_field(v))
                     for k, v in self.opt_state.items()}
        else:
            state = tree_map(torch.clone, self.opt_state)
        masters = self.masters
        return {"step": int(self.step_count),
                "hypers": dict(self.hypers),
                "state": state,
                "masters": (tree_map(torch.clone, masters)
                            if masters is not None else None)}

    def load_state_dict(self, sd):
        self.step_count = torch.full((), int(sd["step"]), dtype=torch.int32,
                                     device=self.device)
        self.hypers.update(sd["hypers"])
        to_dev = (lambda x: x.to(self.device, copy=True))
        if self._plan is not None:
            self.opt_state = {
                k: [b.to(self.device) for b in
                    self._plan.pack_state_field(tree_map(to_dev, v))]
                for k, v in sd["state"].items()}
        else:
            self.opt_state = tree_map(to_dev, sd["state"])
        if sd.get("masters") is not None:
            self.masters = tree_map(to_dev, sd["masters"])

    @property
    def lr(self):
        return self.hypers["lr"]

    @lr.setter
    def lr(self, value):
        self.hypers["lr"] = value
