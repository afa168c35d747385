"""Shared machinery of the fused optimizer facades.

The port of ``apex_tpu.optimizers._base``.  Construct with a params tree,
call ``step(grads)``.  On the bucketed path (the default) a one-time
:class:`~apex_tpu_torch.multi_tensor_apply.packer.BucketPlan` packs the
params, the f32 masters (O2) and the optimizer state into flat buckets
that stay packed between steps; ``step`` runs an optional prologue over
all buckets (LAMB's global gradient norm), then ONE flat kernel chain per
bucket, in place, then refreshes the model bucket from the masters with one
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

``offload_state=True`` keeps every optimizer-state buffer in host memory
between steps (pinned when the optimizer lives on the card, allocated
once): ``step`` copies each bucket's state to the device
(``non_blocking``, on the compute stream), runs the same flat kernels on
it and copies it back, so the device holds one bucket's state only while
that bucket steps.  Host readers (``state_dict``, ``packed_snapshot``,
``load_state_dict``) first wait on the event recorded after the last
copy back.  The per-leaf path runs only on the CPU, where its state
already lives in host memory: there the flag is a no-op
(``offload_state`` reads False).

:meth:`~FusedOptimizerBase.packed_snapshot` and
:meth:`~FusedOptimizerBase.load_packed_snapshot` are the bucket-native
checkpoint's capture and adoption (``apex_tpu_torch.checkpoint`` v2): one
copy per packed buffer and no per-leaf unpack.  The step writes the
packed buffers in place, so the snapshot's copies are taken on the
compute stream before it returns (offloaded state is copied on the
host), and a later step cannot tear a checkpoint still being written.

Not ported yet (each raises ``NotImplementedError`` naming its item):
``rechunk`` and the fp8 slots (ROADMAP Queue 1, slice 2 item T4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from apex_tpu_torch._tree import (tree_leaves, tree_map, tree_structure)
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan

Tree = Any

STATE_TODO = ("rechunk and the fp8 slots are not ported yet: ROADMAP "
              "Queue 1, slice 2 item T4")
PER_LEAF_CPU_ONLY = (
    "the per-leaf optimizer step is plain PyTorch and runs only on the "
    "CPU; on {device} the step runs through the flat kernels, which need "
    "a bucket plan: pass fuse_buckets=True and a non-empty tree of "
    "floating-point leaves, or put the params on the CPU (device='cpu')")


def _device_copy(buf: torch.Tensor) -> torch.Tensor:
    """A copy of one packed buffer where it lives (on the card: on the
    current stream, returns at once).  The bucket-native checkpoint takes
    every copy through this seam, so tests can count them: one per packed
    buffer and nothing else."""
    return buf.clone()


def _adopt(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a checkpoint's buffer into a live packed buffer in place (for
    a host ``src`` and a device ``dst``: one host-to-device copy).  The
    bucket-native restore takes every copy through this seam."""
    dst.copy_(src.reshape(dst.shape))


def place_on_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory when ``pin``."""
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin)
    out.copy_(t)
    return out


def place_on_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of host tensor ``t`` on ``device`` (``non_blocking``: from
    pinned memory the copy is queued on the current stream)."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(
        t, non_blocking=True)


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
        # the per-leaf path's state is on the host already
        self.offload_state = bool(offload_state) and self.fuse_buckets
        # offloaded state is made on the host: it never occupies the card
        state_like = (tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype),
                               work) if self.offload_state else work)
        if self._plan is not None:
            self._param_bufs = self._plan.pack_model(params)
            self._master_bufs = (self._plan.pack_work(masters)
                                 if masters is not None else None)
            # persistent views: the model computes with these, and every
            # in-place step shows through them
            self._params_view = self._plan.unpack_model(self._param_bufs)
            self._masters_view = (self._plan.unpack(self._master_bufs)
                                  if masters is not None else None)
            self.opt_state = self.init_state_packed(self._plan, state_like)
        else:
            self._params_tree = tree_map(lambda x: x.detach(), params)
            self._masters_tree = masters
            self.opt_state = self.init_state(state_like)
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        # the event recorded after the last step's copies back to the host
        self._offload_done: Optional[torch.cuda.Event] = None
        if self.offload_state:
            self.opt_state = tree_map(self._host_copy, self.opt_state)

    # ---- offloaded state -------------------------------------------------
    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        return place_on_host(t, pin=self.device.type == "cuda")

    def _wait_offload(self) -> None:
        """Block the host until the last step's copies of the offloaded
        state are done (before the host reads or writes it)."""
        if self._offload_done is not None:
            self._offload_done.synchronize()
            self._offload_done = None

    def _mark_offload(self) -> None:
        if self.device.type == "cuda":
            self._offload_done = torch.cuda.Event()
            self._offload_done.record()

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
                          grad_scale, hypers, found_inf, extra) -> None:
        """One bucket's kernel, in place on ``p`` and ``state``; writes
        nothing when ``found_inf`` is set.  ``extra`` is what
        :meth:`_flat_prologue` returned (LAMB's global clip factor)."""
        raise NotImplementedError

    def _flat_prologue(self, work_bufs, grad_bufs, step, grad_scale,
                       hypers):
        """Cross-bucket prologue of the bucketed step, computed once
        before the per-bucket kernels (default: nothing)."""
        return None

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
        they arrive packed from the flat pipeline; then the prologue over
        all buckets, ONE kernel chain per bucket in place, and the model
        buckets refresh from the masters."""
        work_bufs = (self._master_bufs if self._master_bufs is not None
                     else self._param_bufs)
        grad_bufs = (list(grads) if self._plan.is_packed(grads)
                     else self._plan.pack(grads))
        extra = self._flat_prologue(work_bufs, grad_bufs, step, grad_scale,
                                    hypers)
        for bi, (p, g) in enumerate(zip(work_bufs, grad_bufs)):
            state = {k: v[bi] for k, v in self.opt_state.items()}
            if self.offload_state:
                # this bucket's state to the device and back: the device
                # copy is freed when the bucket is done
                host = state
                state = {k: place_on_device(v, self.device)
                         for k, v in host.items()}
            self._flat_bucket_step(bi, p, g, state, step, grad_scale,
                                   hypers, found_inf, extra)
            if self.offload_state:
                for k, v in state.items():
                    host[k].copy_(v, non_blocking=True)
                del state
        if self.offload_state:
            self._mark_offload()
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

    def zero_grad(self):
        """No-op for parity: gradients are returned by the backward, never
        stored on the optimizer."""

    def rechunk(self, max_bucket_bytes) -> bool:
        raise NotImplementedError(STATE_TODO)

    def enable_fp8(self, policy=None) -> None:
        raise NotImplementedError(STATE_TODO)

    # ---- bucket-native checkpoint capture --------------------------------
    def packed_snapshot(self) -> Dict:
        """The bucket-native checkpoint's capture: one copy of every
        packed buffer (params, masters, each state field), through
        :func:`_device_copy`, and no per-leaf unpack.

        The step writes the packed buffers in place, so the copies are
        what a later step cannot tear: device buffers are copied on the
        current stream before this returns (a writer on another thread
        waits on an event recorded after them).  Offloaded state is
        copied in place on the host.  Returns ``{"step", "hypers",
        "plan", "param_bufs", "master_bufs", "state"}``.  Reads the step
        clock to the host."""
        if self._plan is None:
            raise ValueError(
                "packed_snapshot requires the bucketed path "
                "(fuse_buckets=False or the packer declined this tree);"
                " use state_dict() / the v1 checkpoint format instead")
        self._wait_offload()
        return {
            "step": int(self.step_count),
            "hypers": dict(self.hypers),
            "plan": self._plan,
            "param_bufs": [_device_copy(b) for b in self._param_bufs],
            "master_bufs": ([_device_copy(b) for b in self._master_bufs]
                            if self._master_bufs is not None else None),
            "state": {k: [_device_copy(b) for b in v]
                      for k, v in self.opt_state.items()},
        }

    def load_packed_snapshot(self, step, hypers, param_bufs, master_bufs,
                             state) -> None:
        """The inverse of :meth:`packed_snapshot`: copy packed buffers
        (host tensors fresh from a checkpoint, or a snapshot's) into the
        live ones in place, one :func:`_adopt` per buffer, so the params'
        views stay valid.  Offloaded state is adopted on the host.  The
        caller has matched the layout against this optimizer's plan
        (``checkpoint`` compares the v2 header's plan with
        ``self._plan.layout()``)."""
        if self._plan is None:
            raise ValueError(
                "load_packed_snapshot requires the bucketed path")
        if (master_bufs is None) != (self._master_bufs is None):
            raise ValueError("the snapshot's masters do not match this "
                             "optimizer's master_weights setting")
        if sorted(state) != sorted(self.opt_state):
            raise ValueError(f"snapshot state fields {sorted(state)} do "
                             f"not match {sorted(self.opt_state)}")
        self._wait_offload()
        self.step_count = torch.full((), int(step), dtype=torch.int32,
                                     device=self.device)
        self.hypers.update(hypers)
        for dst, src in zip(self._param_bufs, param_bufs):
            _adopt(dst, src)
        if master_bufs is not None:
            for dst, src in zip(self._master_bufs, master_bufs):
                _adopt(dst, src)
        for k, bufs in state.items():
            for dst, src in zip(self.opt_state[k], bufs):
                _adopt(dst, src)

    # ---- serialization (torch Optimizer.state_dict shape) ---------------
    def state_dict(self):
        """Per-leaf checkpoint layout (the same for both paths), copied
        out of the live buffers (offloaded state: host tensors).  Reads
        the step clock to the host."""
        self._wait_offload()
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
        if self.offload_state:
            # re-homed on the host now, into the buffers allocated once:
            # the restored state never passes through device memory
            self._wait_offload()
            to_host = (lambda x: x.to("cpu"))
            for k, v in sd["state"].items():
                for dst, src in zip(self.opt_state[k],
                                    self._plan.pack_state_field(
                                        tree_map(to_host, v))):
                    dst.copy_(src)
        elif self._plan is not None:
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
