"""Activation offload under rematerialization (port of
``apex_tpu.offload``).

:func:`offload_checkpoint` rematerializes a function: every tensor its
backward needs is recomputed, except the activations tagged with
:func:`checkpoint_name`.  A tag in ``offload_names`` is a saved
residual in pinned host memory (copied there in the forward, back to
the card when the backward reads it); a tag in ``save_names`` is a
saved residual left on the card.  Outside an ``offload_checkpoint``
scope a tag is the identity.

It is built from torch's own tools: ``torch.utils.checkpoint`` without
reentry, and, inside it, ``torch.autograd.graph.saved_tensors_hooks``
whose pack hook takes the tensors that an op saves for its backward:

- a saved tensor that is a tagged activation (or a view of one) goes to
  pinned host memory (offloaded) or is kept (saved);
- a parameter (a leaf that requires grad, or a view of one) is kept: it
  is alive anyway and needs no recomputation;
- every other tensor is the checkpoint's, recomputed in the backward.

The recomputation reruns the function only until it has rebuilt the
last tensor that the checkpoint took (torch's early stop), so the ops
that follow, such as the matmul that reads an offloaded hidden, are not
rerun.  An op before a tag still is: an eager program cannot skip a
step of its forward.  ``host_copies`` counts, by tag name, the tensors
that went to the host.  The recomputed forward draws the same dropout
masks: torch's RNG state is restored for it, and the flash kernels take
their dropout seed as an input.
"""

from __future__ import annotations

import collections
import functools
import weakref
from typing import Callable, Sequence

import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.utils.checkpoint import checkpoint

__all__ = ["checkpoint_name", "offload_checkpoint", "host_copies"]

host_copies: collections.Counter = collections.Counter()


class _Scope:
    """One call of an :func:`offload_checkpoint`-wrapped function: its
    tag names and the tensors tagged in the run now going (the forward,
    then the recomputation)."""

    def __init__(self, offload_names, save_names):
        self.offload, self.save = offload_names, save_names
        self.runs = 0
        self.tags: dict = {}       # storage address -> (ref, name, kind)

    def tag(self, x: torch.Tensor, name: str) -> None:
        kind = ("offload" if name in self.offload
                else "save" if name in self.save else None)
        if kind is not None:
            self.tags[x.untyped_storage().data_ptr()] = (weakref.ref(x),
                                                         name, kind)

    def find(self, t: torch.Tensor):
        hit = self.tags.get(t.untyped_storage().data_ptr())
        if hit is None or hit[0]() is None:
            return None
        return hit[1:]


_SCOPES: list = []


def _is_param(t: torch.Tensor) -> bool:
    base = t._base if t._base is not None else t
    return base.is_leaf and base.requires_grad


def _hooks(scope: _Scope, recompute: bool):
    """Pack and unpack hooks over the checkpoint's own (the innermost
    hooks, read when the run starts)."""
    outer = torch._C._autograd._top_saved_tensors_default_hooks(False)
    outer_pack, outer_unpack = outer

    def pack(t):
        hit = scope.find(t)
        if hit is None:
            if _is_param(t):
                return ("keep", t)
            return ("checkpoint", outer_pack(t))
        name, kind = hit
        if recompute:
            # the forward's copy serves the backward; nothing to take
            return ("keep", None)
        if kind == "save":
            return ("keep", t)
        host_copies[name] += 1
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=True)
        return ("host", host, t.device)

    def unpack(packed):
        if packed[0] == "checkpoint":
            return outer_unpack(packed[1])
        if packed[0] == "host":
            return packed[1].to(packed[2], non_blocking=True)
        return packed[1]

    return saved_tensors_hooks(pack, unpack)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` as the activation ``name`` (returns ``x``): offloaded or
    saved inside an :func:`offload_checkpoint` that lists it."""
    if _SCOPES:
        _SCOPES[-1].tag(x, name)
    return x


def offload_checkpoint(fn: Callable, offload_names: Sequence[str],
                       save_names: Sequence[str] = ()) -> Callable:
    """Rematerialize ``fn`` with the tagged activations ``offload_names``
    in pinned host memory and ``save_names`` kept on the card; every
    other value is recomputed in the backward (with no names, this is
    plain recomputation)."""
    offload_names, save_names = frozenset(offload_names), frozenset(save_names)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        scope = _Scope(offload_names, save_names)

        def scoped(*a, **k):
            recompute = scope.runs > 0
            scope.runs += 1
            scope.tags.clear()
            _SCOPES.append(scope)
            try:
                with _hooks(scope, recompute):
                    return fn(*a, **k)
            finally:
                _SCOPES.pop()

        return checkpoint(scoped, *args, use_reentrant=False, **kwargs)

    return wrapped
