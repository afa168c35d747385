"""Dynamic loss scaling with its state on the device.

The port of ``apex_tpu.amp.scaler``.  Semantics preserved: scale the
loss before backward; unscale grads; if any grad is non-finite, skip
the step and multiply the scale by ``backoff_factor`` (0.5); after
``growth_interval`` (2000) consecutive clean steps multiply it by
``growth_factor`` (2.0).  The flag, the scale and the growth tracker
are device tensors updated with ``torch.where``: nothing here reads a
value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._tree import tree_flatten, tree_map, tree_unflatten

Tree = Any


@dataclasses.dataclass
class LossScaleState:
    """Carried state of one dynamic loss scaler (0-d device tensors)."""
    loss_scale: torch.Tensor      # f32
    growth_tracker: torch.Tensor  # i32: consecutive clean steps
    found_inf: torch.Tensor       # i32: last step's overflow flag

    @staticmethod
    def create(init_scale: float = 2.0 ** 16, device=None
               ) -> "LossScaleState":
        dev = resolve_device(device)
        return LossScaleState(
            loss_scale=torch.full((), init_scale, dtype=torch.float32,
                                  device=dev),
            growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
            found_inf=torch.zeros((), dtype=torch.int32, device=dev))


@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_loss_scale: float = 1.0
    max_loss_scale: float = 2.0 ** 24
    dynamic: bool = True


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.loss_scale.to(loss.dtype)


def unscale_grads(grads: Tree, state: LossScaleState) -> Tree:
    inv = 1.0 / state.loss_scale
    return tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)


def check_finite(grads: Tree) -> torch.Tensor:
    """i32 flag: 1 iff any grad element is non-finite (on the device)."""
    leaves = tree_flatten(grads)[0]
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    bad = torch.stack([~torch.isfinite(g.float()).all() for g in leaves])
    return bad.any().to(torch.int32)


def update_state(state: LossScaleState, found_inf: torch.Tensor,
                 config: LossScaleConfig = LossScaleConfig(),
                 skipped=None) -> LossScaleState:
    """``update_scale_hysteresis`` semantics, branch-free on the device.
    ``skipped``: the step was skipped externally; the tracker and the
    scale hold."""
    found_inf = found_inf.to(torch.int32)
    if not config.dynamic:
        return dataclasses.replace(state, found_inf=found_inf)
    overflowed = found_inf > 0
    tracker = torch.where(overflowed, torch.zeros_like(state.growth_tracker),
                          state.growth_tracker + 1)
    grow = tracker >= config.growth_interval
    scale = state.loss_scale
    new_scale = torch.where(
        overflowed,
        torch.clamp(scale * config.backoff_factor,
                    min=config.min_loss_scale),
        torch.where(grow,
                    torch.clamp(scale * config.growth_factor,
                                max=config.max_loss_scale),
                    scale))
    tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
    if skipped is not None:
        ext = torch.as_tensor(skipped, device=scale.device).to(
            torch.int32) > 0
        new_scale = torch.where(ext, scale, new_scale)
        tracker = torch.where(ext, state.growth_tracker, tracker)
    return LossScaleState(loss_scale=new_scale, growth_tracker=tracker,
                          found_inf=found_inf)


def value_and_grad(fn, params: Tree, *args, has_aux: bool = False,
                   **kwargs):
    """``((value, aux), grads)`` of ``fn(params, *args)`` with respect to
    every leaf of ``params``.  The leaves enter as detached aliases that
    require grad (no copy), so views into a packed bucket work; a leaf
    the value does not depend on gets a zero gradient, as in JAX."""
    leaves, treedef = tree_flatten(params)
    live = [l.detach().requires_grad_(True) for l in leaves]
    with torch.enable_grad():
        out = fn(tree_unflatten(treedef, live), *args, **kwargs)
        value, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return (value.detach(), aux), tree_unflatten(treedef, grads)


def scaled_value_and_grad(loss_fn, state: LossScaleState, *args,
                          has_aux: bool = False, microbatches: int = 1,
                          **kwargs):
    """value_and_grad of the LOSS-SCALED objective, then unscale, on the
    tree layout (the flat layout is :class:`FlatGradPipeline`'s).

    Returns ``((loss, aux?), grads, found_inf)``.  ``microbatches=N``
    splits every batch argument (``args[1:]``) along its leading axis,
    accumulates the scaled grads in f32 per leaf, and unscales once by
    ``1/(loss_scale * N)``, with the overflow flag latched; with
    ``has_aux`` the aux comes back stacked along a leading axis."""
    def scaled_fn(*a, **kw):
        out = loss_fn(*a, **kw)
        if has_aux:
            loss, aux = out
            return scale_loss(loss, state), aux
        return scale_loss(out, state)

    if microbatches > 1:
        return _microbatched_tree(scaled_fn, state, args, has_aux,
                                  int(microbatches), kwargs)
    (scaled, aux), grads = value_and_grad(scaled_fn, *args, has_aux=has_aux,
                                          **kwargs)
    found_inf = check_finite(grads)
    grads = unscale_grads(grads, state)
    loss = scaled / state.loss_scale
    if has_aux:
        return (loss, aux), grads, found_inf
    return loss, grads, found_inf


def split_microbatch_args(args, n: int) -> Tuple[Tree, List[tuple]]:
    """``(params, [micro args of microbatch i] * n)``: every argument
    after the params splits into ``n`` equal consecutive slices along a
    shared leading batch axis."""
    if len(args) < 2:
        raise ValueError(
            "microbatches=N needs batch arguments after the params "
            "(they are split along their leading axis)")
    params, *batch = args
    leads = {tuple(a.shape[:1]) for a in tree_flatten(tuple(batch))[0]}
    if () in leads or len(leads) != 1:
        raise ValueError(
            "microbatches=N splits every argument after the params "
            "along a shared leading batch axis, but the batch "
            f"arguments have leading dims {sorted(leads)} — close "
            "over non-batch values instead of passing them "
            "positionally")

    def split(a):
        if a.shape[0] % n:
            raise ValueError(
                f"microbatches={n} does not divide the leading batch "
                f"axis of shape {tuple(a.shape)}")
        return a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))

    stacked = tree_map(split, tuple(batch))
    return params, [tree_map(lambda a: a[i], stacked) for i in range(n)]


def stack_trees(trees: List[Tree]) -> Tree:
    """Trees of equal structure -> one tree of leaves stacked on axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _microbatched_tree(scaled_fn, state, args, has_aux, n, kwargs):
    """Per-leaf microbatch accumulation, the oracle of the flat path:
    accumulate SCALED grads in f32 per leaf, unscale once by
    ``1/(loss_scale * n)``, latch found_inf across microbatches."""
    params, micros = split_microbatch_args(args, n)

    def wrapped(p, *b):
        out = scaled_fn(p, *b, **kwargs)
        return out if has_aux else (out, None)

    dev = state.loss_scale.device
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    scaled_sum = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    auxes = []
    for micro in micros:
        (scaled, aux), grads = value_and_grad(wrapped, params, *micro,
                                              has_aux=True)
        acc = tree_map(lambda a, g: a + g.float(), acc, grads)
        bad = torch.maximum(bad, check_finite(acc).to(dev))
        scaled_sum = scaled_sum + scaled
        auxes.append(aux)
    inv = 1.0 / (state.loss_scale * float(n))
    grads = tree_map(lambda a, p: (a * inv).to(p.dtype), acc, params)
    loss = scaled_sum / (float(n) * state.loss_scale)
    if has_aux:
        return (loss, stack_trees(auxes)), grads, bad
    return loss, grads, bad
