"""Fused gradient clipping: the port of
``apex_tpu.contrib.clip_grad.clip_grad`` (the reference's
``apex/contrib/clip_grad/clip_grad.py``, ``multi_tensor_l2norm`` plus
``multi_tensor_scale``).

A tree of gradients is concatenated into one flat buffer (the
reference's ``ravel_pytree``: one dtype, the leaves' promoted one); its
global L2 norm is one ``flat_l2norm`` and the clip one ``flat_scale``.
Packed gradients (the flat pipeline's per-bucket buffer list) skip the
concatenation: one ``flat_l2norm`` per bucket, root-sum-square combined,
and one ``flat_scale`` per bucket, buffers in and buffers out.  Norms
other than 2 (``inf`` included) are plain PyTorch, as the reference's
are XLA.  Nothing is read back to the host: the clip factor stays a
device scalar.  The result comes back in the input's layout, with the
pre-clip total norm: ``(clipped, total_norm)``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _numerics
from apex_tpu_torch._tree import tree_flatten, tree_unflatten
from apex_tpu_torch.ops.multi_tensor import flat_l2norm, flat_scale


def _is_packed(grads) -> bool:
    """A per-bucket flat-buffer list (BucketPlan layout): a PLAIN list or
    tuple of 1-D float tensors.  Clipping by the global norm does not
    depend on the layout, so a tree that happens to be a list of vectors
    gets the same values either way."""
    if type(grads) not in (list, tuple) or not grads:
        return False
    return all(isinstance(g, torch.Tensor) and g.dim() == 1
               and g.is_floating_point() for g in grads)


def _total_norm(flats, norm_type) -> torch.Tensor:
    """The global norm over a list of flat buffers, f32 sums."""
    if norm_type == 2.0:
        return _numerics.sqrt(sum(flat_l2norm(f) ** 2 for f in flats))
    if norm_type == float("inf"):
        return torch.max(torch.stack(
            [torch.max(torch.abs(f.to(torch.float32))) for f in flats]))
    acc = sum(torch.sum(torch.abs(f.to(torch.float32)) ** norm_type)
              for f in flats)
    return acc ** (1.0 / norm_type)


def _clip_scale(total_norm, max_norm, eps) -> torch.Tensor:
    return torch.clamp(max_norm / (total_norm + eps), max=1.0).to(
        torch.float32)


def clip_grad_norm(grads, max_norm, norm_type=2.0, eps=1e-6):
    """Clip a tree of gradients, or a packed per-bucket buffer list, to
    the global norm ``max_norm``; returns ``(clipped, total_norm)``, the
    clipped gradients in the input's layout (packed in, packed out)."""
    if _is_packed(grads):
        total_norm = _total_norm(list(grads), norm_type)
        s = _clip_scale(total_norm, max_norm, eps)
        return type(grads)(flat_scale(g, s)[0] for g in grads), total_norm
    leaves, treedef = tree_flatten(grads)
    flat = torch.cat([l.reshape(-1) for l in leaves])
    total_norm = _total_norm([flat], norm_type)
    clipped, _ = flat_scale(flat, _clip_scale(total_norm, max_norm, eps))
    parts = torch.split(clipped, [l.numel() for l in leaves])
    return tree_unflatten(treedef, [p.reshape(l.shape).to(l.dtype)
                                    for p, l in zip(parts, leaves)]), \
        total_norm


def clip_grad_norm_(grads, max_norm, norm_type=2.0):
    """The reference's entry point (name and trailing underscore).  It
    returns the clipped gradients with the pre-clip total norm,
    ``(clipped, total_norm)``, as the JAX package's does."""
    return clip_grad_norm(grads, max_norm, norm_type)
