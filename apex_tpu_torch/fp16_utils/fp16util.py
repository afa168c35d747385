"""Legacy manual mixed-precision helpers: the port of
``apex_tpu.fp16_utils.fp16util`` (the reference's
``apex/fp16_utils/fp16util.py``: network_to_half, BN_convert_float,
prep_param_lists, master_params_to_model_params, ...).

The unit of state is a params tree (nested dicts and lists of tensors,
:mod:`apex_tpu_torch._tree`), so each helper is a tree transform.
"Half" defaults to bfloat16, as in the JAX package; fp16 is one
``dtype`` argument away.
"""

from __future__ import annotations

from typing import List

import torch

from apex_tpu_torch._tree import (TreeDef, tree_flatten, tree_map,
                                  tree_unflatten)

_NORM_NAME_HINTS = ("batchnorm", "bn", "layernorm", "ln", "norm",
                    "batch_stats")


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tree_to_half(params, dtype=torch.bfloat16):
    """Cast every floating leaf to half precision."""
    return tree_map(lambda x: x.to(dtype) if _is_float(x) else x, params)


def network_to_half(params, dtype=torch.bfloat16):
    """A model in half precision with its normalization layers kept in
    f32 (the reference wraps BatchNorm in f32 shims); norm leaves are
    found by the names on their path."""
    return BN_convert_float(tree_to_half(params, dtype))


def _leaf_names(treedef: TreeDef) -> List[str]:
    """Each leaf's path, its dict keys and list indices joined by ``/``
    (the JAX package's spelling of a key path)."""
    out: List[str] = []

    def walk(d: TreeDef, parts) -> None:
        if d.kind == "leaf":
            out.append("/".join(parts))
        elif d.kind == "dict":
            for k, c in zip(d.keys, d.children):
                walk(c, parts + [str(k)])
        elif d.kind in ("list", "tuple"):
            for i, c in enumerate(d.children):
                walk(c, parts + [str(i)])

    walk(treedef, [])
    return out


def BN_convert_float(params):
    """Normalization-layer leaves back to f32 (BatchNorm statistics and
    affine math stay f32 under half-precision training)."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        x.to(torch.float32) if _is_float(x) and any(
            h in name.lower() for h in _NORM_NAME_HINTS) else x
        for x, name in zip(leaves, _leaf_names(treedef))])


def prep_param_lists(params, flat_master: bool = False):
    """``(model_params, master_params)``: f32 master copies of the model
    tree.  ``flat_master=True`` gives the masters as ONE flat f32 buffer
    and its unflatten function: ``(params, (flat, unravel))``."""
    masters = tree_map(lambda x: x.to(torch.float32) if _is_float(x) else x,
                       params)
    if flat_master:
        leaves, treedef = tree_flatten(masters)
        flat = torch.cat([l.reshape(-1) for l in leaves])

        def unravel(buf):
            parts = torch.split(buf, [l.numel() for l in leaves])
            return tree_unflatten(treedef, [p.reshape(l.shape)
                                            for p, l in zip(parts, leaves)])
        return params, (flat, unravel)
    return params, masters


def master_params_to_model_params(model_params, master_params):
    """The master values in the model's dtypes (a new tree)."""
    return tree_map(lambda p, m: m.to(p.dtype) if _is_float(p) else m,
                    model_params, master_params)


def model_grads_to_master_grads(model_grads):
    """Model-dtype gradients promoted to f32 for the master step."""
    return tree_map(lambda g: g.to(torch.float32) if _is_float(g) else g,
                    model_grads)


def to_python_float(t) -> float:
    """A one-element tensor (or number) as a Python float: a host read."""
    return float(torch.as_tensor(t).reshape(()))
