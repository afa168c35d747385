"""Parameters from the JAX package's layout.

``apex_tpu.serving.init_params`` returns a pytree (a dict of arrays with
a ``layers`` list of dicts).  Given that tree with numpy leaves
(``jax.device_get`` makes one), :func:`params_from_jax` returns the same
structure as f32 tensors on a device — the port's parameter layout is
the reference's, so no name or axis changes.  The tests use it to run
both packages on the same weights.

:func:`resnet_from_jax` does the same for the flax ResNet's ``params``
and ``batch_stats``.  The port's ResNet stores every leaf in the flax
layout too (conv kernels HWIO, the dense kernel (in, out), BatchNorm
scale/bias/mean/var as (C,) vectors): the tree then flattens in the
reference's order with the reference's shapes, so the bucket plan built
over it has the reference's ``layout()`` and the same bucket bytes.  The
forward takes torch's OIHW and (out, in) views of those kernels at use.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device


def params_from_jax(tree, device=None):
    """``tree`` of numpy arrays -> the same tree of f32 tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return conv(tree)


def resnet_from_jax(params, batch_stats, device=None):
    """The flax ResNet's ``(params, batch_stats)`` with numpy leaves ->
    the port's trees (same names, same layouts, each leaf keeping its
    float dtype: f32, or bf16 after amp O2's cast) on ``device``
    (default: the card).  Flatten order, and so the bucket plan, is the
    reference's."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(dev)

    return conv(params), conv(batch_stats)
