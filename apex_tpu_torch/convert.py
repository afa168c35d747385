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
:func:`bert_from_jax` does the same for the flax BERT's ``params``, and
:func:`gpt_from_jax` for the flax ``GPTModel``'s.
:func:`dcgan_from_jax` takes the flax DCGAN's two trees
(``examples/dcgan/main_amp.py``): the port's models keep flax's names
and layouts too (kernels HWIO, dense ``(in, out)``) and take torch's
views at use, the transposed convolutions' flip included.
:func:`gpt_block_from_jax` takes the flax GPT block stack of
``examples/gpt/train_block.py`` (or a flax ``SelfMultiheadAttn``'s
params): the port keeps their names and layouts but two,
a Dense's ``kernel`` (in, out) is ``weight`` (the port's linear layers'
name) and the norm-add LayerNorm ``FusedLayerNorm_0`` is ``norm``.  In
the GPT block's dicts both renames keep the sorted key order, so its
tree flattens, packs and buckets as the reference's.
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


def _from_numpy(tree, dev):
    """Nested dicts of numpy leaves -> the same dicts of tensors on
    ``dev``, each leaf keeping its float dtype (f32, or bf16 after amp
    O2's cast)."""
    if isinstance(tree, dict):
        return {k: _from_numpy(v, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(dev)


def resnet_from_jax(params, batch_stats, device=None):
    """The flax ResNet's ``(params, batch_stats)`` with numpy leaves ->
    the port's trees (same names, same layouts, each leaf keeping its
    float dtype: f32, or bf16 after amp O2's cast) on ``device``
    (default: the card).  Flatten order, and so the bucket plan, is the
    reference's."""
    dev = resolve_device(device)
    return _from_numpy(params, dev), _from_numpy(batch_stats, dev)


def bert_from_jax(params, device=None):
    """The flax BERT's ``params`` with numpy leaves -> the port's tree
    (:mod:`apex_tpu_torch.models.bert` keeps flax's names and layouts:
    ``embed/weight`` (V, h), linear weights (in, out), LayerNorm
    ``weight``/``bias``), each leaf keeping its float dtype, on
    ``device`` (default: the card)."""
    return _from_numpy(params, resolve_device(device))


def gpt_from_jax(params, device=None):
    """The flax ``GPTModel``'s ``params`` with numpy leaves -> the
    port's tree (:mod:`apex_tpu_torch.models.gpt` keeps flax's names and
    layouts: ``embed/weight`` (V, h), ``pos_embedding`` without RoPE,
    ``layer_<i>/...`` with linear weights (in, out), ``final_layernorm``),
    each leaf keeping its float dtype, on ``device`` (default: the
    card)."""
    return _from_numpy(params, resolve_device(device))


_RENAMES = {"kernel": "weight", "FusedLayerNorm_0": "norm"}


def _renamed(tree):
    if isinstance(tree, dict):
        return {_RENAMES.get(k, k): _renamed(v) for k, v in tree.items()}
    return tree


def gpt_block_from_jax(params, device=None):
    """The flax ``GPTBlocks``' ``params`` (``embed``, ``pos``,
    ``block<i>/{attn, ln2, fc1, fc2}``, ``lnf``) with numpy leaves -> the
    tree of :class:`apex_tpu_torch.examples.gpt_train_block.GPTBlocks`,
    each leaf keeping its float dtype, on ``device`` (default: the
    card).  A flax ``SelfMultiheadAttn``'s or ``EncdecMultiheadAttn``'s
    own ``params`` convert the same way to the port's module tree (the
    ``kernel`` -> ``weight`` and ``FusedLayerNorm_0`` -> ``norm`` renames;
    ``q_proj``, ``kv_proj`` and ``out_proj`` keep their names)."""
    return _from_numpy(_renamed(params), resolve_device(device))


def dcgan_from_jax(params_g, params_d, device=None):
    """The flax DCGAN's ``Generator`` and ``Discriminator`` ``params``
    with numpy leaves -> the port's ``(params_g, params_d)``
    (:mod:`apex_tpu_torch.examples.dcgan_main_amp` keeps flax's names
    and layouts; its forward flips the ``ConvTranspose`` kernels, which
    flax applies unflipped), each leaf keeping its float dtype, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return _from_numpy(params_g, dev), _from_numpy(params_d, dev)
