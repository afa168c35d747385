"""apex_tpu_torch.contrib.multihead_attn.SelfMultiheadAttn against flax's.

The flax module (``apex_tpu.contrib.multihead_attn``) is initialised
from a seed and its params handed to the port through
``convert.gpt_block_from_jax`` (the ``kernel`` -> ``weight`` and
``FusedLayerNorm_0`` -> ``norm`` renames); both see the same numpy
query and masks.  Every flag (``bias``, ``include_norm_add``,
``separate_qkv_params``, ``mask_additive``), both mask kinds (boolean
and additive key padding), the causal mask and ``need_weights`` (the
three branches of ``attention_core``: flash, masked ``attention_ref``,
the inline softmax that returns the probabilities).  f32 throughout:
outputs and probabilities within 1e-5 of their scale, the gradients of
the params and of the query within 1e-4 of each leaf's scale, floored
at 1e-2 of the largest param gradient (the key bias's gradient is 0 in
exact arithmetic, so both sides give rounding noise there) (the two
frameworks sum in their own orders; the flash branch runs the Pallas
kernel in interpret mode on the reference's side, the plain twins on
the port's).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JMHA
from apex_tpu_torch._tree import tree_flatten, tree_leaves, tree_map
from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
from apex_tpu_torch.contrib.multihead_attn._common import (attention_core,
                                                           merge_heads,
                                                           split_heads)
from apex_tpu_torch.convert import gpt_block_from_jax

T, B, E, H = 12, 2, 32, 4
FLAGS = ("bias", "include_norm_add", "separate_qkv_params")
FLAG_SETS = [dict(zip(FLAGS, bits))
             for bits in itertools.product([False, True], repeat=3)]
# mask kind, causal, need_weights
CALLS = [(None, True, False), (None, False, True), ("bool", False, False),
         ("additive", True, True)]


def _mask(kind, rng):
    if kind is None:
        return None
    lengths = [T, T - 5]
    pad = np.arange(T)[None, :] >= np.asarray(lengths)[:, None]  # (B, T)
    if kind == "bool":
        return pad
    return np.where(pad, -10000.0, rng.uniform(-1.0, 0.0, (B, T))
                    ).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, floor=1e-30):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("call", range(len(CALLS)))
@pytest.mark.parametrize("flags", range(len(FLAG_SETS)))
def test_self_multihead_attn_matches_flax(flags, call):
    fl = FLAG_SETS[flags]
    kind, causal, need_weights = CALLS[call]
    additive = kind == "additive"
    rng = np.random.default_rng(100 * flags + call)
    x = rng.standard_normal((T, B, E)).astype(np.float32)
    w = rng.standard_normal((T, B, E)).astype(np.float32)
    mask = _mask(kind, rng)
    jm = JMHA(E, H, mask_additive=additive, **fl)
    jp = jm.init(jax.random.key(flags), jnp.asarray(x))["params"]
    tm = SelfMultiheadAttn(E, H, mask_additive=additive, **fl)
    tp = gpt_block_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    # the port's init makes the same tree (names, shapes, order)
    mine, _ = tree_flatten(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert [tuple(t.shape) for t in mine] == [
        tuple(t.shape) for t in tree_leaves(tp)]
    kw = dict(need_weights=need_weights,
              attn_mask="causal" if causal else None)
    jkw = dict(kw, key_padding_mask=None if mask is None
               else jnp.asarray(mask))

    def jloss(p, q):
        out, probs = jm.apply({"params": p}, q, **jkw)
        return jnp.sum(out * jnp.asarray(w)), (out, probs)

    (_, (jout, jprobs)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    tq = torch.from_numpy(x).requires_grad_()
    tkw = dict(kw, key_padding_mask=None if mask is None
               else torch.from_numpy(mask))
    out, probs = tm(tp, tq, **tkw)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout, 1e-5)
    assert (probs is None) == (jprobs is None) == (not need_weights)
    if need_weights:
        _close(probs, jprobs, 1e-5)
    pgrads = tree_leaves(gpt_block_from_jax(
        jax.tree_util.tree_map(np.asarray, jg[0]), "cpu"))
    # the key bias's gradient is 0 in exact arithmetic (adding it shifts
    # every score of a row alike): both sides return rounding noise, so
    # each leaf's scale is floored at 1e-2 of the largest gradient
    floor = 1e-2 * max(float(np.abs(_np(g)).max()) for g in pgrads)
    for got, want in zip(tree_leaves(tp), pgrads):
        _close(got.grad, want, 1e-4, floor)
    _close(tq.grad, jg[1], 1e-4)


def test_heads_split_and_merge_like_the_reference():
    x = torch.arange(T * B * E, dtype=torch.float32).reshape(T, B, E)
    s = split_heads(x, H)
    assert tuple(s.shape) == (B, H, T, E // H)
    assert torch.equal(s[1, 2, 3], x[3, 1, 2 * (E // H):3 * (E // H)])
    assert torch.equal(merge_heads(s), x)


def test_dropout_raises_on_every_branch():
    q = torch.zeros(B, H, T, E // H)
    for kpm, nw in ((None, False), (torch.zeros(B, T, dtype=torch.bool),
                                    False), (None, True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            attention_core(q, q, q, causal=False, key_padding_mask=kpm,
                           mask_additive=False, dropout_rate=0.1,
                           need_weights=nw)
    mha = SelfMultiheadAttn(E, H, dropout=0.1)
    p = mha.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(T, B, E)
    assert mha(p, x, is_training=False)[0].shape == (T, B, E)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mha(p, x)
