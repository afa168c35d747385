"""apex_tpu_torch.contrib.multihead_attn's modules against flax's.

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
the port's).  ``EncdecMultiheadAttn`` the same way for each of its
flags (``bias``, ``include_norm_add``, ``mask_additive``), query and
memory of different lengths, with and without dropout (the port handed
the seed the flax module folds from its key).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.multihead_attn._common as jcommon
from apex_tpu.contrib.multihead_attn import EncdecMultiheadAttn as JEncdec
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JMHA
from apex_tpu_torch._tree import tree_flatten, tree_leaves, tree_map
from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn)
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
    """Dropout runs on every branch of ``attention_core`` and raises only
    without a seed: each branch with a seed gives what it gives without
    the rate applied to the same kept pairs (the masked branch equals
    the flash branch when nothing is masked; the weights branch returns
    the undropped probabilities); the module raises in training without
    a generator or seed, and runs in eval."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, E // H))
                                .astype(np.float32)) for _ in range(3))
    none = torch.zeros(B, T, dtype=torch.bool)
    outs = []
    for kpm, nw in ((None, False), (none, False), (None, True)):
        with pytest.raises(ValueError, match="dropout_seed"):
            attention_core(q, k, v, causal=False, key_padding_mask=kpm,
                           mask_additive=False, dropout_rate=0.1,
                           need_weights=nw)
        out, probs = attention_core(q, k, v, causal=False,
                                    key_padding_mask=kpm,
                                    mask_additive=False, dropout_rate=0.1,
                                    dropout_seed=8, need_weights=nw)
        outs.append(out)
        if nw:
            _close(probs, torch.softmax(torch.einsum(
                "bhqd,bhkd->bhqk", q, k) / np.sqrt(E // H), -1), 1e-6)
    for out in outs[1:]:
        _close(out, outs[0], 1e-5)
    mha = SelfMultiheadAttn(E, H, dropout=0.1)
    p = mha.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(T, B, E)
    assert mha(p, x, is_training=False)[0].shape == (T, B, E)
    with pytest.raises(ValueError, match="generator or a dropout_seed"):
        mha(p, x)
    assert mha(p, x, dropout_seed=3)[0].shape == (T, B, E)


@pytest.mark.parametrize("attn_mask", ["none", "padding"])
def test_a_mask_other_than_causal_is_no_mask(attn_mask):
    """The reference treats any ``attn_mask`` but ``"causal"`` as no
    attention mask; so does the port: the no-mask result of the flax
    module, within the file's f32 tolerance."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, B, E)).astype(np.float32)
    jm = JMHA(E, H, bias=True)
    jp = jm.init(jax.random.key(3), jnp.asarray(x))["params"]
    want, _ = jm.apply({"params": jp}, jnp.asarray(x), attn_mask=None)
    tm = SelfMultiheadAttn(E, H, bias=True)
    tp = gpt_block_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got, _ = tm(tp, torch.from_numpy(x), attn_mask=attn_mask)
    _close(got, want, 1e-5)
    _close(got, tm(tp, torch.from_numpy(x), attn_mask=None)[0], 0.0)


TK = 9                       # the memory's length (Tq is T)
ENC_FLAGS = ("bias", "include_norm_add", "mask_additive")
ENC_FLAG_SETS = [dict(zip(ENC_FLAGS, bits))
                 for bits in itertools.product([False, True], repeat=3)]
# mask kind, causal, need_weights, dropout
ENC_CALLS = [(None, False, False, 0.0), ("mask", False, False, 0.3),
             (None, True, True, 0.3), (None, True, False, 0.2)]


def _enc_mask(rng, additive):
    pad = np.arange(TK)[None, :] >= np.asarray([TK, TK - 4])[:, None]
    if not additive:
        return pad
    return np.where(pad, -10000.0, rng.uniform(-1.0, 0.0, (B, TK))
                    ).astype(np.float32)


@pytest.mark.parametrize("call", range(len(ENC_CALLS)))
@pytest.mark.parametrize("flags", range(len(ENC_FLAG_SETS)))
def test_encdec_multihead_attn_matches_flax(monkeypatch, flags, call):
    fl = ENC_FLAG_SETS[flags]
    kind, causal, need_weights, rate = ENC_CALLS[call]
    rng = np.random.default_rng(300 + 10 * flags + call)
    x = rng.standard_normal((T, B, E)).astype(np.float32)
    mem = rng.standard_normal((TK, B, E)).astype(np.float32)
    w = rng.standard_normal((T, B, E)).astype(np.float32)
    mask = None if kind is None else _enc_mask(rng, fl["mask_additive"])
    jm = JEncdec(E, H, dropout=rate, **fl)
    jp = jm.init(jax.random.key(flags), jnp.asarray(x), jnp.asarray(mem),
                 is_training=False)["params"]
    tm = EncdecMultiheadAttn(E, H, dropout=rate, **fl)
    tp = gpt_block_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    mine, _ = tree_flatten(tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert [tuple(t.shape) for t in mine] == [
        tuple(t.shape) for t in tree_leaves(tp)]
    seeds = []
    fold = jcommon.dropout_seed_from_key

    def recording(key):
        seeds.append(int(fold(key)))
        return fold(key)

    monkeypatch.setattr(jcommon, "dropout_seed_from_key", recording)
    kw = dict(need_weights=need_weights,
              attn_mask="causal" if causal else None)
    jkw = dict(kw, key_padding_mask=None if mask is None
               else jnp.asarray(mask))

    def jloss(p, q, m):
        out, probs = jm.apply({"params": p}, q, m,
                              rngs={"dropout": jax.random.key(call)}, **jkw)
        return jnp.sum(out * jnp.asarray(w)), (out, probs)

    (_, (jout, jprobs)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jp, jnp.asarray(x),
                                                jnp.asarray(mem))
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    tq = torch.from_numpy(x).requires_grad_()
    tmem = torch.from_numpy(mem).requires_grad_()
    tkw = dict(kw, key_padding_mask=None if mask is None
               else torch.from_numpy(mask))
    out, probs = tm(tp, tq, tmem, tmem,
                    dropout_seed=seeds[-1] if rate else None, **tkw)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout, 1e-5)
    assert (probs is None) == (jprobs is None) == (not need_weights)
    if need_weights:
        _close(probs, jprobs, 1e-5)
    pgrads = tree_leaves(gpt_block_from_jax(
        jax.tree_util.tree_map(np.asarray, jg[0]), "cpu"))
    floor = 1e-2 * max(float(np.abs(_np(g)).max()) for g in pgrads)
    for got, want in zip(tree_leaves(tp), pgrads):
        _close(got.grad, want, 1e-4, floor)
    _close(tq.grad, jg[1], 1e-4)
    _close(tmem.grad, jg[2], 1e-4)


def test_encdec_value_must_be_key():
    tm = EncdecMultiheadAttn(E, H)
    p = tm.init(torch.Generator().manual_seed(0), "cpu")
    x, mem = torch.zeros(T, B, E), torch.zeros(TK, B, E)
    assert tm(p, x, mem)[0].shape == (T, B, E)
    with pytest.raises(ValueError, match="value must be key"):
        tm(p, x, mem, mem.clone())
