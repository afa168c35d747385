"""apex_tpu_torch's BERT and its MLM pretraining step against apex_tpu's.

A narrow BERT (2 layers, hidden 128, 4 heads, vocab 96, 16 positions of
32) is initialised by the flax model and handed to the port through
``convert.bert_from_jax``; both see the same numpy tokens.  Parity of
the forward (the sequence output and the f32 MLM logits) and of the
gradients of an MLM loss, with and without an ``attention_mask`` (the
padded batch goes through ``attention_ref``, the unmasked one through
``flash_attention``: Pallas in interpret mode in the reference, the
plain twin in the port), f32 and bf16.  Then the pretraining step of
``examples/bert/pretrain_mlm.py:80-89,132-137`` — ``mlm_logits``, the
transposed flat logits into ``softmax_cross_entropy_loss(...,
padding_idx=-1)``, the sum over the labelled count,
``amp.scaled_value_and_grad``, ``FusedLAMB.step(found_inf=)``,
``amp.update_scaler`` — three steps at O0 and O2 on padded batches.

Tolerances (measured on this configuration, each with its reason):
- f32 (O0): the two frameworks sum their matmuls in their own orders:
  outputs and logits within 1e-5 of their scale, gradients within 1e-4
  of each leaf's scale; the 3-step losses within rtol 1e-5 and the
  params' displacement (final minus init) within 1e-4 of its norm
  (measured: losses equal, 1.2e-5);
- bf16 (O2): a different order flips bf16 roundings of activations:
  outputs within 2e-2 of their scale, gradients within 5e-2 of each
  leaf's scale (both sides' roundings move them); 3-step losses within
  rtol 1e-3 (measured 1.3e-4); masters' displacement within 0.2 of its
  norm (measured 6.7e-2; as the ResNet O2 trajectories, a last-bit
  difference flips bf16 roundings that the optimizer then carries),
  the bf16 params exactly the cast of the masters on the port's side.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jxent_loss
from apex_tpu.models.bert import BertModel as JBert
from apex_tpu.optimizers import FusedLAMB as JLAMB
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_flatten, tree_leaves
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.convert import bert_from_jax
from apex_tpu_torch.models import BertModel, bert_base, bert_large
from apex_tpu_torch.optimizers import FusedLAMB

CFG = dict(vocab_size=96, hidden_size=128, num_heads=4, num_layers=2,
           max_seq_len=32)
B, S = 2, 16
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _batch(seed, padded=True):
    """Tokens in [1, V), lengths in [S/2, S], mask 1 on real positions,
    labels -1 on padding."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, CFG["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    if padded:
        for i, n in enumerate(rng.integers(S // 2, S + 1, B)):
            mask[i, n:] = 0
    labels = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    labels[mask == 0] = -1
    return tokens, mask, labels


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    model = JBert(dtype=dtype, **CFG)
    tokens = jnp.zeros((B, S), jnp.int32)
    return model, jax.jit(model.init)(jax.random.key(0), tokens)["params"]


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _close_scaled(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_param_tree_is_flax_s():
    """The port's init has the flax model's names, shapes and order."""
    _, jp = _jax_params(jnp.float32)
    tp = BertModel(**CFG).init(0, "cpu")
    jl, jdef = jax.tree_util.tree_flatten_with_path(jp)
    tl, _ = tree_flatten(tp)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [
        jax.tree_util.keystr(k) for k, _ in jax.tree_util
        .tree_flatten_with_path(bert_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))[0]]
    assert [tuple(l.shape) for _, l in jl] == [tuple(t.shape) for t in tl]
    big = bert_large()
    assert (big.hidden_size, big.num_heads, big.num_layers,
            big.vocab_size) == (1024, 16, 24, 30528)
    assert bert_base().num_layers == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [True, False])
def test_forward_logits_and_grads_match_jax(dtype, padded):
    jdt, tdt = DT[dtype]
    jm, jp = _jax_params(jdt)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jdt), jp)
    tm = BertModel(dtype=tdt, **CFG)
    tp = bert_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tokens, mask, labels = _batch(1, padded)
    jkw = {"attention_mask": jnp.asarray(mask)} if padded else {}
    tkw = {"attention_mask": torch.from_numpy(mask)} if padded else {}
    ttok = torch.from_numpy(tokens).long()
    seq = tm.apply(tp, ttok, **tkw)
    assert seq.shape == (S, B, CFG["hidden_size"]) and seq.dtype == tdt
    jseq, jlogits = jax.jit(lambda p: (
        jm.apply({"params": p}, jnp.asarray(tokens), **jkw),
        jm.mlm_logits({"params": p}, jnp.asarray(tokens), **jkw)))(jp)
    _close_scaled(seq, jseq, FWD_TOL[dtype])
    tl = tm.mlm_logits(tp, ttok, **tkw)
    assert tl.dtype == torch.float32
    _close_scaled(tl, jlogits, FWD_TOL[dtype])

    def jloss(p):
        lg = jm.mlm_logits({"params": p}, jnp.asarray(tokens), **jkw)
        flat = lg.transpose(1, 0, 2).reshape(-1, CFG["vocab_size"])
        return jnp.sum(jxent_loss(flat, jnp.asarray(labels).reshape(-1),
                                  padding_idx=-1))

    def tloss(p):
        lg = tm.mlm_logits(p, ttok, **tkw)
        flat = lg.transpose(0, 1).reshape(-1, CFG["vocab_size"])
        return softmax_cross_entropy_loss(
            flat, torch.from_numpy(labels).long().reshape(-1),
            padding_idx=-1).sum()

    (loss, _), grads = tamp.value_and_grad(tloss, tp)
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_TOL[dtype])
    for g, jg in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        assert g.dtype == tdt
        _close_scaled(g, jg, GRAD_TOL[dtype])


# ---------------------------------------------------------------------------
# the pretraining step (pretrain_mlm.py), both packages
# ---------------------------------------------------------------------------

STEPS = 3
LAMB = dict(lr=1e-3, weight_decay=0.01)


def _jax_run(params, opt_level, batches):
    dt = jnp.bfloat16 if opt_level != "O0" else jnp.float32
    model = JBert(dtype=dt, **CFG)
    params, amp_state = jamp.initialize(params, opt_level=opt_level)
    opt = JLAMB(params, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **LAMB)

    def loss_fn(p, tokens, labels, attention_mask):
        logits = model.mlm_logits({"params": p}, tokens,
                                  attention_mask=attention_mask)
        flat = logits.transpose(1, 0, 2).reshape(-1, CFG["vocab_size"])
        losses = jxent_loss(flat, labels.reshape(-1), smoothing=0.0,
                            padding_idx=-1)
        n = jnp.maximum(jnp.sum(labels.reshape(-1) != -1), 1)
        return jnp.sum(losses) / n

    wrapped = amp_state.wrap_forward(loss_fn, cast_argnums=())

    @jax.jit
    def step(p, scaler, tokens, labels, mask):
        return jamp.scaled_value_and_grad(wrapped, scaler, p, tokens,
                                          labels, mask)

    losses = []
    for tokens, mask, labels in batches:
        loss, grads, found_inf = step(opt.params, amp_state.scaler,
                                      jnp.asarray(tokens),
                                      jnp.asarray(labels), jnp.asarray(mask))
        opt.step(grads, found_inf=found_inf)
        amp_state = jamp.update_scaler(amp_state, found_inf)
        losses.append(float(loss))
    work = opt.masters if opt.masters is not None else opt.params
    return losses, [_np(w) for w in jax.tree_util.tree_leaves(work)], \
        float(amp_state.scaler.loss_scale)


def _torch_run(params, opt_level, batches):
    dt = torch.bfloat16 if opt_level != "O0" else torch.float32
    model = BertModel(dtype=dt, **CFG)
    params, amp_state = tamp.initialize(params, opt_level=opt_level)
    opt = FusedLAMB(params, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **LAMB)

    def loss_fn(p, tokens, labels, attention_mask):
        logits = model.mlm_logits(p, tokens, attention_mask=attention_mask)
        flat = logits.transpose(0, 1).reshape(-1, CFG["vocab_size"])
        losses = softmax_cross_entropy_loss(flat, labels.reshape(-1),
                                            smoothing=0.0, padding_idx=-1)
        n = torch.clamp((labels.reshape(-1) != -1).sum(), min=1)
        return losses.sum() / n

    wrapped = amp_state.wrap_forward(loss_fn, cast_argnums=())
    losses = []
    for tokens, mask, labels in batches:
        loss, grads, found_inf = tamp.scaled_value_and_grad(
            wrapped, amp_state.scaler, opt.params,
            torch.from_numpy(tokens).long(), torch.from_numpy(labels).long(),
            torch.from_numpy(mask))
        opt.step(grads, found_inf=found_inf)
        amp_state = tamp.update_scaler(amp_state, found_inf)
        losses.append(float(loss))
    if opt.masters is not None:
        for p, m in zip(tree_leaves(opt.params), tree_leaves(opt.masters)):
            assert torch.equal(p, m.to(p.dtype))
    work = opt.masters if opt.masters is not None else opt.params
    return losses, [_np(w) for w in tree_leaves(work)], \
        float(amp_state.scaler.loss_scale)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_pretraining_steps_match_jax(opt_level):
    _, jp = _jax_params(jnp.float32)
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    batches = [_batch(10 + s) for s in range(STEPS)]
    jl, jw, jscale = _jax_run(jp, opt_level, batches)
    tl, tw, tscale = _torch_run(
        bert_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        opt_level, batches)
    assert tscale == jscale
    assert all(np.isfinite(tl))
    loss_tol, disp_tol = {"O0": (1e-5, 1e-4), "O2": (1e-3, 0.2)}[opt_level]
    np.testing.assert_allclose(tl, jl, rtol=loss_tol)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(tw, jw))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(jw, init))
    assert np.sqrt(num / den) <= disp_tol, np.sqrt(num / den)


def test_token_type_embeddings_match_jax():
    """Sentence A/B ids add the segment embedding, which exists only when
    the init saw token type ids (as flax creates it)."""
    tokens, mask, _ = _batch(3)
    types = (np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(B, 0)
    jm = JBert(**CFG)
    jp = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(tokens),
                          jnp.asarray(types))["params"]
    assert "segment_embedding" in jp
    assert "segment_embedding" not in BertModel(**CFG).init(0, "cpu")
    assert tuple(BertModel(**CFG).init(0, "cpu", token_type_ids=True)[
        "segment_embedding"].shape) == tuple(jp["segment_embedding"].shape)
    tp = bert_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(tokens),
                                      jnp.asarray(types),
                                      jnp.asarray(mask)))(jp)
    got = BertModel(**CFG).apply(tp, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(types).long(),
                                 torch.from_numpy(mask))
    _close_scaled(got, want, FWD_TOL["float32"])
