"""The port's GPT model (``apex_tpu_torch.models.GPTModel`` at a
tensor-parallel size of one) and its vocab-parallel loss against
``apex_tpu.models.GPTModel``.

A narrow GPT (vocab 128, hidden 64, 4 heads, 2 layers, 32 positions) is
initialised by the flax model and handed to the port through
``convert.gpt_from_jax``; both see the same numpy tokens, labels and
packed batches (``data.pack_sequences``).  The causal attention runs the
Pallas kernels in interpret mode on the reference's side and the port's
autograd flash attention with its plain twins on the port's.  Held:
the parameter tree, the f32 logits, the loss and every leaf's gradient
for learned positions, RoPE and packed rows (learned and RoPE, whose
``freqs`` differ per row); the packed per-sequence contract; the packed
loss's mask (padding and each segment's final position left out) two
ways; the ``ValueError``s and the multi-process raises; the
vocab-parallel cross entropy at label smoothing 0 and 0.1; the region
mappings and the shard arithmetic; ``pack_dataset``; and three FusedAdam
steps wired as ``examples/gpt/train_block.py`` wires them, at O0 and O2.

Tolerances (each with its reason):
- f32: the two frameworks sum their matmuls in their own orders: logits
  and the loss within rtol/atol 2e-4 (``tests/test_models.py``'s),
  gradients within 1e-4 of each leaf's largest entry (the GPT block
  test's); the cross entropy within 1e-6 (one f32 log-sum-exp);
- three O0 steps: losses within rtol 1e-5 and the params' displacement
  (final minus init) within 1e-4 of its norm (measured 2.2e-5, the GPT
  block test's bound and its 4.1e-5's order), the key third of each
  head's qkv bias held apart to Adam's own bound (its gradient is 0 in
  exact arithmetic, so each side steps it by its own rounding noise:
  the GPT block test's rule);
- three O2 steps (bf16 model, f32 masters): losses within rtol 1e-3 and
  the masters' displacement within 0.2 of its norm (measured 4.4e-2),
  the rule ROADMAP records for O2 trajectories (a different summation
  order flips bf16 roundings that the optimizer then carries).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.data import pack_dataset as jpack_dataset
from apex_tpu.models import GPTModel as JGPT
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_flatten, tree_leaves
from apex_tpu_torch.convert import gpt_from_jax
from apex_tpu_torch.data import pack_dataset, pack_sequences
from apex_tpu_torch.examples import gpt_train_block as ex
from apex_tpu_torch.models import GPTLayer, GPTModel, GPTStage
from apex_tpu_torch.transformer import tensor_parallel as tp
from test_torch_port_gpt_block import _adam_drift_bound

CFG = dict(vocab_size=128, hidden_size=64, num_heads=4, num_layers=2,
           max_seq_len=32)
B, S = 2, 32
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = 2e-4
GRAD_TOL = 1e-4
STEPS = 3
KINDS = ("learned", "rope", "packed_rope", "packed_learned")


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _close_scaled(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _models(rope, dtype="float32"):
    jdt, tdt = DT[dtype]
    return (JGPT(**CFG, use_rope=rope, dtype=jdt),
            GPTModel(**CFG, use_rope=rope, dtype=tdt))


@functools.lru_cache(maxsize=None)
def _jax_params(rope):
    jm, _ = _models(rope)
    return jax.jit(jm.init)(jax.random.key(0),
                            jnp.zeros((B, S), jnp.int32))["params"]


def _port_params(rope):
    return gpt_from_jax(jax.tree_util.tree_map(np.asarray, _jax_params(rope)),
                        "cpu")


@functools.lru_cache(maxsize=None)
def _packed():
    """Six sequences of 5..30 tokens packed into rows of 32."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, CFG["vocab_size"], size=n)
            for n in (17, 9, 23, 5, 12, 30)]
    return pack_sequences(seqs, max_len=S, pad_id=0)


def _batch(kind):
    """numpy (tokens, labels, segment_ids, positions) of a kind; the
    labels are the tokens shifted by one (the last position wraps)."""
    if kind.startswith("packed"):
        p = _packed()
        tokens, seg, pos = p["tokens"], p["segment_ids"], p["positions"]
    else:
        tokens = np.random.default_rng(1).integers(
            0, CFG["vocab_size"], (B, S)).astype(np.int32)
        seg = pos = None
    return tokens, np.roll(tokens, -1, axis=1), seg, pos


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x)).long()


@pytest.mark.parametrize("rope", [False, True])
def test_param_tree_matches_flax(rope):
    """The port's init has the flax model's names, shapes and flatten
    order, and the converted tree carries the flax values."""
    jp = _jax_params(rope)
    _, tm = _models(rope)
    mine, mdef = tree_flatten(tm.init(0, "cpu"))
    conv, cdef = tree_flatten(_port_params(rope))
    assert mdef == cdef
    jl = jax.tree_util.tree_leaves(jp)
    assert [tuple(x.shape) for x in jl] == [tuple(t.shape) for t in mine]
    for a, b in zip(jl, conv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ("pos_embedding" in _port_params(rope)) == (not rope)


@pytest.mark.parametrize("kind", KINDS)
def test_logits_loss_and_grads_match_jax(kind):
    rope = "rope" in kind
    jm, tm = _models(rope)
    jp, tpar = _jax_params(rope), _port_params(rope)
    tokens, labels, seg, pos = _batch(kind)
    jargs = (jnp.asarray(tokens), jnp.asarray(labels), _j(seg), _j(pos))
    logits = tm.apply(tpar, _t(tokens), _t(seg), _t(pos))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (S, tokens.shape[0], CFG["vocab_size"])
    want = jax.jit(lambda p, t, s, q: jm.apply({"params": p}, t,
                                               segment_ids=s, positions=q))(
        jp, jargs[0], jargs[2], jargs[3])
    np.testing.assert_allclose(_np(logits), _np(want), rtol=TOL, atol=TOL)

    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, *b: jm.loss({"params": p}, *b)))(jp, *jargs)
    (loss, _), grads = tamp.value_and_grad(
        lambda p: tm.loss(p, _t(tokens), _t(labels), _t(seg), _t(pos)), tpar)
    np.testing.assert_allclose(float(loss), float(jl), rtol=TOL, atol=TOL)
    gl, gdef = tree_flatten(grads)
    assert gdef == tree_flatten(tpar)[1]
    for g, w in zip(gl, jax.tree_util.tree_leaves(jg)):
        _close_scaled(g, w, GRAD_TOL)


@pytest.mark.parametrize("rope", [False, True])
def test_packed_batch_matches_per_sequence(rope):
    """The packed-pretraining contract (``tests/test_models.py::
    test_gpt_packed_batch_matches_per_sequence``): each packed sequence's
    logits are those of the sequence run alone."""
    _, tm = _models(rope)
    tpar = _port_params(rope)
    p = _packed()
    tokens = _t(p["tokens"])
    logits = tm.apply(tpar, tokens, _t(p["segment_ids"]), _t(p["positions"]))
    for r in range(tokens.shape[0]):
        segs = p["segment_ids"][r]
        for seg in range(1, int(segs.max()) + 1):
            idx = np.flatnonzero(segs == seg)
            alone = tm.apply(tpar, tokens[r:r + 1, idx])
            np.testing.assert_allclose(_np(logits[idx, r]), _np(alone[:, 0]),
                                       rtol=TOL, atol=TOL)


def test_packed_loss_mask_is_pinned():
    """The packed loss leaves out padding and each segment's final
    position: it equals the manually masked mean of the per-token cross
    entropy, poisoning every excluded label leaves it bit-identical, and
    it matches the reference's loss."""
    jm, tm = _models(True)
    tpar = _port_params(True)
    tokens, labels, seg, pos = _batch("packed_rope")
    loss = tm.loss(tpar, _t(tokens), _t(labels), _t(seg), _t(pos))
    logits = tm.apply(tpar, _t(tokens), _t(seg), _t(pos))
    per_tok = tp.cross_entropy_ref(logits, _t(labels).t())
    s_sb = seg.T
    nxt = np.concatenate([s_sb[1:], np.zeros_like(s_sb[:1])])
    keep = (s_sb > 0) & (nxt == s_sb)
    assert 0 < keep.sum() < keep.size
    manual = (_np(per_tok) * keep).sum() / keep.sum()
    np.testing.assert_allclose(float(loss), manual, rtol=1e-6)
    poisoned = labels.copy()
    poisoned[~keep.T] = 1
    again = tm.loss(tpar, _t(tokens), _t(poisoned), _t(seg), _t(pos))
    assert float(again) == float(loss)
    jl = jm.loss({"params": _jax_params(True)}, jnp.asarray(tokens),
                 jnp.asarray(labels), segment_ids=jnp.asarray(seg),
                 positions=jnp.asarray(pos))
    np.testing.assert_allclose(float(loss), float(jl), rtol=TOL, atol=TOL)


def test_what_the_model_refuses():
    """Both ``ValueError``s of the reference (one-sided packing, either
    side; packed rows past ``max_seq_len``), and the multi-process
    settings, which name slice 9."""
    _, tm = _models(False)
    tpar = _port_params(False)
    p = _packed()
    tokens, seg, pos = _t(p["tokens"]), _t(p["segment_ids"]), \
        _t(p["positions"])
    for kw in (dict(segment_ids=seg), dict(positions=pos)):
        with pytest.raises(ValueError, match="BOTH segment_ids"):
            tm.apply(tpar, tokens, **kw)
    short = GPTModel(**dict(CFG, max_seq_len=16))
    with pytest.raises(ValueError, match="max_seq_len"):
        short.apply(short.init(0, "cpu"), torch.ones(1, 32, dtype=torch.long),
                    torch.ones(1, 32, dtype=torch.long),
                    torch.zeros(1, 32, dtype=torch.long))
    for make in (lambda: GPTModel(**CFG, sequence_parallel=True),
                 lambda: tp.ColumnParallelLinear(
                     64, 192, tensor_model_parallel_size=2),
                 lambda: GPTLayer(64, 4, context_parallel=True),
                 lambda: GPTLayer(64, 4, sequence_parallel=True),
                 lambda: GPTStage(64, 4, 2, sequence_parallel=True)):
        with pytest.raises(NotImplementedError, match=r"slice 9"):
            make()


def test_stage_is_the_model_layers():
    """``GPTStage`` over ``layer_<i>`` params computes the model's layer
    stack: the reference's stage with the model's layer parameters."""
    _, tm = _models(True)
    tpar = _port_params(True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S, B, CFG["hidden_size"])).astype(np.float32))
    stage = GPTStage(CFG["hidden_size"], CFG["num_heads"], CFG["num_layers"],
                     use_rope=True)
    assert set(stage.init(torch.Generator().manual_seed(0), "cpu")) == {
        "layer_0", "layer_1"}
    y = x
    for i in range(CFG["num_layers"]):
        y = tm.stage.layer(tpar[f"layer_{i}"], y)
    assert torch.equal(stage(tpar, x), y)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(smoothing):
    """Per-token loss and the gradient of a weighted sum, against the
    reference's op and both oracles; f32 and bf16 logits; a label outside
    the vocabulary has no target term on both sides."""
    rng = np.random.default_rng(int(smoothing * 10) + 7)
    logits = (3 * rng.standard_normal((5, 3, 37))).astype(np.float32)
    target = rng.integers(0, 37, (5, 3)).astype(np.int32)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    for jdt, tdt in DT.values():
        jx = jnp.asarray(logits).astype(jdt)
        tx = torch.from_numpy(logits).to(tdt).requires_grad_()
        want, jg = jax.value_and_grad(lambda x: jnp.sum(
            jtp.vocab_parallel_cross_entropy(x, jnp.asarray(target),
                                             smoothing) * w))(jx)
        got = tp.vocab_parallel_cross_entropy(tx, _t(target), smoothing)
        assert got.dtype == torch.float32
        total = (got * torch.from_numpy(w)).sum()
        total.backward()
        np.testing.assert_allclose(float(total.detach()), float(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(got), _np(
            jtp.vocab_parallel_cross_entropy(jx, jnp.asarray(target),
                                             smoothing)), rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), _np(jg), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            _np(tp.cross_entropy_ref(tx, _t(target), smoothing)),
            _np(jtp.cross_entropy_ref(jx, jnp.asarray(target), smoothing)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            _np(got), _np(tp.cross_entropy_ref(tx, _t(target), smoothing)),
            rtol=1e-5, atol=1e-5)
    bad = target.copy()
    bad[0, 0] = 99
    got = tp.vocab_parallel_cross_entropy(torch.from_numpy(logits),
                                          _t(bad), smoothing)
    want = jtp.vocab_parallel_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(bad), smoothing)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_mappings_and_shard_arithmetic():
    """At a group of one the seven region mappings are the identity (the
    gradient too); the shard arithmetic is the reference's."""
    x = torch.randn(4, 2, 6, requires_grad=True)
    maps = (tp.copy_to_tensor_model_parallel_region,
            tp.reduce_from_tensor_model_parallel_region,
            tp.scatter_to_tensor_model_parallel_region,
            tp.gather_from_tensor_model_parallel_region,
            tp.scatter_to_sequence_parallel_region,
            tp.gather_from_sequence_parallel_region,
            tp.reduce_scatter_to_sequence_parallel_region)
    for f in maps:
        y = f(x)
        assert y is x
        (g,) = torch.autograd.grad((y * 2).sum(), x)
        assert torch.equal(g, torch.full_like(x, 2.0))
    assert tp.divide(12, 4) == jtp.divide(12, 4) == 3
    with pytest.raises(AssertionError, match="not divisible"):
        tp.ensure_divisibility(10, 4)
    parts = tp.split_tensor_along_last_dim(x.detach(), 3)
    jparts = jtp.split_tensor_along_last_dim(jnp.asarray(x.detach()), 3)
    assert len(parts) == 3
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for args in ((50304, 1, 4), (50304, 3, 4), (64, 0, 1)):
        assert (tp.VocabUtility.vocab_range_from_global_vocab_size(*args)
                == jtp.VocabUtility.vocab_range_from_global_vocab_size(
                    *args))
    assert (tp.VocabUtility.vocab_range_from_per_partition_vocab_size(
        100, 2, 4) == (200, 300))


def test_pack_dataset_matches_jax():
    """The same stream of sequences gives the reference's batches, with
    exactly ``rows_per_batch`` rows each (the last padded with segment-0
    rows), every array equal."""
    rng = np.random.default_rng(11)
    seqs = [rng.integers(1, 100, size=int(n))
            for n in rng.integers(3, 33, size=90)]
    got = list(pack_dataset(iter(seqs), max_len=32, rows_per_batch=4,
                            buffer_batches=2))
    want = list(jpack_dataset(iter(seqs), max_len=32, rows_per_batch=4,
                              buffer_batches=2))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == (4, 32)
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    assert sum(int((b["segment_ids"] > 0).sum()) for b in got) == sum(
        len(s) for s in seqs)


def _key_bias(h, heads):
    """The indices of each head's key third in the per-head qkv bias."""
    d = h // heads
    return np.concatenate([np.arange(j * 3 * d + d, j * 3 * d + 2 * d)
                           for j in range(heads)])


def _jax_run(jp, opt_level, rope, batch):
    jm, _ = _models(rope, "float32" if opt_level == "O0" else "bfloat16")
    params, amp_state = jamp.initialize(jp, opt_level=opt_level)
    opt = JAdam(params, lr=3e-4,
                master_weights=bool(amp_state.properties.master_weights),
                masters=amp_state.master_params)

    @jax.jit
    def step(p, scaler, *b):
        return jamp.scaled_value_and_grad(
            lambda pp, t, l, s, q: jm.loss({"params": pp}, t, l,
                                           segment_ids=s, positions=q),
            scaler, p, *b)

    losses = []
    for _ in range(STEPS):
        loss, grads, found_inf = step(opt.params, amp_state.scaler, *batch)
        opt.step(grads, found_inf=found_inf)
        amp_state = jamp.update_scaler(amp_state, found_inf)
        losses.append(float(loss))
    work = opt.masters if opt.masters is not None else opt.params
    return losses, [_np(w) for w in jax.tree_util.tree_leaves(work)], \
        float(amp_state.scaler.loss_scale)


@pytest.mark.parametrize("opt_level,kind", [("O0", "learned"),
                                            ("O2", "packed_rope")])
def test_training_steps_match_jax(opt_level, kind):
    """Three steps of ``GPTModel.loss`` under amp with FusedAdam lr 3e-4
    through the flat pipeline (``gpt_train_block.setup``) against the
    reference's ``amp.scaled_value_and_grad`` + ``FusedAdam``."""
    rope = "rope" in kind
    jp = _jax_params(rope)
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    tokens, labels, seg, pos = _batch(kind)
    jl, jw, jscale = _jax_run(jp, opt_level, rope,
                              tuple(_j(x) for x in (tokens, labels, seg,
                                                    pos)))
    _, tm = _models(rope, "float32" if opt_level == "O0" else "bfloat16")
    tb = tuple(_t(x) for x in (tokens, labels, seg, pos))
    s = ex.setup(tm, _port_params(rope), "cpu", opt_level=opt_level,
                 lr=3e-4, loss_fn=lambda p, t, l, sg, q: tm.loss(p, t, l,
                                                                  sg, q))
    state, losses = s.amp_state, []
    for _ in range(STEPS):
        loss, state = s.step(state, *tb)
        losses.append(float(loss))
    assert float(state.scaler.loss_scale) == jscale
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    loss_tol, disp_tol = {"O0": (1e-5, 1e-4), "O2": (1e-3, 0.2)}[opt_level]
    np.testing.assert_allclose(losses, jl, rtol=loss_tol)
    opt = s.opt
    work = opt.masters if opt.masters is not None else opt.params
    tw = [np.array(_np(w)) for w in tree_leaves(work)]      # copies
    jw = [np.array(w) for w in jw]
    key = _key_bias(CFG["hidden_size"], CFG["num_heads"])
    bound = _adam_drift_bound(3e-4, 0.9, 0.999, STEPS)
    for (path, _), a, b, o in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0], tw, jw, init):
        if "attn_qkv" in jax.tree_util.keystr(path) and a.ndim == 1:
            for x in (a, b):
                assert np.abs(x[key] - o[key]).max() <= bound
                x[key] = o[key]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(tw, jw))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(jw, init))
    assert np.sqrt(num / den) <= disp_tol, np.sqrt(num / den)
    if opt.masters is not None:
        for p, m in zip(tree_leaves(opt.params), tree_leaves(opt.masters)):
            assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(p.dtype))

