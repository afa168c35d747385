"""The port of ``examples/bert/pretrain_mlm.py`` on the batches that go
through flash attention with gradients: the default unmasked batch and
``--packed`` (``apex_tpu_torch.data.pack_sequences``).

``pack_sequences`` must give the JAX package's arrays exactly.  Then a
narrow BERT (2 layers, hidden 128, 4 heads, vocab 96, 32 positions),
initialised by the flax model and handed over by
``convert.bert_from_jax``, takes three pretraining steps on each batch
kind in both packages, wired as the reference's ``main()`` wires them:
``mlm_logits`` with ``segment_ids``/``positions`` or none, the cross
entropy over labelled positions, ``amp.scaled_value_and_grad``,
``FusedLAMB.step(found_inf=)``, ``amp.update_scaler``.  The attention
is the Pallas flash kernels in interpret mode on the reference's side,
the port's autograd flash attention (its plain twins) on the port's.

At vocab 128, on the fused cross entropy's gate, the packed batch's
label -1 padding goes through the gate's kernels (interpret mode) and
their plain versions.

Tolerances, those ``test_torch_port_bert.py`` measured for this model:
O0 losses within rtol 1e-5 and the params' displacement within 1e-4 of
its norm (the two frameworks sum their matmuls in their own orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jxent_loss
from apex_tpu.data import pack_sequences as jpack
from apex_tpu.models.bert import BertModel as JBert
from apex_tpu.optimizers import FusedLAMB as JLAMB
from apex_tpu_torch._tree import tree_leaves
from apex_tpu_torch.convert import bert_from_jax
from apex_tpu_torch.data import pack_sequences
from apex_tpu_torch.examples import bert_pretrain_mlm as ex
from apex_tpu_torch.models import BertModel

CFG = dict(vocab_size=96, hidden_size=128, num_heads=4, num_layers=2,
           max_seq_len=32)
B, S, STEPS = 2, 32, 3
LAMB = dict(lr=1e-3, weight_decay=0.01)


def test_pack_sequences_matches_jax():
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, 50, size=n) for n in rng.integers(1, 40, 23)]
    want = jpack(seqs, max_len=40, pad_id=7)
    got = pack_sequences(seqs, max_len=40, pad_id=7)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got[k].dtype == np.int32, k
    with pytest.raises(ValueError, match="longer than"):
        pack_sequences([np.arange(41)], max_len=40)
    with pytest.raises(ValueError, match="empty"):
        pack_sequences([np.arange(3), []], max_len=40)


def _jax_run(jp, batch, cfg=CFG):
    model = JBert(dtype=jnp.float32, **cfg)
    params, amp_state = jamp.initialize(jp, opt_level="O0")
    opt = JLAMB(params, master_weights=False, **LAMB)
    vocab = cfg["vocab_size"]

    def loss_fn(p, tokens, labels, segment_ids=None, positions=None):
        logits = model.mlm_logits({"params": p}, tokens,
                                  segment_ids=segment_ids,
                                  positions=positions)
        flat = logits.transpose(1, 0, 2).reshape(-1, vocab)
        losses = jxent_loss(flat, labels.reshape(-1), smoothing=0.0,
                            padding_idx=-1)
        n = jnp.maximum(jnp.sum(labels.reshape(-1) != -1), 1)
        return jnp.sum(losses) / n

    kw = {k: jnp.asarray(batch[k].numpy()) for k in ("segment_ids",
                                                      "positions")
          if k in batch}

    @jax.jit
    def step(p, scaler, tokens, labels, kw):
        return jamp.scaled_value_and_grad(loss_fn, scaler, p, tokens,
                                          labels, **kw)

    losses = []
    for _ in range(STEPS):
        loss, grads, found_inf = step(
            opt.params, amp_state.scaler,
            jnp.asarray(batch["tokens"].numpy()),
            jnp.asarray(batch["labels"].numpy()), kw)
        opt.step(grads, found_inf=found_inf)
        amp_state = jamp.update_scaler(amp_state, found_inf)
        losses.append(float(loss))
    return losses, [np.asarray(w) for w in
                    jax.tree_util.tree_leaves(opt.params)]


def _steps_match_jax(packed, cfg):
    jm = JBert(**cfg)
    jp = jm.init(jax.random.key(0), jnp.zeros((B, S), jnp.int32))["params"]
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    batch, real, _ = ex.synthetic_batch(cfg["vocab_size"], B, S, packed,
                                        "cpu")
    assert (real < B * S) == packed == ("segment_ids" in batch)
    if packed:
        assert bool((batch["labels"][batch["segment_ids"] == 0] == -1).all())
    jl, jw = _jax_run(jp, batch, cfg)
    model = BertModel(dtype=torch.float32, **cfg)
    opt, state, step = ex.setup(model, bert_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"), "cpu",
        opt_level="O0", **LAMB)
    losses = []
    for _ in range(STEPS):
        loss, state = step(state, **batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    tw = [w.float().numpy() for w in tree_leaves(opt.params)]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(tw, jw))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(jw, init))
    assert np.sqrt(num / den) <= 1e-4, np.sqrt(num / den)


@pytest.mark.parametrize("packed", [False, True])
def test_pretraining_steps_through_flash_match_jax(packed):
    _steps_match_jax(packed, CFG)


def test_a_vocab_on_the_cross_entropy_gate_matches_jax():
    """Vocab 128 is on the fused cross entropy's gate (C % 128 == 0): the
    reference runs its Pallas kernels (interpret mode), the port the
    kernels' plain versions on the CPU, with label -1 on the packed
    batch's padding masked by ``padding_idx``."""
    from apex_tpu.ops.xentropy import _use_pallas
    cfg = dict(CFG, vocab_size=128)
    assert _use_pallas(cfg["vocab_size"])
    _steps_match_jax(True, cfg)


def test_example_trains_both_batches_on_cpu_and_refuses_offload():
    for packed in (False, True):
        res = ex.train(steps=2, packed=packed, device="cpu", log=None)
        assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    # --offload-state was refused until the state offload was ported; it
    # now trains (bit for bit against resident: test_torch_port_
    # offload_state.py)
    res = ex.main(["--device", "cpu", "--offload-state", "--steps", "1"])
    assert res.opt.offload_state and len(res.losses) == 1
    assert all(np.isfinite(res.losses))
