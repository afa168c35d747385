"""apex_tpu_torch.offload against apex_tpu.offload
(``tests/test_offload.py``'s three cases, and the GPT block's
``--offload-activations``).

- A two-matmul block with a tagged GELU hidden: the gradients under
  ``offload_checkpoint`` equal the plain ones on the port's side and
  the reference's ``offload_checkpoint`` gradients on the same numpy
  inputs within rtol 1e-5 and 1e-6 of each leaf's largest entry (the
  reference's own tolerance, scaled: each framework sums the matmuls in
  its own order, and the entries reach 6).
- The reference checks that its policy lowers for the TPU; the port's
  counterpart checks that the tagged tensors, and only those, go
  through the host hook, once per tag in the forward, while a
  ``save_names`` tag stays on the device; and that the offloaded tag
  spares recomputation: the backward does not rerun what follows the
  last recomputed op, which plain recomputation (no names) does.
- ``GPTLayer``'s ``attn_out`` / ``ffn_hidden`` tags compose with
  ``offload_checkpoint`` over the unmodified layer: the same gradients
  as the plain layer within rtol 1e-5, atol 1e-5 (the reference's).
- The GPT block stack of ``examples/gpt/train_block.py`` with
  ``offload_activations=True`` in f32: its loss and gradients equal the
  port's plain step within rtol 1e-5, atol 1e-6, and the reference's
  offloaded stack within the GPT block tests' f32 bounds (the loss
  within rtol 1e-5, each gradient within 1e-4 of its leaf's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu.offload import checkpoint_name as jname
from apex_tpu.offload import offload_checkpoint as joffload
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import offload
from apex_tpu_torch._tree import tree_leaves
from apex_tpu_torch.offload import checkpoint_name, offload_checkpoint

F32 = dict(rtol=1e-5, atol=1e-6)


def _weights():
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((64, 256)) * 0.1).astype(np.float32),
            (rng.standard_normal((256, 64)) * 0.1).astype(np.float32),
            rng.standard_normal((8, 64)).astype(np.float32))


def _block(w1, w2, x):
    h = checkpoint_name(F.gelu(x @ w1, approximate="tanh"), "ffn_hidden")
    return checkpoint_name(h @ w2, "out")


def _jblock(w1, w2, x):
    h = jname(jax.nn.gelu(x @ w1), "ffn_hidden")
    return jname(h @ w2, "out")


def _grads(f, w1, w2, x):
    w1, w2 = (torch.from_numpy(w).requires_grad_(True) for w in (w1, w2))
    return torch.autograd.grad((f(w1, w2, torch.from_numpy(x)) ** 2).sum(),
                               (w1, w2))


def test_offload_checkpoint_matches_plain_grads():
    w1, w2, x = _weights()
    plain = _grads(_block, w1, w2, x)
    off = _grads(offload_checkpoint(_block, offload_names=("ffn_hidden",)),
                 w1, w2, x)
    jf = joffload(_jblock, offload_names=("ffn_hidden",))
    jg = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) ** 2),
                          argnums=(0, 1)))(w1, w2, x)
    for p, o, j in zip(plain, off, jg):
        torch.testing.assert_close(o, p, rtol=0, atol=0)
        j = np.asarray(j)
        np.testing.assert_allclose(o.numpy(), j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max())


def test_only_the_tagged_tensors_go_through_the_host():
    w1, w2, x = _weights()
    off = offload_checkpoint(_block, offload_names=("ffn_hidden",),
                             save_names=("out",))
    offload.host_copies.clear()
    grads = _grads(off, w1, w2, x)
    assert dict(offload.host_copies) == {"ffn_hidden": 1}
    # a second step copies again, once per tag; outside a scope the tags
    # are the identity and nothing goes to the host
    _grads(off, w1, w2, x)
    assert dict(offload.host_copies) == {"ffn_hidden": 2}
    _grads(_block, w1, w2, x)
    assert dict(offload.host_copies) == {"ffn_hidden": 2}
    for g, p in zip(grads, _grads(_block, w1, w2, x)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    t = torch.ones(3)
    assert checkpoint_name(t, "ffn_hidden") is t


def test_an_offloaded_tag_spares_recomputing_what_follows():
    """The matmul that reads the offloaded hidden is not rerun in the
    backward: the recomputation stops at the GELU.  Without names (plain
    recomputation) it reruns to the end."""
    w1, w2, x = _weights()
    tails = []

    def block(w1, w2, x):
        h = checkpoint_name(F.gelu(x @ w1, approximate="tanh"),
                            "ffn_hidden")
        tails.append(1)
        return h @ w2

    plain = _grads(block, w1, w2, x)
    for names, runs in ((("ffn_hidden",), 1), ((), 2)):
        tails.clear()
        got = _grads(offload_checkpoint(block, offload_names=names),
                     w1, w2, x)
        assert len(tails) == runs, names
        for g, p in zip(got, plain):
            torch.testing.assert_close(g, p, rtol=0, atol=0)


def test_gpt_layer_tags_compose_with_offload():
    from apex_tpu_torch.models import GPTLayer

    layer = GPTLayer(32, 4)
    params = layer.init(torch.Generator().manual_seed(1), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 2, 32)).astype(np.float32))

    def loss(apply):
        return lambda p, xx: torch.sum(apply(p, xx) ** 2)

    (_, _), g_plain = tamp.value_and_grad(loss(layer), params, x)
    offload.host_copies.clear()
    off = offload_checkpoint(layer, offload_names=("attn_out",
                                                   "ffn_hidden"))
    (_, _), g_off = tamp.value_and_grad(loss(off), params, x)
    assert dict(offload.host_copies) == {"attn_out": 1, "ffn_hidden": 1}
    for a, b in zip(tree_leaves(g_plain), tree_leaves(g_off)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_gpt_block_offload_step_matches_plain_and_reference():
    from test_torch_port_gpt_block import (CFG, _close_scaled, _jloss,
                                           _ref_module, _tokens)

    from apex_tpu_torch.convert import gpt_block_from_jax
    from apex_tpu_torch.examples import gpt_train_block as ex

    c = CFG
    kw = dict(max_seq=max(c["seq"], 128))
    jm = _ref_module().GPTBlocks(c["vocab"], c["hidden"], c["heads"],
                                 c["layers"], dtype=jnp.float32,
                                 offload_activations=True, **kw)
    tokens = _tokens()
    jp = jm.init(jax.random.key(0), jnp.asarray(tokens))["params"]
    tp = gpt_block_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ttok = torch.from_numpy(tokens).long()
    losses = {}
    grads = {}
    for off in (False, True):
        tm = ex.GPTBlocks(c["vocab"], c["hidden"], c["heads"], c["layers"],
                          dtype=torch.float32, offload_activations=off, **kw)
        offload.host_copies.clear()
        (losses[off], _), grads[off] = tamp.value_and_grad(
            lambda p, t: ex.next_token_loss(tm(p, t), t), tp, ttok)
        if off:
            assert dict(offload.host_copies) == {"ffn_hidden": c["layers"]}
    np.testing.assert_allclose(float(losses[True]), float(losses[False]),
                               **F32)
    for a, b in zip(tree_leaves(grads[False]), tree_leaves(grads[True])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **F32)
    jvg = jax.jit(jax.value_and_grad(lambda p, t: _jloss(jm, p, t)))
    jl, jg = jvg(jp, jnp.asarray(tokens))
    np.testing.assert_allclose(float(losses[True]), float(jl), rtol=1e-5)
    for g, j in zip(tree_leaves(grads[True]),
                    jax.tree_util.tree_leaves(jg)):
        _close_scaled(g, j, 1e-4)
