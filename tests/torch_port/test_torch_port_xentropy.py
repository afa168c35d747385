"""apex_tpu_torch's softmax cross entropy against apex_tpu's.

The same numpy logits and labels go through ``apex_tpu.ops.xentropy``
(its Pallas kernels in interpret mode on the gate, C % 128 == 0; its
XLA formula off it, as at BERT-Large's C = 30528) and through the port
on the CPU, forward and backward, with and without label smoothing, f32
and bf16 logits, and through ``contrib.xentropy`` with ``padding_idx``
(-1, the MLM loss's padding label, and the reference default 0).
Labels outside [0, C) follow each side of the gate: the kernel's
``col == label`` one-hot on it, ``take_along_axis`` off it.  On the
gate a tensor off the CPU must reach the kernels' launchers (a stub on
the meta device here; the kernels themselves are held on the card by
``test_torch_port_cuda.py``).

Tolerances: f32 losses and gradients within rtol 1e-5 / atol 1e-6 (the
same formula, summed in each framework's order); bf16 losses within 2e-2
(one bf16 rounding of the result), bf16 gradients within 1e-2 of the
gradient's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jloss_fn
from apex_tpu.ops import xentropy as jx
from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             softmax_cross_entropy_loss)
from apex_tpu_torch.ops import xentropy as tx


def _case(n, c, dtype, seed, pad=None):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    if pad is not None:
        labels[::3] = pad
    dy = rng.standard_normal(n).astype(np.float32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    return jl, tl, labels, dy


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _check(got, want, dtype, grad=False):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    elif grad:
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=1e-2 * scale)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("c", [256, 200])         # on / off the gate
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_backward_match_jax(c, smoothing, dtype):
    assert tx._use_pallas(c) == jx._use_pallas(c) == (c == 256)
    jl, tl, labels, dy = _case(12, c, dtype, seed=c)
    jloss, vjp = jax.vjp(
        lambda x: jx.softmax_cross_entropy(x, jnp.asarray(labels),
                                           smoothing), jl)
    tl = tl.requires_grad_(True)
    tloss = tx.softmax_cross_entropy(tl, torch.from_numpy(labels),
                                     smoothing)
    assert tloss.dtype == tl.dtype
    _check(tloss, jloss, dtype)
    (jgrad,) = vjp(jnp.asarray(dy).astype(jloss.dtype))
    tloss.backward(torch.from_numpy(dy).to(tloss.dtype))
    assert tl.grad.dtype == tl.dtype
    _check(tl.grad, jgrad, dtype, grad=True)
    ref = tx.softmax_cross_entropy_ref(tl, torch.from_numpy(labels),
                                       smoothing)
    _check(ref, jx.softmax_cross_entropy_ref(jl, jnp.asarray(labels),
                                             smoothing), dtype)


@pytest.mark.parametrize("padding_idx", [-1, 0])
def test_loss_with_padding_and_half_to_float(padding_idx):
    """BERT's MLM loss shape: C off the gate, labels -1 (or 0) on
    padding, the losses and their gradient zero there."""
    jl, tl, labels, dy = _case(15, 300, "bfloat16", seed=4,
                               pad=padding_idx)
    jloss, vjp = jax.vjp(lambda x: jloss_fn(
        x, jnp.asarray(labels), 0.0, padding_idx, True), jl)
    tl = tl.requires_grad_(True)
    tloss = softmax_cross_entropy_loss(tl, torch.from_numpy(labels), 0.0,
                                       padding_idx, True)
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(_np(tloss), _np(jloss), rtol=1e-5, atol=1e-5)
    assert np.all(_np(tloss)[labels == padding_idx] == 0)
    (jgrad,) = vjp(jnp.asarray(dy))
    tloss.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(_np(tl.grad), _np(jgrad), rtol=0,
                               atol=1e-2 * float(np.abs(_np(jgrad)).max()))
    assert np.all(_np(tl.grad)[labels == padding_idx] == 0)
    again = SoftmaxCrossEntropyLoss.apply(tl, torch.from_numpy(labels), 0.0,
                                          padding_idx, True)
    assert torch.equal(again, tloss)


def test_labels_out_of_range_follow_jax_indexing():
    """Off the gate a negative label counts from the end, one past C
    gathers NaN; in the backward both have no one-hot term."""
    jl, tl, _, _ = _case(3, 50, "float32", seed=9)
    labels = np.array([-1, 7, 50], np.int32)
    want = jx.softmax_cross_entropy(jl, jnp.asarray(labels))
    got = tx.softmax_cross_entropy(tl, torch.from_numpy(labels))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    assert np.isnan(_np(got)[2])
    jgrad = jax.grad(lambda x: jnp.sum(jnp.where(
        jnp.arange(3) < 2, jx.softmax_cross_entropy(x, jnp.asarray(labels)),
        0.0)))(jl)
    tl = tl.requires_grad_(True)
    loss = tx.softmax_cross_entropy(tl, torch.from_numpy(labels))
    torch.where(torch.arange(3) < 2, loss, torch.zeros(())).sum().backward()
    np.testing.assert_allclose(_np(tl.grad), _np(jgrad), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("c", [256, 2048])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_labels_out_of_range_on_the_gate_have_no_target_term(c, smoothing,
                                                             dtype):
    """On the gate the reference kernel's one-hot is ``col == label``: a
    label outside [0, C) has no target term (``loss = lse - s *
    mean(x)``) and no one-hot term in the gradient, where the XLA path
    off the gate would wrap -1 and give NaN at C."""
    jl, tl, labels, dy = _case(6, c, dtype, seed=c + 9)
    labels[:3] = [-1, c, c + 5]
    jloss, vjp = jax.vjp(
        lambda x: jx.softmax_cross_entropy(x, jnp.asarray(labels),
                                           smoothing), jl)
    tl = tl.requires_grad_(True)
    tloss = tx.softmax_cross_entropy(tl, torch.from_numpy(labels),
                                     smoothing)
    assert np.all(np.isfinite(_np(tloss)))
    _check(tloss, jloss, dtype)
    xf = tl.detach().float()
    want = torch.logsumexp(xf, 1) - smoothing * xf.mean(1)
    _check(tloss[:3], want[:3].to(tloss.dtype), dtype)
    (jgrad,) = vjp(jnp.asarray(dy).astype(jloss.dtype))
    tloss.backward(torch.from_numpy(dy).to(tloss.dtype))
    _check(tl.grad, jgrad, dtype, grad=True)


def test_half_to_float_on_the_gate_matches_jax():
    """bf16 logits at C = 256 with ``half_to_float``: f32 losses and an
    f32 gradient, as the reference kernel writes them."""
    jl, tl, labels, dy = _case(10, 256, "bfloat16", seed=31)
    jloss, vjp = jax.vjp(lambda x: jx.softmax_cross_entropy(
        x, jnp.asarray(labels), 0.1, True), jl)
    tl = tl.requires_grad_(True)
    tloss = tx.softmax_cross_entropy(tl, torch.from_numpy(labels), 0.1,
                                     True)
    assert jloss.dtype == jnp.float32 and tloss.dtype == torch.float32
    np.testing.assert_allclose(_np(tloss), _np(jloss), rtol=1e-5, atol=1e-6)
    (jgrad,) = vjp(jnp.asarray(dy))
    tloss.backward(torch.from_numpy(dy))
    assert tl.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl.grad), _np(jgrad), rtol=0,
                               atol=1e-2 * float(np.abs(_np(jgrad)).max()))


@pytest.mark.parametrize("c", [256, 200])         # on / off the gate
def test_the_gate_routes_a_card_tensor_to_the_kernels(c, monkeypatch):
    """A tensor off the CPU (the meta device stands in for the card)
    reaches the forward and backward kernels' launchers on the gate and
    neither off it, where the plain formula runs, as the reference's
    XLA path does."""
    calls = []

    def fwd(logits, labels, smoothing, half_to_float):
        calls.append("fwd")
        n = logits.shape[0]
        return (torch.empty(n, dtype=tx._loss_dtype(logits, half_to_float),
                            device=logits.device),
                torch.empty(n, device=logits.device))

    def bwd(logits, labels, lse, dy, smoothing, half_to_float):
        calls.append("bwd")
        return torch.empty(logits.shape, device=logits.device,
                           dtype=tx._loss_dtype(logits, half_to_float))

    monkeypatch.setattr(tx, "_xent_fwd_cuda", fwd)
    monkeypatch.setattr(tx, "_xent_bwd_cuda", bwd)
    x = torch.zeros(4, c, device="meta", requires_grad=True)
    loss = tx.softmax_cross_entropy(x, torch.zeros(4, dtype=torch.long,
                                                   device="meta"), 0.1)
    assert calls == (["fwd"] if c == 256 else [])
    loss.sum().backward()
    assert calls == (["fwd", "bwd"] if c == 256 else [])
    assert x.grad.shape == (4, c)
