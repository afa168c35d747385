"""Flash attention at head dims past 128 (F5b, F5c) against the JAX
package.

On the card the port pads a head dim of 129..256 to its 256-wide bodies
and 257..512 to its 512-wide ones (``ops.attention._kernel_width``),
with the scale 1/sqrt(D) of the unpadded D; the reference pads D to its
128 lanes and shrinks its sequence blocks as the padded width grows.
Here, on the CPU, the port's ``flash_attention`` (its plain twins, which
take any D) against the JAX ``flash_attention`` (its Pallas kernels in
interpret mode) on the same numpy inputs made from a seed, at D 160,
192, 256 and 512 (the widest width the card takes), causal and not,
with dropout 0.25 and without: the output, and the gradients of a
weighted sum against ``jax.grad``.  And the padding itself: the twins
at D zero-padded to the kernel width give the unpadded result.

F5c: past 512 the card pads a head dim to the next power of two up to
8192 and runs its wide bodies (rows across warps); here D 640 and 1024,
f32 and bf16, dropout 0 and 0.1, against the JAX ``flash_attention``,
and the padding to 1024.  F7: past 8192 the card pads a head dim to the
next multiple of 8192 and splits each row's columns over CTAs; here D
8200 against the JAX ``flash_attention`` and its padding to 16384.

Tolerances: f32 within 1e-5 of each output's scale (the two sum the
same products in another order; ``test_torch_port_dropout.py``'s),
bf16 within 2**-7 of the scale (one bf16 rounding of p or ds can flip
on a last-bit f32 difference).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch.ops import attention as tattn

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
WIDE = (160, 192, 256, 512)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _inputs(d, causal, rate, dt, b=1, h=2, hk=1, s=40):
    rng = np.random.default_rng(zlib.crc32(f"{d}{causal}{rate}{dt}".encode()))
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))]


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDE)
def test_wide_heads_match_jax_forward_and_grad(d, causal, rate):
    dt = "bf16" if d == 192 else "f32"
    q, k, v, w = _inputs(d, causal, rate, dt)
    jdt, tdt = DT[dt]
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=11 if rate else None)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    jo = jattn.flash_attention(jq, jk, jv, **kw)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    to = tattn.flash_attention(tq, tk, tv, **kw)
    (to.float() * torch.from_numpy(w)).sum().backward()
    assert to.dtype == tdt and tuple(to.shape) == q.shape
    _close(to, jo, TOL[dt])
    for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(g, want, TOL[dt])


@pytest.mark.parametrize("d", WIDE)
def test_zero_padding_to_the_kernel_width_is_exact(d):
    """What the card's wrappers do before a launch: q, k, v zero-padded
    to the kernel width, the scale of the unpadded D, the result cut back
    to D.  The twins run at the padded width give the unpadded result
    within the f32 tolerance (the padded width changes the CPU's summation
    blocking; forward, lse and the three gradients), with dropout 0.25,
    and exact zeros in the padding."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(d, True, 0.25,
                                                         "f32"))
    wd = tattn._kernel_width(d)
    assert wd == (256 if d <= 256 else 512)
    pad = [torch.nn.functional.pad(t, (0, wd - d)) for t in (q, k, v, do)]
    sc = 1.0 / np.sqrt(d)
    o, lse = tattn.flash_fwd_ref(q, k, v, True, sc, None, 0.25, 11)
    po, plse = tattn.flash_fwd_ref(*pad[:3], True, sc, None, 0.25, 11)
    _close(po[..., :d], o, TOL["f32"])
    assert torch.all(po[..., d:] == 0)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
    grads = tattn.flash_bwd_ref(q, k, v, o, lse, do, True, sc, None, 0.25,
                                11)
    pgrads = tattn.flash_bwd_ref(*pad[:3], po, plse, pad[3], True, sc, None,
                                 0.25, 11)
    for g, pg in zip(grads, pgrads):
        _close(pg[..., :d], g, TOL["f32"])
        assert torch.all(pg[..., d:] == 0)


PAST_512 = (640, 1024)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", PAST_512)
def test_heads_past_512_match_jax_forward_and_grad(d, dt, rate):
    """F5c's widths: the port's ``flash_attention`` on the CPU (the plain
    twins the wide kernels are held to on the card) against the JAX
    ``flash_attention`` (Pallas in interpret mode), causal, output and
    the three gradients."""
    q, k, v, w = _inputs(d, True, rate, dt, s=64)
    jdt, tdt = DT[dt]
    kw = dict(causal=True, dropout_rate=rate,
              dropout_seed=29 if rate else None)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    jo = jattn.flash_attention(jq, jk, jv, **kw)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    to = tattn.flash_attention(tq, tk, tv, **kw)
    (to.float() * torch.from_numpy(w)).sum().backward()
    assert to.dtype == tdt and tuple(to.shape) == q.shape
    _close(to, jo, TOL[dt])
    for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(g, want, TOL[dt])


def _padding_is_exact(d, wd, rate, seed, s):
    """The wrappers' padding of D to ``wd`` on the twins: ``_operands``
    pads with zeros, and the twins at the padded width (forward, lse and
    the three gradients, the scale of the unpadded D) give the unpadded
    result within the f32 tolerance and exact zeros in the padding."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(d, True, rate, "f32",
                                                         s=s))
    assert tattn._kernel_width(d) == wd
    (padded,) = tattn._operands(q)
    assert padded.shape[-1] == wd and torch.all(padded[..., d:] == 0)
    pad = [torch.nn.functional.pad(t, (0, wd - d)) for t in (q, k, v, do)]
    sc = 1.0 / np.sqrt(d)
    o, lse = tattn.flash_fwd_ref(q, k, v, True, sc, None, rate, seed)
    po, plse = tattn.flash_fwd_ref(*pad[:3], True, sc, None, rate, seed)
    _close(po[..., :d], o, TOL["f32"])
    assert torch.all(po[..., d:] == 0)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
    grads = tattn.flash_bwd_ref(q, k, v, o, lse, do, True, sc, None, rate,
                                seed)
    pgrads = tattn.flash_bwd_ref(*pad[:3], po, plse, pad[3], True, sc, None,
                                 rate, seed)
    for g, pg in zip(grads, pgrads):
        _close(pg[..., :d], g, TOL["f32"])
        assert torch.all(pg[..., d:] == 0)


def test_padding_past_512_and_the_cards_limit():
    """D 640 zero-padded to the 1024-wide body gives the unpadded
    result (dropout 0.1).  F7: the card has no head-dim limit any more:
    past 8192 a head pads to the next multiple of 8192, and D 8200
    zero-padded to 16384 gives the unpadded result too."""
    _padding_is_exact(640, 1024, 0.1, 5, s=24)
    assert tattn._kernel_width(8192) == 8192
    assert [tattn._kernel_width(d) for d in (8193, 16384, 16385, 30000)] == [
        16384, 16384, 24576, 32768]
    _padding_is_exact(8200, 16384, 0.1, 5, s=12)


PAST_8192 = (8200,)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", PAST_8192)
def test_heads_past_8192_match_jax_forward_and_grad(d, dt, rate):
    """F7's widths: the port's ``flash_attention`` on the CPU (the twins
    the card's kernels are held to) against the JAX ``flash_attention``
    (Pallas in interpret mode), causal, output and the three gradients,
    at D 8200 (the card pads it to 16384, the reference to 8320)."""
    q, k, v, w = _inputs(d, True, rate, dt, s=16)
    jdt, tdt = DT[dt]
    kw = dict(causal=True, dropout_rate=rate,
              dropout_seed=31 if rate else None)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    jo = jattn.flash_attention(jq, jk, jv, **kw)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    to = tattn.flash_attention(tq, tk, tv, **kw)
    (to.float() * torch.from_numpy(w)).sum().backward()
    assert to.dtype == tdt and tuple(to.shape) == q.shape
    _close(to, jo, TOL[dt])
    for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(g, want, TOL[dt])
