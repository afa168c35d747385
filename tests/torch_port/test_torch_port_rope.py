"""apex_tpu_torch's RoPE against apex_tpu's.

The same numpy ``t`` and angles go through
``apex_tpu.ops.rope.fused_apply_rotary_pos_emb`` /
``apex_tpu.transformer.functional.fused_apply_rotary_pos_emb_cached``
and through the port on the CPU: forward and gradient (the reference's
custom VJP, the exact transpose of the rotation) with the rotary dim the
whole head or half of it, interleaved and not, f32 and bf16; and the
port's custom backward against torch's autograd of :func:`rope_ref`.

Tolerances: f32 within rtol 1e-5 / atol 1e-6; bf16 within one bf16
rounding (rtol 2^-7, atol 1e-6 for values that round to zero: both
sides round each product and the sum in bf16, so with jax 0.9's
XLA they agree bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import rope as jrope
from apex_tpu.transformer.functional import \
    fused_apply_rotary_pos_emb_cached as jcached
from apex_tpu_torch.ops import rope as trope
from apex_tpu_torch.transformer.functional import (
    fused_apply_rotary_pos_emb, fused_apply_rotary_pos_emb_cached)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
S, B, H, D = 10, 2, 3, 16


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _close(got, want, dtn):
    got, want = _np(got), _np(want)
    if dtn == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def _inputs(rot, dtn, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((S, B, H, D)).astype(np.float32)
    freqs = (rng.standard_normal((S, 1, 1, rot)) * 3).astype(np.float32)
    w = rng.standard_normal((S, B, H, D)).astype(np.float32)
    jdt, tdt = DTYPES[dtn]
    return (jnp.asarray(t).astype(jdt), torch.from_numpy(t).to(tdt), freqs,
            w)


def _grads(jfn, tfn, jt, tt, w):
    jy, jg = jfn(jt), jax.grad(
        lambda t: jnp.sum(jfn(t).astype(jnp.float32) * w))(jt)
    x = tt.clone().requires_grad_()
    ty = tfn(x)
    (ty.float() * torch.from_numpy(w)).sum().backward()
    return jy, jg, ty, x.grad


@pytest.mark.parametrize("dtn", sorted(DTYPES))
@pytest.mark.parametrize("rot_frac", [1.0, 0.5])
@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_matches_the_reference(interleaved, rot_frac, dtn):
    jt, tt, freqs, w = _inputs(int(D * rot_frac), dtn, seed=1)
    jy, jg, ty, tg = _grads(
        lambda t: jrope.fused_apply_rotary_pos_emb(t, jnp.asarray(freqs),
                                                   interleaved),
        lambda t: fused_apply_rotary_pos_emb(t, torch.from_numpy(freqs),
                                             interleaved),
        jt, tt, w)
    assert ty.dtype == tt.dtype and tg.dtype == tt.dtype
    _close(ty, jy, dtn)
    _close(tg, jg, dtn)
    # the trailing channels pass through untouched
    rot = freqs.shape[-1]
    assert torch.equal(ty[..., rot:], tt[..., rot:])


@pytest.mark.parametrize("dtn", sorted(DTYPES))
@pytest.mark.parametrize("interleaved", [False, True])
def test_cached_variant_matches_the_reference(interleaved, dtn):
    jt, tt, freqs, w = _inputs(D // 2, dtn, seed=2)
    cos, sin = np.cos(freqs), np.sin(freqs)
    jy, jg, ty, tg = _grads(
        lambda t: jcached(t, jnp.asarray(cos), jnp.asarray(sin),
                          interleaved),
        lambda t: fused_apply_rotary_pos_emb_cached(
            t, torch.from_numpy(cos), torch.from_numpy(sin), interleaved),
        jt, tt, w)
    _close(ty, jy, dtn)
    _close(tg, jg, dtn)


@pytest.mark.parametrize("rot_frac", [1.0, 0.5])
@pytest.mark.parametrize("interleaved", [False, True])
def test_custom_backward_is_the_transpose_autograd_finds(interleaved,
                                                         rot_frac):
    _, tt, freqs, w = _inputs(int(D * rot_frac), "f32", seed=3)
    f = torch.from_numpy(freqs)
    a = tt.clone().requires_grad_()
    b = tt.clone().requires_grad_()
    (fused_apply_rotary_pos_emb(a, f, interleaved)
     * torch.from_numpy(w)).sum().backward()
    (trope.rope_ref(b, f, interleaved) * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
