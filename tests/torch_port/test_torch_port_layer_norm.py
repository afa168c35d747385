"""apex_tpu_torch's fused LayerNorm / RMSNorm against apex_tpu's.

The same numpy inputs go through ``apex_tpu.ops.layer_norm`` (its
Pallas kernels in interpret mode on the CPU, or its XLA formula off the
gate) and through the port on the CPU (the kernels' plain twins, or the
plain formula off the gate): forward, and the VJP of a random cotangent
for x, weight and bias.  h in {128, 1024} is on the kernels' gate, 80
is off it.

Tolerances are the reference's own (tests/test_fused_layer_norm.py):
rtol = atol = 1e-5 in f32, 2e-2 in bf16 (one bf16 rounding of the
output; both sides sum in f32 in their own orders); the f32 gradients
within 1e-4 (as the reference's grads test); bf16 gradients of x within
2e-2 (the output's dtype), of the f32 weight and bias within 1e-4 of
their scale (they are sums over the rows, taken in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JFusedLayerNorm
from apex_tpu.normalization import FusedRMSNorm as JFusedRMSNorm
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch import normalization
from apex_tpu_torch.ops import layer_norm as tln

ROWS = 24


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _inputs(h, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, ROWS // 2, h)) * 3 + 1).astype(np.float32)
    w = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, ROWS // 2, h)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the same (rounded) values on both sides
    x = np.asarray(jx.astype(jnp.float32))
    dy_j = jnp.asarray(dy).astype(dtype)
    dy_t = torch.from_numpy(dy).to(getattr(torch, dtype))
    return jx, tx, w, b, dy_j, dy_t


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [128, 1024, 80])
@pytest.mark.parametrize("rms", [False, True])
def test_forward_and_vjp_match_jax(h, rms, dtype):
    jx, tx, w, b, dy_j, dy_t = _inputs(h, dtype, seed=h + rms)
    assert tln._use_pallas(h) == jln._use_pallas(h) == (h != 80)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tx = tx.requires_grad_(True)
    if rms:
        jy, vjp = jax.vjp(lambda x, w: jln.fused_rms_norm(x, w), jx, jw)
        ty = tln.fused_rms_norm(tx, tw)
    else:
        jy, vjp = jax.vjp(lambda x, w, b: jln.fused_layer_norm(x, w, b),
                          jx, jw, jb)
        ty = tln.fused_layer_norm(tx, tw, tb)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **_tol(dtype))
    jgrads = vjp(dy_j)
    ty.backward(dy_t)
    tgrads = (tx.grad, tw.grad) if rms else (tx.grad, tw.grad, tb.grad)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(tgrads[0]), _np(jgrads[0]),
                               **(_tol(dtype) if dtype == "bfloat16"
                                  else dict(rtol=1e-4, atol=1e-4)))
    for tg, jg in zip(tgrads[1:], jgrads[1:]):
        scale = float(np.abs(_np(jg)).max())
        np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0))


@pytest.mark.parametrize("rms", [False, True])
def test_bf16_params_and_no_affine(rms):
    """O2's bf16 norm params: dw/db come back in the params' dtype; with
    no weight the op normalises alone."""
    jx, tx, w, b, dy_j, dy_t = _inputs(256, "bfloat16", seed=7)
    jw, jb = jnp.asarray(w).astype(jnp.bfloat16), \
        jnp.asarray(b).astype(jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_(True)
    if rms:
        jy, vjp = jax.vjp(lambda w: jln.fused_rms_norm(jx, w), jw)
        ty = tln.fused_rms_norm(tx, tw)
        (tw_want,) = vjp(dy_j)
        ty.backward(dy_t)
        got = [tw.grad]
        want = [tw_want]
    else:
        jy, vjp = jax.vjp(lambda w, b: jln.fused_layer_norm(jx, w, b),
                          jw, jb)
        ty = tln.fused_layer_norm(tx, tw, tb)
        want = list(vjp(dy_j))
        ty.backward(dy_t)
        got = [tw.grad, tb.grad]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=2e-2, atol=2e-2)
    for g, j in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(j), rtol=2e-2,
                                   atol=2e-2 * float(np.abs(_np(j)).max()))
    plain = tln.fused_rms_norm(tx) if rms else tln.fused_layer_norm(tx)
    want = jln.fused_rms_norm(jx) if rms else jln.fused_layer_norm(jx)
    np.testing.assert_allclose(_np(plain), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rms", [False, True])
def test_twins_mirror_the_kernel_bodies(rms):
    """The plain twins of _fwd_2d/_bwd_2d against the reference's Pallas
    kernels themselves (interpret mode), 2-D, f32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    w = (rng.standard_normal(128) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    dy = rng.standard_normal((16, 128)).astype(np.float32)
    jy = jln._fwd_2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5,
                     rms)
    ty = tln._fwd_2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), 1e-5, rms)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    jg = jln._bwd_2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy), 1e-5,
                     rms)
    tg = tln._bwd_2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(dy), 1e-5, rms)
    for a, c in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("cls,jcls", [
    (normalization.FusedLayerNorm, JFusedLayerNorm),
    (normalization.FusedRMSNorm, JFusedRMSNorm),
    (normalization.MixedFusedLayerNorm, JFusedLayerNorm)])
def test_modules_match_flax_params_and_outputs(cls, jcls):
    x = np.random.default_rng(5).standard_normal((3, 4, 2, 64)).astype(
        np.float32)
    jmod = jcls(normalized_shape=(2, 64))
    jparams = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    mod = cls((2, 64))
    params = mod.init("cpu")
    assert sorted(params) == sorted(jparams)
    for k in params:
        assert tuple(params[k].shape) == tuple(jparams[k].shape)
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
    got = mod(params, torch.from_numpy(x))
    want = jmod.apply({"params": jparams}, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_what_waits_for_later_slices_says_so():
    with pytest.raises(NotImplementedError, match="slice 4 item 12"):
        normalization.FusedLayerNorm(128, sequence_parallel=True)
