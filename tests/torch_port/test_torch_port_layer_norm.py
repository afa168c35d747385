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
    with pytest.raises(NotImplementedError, match=r"item 9 \(slice 9\)"):
        normalization.FusedLayerNorm(128, sequence_parallel=True)


def _rows(h, dtype, offset=0):
    """(8, h) of ``dtype`` starting ``offset`` elements into a buffer."""
    return torch.zeros(8 * h + offset, dtype=dtype)[offset:].view(8, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,route", [(128, "fused"), (768, "fused"),
                                     (1024, "fused"), (4096, "fused"),
                                     (tln.FUSED_MAX_H, "fused"),
                                     (tln.FUSED_MAX_H + 128, "three"),
                                     (32768, "three")])
def test_backward_route_follows_the_fused_bodys_register_limit(h, route,
                                                               dtype):
    """The fused backward takes rows up to FUSED_MAX_H (at least 8192:
    GPT-2's 768, BERT-L's 1024 and Llama-class 4096 fit); wider rows,
    up to the gate's 32768, keep the three-launch body; the device
    kernels a call launches follow the route."""
    assert tln.FUSED_MAX_H >= 8192
    x, dy = _rows(h, dtype), _rows(h, dtype)
    assert tln.bwd_route(x, dy) == route
    assert tln.BWD_DEVICE_KERNELS[route] == (2 if route == "fused" else 3)


@pytest.mark.parametrize("which", ["x", "dy"])
def test_backward_route_takes_three_launches_off_16_bytes(which):
    """An x or dy whose data starts 2 bytes off a 16-byte boundary (a
    bf16 view one element in) cannot take the fused body's vector loads:
    the three-launch body, which accepts any row start."""
    aligned, off = _rows(1024, torch.bfloat16), _rows(1024, torch.bfloat16, 1)
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    x, dy = (off, aligned) if which == "x" else (aligned, off)
    assert tln.bwd_route(x, dy) == "three"
    assert tln.bwd_route(aligned, aligned) == "fused"


@pytest.mark.parametrize("rows,route,want", [
    (4096, "fused", (32, 128)), (333, "fused", (8, 42)), (1, "fused", (8, 1)),
    (65536, "fused", (64, 1024)), (4096, "three", (64, 64)),
    (333, "three", (64, 6))])
def test_backward_chunking_is_a_function_of_the_rows(rows, route, want):
    """Each dw/db partial sums a fixed chunk of rows that depends on the
    row count only (not on the card), so the bits repeat on every H100."""
    assert tln._chunking(rows, route) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,route", [(128, "register"), (768, "register"),
                                     (1024, "register"), (4096, "register"),
                                     (tln.FUSED_MAX_H, "register"),
                                     (tln.FUSED_MAX_H + 128, "wide"),
                                     (32768, "wide")])
def test_forward_route_follows_the_register_bodys_limit(h, route, dtype):
    """The register forward takes rows up to FUSED_MAX_H (GPT-2's 768,
    BERT-L's 1024 and Llama-class 4096 fit, as in the fused backward);
    wider rows, up to the gate's 32768, keep the block-a-row body."""
    assert tln.fwd_route(_rows(h, dtype)) == route


@pytest.mark.parametrize("offset,route", [(0, "register"), (1, "wide"),
                                          (4, "wide"), (8, "register")])
def test_forward_route_takes_the_wide_body_off_16_bytes(offset, route):
    """An x whose data starts off a 16-byte boundary (a bf16 view 1 or 4
    elements in) cannot take the register body's 16-byte loads: the wide
    body, which accepts any row start; 8 elements in is 16 bytes."""
    x = _rows(1024, torch.bfloat16, offset)
    assert (x.data_ptr() % 16 == 0) == (route == "register")
    assert tln.fwd_route(x) == route


def test_forward_kernel_names_keep_the_profiled_prefix():
    """Both forward bodies are named ln_fwd_*, the prefix the profile
    attribution matches, and neither name holds the other's."""
    import os
    from apex_tpu_torch import _build
    src = open(os.path.join(_build.CSRC, "layer_norm.cu")).read()
    for name in ("ln_fwd_reg_kernel(", "ln_fwd_kernel("):
        assert name in src
    assert "ln_fwd_kernel" not in "ln_fwd_reg_kernel"


def test_backward_kernel_names_keep_the_profiled_prefix():
    """Both backward bodies and the combine are named ln_bwd_*, the prefix
    the profile attribution matches."""
    import os
    from apex_tpu_torch import _build
    src = open(os.path.join(_build.CSRC, "layer_norm.cu")).read()
    for name in ("ln_bwd_fused_kernel(", "ln_bwd_dx_kernel(",
                 "ln_bwd_partial_kernel(", "ln_bwd_combine_kernel("):
        assert name in src
