"""The port's flash-attention twins and gradients against the JAX kernels.

The same numpy inputs, made from a seed, go through the JAX package's
``_fwd_pallas(need_lse=True)`` / ``_bwd_pallas`` (interpret-mode Pallas
on the CPU, as the JAX package's own tests run them) and through the
port's plain twins ``flash_fwd_ref`` / ``flash_bwd_ref``; then
``jax.grad`` of ``apex_tpu.ops.attention.flash_attention`` against the
port's ``flash_attention`` under autograd on the CPU (its autograd
Function with the twins).  The cases cover causal or not, packed
segment ids with pad rows, grouped-query heads and Sq = 200 (not a
multiple of the TPU kernel's 128-row blocks), in f32 and bf16, f32 at D
16 and 32 among them.

Tolerances (each with its reason):
- f32: the two sum the same products in another order: within 1e-5 of
  each output's scale (o, dq, dk, dv), lse within 1e-5;
- bf16: both round p (before P.V and dV) and ds (before dQ and dK) to
  bf16 and round each result once; an f32 difference in the last bit
  (another exp or summation order) can flip one of those roundings, so
  the outputs agree within one bf16 rounding: 2**-7 of their scale
  (one bf16 ulp is 2**-8 relative, plus a flipped p or ds rounding
  summed in); lse is f32 and agrees within 1e-5.
Rows that see no key give exact zeros on both sides, in o and dq; key
rows that no query sees give exact zeros in dk and dv.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch import _build
from apex_tpu_torch.ops import attention as tattn

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}

CASES = {
    # name: (b, h, hk, s, d, causal, seg kind, dtype)
    "causal_f32": (2, 2, 2, 64, 32, True, None, "f32"),
    "non_causal_packed_f32": (2, 2, 2, 60, 16, False, "packed", "f32"),
    "gqa_causal_packed_s200_f32": (2, 4, 2, 200, 64, True, "packed", "f32"),
    "gqa_causal_ragged_s200_bf16": (2, 4, 2, 200, 32, True, "ragged",
                                    "bf16"),
    "non_causal_bf16": (1, 2, 2, 48, 64, False, None, "bf16"),
    "mqa_causal_packed_d128_bf16": (1, 2, 1, 40, 128, True, "packed",
                                    "bf16"),
    # f32 at the narrow widths (the register-tile dq and dk/dv at D 32 and
    # 16): grouped-query heads, Sq = 200 ragged and packed segment ids
    "gqa_causal_ragged_s200_d32_f32": (2, 4, 2, 200, 32, True, "ragged",
                                       "f32"),
    "gqa_packed_s200_d16_f32": (2, 4, 2, 200, 16, False, "packed", "f32"),
}


def _seg(kind, b, s):
    """(B, S) base segment ids: 1.. per sequence, 0 on padding."""
    if kind is None:
        return None
    seg = np.zeros((b, s), np.int32)
    if kind == "ragged":
        for i, n in enumerate([s, s // 2 + 3][:b]):
            seg[i, :n] = 1
    else:                           # two packed sequences + a pad tail
        seg[:, : s // 3] = 1
        seg[:, s // 3: s - s // 5] = 2
    return seg


def _inputs(name):
    b, h, hk, s, d, causal, kind, dt = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))]
    return arrs, causal, _seg(kind, b, s), dt


def _j(x, dt):
    return jnp.asarray(x).astype(DT[dt][0])


def _t(x, dt):
    return torch.from_numpy(np.array(x, np.float32)).to(DT[dt][1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _segs(seg):
    if seg is None:
        return None, None
    return (jattn.packed_segment_ids(jnp.asarray(seg)),
            tattn.packed_segment_ids(torch.from_numpy(seg)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fwd_twin_matches_pallas_fwd_with_lse(name):
    (q, k, v, _), causal, seg, dt = _inputs(name)
    jseg, tseg = _segs(seg)
    sc = 1.0 / np.sqrt(q.shape[-1])
    jo, jlse = jattn._fwd_pallas(_j(q, dt), _j(k, dt), _j(v, dt), sc,
                                 causal, jseg, need_lse=True)
    to, tlse = tattn.flash_fwd_ref(_t(q, dt), _t(k, dt), _t(v, dt), causal,
                                   sc, tseg)
    assert to.dtype == DT[dt][1] and tlse.dtype == torch.float32
    b, h, s, _ = q.shape
    assert tuple(tlse.shape) == (b * h, s)
    _close(to, jo, TOL[dt])
    jl = np.asarray(jlse)[:, :s, 0]
    np.testing.assert_allclose(tlse.numpy(), jl, rtol=1e-5, atol=1e-5)
    if seg is not None:
        pad = seg == 0                                   # (B, S)
        assert np.all(_np(to).transpose(0, 2, 1, 3)[pad] == 0.0)
        assert np.all(tlse.numpy().reshape(b, h, s).transpose(0, 2, 1)[pad]
                      == np.float32(-1e30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_twin_matches_pallas_bwd(name):
    (q, k, v, do), causal, seg, dt = _inputs(name)
    jseg, tseg = _segs(seg)
    sc = 1.0 / np.sqrt(q.shape[-1])
    s = q.shape[2]
    # both sides start from the reference forward's o and lse
    jo, jlse = jattn._fwd_pallas(_j(q, dt), _j(k, dt), _j(v, dt), sc,
                                 causal, jseg, need_lse=True)
    lse = np.asarray(jlse)[:, :s, 0]
    want = jattn._bwd_pallas(_j(q, dt), _j(k, dt), _j(v, dt), jo,
                             jnp.asarray(lse), _j(do, dt), sc, causal, jseg)
    got = tattn.flash_bwd_ref(_t(q, dt), _t(k, dt), _t(v, dt), _t(_np(jo), dt),
                              torch.from_numpy(lse), _t(do, dt), causal, sc,
                              tseg)
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == DT[dt][1] and g.shape == ref.shape
        _close(g, w, TOL[dt])
    if seg is not None:
        pad = seg == 0
        for g in got:          # pad q rows: no dq; pad kv rows: no dk/dv
            assert np.all(_np(g).transpose(0, 2, 1, 3)[pad] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_grads_match_jax_grad(name):
    (q, k, v, w), causal, seg, dt = _inputs(name)
    jseg, tseg = _segs(seg)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, segment_ids=jseg)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jo = jattn.flash_attention(_j(q, dt), _j(k, dt), _j(v, dt),
                               causal=causal, segment_ids=jseg)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q, dt), _j(k, dt), _j(v, dt))
    tq, tk, tv = (_t(x, dt).requires_grad_() for x in (q, k, v))
    to = tattn.flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg)
    (to.float() * torch.from_numpy(w)).sum().backward()
    _close(to, jo, TOL[dt])
    for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert g.dtype == DT[dt][1]
        _close(g, want, TOL[dt])


def test_grads_need_no_lse_without_grad():
    """Without a gradient the primal path runs (no lse); with one the
    autograd Function saves o and lse, and both give the same output."""
    (q, k, v, _), causal, seg, dt = _inputs("causal_f32")
    tq, tk, tv = (_t(x, dt) for x in (q, k, v))
    plain = tattn.flash_attention(tq, tk, tv, causal=causal)
    assert plain.grad_fn is None
    tracked = tattn.flash_attention(tq.requires_grad_(), tk, tv,
                                    causal=causal)
    assert type(tracked.grad_fn).__name__.startswith("_FlashAttention")
    assert torch.equal(plain, tracked.detach())


def test_dropout_raises_naming_its_roadmap_item():
    """Dropout is ported: a rate with a seed runs (and drops, under
    autograd too), the reference's two refusals stay: a rate outside
    [0, 1) and a rate above 0 with no seed."""
    q = torch.randn(1, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    kept = tattn.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=3)
    tracked = tattn.flash_attention(q.clone().requires_grad_(), q, q,
                                    dropout_rate=0.1, dropout_seed=3)
    torch.testing.assert_close(kept, tracked.detach(), rtol=1e-6, atol=1e-6)
    assert not torch.allclose(kept, tattn.flash_attention(q, q, q))
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tattn.flash_attention(q, q, q, dropout_rate=1.0)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tattn.flash_attention(q, q, q, dropout_rate=0.1)


def test_backward_kernels_are_registered_with_launch_counts():
    for kern in (tattn.FLASH_DQ, tattn.FLASH_DKV):
        assert kern in _build.KERNELS
        assert os.path.exists(os.path.join(_build.CSRC,
                                           f"{kern.library}.cu"))
    assert tattn.FLASH_DQ.library == tattn.FLASH_DKV.library == "flash_bwd"
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    before = [k.launches for k in _build.KERNELS]
    tattn.flash_attention(q, q, q, causal=True).sum().backward()
    assert [k.launches for k in _build.KERNELS] == before  # CPU: twins
