"""apex_tpu_torch's fused softmax against apex_tpu's.

The same numpy inputs from a seed go through ``apex_tpu.ops.softmax``
and ``apex_tpu.transformer.functional.FusedScaleMaskSoftmax`` (the
Pallas kernels in interpret mode on their gate, the XLA formula off it,
as ``tests/test_fused_softmax_rope.py`` runs them) and through the port
on the CPU (the kernels' plain versions on the gate, the same formula
off it): the masked, unmasked and causal forward and their gradients in
f32 and bf16, on the gate (sk 128 and 256) and off it (sk 72; masked
with sq 12, whose forward is off the gate and backward on it); rows
with every entry masked; the module's routing, its ``mask_func``
branch and its causal squareness check; the gate functions themselves;
and the unfused attention that chip_smoke.py drives (``q @ k^T``, the
module, ``@ v``) against ``apex_tpu.ops.attention.attention_ref``.

Tolerances: f32 within atol 1e-6 / rtol 1e-5 (one formula; ``exp``
rounded and the row sums ordered by each framework); bf16 within one
bf16 rounding (rtol 2^-7 of each value, atol 1e-6 for values that
round to zero).  Rows with every entry masked are exact zeros on both
sides, their gradients too.  The unfused attention: f32 within 1e-5,
bf16 within 2e-2 of the output's scale (the scores and the
probabilities rounded to bf16 where the oracle keeps f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.enums import AttnMaskType as JMask
from apex_tpu.transformer.functional import \
    FusedScaleMaskSoftmax as JFused
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer.enums import AttnMaskType as TMask
from apex_tpu_torch.transformer.functional import \
    FusedScaleMaskSoftmax as TFused

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SCALE = 0.7


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _close(got, want, dtn):
    if dtn == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7,
                                   atol=1e-6)


def _inputs(shape, dtn, seed, mask_shape=None, dead_rows=()):
    """x and a weight for the loss (its gradient), both sides; a 0/1
    int32 mask (~30% masked) with the listed query rows fully masked."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtn]
    out = dict(jx=jnp.asarray(x).astype(jdt), tx=torch.from_numpy(x).to(tdt),
               w=w)
    if mask_shape is not None:
        m = (rng.random(mask_shape) < 0.3).astype(np.int32)
        for r in dead_rows:
            m[..., r, :] = 1
        out.update(jm=jnp.asarray(m), tm=torch.from_numpy(m))
    return out


def _jax_value_and_grad(fn, x, w):
    def loss(x):
        return jnp.sum(fn(x).astype(jnp.float32) * w)
    return fn(x), jax.grad(loss)(x)


def _torch_value_and_grad(fn, x, w):
    x = x.clone().requires_grad_()
    y = fn(x)
    (y.float() * torch.from_numpy(w)).sum().backward()
    return y, x.grad


# name: (x shape, mask shape or None, causal)
CASES = {
    "masked_sk128": ((2, 3, 16, 128), (2, 1, 16, 128), False),
    "masked_sk256": ((1, 2, 8, 256), (1, 1, 8, 256), False),
    "unmasked_sk256": ((2, 3, 8, 256), None, False),
    "causal_sk128": ((2, 128, 128), None, True),
    "masked_off_gate_sk72": ((2, 3, 16, 72), (2, 1, 16, 72), False),
    "masked_sq12_fwd_off_bwd_on": ((2, 3, 12, 128), (2, 1, 12, 128), False),
    "unmasked_off_gate_sk72": ((2, 3, 8, 72), None, False),
    "causal_off_gate_sk72": ((2, 72, 72), None, True),
}


@pytest.mark.parametrize("dtn", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradient_match_the_reference(case, dtn):
    shape, mshape, causal = CASES[case]
    d = _inputs(shape, dtn, seed=len(case), mask_shape=mshape,
                dead_rows=(3,) if mshape else ())
    if causal:
        jfn = lambda x: jsm.scaled_upper_triang_masked_softmax(x, SCALE)
        tfn = lambda x: tsm.scaled_upper_triang_masked_softmax(x, SCALE)
    else:
        jm, tm = (d["jm"], d["tm"]) if mshape else (None, None)
        jfn = lambda x: jsm.scaled_masked_softmax(x, jm, SCALE)
        tfn = lambda x: tsm.scaled_masked_softmax(x, tm, SCALE)
    jy, jg = _jax_value_and_grad(jfn, d["jx"], d["w"])
    ty, tg = _torch_value_and_grad(tfn, d["tx"], d["w"])
    assert ty.dtype == DTYPES[dtn][1] and tg.dtype == DTYPES[dtn][1]
    _close(ty, jy, dtn)
    _close(tg, jg, dtn)
    if mshape:                       # query row 3 is masked everywhere
        assert np.all(_np(ty)[..., 3, :] == 0) and np.all(_np(jy)[..., 3, :]
                                                          == 0)
        assert np.all(_np(tg)[..., 3, :] == 0)
    if causal:
        assert np.all(np.triu(_np(ty)[0], k=1) == 0)


@pytest.mark.parametrize("dtn", sorted(DTYPES))
def test_plain_versions_match_the_reference_oracles(dtn):
    d = _inputs((2, 2, 8, 128), dtn, seed=5, mask_shape=(2, 1, 8, 128),
                dead_rows=(0,))
    _close(tsm.scaled_masked_softmax_ref(d["tx"], d["tm"], SCALE),
           jsm.scaled_masked_softmax_ref(d["jx"], d["jm"], SCALE), dtn)
    c = _inputs((2, 128, 128), dtn, seed=6)
    _close(tsm.scaled_upper_triang_masked_softmax_ref(c["tx"], SCALE),
           jsm.scaled_upper_triang_masked_softmax_ref(c["jx"], SCALE), dtn)
    dy = d["w"]
    y = jsm.scaled_masked_softmax_ref(d["jx"], d["jm"], SCALE)
    _close(tsm.softmax_vjp_ref(torch.tensor(_np(y)).to(DTYPES[dtn][1]),
                               torch.from_numpy(dy).to(DTYPES[dtn][1]),
                               SCALE),
           jsm._softmax_vjp(y, jnp.asarray(dy).astype(DTYPES[dtn][0]),
                            SCALE), dtn)


def test_a_score_below_minus_5000_kills_the_row_as_in_the_reference():
    """The fill is -10000, not -inf: an unmasked row whose scaled scores
    all lie at or below -5000 is dead (zeros) on both sides."""
    x = np.full((1, 1, 8, 128), -6000.0, np.float32)
    x[0, 0, 1] = np.linspace(-6000, -4000, 128)     # alive: max -4000
    jy = jsm.scaled_masked_softmax(jnp.asarray(x), None, 1.0)
    ty = tsm.scaled_masked_softmax(torch.from_numpy(x), None, 1.0)
    _close(ty, jy, "f32")
    assert np.all(_np(ty)[0, 0, 0] == 0) and _np(ty)[0, 0, 1].sum() > 0.99


@pytest.mark.parametrize("mdt", [np.int32, np.bool_, np.uint8, np.float32])
def test_mask_dtypes(mdt):
    d = _inputs((2, 2, 8, 128), "f32", seed=7, mask_shape=(2, 1, 8, 128))
    m = np.asarray(d["jm"]).astype(mdt)
    jy = jsm.scaled_masked_softmax(d["jx"], jnp.asarray(m), SCALE)
    ty = tsm.scaled_masked_softmax(d["tx"], torch.from_numpy(m), SCALE)
    _close(ty, jy, "f32")


def test_a_broadcast_mask_raises_on_the_gate_and_broadcasts_off_it():
    """The reference's masked kernel reshapes the mask to (b*sq, sk):
    a (1, 1, sq, sk) mask with b > 1 is an error there, not a
    broadcast; off the gate (sk 72) both sides broadcast it."""
    on = _inputs((2, 2, 8, 128), "f32", seed=8, mask_shape=(1, 1, 8, 128))
    with pytest.raises(TypeError):
        jsm.scaled_masked_softmax(on["jx"], on["jm"], SCALE)
    with pytest.raises(TypeError):
        tsm.scaled_masked_softmax(on["tx"], on["tm"], SCALE)
    off = _inputs((2, 2, 8, 72), "f32", seed=9, mask_shape=(1, 1, 8, 72))
    _close(tsm.scaled_masked_softmax(off["tx"], off["tm"], SCALE),
           jsm.scaled_masked_softmax(off["jx"], off["jm"], SCALE), "f32")


@pytest.mark.parametrize("bad", [torch.tensor(0.5), "0.5", None])
def test_scale_must_be_a_python_number(bad):
    x = torch.zeros(1, 1, 8, 128)
    with pytest.raises(TypeError):
        tsm.scaled_masked_softmax(x, None, bad)
    with pytest.raises(TypeError):
        tsm.scaled_upper_triang_masked_softmax(x[0], bad)


def test_gate_functions_match_the_reference():
    for sk in list(range(0, 8193, 64)) + [72, 200, 4224]:
        assert tsm._use_pallas(sk) == jsm._use_pallas(sk), sk
        if sk:
            assert tsm._block_rows_cap(sk) == jsm._block_rows_cap(sk), sk
    for sq in range(0, 600, 3):
        for cap in (8, 16, 128, 256):
            assert tsm._divisor_block(sq, cap) == jsm._divisor_block(sq, cap)
    assert (tsm.LANE, tsm._MAX_SK, tsm._NEG) == (jsm.LANE, jsm._MAX_SK,
                                                 jsm._NEG)


def _padding_mask(b, sq, sk, lengths):
    """Megatron's BERT padding mask pad_q | pad_k, (b, 1, sq, sk)."""
    pad = np.arange(sk)[None, :] >= np.asarray(lengths)[:, None]
    return (pad[:, None, :, None] | pad[:, None, None, :]).astype(np.int32)


MODULE_CASES = {
    # name: (kwargs, x shape, with a mask)
    "causal": (dict(attn_mask_type="causal", scale=0.5), (2, 2, 128, 128),
               False),
    "padding": (dict(scale=0.25), (2, 3, 16, 128), True),
    "padding_no_mask": (dict(), (2, 3, 8, 256), False),
    "padding_no_scale_off_gate": (dict(), (2, 3, 8, 72), True),
    "mask_func_fusion_off": (dict(scaled_masked_softmax_fusion=False,
                                  mask_func="fill", scale=0.5),
                             (2, 3, 16, 128), True),
    "mask_func_fusion_on": (dict(mask_func="fill", scale=0.5),
                            (2, 3, 16, 128), True),
}


def _fill_j(x, m):
    return jnp.where(m != 0, -1e4, x)


def _fill_t(x, m):
    return x.masked_fill(m != 0, -1e4)


@pytest.mark.parametrize("dtn", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_fused_scale_mask_softmax_matches_the_reference(case, dtn):
    kw, shape, with_mask = MODULE_CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("attn_mask_type") == "causal":
        jkw["attn_mask_type"], tkw["attn_mask_type"] = JMask.causal, \
            TMask.causal
    if "mask_func" in kw:
        jkw["mask_func"], tkw["mask_func"] = _fill_j, _fill_t
    jmod, tmod = JFused(**jkw), TFused(**tkw)
    d = _inputs(shape, dtn, seed=len(case),
                mask_shape=(shape[0], 1) + shape[2:] if with_mask else None,
                dead_rows=(1,) if with_mask else ())
    jm, tm = (d["jm"], d["tm"]) if with_mask else (None, None)
    jy, jg = _jax_value_and_grad(lambda x: jmod(x, jm), d["jx"], d["w"])
    ty, tg = _torch_value_and_grad(lambda x: tmod(x, tm), d["tx"], d["w"])
    _close(ty, jy, dtn)
    _close(tg, jg, dtn)
    b, np_, sq, sk = shape
    assert tmod.is_kernel_available(tm, b, np_, sq, sk) == \
        jmod.is_kernel_available(jm, b, np_, sq, sk)


def test_module_checks_as_the_reference_does():
    x = np.random.default_rng(10).standard_normal((1, 1, 1, 128)).astype(
        np.float32)
    with pytest.raises(AssertionError):
        JFused(attn_mask_type=JMask.causal)(jnp.asarray(x))
    with pytest.raises(AssertionError):
        TFused(attn_mask_type=TMask.causal)(torch.from_numpy(x))
    for kw in (dict(input_in_fp16=True, input_in_bf16=True),
               dict(softmax_in_fp32=False, scale=0.5)):
        with pytest.raises(AssertionError):
            JFused(**kw)
        with pytest.raises(AssertionError):
            TFused(**kw)


def _unfused_torch(q, k, v, fsm, mask):
    """Megatron's core attention: scores in the operands' dtype, the
    fused softmax module, then ``@ v``."""
    return torch.matmul(fsm(torch.matmul(q, k.transpose(-1, -2)), mask), v)


@pytest.mark.parametrize("dtn", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["causal", "padding"])
def test_unfused_attention_matches_attention_ref(kind, dtn):
    b, h, s, d = 2, 2, 128, 32
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    jdt, tdt = DTYPES[dtn]
    scale = 1.0 / np.sqrt(d)
    if kind == "causal":
        fsm = TFused(attn_mask_type=TMask.causal, scale=scale)
        tmask = jmask = None
        alive = np.ones((b, 1, s, 1), bool)
    else:
        fsm = TFused(attn_mask_type=TMask.padding, scale=scale)
        m = _padding_mask(b, s, s, [s, 40])
        tmask, jmask = torch.from_numpy(m), jnp.where(m != 0, -1e4, 0.0)
        alive = m.min(axis=-1, keepdims=True) == 0
    do = do * alive                  # dead query rows get no gradient
    tq, tk, tv = (torch.from_numpy(t).to(tdt).requires_grad_()
                  for t in (q, k, v))
    out = _unfused_torch(tq, tk, tv, fsm, tmask)
    out.backward(torch.from_numpy(do).to(tdt))

    def ref(q, k, v):
        return jattn.attention_ref(q, k, v, causal=kind == "causal",
                                   scale=scale, mask=jmask)
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    want, vjp = jax.vjp(ref, jq, jk, jv)
    wgrads = vjp(jnp.asarray(do).astype(want.dtype))
    names = ("out", "dq", "dk", "dv")
    for name, got, w in zip(names, (out, tq.grad, tk.grad, tv.grad),
                            (want,) + wgrads):
        diff = _np(got) - _np(w)
        if name == "out":            # a dead row: zeros here, mean(v) there
            diff = np.where(alive, diff, 0.0)
        limit = 1e-5 if dtn == "f32" else 2e-2 * np.abs(_np(w)).max()
        assert np.abs(diff).max() <= limit, (name, np.abs(diff).max(), limit)
    if kind == "padding":            # dead query rows are exact zeros
        dead = ~np.broadcast_to(alive, out.shape)
        assert np.all(_np(out)[dead] == 0)
