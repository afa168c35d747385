"""apex_tpu_torch.contrib.fmha against apex_tpu.contrib.fmha.

The same numpy packed qkv ``(total, 3, H, D)`` and ``cu_seqlens`` go
through the JAX package's ``fmha_packed`` / ``FMHAFun.apply`` (the
Pallas flash kernel in interpret mode) and through the port's (one
``flash_attention`` over ``(1, H, total, D)`` with segment ids from
``torch.searchsorted``): with and without dropout (the port handed the
seed the JAX side folds from its key, ``dropout_seed_from_key``),
causal or not, f32 and bf16, outputs and the gradient of qkv under
``jax.grad`` / autograd.  The buffer's tail past ``cu_seqlens[-1]`` is
exact zeros on both sides, in the output and in its gradient.

Tolerances: f32 within 1e-5 of each output's scale (the same products
summed in another order), bf16 within 2**-7 (one bf16 rounding of p or
ds can flip on a last-bit f32 difference; see
``test_torch_port_flash_bwd.py``); one function run twice on the CPU
within 1e-6 (the CPU's BLAS may sum in another order from call to call
under load).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import fmha as jfmha
from apex_tpu.ops.attention import dropout_seed_from_key
from apex_tpu_torch.contrib import fmha as tfmha

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
H, D = 2, 32
LENGTHS = [17, 40, 5, 26]          # 88 real tokens
TOTAL = 96                         # a tail of 8 padding tokens

CASES = [
    # dtype, p_dropout, causal
    ("f32", 0.0, False),
    ("f32", 0.0, True),
    ("f32", 0.2, False),
    ("bf16", 0.1, True),
    ("bf16", 0.0, False),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((TOTAL, 3, H, D)).astype(np.float32)
    w = rng.standard_normal((TOTAL, H, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(LENGTHS)]).astype(np.int32)
    return qkv, w, cu


@pytest.mark.parametrize("case", range(len(CASES)))
def test_fmha_packed_matches_jax(case):
    dt, p, causal = CASES[case]
    qkv, w, cu = _inputs(case)
    key = jax.random.key(case)
    seed = int(dropout_seed_from_key(key)) if p else None

    def jloss(x):
        o = jfmha.fmha_packed(x, jnp.asarray(cu), p, dropout_rng=key,
                              causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w)), o

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(qkv).astype(DT[dt][0]))
    tx = torch.from_numpy(qkv).to(DT[dt][1]).requires_grad_()
    to = tfmha.fmha_packed(tx, torch.from_numpy(cu), p, dropout_seed=seed,
                           causal=causal)
    (to.float() * torch.from_numpy(w)).sum().backward()
    assert to.dtype == DT[dt][1] and tuple(to.shape) == (TOTAL, H, D)
    _close(to, jo, TOL[dt])
    _close(tx.grad, jg, TOL[dt])
    end = int(cu[-1])
    assert torch.all(to[end:] == 0) and torch.all(tx.grad[end:] == 0)


def test_fmha_dropout_draws_and_eval():
    """The seed drawn from a generator a call (the same state, the same
    bits; the next draw, others); in eval (``is_training=False``) no
    dropout: the p = 0 result."""
    qkv, _, cu = _inputs(9)
    x, cu_t = torch.from_numpy(qkv), torch.from_numpy(cu)
    g = torch.Generator().manual_seed(2)
    first = tfmha.fmha_packed(x, cu_t, 0.3, generator=g)
    second = tfmha.fmha_packed(x, cu_t, 0.3, generator=g)
    again = tfmha.fmha_packed(x, cu_t, 0.3,
                              generator=torch.Generator().manual_seed(2))
    same = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(first, again, **same)
    assert not torch.allclose(first, second)
    plain = tfmha.fmha_packed(x, cu_t, 0.0)
    torch.testing.assert_close(
        tfmha.fmha_packed(x, cu_t, 0.3, is_training=False), plain, **same)
    want = jfmha.fmha_packed(jnp.asarray(qkv), jnp.asarray(cu), 0.0)
    _close(plain, want, TOL["f32"])


def test_fmha_fun_apply_matches_jax():
    qkv, w, cu = _inputs(12)
    key = jax.random.key(5)
    seed = int(dropout_seed_from_key(key))
    want = jfmha.FMHAFun.apply(jnp.asarray(qkv), jnp.asarray(cu), 0.25,
                               max_s=64, dropout_rng=key)
    got = tfmha.FMHAFun.apply(torch.from_numpy(qkv), torch.from_numpy(cu),
                              0.25, max_s=64, dropout_seed=seed)
    _close(got, want, TOL["f32"])
    with pytest.raises(ValueError, match="total, 3, H, D"):
        tfmha.fmha_packed(torch.zeros(4, 2, H, D), torch.tensor([0, 4]))


def test_segment_ids_come_from_cu_seqlens():
    cu = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    got = tfmha.fmha._segment_ids(cu, 9)
    want = np.asarray(jfmha.fmha._segment_ids(jnp.asarray(cu.numpy()), 9))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [0, 0, 0, 2, 2, 2, 2, 3, 3]
