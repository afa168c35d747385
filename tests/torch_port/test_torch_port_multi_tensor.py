"""apex_tpu_torch.ops.multi_tensor against apex_tpu.ops.multi_tensor.

The same numpy inputs (made from a seed) go through the JAX kernels —
Pallas in interpret mode on the CPU, as tests/test_multi_tensor.py runs
them — and through the port with CPU tensors, where each wrapper runs
its plain twin.  Rows 6, 7 and 10 of the kernel table: flat_accumulate,
flat_unscale_norm, flat_sgd.

Tolerances: the port's elementwise outputs agree to the bit with the
JAX package's (both round the same f32 products and sums in the same
order), except flat_sgd against the TPU kernel run through XLA: there
XLA may contract a product and a sum into one FMA, and the kernel
multiplies by 1/grad_scale where the oracle divides, so that check is
within f32 rounding (rtol 1e-6, atol 1e-7; it stays bit-exact against
the JAX oracle ``flat_sgd_ref``).  Sums of squares are summed in another
order: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch.ops import multi_tensor as tmt

SIZES = [1, 5, 128, 1000, 4099]
KERNEL_TOL = dict(rtol=1e-6, atol=1e-7)


def _np(n, seed, poison=None):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if poison:
        x[n // 2] = np.float32(poison)
    return x


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x)
    if dtype == jnp.bfloat16:
        t = t.to(torch.bfloat16)
    return j, t


def _t2np(t):
    return t.float().numpy()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_flat_accumulate_matches_jax(n, gdt, poison):
    acc = _np(n, 1)
    g = _np(n, 2, poison)
    jacc, tacc = _pair(acc, jnp.float32)
    jg, tg = _pair(g, gdt)
    jout, jflag = jmt.flat_accumulate(jnp.array(jacc, copy=True), jg, 0.5)
    tout, tflag = tmt.flat_accumulate(tacc, tg, 0.5)
    assert tout is tacc                          # in place
    np.testing.assert_array_equal(_t2np(tout), np.asarray(jout))
    assert int(tflag) == int(jflag) == (poison is not None)


def test_flat_accumulate_flag_latches_through_later_adds():
    acc = torch.zeros(7)
    g = torch.ones(7)
    g[3] = float("inf")
    _, f1 = tmt.flat_accumulate(acc, g)
    _, f2 = tmt.flat_accumulate(acc, torch.ones(7))   # clean grads
    assert int(f1) == 1 and int(f2) == 1         # the RESULT is still inf
    with pytest.raises(ValueError, match="f32"):
        tmt.flat_accumulate(torch.zeros(3, dtype=torch.bfloat16),
                            torch.zeros(3))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_flat_unscale_norm_matches_jax(n, xdt, poison):
    x = _np(n, 3, poison)
    jx, tx = _pair(x, xdt)
    inv = np.float32(1.0 / 1024)
    jo, jn, jf = jmt.flat_unscale_norm(jx, inv)
    to, tn, tf = tmt.flat_unscale_norm(tx, torch.tensor(inv))
    np.testing.assert_array_equal(_t2np(to), np.asarray(jo, np.float32))
    assert int(tf) == int(jf) == (poison is not None)
    if poison is None:
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)


SGD_CASES = {
    # name: (p dtype, g dtype, momentum, dampening, nesterov, first, gs)
    "momentum_first": (jnp.float32, jnp.float32, 0.9, 0.0, False, True, 1.0),
    "momentum": (jnp.float32, jnp.float32, 0.9, 0.0, False, False, 1.0),
    "nesterov_bf16_grad": (jnp.float32, jnp.bfloat16, 0.9, 0.0, True, False,
                           1.0),
    "nesterov_first": (jnp.float32, jnp.bfloat16, 0.9, 0.0, True, True, 1.0),
    "dampening": (jnp.float32, jnp.float32, 0.5, 0.25, False, False, 1.0),
    "no_momentum": (jnp.float32, jnp.float32, 0.0, 0.0, False, False, 1.0),
    "bf16_params": (jnp.bfloat16, jnp.bfloat16, 0.9, 0.0, False, False, 1.0),
    "grad_scale": (jnp.float32, jnp.float32, 0.9, 0.1, False, False, 1000.0),
}


@pytest.mark.parametrize("n", [1, 130, 4099])
@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_flat_sgd_matches_jax(n, case):
    pdt, gdt, mom, damp, nest, first, gs = SGD_CASES[case]
    jp, tp = _pair(_np(n, 4), pdt)
    jg, tg = _pair(_np(n, 5), gdt)
    jb, tb = _pair(_np(n, 6), jnp.float32)
    kw = dict(lr=0.1, momentum=mom, dampening=damp, weight_decay=1e-4,
              nesterov=nest, first_run=first, grad_scale=gs)
    jpr, jbr = jmt.flat_sgd_ref(jp, jg, jb, **kw)
    # the kernel aliases p and buf to its outputs: give it copies
    jpo, jbo = jmt.flat_sgd(jnp.array(jp, copy=True), jg,
                            jnp.array(jb, copy=True), **kw)
    tpo, tbo = tmt.flat_sgd(tp, tg, tb, **kw)
    assert tpo is tp and tbo is tb               # in place
    # the twin is the JAX oracle's arithmetic, bit for bit
    np.testing.assert_array_equal(_t2np(tpo), np.asarray(jpr, np.float32))
    np.testing.assert_array_equal(_t2np(tbo), np.asarray(jbr, np.float32))
    # ... and the TPU kernel's within f32 rounding
    np.testing.assert_allclose(_t2np(tpo), np.asarray(jpo, np.float32),
                               **KERNEL_TOL)
    np.testing.assert_allclose(_t2np(tbo), np.asarray(jbo, np.float32),
                               **KERNEL_TOL)


@pytest.mark.parametrize("flag", [0, 1])
def test_flat_sgd_found_inf_gate_keeps_p_and_buf(flag):
    p, g, b = (torch.from_numpy(_np(99, s)) for s in (7, 8, 9))
    p0, b0 = p.clone(), b.clone()
    tmt.flat_sgd(p, g, b, lr=0.1, momentum=0.9, weight_decay=1e-4,
                 first_run=torch.tensor(False),
                 found_inf=torch.tensor(flag, dtype=torch.int32))
    assert torch.equal(p, p0) == bool(flag)
    assert torch.equal(b, b0) == bool(flag)


def test_traced_first_run_and_grad_scale_as_tensors():
    """first_run and grad_scale may be 0-d tensors (the optimizer's step
    clock and clip-folded scale): the same result as Python values."""
    p, g, b = (torch.from_numpy(_np(64, s)) for s in (10, 11, 12))
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
    a = tmt.flat_sgd_ref(p, g, b, first_run=True, grad_scale=8.0, **kw)
    t = tmt.flat_sgd_ref(p, g, b, first_run=torch.tensor(True),
                         grad_scale=torch.tensor(8.0), **kw)
    for x, y in zip(a, t):
        assert torch.equal(x, y)


def test_grid_is_fixed_by_n():
    assert tmt.grid_blocks(1) == 1
    assert tmt.grid_blocks(4 * 256) == 1
    assert tmt.grid_blocks(4 * 256 + 1) == 2
    assert tmt.grid_blocks(25_557_032) == tmt.MAX_BLOCKS
