"""The port's correctly rounded roots on the CPU (``apex_tpu_torch.
_numerics``), against numpy's in f64.

aten's CPU f32 ``torch.sqrt`` is not correctly rounded on every host,
so a twin that took it matched the JAX package's bits on one host and
not on another.  ``_numerics.sqrt`` takes the root in f64 and rounds
once: on any host it gives the f32 root numpy gives from f64, bit for
bit, over 10**5 inputs spread over every binade, the subnormals, 0, -0,
inf, NaN and a negative; and so does ``_numerics.rsqrt`` (1/sqrt in
f64, rounded once).  ``_numerics.conv2d`` sums a convolution in f64 and
rounds once, so its f32 output and gradients do not move with the
thread count, as aten's f32 CPU convolution's may.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import _numerics


def _inputs(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 0x7F800000, n, dtype=np.int64).astype(np.int32)
    x = bits.view(np.float32)                   # every finite binade
    special = np.array([0.0, -0.0, np.inf, np.nan, -1.0, 1.0, 4.0,
                        np.finfo(np.float32).tiny,
                        np.finfo(np.float32).smallest_subnormal,
                        np.finfo(np.float32).max], np.float32)
    sub = (rng.integers(1, 0x00800000, 1000, dtype=np.int64)
           .astype(np.int32).view(np.float32))  # subnormals
    return np.concatenate([x, special, sub, rng.uniform(0, 3, 10_000)
                           .astype(np.float32)])


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def test_sqrt_is_correctly_rounded_on_the_cpu():
    x = _inputs()
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = _numerics.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _bits_equal(got.numpy(), want)


def test_rsqrt_is_the_rounded_f64_reciprocal_root():
    x = _inputs(seed=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    got = _numerics.rsqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_other_dtypes_keep_their_dtype(dtype):
    """f64 is torch's own root; bf16 goes through f64 and back."""
    x = torch.tensor([0.0, 2.0, 3.0, 1e-3], dtype=dtype)
    got = _numerics.sqrt(x)
    assert got.dtype == dtype
    want = torch.sqrt(x.double()).to(dtype)
    assert torch.equal(got, want)


def _conv_case():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16, 12, 12))
                         .astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((24, 16, 3, 3))
                         .astype(np.float32)).requires_grad_()
    return x, w


def _conv_and_grads(x, w, threads):
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        y = _numerics.conv2d(x, w, stride=2, padding=1)
        gx, gw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
    finally:
        torch.set_num_threads(old)
    return y, gx, gw


@pytest.mark.parametrize("threads", [1, 3])
def test_conv2d_is_the_rounded_f64_sum_at_any_thread_count(threads):
    """Output and both gradients are f32 and equal the f64 convolution
    (and its gradients) rounded once, bit for bit, at 1 and 3 threads."""
    x, w = _conv_case()
    got = _conv_and_grads(x, w, threads)
    x64, w64 = (t.detach().double().requires_grad_() for t in (x, w))
    y64 = torch.nn.functional.conv2d(x64, w64, stride=2, padding=1)
    want = (y64,) + torch.autograd.grad(y64, (x64, w64),
                                        torch.ones_like(y64))
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        _bits_equal(g.detach().numpy(), e.detach().float().numpy())
