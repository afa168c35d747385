"""apex_tpu_torch.ops.welford against apex_tpu.ops.welford.

The same numpy arrays go through the JAX op (its Pallas kernel in
interpret mode on the gate, C % 128 == 0; its plain fallback off it) and
through the port on the CPU (the plain version on either side: the
kernel runs only on the card, ``test_torch_port_cuda.py``).

Tolerances are the reference's own (``tests/test_parallel.py``): mean
rtol 1e-5 / atol 1e-6, var rtol 1e-4 / atol 1e-5, the count exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import welford as jw
from apex_tpu_torch.ops import welford as tw

MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
VAR_TOL = dict(rtol=1e-4, atol=1e-5)


def _check(got, want):
    mean, var, count = got
    np.testing.assert_allclose(mean.numpy(), np.asarray(want[0]), **MEAN_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(want[1]), **VAR_TOL)
    assert count.shape == () and count.dtype == torch.float32
    assert float(count) == float(want[2])


@pytest.mark.parametrize("shape", [(32, 128), (100, 256), (7, 128),
                                   (300, 384), (50, 100)])
def test_welford_mean_var_matches_jax(shape):
    assert tw._use_pallas(shape[1]) == (shape[1] % 128 == 0)
    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32) * 2 + 0.5
    got = tw.welford_mean_var(torch.from_numpy(x))
    for t in got[:2]:
        assert t.shape == (shape[1],) and t.dtype == torch.float32
    _check(got, jw.welford_mean_var(jnp.asarray(x)))
    _check(tw.welford_mean_var_ref(torch.from_numpy(x)),
           jw.welford_mean_var_ref(jnp.asarray(x)))


def test_welford_combine_matches_jax_and_guards_empty_parts():
    rng = np.random.default_rng(3)
    ma, mb = rng.standard_normal((2, 1, 8)).astype(np.float32)
    m2a, m2b = rng.random((2, 1, 8)).astype(np.float32)
    for na, nb in ((5.0, 7.0), (0.0, 4.0), (4.0, 0.0), (0.0, 0.0)):
        want = jw.welford_combine(jnp.float32(na), jnp.asarray(ma),
                                  jnp.asarray(m2a), jnp.float32(nb),
                                  jnp.asarray(mb), jnp.asarray(m2b))
        got = tw.welford_combine(torch.tensor(na), torch.from_numpy(ma),
                                 torch.from_numpy(m2a), torch.tensor(nb),
                                 torch.from_numpy(mb), torch.from_numpy(m2b))
        for g, w in zip(got, want):
            assert np.all(np.isfinite(g.numpy()))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    # two halves merge into the whole
    x = rng.standard_normal((40, 8)).astype(np.float32)
    a, b = tw.welford_mean_var(torch.from_numpy(x[:15])), \
        tw.welford_mean_var(torch.from_numpy(x[15:]))
    n, mean, m2 = tw.welford_combine(a[2], a[0], a[1] * a[2], b[2], b[0],
                                     b[1] * b[2])
    assert float(n) == 40
    np.testing.assert_allclose(mean.numpy(), x.mean(0), **MEAN_TOL)
    np.testing.assert_allclose((m2 / n).numpy(), x.var(0), **VAR_TOL)


def test_large_mean_is_stable():
    """300 + 0.05 noise (``tests/test_parallel.py``'s case): the
    variance stays within the reference's tolerance of the JAX op and of
    an f64 evaluation, where a sum / sum-of-squares would cancel."""
    x = (300.0 + 0.05 * np.random.default_rng(12).standard_normal(
        (4096, 256))).astype(np.float32)
    got = tw.welford_mean_var(torch.from_numpy(x))
    _check(got, jw.welford_mean_var(jnp.asarray(x)))
    np.testing.assert_allclose(got[1].numpy(), x.astype(np.float64).var(0),
                               **VAR_TOL)
    assert float(got[1].min()) > 1e-4


def test_bf16_input_gives_f32_stats():
    x = np.random.default_rng(4).standard_normal((64, 128)).astype(
        np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tw.welford_mean_var(xb)
    assert all(t.dtype == torch.float32 for t in got)
    _check(got, jw.welford_mean_var(jnp.asarray(x).astype(jnp.bfloat16)))


def test_welford_takes_only_two_dims():
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        tw.welford_mean_var(torch.zeros(2, 3, 128))
