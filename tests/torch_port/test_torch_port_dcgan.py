"""apex_tpu_torch's DCGAN example against the reference's
``examples/dcgan/main_amp.py`` (imported from its path).

The flax ``Generator`` and ``Discriminator`` are initialised by flax and
handed to the port through ``convert.dcgan_from_jax``; both packages see
the same numpy ``z`` and real images.

- The forward: the generated images and the logits within 1e-5 of their
  scale (the two frameworks sum their small convolutions in their own
  orders; the transposed convolutions exercise the kernel flip and the
  ``SAME`` padding).
- The training loop of ``main_amp.py:74-120`` (two ``FusedAdam``, two
  scalers, ``d_loss`` then ``g_loss`` each step), 3 steps: at O0 and at
  O1 (whose only change is the bf16 rounding of ``z`` and the real
  images, then f32 throughout, as the f32 params promote them), held
  by how far the reference itself moves when its f32 init changes by
  one ulp.  Adam's first update is ``lr * sign(g)``, so an element whose
  gradient is within f32 noise of zero (0.1-0.3% of the generator's)
  moves by a full ``2 * lr`` on such a change: at O0 the one-ulp change
  moves the reference's params by 0.0387 of their displacement (final
  minus init) and its losses by 9.5e-6; at O1 by 2.7e-5 and 8e-8.  The
  port measured 0.0387 and 7.6e-6.  So the losses agree within rtol
  1e-4 and the params' displacement within 0.1 of its norm.
- ``amp.state_dict`` over the two scalers equals the reference's
  (``tests/test_examples_smoke.py:582``: ``loss_scaler0`` and
  ``loss_scaler1``) and round-trips.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves
from apex_tpu_torch.convert import dcgan_from_jax
from apex_tpu_torch.examples import dcgan_main_amp as ex

_REF = os.path.join(os.path.dirname(__file__), "..", "..", "examples",
                    "dcgan", "main_amp.py")
B, NZ, STEPS = 4, 32, 3


@functools.lru_cache(maxsize=None)
def _ref_module():
    spec = importlib.util.spec_from_file_location("dcgan_main_amp_ref",
                                                  os.path.abspath(_REF))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # flax's dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_params():
    ref = _ref_module()
    pg = ref.Generator().init(jax.random.PRNGKey(0), jnp.zeros((B, NZ)))
    pd = ref.Discriminator().init(jax.random.PRNGKey(1),
                                  jnp.zeros((B, 16, 16, 3)))
    return (jax.tree_util.tree_map(np.asarray, pg["params"]),
            jax.tree_util.tree_map(np.asarray, pd["params"]))


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def test_forward_through_converted_weights():
    ref = _ref_module()
    jg, jd = _jax_params()
    tg, td = dcgan_from_jax(jg, jd, "cpu")
    z, real = next(ex.synthetic_batches(B, NZ, 1, seed=5))
    jimg = ref.Generator().apply({"params": jg}, jnp.asarray(z))
    timg = ex.Generator(nz=NZ)(tg, torch.from_numpy(z))
    assert timg.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(_np(timg), _np(jimg), rtol=0,
                               atol=1e-5 * np.abs(_np(jimg)).max())
    for x in (real, np.asarray(jimg)):
        jl = ref.Discriminator().apply({"params": jd}, jnp.asarray(x))
        tl = ex.Discriminator()(td, torch.from_numpy(np.array(x)))
        assert tl.shape == (B,)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=1e-5 * np.abs(_np(jl)).max())


def test_param_trees_are_flax_s():
    jg, jd = _jax_params()
    for net, jp in ((ex.Generator(nz=NZ), jg), (ex.Discriminator(), jd)):
        tp = net.init(0, "cpu")
        jl = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert [tuple(l.shape) for _, l in jl] == [
            tuple(t.shape) for t in tree_leaves(tp)]


def _jax_run(opt_level, data):
    """examples/dcgan/main_amp.py:69-120 with the given batches."""
    ref = _ref_module()
    netG, netD = ref.Generator(), ref.Discriminator()
    pG, pD = (jax.tree_util.tree_map(jnp.asarray, t) for t in _jax_params())
    pG, ampG = jamp.initialize(pG, opt_level=opt_level)
    pD, ampD = jamp.initialize(pD, opt_level=opt_level)
    optG = JAdam(pG, lr=2e-4, beta1=0.5, beta2=0.999)
    optD = JAdam(pD, lr=2e-4, beta1=0.5, beta2=0.999)
    half = jnp.bfloat16 if opt_level != "O0" else jnp.float32

    def d_loss(pd, pg, z, real):
        fake = netG.apply({"params": pg}, z.astype(half))
        dr = netD.apply({"params": pd}, real.astype(half))
        df = netD.apply({"params": pd}, fake)
        return (ref.bce_logits(dr.astype(jnp.float32), 1.0)
                + ref.bce_logits(df.astype(jnp.float32), 0.0))

    def g_loss(pg, pd, z):
        fake = netG.apply({"params": pg}, z.astype(half))
        df = netD.apply({"params": pd}, fake)
        return ref.bce_logits(df.astype(jnp.float32), 1.0)

    d_vg = jax.jit(lambda pd, pg, sc, z, x: jamp.scaled_value_and_grad(
        d_loss, sc, pd, pg, z, x))
    g_vg = jax.jit(lambda pg, pd, sc, z: jamp.scaled_value_and_grad(
        g_loss, sc, pg, pd, z))
    ld, lg = [], []
    for z, real in data:
        z, real = jnp.asarray(z), jnp.asarray(real)
        lossD, gD, infD = d_vg(optD.params, optG.params, ampD.scaler, z,
                               real)
        if int(infD) == 0:
            optD.step(gD)
        ampD = jamp.update_scaler(ampD, infD)
        lossG, gG, infG = g_vg(optG.params, optD.params, ampG.scaler, z)
        if int(infG) == 0:
            optG.step(gG)
        ampG = jamp.update_scaler(ampG, infG)
        ld.append(float(lossD))
        lg.append(float(lossG))
    return ld, lg, optG, optD, jamp.state_dict(ampD, ampG)


@pytest.mark.parametrize("opt_level", ["O0", "O1"])
def test_training_steps_follow_jax(opt_level):
    data = list(ex.synthetic_batches(B, NZ, STEPS, seed=7))
    jld, jlg, joptG, joptD, jsd = _jax_run(opt_level, data)
    res = ex.train(steps=STEPS, opt_level=opt_level, batch=B, nz=NZ,
                   device="cpu", variables=dcgan_from_jax(
                       *_jax_params(), "cpu"), data=data, log=None)
    np.testing.assert_allclose(res.losses_d, jld, rtol=1e-4)
    np.testing.assert_allclose(res.losses_g, jlg, rtol=1e-4)
    init = [np.asarray(x) for p in _jax_params()
            for x in jax.tree_util.tree_leaves(p)]
    got = [_np(t) for o in (res.opt_g, res.opt_d)
           for t in tree_leaves(o.params)]
    want = [_np(j) for o in (joptG, joptD)
            for j in jax.tree_util.tree_leaves(o.params)]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(want, init))
    assert np.sqrt(num / den) <= 0.1, np.sqrt(num / den)
    assert res.state_dict == jsd
    assert sorted(res.state_dict) == ["loss_scaler0", "loss_scaler1"]
    assert tamp.state_dict(res.amp_d, res.amp_g) == res.state_dict


def test_main_runs_two_scalers(capsys):
    res = ex.main(["--steps", "2", "--batch-size", "4", "--device", "cpu"])
    assert len(res.losses_d) == len(res.losses_g) == 2
    assert all(np.isfinite(res.losses_d + res.losses_g))
    out = capsys.readouterr().out
    assert "loss_scaler0" in out and "loss_scaler1" in out
