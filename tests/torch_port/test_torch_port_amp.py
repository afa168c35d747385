"""apex_tpu_torch.amp against apex_tpu.amp.

The same numpy inputs go through both packages: the scaler's update over
a scripted sequence of overflow flags, ``initialize`` at O0/O2/O3, the
per-leaf ``scaled_value_and_grad`` (one batch and ``microbatches=2``)
and the flat pipeline (``FlatGradPipeline``: pack, fused unscale + norm
+ clip, flat accumulation) on a small two-layer model written once in
each framework.

Tolerances: the scaler's state and the overflow flags agree exactly;
gradients and losses in f32 within rtol 1e-5, atol 1e-6 (each framework
sums the small matmuls in its own order); bf16 gradients within one
bf16 rounding (rtol 1e-2) — a last-bit difference in the f32 value can
round either way; the norm within rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.amp import scaler as jscaler
from apex_tpu.amp.flat_pipeline import FlatGradPipeline as JPipe
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.amp import scaler as tscaler
from apex_tpu_torch.amp.flat_pipeline import FlatGradPipeline as TPipe

F32 = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the scaler
# ---------------------------------------------------------------------------

FLAGS = [0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("init", [2.0, 2.0 ** 16, 2.0 ** 24])
def test_scaler_growth_backoff_and_skip_follow_jax(init):
    """Growth every 3 clean steps, backoff on each overflow, clamped to
    [1, 2**24]; an externally skipped step (index 5) holds both."""
    jcfg = jscaler.LossScaleConfig(init_scale=init, growth_interval=3)
    tcfg = tscaler.LossScaleConfig(init_scale=init, growth_interval=3)
    js = jscaler.LossScaleState.create(init)
    ts = tscaler.LossScaleState.create(init, device="cpu")
    for i, f in enumerate(FLAGS):
        skipped = 1 if i == 5 else None
        js = jscaler.update_state(js, jnp.int32(f), jcfg, skipped=skipped)
        ts = tscaler.update_state(ts, torch.tensor(f, dtype=torch.int32),
                                  tcfg, skipped=skipped)
        assert float(ts.loss_scale) == float(js.loss_scale), i
        assert int(ts.growth_tracker) == int(js.growth_tracker), i
        assert int(ts.found_inf) == int(js.found_inf) == f
        assert ts.loss_scale.dtype == torch.float32
        assert ts.growth_tracker.dtype == torch.int32


def test_static_scaler_only_records_the_flag():
    cfg = tscaler.LossScaleConfig(init_scale=1.0, dynamic=False)
    ts = tscaler.LossScaleState.create(1.0, device="cpu")
    ts = tscaler.update_state(ts, torch.tensor(1), cfg)
    assert float(ts.loss_scale) == 1.0 and int(ts.found_inf) == 1


def test_scaler_defaults_match():
    assert dataclasses.asdict(tscaler.LossScaleConfig()) == \
        dataclasses.asdict(jscaler.LossScaleConfig())


# ---------------------------------------------------------------------------
# initialize
# ---------------------------------------------------------------------------

def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((8, 16)).astype(np.float32),
            "b1": rng.standard_normal(16).astype(np.float32),
            "bn": {"scale": (1 + 0.01 * rng.standard_normal(16)).astype(
                np.float32)},
            "w2": rng.standard_normal((16, 4)).astype(np.float32)}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _j(tree):
    return tree_map(jnp.asarray, tree)


def _tnp(x):
    return x.float().numpy()


def _jnp(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("opt_level", ["O0", "O2", "O3"])
def test_initialize_casts_and_masters_follow_jax(opt_level):
    p = _np_params()
    tp, ts = tamp.initialize(_t(p), opt_level=opt_level)
    jp, js = jamp.initialize(_j(p), opt_level=opt_level)
    for t, j in zip(tree_leaves(tp), tree_leaves(jp)):
        assert str(t.dtype).split(".")[1] == jnp.dtype(j.dtype).name
        np.testing.assert_array_equal(_tnp(t), _jnp(j))
    assert (ts.master_params is None) == (js.master_params is None)
    if opt_level == "O2":
        # every float param is cast (BatchNorm's scale too) and the
        # masters are the ORIGINAL f32 values, not the rounded params
        for t, m, orig in zip(tree_leaves(tp), tree_leaves(ts.master_params),
                              tree_leaves(_t(p))):
            assert t.dtype == torch.bfloat16 and m.dtype == torch.float32
            assert torch.equal(m, orig)
            assert not torch.equal(m, t.float())
    for f in ("opt_level", "master_weights", "loss_scale",
              "keep_batchnorm_fp32", "patch_torch_functions"):
        assert getattr(ts.properties, f) == getattr(js.properties, f), f
    assert float(ts.scaler.loss_scale) == float(js.scaler.loss_scale)
    assert ts.scaler_config.dynamic == js.scaler_config.dynamic


def test_initialize_overrides_and_what_waits():
    p = _np_params()
    _, ts = tamp.initialize(_t(p), opt_level="O2", loss_scale="dynamic")
    _, js = jamp.initialize(_j(p), opt_level="O2", loss_scale="dynamic")
    assert float(ts.scaler.loss_scale) == float(js.scaler.loss_scale) \
        == 2.0 ** 16
    assert ts.scaler_config.dynamic and js.scaler_config.dynamic
    # O1 leaves the params in f32 and resolves the reference's table
    t1, ts1 = tamp.initialize(_t(p), opt_level="O1")
    _, js1 = jamp.initialize(_j(p), opt_level="O1")
    assert all(t.dtype == torch.float32 for t in tree_leaves(t1))
    assert ts1.master_params is None and js1.master_params is None
    assert ts1.properties.patch_torch_functions \
        and js1.properties.patch_torch_functions
    assert float(ts1.scaler.loss_scale) == float(js1.scaler.loss_scale)
    with pytest.raises(NotImplementedError, match="fp8"):
        tamp.initialize(_t(p), opt_level="O2", fp8=True)
    sd = ts.state_dict()
    assert sd == js.state_dict()
    assert float(ts.load_state_dict(
        {"loss_scaler0": {"loss_scale": 8.0, "unskipped": 3}})
        .scaler.loss_scale) == 8.0


def test_wrap_forward_casts_only_the_data_args():
    _, ts = tamp.initialize(_t(_np_params()), opt_level="O2")
    seen = {}

    def fn(p, x, y):
        seen.update(p=p.dtype, x=x.dtype, y=y.dtype)

    ts.wrap_forward(fn, cast_argnums=(1,))(torch.zeros(2), torch.zeros(2),
                                           torch.zeros(2))
    assert seen == dict(p=torch.float32, x=torch.bfloat16, y=torch.float32)


# ---------------------------------------------------------------------------
# scaled value-and-grad (per-leaf) and the flat pipeline
# ---------------------------------------------------------------------------

def _tloss(p, x, y):
    h = torch.tanh(x @ p["w1"].float() + p["b1"].float()) * \
        p["bn"]["scale"].float()
    return torch.mean((h @ p["w2"].float() - y) ** 2)


def _jloss(p, x, y):
    f32 = jnp.float32
    h = jnp.tanh(x @ p["w1"].astype(f32) + p["b1"].astype(f32)) * \
        p["bn"]["scale"].astype(f32)
    return jnp.mean((h @ p["w2"].astype(f32) - y) ** 2)


def _batch(seed=1, n=8, poison=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = rng.standard_normal((n, 4)).astype(np.float32)
    if poison:
        x[n - 1, 0] = np.inf          # the second microbatch only
    return x, y


def _close_tree(t, j, bf16):
    for a, b in zip(tree_leaves(t), tree_leaves(j)):
        if bf16:
            np.testing.assert_allclose(_tnp(a), _jnp(b), rtol=1e-2,
                                       atol=1e-2)
        else:
            np.testing.assert_allclose(_tnp(a), _jnp(b), **F32)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("micro", [1, 2])
def test_tree_scaled_value_and_grad_follows_jax(opt_level, micro):
    p = _np_params()
    tp, ts = tamp.initialize(_t(p), opt_level=opt_level,
                             loss_scale="dynamic")
    jp, js = jamp.initialize(_j(p), opt_level=opt_level,
                             loss_scale="dynamic")
    x, y = _batch()
    tl, tg, tf = tamp.scaled_value_and_grad(
        _tloss, ts.scaler, tp, torch.from_numpy(x), torch.from_numpy(y),
        microbatches=micro)
    jl, jg, jf = jamp.scaled_value_and_grad(
        _jloss, js.scaler, jp, jnp.asarray(x), jnp.asarray(y),
        microbatches=micro)
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    assert int(tf) == int(jf) == 0
    for a, b in zip(tree_leaves(tg), tree_leaves(jg)):
        assert str(a.dtype).split(".")[1] == jnp.dtype(b.dtype).name
    _close_tree(tg, jg, opt_level == "O2")


def test_tree_overflow_is_flagged_and_latched_across_microbatches():
    tp = _t(_np_params())
    ts = tscaler.LossScaleState.create(2.0 ** 16, device="cpu")
    x, y = _batch(poison=True)
    for micro in (1, 2):
        _, _, f = tamp.scaled_value_and_grad(
            _tloss, ts, tp, torch.from_numpy(x), torch.from_numpy(y),
            microbatches=micro)
        assert int(f) == 1


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("max_norm", [0.0, 0.5])
def test_flat_pipeline_follows_jax(opt_level, micro, max_norm):
    p = _np_params()
    tp, ts = tamp.initialize(_t(p), opt_level=opt_level,
                             loss_scale="dynamic")
    jp, js = jamp.initialize(_j(p), opt_level=opt_level,
                             loss_scale="dynamic")
    x, y = _batch()
    tpipe = TPipe(params=tp, max_grad_norm=max_norm)
    jpipe = JPipe(params=jp, max_grad_norm=max_norm)
    tl, tflat = tpipe.scaled_value_and_grad(
        _tloss, ts, tp, torch.from_numpy(x), torch.from_numpy(y),
        microbatches=micro)
    jl, jflat = jpipe.scaled_value_and_grad(
        _jloss, js, jp, jnp.asarray(x), jnp.asarray(y), microbatches=micro)
    assert tpipe.plan.layout() == jpipe.plan.layout()
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    for a, b in zip(tflat.bufs, jflat.bufs):
        assert str(a.dtype).split(".")[1] == jnp.dtype(b.dtype).name
        tol = dict(rtol=1e-2, atol=1e-2) if a.dtype == torch.bfloat16 \
            else F32
        np.testing.assert_allclose(_tnp(a), _jnp(b), **tol)
    np.testing.assert_allclose(float(tflat.grad_norm),
                               float(jflat.grad_norm), rtol=1e-5)
    np.testing.assert_allclose(float(tflat.clip_coef),
                               float(jflat.clip_coef), rtol=1e-5)
    assert int(tflat.found_inf) == int(jflat.found_inf) == 0
    # the flat buffers are the per-leaf oracle's grads, packed
    _, tg, _ = tamp.scaled_value_and_grad(
        _tloss, ts.scaler, tp, torch.from_numpy(x), torch.from_numpy(y),
        microbatches=micro)
    for a, b in zip(tree_leaves(tpipe.grads_tree(tflat)), tree_leaves(tg)):
        tol = dict(rtol=1e-2, atol=1e-2) if b.dtype == torch.bfloat16 \
            else F32
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_flat_accumulation_latches_and_pins_clip_to_one():
    tp = _t(_np_params())
    jp = _j(_np_params())
    ts = tscaler.LossScaleState.create(2.0 ** 16, device="cpu")
    js = jscaler.LossScaleState.create(2.0 ** 16)
    x, y = _batch(poison=True)
    tpipe = TPipe(params=tp, max_grad_norm=1.0)
    jpipe = JPipe(params=jp, max_grad_norm=1.0)
    _, tflat = tpipe.scaled_value_and_grad(
        _tloss, ts, tp, torch.from_numpy(x), torch.from_numpy(y),
        microbatches=2)
    _, jflat = jpipe.scaled_value_and_grad(
        _jloss, js, jp, jnp.asarray(x), jnp.asarray(y), microbatches=2)
    assert int(tflat.found_inf) == int(jflat.found_inf) == 1
    assert float(tflat.clip_coef) == float(jflat.clip_coef) == 1.0


def test_accumulate_finalize_reset_by_hand():
    """init_accum / accumulate / finalize / reset_accum, driven one
    microbatch at a time, against the JAX pipeline's same calls."""
    tp, jp = _t(_np_params()), _j(_np_params())
    tpipe, jpipe = TPipe(params=tp), JPipe(params=jp)
    tacc, jacc = tpipe.init_accum(), jpipe.init_accum()
    for seed in (3, 4, 5):
        x, y = _batch(seed)
        tg = tamp.value_and_grad(_tloss, tp, torch.from_numpy(x),
                                 torch.from_numpy(y))[1]
        jg = jax.grad(_jloss)(jp, jnp.asarray(x), jnp.asarray(y))
        tacc = tpipe.accumulate(tacc, tg)
        jacc = jpipe.accumulate(jacc, jg)
    assert tacc.count == int(jacc.count) == 3
    tflat = tpipe.finalize(tacc, inv_scale=0.5)
    jflat = jpipe.finalize(jacc, inv_scale=0.5)
    for a, b in zip(tflat.bufs, jflat.bufs):
        np.testing.assert_allclose(_tnp(a), _jnp(b), **F32)
    tacc = tpipe.reset_accum(tacc)
    assert tacc.count == 0 and all(int(b.abs().sum()) == 0
                                   for b in tacc.bufs)


def test_flat_pipeline_parts_that_wait_say_so():
    tp = _t(_np_params())
    for kw in (dict(axis_name="data"), dict(interleave=True),
               dict(reduce_decompose="reduce_scatter")):
        with pytest.raises(NotImplementedError, match="T2"):
            TPipe(params=tp, **kw)
    with pytest.raises(NotImplementedError, match="T5"):
        TPipe(params=tp, fp8=True)
    with pytest.raises(NotImplementedError, match="T6"):
        TPipe(params=tp, max_bucket_bytes="auto")
    with pytest.raises(ValueError, match="need one of"):
        TPipe()
