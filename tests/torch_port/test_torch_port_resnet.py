"""apex_tpu_torch.models.resnet against apex_tpu.models.resnet (flax).

A narrow ResNet (width 8, 32x32 inputs, batch 4, 10 classes) on the same
numpy weights — the port's init, handed to flax as numpy — and the same
numpy batch: the forward in train and eval mode, every parameter
gradient of the trainer's loss, and the BatchNorm running statistics.
Then the three traps of the port:

(a) under amp O2 the reference computes in f32 on bf16-rounded params
    (its layers are built with dtype=f32), and the gradient of a bf16
    param comes back bf16;
(b) flax's BatchNorm(momentum=0.9) keeps 0.9 of the OLD running value
    and takes the BIASED batch variance (torch's BatchNorm2d does
    neither);
(c) under grad-accum the trainer averages the N per-microbatch BN
    candidates, each folded from the same input statistics.

Tolerances: f32 throughout, but convolutions sum in another order in
each framework and BatchNorm over 4 images divides by small variances,
so for ResNet-18 logits within rtol 1e-4, atol 1e-4; f32 gradients
within atol 2e-4 relative to their leaf's largest entry of an f64
evaluation of the same function, and at least as close to it as
flax's (flax's own f32 gradients sit up to 3.6e-4 off it, so the two
sides are not held to each other at 2e-4; the port's CPU convolutions
sum in f64, see ``apex_tpu_torch._numerics.conv2d``); bf16 gradients
within 1e-2 of flax's (one bf16 rounding); running statistics within
rtol 1e-4, atol 1e-5.  ResNet-50's 16 bottlenecks carry BatchNorm over
populations of 4 (stage 4 is 1x1): flax takes the variance as E[x^2] - E[x]^2, the
port as the mean squared deviation, and that rounding, amplified by the
depth, moves the logits by up to ~5e-3 and single gradient entries by
several percent of their leaf's largest.  So for ResNet-50 the check is
against an f64 evaluation of the same function: the port's logits,
gradients and running statistics must each be at least as close to it
as flax's, the two logits must agree within atol 1e-2 and the two sets
of running statistics within atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import resnet18 as jresnet18
from apex_tpu.models import resnet50 as jresnet50
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.amp.scaler import value_and_grad
from apex_tpu_torch.convert import resnet_from_jax
from apex_tpu_torch.examples import imagenet_main_amp as main_amp
from apex_tpu_torch.models import resnet18, resnet50
from apex_tpu_torch.models.resnet import fold_stem_kernel, space_to_depth

ARCHS = {"resnet18": (resnet18, jresnet18), "resnet50": (resnet50,
                                                         jresnet50)}
KW = dict(num_classes=10, width=8)
B, S = 4, 32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, S, S, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _np_tree(tree):
    return tree_map(lambda t: t.float().numpy(), tree)


def _tloss(model):
    def loss(p, bs, x, y):
        logits, new = model.apply(p, bs, x, train=True)
        ll = -torch.gather(torch.log_softmax(logits.float(), -1), 1,
                           y.long()[:, None])
        return ll.mean(), (logits, new)
    return loss


def _jloss(model):
    def loss(p, bs, x, y):
        out, upd = model.apply({"params": p, "batch_stats": bs}, x,
                               train=True, mutable=["batch_stats"])
        logits = out.astype(jnp.float32)
        ll = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None],
                                  axis=1)
        return jnp.mean(ll), (logits, upd["batch_stats"])
    return loss


def _grad_close(t, j, rel=2e-4):
    for a, b in zip(tree_leaves(t), tree_leaves(j)):
        a = a.float().numpy()
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _f64(arch, tp, ts, x, y):
    """Logits, grads and running statistics of the port's train-mode
    forward in f64 (convs and BatchNorm, flax's update of the running
    averages): the exact values both f32 runs approximate."""
    def bn64(h, params, stats, train):
        h = h.double()
        out = torch.nn.functional.batch_norm(
            h, None, None, params["scale"].double(),
            params["bias"].double(), training=True, eps=1e-5)
        with torch.no_grad():
            var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
        return out, {"mean": 0.9 * stats["mean"] + 0.1 * mean,
                     "var": 0.9 * stats["var"] + 0.1 * var}

    model = ARCHS[arch][0](dtype=torch.float64, norm_cls=bn64, **KW)

    def loss(p, bs, xx, yy):
        logits, new = model.apply(p, bs, xx, train=True)
        ll = -torch.gather(torch.log_softmax(logits, -1), 1,
                           yy.long()[:, None])
        return ll.mean(), (logits, new)

    (_, (logits, new)), grads = value_and_grad(
        loss, tree_map(torch.Tensor.double, tp),
        tree_map(torch.Tensor.double, ts), torch.from_numpy(x).double(),
        torch.from_numpy(y), has_aux=True)
    return (logits.detach().numpy(), [g.numpy() for g in tree_leaves(grads)],
            [s.numpy() for s in tree_leaves(new)])


def _worst_rel(got, exact):
    """Largest error over the leaves, each relative to its largest entry."""
    return max(float(np.abs(np.asarray(a, np.float64) - e).max())
               / max(float(np.abs(e).max()), 1e-3)
               for a, e in zip(got, exact))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("s2d", [False, True])
def test_param_tree_is_the_flax_tree(arch, s2d):
    tm, jm = (f(stem_space_to_depth=s2d, **KW) for f in ARCHS[arch])
    tp, ts = tm.init(0, "cpu")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, S, S, 3)), train=False))
    assert tree_map(lambda t: tuple(t.shape), tp) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes["params"])
    assert tree_map(lambda t: tuple(t.shape), ts) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape),
                               shapes["batch_stats"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_grads_and_bn_stats_match_flax(arch):
    tm, jm = (f(**KW) for f in ARCHS[arch])
    tp, ts = tm.init(1, "cpu")
    jp, js = (tree_map(jnp.asarray, _np_tree(t)) for t in (tp, ts))
    x, y = _batch()
    (tl, (tlogits, tnew)), tg = value_and_grad(
        _tloss(tm), tp, ts, torch.from_numpy(x), torch.from_numpy(y),
        has_aux=True)
    (jl, (jlogits, jnew)), jg = jax.jit(jax.value_and_grad(
        _jloss(jm), has_aux=True))(jp, js, jnp.asarray(x), jnp.asarray(y))
    tlogits, jlogits = tlogits.detach().numpy(), np.asarray(jlogits)
    tstats = [a.numpy() for a in tree_leaves(tnew)]
    jstats = [np.asarray(b) for b in jax.tree_util.tree_leaves(jnew)]
    if arch == "resnet18":
        np.testing.assert_allclose(tlogits, jlogits, **LOGIT_TOL)
        np.testing.assert_allclose(float(tl), float(jl), **LOGIT_TOL)
        exact_g = _f64(arch, tp, ts, x, y)[1]
        tgl = [g.numpy() for g in tree_leaves(tg)]
        jgl = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
        assert _worst_rel(tgl, exact_g) <= 2e-4
        assert _worst_rel(tgl, exact_g) <= _worst_rel(jgl, exact_g)
        for a, b in zip(tstats, jstats):
            np.testing.assert_allclose(a, b, **STAT_TOL)
    else:
        exact, exact_g, exact_s = _f64(arch, tp, ts, x, y)
        assert np.abs(tlogits - exact).max() <= np.abs(jlogits - exact).max()
        np.testing.assert_allclose(tlogits, jlogits, rtol=0, atol=1e-2)
        tgl = [g.numpy() for g in tree_leaves(tg)]
        jgl = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
        assert _worst_rel(tgl, exact_g) <= _worst_rel(jgl, exact_g)
        assert _worst_rel(tstats, exact_s) <= _worst_rel(jstats, exact_s)
        for a, b in zip(tstats, jstats):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    # eval mode normalises with the running statistics just produced
    tev = tm.apply(tp, tnew, torch.from_numpy(x), train=False)
    jev = jm.apply({"params": jp, "batch_stats": jnew}, jnp.asarray(x),
                   train=False)
    np.testing.assert_allclose(tev.detach().numpy(), np.asarray(jev),
                               **LOGIT_TOL)


def test_o2_computes_in_f32_on_bf16_params():
    """Trap (a): with bf16 params and a bf16 input the port's logits are
    those of f32 params holding the same rounded values (the compute is
    f32), each grad is bf16 and is the f32 grad rounded; and flax's O2
    model agrees."""
    tm, jm = resnet18(**KW), jresnet18(**KW)
    tp, ts = tm.init(2, "cpu")
    p16, st = tamp.initialize(tp, opt_level="O2")
    p32 = tree_map(lambda t: t.float(), p16)
    x, y = _batch(1)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    (l16, (lg16, _)), g16 = value_and_grad(_tloss(tm), p16, ts, x16,
                                           torch.from_numpy(y), has_aux=True)
    (l32, (lg32, _)), g32 = value_and_grad(_tloss(tm), p32, ts, x16.float(),
                                           torch.from_numpy(y), has_aux=True)
    assert lg16.dtype == torch.float32
    assert torch.equal(lg16, lg32)
    for a, b in zip(tree_leaves(g16), tree_leaves(g32)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
    jp16 = tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16), p16)
    js = tree_map(lambda t: jnp.asarray(t.numpy()), ts)
    (jl, (jlg, _)), jg = jax.jit(jax.value_and_grad(
        _jloss(jm), has_aux=True))(jp16, js, jnp.asarray(x).astype(
            jnp.bfloat16), jnp.asarray(y))
    assert jlg.dtype == jnp.float32
    np.testing.assert_allclose(lg16.detach().numpy(), np.asarray(jlg),
                               **LOGIT_TOL)
    for a, b in zip(tree_leaves(g16), jax.tree_util.tree_leaves(jg)):
        assert b.dtype == jnp.bfloat16
    _grad_close(g16, jg, rel=1e-2)


def test_bn_running_stats_are_flax_not_torch():
    """Trap (b): 0.9 of the old value, the biased batch variance."""
    tm = resnet18(**KW)
    tp, ts = tm.init(3, "cpu")
    x, _ = _batch(2)
    _, new = tm.apply(tp, ts, torch.from_numpy(x), train=True)
    # the stem's BN sees the stem conv's output: recompute its stats
    h = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        tp["Conv_0"]["kernel"].permute(3, 2, 0, 1), stride=2, padding=3)
    var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(new["BatchNorm_0"]["mean"], 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new["BatchNorm_0"]["var"], 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)


def test_grad_accum_averages_the_microbatch_bn_candidates():
    """Trap (c): after one grad-accum step the trainer's stats are the
    mean of the two candidates flax folds from the same input stats, one
    per half batch — not the fold of the last half."""
    tm, jm = resnet18(**KW), jresnet18(**KW)
    tp, ts = tm.init(4, "cpu")
    x, y = _batch(3, n=8)
    res = main_amp.train(arch="resnet18", opt_level="O0", batch=8, image=S,
                         steps=1, grad_accum=2, device="cpu", log=None,
                         variables=(tp, ts), data=[(x, y)], **KW)
    jp, js = (tree_map(jnp.asarray, _np_tree(t)) for t in (tp, ts))
    fold = jax.jit(lambda xx: jm.apply(
        {"params": jp, "batch_stats": js}, xx, train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    a, b = fold(jnp.asarray(x[:4])), fold(jnp.asarray(x[4:]))
    want = jax.tree_util.tree_map(lambda u, v: (u + v) / 2, a, b)
    for t, w, last in zip(tree_leaves(res.batch_stats),
                          jax.tree_util.tree_leaves(want),
                          jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **STAT_TOL)
    assert any(not np.allclose(t.numpy(), np.asarray(last), **STAT_TOL)
               for t, last in zip(tree_leaves(res.batch_stats),
                                  jax.tree_util.tree_leaves(b)))


def test_space_to_depth_stem_is_the_same_function():
    tm = resnet18(stem_space_to_depth=True, **KW)
    jm = jresnet18(stem_space_to_depth=True, **KW)
    tp, ts = tm.init(5, "cpu")
    x, _ = _batch(4)
    xt = torch.from_numpy(x)
    w7 = tp["stem_conv"]
    direct = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2),
                                        w7.permute(3, 2, 0, 1), stride=2,
                                        padding=3)
    folded = torch.nn.functional.conv2d(
        torch.nn.functional.pad(space_to_depth(xt).permute(0, 3, 1, 2),
                                (2, 1, 2, 1)),
        fold_stem_kernel(w7).permute(3, 2, 0, 1))
    torch.testing.assert_close(folded, direct, rtol=1e-5, atol=1e-5)
    jp, js = (tree_map(jnp.asarray, _np_tree(t)) for t in (tp, ts))
    tev = tm.apply(tp, ts, xt, train=False)
    jev = jm.apply({"params": jp, "batch_stats": js}, jnp.asarray(x),
                   train=False)
    np.testing.assert_allclose(tev.detach().numpy(), np.asarray(jev),
                               **LOGIT_TOL)
    with pytest.raises(ValueError, match="multiples"):
        space_to_depth(torch.zeros(1, 5, 5, 3))


def test_resnet_from_jax_keeps_names_layouts_and_dtypes():
    jm = jresnet18(**KW)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, S, S, 3)), train=False))()
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                 v["params"])
    tp, ts = resnet_from_jax(jax.device_get(p16),
                             jax.device_get(v["batch_stats"]), device="cpu")
    assert tree_map(lambda t: tuple(t.shape), tp) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), p16)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts))
    np.testing.assert_array_equal(
        tp["Conv_0"]["kernel"].float().numpy(),
        np.asarray(p16["Conv_0"]["kernel"].astype(jnp.float32)))
