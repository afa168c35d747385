"""apex_tpu_torch.parallel (SyncBatchNorm at world size 1) against
apex_tpu.parallel.

The flax ``SyncBatchNorm`` and the port's run on the same numpy inputs,
params and running statistics, outside any mesh (the reference's data
axis unbound: local statistics) and without ``torch.distributed`` (or
with a one-process gloo group): train and eval, 2-D, NCHW and
channel_last, bf16 input (bf16 out), the running-stat update with the
unbiased variance, ``affine=False`` and ``track_running_stats=False``.
Then ``convert_syncbn_model``, ``resnet_from_jax`` on a SyncBN ResNet-18
and one O0 training step of it through the ImageNet example's trainer
against the reference's step.

Tolerances: f32 outputs within rtol 1e-5 / atol 1e-5 (the same formula,
each framework's sum order), running statistics within rtol 1e-5 / atol
1e-6, bf16 outputs within one bf16 rounding (2e-2).  The training step
takes ``test_torch_port_train.py``'s O0 tolerances: loss rtol 1e-5, the
params' displacement within 1e-4 of its norm, the running statistics
within 1e-5 (relative L2 norms).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import resnet18 as jresnet18
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu.parallel import SyncBatchNorm as JSync
from apex_tpu.parallel import sync_batch_norm_stats as jstats
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.convert import resnet_from_jax
from apex_tpu_torch.examples import imagenet_main_amp as main_amp
from apex_tpu_torch.models import resnet18
from apex_tpu_torch.parallel import (SyncBatchNorm, convert_syncbn_model,
                                     sync_batch_norm_stats)

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)

# name: (input shape, channel_last, dtype, module fields)
CASES = {
    "2d": ((64, 16), False, "float32", {}),
    "nchw": ((4, 6, 5, 7), False, "float32", {}),
    "channel_last": ((4, 5, 7, 6), True, "float32", {}),
    "nchw_bf16": ((4, 6, 5, 7), False, "bfloat16", {}),
    "no_affine": ((4, 6, 5, 7), False, "float32", dict(affine=False)),
    "no_running_stats": ((4, 6, 5, 7), False, "float32",
                         dict(track_running_stats=False)),
    "momentum_0.3_eps_1e-3": ((32, 8), False, "float32",
                              dict(momentum=0.3, eps=1e-3)),
}


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _inputs(shape, channel_last, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)
    c = shape[-1] if channel_last or len(shape) == 2 else shape[1]
    params = {"weight": (1 + 0.1 * rng.standard_normal(c)).astype(
        np.float32), "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    stats = {"running_mean": (0.2 * rng.standard_normal(c)).astype(
        np.float32), "running_var": (1 + rng.random(c)).astype(np.float32)}
    return x, params, stats


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sync_batchnorm_matches_flax(case, train):
    shape, channel_last, dtype, fields = CASES[case]
    x, params, stats = _inputs(shape, channel_last, dtype, seed=len(case))
    affine = fields.get("affine", True)
    if not affine:
        params = {}
    jm = JSync(channel_last=channel_last, process_group=None, **fields)
    jx = jnp.asarray(x).astype(dtype)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    if not affine:
        variables.pop("params")
    jy, upd = jm.apply(variables, jx, use_running_average=not train,
                       mutable=["batch_stats"])
    tm = SyncBatchNorm(channel_last=channel_last, **fields)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ty, new = tm(tx, {k: torch.from_numpy(v) for k, v in params.items()},
                 {k: torch.from_numpy(v) for k, v in stats.items()}, train)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert jy.dtype == jx.dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(_np(ty), _np(jy), **OUT_TOL)
    if not train:
        assert new is None
        return
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(_np(new[k]), _np(upd["batch_stats"][k]),
                                   **STAT_TOL)
    if not fields.get("track_running_stats", True):
        for k in stats:
            np.testing.assert_array_equal(_np(new[k]), stats[k])


def test_running_var_takes_the_unbiased_batch_variance():
    x, params, stats = _inputs((6, 3), False, "float32", seed=1)
    tm = SyncBatchNorm(momentum=1.0)
    _, new = tm(torch.from_numpy(x),
                {k: torch.from_numpy(v) for k, v in params.items()},
                {k: torch.from_numpy(v) for k, v in stats.items()}, True)
    np.testing.assert_allclose(_np(new["running_var"]), x.var(0, ddof=1),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(new["running_mean"]), x.mean(0),
                               rtol=1e-5, atol=1e-6)


def test_use_running_average_is_passed_once():
    x, params, stats = _inputs((6, 3), False, "float32", seed=2)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in stats.items()}
    y, new = SyncBatchNorm(use_running_average=True)(torch.from_numpy(x), p,
                                                     s)
    assert new is None
    with pytest.raises(ValueError, match="just once"):
        SyncBatchNorm(use_running_average=True)(torch.from_numpy(x), p, s,
                                                True)
    with pytest.raises(ValueError, match="must be passed"):
        SyncBatchNorm()(torch.from_numpy(x), p, s)


def test_gradients_flow_through_the_batch_statistics():
    """The statistics come from the differentiable plain Welford, as the
    reference's: the input gradient matches ``jax.grad``."""
    x, params, stats = _inputs((4, 6, 5, 7), False, "float32", seed=3)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jm = JSync(process_group=None)

    def jloss(xx):
        y, _ = jm.apply({"params": params, "batch_stats": stats}, xx,
                        use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * w)

    jg = jax.grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = SyncBatchNorm()(tx, {k: torch.from_numpy(v)
                                for k, v in params.items()},
                           {k: torch.from_numpy(v) for k, v in stats.items()},
                           True)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_stats_at_world_size_one_match_jax():
    x = (300.0 + 0.05 * np.random.default_rng(12).standard_normal(
        (4096, 4))).astype(np.float32)
    got = sync_batch_norm_stats(torch.from_numpy(x))
    want = jstats(jnp.asarray(x), None)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-5)
    assert float(got[2]) == float(want[2]) == 4096
    assert float(got[1].min()) > 1e-4


def test_a_one_process_group_is_local(tmp_path):
    """An initialized gloo group of one process gives the local stats."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (10, 4)).astype(np.float32))
    want = sync_batch_norm_stats(x)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1)
    try:
        got = sync_batch_norm_stats(x)
    finally:
        torch.distributed.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_larger_world_raises_naming_slice_9(monkeypatch):
    """World size 2 (``torch.distributed`` stubbed: the merge across
    processes is not ported) raises, in the module as in the stats."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    x = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="slice 9"):
        sync_batch_norm_stats(x)
    p, s = SyncBatchNorm().init(3, "cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        SyncBatchNorm()(x, p, s, True)
    y, new = SyncBatchNorm()(x, p, s, False)     # eval needs no sync
    assert new is None and y.shape == x.shape


def test_convert_syncbn_model():
    bn = torch.nn.BatchNorm2d(12, eps=1e-3, momentum=0.2)
    got = convert_syncbn_model(bn, channel_last=True)
    assert isinstance(got, SyncBatchNorm)
    assert (got.num_features, got.eps, got.momentum, got.affine,
            got.track_running_stats, got.channel_last,
            got.process_group) == (12, 1e-3, 0.2, True, True, True, None)
    assert sorted(dict(bn.named_parameters())) == sorted(got.init(12, "cpu")[0])
    assert {"running_mean", "running_var"} <= set(dict(bn.named_buffers()))

    class Model:
        def replace_norm(self, cls):
            return ("replaced", cls)

    assert convert_syncbn_model(Model()) == ("replaced", SyncBatchNorm)
    with pytest.raises(TypeError, match="BatchNorm"):
        convert_syncbn_model(torch.nn.Linear(2, 2))


KW = dict(num_classes=10, width=8)
B, S = 4, 32


def _jax_model():
    return jresnet18(norm_cls=functools.partial(JSync, channel_last=True),
                     **KW)


def test_resnet_from_jax_carries_a_syncbn_resnet():
    model = _jax_model()

    def init(key):
        return model.init(key, jnp.zeros((B, S, S, 3)), train=False)

    jv = jax.jit(init)(jax.random.key(0))
    jp, js = jax.tree_util.tree_map(np.asarray, (jv["params"],
                                                 jv["batch_stats"]))
    tp, ts = resnet_from_jax(jp, js, "cpu")
    want_p, want_s = resnet18(norm_cls=SyncBatchNorm, **KW).init(0, "cpu")
    assert tree_map(lambda t: tuple(t.shape), tp) == \
        tree_map(lambda t: tuple(t.shape), want_p)
    assert tree_map(lambda t: tuple(t.shape), ts) == \
        tree_map(lambda t: tuple(t.shape), want_s)
    assert sorted(tp["BasicBlock_0"]) == ["Conv_0", "Conv_1",
                                          "SyncBatchNorm_0", "SyncBatchNorm_1"]
    assert sorted(tp["SyncBatchNorm_0"]) == ["bias", "weight"]
    assert sorted(ts["SyncBatchNorm_0"]) == ["running_mean", "running_var"]
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_o0_syncbn_step_follows_jax():
    """One O0 step of a SyncBN ResNet-18 through the example's trainer
    (``--sync-bn``) against ``examples/imagenet/main_amp.py``'s step with
    ``norm_cls=SyncBatchNorm``, from the same numpy weights and batch."""
    tp, ts = resnet18(norm_cls=SyncBatchNorm, **KW).init(3, "cpu")
    rng = np.random.default_rng(6)
    data = [(rng.standard_normal((B, S, S, 3)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32))]
    hypers = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)
    res = main_amp.train(arch="resnet18", opt_level="O0", batch=B, image=S,
                         steps=1, device="cpu", log=None, sync_bn=True,
                         variables=(tp, ts), data=data, **KW, **hypers)

    model = _jax_model()
    params = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    stats = tree_map(lambda t: jnp.asarray(t.numpy()), ts)
    params, amp_state = jamp.initialize(params, opt_level="O0")
    opt = JSGD(params, master_weights=False, **hypers)

    def loss_fn(p, bs, x, y):
        out, upd = model.apply({"params": p, "batch_stats": bs}, x,
                               train=True, mutable=["batch_stats"])
        ll = -jnp.take_along_axis(jax.nn.log_softmax(out), y[:, None],
                                  axis=1)
        return jnp.mean(ll), upd["batch_stats"]

    wrapped = amp_state.wrap_forward(loss_fn, cast_argnums=(2,))

    def step(p, bs, x, y):
        return jamp.scaled_value_and_grad(wrapped, amp_state.scaler, p, bs,
                                          x, y, has_aux=True)

    jstep = jax.jit(step)
    (loss, new_bs), grads, found_inf = jstep(
        opt.params, stats, jnp.asarray(data[0][0]), jnp.asarray(data[0][1]))
    opt.step(grads, found_inf=found_inf)

    def rel(got, want, origin=None):
        got = [t.float().numpy() for t in tree_leaves(got)]
        want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
        origin = ([t.float().numpy() for t in tree_leaves(origin)]
                  if origin is not None else [0 * w for w in want])
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
        den = sum(float(((b - o) ** 2).sum()) for b, o in zip(want, origin))
        return np.sqrt(num / den)

    np.testing.assert_allclose(res.losses[0], float(loss), rtol=1e-5)
    assert rel(res.opt.params, opt.params, tp) <= 1e-4
    assert rel(res.batch_stats, new_bs) <= 1e-5
    assert rel(res.batch_stats, new_bs, ts) <= 1e-4
    assert sorted(res.batch_stats["SyncBatchNorm_0"]) == ["running_mean",
                                                          "running_var"]
