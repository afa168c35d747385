"""apex_tpu_torch's BucketPlan and FusedSGD against apex_tpu's.

Trees are the port's ResNet-18 (width 8, 10 classes) parameters, handed
to both packages as the same numpy values (the flax model's names and
layouts; tests/torch_port/test_torch_port_resnet.py pins that the
shapes are flax's).  Gradients are numpy draws from a seed.

Tolerances: the port's bucketed and per-leaf steps agree to the bit (as
tests/test_bucketed_optimizers.py pins for the reference).  Against the
JAX FusedSGD — whose step XLA compiles, free to contract a product and
a sum into an FMA — within f32 rounding over 3 steps: rtol 1e-6,
atol 1e-7 on masters, momentum and f32 params.  Under O2 the port's
bf16 params must be exactly the bf16 cast of its masters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.multi_tensor_apply.packer import BucketPlan as JPlan
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_flatten, tree_leaves, tree_map
from apex_tpu_torch.amp.flat_pipeline import FlatGrads
from apex_tpu_torch.models import resnet18
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan, cached_plan
from apex_tpu_torch.optimizers import FusedSGD

TOL = dict(rtol=1e-6, atol=1e-7)
HYPERS = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def _params():
    p, _ = resnet18(num_classes=10, width=8).init(0, "cpu")
    return p


def _to_jax(tree):
    return tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: torch.from_numpy(rng.standard_normal(
        tuple(p.shape)).astype(np.float32)).to(p.dtype), params)


def _np(tree):
    """f32 numpy leaves of a torch or a JAX tree, in flatten order (the
    port's tree order is JAX's)."""
    return [l.float().numpy() if isinstance(l, torch.Tensor)
            else np.asarray(l.astype(jnp.float32)) for l in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_level", ["O0", "O2", "O3"])
@pytest.mark.parametrize("cap", [None, 40_000])
def test_plan_layout_equals_jax_for_resnet18(opt_level, cap):
    """Field for field: leaf paths (JAX flatten order — sorted keys, so
    BasicBlock_0..7 then BatchNorm_0, Conv_0, Dense_0), dtypes, sizes,
    per-leaf index/shape/offset, with and without the bytes cap."""
    tp, tst = tamp.initialize(_params(), opt_level=opt_level)
    jp, jst = jamp.initialize(_to_jax(_params()), opt_level=opt_level)
    twork = tst.master_params if tst.master_params is not None else tp
    jwork = jst.master_params if jst.master_params is not None else jp
    tplan = BucketPlan.from_tree(
        twork, tp if tst.master_params is not None else None, cap)
    jplan = JPlan.from_tree(
        jwork, jp if jst.master_params is not None else None, cap)
    assert tplan.layout() == jplan.layout()
    assert tplan.describe() == jplan.describe()
    assert len(tplan.buckets) == (1 if cap is None else len(jplan.buckets))


def test_plan_pack_unpack_round_trip_and_views():
    p = _params()
    plan = cached_plan(p)
    assert cached_plan(p) is plan
    bufs = plan.pack(p)
    assert plan.is_packed(bufs) and not plan.is_packed(bufs[:0])
    back = plan.unpack(bufs)
    for a, b in zip(tree_leaves(p), tree_leaves(back)):
        assert torch.equal(a, b)
        assert b.data_ptr() >= bufs[0].data_ptr()      # a view, no copy
    st = plan.pack_state_field(tree_map(torch.zeros_like, p))
    assert [b.numel() for b in st] == [b.size for b in plan.buckets]
    assert tree_flatten(plan.unpack_state_field(st))[1] == plan.treedef


# ---------------------------------------------------------------------------
# FusedSGD
# ---------------------------------------------------------------------------

def _run(opt, grads_seq, flags):
    for g, f in zip(grads_seq, flags):
        opt.step(g, found_inf=None if f is None
                 else torch.tensor(f, dtype=torch.int32))
    return opt


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_bucketed_matches_per_leaf_bit_exact(opt_level, nesterov):
    params, st = tamp.initialize(_params(), opt_level=opt_level)
    grads = [_grads(params, s) for s in range(3)]
    kw = dict(HYPERS, nesterov=nesterov, masters=st.master_params)
    a = _run(FusedSGD(params, **kw), grads, [0, 1, 0])
    b = _run(FusedSGD(params, fuse_buckets=False, **kw), grads, [0, 1, 0])
    assert a.fuse_buckets and not b.fuse_buckets
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if opt_level == "O2":
        for x, y in zip(tree_leaves(a.masters), tree_leaves(b.masters)):
            assert torch.equal(x, y)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] == 2           # the skip held the clock
    for x, y in zip(tree_leaves(sa["state"]), tree_leaves(sb["state"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_port_matches_jax_fused_sgd_with_an_overflow_skip(opt_level):
    """3 steps, the second one flagged: both skip it, hold the step clock
    (so step 3 is the second real step: first_run only on step 1)."""
    tparams, tst = tamp.initialize(_params(), opt_level=opt_level)
    jparams, jst = jamp.initialize(_to_jax(_params()), opt_level=opt_level)
    topt = FusedSGD(tparams, masters=tst.master_params, **HYPERS)
    jopt = JSGD(jparams, masters=jst.master_params,
                master_weights=bool(jst.properties.master_weights), **HYPERS)
    for i, flag in enumerate([0, 1, 0]):
        g = _grads(tparams, 10 + i)
        topt.step(g, found_inf=torch.tensor(flag, dtype=torch.int32))
        jopt.step(_to_jax(g), found_inf=jnp.int32(flag))
    assert int(topt.step_count) == int(jopt.step_count) == 2
    if opt_level == "O2":
        for t, j in zip(_np(topt.masters), _np(jopt.masters)):
            np.testing.assert_allclose(t, j, **TOL)
        # model params are the masters' bf16 cast on both sides
        for t, m in zip(tree_leaves(topt.params), tree_leaves(topt.masters)):
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, m.to(torch.bfloat16))
    else:
        for t, j in zip(_np(topt.params), _np(jopt.params)):
            np.testing.assert_allclose(t, j, **TOL)
    tsd, jsd = topt.state_dict(), jopt.state_dict()
    for t, j in zip(_np(tsd["state"]), _np(jsd["state"])):
        np.testing.assert_allclose(t, j, **TOL)


def test_state_dict_interloads_between_layouts():
    params = _params()
    a = FusedSGD(params, **HYPERS)
    _run(a, [_grads(params, 1), _grads(params, 2)], [0, 0])
    b = FusedSGD(params, fuse_buckets=False, **HYPERS)
    b.load_state_dict(a.state_dict())
    b.params = tree_map(torch.clone, a.params)
    g = _grads(params, 3)
    a.step(g)
    b.step(g)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    c = FusedSGD(params, **HYPERS)
    c.load_state_dict(b.state_dict())
    assert int(c.step_count) == 3


def test_params_are_views_the_step_updates_in_place():
    params, st = tamp.initialize(_params(), opt_level="O2")
    opt = FusedSGD(params, masters=st.master_params, **HYPERS)
    views = opt.params
    before = [t.clone() for t in tree_leaves(views)]
    opt.step(_grads(params, 4))
    assert opt.params is views
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(views)))


def test_flat_grads_bundle_feeds_the_step():
    params = _params()
    opt = FusedSGD(params, **HYPERS)
    ref = FusedSGD(params, **HYPERS)
    g = _grads(params, 5)
    bufs = opt._plan.pack_grads(g)
    one = torch.ones(())
    opt.step(FlatGrads(bufs=bufs, grad_norm=one,
                       found_inf=torch.zeros((), dtype=torch.int32),
                       clip_coef=torch.tensor(0.5)))
    ref.step(g, grad_scale=2.0)           # clip 0.5 == grad_scale 2
    for x, y in zip(tree_leaves(opt.params), tree_leaves(ref.params)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    per_leaf = FusedSGD(params, fuse_buckets=False, **HYPERS)
    with pytest.raises(ValueError, match="bucketed"):
        per_leaf.step(FlatGrads(bufs, one, one, one))


@pytest.mark.parametrize("case", ["fuse_buckets=False", "non-float leaf"])
def test_per_leaf_step_refuses_a_device_other_than_the_cpu(case):
    """The per-leaf step is the plain oracle: off the CPU (here the meta
    device stands in for the card) an optimizer with no bucket plan
    raises instead of running plain PyTorch there."""
    params = tree_map(lambda t: t.to("meta"), _params())
    kw = dict(HYPERS)
    if case == "fuse_buckets=False":
        kw["fuse_buckets"] = False
    else:
        params["step"] = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs only on the CPU"):
        FusedSGD(params, **kw)


@pytest.mark.parametrize("option", ["wd_after_momentum",
                                    "materialize_master_grads",
                                    "set_grad_none"])
def test_options_the_port_does_not_read_are_rejected(option):
    with pytest.raises(TypeError, match=option):
        FusedSGD(_params(), **{option: True}, **HYPERS)


def test_what_waits_for_later_slices_says_so():
    params = _params()
    with pytest.raises(NotImplementedError, match="T4"):
        FusedSGD(params, **HYPERS).enable_fp8()
    with pytest.raises(NotImplementedError, match="T4"):
        FusedSGD(params, **HYPERS).rechunk(1 << 20)
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(params, lr=0.1, nesterov=True)
