"""apex_tpu_torch's flat_l2norm, flat_lamb, segment metadata and FusedLAMB
against apex_tpu's.

The trees are a narrow BERT's parameters (2 layers, hidden 128, vocab
96) from the port's init, handed to both packages as the same numpy
values; gradients and buffers are numpy draws from a seed.

Tolerances.  One flat_lamb step is elementwise f32 in the reference's
order on both sides, but the per-tensor norms and the bias corrections
(``b ** step``) are summed or evaluated in each framework's own order:
rtol 1e-5, atol 1e-6 on p, m and v.  flat_l2norm: rtol 1e-6.  Three
FusedLAMB steps at O0: rtol 1e-5, atol 1e-6 on the params and moments;
at O2 the same on the f32 masters and moments, with the bf16 params
exactly the cast of the masters.  The port's bucketed and per-leaf
steps sum the global norm in different orders (one buffer against leaf
by leaf): rtol 2e-5, atol 2e-6, the reference's own bound
(tests/test_bucketed_optimizers.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.multi_tensor_apply.packer import BucketPlan as JPlan
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import FusedLAMB as JLAMB
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.models import BertModel
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan
from apex_tpu_torch.ops import multi_tensor as tmt
from apex_tpu_torch.optimizers import FusedLAMB, FusedMixedPrecisionLamb

TOL = dict(rtol=1e-5, atol=1e-6)
HYPERS = dict(lr=1e-2, weight_decay=0.01)


def _params():
    model = BertModel(vocab_size=96, hidden_size=128, num_heads=4,
                      num_layers=2, max_seq_len=32)
    return model.init(0, "cpu")


def _to_jax(tree):
    return tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def _grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: torch.from_numpy(
        (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
    ).to(p.dtype), params)


def _np(tree):
    return [l.float().numpy() if isinstance(l, torch.Tensor)
            else np.asarray(l.astype(jnp.float32)) for l in tree_leaves(tree)]


def _close(got, want, **tol):
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_allclose(a, b, **(tol or TOL))


# ---------------------------------------------------------------------------
# the flat functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_flat_l2norm_matches_jax(n, dtype):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tmt.flat_l2norm(tx)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(jmt.flat_l2norm(jx)),
                               rtol=1e-6)
    assert torch.equal(got, tmt.flat_l2norm_ref(tx))


def _bucket(seed, sizes, gdt="float32"):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    g[:sizes[0]] *= 0.0                  # a zero-gradient tensor
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = np.abs(rng.standard_normal(n) * 1e-4).astype(np.float32)
    if gdt == "bfloat16":
        g = np.array(jnp.asarray(g).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    return p, g, m, v


LAMB_CASES = {
    # name: (use_nvlamb, bias_correction, clip, grad_scale, step, wd, g)
    "default": (False, True, 1.0, 1.0, 1, 0.01, "float32"),
    "nvlamb_clip_scaled": (True, True, 0.25, 1024.0, 3, 0.01, "bfloat16"),
    "no_bias_correction": (False, False, 1.0, 1.0, 5, 0.01, "float32"),
    "no_decay": (False, True, 0.5, 1.0, 2, 0.0, "bfloat16"),
    "nvlamb_no_decay": (True, True, 1.0, 8.0, 2, 0.0, "float32"),
}


@pytest.mark.parametrize("case", sorted(LAMB_CASES))
def test_flat_lamb_matches_jax(case):
    nv, bc, clip, gs, step, wd, gdt = LAMB_CASES[case]
    sizes = [64, 7, 1000, 130]
    p, g, m, v = _bucket(1, sizes, gdt)
    plan = BucketPlan.from_tree([torch.zeros(s) for s in sizes])
    jplan = JPlan.from_tree([jnp.zeros(s) for s in sizes])
    seg = plan.segment_ids(0)
    np.testing.assert_array_equal(seg.numpy(),
                                  np.asarray(jplan.segment_ids(0)))
    assert plan.num_segments(0) == jplan.num_segments(0) == len(sizes)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=wd,
              step=step, bias_correction=bc, grad_scale=gs,
              clip_coeff=clip, use_nvlamb=nv)
    jg = jnp.asarray(g).astype(gdt)
    want = jmt.flat_lamb(jnp.asarray(p), jg, jnp.asarray(m), jnp.asarray(v),
                         jplan.segment_ids(0), len(sizes), **kw)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    got = tmt.flat_lamb(tp, tg, tm, tv, seg, plan.segment_sizes(0),
                        **{**kw, "step": torch.tensor(step, dtype=torch.int32),
                           "clip_coeff": torch.tensor(clip)})
    assert got[0] is tp and got[1] is tm and got[2] is tv
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    ref = tmt.flat_lamb_ref(torch.from_numpy(p), tg, torch.from_numpy(m),
                            torch.from_numpy(v), seg, plan.segment_sizes(0),
                            **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_flat_lamb_found_inf_leaves_every_buffer():
    sizes = [10, 33]
    p, g, m, v = _bucket(2, sizes)
    plan = BucketPlan.from_tree([torch.zeros(s) for s in sizes])
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    tmt.flat_lamb(tp, torch.from_numpy(g), tm, tv, plan.segment_ids(0),
                  sizes, found_inf=torch.tensor(1, dtype=torch.int32), **kw)
    for a, b in zip((tp, tm, tv), (p, m, v)):
        np.testing.assert_array_equal(a.numpy(), b)
    tmt.flat_lamb(tp, torch.from_numpy(g), tm, tv, plan.segment_ids(0),
                  sizes, found_inf=torch.tensor(0, dtype=torch.int32), **kw)
    assert not np.array_equal(tp.numpy(), p)


def test_segment_sumsq_matches_jax():
    sizes = [5, 1, 300, 64]
    x = np.random.default_rng(3).standard_normal(sum(sizes)).astype(
        np.float32)
    jplan = JPlan.from_tree([jnp.zeros(s) for s in sizes])
    want = jmt.flat_segment_sumsq(jnp.asarray(x), jplan.segment_ids(0),
                                  len(sizes))
    got = tmt.flat_segment_sumsq(torch.from_numpy(x), sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the plan's segment metadata and FusedLAMB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("cap", [None, 200_000])
def test_plan_segments_and_layout_equal_jax_for_bert(opt_level, cap):
    tp, tst = tamp.initialize(_params(), opt_level=opt_level)
    jp, jst = jamp.initialize(_to_jax(_params()), opt_level=opt_level)
    twork = tst.master_params if tst.master_params is not None else tp
    jwork = jst.master_params if jst.master_params is not None else jp
    tplan = BucketPlan.from_tree(
        twork, tp if tst.master_params is not None else None, cap)
    jplan = JPlan.from_tree(
        jwork, jp if jst.master_params is not None else None, cap)
    assert tplan.layout() == jplan.layout()
    assert len(tplan.buckets) == len(jplan.buckets)
    for bi in range(len(tplan.buckets)):
        np.testing.assert_array_equal(tplan.segment_ids(bi).numpy(),
                                      np.asarray(jplan.segment_ids(bi)))
        assert tplan.segment_ids(bi) is tplan.segment_ids(bi)   # cached
        assert tplan.num_segments(bi) == jplan.num_segments(bi)
        assert sum(tplan.segment_sizes(bi)) == tplan.buckets[bi].size


def _run(opt, grads_seq, flags):
    for g, f in zip(grads_seq, flags):
        opt.step(g, found_inf=None if f is None
                 else torch.tensor(f, dtype=torch.int32))
    return opt


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_bucketed_matches_per_leaf(opt_level):
    params, st = tamp.initialize(_params(), opt_level=opt_level)
    # scaled so the global norm passes max_grad_norm: the clip acts
    grads = [_grads(params, s, 0.05) for s in range(3)]
    kw = dict(HYPERS, masters=st.master_params)
    a = _run(FusedLAMB(params, **kw), grads, [0, 1, 0])
    b = _run(FusedLAMB(params, fuse_buckets=False, **kw), grads, [0, 1, 0])
    assert a.fuse_buckets and not b.fuse_buckets
    tol = dict(rtol=2e-5, atol=2e-6)
    _close(a.masters if opt_level == "O2" else a.params,
           b.masters if opt_level == "O2" else b.params, **tol)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] == 2          # the skip held the clock
    _close(sa["state"], sb["state"], **tol)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_port_matches_jax_fused_lamb_with_an_overflow_skip(opt_level):
    """3 steps, the second one flagged: both skip it and hold the step
    clock, so the bias corrections of step 3 are those of step 2."""
    params = _params()
    tp, tst = tamp.initialize(params, opt_level=opt_level)
    jp, jst = jamp.initialize(_to_jax(params), opt_level=opt_level)
    tgrads = [_grads(tp, s, 0.05) for s in range(3)]
    jgrads = [_to_jax(g) for g in tgrads]
    topt = FusedLAMB(tp, masters=tst.master_params, **HYPERS)
    jopt = JLAMB(jp, masters=jst.master_params, **HYPERS)
    for s, f in enumerate([0, 1, 0]):
        topt.step(tgrads[s], found_inf=torch.tensor(f, dtype=torch.int32))
        jopt.step(jgrads[s], found_inf=jnp.int32(f))
    assert int(topt.step_count) == int(jopt.step_count) == 2
    if opt_level == "O2":
        _close(topt.masters, jopt.masters)
        for p, mst in zip(tree_leaves(topt.params), tree_leaves(topt.masters)):
            assert p.dtype == torch.bfloat16
            assert torch.equal(p, mst.to(torch.bfloat16))
    else:
        _close(topt.params, jopt.params)
    ts, js = topt.state_dict()["state"], jopt.state_dict()["state"]
    _close(ts["exp_avg"], js["exp_avg"])
    _close(ts["exp_avg_sq"], js["exp_avg_sq"])


def test_options_and_what_is_refused():
    params = _params()
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(params, amsgrad=True)
    FusedLAMB(params, amsgrad=False)
    for option in ("adam_w_mode", "grad_averaging", "set_grad_none"):
        with pytest.raises(TypeError, match=option):
            FusedLAMB(params, **{option: True})
    assert FusedLAMB(params).hypers == dict(
        lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
        bias_correction=True, max_grad_norm=1.0, use_nvlamb=False)
    opt = FusedLAMB(params, betas=(0.8, 0.99))
    assert (opt.hypers["beta1"], opt.hypers["beta2"]) == (0.8, 0.99)
    half, st = tamp.initialize(params, opt_level="O2")
    assert FusedMixedPrecisionLamb(half).master_weights
