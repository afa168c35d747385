"""apex_tpu_torch's optimizer tail against apex_tpu's: flat_scale,
flat_axpby, flat_adagrad and flat_novograd (the plain twins the card's
kernels are held to), the packer's per-leaf scalar state, FusedNovoGrad
and FusedAdagrad.

Buffers and gradients are numpy draws from a seed, handed to both
packages as the same values, at ragged lengths (not a multiple of the
kernels' 4-element vectors); the optimizer trees are a narrow GPT block
stack's parameters (the port's init).  The JAX ``flat_*`` run their
Pallas kernels in interpret mode.

Tolerances, each with its reason:
- flat_scale: bit for bit against both JAX versions (one product);
- flat_axpby: bit for bit against the JAX twin (each product and the
  sum rounded once, as the card's kernel computes them); the JAX kernel
  in interpret mode is contracted by XLA into one FMA: within one f32
  rounding of the products (atol 1e-6 of the result's scale), which
  can flip a bf16 or f16 output by one ulp;
- flat_adagrad: ``h`` bit for bit against the JAX twin (both divide by
  ``grad_scale``); ``p`` within one ulp of its dtype (f32: rtol 1e-6,
  atol 1e-7 of its scale; bf16: 2**-7), because PyTorch's CPU
  ``torch.sqrt`` (its AVX512 path) is not correctly rounded (one ulp
  off at 0.6% of f32 inputs; numpy's and XLA's are, and so is the
  card's, where the kernel is held to the twin's bits).  The JAX kernel multiplies by
  ``1 / grad_scale``: the same bound;
- flat_novograd: the port takes each segment's norm of the raw gradient
  and divides it by ``grad_scale`` (``torch._foreach_norm``, no scaled
  copy of the bucket), the reference sums the squares of the scaled
  gradient (XLA's segment sum), each in its own order over segments of
  up to 2048 elements: the second moment within rtol 1e-5, and so the
  param and first moment (atol 1e-7 of the buffer's scale);
- three FusedNovoGrad / FusedAdagrad steps (the second skipped on
  overflow) against the JAX optimizers: rtol 1e-5, atol 1e-6 of each
  leaf's scale on the params (masters at O2) and the state, bf16 params
  exactly the cast of the masters; the port's bucketed and per-leaf
  steps run the same twin on the same segments: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import FusedAdagrad as JAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JNovoGrad
from apex_tpu_torch import _build
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves, tree_map, tree_structure
from apex_tpu_torch.examples.gpt_train_block import GPTBlocks
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan
from apex_tpu_torch.ops import multi_tensor as tmt
from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad

N = 4099                # not a multiple of the kernels' 4-element vectors
SIZES = (1000, 7, 3, 2048, 1041)        # NovoGrad's segments, sum N
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16),
      "f16": (jnp.float16, torch.float16)}


# one ulp of each storage dtype, relative (f32: a few)
ROUNDING = {"f32": 1e-6, "bf16": 2.0 ** -7, "f16": 2.0 ** -10}


def _draw(seed, n=N, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _j(x, dt="f32"):
    return jnp.asarray(x).astype(DT[dt][0])


def _t(x, dt="f32"):
    return torch.from_numpy(np.array(x, np.float32)).to(DT[dt][1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _close(got, want, rtol, atol=0.0):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# flat_scale, flat_axpby
# ---------------------------------------------------------------------------

SCALE_CASES = [("f32", "f32", 0.37), ("bf16", "bf16", 2.0 ** -10),
               ("f32", "bf16", 1.3), ("bf16", "f32", 65536.0),
               ("f32", "f16", 0.5)]


@pytest.mark.parametrize("xdt,odt,s", SCALE_CASES)
def test_flat_scale_matches_jax_bit_for_bit(xdt, odt, s):
    x = _draw(1)
    want_ref = jmt.flat_scale_ref(_j(x, xdt), s, DT[odt][0])
    want_kern = jmt.flat_scale(_j(x, xdt), s, DT[odt][0])
    for scale in (s, torch.tensor(s)):          # host or device scalar
        got, flag = tmt.flat_scale(_t(x, xdt), scale, DT[odt][1])
        assert got.dtype == DT[odt][1] and int(flag) == 0
        _equal(got, want_ref[0])
        _equal(got, want_kern[0])
    assert int(want_ref[1]) == int(want_kern[1]) == 0


AXPBY_CASES = [("f32", "f32", "f32"), ("bf16", "bf16", "bf16"),
               ("f32", "bf16", "f32"), ("bf16", "f32", "f16")]


@pytest.mark.parametrize("xdt,ydt,odt", AXPBY_CASES)
def test_flat_axpby_matches_jax_bit_for_bit(xdt, ydt, odt):
    x, y = _draw(2), _draw(3)
    a, b = 0.7, -1.3
    want_ref = jmt.flat_axpby_ref(a, _j(x, xdt), b, _j(y, ydt), DT[odt][0])
    want_kern = jmt.flat_axpby(a, _j(x, xdt), b, _j(y, ydt), DT[odt][0])
    got, flag = tmt.flat_axpby(torch.tensor(a), _t(x, xdt), b, _t(y, ydt),
                               DT[odt][1])
    assert got.dtype == DT[odt][1] and int(flag) == 0
    _equal(got, want_ref[0])
    _close(got, want_kern[0], rtol=ROUNDING[odt], atol=1e-6)


@pytest.mark.parametrize("poison", ["inf", "-inf", "nan"])
@pytest.mark.parametrize("op", ["scale", "axpby"])
def test_flags_on_a_planted_non_finite(op, poison):
    x, y = _draw(4), _draw(5)
    x[N - 1] = float(poison)            # the ragged tail
    if op == "scale":
        got = tmt.flat_scale(_t(x), 0.5)
        want = jmt.flat_scale(_j(x), 0.5)
    else:
        got = tmt.flat_axpby(0.5, _t(x), 2.0, _t(y))
        want = jmt.flat_axpby(0.5, _j(x), 2.0, _j(y))
    assert int(got[1]) == int(want[1]) == 1
    _close(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_flag_is_of_the_f32_result_before_the_cast():
    """A finite f32 product that rounds to inf in bf16 does not flag, in
    the reference's twin and kernel alike; an f32 product that overflows
    does."""
    x = np.full(5, 3.4e38, np.float32)
    got, flag = tmt.flat_scale(_t(x), 1.0, torch.bfloat16)
    want = jmt.flat_scale(_j(x), 1.0, jnp.bfloat16)
    assert bool(torch.isinf(got).all()) and int(flag) == 0
    assert int(want[1]) == int(jmt.flat_scale_ref(_j(x), 1.0,
                                                  jnp.bfloat16)[1]) == 0
    assert int(tmt.flat_scale(_t(x), 2.0)[1]) == 1
    assert int(tmt.flat_axpby(1.0, _t(x), 1.0, _t(x))[1]) == 1


# ---------------------------------------------------------------------------
# flat_adagrad
# ---------------------------------------------------------------------------

ADAGRAD_CASES = {
    # name: (p dtype, g dtype, weight decay, grad scale)
    "f32": ("f32", "f32", 0.0, 1.0),
    "masters_bf16_grads_decay": ("f32", "bf16", 0.01, 1024.0),
    "bf16_params": ("bf16", "bf16", 0.01, 1.0),
    "f32_scale_not_pow2": ("f32", "f32", 0.0, 3.0),
}


def _adagrad_bufs(case, seed):
    pdt, gdt, _, _ = ADAGRAD_CASES[case]
    p, g, h = _draw(seed), _draw(seed + 1, scale=1e-2), _draw(seed + 2)
    h = np.abs(h) * 1e-3
    return (p, pdt), (g, gdt), (h, "f32")


@pytest.mark.parametrize("case", sorted(ADAGRAD_CASES))
def test_flat_adagrad_matches_jax(case):
    _, _, wd, gs = ADAGRAD_CASES[case]
    bufs = _adagrad_bufs(case, 10)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=wd, grad_scale=gs)
    want_ref = jmt.flat_adagrad_ref(*(_j(*b) for b in bufs), **kw)
    want_kern = jmt.flat_adagrad(*(_j(*b) for b in bufs), **kw)
    got = tmt.flat_adagrad_ref(*(_t(*b) for b in bufs), **kw)
    pdt = bufs[0][1]
    assert got[0].dtype == DT[pdt][1]
    _equal(got[1], want_ref[1])
    _close(got[1], want_kern[1], rtol=1e-6)
    for want in (want_ref[0], want_kern[0]):
        _close(got[0], want, rtol=ROUNDING[pdt], atol=1e-7)


@pytest.mark.parametrize("flag", [0, 1])
def test_flat_adagrad_in_place_and_found_inf_gate(flag):
    """The CPU wrapper writes the twin's result into p and h; with the
    flag set both keep their bits."""
    p, g, h = (_t(*b) for b in _adagrad_bufs("masters_bf16_grads_decay", 20))
    g[11] = float("nan")
    kw = dict(lr=torch.tensor(1e-2), eps=1e-10, weight_decay=0.01,
              grad_scale=torch.tensor(1024.0))
    want = tmt.flat_adagrad_ref(p, g, h, **kw)
    p0, h0 = p.clone(), h.clone()
    got = tmt.flat_adagrad(p, g, h, found_inf=torch.tensor(flag), **kw)
    assert got[0] is p and got[1] is h
    for a, old, new in zip(got, (p0, h0), want):
        torch.testing.assert_close(a, old if flag else new, atol=0, rtol=0,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# flat_novograd
# ---------------------------------------------------------------------------

NOVO_CASES = {
    # name: (p dtype, g dtype, grad scale, first, init_zero, rim, avg)
    "f32_first": ("f32", "f32", 1.0, True, False, False, True),
    "masters_bf16_grads": ("f32", "bf16", 1024.0, False, False, False, True),
    "init_zero_first": ("f32", "bf16", 1.0, True, True, False, True),
    "reg_inside_no_avg": ("f32", "f32", 4.0, False, False, True, False),
    "bf16_params_rim": ("bf16", "bf16", 1.0, False, True, True, True),
}


def _novo_bufs(case, seed):
    pdt, gdt = NOVO_CASES[case][:2]
    p, g, m = _draw(seed), _draw(seed + 1, scale=1e-2), _draw(seed + 2,
                                                              scale=1e-3)
    v = np.abs(_draw(seed + 3, n=len(SIZES))) * 1e-2
    return (p, pdt), (g, gdt), (m, "f32"), (v, "f32")


def _novo_kw(case):
    _, _, gs, first, iz, rim, avg = NOVO_CASES[case]
    return dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8,
                weight_decay=0.01, first_run=first, grad_averaging=avg,
                init_zero=iz, reg_inside_moment=rim, grad_scale=gs)


@pytest.mark.parametrize("case", sorted(NOVO_CASES))
def test_flat_novograd_matches_jax(case):
    bufs = _novo_bufs(case, 30)
    seg = jnp.asarray(np.repeat(np.arange(len(SIZES), dtype=np.int32),
                                SIZES))
    jb = [_j(*b) for b in bufs]
    want_ref = jmt.flat_novograd_ref(*jb, seg, **_novo_kw(case))
    want_kern = jmt.flat_novograd(*jb, seg, **_novo_kw(case))
    got = tmt.flat_novograd_ref(*(_t(*b) for b in bufs), SIZES,
                                **_novo_kw(case))
    assert got[0].dtype == DT[bufs[0][1]][1] and got[2].shape == (5,)
    tol = max(1e-5, ROUNDING[bufs[0][1]])
    for a, r, k in zip(got, want_ref, want_kern):
        _close(a, r, rtol=tol, atol=1e-7)
        _close(a, k, rtol=tol, atol=1e-7)


@pytest.mark.parametrize("flag", [0, 1])
def test_flat_novograd_in_place_and_found_inf_gate(flag):
    """p, m and the per-segment v all keep their bits under the flag (v
    is computed outside the kernel, so the skip must cover it too)."""
    p, g, m, v = (_t(*b) for b in _novo_bufs("masters_bf16_grads", 40))
    g[3] = float("inf")
    kw = _novo_kw("masters_bf16_grads")
    want = tmt.flat_novograd_ref(p, g, m, v, SIZES, **kw)
    old = [t.clone() for t in (p, m, v)]
    got = tmt.flat_novograd(p, g, m, v, SIZES, found_inf=torch.tensor(flag),
                            **kw)
    assert got[0] is p and got[1] is m and got[2] is v
    for a, o, new in zip(got, old, want):
        torch.testing.assert_close(a, o if flag else new, atol=0, rtol=0,
                                   equal_nan=True)


def test_segment_offsets_table():
    offs = tmt.segment_offsets(SIZES, "cpu")
    assert offs.dtype == torch.int64
    assert offs.tolist() == [0, 1000, 1007, 1010, 3058, 4099]


# ---------------------------------------------------------------------------
# the packer's per-leaf scalar state
# ---------------------------------------------------------------------------

def _tree():
    return GPTBlocks(vocab=96, hidden=64, heads=4, layers=1, max_seq=16,
                     dtype=torch.float32).init(0, "cpu")


@pytest.mark.parametrize("cap", [None, 20_000])
def test_scalar_state_field_packs_one_vector_per_bucket(cap):
    params = _tree()
    plan = BucketPlan.from_tree(params, max_bucket_bytes=cap)
    field = tree_map(lambda p: torch.tensor(float(p.numel())), params)
    bufs = plan.pack_state_field(field)
    assert [tuple(b.shape) for b in bufs] == [(len(b.leaves),)
                                              for b in plan.buckets]
    assert all(b.dtype == torch.float32 for b in bufs)
    for bi, b in enumerate(plan.buckets):
        assert bufs[bi].tolist() == [float(s.size) for s in b.leaves]
    back = plan.unpack_state_field(bufs)
    assert tree_structure(back) == tree_structure(params)
    for a, p in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dim() == 0 and float(a) == float(p.numel())
    # a field at the params' shapes still packs flat
    flat = plan.pack_state_field(params)
    assert [b.numel() for b in flat] == [b.size for b in plan.buckets]
    offs = plan.segment_offsets(0)
    assert offs.tolist() == [0] + list(np.cumsum(plan.segment_sizes(0)))


# ---------------------------------------------------------------------------
# FusedNovoGrad, FusedAdagrad
# ---------------------------------------------------------------------------

def _to_jax(tree):
    return tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: (rng.standard_normal(tuple(p.shape)) * 1e-2
                               ).astype(np.float32), params)


def _three_steps(cls, jcls, hyp, opt_level, skip_step=1):
    """The port's bucketed and per-leaf optimizers and the JAX one, three
    steps from the same tree and grads, step ``skip_step`` skipped."""
    params = _tree()
    tp, tstate = tamp.initialize(params, opt_level=opt_level, device="cpu")
    jp, jstate = jamp.initialize(_to_jax(params), opt_level=opt_level)
    mw = bool(tstate.properties.master_weights)
    buck = cls(tp, master_weights=mw, masters=tstate.master_params, **hyp)
    leaf = cls(tp, master_weights=mw, masters=tstate.master_params,
               fuse_buckets=False, **hyp)
    jopt = jcls(jp, master_weights=bool(jstate.properties.master_weights),
                masters=jstate.master_params, **hyp)
    assert buck._plan is not None and leaf._plan is None
    half = opt_level == "O2"
    for step in range(3):
        g = _grads(params, 10 + step)
        tg = tree_map(lambda a: _t(a, "bf16" if half else "f32"), g)
        jg = tree_map(lambda a: _j(a, "bf16" if half else "f32"), g)
        skip = int(step == skip_step)
        buck.step(tg, found_inf=torch.tensor(skip, dtype=torch.int32))
        leaf.step(tg, found_inf=torch.tensor(skip, dtype=torch.int32))
        jopt.step(jg, found_inf=jnp.int32(skip))
    return buck, leaf, jopt


def _held_to_jax(buck, leaf, jopt):
    half = buck.masters is not None
    assert int(buck.step_count) == int(leaf.step_count) \
        == int(jopt.step_count) == 2
    for got, want in ((buck.masters if half else buck.params,
                       jopt.masters if half else jopt.params),
                      (buck.state_dict()["state"],
                       jopt.state_dict()["state"])):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            _close(a, b, **STEP_TOL)
    for a, b in zip(tree_leaves(buck.params), tree_leaves(leaf.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(buck.state_dict()["state"]),
                    tree_leaves(leaf.state_dict()["state"])):
        assert a.shape == b.shape and torch.equal(a, b)
    if half:
        for p, m in zip(tree_leaves(buck.params), tree_leaves(buck.masters)):
            assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(p.dtype))


NOVO_FLAGS = [(iz, rim, avg) for iz in (False, True) for rim in (False, True)
              for avg in (False, True)]


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("init_zero,reg_inside_moment,grad_averaging",
                         NOVO_FLAGS)
def test_fused_novograd_three_steps_match_jax_and_per_leaf(
        init_zero, reg_inside_moment, grad_averaging, opt_level):
    hyp = dict(lr=1e-2, weight_decay=0.01, init_zero=init_zero,
               reg_inside_moment=reg_inside_moment,
               grad_averaging=grad_averaging)
    _held_to_jax(*_three_steps(FusedNovoGrad, JNovoGrad, hyp, opt_level))


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fused_adagrad_three_steps_match_jax_and_per_leaf(weight_decay,
                                                          opt_level):
    hyp = dict(lr=1e-2, weight_decay=weight_decay)
    _held_to_jax(*_three_steps(FusedAdagrad, JAdagrad, hyp, opt_level))


@pytest.mark.parametrize("cls", [FusedNovoGrad, FusedAdagrad])
@pytest.mark.parametrize("fuse", [True, False])
def test_a_skipped_step_leaves_every_bit(cls, fuse):
    """A skipped first step leaves params, masters, the state (NovoGrad's
    per-tensor v included) and the step clock bit-identical, and the next
    step is the first again: it equals a first step on a fresh optimizer."""
    params = _tree()
    tp, tstate = tamp.initialize(params, opt_level="O2", device="cpu")
    kw = dict(lr=1e-2, weight_decay=0.01, fuse_buckets=fuse,
              masters=tstate.master_params)
    opt, fresh = cls(tp, **kw), cls(tp, **kw)
    before = (opt.state_dict(), [t.clone() for t in tree_leaves(opt.params)])
    bad = tree_map(lambda a: _t(a, "bf16"), _grads(params, 1))
    good = tree_map(lambda a: _t(a, "bf16"), _grads(params, 2))
    opt.step(bad, found_inf=torch.tensor(1, dtype=torch.int32))
    after = opt.state_dict()
    assert after["step"] == before[0]["step"] == 0
    for a, b in zip(tree_leaves(after["state"]) + tree_leaves(
            after["masters"]) + tree_leaves(opt.params),
            tree_leaves(before[0]["state"]) + tree_leaves(
                before[0]["masters"]) + before[1]):
        assert torch.equal(a, b)
    opt.step(good, found_inf=torch.tensor(0, dtype=torch.int32))
    fresh.step(good)
    for a, b in zip(tree_leaves(opt.state_dict()["state"]) + tree_leaves(
            opt.masters), tree_leaves(fresh.state_dict()["state"])
            + tree_leaves(fresh.masters)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cls", [FusedNovoGrad, FusedAdagrad])
def test_state_dict_layout_and_round_trip_across_packing(cls):
    """The per-leaf checkpoint layout (NovoGrad: exp_avg at the params'
    shapes, exp_avg_sq one 0-d tensor a leaf) from either path loads into
    the other, and the next steps agree bit for bit."""
    params = _tree()
    g = tree_map(_t, _grads(params, 3))
    old = cls(params, lr=1e-2, weight_decay=0.01, fuse_buckets=False)
    old.step(g)
    sd = old.state_dict()
    if cls is FusedNovoGrad:
        for v, m, p in zip(tree_leaves(sd["state"]["exp_avg_sq"]),
                           tree_leaves(sd["state"]["exp_avg"]),
                           tree_leaves(params)):
            assert v.shape == () and m.shape == p.shape
    new = cls(old.params, lr=1e-2, weight_decay=0.01)
    new.load_state_dict(sd)
    assert int(new.step_count) == 1
    old.step(g)
    new.step(g)
    sd2 = new.state_dict()
    assert tree_structure(sd2["state"]) == tree_structure(sd["state"])
    back = cls(new.params, lr=1e-2, weight_decay=0.01, fuse_buckets=False)
    back.load_state_dict(sd2)
    back.step(g)
    new.step(g)
    old.step(g)
    for a, b, c in zip(tree_leaves(old.params), tree_leaves(new.params),
                       tree_leaves(back.params)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_options_and_what_is_refused():
    params = {"w": torch.ones(3)}
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(params, amsgrad=True)
    opt = FusedNovoGrad(params, betas=(0.9, 0.99), norm_type=0)
    assert (opt.hypers["beta1"], opt.hypers["beta2"]) == (0.9, 0.99)
    with pytest.raises(ValueError, match="norm_type=2"):
        opt.step({"w": torch.ones(3)})
    assert FusedNovoGrad.defaults["lr"] == JNovoGrad.defaults["lr"]
    assert FusedNovoGrad.defaults == {
        k: v for k, v in JNovoGrad.defaults.items()
        if k not in ("amsgrad", "set_grad_none")}
    assert FusedAdagrad.defaults == {
        k: v for k, v in JAdagrad.defaults.items()
        if k not in ("adagrad_w_mode", "set_grad_none")}


@pytest.mark.parametrize("opt, option", [
    (FusedNovoGrad, "set_grad_none"), (FusedAdagrad, "set_grad_none"),
    (FusedAdagrad, "adagrad_w_mode")])
def test_options_the_port_does_not_read_are_rejected(opt, option):
    with pytest.raises(TypeError, match=option):
        opt({"w": torch.ones(3)}, **{option: True})


def test_segment_norms_hold_a_long_run_on_the_cpu():
    """Per-tensor norms of a run of millions of elements agree with an f64
    sum to f32 rounding (the CPU's f32 vector norm drifts by about 4e-5
    at this length, which NovoGrad carries into its whole update), and a
    run gives the same bits inside a bucket as alone."""
    sizes = [5, 2_359_296, 7]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        sum(sizes)).astype(np.float32) * 1e-3)
    got = tmt.segment_norms(x, sizes)
    want = [np.sqrt(np.sum(np.square(r.numpy().astype(np.float64))))
            for r in torch.split(x, sizes)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(got[1:2], tmt.segment_norms(x[5:-7], sizes[1:2]))


def test_flat_novograd_off_the_cpu_needs_its_segment_table():
    """Off the CPU the segment-start table is the caller's, built once
    per bucket (a table built per call would copy from the host every
    step)."""
    x = torch.zeros(sum(SIZES), device="meta")
    with pytest.raises(ValueError, match="seg_offsets is required"):
        tmt.flat_novograd(x, x, x, torch.zeros(len(SIZES), device="meta"),
                          SIZES, lr=0.1, beta1=0.9, beta2=0.9, eps=1e-8)


def test_tail_kernels_are_registered_and_the_cpu_never_launches():
    kernels = (tmt.SCALE, tmt.AXPBY, tmt.ADAGRAD, tmt.NOVOGRAD)
    assert all(k in _build.KERNELS and k.library == "multi_tensor"
               for k in kernels)
    assert [k.name for k in kernels] == ["flat_scale", "flat_axpby",
                                        "flat_adagrad", "flat_novograd"]
    before = [k.launches for k in kernels]
    x = _t(_draw(50))
    tmt.flat_scale(x, 2.0)
    tmt.flat_axpby(1.0, x, 2.0, x)
    tmt.flat_adagrad(x.clone(), x, x.abs(), lr=0.1, eps=1e-10)
    tmt.flat_novograd(x.clone(), x, x.clone(), torch.zeros(len(SIZES)),
                      SIZES, lr=0.1, beta1=0.9, beta2=0.9, eps=1e-8)
    assert [k.launches for k in kernels] == before
