"""apex_tpu_torch's flat_adam and FusedAdam against apex_tpu's.

Buffers and gradients are numpy draws from a seed, handed to both
packages as the same values; the optimizer trees are a narrow GPT block
stack's parameters (the port's init).

Tolerances.  ``flat_adam_ref`` is elementwise f32 in the reference's
order with each operation rounded once, and both frameworks evaluate
the bias corrections ``1 / (1 - b ** step)`` to the same bits: the
port's twin equals the JAX twin bit for bit.  The JAX kernel
(interpret mode) multiplies by ``1 / grad_scale`` and XLA may contract
a multiply-add into one rounding: within f32 rounding (rtol 1e-6, atol
1e-7 of the buffer's scale).  Three FusedAdam steps (the second
skipped on overflow) against the JAX FusedAdam: the same bound on the
params, masters and moments, bf16 params exactly the cast of the
masters; the port's bucketed and per-leaf steps run the same twin and
agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch import _build
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.examples.gpt_train_block import GPTBlocks
from apex_tpu_torch.ops import multi_tensor as tmt
from apex_tpu_torch.optimizers import FusedAdam

TOL = dict(rtol=1e-6, atol=1e-7)
N = 4099                # not a multiple of the kernels' 4-element vectors


def _bufs(seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(N).astype(np.float32)
    g = (rng.standard_normal(N) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(N) * 1e-3).astype(np.float32)
    v = (rng.standard_normal(N) ** 2 * 1e-5).astype(np.float32)
    return p, g, m, v


def _j(x, bf16=False):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def _t(x, bf16=False):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(torch.bfloat16) if bf16 else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


CASES = {
    # name: (adam_w_mode, bias_correction, p bf16, g bf16, grad_scale, step)
    "adamw_bc": (True, True, False, False, 1.0, 1),
    "adamw_bc_bf16_grads_scaled": (True, True, False, True, 1024.0, 7),
    "adam_l2_bc": (False, True, False, False, 1.0, 3),
    "adamw_no_bc": (True, False, False, True, 1.0, 2),
    "adam_l2_no_bc_bf16_params": (False, False, True, True, 65536.0, 5),
}


def _kw(case):
    aw, bc, _, _, gs, step = CASES[case]
    return dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                step=step, adam_w_mode=aw, bias_correction=bc, grad_scale=gs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_adam_ref_matches_jax_twin_bit_for_bit(case):
    _, _, pb, gb, _, _ = CASES[case]
    p, g, m, v = _bufs(1)
    want = jmt.flat_adam_ref(_j(p, pb), _j(g, gb), _j(m), _j(v), **_kw(case))
    got = tmt.flat_adam_ref(_t(p, pb), _t(g, gb), _t(m), _t(v), **_kw(case))
    assert got[0].dtype == (torch.bfloat16 if pb else torch.float32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_adam_ref_matches_jax_kernel_within_rounding(case):
    _, _, pb, gb, _, _ = CASES[case]
    p, g, m, v = _bufs(2)
    want = jmt.flat_adam(_j(p, pb), _j(g, gb), _j(m), _j(v), **_kw(case))
    got = tmt.flat_adam_ref(_t(p, pb), _t(g, gb), _t(m), _t(v), **_kw(case))
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(a, b, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(b).max())


@pytest.mark.parametrize("flag", [0, 1])
def test_flat_adam_in_place_and_found_inf_gate(flag):
    """The CPU wrapper updates p, m and v in place as the twin computes;
    with the flag set all three keep their bits."""
    p, g, m, v = (_t(x) for x in _bufs(3))
    g[11] = float("nan")
    want = tmt.flat_adam_ref(p, g, m, v, **_kw("adamw_bc"))
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    got = tmt.flat_adam(p, g, m, v, found_inf=torch.tensor(flag,
                                                          dtype=torch.int32),
                        **_kw("adamw_bc"))
    assert got[0] is p and got[1] is m and got[2] is v
    for a, old, new in zip(got, (p0, m0, v0), want):
        torch.testing.assert_close(a, old if flag else new, atol=0, rtol=0,
                                   equal_nan=True)


def _tree():
    return GPTBlocks(vocab=96, hidden=64, heads=4, layers=1, max_seq=16,
                     dtype=torch.float32).init(0, "cpu")


def _to_jax(tree):
    return tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: (rng.standard_normal(tuple(p.shape)) * 1e-2
                               ).astype(np.float32), params)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_fused_adam_three_steps_with_a_skip_match_jax(opt_level):
    params = _tree()
    hyp = dict(lr=1e-2, weight_decay=0.01, betas=(0.9, 0.99))
    tp, tstate = tamp.initialize(params, opt_level=opt_level, device="cpu")
    jp, jstate = jamp.initialize(_to_jax(params), opt_level=opt_level)
    topt = FusedAdam(tp, master_weights=bool(
        tstate.properties.master_weights), masters=tstate.master_params,
        **hyp)
    jopt = JAdam(jp, master_weights=bool(jstate.properties.master_weights),
                 masters=jstate.master_params, **hyp)
    flat = FusedAdam(tp, master_weights=bool(
        tstate.properties.master_weights), masters=tstate.master_params,
        fuse_buckets=False, **hyp)
    assert topt._plan is not None and flat._plan is None
    for step in range(3):
        g = _grads(params, 10 + step)
        half = opt_level == "O2"
        tg = tree_map(lambda a: _t(a, half), g)
        jg = tree_map(lambda a: _j(a, half), g)
        skip = step == 1
        topt.step(tg, found_inf=torch.tensor(int(skip), dtype=torch.int32))
        flat.step(tg, found_inf=torch.tensor(int(skip), dtype=torch.int32))
        jopt.step(jg, found_inf=jnp.int32(int(skip)))
    assert int(topt.step_count) == int(jopt.step_count) == 2
    for got, want in ((topt.masters if half else topt.params,
                       jopt.masters if half else jopt.params),
                      (topt.state_dict()["state"],
                       jopt.state_dict()["state"])):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            a, b = _np(a), _np(b)
            np.testing.assert_allclose(a, b, rtol=TOL["rtol"],
                                       atol=TOL["atol"] * np.abs(b).max())
    # bucketed and per-leaf: the same twin, the same bits
    for a, b in zip(tree_leaves(topt.params), tree_leaves(flat.params)):
        assert torch.equal(a, b)
    if half:
        for p, m in zip(tree_leaves(topt.params), tree_leaves(topt.masters)):
            assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(p.dtype))


def test_fused_adam_refuses_amsgrad_and_takes_betas():
    params = {"w": torch.ones(3)}
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(params, amsgrad=True)
    opt = FusedAdam(params, betas=(0.8, 0.95), adam_w_mode=False)
    assert (opt.hypers["beta1"], opt.hypers["beta2"]) == (0.8, 0.95)
    assert opt.hypers["adam_w_mode"] is False


def test_adam_kernel_is_registered_with_a_launch_count():
    assert tmt.ADAM in _build.KERNELS and tmt.ADAM.name == "flat_adam"
    assert tmt.ADAM.library == "multi_tensor"
    before = tmt.ADAM.launches
    p, g, m, v = (_t(x) for x in _bufs(4))
    tmt.flat_adam(p, g, m, v, **_kw("adamw_bc"))
    assert tmt.ADAM.launches == before     # the CPU path never launches
