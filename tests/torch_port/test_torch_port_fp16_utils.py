"""apex_tpu_torch's contrib.clip_grad and fp16_utils against apex_tpu's,
and the optimizer-tail slice as a whole: the GPT block stack trained
with FusedNovoGrad through the flat pipeline with a global-norm clip.

Inputs are numpy draws from a seed, handed to both packages as the same
values.  The JAX ``flat_l2norm``/``flat_scale`` run their Pallas kernels
in interpret mode.

Tolerances, each with its reason:
- clip_grad_norm: the global norm is summed in each framework's own
  order (rtol 1e-6); the clipped gradients carry that factor (rtol
  1e-6); a clip below the threshold multiplies by exactly 1 (bit for
  bit, on both sides);
- FP16_Optimizer over FusedAdagrad: the loss scale and the skip
  decisions exactly; the masters after three steps within rtol 1e-6,
  atol 1e-7 of each leaf's scale (PyTorch's AVX512 CPU ``torch.sqrt``
  is one ulp off at 0.6% of inputs, ``test_torch_port_optim_tail``);
- the GPT block stack (the example's CPU widths, the flax init through
  ``convert.gpt_block_from_jax``), FusedNovoGrad lr 1e-3 with
  ``max_grad_norm=1.0``, three steps: at O0 (f32 model) the losses
  within rtol 1e-5 and the params' displacement within 1e-4 of its
  norm (the two frameworks sum their matmuls in their own orders, and
  their gradients agree to 1e-4 of each leaf's scale,
  ``test_torch_port_gpt_block``); at O2 (bf16 model) the losses within
  rtol 1e-3 and the masters' displacement within 0.2 of its norm, the
  band of bf16 activation roundings that ``test_torch_port_gpt_block``
  states for FusedAdam.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.contrib.clip_grad import clip_grad_norm as jclip
from apex_tpu.fp16_utils import FP16_Optimizer as JFP16
from apex_tpu.fp16_utils import fp16util as jutil
from apex_tpu.optimizers import FusedAdagrad as JAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JNovoGrad
from apex_tpu_torch import amp as tamp
from apex_tpu_torch._tree import tree_leaves, tree_map, tree_structure
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm, clip_grad_norm_
from apex_tpu_torch.convert import gpt_block_from_jax
from apex_tpu_torch.examples import gpt_train_block as ex
from apex_tpu_torch.fp16_utils import (BN_convert_float, DynamicLossScaler,
                                       FP16_Optimizer, LossScaler,
                                       master_params_to_model_params,
                                       model_grads_to_master_grads,
                                       network_to_half, prep_param_lists,
                                       to_python_float, tree_to_half)
from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad

from test_torch_port_gpt_block import _jax_params, _jloss, _models, _tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": (rng.standard_normal((13, 7)) * scale
                                 ).astype(np.float32),
                      "bias": (rng.standard_normal(7) * scale
                               ).astype(np.float32)},
            "layernorm_0": {"scale": (rng.standard_normal(5) * scale
                                      ).astype(np.float32)},
            "head": (rng.standard_normal((3, 3)) * scale).astype(np.float32)}


def _t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _j(tree, dtype=jnp.float32):
    return tree_map(lambda a: jnp.asarray(a).astype(dtype), tree)


# ---------------------------------------------------------------------------
# contrib.clip_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.5])
@pytest.mark.parametrize("layout", ["tree", "packed"])
def test_clip_grad_norm_matches_jax(layout, norm_type):
    g = _tree_np(1)
    if layout == "packed":           # per-bucket flat buffers, one dtype each
        tg = [torch.from_numpy(np.concatenate([g["dense"]["kernel"].ravel(),
                                               g["head"].ravel()])),
              torch.from_numpy(g["dense"]["bias"]).to(torch.bfloat16)]
        jg = [jnp.asarray(_np(t)).astype(jnp.bfloat16 if t.dtype ==
                                         torch.bfloat16 else jnp.float32)
              for t in tg]
    else:
        tg, jg = _t(g), _j(g)
    got, norm = clip_grad_norm(tg, 1.0, norm_type)
    want, wnorm = jclip(jg, 1.0, norm_type)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    assert float(norm) > 1.0                         # it did clip
    assert tree_structure(got) == tree_structure(tg)
    for a, b, src in zip(tree_leaves(got), tree_leaves(want),
                         tree_leaves(tg)):
        assert a.dtype == src.dtype and a.shape == src.shape
        tol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=1e-7)


@pytest.mark.parametrize("layout", ["tree", "packed"])
def test_clip_grad_norm_is_a_no_op_below_the_threshold(layout):
    g = _tree_np(2, scale=1e-3)
    tg = (_t(g) if layout == "tree"
          else [torch.from_numpy(l.ravel()) for l in tree_leaves(g)])
    got, norm = clip_grad_norm_(tg, 10.0)
    want, wnorm = jclip(_j(g), 10.0)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for a, b in zip(tree_leaves(got), tree_leaves(tg)):
        assert torch.equal(a, b)
    if layout == "packed":
        assert type(got) is list


# ---------------------------------------------------------------------------
# fp16_utils
# ---------------------------------------------------------------------------

def test_fp16util_helpers_match_jax():
    params = _tree_np(3)
    half, jhalf = network_to_half(_t(params)), jutil.network_to_half(
        _j(params))
    for a, b in zip(tree_leaves(half), tree_leaves(jhalf)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(_np(a), _np(b))
    assert half["layernorm_0"]["scale"].dtype == torch.float32
    assert half["dense"]["kernel"].dtype == torch.bfloat16
    assert tree_to_half(_t(params))["layernorm_0"]["scale"].dtype \
        == torch.bfloat16
    assert BN_convert_float({"bn": {"bias": torch.zeros(2, dtype=torch.half)}
                             })["bn"]["bias"].dtype == torch.float32
    model, masters = prep_param_lists(half)
    assert all(m.dtype == torch.float32 for m in tree_leaves(masters))
    _, (flat, unravel) = prep_param_lists(half, flat_master=True)
    _, (jflat, _) = jutil.prep_param_lists(jhalf, flat_master=True)
    np.testing.assert_array_equal(_np(flat), _np(jflat))
    back = unravel(flat)
    assert tree_structure(back) == tree_structure(half)
    moved = tree_map(lambda m: m + 0.25, masters)
    written = master_params_to_model_params(model, moved)
    jwritten = jutil.master_params_to_model_params(
        jhalf, tree_map(lambda m: m.astype(jnp.float32) + 0.25, jhalf))
    for a, b in zip(tree_leaves(written), tree_leaves(jwritten)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert all(g.dtype == torch.float32 for g in tree_leaves(
        model_grads_to_master_grads(half)))
    assert to_python_float(torch.tensor([2.5])) == 2.5


def test_loss_scalers_back_off_and_grow_as_jax():
    from apex_tpu.fp16_utils import DynamicLossScaler as JDyn
    mine, ref = (DynamicLossScaler(init_scale=2.0 ** 8, scale_window=2),
                 JDyn(init_scale=2.0 ** 8, scale_window=2))
    assert mine.has_overflow({"g": torch.tensor([float("inf")])})
    assert not mine.has_overflow({"g": torch.ones(3)})
    for overflow in (True, False, False, True, False, False, False):
        mine.update_scale(overflow)
        ref.update_scale(overflow)
        assert mine.loss_scale == ref.loss_scale
    static = LossScaler(128.0)
    assert static.loss_scale == 128.0
    assert not static.has_overflow({"g": torch.tensor([float("nan")])})


def _fp16_run(dynamic, steps_grads, jax_side):
    params = _tree_np(4)
    if jax_side:
        opt = JAdagrad(_j(params, jnp.bfloat16), lr=1e-2, weight_decay=0.01)
        fopt = JFP16(opt, static_loss_scale=128.0,
                     dynamic_loss_scale=dynamic,
                     dynamic_loss_args={"init_scale": 2.0 ** 10,
                                        "scale_window": 2})
    else:
        opt = FusedAdagrad(_t(params, torch.bfloat16), lr=1e-2,
                           weight_decay=0.01)
        fopt = FP16_Optimizer(opt, static_loss_scale=128.0,
                              dynamic_loss_scale=dynamic,
                              dynamic_loss_args={"init_scale": 2.0 ** 10,
                                                 "scale_window": 2})
    trace = []
    for g in steps_grads:
        scaled = tree_map(lambda a: a * fopt.loss_scale, g)
        fopt.step(_j(scaled, jnp.bfloat16) if jax_side
                  else _t(scaled, torch.bfloat16))
        trace.append((fopt.overflow, fopt.loss_scale))
    return fopt, trace


@pytest.mark.parametrize("dynamic", [False, True])
def test_fp16_optimizer_over_fused_adagrad_matches_jax(dynamic):
    grads = [_tree_np(10 + i, scale=1e-2) for i in range(4)]
    if dynamic:                         # one overflowing step, skipped
        grads[1] = tree_map(lambda a: a * np.float32(np.inf), grads[1])
    mine, mtrace = _fp16_run(dynamic, grads, jax_side=False)
    ref, rtrace = _fp16_run(dynamic, grads, jax_side=True)
    assert mtrace == rtrace
    assert [o for o, _ in mtrace] == [False, dynamic, False, False]
    for a, b in zip(tree_leaves(mine.optimizer.masters),
                    tree_leaves(ref.optimizer.masters)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                   atol=1e-7 * np.abs(_np(b)).max())
    for p, m in zip(tree_leaves(mine.params), tree_leaves(
            mine.optimizer.masters)):
        assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(p.dtype))


def test_fp16_optimizer_skip_keeps_every_bit_and_halves_the_scale():
    params = _t(_tree_np(5), torch.bfloat16)
    fopt = FP16_Optimizer(FusedAdagrad(params, lr=1e-2),
                          dynamic_loss_scale=True,
                          dynamic_loss_args={"init_scale": 4.0})
    before = fopt.state_dict()
    bad = tree_map(lambda p: torch.full(p.shape, float("nan")), params)
    fopt.step(bad)
    assert fopt.overflow and fopt.loss_scale == 2.0
    after = fopt.state_dict()
    for a, b in zip(tree_leaves(after["optimizer"]), tree_leaves(
            before["optimizer"])):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    # a clean step moves the params; the state round-trips
    fopt.step(tree_map(lambda p: torch.ones(p.shape) * fopt.loss_scale,
                       params))
    assert not fopt.overflow
    sd = fopt.state_dict()
    assert sd["dynamic"] and sd["cur_iter"] == 2
    other = FP16_Optimizer(FusedAdagrad(_t(_tree_np(5), torch.bfloat16),
                                        lr=1e-2))
    other.load_state_dict(sd)
    assert isinstance(other.loss_scaler, DynamicLossScaler)
    assert other.loss_scale == fopt.loss_scale
    assert (other.loss_scaler.cur_iter, other.loss_scaler.last_overflow_iter
            ) == (2, 0)
    for a, b in zip(tree_leaves(other.optimizer.masters),
                    tree_leaves(fopt.optimizer.masters)):
        assert torch.equal(a, b)
    grads = tree_map(lambda p: torch.ones(p.shape) * fopt.loss_scale, params)
    other.step(grads)
    fopt.step(grads)
    for a, b in zip(tree_leaves(other.params), tree_leaves(fopt.params)):
        assert torch.equal(a, b)
    fopt.zero_grad()


def test_clip_master_grads_on_packed_grads():
    """The legacy path's clip: on the optimizer plan's packed f32 grads,
    one flat_l2norm and one flat_scale per bucket; in the plan's layout
    out; the same clip as the tree path."""
    params = _t(_tree_np(6), torch.bfloat16)
    fopt = FP16_Optimizer(FusedAdagrad(params, lr=1e-2))
    g = _t(_tree_np(7))
    packed = fopt.optimizer._plan.pack_grads(g)
    clipped, norm = fopt.clip_master_grads(packed, 0.5)
    tree_clipped, tree_norm = fopt.clip_master_grads(g, 0.5)
    assert fopt.optimizer._plan.is_packed(clipped)
    np.testing.assert_allclose(float(norm), float(tree_norm), rtol=1e-6)
    unpacked = fopt.optimizer._plan.unpack_grads(clipped)
    for a, b in zip(tree_leaves(unpacked), tree_leaves(tree_clipped)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# the slice: GPT block training with FusedNovoGrad and the clip
# ---------------------------------------------------------------------------

STEPS = 3
NOVO = dict(lr=1e-3)
MAX_NORM = 1.0


def _jax_novograd_run(jp, opt_level, dtype, tokens):
    jm, _ = _models(dtype)
    params, amp_state = jamp.initialize(jp, opt_level=opt_level)
    opt = JNovoGrad(params, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **NOVO)
    pipe = amp_state.flat_pipeline(optimizer=opt, max_grad_norm=MAX_NORM)
    grads_of = jax.jit(functools.partial(
        pipe.scaled_value_and_grad, lambda p, t: _jloss(jm, p, t)))
    losses, norms = [], []
    for _ in range(STEPS):
        loss, flat = grads_of(amp_state.scaler, opt.params,
                              jnp.asarray(tokens))
        opt.step(flat)
        amp_state = jamp.update_scaler(amp_state, flat.found_inf)
        losses.append(loss)
        norms.append(flat.grad_norm)
    work = opt.masters if opt.masters is not None else opt.params
    return ([float(x) for x in losses], [float(x) for x in norms],
            [_np(w) for w in jax.tree_util.tree_leaves(work)])


@pytest.mark.parametrize("opt_level,dtype", [("O0", "float32"),
                                             ("O2", "bfloat16")])
def test_gpt_block_novograd_with_clip_matches_jax(opt_level, dtype):
    jp = _jax_params()
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    tokens = _tokens()
    jl, jn, jw = _jax_novograd_run(jp, opt_level, dtype, tokens)
    _, tm = _models(dtype)
    params, amp_state = tamp.initialize(
        gpt_block_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        opt_level=opt_level, device="cpu")
    opt = FusedNovoGrad(params, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **NOVO)
    pipe = amp_state.flat_pipeline(optimizer=opt, max_grad_norm=MAX_NORM)
    wrapped = amp_state.wrap_forward(
        lambda p, t: ex.next_token_loss(tm(p, t), t), cast_argnums=())
    tt = torch.from_numpy(tokens).long()
    losses, norms = [], []
    for _ in range(STEPS):
        loss, flat = pipe.scaled_value_and_grad(wrapped, amp_state.scaler,
                                                opt.params, tt)
        opt.step(flat)
        amp_state = tamp.update_scaler(amp_state, flat.found_inf)
        losses.append(float(loss))
        norms.append(float(flat.grad_norm))
    assert min(norms) > MAX_NORM and min(jn) > MAX_NORM   # the clip is on
    loss_tol, disp_tol = {"O0": (1e-5, 1e-4), "O2": (1e-3, 0.2)}[opt_level]
    np.testing.assert_allclose(losses, jl, rtol=loss_tol)
    assert losses[-1] < losses[0]
    work = opt.masters if opt.masters is not None else opt.params
    tw = [_np(w) for w in tree_leaves(work)]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(tw, jw))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(jw, init))
    assert np.sqrt(num / den) <= disp_tol, np.sqrt(num / den)
    state = opt.state_dict()["state"]
    assert all(v.shape == () and bool(v > 0)
               for v in tree_leaves(state["exp_avg_sq"]))
    assert len(tree_leaves(state["exp_avg_sq"])) == len(init)
