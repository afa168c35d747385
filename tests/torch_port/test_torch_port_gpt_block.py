"""The port's GPT block training (``apex_tpu_torch.examples.
gpt_train_block``) against the reference's ``examples/gpt/train_block.py``.

The example's CPU-size configuration (2 layers, hidden 128, 4 heads,
vocab 2048, seq 64, batch 2) is initialised by the flax ``GPTBlocks``
and handed to the port through ``convert.gpt_block_from_jax``; both see
the same numpy tokens.  The forward (f32 logits), the gradients of the
next-token loss, then three training steps wired as the reference's
``main()`` wires them (``amp.initialize``, ``FusedAdam`` lr 3e-4,
``amp.scaled_value_and_grad``, ``opt.step(found_inf=)``,
``amp.update_scaler``; the port's step takes the flat gradient layout,
which the reference's own tests hold equal to the tree layout).  The
causal attention runs the Pallas kernels in interpret mode on the
reference's side and the port's autograd flash attention with its plain
twins on the port's.

Tolerances (each with its reason):
- the model in f32 (``dtype=float32``): the two frameworks sum their
  matmuls in their own orders: logits within 1e-5 of their scale,
  gradients within 1e-4 of each leaf's scale; three O0 steps: losses
  within rtol 1e-5 and the params' displacement (final minus init)
  within 1e-4 of its norm (measured 4.1e-5: Adam's first steps move an
  element by about lr * sign(g), so elements whose gradient is near the
  sums' rounding move apart).  The key third of each qkv bias is left
  out of that norm and held on its own: its gradient is 0 in exact
  arithmetic (it shifts every score of a row alike), so on both sides
  Adam steps it by noise / (|noise| + eps), a different noise in each
  framework (it alone measured 4.2e-4); both must move it by no more
  than Adam's own bound on three steps, ``_adam_drift_bound`` (3.005 lr
  at the defaults, not 3 lr: from the second step on, bias-corrected
  Adam may step by more than lr);
- the model in bf16 (the reference's default ``GPTBlocks.dtype``): a
  different order flips bf16 roundings of activations: logits within
  2e-2 of their scale, gradients within 5e-2 of each leaf's scale; three
  O2 steps: losses within rtol 1e-3 and the masters' displacement within
  0.2 of its norm, the band PRs 3-4 measured for bf16 roundings that the
  optimizer then carries (a one-ulp change of the reference's own f32
  init moves its masters by 6-7e-2).
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
from apex_tpu_torch._tree import tree_flatten, tree_leaves, tree_map
from apex_tpu_torch.convert import gpt_block_from_jax
from apex_tpu_torch.examples import gpt_train_block as ex
from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan

_REF = os.path.join(os.path.dirname(__file__), "..", "..", "examples", "gpt",
                    "train_block.py")
CFG = dict(ex.CPU)                     # the reference's CPU widths
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STEPS = 3


@functools.lru_cache(maxsize=None)
def _ref_module():
    spec = importlib.util.spec_from_file_location("gpt_train_block_ref",
                                                  os.path.abspath(_REF))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # flax's dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def _models(dtype):
    jdt, tdt = DT[dtype]
    c = CFG
    jm = _ref_module().GPTBlocks(c["vocab"], c["hidden"], c["heads"],
                                 c["layers"], max_seq=max(c["seq"], 128),
                                 dtype=jdt)
    tm = ex.GPTBlocks(c["vocab"], c["hidden"], c["heads"], c["layers"],
                      max_seq=max(c["seq"], 128), dtype=tdt)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _jax_params():
    jm, _ = _models("float32")
    tokens = jnp.zeros((CFG["batch"], CFG["seq"]), jnp.int32)
    return jax.jit(jm.init)(jax.random.key(0), tokens)["params"]


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], (CFG["batch"], CFG["seq"])).astype(np.int32)


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _close_scaled(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _adam_drift_bound(lr, beta1, beta2, steps):
    """The most that ``steps`` bias-corrected Adam steps (no weight
    decay, as here) can move an element, whatever its gradients.

    Step t moves it by lr * |m_hat| / (sqrt(v_hat) + eps) with
    m_hat = sum_i a_i g_i / (1 - beta1^t), a_i = (1 - beta1) beta1^(t-i),
    v_hat = sum_i b_i g_i^2 / (1 - beta2^t), b_i = (1 - beta2) beta2^(t-i).
    Cauchy-Schwarz on sum_i (a_i / sqrt(b_i)) (sqrt(b_i) g_i) gives
    |sum_i a_i g_i| <= sqrt(sum_i a_i^2 / b_i) sqrt(sum_i b_i g_i^2), so
    the step is at most lr * r_t, r_t = sqrt(sum_i a_i^2 / b_i)
    * sqrt(1 - beta2^t) / (1 - beta1^t), reached when g_i is
    proportional to a_i / b_i (eps > 0 only shrinks it).  r_1 = 1, and at
    beta1 0.9, beta2 0.999, r_2 = 1.0014 and r_3 = 1.0036.  The lr is
    taken as the f32 value the step uses, and each step's f32 arithmetic
    (about eight roundings) may add 2^-24 of the step apiece."""
    lr = float(np.float32(lr))
    total = 0.0
    for t in range(1, steps + 1):
        i = np.arange(1, t + 1)
        a = (1 - beta1) * beta1 ** (t - i)
        b = (1 - beta2) * beta2 ** (t - i)
        r = (np.sqrt(np.sum(a * a / b)) * np.sqrt(1 - beta2 ** t)
             / (1 - beta1 ** t))
        total += lr * r * (1 + 8 * 2.0 ** -24)
    return total


def _jloss(jm, p, tokens):
    """The reference's loss_fn (examples/gpt/train_block.py:128-133)."""
    logits = jm.apply({"params": p}, tokens)
    labels = jnp.roll(tokens, -1, axis=1).T
    logp = jax.nn.log_softmax(logits)
    ll = jnp.take_along_axis(logp, labels[..., None], axis=-1)
    return -jnp.mean(ll[:-1])


def test_param_tree_matches_flax():
    """The port's init has the flax model's shapes in the flax order, and
    the converted tree is the port's tree with the flax values."""
    jp = _jax_params()
    _, tm = _models("float32")
    jl = jax.tree_util.tree_leaves(jp)
    mine, mdef = tree_flatten(tm.init(0, "cpu"))
    conv, cdef = tree_flatten(gpt_block_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    assert mdef == cdef
    assert [tuple(l.shape) for l in jl] == [tuple(t.shape) for t in mine]
    for a, b in zip(jl, conv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_full_width_o2_bucket_holds_124046592_params():
    """GPT-2 small's widths: 38,597,376 embedding + 393,216 positions +
    12 x 7,087,872 blocks + 1,536 final norm, in one O2 bucket."""
    c = ex.CARD
    jm = _ref_module().GPTBlocks(c["vocab"], c["hidden"], c["heads"],
                                 c["layers"], max_seq=max(c["seq"], 128))
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, c["seq"]), jnp.int32))["params"]
    want = [int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)]
    tm = ex.GPTBlocks(c["vocab"], c["hidden"], c["heads"], c["layers"],
                      max_seq=max(c["seq"], 128))
    params = tm.init(0, "cpu")
    assert [t.numel() for t in tree_leaves(params)] == want
    assert sum(want) == 124_046_592
    assert params["embed"].numel() == 38_597_376
    assert params["pos"].numel() == 393_216
    assert sum(t.numel() for t in tree_leaves(params["block0"])) == 7_087_872
    # amp O2's plan: the f32 masters (here the params themselves) over
    # the bf16 model params
    cast = tree_map(lambda t: t.to(torch.bfloat16), params)
    plan = BucketPlan.from_tree(params, cast)
    assert [b.size for b in plan.buckets] == [124_046_592]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_grads_match_jax(dtype):
    jdt, tdt = DT[dtype]
    jm, tm = _models(dtype)
    jp = _jax_params()
    tp = gpt_block_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tokens = _tokens()
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    logits = tm(tp, tt)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (CFG["seq"], CFG["batch"], CFG["vocab"])
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: _jloss(jm, p, jt)))(jp)
    _close_scaled(logits, jax.jit(lambda p: jm.apply({"params": p}, jt))(jp),
                  FWD_TOL[dtype])
    (loss, _), grads = tamp.value_and_grad(
        lambda p: ex.next_token_loss(tm(p, tt), tt), tp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_TOL[dtype])
    for g, want in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jg)):
        _close_scaled(g, want, GRAD_TOL[dtype])


def _jax_run(jp, opt_level, dtype, tokens):
    jm, _ = _models(dtype)
    params, amp_state = jamp.initialize(jp, opt_level=opt_level)
    opt = JAdam(params, lr=3e-4,
                master_weights=bool(amp_state.properties.master_weights),
                masters=amp_state.master_params)

    @jax.jit
    def step(p, scaler, t):
        return jamp.scaled_value_and_grad(
            lambda pp, tt: _jloss(jm, pp, tt), scaler, p, t)

    losses = []
    for _ in range(STEPS):
        loss, grads, found_inf = step(opt.params, amp_state.scaler,
                                      jnp.asarray(tokens))
        opt.step(grads, found_inf=found_inf)
        amp_state = jamp.update_scaler(amp_state, found_inf)
        losses.append(float(loss))
    work = opt.masters if opt.masters is not None else opt.params
    return losses, [_np(w) for w in jax.tree_util.tree_leaves(work)], \
        float(amp_state.scaler.loss_scale)


@pytest.mark.parametrize("opt_level,dtype", [("O0", "float32"),
                                             ("O2", "bfloat16")])
def test_training_steps_match_jax(opt_level, dtype):
    jp = _jax_params()
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    tokens = _tokens()
    jl, jw, jscale = _jax_run(jp, opt_level, dtype, tokens)
    _, tm = _models(dtype)
    s = ex.setup(tm, gpt_block_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"), "cpu",
        opt_level=opt_level, lr=3e-4)
    state, losses = s.amp_state, []
    tt = torch.from_numpy(tokens).long()
    for _ in range(STEPS):
        loss, state = s.step(state, tt)
        losses.append(float(loss))
    assert float(state.scaler.loss_scale) == jscale
    assert all(np.isfinite(losses))
    loss_tol, disp_tol = {"O0": (1e-5, 1e-4), "O2": (1e-3, 0.2)}[opt_level]
    np.testing.assert_allclose(losses, jl, rtol=loss_tol)
    opt = s.opt
    work = opt.masters if opt.masters is not None else opt.params
    tw = [np.array(_np(w)) for w in tree_leaves(work)]      # copies
    jw = [np.array(w) for w in jw]
    h = CFG["hidden"]
    for (path, _), a, b, o in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0], tw, jw, init):
        if "qkv_proj" in jax.tree_util.keystr(path) and a.ndim == 1:
            key = slice(h, 2 * h)           # the key bias: noise-driven
            for x in (a, b):
                assert np.abs(x[key] - o[key]).max() <= _adam_drift_bound(
                    3e-4, 0.9, 0.999, STEPS)
                x[key] = o[key]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(tw, jw))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(jw, init))
    assert np.sqrt(num / den) <= disp_tol, np.sqrt(num / den)
    if opt.masters is not None:
        for p, m in zip(tree_leaves(opt.params), tree_leaves(opt.masters)):
            assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(p.dtype))


def test_example_trains_on_cpu_and_refuses_offload():
    res = ex.train(steps=3, device="cpu", log=None)
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]        # one fixed batch: descent
    assert res.widths == CFG and res.tokens_per_sec > 0
    # --offload-activations remats each block with its ffn_hidden in host
    # memory: the same first loss as the plain step (f32 sums in the same
    # order; the recompute changes only the backward)
    off = ex.main(["--device", "cpu", "--offload-activations", "--steps",
                   "1"])
    np.testing.assert_allclose(off.losses, res.losses[:1], rtol=1e-6)
