"""The port's fused attention dropout against the JAX package's.

The reference drops attention probabilities with a counter hash of
(seed, flat b*h row, q row, key) that every kernel rebuilds
(``apex_tpu.ops.attention._keep_mask``).  Here, on the same numpy
inputs made from a seed:

- ``dropout_keep_ref`` against the JAX one bit for bit (seeds 0, 5, -7
  and 2**31 - 2; rates 0.1, 0.25, 0.5, 0.9; B*H up to 70000), from a
  Python int and from a one-element int32 tensor;
- the twins ``flash_fwd_ref`` / ``flash_bwd_ref`` with a rate and seed
  against ``_fwd_pallas(need_lse=True)`` / ``_bwd_pallas`` (interpret
  mode, as the JAX package's own tests run them): causal, grouped-query
  heads, packed segment ids, f32 and bf16;
- ``flash_attention`` with dropout under autograd against ``jax.grad``
  of the JAX one;
- the three branches of ``attention_core`` against the JAX ones;
- ``SelfMultiheadAttn(dropout=0.4)`` against flax, the port handed the
  seed the flax module folds from its key (``dropout_seed_from_key``):
  the same seed gives the same dropped pairs, another seed others, and
  eval drops nothing;
- the head dim 96 (padded to the kernels' 128 on the card): the JAX
  ``flash_attention`` at D 96 against the port's CPU path.

Tolerances (each with its reason): f32 within 1e-5 of each output's
scale (the two sum the same products in another order); bf16 within
2**-7 of the scale (one bf16 rounding of p or ds can flip on a last-bit
f32 difference, as in ``test_torch_port_flash_bwd.py``); lse within
1e-5; the keep masks exactly; one function run twice on the CPU within
1e-6 (``SAME``: the CPU's BLAS may sum in another order from call to
call under load).  The modules' tolerances are
``test_torch_port_multihead_attn.py``'s: outputs and probabilities
1e-5 of their scale, gradients 1e-4 of each leaf's scale floored at
1e-2 of the largest.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.multihead_attn._common as jcommon
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JMHA
from apex_tpu.ops import attention as jattn
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
from apex_tpu_torch.contrib.multihead_attn._common import attention_core
from apex_tpu_torch.convert import gpt_block_from_jax
from apex_tpu_torch.ops import attention as tattn

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
SAME = dict(rtol=1e-6, atol=1e-6)
SEEDS = (0, 5, -7, 2 ** 31 - 2)
RATES = (0.1, 0.25, 0.5, 0.9)

CASES = {
    # name: (b, h, hk, s, d, causal, packed segment ids, dtype, rate, seed)
    "causal_f32": (2, 2, 2, 64, 32, True, False, "f32", 0.25, 5),
    "gqa_causal_s72_f32": (2, 4, 2, 72, 16, True, False, "f32", 0.1, -7),
    "packed_f32": (2, 2, 2, 60, 16, False, True, "f32", 0.5, 2 ** 31 - 2),
    "gqa_packed_bf16": (1, 4, 2, 96, 64, True, True, "bf16", 0.1, 0),
    "non_causal_bf16": (1, 2, 2, 48, 32, False, False, "bf16", 0.9, 11),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, floor=1e-30):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _seg(b, s):
    """(B, S) base ids: two packed sequences and a pad tail."""
    seg = np.zeros((b, s), np.int32)
    seg[:, : s // 3] = 1
    seg[:, s // 3: s - s // 5] = 2
    return seg


def _inputs(name):
    b, h, hk, s, d, causal, packed, dt, rate, seed = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))]
    seg = _seg(b, s) if packed else None
    return arrs, causal, seg, dt, rate, seed


def _j(x, dt):
    return jnp.asarray(x).astype(DT[dt][0])


def _t(x, dt):
    return torch.from_numpy(np.array(x, np.float32)).to(DT[dt][1])


def _segs(seg):
    if seg is None:
        return None, None
    return (jattn.packed_segment_ids(jnp.asarray(seg)),
            tattn.packed_segment_ids(torch.from_numpy(seg)))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_keep_ref_matches_jax_bit_for_bit(seed, rate):
    want = np.asarray(jattn.dropout_keep_ref(seed, 2, 3, 17, 70, rate))
    got = tattn.dropout_keep_ref(seed, 2, 3, 17, 70, rate)
    assert got.dtype == torch.bool and tuple(got.shape) == (2, 3, 17, 70)
    np.testing.assert_array_equal(got.numpy(), want)
    as_tensor = tattn.dropout_keep_ref(
        torch.tensor([seed], dtype=torch.int32), 2, 3, 17, 70, rate)
    assert torch.equal(as_tensor, got)
    assert abs(float(got.float().mean()) - (1.0 - rate)) < 0.05


def test_dropout_keep_ref_matches_jax_at_a_large_flat_row():
    """B*H = 70000: the flat row's product wraps in 32 bits on both
    sides (and would overflow a 16-bit grid dimension)."""
    want = np.asarray(jattn.dropout_keep_ref(-7, 70000, 1, 2, 3, 0.25))
    got = tattn.dropout_keep_ref(-7, 70000, 1, 2, 3, 0.25)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_threshold_and_scale_are_the_references():
    for rate in RATES + (1e-9, 0.999999):
        assert tattn.keep_threshold(rate) == min(
            int((1.0 - rate) * 4294967296.0), 4294967295)
        assert np.float32(tattn.keep_scale(rate)) == np.float32(
            1.0 / (1.0 - rate))
    assert tattn.keep_threshold(0.0) == 2 ** 32 - 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_fwd_twin_with_dropout_matches_pallas_fwd(name):
    (q, k, v, _), causal, seg, dt, rate, seed = _inputs(name)
    jseg, tseg = _segs(seg)
    sc = 1.0 / np.sqrt(q.shape[-1])
    jo, jlse = jattn._fwd_pallas(_j(q, dt), _j(k, dt), _j(v, dt), sc,
                                 causal, jseg, need_lse=True, rate=rate,
                                 seed=jnp.int32(seed))
    to, tlse = tattn.flash_fwd_ref(_t(q, dt), _t(k, dt), _t(v, dt), causal,
                                   sc, tseg, rate, seed)
    assert to.dtype == DT[dt][1]
    _close(to, jo, TOL[dt])
    s = q.shape[2]
    # lse sums the undropped probabilities: the same as without dropout
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :s, 0],
                               rtol=1e-5, atol=1e-5)
    _, plain_lse = tattn.flash_fwd_ref(_t(q, dt), _t(k, dt), _t(v, dt),
                                       causal, sc, tseg)
    torch.testing.assert_close(tlse, plain_lse, **SAME)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_twin_with_dropout_matches_pallas_bwd(name):
    (q, k, v, do), causal, seg, dt, rate, seed = _inputs(name)
    jseg, tseg = _segs(seg)
    sc = 1.0 / np.sqrt(q.shape[-1])
    s = q.shape[2]
    jo, jlse = jattn._fwd_pallas(_j(q, dt), _j(k, dt), _j(v, dt), sc,
                                 causal, jseg, need_lse=True, rate=rate,
                                 seed=jnp.int32(seed))
    lse = np.array(jlse)[:, :s, 0]
    want = jattn._bwd_pallas(_j(q, dt), _j(k, dt), _j(v, dt), jo,
                             jnp.asarray(lse), _j(do, dt), sc, causal, jseg,
                             rate=rate, seed=jnp.int32(seed))
    got = tattn.flash_bwd_ref(_t(q, dt), _t(k, dt), _t(v, dt),
                              _t(_np(jo), dt), torch.from_numpy(lse),
                              _t(do, dt), causal, sc, tseg, rate,
                              torch.tensor([seed], dtype=torch.int32))
    for g, w in zip(got, want):
        assert g.dtype == DT[dt][1]
        _close(g, w, TOL[dt])


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_with_dropout_grads_match_jax_grad(name):
    (q, k, v, w), causal, seg, dt, rate, seed = _inputs(name)
    jseg, tseg = _segs(seg)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, segment_ids=jseg,
                                  dropout_rate=rate, dropout_seed=seed)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jo = jattn.flash_attention(_j(q, dt), _j(k, dt), _j(v, dt),
                               causal=causal, segment_ids=jseg,
                               dropout_rate=rate, dropout_seed=seed)
    jgrad = jax.grad(jloss, argnums=(0, 1, 2))
    jg = jgrad(_j(q, dt), _j(k, dt), _j(v, dt))
    tq, tk, tv = (_t(x, dt).requires_grad_() for x in (q, k, v))
    to = tattn.flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg,
                               dropout_rate=rate, dropout_seed=seed)
    (to.float() * torch.from_numpy(w)).sum().backward()
    _close(to, jo, TOL[dt])
    for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(g, want, TOL[dt])


def test_flash_attention_dropout_arguments_are_the_references():
    """A rate above 0 needs a seed and a rate outside [0, 1) raises, as
    in the reference; an int and a one-element int32 tensor give the
    same bits, and a seed tensor of another dtype, size or device raises
    (it would be a fresh copy, not the caller's buffer); rate 0 ignores
    the seed."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 24, 16))
                                .astype(np.float32)) for _ in range(3))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tattn.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tattn.flash_attention(q, k, v, dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="int32"):
        tattn.flash_attention(q, k, v, dropout_rate=0.1,
                              dropout_seed=2 ** 31)
    for bad in (torch.tensor([9]), torch.tensor([9, 10], dtype=torch.int32),
                torch.tensor([9], dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="one int32 on cpu"):
            tattn.flash_attention(q, k, v, dropout_rate=0.1,
                                  dropout_seed=bad)
    a = tattn.flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=9)
    b = tattn.flash_attention(q, k, v, dropout_rate=0.3,
                              dropout_seed=torch.tensor(9, dtype=torch.int32))
    torch.testing.assert_close(a, b, **SAME)
    assert not torch.allclose(a, tattn.flash_attention(
        q, k, v, dropout_rate=0.3, dropout_seed=10))
    torch.testing.assert_close(tattn.flash_attention(q, k, v),
                               tattn.flash_attention(q, k, v, dropout_seed=9),
                               **SAME)


@pytest.mark.parametrize("branch", ["flash", "masked", "weights"])
def test_attention_core_with_dropout_matches_jax(branch):
    """Each branch of ``attention_core`` with dropout 0.3 against the
    JAX one at the seed it folds from its key; the weights returned are
    the undropped probabilities on both sides."""
    b, h, t, d = 2, 4, 20, 8
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    kpm = None
    if branch == "masked":
        kpm = np.arange(t)[None, :] >= np.asarray([t, t - 6])[:, None]
    need_weights = branch == "weights"
    key = jax.random.key(4)
    seed = int(jattn.dropout_seed_from_key(key))
    jout, jprobs = jcommon.attention_core(
        *(jnp.asarray(x) for x in (q, k, v)), causal=branch != "masked",
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        mask_additive=False, dropout_rate=0.3, dropout_rng=key,
        need_weights=need_weights)
    out, probs = attention_core(
        *(torch.from_numpy(x) for x in (q, k, v)),
        causal=branch != "masked",
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        mask_additive=False, dropout_rate=0.3, dropout_seed=seed,
        need_weights=need_weights)
    _close(out, jout, 1e-5)
    assert (probs is None) == (jprobs is None) == (not need_weights)
    if need_weights:
        _close(probs, jprobs, 1e-5)
        plain, _ = attention_core(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
            key_padding_mask=None, mask_additive=False, need_weights=False)
        assert not torch.allclose(out, plain)
    with pytest.raises(ValueError, match="dropout_seed"):
        attention_core(*(torch.from_numpy(x) for x in (q, k, v)),
                       causal=False, key_padding_mask=None,
                       mask_additive=False, dropout_rate=0.3,
                       need_weights=need_weights)


T, B, E, H = 12, 2, 32, 4


def _flax_seeds(monkeypatch):
    """Record each int32 seed the flax module folds from its dropout key
    (the reference's one fold, ``dropout_seed_from_key``)."""
    seen = []
    fold = jcommon.dropout_seed_from_key

    def recording(key):
        s = fold(key)
        seen.append(int(s))
        return s

    monkeypatch.setattr(jcommon, "dropout_seed_from_key", recording)
    return seen


@pytest.mark.parametrize("call", ["flash_causal", "masked", "weights"])
def test_self_multihead_attn_dropout_matches_flax(monkeypatch, call):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((T, B, E)).astype(np.float32)
    w = rng.standard_normal((T, B, E)).astype(np.float32)
    kpm = None
    if call == "masked":
        kpm = np.arange(T)[None, :] >= np.asarray([T, T - 5])[:, None]
    kw = dict(need_weights=call == "weights",
              attn_mask="causal" if call == "flash_causal" else None)
    jm = JMHA(E, H, dropout=0.4, bias=True, include_norm_add=True)
    jp = jm.init(jax.random.key(0), jnp.asarray(x),
                 is_training=False)["params"]
    seeds = _flax_seeds(monkeypatch)
    jkw = dict(kw, key_padding_mask=None if kpm is None else jnp.asarray(kpm))

    def jloss(p, q, key):
        out, _ = jm.apply({"params": p}, q, rngs={"dropout": key}, **jkw)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x), jax.random.key(7))
    seed = seeds[-1]
    tm = SelfMultiheadAttn(E, H, dropout=0.4, bias=True,
                           include_norm_add=True)
    tp = tree_map(lambda t: t.requires_grad_(), gpt_block_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    tq = torch.from_numpy(x).requires_grad_()
    tkw = dict(kw, key_padding_mask=None if kpm is None
               else torch.from_numpy(kpm))
    out, _ = tm(tp, tq, dropout_seed=seed, **tkw)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout, 1e-5)
    pgrads = tree_leaves(gpt_block_from_jax(
        jax.tree_util.tree_map(np.asarray, jg[0]), "cpu"))
    floor = 1e-2 * max(float(np.abs(_np(g)).max()) for g in pgrads)
    for got, want in zip(tree_leaves(tp), pgrads):
        _close(got.grad, want, 1e-4, floor)
    _close(tq.grad, jg[1], 1e-4)

    # another seed drops other pairs; eval drops none
    with torch.no_grad():
        again, _ = tm(tp, tq, dropout_seed=seed, **tkw)
        other, _ = tm(tp, tq, dropout_seed=seed + 1, **tkw)
        evald, _ = tm(tp, tq, is_training=False, **tkw)
    torch.testing.assert_close(again, out.detach(), **SAME)
    assert not torch.allclose(other, again)
    jeval, _ = jm.apply({"params": jp}, jnp.asarray(x), is_training=False,
                        **jkw)
    _close(evald, jeval, 1e-5)


def test_self_multihead_attn_draws_its_seed_from_a_generator():
    """With no seed given, one int32 is drawn from the generator a call:
    the same generator state gives the same output, the next draw
    another; no generator and no seed in training raises."""
    tm = SelfMultiheadAttn(E, H, dropout=0.3)
    p = tm.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(T, B, E, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(5)
    first, _ = tm(p, x, generator=g)
    second, _ = tm(p, x, generator=g)
    again, _ = tm(p, x, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(first, again, **SAME)
    assert not torch.allclose(first, second)
    drawn = int(torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(5)))
    torch.testing.assert_close(first, tm(p, x, dropout_seed=drawn)[0],
                               **SAME)
    with pytest.raises(ValueError, match="generator or a dropout_seed"):
        tm(p, x)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_dim_96_matches_jax(dt):
    """D 96 (``SelfMultiheadAttn(768, 8)``'s heads): the JAX flash
    attention pads it to its lanes; the port's CPU path computes it as
    is (on the card the wrapper pads it to the kernels' 128).  Output
    and gradients, causal, with and without dropout."""
    rng = np.random.default_rng(96)
    q, k, v, w = (rng.standard_normal((1, 2, 40, 96)).astype(np.float32)
                  for _ in range(4))
    for rate in (0.0, 0.2):
        kw = dict(causal=True, dropout_rate=rate,
                  dropout_seed=3 if rate else None)

        def jloss(q, k, v):
            o = jattn.flash_attention(q, k, v, **kw)
            return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w)), o

        (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
            _j(q, dt), _j(k, dt), _j(v, dt))
        tq, tk, tv = (_t(x, dt).requires_grad_() for x in (q, k, v))
        to = tattn.flash_attention(tq, tk, tv, **kw)
        (to.float() * torch.from_numpy(w)).sum().backward()
        _close(to, jo, TOL[dt])
        for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
            _close(g, want, TOL[dt])
