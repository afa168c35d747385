"""The port's kernels and engine on the card (skipped without one).

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has only PyTorch:

    python -m pytest --noconftest -q tests/torch_port/test_torch_port_cuda.py

The flash-attention kernel is held against its plain PyTorch version
(``flash_attention_ref``) on the same inputs, f32 with TF32 off,
``atol=rtol=1e-4`` (the kernel sums each row in its own order and uses
the online softmax).  The engine on the card must give the CPU
engine's greedy tokens and must not sync the host inside a window.
Under autograd the forward with lse and the dq, dk/dv kernels are held
against ``flash_fwd_ref``/``flash_bwd_ref`` (bf16 within one bf16
rounding, 2e-2; f32 1e-4) and must give the same bits twice; the flat
kernels of the training paths against their twins (tolerances by the
kernels' sections below); a GPT block step must not sync the host.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import serving
from apex_tpu_torch.ops import attention as attn

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _seg(kind, b, s, device):
    base = np.zeros((b, s), np.int32)
    if kind == "ragged":            # prefill's padded tails
        for i, n in enumerate([s, max(1, s // 3)] * b):
            if i < b:
                base[i, :n] = 1
    else:                           # two packed sequences + a pad tail
        base[:, : s // 3] = 1
        base[:, s // 3: s - s // 5] = 2
    return attn.packed_segment_ids(torch.from_numpy(base).to(device))


KERNEL_CASES = {
    # name: (b, h, hk, sq, sk, d, causal, seg kind)
    "gpt2_prefill_ragged": (2, 12, 12, 300, 300, 64, True, "ragged"),
    "gqa": (2, 12, 4, 130, 130, 64, True, "ragged"),
    "non_causal_packed": (2, 4, 4, 97, 97, 32, False, "packed"),
    "below_one_block": (3, 2, 2, 5, 5, 16, True, None),
    "d128": (1, 4, 2, 70, 70, 128, True, "packed"),
    "cross_lengths": (1, 2, 2, 33, 71, 64, False, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_matches_plain_on_card(cuda, name):
    b, h, hk, sq, sk, d, causal, kind = KERNEL_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(b, h, sq, d, generator=g, device=cuda)
    k = torch.randn(b, hk, sk, d, generator=g, device=cuda)
    v = torch.randn(b, hk, sk, d, generator=g, device=cuda)
    seg = None if kind is None else _seg(kind, b, sq, cuda)
    before = attn.FLASH_FWD.launches
    got = attn.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert attn.FLASH_FWD.launches == before + 1
    want = attn.flash_attention_ref(q, k, v, causal=causal,
                                    segment_ids=seg)
    torch.testing.assert_close(got, want, **TOL)
    if seg is not None:
        pad = (seg[0] < 0)[:, None, :, None].expand_as(got)
        assert torch.all(got[pad] == 0.0)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    q8 = q[..., :8].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_attention(q8, q8, q8)
    with pytest.raises(TypeError, match="float32"):
        attn.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                             q, q)


CFG = serving.DecoderConfig(vocab_size=64, hidden=64, n_layers=2,
                            n_heads=4, n_kv_heads=2, ffn=128, max_seq=32,
                            eos_token=1)
GEOM = dict(page_size=4, n_pages=16, max_slots=2, pages_per_slot=4,
            window=4, prefill_buckets=[4, 8])
REQUESTS = [dict(id="a", prompt=[5, 6, 7], max_new_tokens=6),
            dict(id="b", prompt=[9, 10], max_new_tokens=5),
            dict(id="c", prompt=[3, 4, 5, 6, 7, 8, 9, 10],
                 max_new_tokens=7),
            dict(id="d", prompt=[11], max_new_tokens=3)]


def _params(device):
    return serving.init_params(CFG, torch.Generator().manual_seed(0),
                               device=device)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_and_launches_the_kernel(cuda):
    want = serving.Engine(_params("cpu"), CFG, device="cpu", **GEOM)
    got = serving.Engine(_params(cuda), CFG, device=cuda, **GEOM)
    for r in REQUESTS:
        want.submit(serving.Request(**r))
        got.submit(serving.Request(**r))
    before = attn.FLASH_FWD.launches
    gr, wr = got.serve(), want.serve()
    assert attn.FLASH_FWD.launches - before == \
        len(REQUESTS) * CFG.n_layers
    for rid in wr:
        assert gr[rid].verdict == serving.COMPLETED
        assert gr[rid].tokens == wr[rid].tokens, rid
    got.arena.check_accounting()


@pytest.mark.cuda
def test_decode_window_never_syncs_the_host(cuda):
    eng = serving.Engine(_params(cuda), CFG, device=cuda, **GEOM)
    eng.submit(serving.Request(id="a", prompt=[5, 6, 7], max_new_tokens=8))
    eng._admit()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.programs.decode(eng.params, eng.state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(eng.state.n_out.sum()) == eng.window


# ---------------------------------------------------------------------------
# the flat kernels of the training path (csrc/multi_tensor.cu)
# ---------------------------------------------------------------------------
#
# Each kernel against its plain twin on the same card inputs.  The
# accumulate and unscale kernels round exactly where their twins do, so
# their elementwise outputs must agree to the bit; the sum of squares is
# summed in another order (rtol 1e-5).  flat_sgd multiplies by the
# reciprocal of grad_scale where the twin divides: at grad_scale 1 they
# agree to the bit, at 1024 within f32 rounding (rtol 1e-6, atol 1e-7).

from apex_tpu_torch.ops import multi_tensor as mt  # noqa: E402

SIZES = [1, 3, 4, 1027, 70001]


def _vec(n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=g, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_flat_accumulate_matches_plain_on_card(cuda, n, gdt, poison):
    acc = _vec(n, torch.float32, cuda, 1)
    g = _vec(n, gdt, cuda, 2)
    if poison:
        g[n // 2] = float(poison)
    want, wflag = mt.flat_accumulate_ref(acc, g, 0.5)
    before = mt.ACCUMULATE.launches
    got, flag = mt.flat_accumulate(acc, g, 0.5)
    torch.cuda.synchronize()
    assert mt.ACCUMULATE.launches == before + 1
    assert got is acc
    torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
    assert int(flag) == int(wflag) == (poison is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_flat_unscale_norm_matches_plain_on_card(cuda, n, poison):
    x = _vec(n, torch.float32, cuda, 3)
    if poison:
        x[n - 1] = float(poison)
    inv = torch.tensor(1.0 / 1024, device=cuda)
    want = mt.flat_unscale_norm_ref(x, inv)
    before = mt.UNSCALE_NORM.launches
    out, nsq, flag = mt.flat_unscale_norm(x, inv)
    torch.cuda.synchronize()
    assert mt.UNSCALE_NORM.launches == before + 1
    torch.testing.assert_close(out, want[0], atol=0, rtol=0, equal_nan=True)
    assert int(flag) == int(want[2]) == (poison is not None)
    if poison is None:
        torch.testing.assert_close(nsq, want[1], rtol=1e-5, atol=0)
    # a fixed grid and a fixed combine order: the same bits every run
    assert torch.equal(mt.flat_unscale_norm(x, inv)[1], nsq) or poison


SGD_CASES = {
    # name: (p dtype, g dtype, momentum, dampening, nesterov, first, gs)
    "f32_momentum_first": (torch.float32, torch.float32, 0.9, 0.0, False,
                           True, 1.0),
    "f32_momentum": (torch.float32, torch.float32, 0.9, 0.0, False, False,
                     1.0),
    "bf16_grad_nesterov": (torch.float32, torch.bfloat16, 0.9, 0.0, True,
                           False, 1.0),
    "bf16_grad_nesterov_first": (torch.float32, torch.bfloat16, 0.9, 0.0,
                                 True, True, 1.0),
    "dampening_scaled": (torch.float32, torch.float32, 0.5, 0.25, False,
                         False, 1024.0),
    "no_momentum": (torch.float32, torch.float32, 0.0, 0.0, False, False,
                    1.0),
    "bf16_params": (torch.bfloat16, torch.bfloat16, 0.9, 0.0, False, False,
                    1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1027, 70001])
@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_flat_sgd_matches_plain_on_card(cuda, n, case):
    pdt, gdt, mom, damp, nest, first, gs = SGD_CASES[case]
    p = _vec(n, pdt, cuda, 4)
    g = _vec(n, gdt, cuda, 5)
    buf = _vec(n, torch.float32, cuda, 6)
    kw = dict(lr=0.1, momentum=mom, dampening=damp, weight_decay=1e-4,
              nesterov=nest, first_run=torch.tensor(first, device=cuda),
              grad_scale=torch.tensor(gs, device=cuda))
    want_p, want_b = mt.flat_sgd_ref(p, g, buf, **kw)
    before = mt.SGD.launches
    got_p, got_b = mt.flat_sgd(p.clone(), g, buf.clone(), **kw)
    torch.cuda.synchronize()
    assert mt.SGD.launches == before + 1
    tol = dict(atol=0, rtol=0) if gs == 1.0 else dict(atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(got_p, want_p, **tol)
    torch.testing.assert_close(got_b, want_b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
def test_flat_sgd_found_inf_gate_on_card(cuda, flag):
    """With the flag set the kernel writes nothing: p and buf keep their
    bits; with it clear the step lands."""
    n = 4099
    p, buf = _vec(n, torch.float32, cuda, 7), _vec(n, torch.float32, cuda, 8)
    g = _vec(n, torch.bfloat16, cuda, 9)
    p0, b0 = p.clone(), buf.clone()
    mt.flat_sgd(p, g, buf, lr=0.1, momentum=0.9, weight_decay=1e-4,
                first_run=False,
                found_inf=torch.tensor(flag, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(p, p0) == bool(flag)
    assert torch.equal(buf, b0) == bool(flag)


@pytest.mark.cuda
def test_flat_kernel_wrappers_reject_what_they_cannot_take(cuda):
    acc = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="float16"):
        mt.flat_accumulate(acc, torch.zeros(8, dtype=torch.float16,
                                            device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        mt.flat_accumulate(torch.zeros(9, device=cuda)[1:], acc)
    with pytest.raises(ValueError, match="elements"):
        mt.flat_sgd(acc, torch.zeros(4, device=cuda), acc.clone(), lr=0.1)
    with pytest.raises(TypeError, match="host read"):
        mt.flat_sgd(acc, acc.clone(), acc.clone(),
                    lr=torch.tensor(0.1, device=cuda))


@pytest.mark.cuda
def test_resnet18_o2_grad_accum_step_never_syncs_the_host(cuda):
    """One ResNet-18 O2 grad-accum step on the card, under the sync
    debugger: the flat kernels launch and nothing reads back."""
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp

    main_amp.train(arch="resnet18", opt_level="O2", batch=8, image=64,
                   steps=1, grad_accum=2, device=cuda, log=None)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in (mt.ACCUMULATE, mt.UNSCALE_NORM,
                                           mt.SGD)}

    def on_step(step):          # step 1 runs under the debugger
        torch.cuda.set_sync_debug_mode("error" if step == 0 else "default")

    try:
        res = main_amp.train(arch="resnet18", opt_level="O2", batch=8,
                             image=64, steps=2, grad_accum=2, device=cuda,
                             log=None, on_step=on_step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = {k.name: k.launches - counts[k.name]
           for k in (mt.ACCUMULATE, mt.UNSCALE_NORM, mt.SGD)}
    assert got == {"flat_accumulate": 4, "flat_unscale_norm": 2,
                   "flat_sgd": 2}
    assert all(np.isfinite(res.losses))


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_buckets", [True, False])
def test_fused_sgd_on_card_never_reaches_the_plain_twin(cuda, monkeypatch,
                                                        fuse_buckets):
    """On the card the bucketed step launches flat_sgd once per bucket and
    never calls flat_sgd_ref; with no bucket plan the optimizer raises
    rather than run the plain per-leaf step there."""
    from apex_tpu_torch.optimizers import FusedSGD

    def plain(*a, **k):
        raise AssertionError("flat_sgd_ref ran on the card")

    monkeypatch.setattr(mt, "flat_sgd_ref", plain)
    params = {"w": _vec(1027, torch.float32, cuda, 10).reshape(13, 79),
              "b": _vec(5, torch.float32, cuda, 11)}
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    if not fuse_buckets:
        with pytest.raises(ValueError, match="runs only on the CPU"):
            FusedSGD(params, fuse_buckets=False, **kw)
        return
    opt = FusedSGD(params, **kw)
    before = mt.SGD.launches
    opt.step({k: torch.ones_like(v) for k, v in params.items()})
    torch.cuda.synchronize()
    assert mt.SGD.launches - before == len(opt._plan.buckets) == 1


# ---------------------------------------------------------------------------
# training through flash attention (the GPT block and BERT's unmasked and
# packed batches), then the BERT path's LayerNorm, flat_l2norm, flat_lamb
# ---------------------------------------------------------------------------
#
# The LayerNorm kernels sum each row in a fixed shuffle tree, the twins
# in torch's order: f32 outputs within 1e-5 (rtol and atol), f32 dx
# within 1e-4, bf16 outputs and dx within one bf16 rounding (2e-2), dw
# and db (sums over the rows, f32) within 1e-4 of their scale.  The LAMB
# stages compute in the twin's order with every rounding explicit, and
# the trust ratios come from the same segment norms on both paths: the
# kernels must give the twin's bits (tolerance 0).  flat_l2norm sums in
# another order than the twin: rtol 1e-5, and the same bits every run.

from apex_tpu_torch.ops import layer_norm as ln  # noqa: E402


FLASH_TRAIN_CASES = {
    # name: (b, h, hk, s, d, causal, seg kind, dtype)
    "gpt_bf16_causal": (2, 12, 12, 256, 64, True, None, torch.bfloat16),
    "bert_bf16_packed": (2, 16, 16, 192, 64, False, "packed",
                         torch.bfloat16),
    "gqa_s200_f32": (2, 12, 4, 200, 64, True, "ragged", torch.float32),
    "d16_f32_packed": (1, 2, 2, 77, 16, True, "packed", torch.float32),
    "d128_bf16_gqa": (1, 4, 2, 130, 128, False, "ragged", torch.bfloat16),
    "d32_f32": (3, 2, 1, 64, 32, False, None, torch.float32),
}
# f32: the kernels sum in their own order (1e-4, the forward's bound);
# bf16: one bf16 rounding of each output, plus the forward's p rounded
# against the running row max where the twin rounds it against the final
# one (2e-2, the LayerNorm kernels' bf16 bound)
FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_TRAIN_CASES))
def test_flash_attention_gradients_on_card_match_the_twins(cuda, name):
    """Under autograd on the card: the forward with lse, then the dq and
    dk/dv kernels, each once, against the twins on the same inputs; rows
    that see no key give exact zeros; a second run gives the same bits."""
    b, h, hk, s, d, causal, kind, dt = FLASH_TRAIN_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, do = (torch.randn(b, n, s, d, generator=g, device=cuda).to(dt)
                   for n in (h, hk, hk, h))
    seg = None if kind is None else _seg(kind, b, s, cuda)
    counts = [kk.launches for kk in (attn.FLASH_FWD, attn.FLASH_DQ,
                                     attn.FLASH_DKV)]

    def run():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = attn.flash_attention(qq, kk, vv, causal=causal, segment_ids=seg)
        o.backward(do)
        return o.detach(), qq.grad, kk.grad, vv.grad

    got = run()
    torch.cuda.synchronize()
    assert [kk.launches - c for kk, c in zip(
        (attn.FLASH_FWD, attn.FLASH_DQ, attn.FLASH_DKV), counts)] == [1, 1, 1]
    wo, lse = attn.flash_fwd_ref(q, k, v, causal, None, seg)
    want = (wo,) + attn.flash_bwd_ref(q, k, v, got[0], lse, do, causal, None,
                                      seg)
    for a, w in zip(got, want):
        assert a.dtype == dt
        torch.testing.assert_close(a, w, **FLASH_TOL[dt])
    _, klse = attn._flash_fwd_cuda(q, k, v, causal, None, seg, True)
    torch.testing.assert_close(klse, lse, atol=1e-4, rtol=1e-5)
    if seg is not None:
        pad = seg[0] < 0                                  # (B, S)
        for t in got:
            assert torch.all(t.transpose(1, 2)[pad] == 0)
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_flash_attention_refuses_dropout_on_card(cuda):
    q = torch.randn(1, 2, 16, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attn.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1)


LN_CASES = {
    # name: (rows, h, x dtype, w dtype, rms)
    "bert_bf16": (4096, 1024, torch.bfloat16, torch.bfloat16, False),
    "f32": (300, 1024, torch.float32, torch.float32, False),
    "mixed": (77, 128, torch.bfloat16, torch.float32, False),
    "rms_bf16": (129, 4096, torch.bfloat16, torch.bfloat16, True),
    "rms_f32_wide": (9, 32768, torch.float32, torch.float32, True),
    "one_row": (1, 256, torch.float32, torch.bfloat16, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LN_CASES))
def test_layer_norm_kernels_match_plain_on_card(cuda, case):
    rows, h, xdt, wdt, rms = LN_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(12)
    x = (torch.randn(rows, h, generator=g, device=cuda) * 3 + 1).to(xdt)
    w = (torch.randn(h, generator=g, device=cuda) * 0.1 + 1).to(wdt)
    b = (torch.randn(h, generator=g, device=cuda) * 0.1).to(wdt)
    dy = torch.randn(rows, h, generator=g, device=cuda).to(xdt)
    f0, b0 = ln.LN_FWD.launches, ln.LN_BWD.launches
    y = ln._fwd_2d(x, w, b, 1e-5, rms)
    dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert (ln.LN_FWD.launches - f0, ln.LN_BWD.launches - b0) == (1, 1)
    wy = ln._fwd_2d_ref(x, w, b, 1e-5, rms)
    wdx, wdw, wdb = ln._bwd_2d_ref(x, w, dy, 1e-5, rms)
    half = xdt == torch.bfloat16
    torch.testing.assert_close(y, wy, **(dict(atol=2e-2, rtol=2e-2) if half
                                         else dict(atol=1e-5, rtol=1e-5)))
    torch.testing.assert_close(dx, wdx, **(dict(atol=2e-2, rtol=2e-2) if half
                                           else dict(atol=1e-4, rtol=1e-4)))
    for got, want in ((dw, wdw), (db, wdb)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    again = ln._bwd_2d(x, w, dy, 1e-5, rms)
    assert torch.equal(again[1], dw) and torch.equal(again[0], dx)


@pytest.mark.cuda
def test_fused_layer_norm_autograd_runs_the_kernels_on_card(cuda):
    x = torch.randn(6, 5, 256, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.ones(256, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(256, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    f0, b0 = ln.LN_FWD.launches, ln.LN_BWD.launches
    ln.fused_layer_norm(x, w, b).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (ln.LN_FWD.launches - f0, ln.LN_BWD.launches - b0) == (1, 1)
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln._fwd_2d(x.detach().half().reshape(-1, 256), w, b, 1e-5, False)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_l2norm_matches_plain_on_card(cuda, n, dtype):
    x = _vec(n, dtype, cuda, 13)
    before = mt.L2NORM.launches
    got = mt.flat_l2norm(x)
    torch.cuda.synchronize()
    assert mt.L2NORM.launches == before + 1
    torch.testing.assert_close(got, mt.flat_l2norm_ref(x), rtol=1e-5, atol=0)
    assert torch.equal(mt.flat_l2norm(x), got)


def _lamb_bucket(sizes, pdt, gdt, device):
    n = sum(sizes)
    p = _vec(n, pdt, device, 14)
    g = _vec(n, gdt, device, 15) * 1e-2
    m = _vec(n, torch.float32, device, 16) * 1e-3
    v = _vec(n, torch.float32, device, 17).abs() * 1e-4
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32),
        torch.tensor(sizes)).to(device)
    return p, g, m, v, seg


LAMB_CASES = {
    # name: (p dtype, g dtype, nvlamb, bias correction, clip, scale, wd)
    "masters_bf16_grads": (torch.float32, torch.bfloat16, False, True, 0.3,
                           1.0, 0.01),
    "f32_nvlamb_scaled": (torch.float32, torch.float32, True, True, 1.0,
                          1024.0, 0.01),
    "no_decay": (torch.float32, torch.bfloat16, False, False, 1.0, 1.0,
                 0.0),
    "bf16_params": (torch.bfloat16, torch.bfloat16, False, True, 0.5, 1.0,
                    0.01),
}


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[1], [3, 1024, 5], [70001, 4, 333]])
@pytest.mark.parametrize("case", sorted(LAMB_CASES))
def test_flat_lamb_matches_plain_on_card(cuda, sizes, case):
    pdt, gdt, nv, bc, clip, gs, wd = LAMB_CASES[case]
    p, g, m, v, seg = _lamb_bucket(sizes, pdt, gdt, cuda)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=wd,
              step=torch.tensor(3, dtype=torch.int32, device=cuda),
              bias_correction=bc, grad_scale=torch.tensor(gs, device=cuda),
              clip_coeff=torch.tensor(clip, device=cuda), use_nvlamb=nv)
    want = mt.flat_lamb_ref(p, g, m, v, seg, sizes, **kw)
    before = (mt.LAMB_MOMENTS.launches, mt.LAMB_APPLY.launches)
    got = mt.flat_lamb(p.clone(), g, m.clone(), v.clone(), seg, sizes, **kw)
    torch.cuda.synchronize()
    assert (mt.LAMB_MOMENTS.launches, mt.LAMB_APPLY.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
def test_flat_lamb_found_inf_gate_on_card(cuda, flag):
    p, g, m, v, seg = _lamb_bucket([4099, 7], torch.float32, torch.bfloat16,
                                   cuda)
    g[5] = float("nan")
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    mt.flat_lamb(p, g, m, v, seg, [4099, 7], lr=1e-3, beta1=0.9,
                 beta2=0.999, eps=1e-6, weight_decay=0.01,
                 found_inf=torch.tensor(flag, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    for a, b in ((p, p0), (m, m0), (v, v0)):
        assert torch.equal(a, b) == bool(flag)


@pytest.mark.cuda
def test_fused_lamb_on_card_never_reaches_the_plain_twin(cuda, monkeypatch):
    """The bucketed step runs one flat_l2norm, one stage 1 and one stage 2
    per bucket, never the twin, and reads nothing back to the host."""
    from apex_tpu_torch.optimizers import FusedLAMB

    def plain(*a, **k):
        raise AssertionError("a plain twin ran on the card")

    monkeypatch.setattr(mt, "flat_lamb_ref", plain)
    monkeypatch.setattr(mt, "flat_l2norm_ref", plain)
    params = {"w": _vec(1027, torch.bfloat16, cuda, 18).reshape(13, 79),
              "b": _vec(5, torch.bfloat16, cuda, 19)}
    opt = FusedLAMB(params, lr=1e-3, weight_decay=0.01)
    grads = {k: torch.ones_like(t) for k, t in params.items()}
    opt.step(grads, found_inf=torch.zeros((), dtype=torch.int32,
                                          device=cuda))
    torch.cuda.synchronize()
    before = [k.launches for k in (mt.L2NORM, mt.LAMB_MOMENTS,
                                   mt.LAMB_APPLY)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(grads, found_inf=torch.zeros((), dtype=torch.int32,
                                              device=cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    got = [k.launches - b for k, b in zip(
        (mt.L2NORM, mt.LAMB_MOMENTS, mt.LAMB_APPLY), before)]
    assert got == [len(opt._plan.buckets)] * 3 == [1, 1, 1]
    assert all(bool(torch.isfinite(t.float()).all())
               for t in opt.params.values())


# ---------------------------------------------------------------------------
# the GPT block path: flat_adam, FusedAdam, one training step
# ---------------------------------------------------------------------------
#
# flat_adam computes in the twin's order with every rounding explicit and
# reads the twin's bias corrections: the twin's bits exactly at a
# power-of-two grad scale (the kernel multiplies by the reciprocal where
# the twin divides).

ADAM_CASES = {
    # name: (p dtype, g dtype, adam_w_mode, bias_correction, grad scale)
    "masters_bf16_grads_adamw": (torch.float32, torch.bfloat16, True, True,
                                 1.0),
    "f32_adam_l2_scaled": (torch.float32, torch.float32, False, True,
                           1024.0),
    "no_bias_correction": (torch.float32, torch.bfloat16, True, False, 1.0),
    "bf16_params_l2_no_bc": (torch.bfloat16, torch.bfloat16, False, False,
                             65536.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1027, 70001])
@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_flat_adam_matches_plain_on_card(cuda, n, case):
    pdt, gdt, aw, bc, gs = ADAM_CASES[case]
    p, g = _vec(n, pdt, cuda, 22), _vec(n, gdt, cuda, 23) * 1e-2
    m = _vec(n, torch.float32, cuda, 24) * 1e-3
    v = _vec(n, torch.float32, cuda, 25).square() * 1e-5
    kw = dict(lr=torch.tensor(3e-4, device=cuda), beta1=0.9, beta2=0.999,
              eps=1e-8, weight_decay=0.01,
              step=torch.tensor(4, dtype=torch.int32, device=cuda),
              adam_w_mode=aw, bias_correction=bc,
              grad_scale=torch.tensor(gs, device=cuda))
    want = mt.flat_adam_ref(p, g, m, v, **kw)
    before = mt.ADAM.launches
    got = mt.flat_adam(p.clone(), g, m.clone(), v.clone(), **kw)
    torch.cuda.synchronize()
    assert mt.ADAM.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
def test_flat_adam_found_inf_gate_on_card(cuda, flag):
    """With the flag set the kernel writes nothing: p, m and v keep their
    bits; with it clear the step lands."""
    n = 4099
    p, m = _vec(n, torch.float32, cuda, 26), _vec(n, torch.float32, cuda, 27)
    v = _vec(n, torch.float32, cuda, 28).square()
    g = _vec(n, torch.bfloat16, cuda, 29)
    g[3] = float("inf")
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    mt.flat_adam(p, g, m, v, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 found_inf=torch.tensor(flag, dtype=torch.int32,
                                        device=cuda))
    torch.cuda.synchronize()
    for a, b in ((p, p0), (m, m0), (v, v0)):
        assert torch.equal(a, b) == bool(flag)


@pytest.mark.cuda
def test_fused_adam_on_card_never_reaches_the_plain_twin(cuda, monkeypatch):
    from apex_tpu_torch.optimizers import FusedAdam

    def plain(*a, **k):
        raise AssertionError("flat_adam_ref ran on the card")

    monkeypatch.setattr(mt, "flat_adam_ref", plain)
    params = {"w": _vec(1027, torch.bfloat16, cuda, 30).reshape(13, 79),
              "b": _vec(5, torch.bfloat16, cuda, 31)}
    opt = FusedAdam(params, lr=1e-3, weight_decay=0.01)
    before = mt.ADAM.launches
    opt.step({k: torch.ones_like(t) for k, t in params.items()})
    torch.cuda.synchronize()
    assert mt.ADAM.launches - before == len(opt._plan.buckets) == 1


@pytest.mark.cuda
def test_gpt_block_step_never_syncs_the_host(cuda):
    """One O2 step of a 2-layer GPT block stack on the card under the sync
    debugger, after a warm-up step: the kernels of the path launch their
    exact counts and nothing reads back."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import gpt_train_block as ex

    torch.backends.cuda.matmul.allow_tf32 = False
    model = ex.GPTBlocks(vocab=512, hidden=128, heads=4, layers=2,
                         max_seq=128)
    s = ex.setup(model, model.init(0, "cpu"), cuda)
    tokens = ex.synthetic_tokens(2, 64, 512, device=cuda)
    loss, state = s.step(s.amp_state, tokens)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, state = s.step(state, tokens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = {k.name: k.launches for k in _build.KERNELS if k.launches}
    assert got == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2,
                   "layer_norm_fwd": 5, "layer_norm_bwd": 5,
                   "flat_unscale_norm": 1, "flat_adam": 1}
    assert bool(torch.isfinite(loss))


@pytest.mark.cuda
def test_flash_attention_promotes_mixed_dtypes_on_card(cuda):
    """q bf16 with k, v f32: promoted to f32 before the kernel (the
    reference's rule), so the f32 kernel runs and matches the twin on the
    promoted inputs."""
    q = _vec(2 * 16 * 16, torch.bfloat16, cuda, 32).reshape(1, 2, 16, 16)
    k = _vec(2 * 16 * 16, torch.float32, cuda, 33).reshape(1, 2, 16, 16)
    v = _vec(2 * 16 * 16, torch.float32, cuda, 34).reshape(1, 2, 16, 16)
    got = attn.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    want = attn.flash_attention_ref(q.float(), k, v, causal=True)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the optimizer tail: flat_scale, flat_axpby, flat_adagrad, flat_novograd
# ---------------------------------------------------------------------------
#
# Each computes in its twin's order with every rounding explicit: the
# twin's bits exactly (Adagrad and NovoGrad at a power-of-two grad scale:
# the kernels multiply by the reciprocal where the twins divide).

IO_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
TAIL_SIZES = [1, 1027, 70001]


@pytest.mark.cuda
@pytest.mark.parametrize("n", TAIL_SIZES)
@pytest.mark.parametrize("odt", IO_DTYPES)
@pytest.mark.parametrize("xdt", IO_DTYPES)
def test_flat_scale_matches_plain_on_card(cuda, xdt, odt, n):
    x = _vec(n, xdt, cuda, 40)
    s = torch.tensor(0.37, device=cuda)
    want = mt.flat_scale_ref(x, s, odt)
    before = mt.SCALE.launches
    got = mt.flat_scale(x, s, odt)
    torch.cuda.synchronize()
    assert mt.SCALE.launches == before + 1
    assert got[0].dtype == odt
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    assert int(got[1]) == int(want[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("odt", IO_DTYPES)
@pytest.mark.parametrize("ydt", IO_DTYPES)
@pytest.mark.parametrize("xdt", IO_DTYPES)
def test_flat_axpby_matches_plain_on_card(cuda, xdt, ydt, odt):
    n = 70001
    x, y = _vec(n, xdt, cuda, 41), _vec(n, ydt, cuda, 42)
    a, b = torch.tensor(0.7, device=cuda), torch.tensor(-1.3, device=cuda)
    want = mt.flat_axpby_ref(a, x, b, y, odt)
    before = mt.AXPBY.launches
    got = mt.flat_axpby(a, x, b, y, odt)
    torch.cuda.synchronize()
    assert mt.AXPBY.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    assert int(got[1]) == int(want[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("where", [0, 70000])     # a vector, the tail
@pytest.mark.parametrize("poison", ["nan", "inf"])
@pytest.mark.parametrize("op", ["scale", "axpby"])
def test_scale_and_axpby_flag_a_planted_non_finite_on_card(cuda, op, poison,
                                                           where):
    x, y = _vec(70001, torch.float32, cuda, 43), _vec(70001, torch.bfloat16,
                                                      cuda, 44)
    x[where] = float(poison)
    got = (mt.flat_scale(x, 2.0, torch.bfloat16) if op == "scale"
           else mt.flat_axpby(1.0, x, 2.0, y))
    torch.cuda.synchronize()
    assert int(got[1]) == 1
    # a finite f32 result that rounds to inf in bf16 does not flag
    big = torch.full((5,), 3.4e38, device=cuda)
    out, flag = mt.flat_scale(big, 1.0, torch.bfloat16)
    assert bool(torch.isinf(out.float()).all()) and int(flag) == 0


PG_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", TAIL_SIZES)
@pytest.mark.parametrize("pg", range(len(PG_DTYPES)))
def test_flat_adagrad_matches_plain_on_card(cuda, pg, n):
    pdt, gdt = PG_DTYPES[pg]
    p, g = _vec(n, pdt, cuda, 45), _vec(n, gdt, cuda, 46) * 1e-2
    h = _vec(n, torch.float32, cuda, 47).square() * 1e-3
    kw = dict(lr=torch.tensor(1e-2, device=cuda), eps=1e-10,
              weight_decay=0.01, grad_scale=torch.tensor(1024.0,
                                                         device=cuda))
    want = mt.flat_adagrad_ref(p, g, h, **kw)
    before = mt.ADAGRAD.launches
    got = mt.flat_adagrad(p.clone(), g, h.clone(), **kw)
    torch.cuda.synchronize()
    assert mt.ADAGRAD.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


NOVO_SEGMENTS = [[1], [3, 1024, 5], [70001, 4, 333]]


@pytest.mark.cuda
@pytest.mark.parametrize("segments", range(len(NOVO_SEGMENTS)))
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("variant", range(16))
def test_flat_novograd_matches_plain_on_card(cuda, variant, first, segments):
    """Every dtype pair x grad_averaging x reg_inside_moment (the
    kernel's template variants), init_zero with them."""
    pdt, gdt = PG_DTYPES[variant % 4]
    avg, rim = bool(variant & 4), bool(variant & 8)
    sizes = NOVO_SEGMENTS[segments]
    n = sum(sizes)
    p, g = _vec(n, pdt, cuda, 48), _vec(n, gdt, cuda, 49) * 1e-2
    m = _vec(n, torch.float32, cuda, 50) * 1e-3
    v = _vec(len(sizes), torch.float32, cuda, 51).square() * 1e-2
    kw = dict(lr=torch.tensor(1e-2, device=cuda), beta1=0.95, beta2=0.98,
              eps=1e-8, weight_decay=0.01,
              first_run=torch.tensor(first, device=cuda),
              grad_averaging=avg, init_zero=bool(variant & 1),
              reg_inside_moment=rim,
              grad_scale=torch.tensor(4.0, device=cuda))
    want = mt.flat_novograd_ref(p, g, m, v, sizes, **kw)
    before = mt.NOVOGRAD.launches
    got = mt.flat_novograd(p.clone(), g, m.clone(), v.clone(), sizes,
                           seg_offsets=mt.segment_offsets(sizes, cuda), **kw)
    torch.cuda.synchronize()
    assert mt.NOVOGRAD.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("op", ["adagrad", "novograd"])
def test_tail_found_inf_gate_on_card(cuda, op, flag):
    """With the flag set p and the state keep every bit (NovoGrad's
    per-segment v too, which is computed outside the kernel); with it
    clear the step lands."""
    n = 4099
    p, m = _vec(n, torch.float32, cuda, 52), _vec(n, torch.float32, cuda, 53)
    g = _vec(n, torch.bfloat16, cuda, 54)
    g[3] = float("inf")
    gate = torch.tensor(flag, dtype=torch.int32, device=cuda)
    if op == "adagrad":
        bufs = (p, m.square())
        old = [t.clone() for t in bufs]
        mt.flat_adagrad(bufs[0], g, bufs[1], lr=1e-2, eps=1e-10,
                        found_inf=gate)
    else:
        bufs = (p, m, _vec(2, torch.float32, cuda, 55).square())
        old = [t.clone() for t in bufs]
        mt.flat_novograd(bufs[0], g, bufs[1], bufs[2], [4000, 99], lr=1e-2,
                         beta1=0.95, beta2=0.98, eps=1e-8, found_inf=gate,
                         seg_offsets=mt.segment_offsets([4000, 99], cuda))
    torch.cuda.synchronize()
    for a, b in zip(bufs, old):
        assert torch.equal(a, b) == bool(flag)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["FusedNovoGrad", "FusedAdagrad"])
def test_tail_optimizers_on_card_never_reach_the_twin_or_the_host(
        cuda, monkeypatch, name):
    """The bucketed step runs one kernel per bucket, never the plain twin,
    and (after a warm-up step) reads nothing back to the host."""
    from apex_tpu_torch import optimizers

    def plain(*a, **k):
        raise AssertionError("a plain twin ran on the card")

    for twin in ("flat_novograd_ref", "flat_adagrad_ref"):
        monkeypatch.setattr(mt, twin, plain)
    kern = {"FusedNovoGrad": mt.NOVOGRAD, "FusedAdagrad": mt.ADAGRAD}[name]
    params = {"w": _vec(1027, torch.bfloat16, cuda, 56).reshape(13, 79),
              "b": _vec(5, torch.bfloat16, cuda, 57)}
    opt = getattr(optimizers, name)(params, lr=1e-3, weight_decay=0.01)
    grads = {k: torch.ones_like(t) for k, t in params.items()}
    opt.step(grads, found_inf=torch.zeros((), dtype=torch.int32,
                                          device=cuda))
    torch.cuda.synchronize()
    before = kern.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(grads, found_inf=torch.zeros((), dtype=torch.int32,
                                              device=cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert kern.launches - before == len(opt._plan.buckets) == 1
    assert all(bool(torch.isfinite(t.float()).all())
               for t in opt.params.values())


@pytest.mark.cuda
def test_fp16_optimizer_clip_and_skip_on_card(cuda):
    """FP16_Optimizer over FusedAdagrad on the card: clip_master_grads on
    the packed grads launches flat_l2norm and flat_scale once a bucket;
    a non-finite step is skipped with every bit kept and the scale
    halved."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedAdagrad

    params = {"w": _vec(1027, torch.bfloat16, cuda, 58).reshape(13, 79),
              "b": _vec(5, torch.bfloat16, cuda, 59)}
    fopt = FP16_Optimizer(FusedAdagrad(params, lr=1e-2),
                          dynamic_loss_scale=True,
                          dynamic_loss_args={"init_scale": 2.0 ** 10})
    plan = fopt.optimizer._plan
    grads = plan.pack_grads({k: torch.ones_like(t, dtype=torch.float32)
                             for k, t in params.items()})
    before = (mt.L2NORM.launches, mt.SCALE.launches)
    clipped, norm = fopt.clip_master_grads(grads, 1.0)
    torch.cuda.synchronize()
    assert (mt.L2NORM.launches - before[0],
            mt.SCALE.launches - before[1]) == (1, 1)
    assert abs(float(norm) - 1032 ** 0.5) < 1e-3
    assert abs(float(torch.linalg.vector_norm(clipped[0])) - 1.0) < 1e-5
    scaled = [c * fopt.loss_scale for c in clipped]
    fopt.step(scaled)
    assert not fopt.overflow
    masters = [t.clone() for t in fopt.optimizer._master_bufs]
    scale = fopt.loss_scale
    bad = [s.clone() for s in scaled]
    bad[0][5] = float("nan")
    fopt.step(bad)
    assert fopt.overflow and fopt.loss_scale == scale / 2
    for a, b in zip(fopt.optimizer._master_bufs, masters):
        assert torch.equal(a, b)
