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
dq and the LayerNorm backward are also held on each of their routes
(each flash kernel's by ``ops.attention.flash_route``: the tensor-core
forward, dq and dk/dv for bf16 at D 64, 128 and 256 and the wide
tensor-core ones from D 1024; the fused or three-launch LayerNorm
backward by
``bwd_route``), each read from the device kernels' names under
``torch.profiler``.  The flash bodies' dropout
instantiations are held against the twins at the same seed (FLASH_TOL),
their keep mask read out of the kernels bit for bit, and the inputs the
wrapper pads or copies (head dims 8, 80, 96, 8200; strided,
misaligned; B*H 65,600) with their gradients.
"""

import importlib.util
import re
from pathlib import Path

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
    """float64 raises; a head dim above 8192 (which raised before F7)
    pads to 16384 and runs, forward and gradients, one launch of each
    kernel, within the f32 tolerance of the twins; a head dim of 8
    (padded to the kernels' 16) and a strided q (copied) compute what the
    plain version does, each with one launch."""
    q = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        attn.flash_attention(q.double(), q.double(), q.double())
    g = torch.Generator(device=cuda).manual_seed(17)
    wq, wk, wv, wdo = (torch.randn(1, 2, 8, 8200, generator=g, device=cuda)
                       for _ in range(4))
    kernels = (attn.FLASH_FWD, attn.FLASH_DQ, attn.FLASH_DKV)
    before = [kk.launches for kk in kernels]
    leaves = [t.clone().requires_grad_() for t in (wq, wk, wv)]
    out = attn.flash_attention(*leaves, causal=True)
    out.backward(wdo)
    torch.cuda.synchronize()
    assert [kk.launches - c for kk, c in zip(kernels, before)] == [1, 1, 1]
    wo, wlse = attn.flash_fwd_ref(wq, wk, wv, True)
    want = (wo,) + attn.flash_bwd_ref(wq, wk, wv, out.detach(), wlse, wdo,
                                      True)
    for got, w in zip([out.detach()] + [t.grad for t in leaves], want):
        assert got.shape == w.shape
        torch.testing.assert_close(got, w, **TOL)
    q8 = q[..., :8].contiguous()
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    for args in ((q8, q8, q8), (strided, q, q)):
        before = attn.FLASH_FWD.launches
        got = attn.flash_attention(*args, causal=True)
        assert attn.FLASH_FWD.launches == before + 1
        torch.testing.assert_close(
            got, attn.flash_attention_ref(*args, causal=True), **TOL)


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
    # the tensor-core bodies (bf16 at D 64 and 128): a ragged last tile,
    # grouped-query heads, segment ids with the causal mask at D 128
    "tc_bf16_causal_s200": (2, 12, 12, 200, 64, True, None, torch.bfloat16),
    "tc_bf16_gqa_12_to_4": (2, 12, 4, 256, 64, False, None, torch.bfloat16),
    "tc_d128_bf16_causal_packed": (2, 8, 8, 192, 128, True, "packed",
                                   torch.bfloat16),
    # the D-256 tensor-core forward, dq and dk/dv (two warpgroups): a
    # ragged last tile, grouped-query heads under segment ids, head dims
    # 160 and 200 padded to 256
    "tc_d256_bf16_causal_s200": (2, 4, 4, 200, 256, True, None,
                                 torch.bfloat16),
    "tc_d256_bf16_gqa_4_to_2_packed": (2, 4, 2, 192, 256, True, "packed",
                                       torch.bfloat16),
    "tc_d160_bf16_causal": (2, 4, 4, 130, 160, True, None, torch.bfloat16),
    "tc_d200_bf16_gqa_ragged": (2, 4, 2, 100, 200, False, "ragged",
                                torch.bfloat16),
    # F5b: D 256 and 512 in dynamic shared memory on the CUDA cores (bf16
    # forward and dk/dv at 256 on the tensor cores), f32 and bf16
    "d256_f32_gqa_causal": (2, 4, 2, 130, 256, True, "ragged",
                            torch.float32),
    "d256_bf16_packed": (2, 4, 4, 128, 256, False, "packed",
                         torch.bfloat16),
    "d512_bf16_causal": (1, 2, 2, 100, 512, True, None, torch.bfloat16),
    "d512_f32": (1, 2, 1, 64, 512, False, None, torch.float32),
    # bf16 at D 512 on the wide tensor-core bodies (two 256-column forward
    # slices, one 512-column dq slice, two dk/dv slices): a ragged last
    # tile, grouped-query heads under segment ids, causal and not
    "d512_bf16_s300_gqa_packed_causal": (1, 4, 2, 300, 512, True, "packed",
                                         torch.bfloat16),
    "d512_bf16_s300_ragged": (2, 2, 2, 300, 512, False, "ragged",
                              torch.bfloat16),
    # the f32 wide forward in register tiles at D 640 (padded to 1024) and
    # 2048 (two 1024-column slices), ragged, grouped-query, segment ids
    "d640_f32_gqa_packed_causal": (2, 4, 2, 90, 640, True, "packed",
                                   torch.float32),
    "d2048_f32_gqa_ragged": (1, 4, 2, 70, 2048, False, "ragged",
                             torch.float32),
    # F5c: the wide bodies (D 1024..8192, rows across warps; the bf16
    # forward on the wide tensor-core body, 256 of O's columns a CTA)
    "d1024_f32_gqa_causal": (2, 4, 2, 70, 1024, True, "ragged",
                             torch.float32),
    "d1024_bf16_packed": (1, 2, 2, 64, 1024, False, "packed",
                          torch.bfloat16),
    "d2048_bf16_causal": (1, 2, 1, 40, 2048, True, None, torch.bfloat16),
    "d8192_f32": (1, 1, 1, 20, 8192, False, None, torch.float32),
    # the wide tensor-core forward at its widest (32 column slices, a
    # ragged q block) and with grouped-query heads over three key tiles
    "d8192_bf16_causal_s70": (1, 2, 1, 70, 8192, True, None,
                              torch.bfloat16),
    "d1024_bf16_gqa_causal_ragged": (2, 4, 2, 200, 1024, True, "ragged",
                                     torch.bfloat16),
    # F7: past 8192, padded to a multiple of 8192 (two 8192-column
    # slices on the CUDA cores; 32 / 64 slices of the tensor-core bodies)
    "d8200_f32_gqa_causal": (1, 2, 1, 24, 8200, True, None, torch.float32),
    "d8200_bf16_causal_s70": (1, 2, 1, 70, 8200, True, None,
                              torch.bfloat16),
    "d16384_f32_packed": (1, 1, 1, 20, 16384, False, "packed",
                          torch.float32),
    "d16384_bf16_gqa_causal": (1, 2, 1, 40, 16384, True, None,
                               torch.bfloat16),
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
    that see no key give exact zeros; a second run gives the same bits;
    each kernel on its ``flash_route``, read from the device kernels'
    names."""
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
    names = _device_kernel_names(run, "flash_", want=tuple(
        FLASH_BODIES.values()))
    _assert_flash_routes(names, dt, d)


# each flash kernel's device body, and the route a body's name shows
FLASH_BODIES = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_kernel",
                "flash_dkv": "flash_dkv_kernel"}


def _body_route(name: str, sym: str) -> str:
    return ("wide tensor cores" if f"{sym}_tc_wide<" in name else
            "tensor cores" if f"{sym}_tc<" in name else
            "wide CUDA cores" if f"{sym}_wide<" in name else "CUDA cores")


def _assert_flash_routes(names, dt, d):
    """Each of the three kernels seen in ``names`` (profiled device
    kernels), and each on the body ``attn.flash_route`` names for it."""
    for kernel, sym in FLASH_BODIES.items():
        seen = {_body_route(n, sym) for n in names if sym in n}
        assert seen == {attn.flash_route(kernel, dt, d)}, (kernel, names)


TC_CROSS_CASES = {
    # name: (b, h, hk, sq, sk, d, causal): the tensor-core bodies with
    # query and key lengths apart (ragged on both sides, keys no row sees)
    "sq33_sk71": (1, 4, 2, 33, 71, 64, False),
    "sq70_sk300_causal": (1, 2, 1, 70, 300, 64, True),
    "sq200_sk130_causal_d128": (2, 4, 4, 200, 130, 128, True),
    "sq130_sk70_causal_d256": (2, 4, 4, 130, 70, 256, True),
    "sq70_sk200_causal_d256_gqa": (1, 4, 2, 70, 200, 256, True),
    # the wide tensor-core dq and dk/dv (D 1024), and all three at D 512
    "sq130_sk70_causal_d1024": (1, 2, 2, 130, 70, 1024, True),
    "sq70_sk100_causal_d512": (1, 2, 2, 70, 100, 512, True),
    "sq300_sk70_d512_gqa": (1, 4, 2, 300, 70, 512, False),
    "sq70_sk200_causal_d1024_gqa": (1, 4, 2, 70, 200, 1024, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TC_CROSS_CASES))
def test_tensor_core_bodies_at_cross_lengths_match_the_twins(cuda, name):
    """The forward with lse and the dk/dv kernel (bf16, D 64/128/256: the
    tensor-core route) at Sq != Sk against the twins; keys that no row
    sees get exact zeros."""
    b, h, hk, sq, sk, d, causal = TC_CROSS_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(23)
    q, do = (torch.randn(b, h, sq, d, generator=g,
                         device=cuda).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=g,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True)
    got = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, None)
    torch.cuda.synchronize()
    wo, wlse = attn.flash_fwd_ref(q, k, v, causal)
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, causal)
    torch.testing.assert_close(o, wo, **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **FLASH_TOL[torch.bfloat16])
    if causal and sk > sq:
        assert torch.all(got[1][:, :, sq:] == 0)
        assert torch.all(got[2][:, :, sq:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512, 1024])
def test_tensor_core_route_refuses_an_operand_off_16_bytes(cuda, d):
    """bf16 at D 64/128/256 (and 512, 1024, the wide tensor-core forward): q
    starting 8 bytes past a 16-byte boundary (TMA needs 16) is cloned to
    an aligned start by the wrapper (F5): one launch, on the tensor
    cores, the plain version's result."""
    q = torch.randn(4 + 2 * 16 * d, device=cuda).to(torch.bfloat16)[4:]
    q = q.view(1, 2, 16, d)
    assert q.data_ptr() % 16 == 8
    k, v = (torch.randn(1, 2, 16, d, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    before = attn.FLASH_FWD.launches
    got = attn.flash_attention(q, k, v, causal=True)
    assert attn.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(got, attn.flash_attention_ref(
        q, k, v, causal=True), **FLASH_TOL[torch.bfloat16])
    names = _device_kernel_names(
        lambda: attn.flash_attention(q, k, v, causal=True), "flash_fwd_kernel")
    assert names and all("flash_fwd_kernel_tc" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [2048, 16384])
def test_f32_wide_forward_slices_agree_bit_for_bit(cuda, d, rate):
    """The f32 wide forward's column slices (1024 columns of O a CTA; a
    cluster of up to 8 sums S's partials in rank order, and past D 8192
    each cluster computes the whole of S) get the same m, l and p, bit for
    bit: with V
    made of D/1024 copies of one 1024-column block, every slice of O
    holds the same bits, the dropout keep included; the lse, which slice 0
    writes, is the same whatever V holds; both held to the twin, causal,
    ragged (Sq 70 against Sk 100), grouped-query heads."""
    g = torch.Generator(device=cuda).manual_seed(29)
    q = torch.randn(1, 4, 70, d, generator=g, device=cuda)
    k = torch.randn(1, 2, 100, d, generator=g, device=cuda)
    block = torch.randn(1, 2, 100, 1024, generator=g, device=cuda)
    v = block.repeat(1, 1, 1, d // 1024)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    sd = seed if rate else None
    o, lse = attn._flash_fwd_cuda(q, k, v, True, None, None, True, rate, sd)
    o2, lse2 = attn._flash_fwd_cuda(q, k, torch.randn_like(v), True, None,
                                    None, True, rate, sd)
    torch.cuda.synchronize()
    slices = o.split(1024, dim=-1)
    assert all(torch.equal(x, slices[0]) for x in slices[1:])
    assert torch.equal(lse, lse2)
    wo, wlse = attn.flash_fwd_ref(q, k, v, True, None, None, rate, sd)
    torch.testing.assert_close(o, wo, **FLASH_TOL[torch.float32])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-5)
    names = _device_kernel_names(lambda: attn._flash_fwd_cuda(
        q, k, v, True, None, None, True, rate, sd), "flash_fwd_kernel")
    assert names and all(
        re.search(r"flash_fwd_kernel_wide<float, %s>" % str(bool(rate))
                  .lower(), n) for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [2048, 16384])
def test_f32_wide_backward_slices_agree_bit_for_bit(cuda, d, rate):
    """The f32 wide dq's and dk/dv's column slices (1024 of dQ's, 512 of
    dK's and dV's columns a CTA, 1024 past D 4096; a cluster of up to 8
    sums the partials of S and dP in rank order, and where a row block
    has more than one cluster each computes the whole of both) get the
    same p and ds, bit for bit, the dropout keep included: with K made of
    D/1024 copies of one 1024-column block every slice of dQ holds the
    same bits, and with q and dO made of D/512 copies of one 512-column
    block every slice of dK and of dV; held to the twin, causal, ragged
    (Sq 70 against Sk 100), grouped-query heads, each kernel the f32 wide
    body of its DROP instantiation.  K is scaled by 32/sqrt(D), so q.k
    keeps the spread of random rows of width D (the copies' correlation
    alone would widen it sqrt(D/1024) times)."""
    g = torch.Generator(device=cuda).manual_seed(37)
    q, do = (torch.randn(1, 4, 70, 512, generator=g, device=cuda)
             .repeat(1, 1, 1, d // 512) for _ in range(2))
    k = torch.randn(1, 2, 100, 1024, generator=g, device=cuda).repeat(
        1, 1, 1, d // 1024) * (32 / d ** 0.5)
    v = torch.randn(1, 2, 100, d, generator=g, device=cuda)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    sd = seed if rate else None
    o, lse = attn._flash_fwd_cuda(q, k, v, True, None, None, True, rate, sd)
    dq, dk, dv = attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None, None,
                                      rate, sd)
    torch.cuda.synchronize()
    for t, w in ((dq, 1024), (dk, 512), (dv, 512)):
        slices = t.split(w, dim=-1)
        assert all(torch.equal(x, slices[0]) for x in slices[1:])
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, True, None, None, rate,
                              sd)
    for a, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, w, **FLASH_TOL[torch.float32])
    again = attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None, None,
                                 rate, sd)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
    _assert_f32_wide_backward(q, k, v, o, lse, do, True, None, rate, sd)


def _assert_f32_wide_backward(q, k, v, o, lse, do, causal, seg, rate, sd):
    """dq and dk/dv of this call each ran the f32 wide body of its DROP
    instantiation (dk/dv's key rows a CTA, 32 up to D 4096 and 16 past
    it, its middle template argument), read from the device kernels'
    names."""
    names = _device_kernel_names(lambda: attn._flash_bwd_cuda(
        q, k, v, o, lse, do, causal, None, seg, rate, sd), "flash_",
        want=("flash_dq_kernel_wide", "flash_dkv_kernel_wide"))
    drop = str(bool(rate)).lower()
    rows = 32 if attn._kernel_width(q.shape[-1]) <= 4096 else 16
    for want in (f"flash_dq_kernel_wide<float, {drop}>",
                 f"flash_dkv_kernel_wide<float, {rows}, {drop}>"):
        assert any(want in n for n in names), (want, names)
    assert all("_kernel_wide<float, " in n for n in names), names


F32_WIDE_BWD_CASES = {
    # name: (b, h, hk, sq, sk, d, causal, seg kind): the f32 wide dq and
    # dk/dv (register tiles over a cluster of column slices) at ragged
    # query and key lengths, grouped-query heads and packed segment ids,
    # D 640 (padded to 1024), 1024, 2048 and 8200 (padded to 16384)
    "d640_sq130_sk70_causal": (1, 4, 2, 130, 70, 640, True, None),
    "d1024_sq70_sk200_gqa_causal": (1, 4, 2, 70, 200, 1024, True, None),
    "d1024_gqa_packed_causal": (2, 4, 2, 130, 130, 1024, True, "packed"),
    "d2048_sq130_sk70_gqa": (1, 4, 2, 130, 70, 2048, False, None),
    "d2048_sq70_sk200_causal": (1, 2, 2, 70, 200, 2048, True, None),
    "d8200_sq130_sk70_gqa_causal": (1, 4, 2, 130, 70, 8200, True, None),
    "d8200_gqa_packed": (1, 2, 1, 70, 70, 8200, False, "packed"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(F32_WIDE_BWD_CASES))
def test_f32_wide_backward_matches_the_twin_on_card(cuda, name, rate):
    """The f32 wide dq and dk/dv against ``flash_bwd_ref`` on the card's
    own o and lse (f32 within 1e-4), rate 0 and 0.1: the same bits on a
    second call; rows of padding (packed ids) and, causal with Sk > Sq,
    keys that no row sees give exact zeros; each kernel the f32 wide body
    of its DROP instantiation, read from the device kernels' names."""
    b, h, hk, sq, sk, d, causal, kind = F32_WIDE_BWD_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(43)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=cuda)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=g, device=cuda)
            for _ in range(2))
    seg = None if kind is None else _seg(kind, b, sq, cuda)
    seed = torch.tensor([-98765], dtype=torch.int32, device=cuda)
    sd = seed if rate else None
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg, True, rate, sd)
    got = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg, rate,
                               sd)
    torch.cuda.synchronize()
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, seg, rate,
                              sd)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **FLASH_TOL[torch.float32])
    if seg is not None:
        pad = seg[0] < 0                                  # (B, S)
        assert bool(pad.any())
        for t in got:
            assert torch.all(t.transpose(1, 2)[pad] == 0)
    if causal and sk > sq:
        assert torch.all(got[1][:, :, sq:] == 0)
        assert torch.all(got[2][:, :, sq:] == 0)
    again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg,
                                 rate, sd)
    assert all(torch.equal(a, w) for a, w in zip(again, got))
    _assert_f32_wide_backward(q, k, v, o, lse, do, causal, seg, rate, sd)


@pytest.mark.cuda
def test_flash_attention_refuses_dropout_on_card(cuda):
    """Dropout runs on the card: forward and gradients at rate 0.1 on
    the tensor-core route against the twins at the same seed, one
    launch of each kernel, and the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(1, 2, 80, 64, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([77], dtype=torch.int32, device=cuda)
    counts = [kk.launches for kk in (attn.FLASH_FWD, attn.FLASH_DQ,
                                     attn.FLASH_DKV)]

    def run():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = attn.flash_attention(qq, kk, vv, causal=True, dropout_rate=0.1,
                                 dropout_seed=seed)
        o.backward(do)
        return o.detach(), qq.grad, kk.grad, vv.grad

    got = run()
    torch.cuda.synchronize()
    assert [kk.launches - c for kk, c in zip(
        (attn.FLASH_FWD, attn.FLASH_DQ, attn.FLASH_DKV), counts)] == [1, 1, 1]
    wo, lse = attn.flash_fwd_ref(q, k, v, True, None, None, 0.1, seed)
    want = (wo,) + attn.flash_bwd_ref(q, k, v, got[0], lse, do, True, None,
                                      None, 0.1, seed)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **FLASH_TOL[torch.bfloat16])
    assert all(torch.equal(a, b) for a, b in zip(run(), got))


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


def _device_kernel_names(fn, keep, want=None, calls=3, sessions=3):
    """The names holding ``keep`` of the device kernels that ``calls``
    calls of ``fn`` launch, read by ``torch.profiler`` after one warm-up
    call.  A session sometimes comes back without its first kernels'
    records, so a few small kernels run first, and the session is read
    again, up to ``sessions`` times, until some name holds each of
    ``want`` (default: ``keep``); the caller checks the last session's
    names."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer = torch.zeros(1024, device="cuda")
            for _ in range(64):
                primer.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and keep in e.name]
        if all(any(w in n for n in names) for w in (want or (keep,))):
            break
    return names


DQ_CASES = {
    # name: (b, h, hk, sq, sk, d, causal, seg kind, dtype): bf16 at D 64,
    # 128 and 256 is the tensor-core route, the rest the CUDA cores
    "gpt2_small_causal": (8, 12, 12, 512, 512, 64, True, None,
                          torch.bfloat16),
    "bert_large_unmasked": (8, 16, 16, 512, 512, 64, False, None,
                            torch.bfloat16),
    "bert_large_packed_causal": (2, 16, 16, 512, 512, 64, True, "packed",
                                 torch.bfloat16),
    "gqa_12_to_4_s200": (2, 12, 4, 200, 200, 64, True, "ragged",
                         torch.bfloat16),
    "d128_packed": (2, 8, 8, 256, 256, 128, False, "packed", torch.bfloat16),
    "sq200_sk330_d128": (1, 4, 2, 200, 330, 128, False, None, torch.bfloat16),
    "sq130_sk70_causal": (2, 4, 4, 130, 70, 64, True, None, torch.bfloat16),
    "f32_d64_cuda_cores": (2, 4, 4, 200, 200, 64, True, "packed",
                           torch.float32),
    "bf16_d32_cuda_cores": (2, 4, 4, 200, 200, 32, True, None,
                            torch.bfloat16),
    "bf16_d256_tensor_cores_packed": (2, 4, 2, 200, 200, 256, True,
                                      "packed", torch.bfloat16),
    "bf16_d256_gqa_sq200_sk330_causal": (2, 4, 2, 200, 330, 256, True, None,
                                         torch.bfloat16),
    # the wide tensor-core dq: 512 of dQ's columns a CTA
    "bf16_d1024_gqa_packed_causal": (2, 4, 2, 200, 200, 1024, True, "packed",
                                     torch.bfloat16),
    "bf16_d2048_sq200_sk330": (1, 2, 1, 200, 330, 2048, False, None,
                               torch.bfloat16),
    "f32_d1024_wide_cuda_cores": (1, 2, 2, 100, 100, 1024, True, None,
                                  torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DQ_CASES))
def test_flash_dq_on_its_route_matches_the_twin(cuda, name):
    """dq against ``flash_bwd_ref`` on the kernel's own o and lse: bf16
    within one bf16 rounding (2e-2), f32 within 1e-4; rows that see no
    key give exact zeros; the same bits on a second call; the route read
    from the kernel's name (``attn.flash_route``: ``flash_dq_kernel_tc``
    exactly for bf16 at D 64, 128 and 256)."""
    b, h, hk, sq, sk, d, causal, kind, dt = DQ_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(31)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=cuda).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=g, device=cuda).to(dt)
            for _ in range(2))
    seg = None if kind is None else _seg(kind, b, sq, cuda)
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg, True)
    dq = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg)[0]
    torch.cuda.synchronize()
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, seg)[0]
    torch.testing.assert_close(dq, want, **FLASH_TOL[dt])
    if seg is not None:
        pad = seg[0] < 0                                  # (B, S)
        assert bool(pad.any())
        assert torch.all(dq.transpose(1, 2)[pad] == 0)
    again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg)[0]
    assert torch.equal(again, dq)
    names = _device_kernel_names(
        lambda: attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg),
        "flash_dq_kernel")
    want = attn.flash_route("flash_dq", dt, d)
    assert names and all(_body_route(n, "flash_dq_kernel") == want
                         for n in names)


LN_BWD_CASES = {
    # name: (rows, h, x dtype, w dtype, rms, x's start in elements past a
    # 16-byte boundary, route)
    "gpt_bf16": (4096, 768, torch.bfloat16, torch.bfloat16, False, 0,
                 "fused"),
    "bert_bf16": (4096, 1024, torch.bfloat16, torch.bfloat16, False, 0,
                  "fused"),
    "bert_bf16_rms": (4096, 1024, torch.bfloat16, torch.bfloat16, True, 0,
                      "fused"),
    "h128_f32_333_rows": (333, 128, torch.float32, torch.float32, False, 0,
                          "fused"),
    "h128_bf16_rms_333_rows": (333, 128, torch.bfloat16, torch.float32, True,
                               0, "fused"),
    "h4096_bf16_333_rows": (333, 4096, torch.bfloat16, torch.bfloat16, False,
                            0, "fused"),
    "h4096_f32_rms": (129, 4096, torch.float32, torch.bfloat16, True, 0,
                      "fused"),
    "h8192_f32": (65, 8192, torch.float32, torch.float32, False, 0,
                  "fused"),
    "h8192_bf16_rms": (65, 8192, torch.bfloat16, torch.bfloat16, True, 0,
                       "fused"),
    "h16384_f32_three": (9, 16384, torch.float32, torch.float32, False, 0,
                         "three"),
    "unaligned_bf16_three": (333, 1024, torch.bfloat16, torch.bfloat16,
                             False, 1, "three"),
}
LN_BWD_NAMES = {"fused": {"ln_bwd_fused_kernel", "ln_bwd_combine_kernel"},
                "three": {"ln_bwd_dx_kernel", "ln_bwd_partial_kernel",
                          "ln_bwd_combine_kernel"}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LN_BWD_CASES))
def test_layer_norm_backward_routes_match_plain_on_card(cuda, case):
    """Both backward bodies against ``_bwd_2d_ref``: dx within 2e-2 in
    bf16 and 1e-4 in f32, dw and db within 1e-4 of their scale; the same
    bits twice; the route the wrapper picks is the one the device runs
    (its kernels' names, 2 fused or 3 otherwise)."""
    rows, h, xdt, wdt, rms, off, route = LN_BWD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(13)

    def tensor(scale, shift):
        t = (torch.randn(rows * h + off, generator=g, device=cuda) * scale
             + shift).to(xdt)
        return t[off:].view(rows, h)

    x, dy = tensor(3, 1), tensor(1, 0)
    w = (torch.randn(h, generator=g, device=cuda) * 0.1 + 1).to(wdt)
    assert ln.bwd_route(x, dy) == route
    b0 = ln.LN_BWD.launches
    dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert ln.LN_BWD.launches - b0 == 1
    wdx, wdw, wdb = ln._bwd_2d_ref(x, w, dy, 1e-5, rms)
    half = xdt == torch.bfloat16
    torch.testing.assert_close(dx, wdx, **(dict(atol=2e-2, rtol=2e-2) if half
                                           else dict(atol=1e-4, rtol=1e-4)))
    for got, want in ((dw, wdw), (db, wdb)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    again = ln._bwd_2d(x, w, dy, 1e-5, rms)
    assert all(torch.equal(a, c) for a, c in zip(again, (dx, dw, db)))
    names = _device_kernel_names(lambda: ln._bwd_2d(x, w, dy, 1e-5, rms),
                                 "ln_bwd_", want=LN_BWD_NAMES[route])
    seen = {k for k in LN_BWD_NAMES["three"] | LN_BWD_NAMES["fused"]
            if any(k in n for n in names)}
    assert seen == LN_BWD_NAMES[route]
    assert len(seen) == ln.BWD_DEVICE_KERNELS[route]


LN_FWD_CASES = {
    # name: (rows, h, x dtype, w dtype, rms, x's offset in elements,
    # route): h 768, 1024, 4096 and 8192 in f32 and bf16, LN and RMS, on
    # the register route; a misaligned x and h past 8192 on the wide one
    "gpt_bf16": (4096, 768, torch.bfloat16, torch.bfloat16, False, 0,
                 "register"),
    "bert_bf16": (4096, 1024, torch.bfloat16, torch.bfloat16, False, 0,
                  "register"),
    "bert_bf16_rms": (4096, 1024, torch.bfloat16, torch.bfloat16, True, 0,
                      "register"),
    "h768_f32_rms_333_rows": (333, 768, torch.float32, torch.float32, True,
                              0, "register"),
    "h1024_f32_mixed_w": (300, 1024, torch.float32, torch.bfloat16, False,
                          0, "register"),
    "h4096_bf16_rms": (129, 4096, torch.bfloat16, torch.float32, True, 0,
                       "register"),
    "h4096_f32": (333, 4096, torch.float32, torch.float32, False, 0,
                  "register"),
    "h8192_f32_rms": (65, 8192, torch.float32, torch.float32, True, 0,
                      "register"),
    "h8192_bf16": (65, 8192, torch.bfloat16, torch.bfloat16, False, 0,
                   "register"),
    "one_row_h128": (1, 128, torch.bfloat16, torch.bfloat16, False, 0,
                     "register"),
    "unaligned_bf16_wide": (333, 1024, torch.bfloat16, torch.bfloat16,
                            False, 1, "wide"),
    "unaligned_f32_rms_wide": (77, 768, torch.float32, torch.float32, True,
                               2, "wide"),
    "h16384_f32_wide": (9, 16384, torch.float32, torch.float32, False, 0,
                        "wide"),
}
LN_FWD_NAMES = {"register": "ln_fwd_reg_kernel", "wide": "ln_fwd_kernel"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LN_FWD_CASES))
def test_layer_norm_forward_routes_match_plain_on_card(cuda, case):
    """Both forward bodies against ``_fwd_2d_ref``: y within 2e-2 in bf16
    and 1e-5 in f32 (the kernels' LN_CASES tolerances); the same bits
    twice; one launch; the route the wrapper picks is the one the device
    runs (its kernel's name)."""
    rows, h, xdt, wdt, rms, off, route = LN_FWD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(14)
    x = ((torch.randn(rows * h + off, generator=g, device=cuda) * 3 + 1)
         .to(xdt)[off:].view(rows, h))
    w = (torch.randn(h, generator=g, device=cuda) * 0.1 + 1).to(wdt)
    b = (torch.randn(h, generator=g, device=cuda) * 0.1).to(wdt)
    assert ln.fwd_route(x) == route
    f0 = ln.LN_FWD.launches
    y = ln._fwd_2d(x, w, b, 1e-5, rms)
    torch.cuda.synchronize()
    assert ln.LN_FWD.launches - f0 == 1
    half = xdt == torch.bfloat16
    torch.testing.assert_close(y, ln._fwd_2d_ref(x, w, b, 1e-5, rms),
                               **(dict(atol=2e-2, rtol=2e-2) if half
                                  else dict(atol=1e-5, rtol=1e-5)))
    assert torch.equal(ln._fwd_2d(x, w, b, 1e-5, rms), y)
    names = _device_kernel_names(lambda: ln._fwd_2d(x, w, b, 1e-5, rms),
                                 "ln_fwd_", want=(LN_FWD_NAMES[route],))
    assert names and all(LN_FWD_NAMES[route] in n for n in names)


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
    return p, g, m, v


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


# stage 2 walks the segment starts: single-element segments, boundaries
# inside one vector, a tail that is not a multiple of 4, segments that
# span CTAs (a CTA takes about 1024 elements at these lengths)
LAMB_SIZES = [[1], [3, 1024, 5], [70001, 4, 333],
              [1, 1, 2, 5, 1, 4099, 1, 3], [2053] * 97 + [1, 6]]


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", LAMB_SIZES)
@pytest.mark.parametrize("case", sorted(LAMB_CASES))
def test_flat_lamb_matches_plain_on_card(cuda, sizes, case):
    pdt, gdt, nv, bc, clip, gs, wd = LAMB_CASES[case]
    p, g, m, v = _lamb_bucket(sizes, pdt, gdt, cuda)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=wd,
              step=torch.tensor(3, dtype=torch.int32, device=cuda),
              bias_correction=bc, grad_scale=torch.tensor(gs, device=cuda),
              clip_coeff=torch.tensor(clip, device=cuda), use_nvlamb=nv)
    want = mt.flat_lamb_ref(p, g, m, v, sizes, **kw)
    before = (mt.LAMB_MOMENTS.launches, mt.LAMB_APPLY.launches)
    got = mt.flat_lamb(p.clone(), g, m.clone(), v.clone(), sizes,
                       seg_offsets=mt.segment_offsets(sizes, cuda), **kw)
    torch.cuda.synchronize()
    assert (mt.LAMB_MOMENTS.launches, mt.LAMB_APPLY.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flag", [0, 1])
def test_flat_lamb_found_inf_gate_on_card(cuda, flag, pdt):
    p, g, m, v = _lamb_bucket([4099, 7], pdt, torch.bfloat16, cuda)
    g[5] = float("nan")
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    mt.flat_lamb(p, g, m, v, [4099, 7], lr=1e-3, beta1=0.9,
                 beta2=0.999, eps=1e-6, weight_decay=0.01,
                 found_inf=torch.tensor(flag, dtype=torch.int32, device=cuda),
                 seg_offsets=mt.segment_offsets([4099, 7], cuda))
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


# ---------------------------------------------------------------------------
# the fused softmax: softmax_fwd, softmax_masked_fwd, softmax_bwd
# ---------------------------------------------------------------------------

SOFTMAX_CASES = {
    # name: (x shape (b, np, sq, sk), kind, dtype)
    "causal_bf16": ((2, 3, 256, 256), "causal", torch.bfloat16),
    "causal_f32_wide": ((1, 2, 2048, 2048), "causal", torch.float32),
    "masked_bf16": ((2, 4, 64, 512), "masked", torch.bfloat16),
    "masked_fp16_ragged_rows": ((3, 5, 8, 384), "masked", torch.float16),
    "masked_f32_s4096": ((1, 2, 16, 4096), "masked", torch.float32),
    "unmasked_bf16_ragged_rows": ((1, 3, 7, 128), "unmasked",
                                  torch.bfloat16),
    "unmasked_fp16_s1152": ((2, 2, 8, 1152), "unmasked", torch.float16),
}
# one rounding of the output dtype; f32 forward within 1e-6; the
# backward within 1e-5 of max |dx| (sums in another order)
SOFTMAX_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
                torch.float16: 2.0 ** -10}
SOFTMAX_ATOL = {torch.float32: 1e-6, torch.bfloat16: 1e-12,
                torch.float16: 2.0 ** -24}


def _sm_inputs(shape, kind, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 4).to(dtype)
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    mask = None
    if kind == "masked":             # ~30% masked, query row 1 all masked
        mask = torch.rand((shape[0], 1) + shape[2:], generator=g,
                          device=device) < 0.3
        mask[:, :, 1] = True
    return x, dy, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_kernels_match_plain_on_card(cuda, case):
    from apex_tpu_torch.ops import softmax as sm
    shape, kind, dtype = SOFTMAX_CASES[case]
    b, np_, sq, sk = shape
    x, dy, mask = _sm_inputs(shape, kind, dtype, cuda, 14)
    kern = sm.SOFTMAX_MASKED_FWD if kind == "masked" else sm.SOFTMAX_FWD
    before = (kern.launches, sm.SOFTMAX_BWD.launches)
    if kind == "causal":
        x, dy = x.reshape(b * np_, sq, sk), dy.reshape(b * np_, sq, sk)
        y = sm._softmax_fwd(x, 0.125, causal=True)
        want = sm.scaled_upper_triang_masked_softmax_ref(x, 0.125)
    elif kind == "masked":
        y = sm._softmax_masked_fwd(x, sm._byte_mask(mask, b, sq, sk), 0.125)
        want = sm.scaled_masked_softmax_ref(x, mask, 0.125)
    else:
        y = sm._softmax_fwd(x, 0.125, causal=False)
        want = sm.scaled_masked_softmax_ref(x, None, 0.125)
    dx = sm._softmax_bwd(y, dy, 0.125)
    torch.cuda.synchronize()
    assert (kern.launches - before[0],
            sm.SOFTMAX_BWD.launches - before[1]) == (1, 1)
    torch.testing.assert_close(y, want, rtol=SOFTMAX_RTOL[dtype],
                               atol=SOFTMAX_ATOL[dtype])
    want_dx = sm.softmax_vjp_ref(y, dy, 0.125)
    torch.testing.assert_close(
        dx, want_dx, rtol=SOFTMAX_RTOL[dtype],
        atol=1e-5 * float(want_dx.float().abs().max()))
    if kind == "masked":             # a fully masked row: exact zeros
        assert torch.all(y[:, :, 1] == 0) and torch.all(dx[:, :, 1] == 0)
    if kind == "causal":
        upper = torch.ones(sq, sk, dtype=torch.bool, device=cuda).triu(1)
        assert torch.all(y[:, upper] == 0)
    assert torch.equal(sm._softmax_bwd(y, dy, 0.125), dx)
    if kind == "masked":
        again = sm._softmax_masked_fwd(x, sm._byte_mask(mask, b, sq, sk),
                                       0.125)
    else:
        again = sm._softmax_fwd(x, 0.125, causal=kind == "causal")
    assert torch.equal(again, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["causal", "padding"])
def test_fused_scale_mask_softmax_runs_the_kernels_on_card(cuda, kind):
    from apex_tpu_torch.ops import softmax as sm
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
    x, _, mask = _sm_inputs((2, 3, 128, 128), "masked", torch.bfloat16,
                            cuda, 15)
    causal = kind == "causal"
    fsm = FusedScaleMaskSoftmax(
        attn_mask_type=AttnMaskType.causal if causal else
        AttnMaskType.padding, scale=0.5)
    x.requires_grad_()
    fwd = sm.SOFTMAX_FWD if causal else sm.SOFTMAX_MASKED_FWD
    before = (fwd.launches, sm.SOFTMAX_BWD.launches)
    y = fsm(x, None if causal else mask)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches - before[0],
            sm.SOFTMAX_BWD.launches - before[1]) == (1, 1)
    assert y.dtype == x.grad.dtype == torch.bfloat16
    with torch.no_grad():
        want = (sm.scaled_upper_triang_masked_softmax_ref(
            x.reshape(6, 128, 128), 0.5).reshape(x.shape) if causal else
            sm.scaled_masked_softmax_ref(x, mask, 0.5))
    torch.testing.assert_close(y, want, rtol=2.0 ** -7, atol=1e-12)


OFF_GATE = {
    # name: (x shape, kind, (forward, backward) launches on the gate)
    "sk200": ((2, 2, 16, 200), "masked", (0, 0)),
    "sk72_causal": ((1, 2, 72, 72), "causal", (0, 0)),
    "masked_sq12": ((2, 2, 12, 256), "masked", (0, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OFF_GATE))
def test_softmax_off_the_gate_launches_what_the_reference_does(cuda, case):
    """Off the reference's gate the plain version runs on the card; the
    backward's gate is sk's alone, so masked with sq % 8 != 0 runs the
    backward kernel after a plain forward, as the reference does."""
    from apex_tpu_torch.ops import softmax as sm
    shape, kind, (n_fwd, n_bwd) = OFF_GATE[case]
    b, np_, sq, sk = shape
    x, dy, mask = _sm_inputs(shape, kind, torch.bfloat16, cuda, 16)
    x.requires_grad_()
    before = (sm.SOFTMAX_FWD.launches + sm.SOFTMAX_MASKED_FWD.launches,
              sm.SOFTMAX_BWD.launches)
    if kind == "causal":
        y = sm.scaled_upper_triang_masked_softmax(
            x.reshape(b * np_, sq, sk), 0.5).reshape(shape)
    else:
        y = sm.scaled_masked_softmax(x, mask, 0.5)
    after_fwd = sm.SOFTMAX_FWD.launches + sm.SOFTMAX_MASKED_FWD.launches
    y.backward(dy)
    torch.cuda.synchronize()
    assert (after_fwd - before[0],
            sm.SOFTMAX_BWD.launches - before[1]) == (n_fwd, n_bwd)
    assert torch.isfinite(x.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", [torch.bool, torch.uint8, torch.int32])
def test_softmax_mask_is_never_copied_across_heads(cuda, mdt):
    """Peak memory of the masked forward stays within y plus one (b, sq,
    sk) byte mask (made only for a mask that is not bool or uint8): the
    mask is read per batch row, never broadcast np-fold."""
    from apex_tpu_torch.ops import softmax as sm
    b, np_, sq, sk = 2, 16, 256, 512
    x, _, mask = _sm_inputs((b, np_, sq, sk), "masked", torch.bfloat16,
                            cuda, 17)
    mask = mask.to(mdt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    before = sm.SOFTMAX_MASKED_FWD.launches
    with torch.no_grad():
        y = sm.scaled_masked_softmax(x, mask, 0.5)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    allowed = y.numel() * y.element_size() + b * sq * sk
    assert sm.SOFTMAX_MASKED_FWD.launches == before + 1
    assert extra <= allowed, (extra, allowed)


@pytest.mark.cuda
def test_softmax_wrappers_reject_what_they_cannot_take(cuda):
    from apex_tpu_torch.ops import softmax as sm
    x = torch.randn(1, 2, 8, 128, device=cuda)
    with pytest.raises(TypeError, match="float32, bfloat16"):
        sm.scaled_masked_softmax(x.double(), None, 0.5)
    with pytest.raises(ValueError, match="mask is on cpu"):
        sm.scaled_masked_softmax(x, torch.zeros(1, 1, 8, 128,
                                                dtype=torch.bool), 0.5)
    with pytest.raises(TypeError, match="cannot reshape mask"):
        sm.scaled_masked_softmax(
            torch.randn(2, 2, 8, 128, device=cuda),
            torch.zeros(1, 1, 8, 128, dtype=torch.bool, device=cuda), 0.5)


# ---------------------------------------------------------------------------
# the fused cross entropy (xent_fwd, xent_bwd) and Welford (welford_mean_var)
# ---------------------------------------------------------------------------

# (rows, C, logits dtype, half_to_float): BERT-L's MLM logits at
# Megatron's padded vocabulary, GPT-2's vocabulary padded the same way,
# the gate's edge, and fp16 at the narrowest row
XENT_CASES = {
    "bert_large_30592_f32": (4096, 30592, torch.float32, False),
    "gpt2_50304_bf16_h2f": (8192, 50304, torch.bfloat16, True),
    "edge_65536_f32": (64, 65536, torch.float32, False),
    "c128_bf16": (300, 128, torch.bfloat16, False),
    "c256_fp16": (33, 256, torch.float16, False),
}


def _xent_inputs(n, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(n, c, generator=g, device=device) * 2).to(dtype)
    labels = torch.randint(0, c, (n,), generator=g, device=device)
    labels[:3] = torch.tensor([-1, c, c + 5], device=device)
    dy = torch.randn(n, generator=g, device=device)
    return x, labels, dy


def _held_to(got, want, atol, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(XENT_CASES))
def test_xent_kernels_match_plain_on_card(cuda, case, smoothing):
    """Losses and lse within rtol 1e-5 (f32; half losses within one
    rounding), dx within 1e-6 of max |dx| (and one rounding in half);
    labels -1, C and C + 5 have no target term; the same bits twice."""
    from apex_tpu_torch.ops import xentropy as tx
    n, c, dtype, h2f = XENT_CASES[case]
    x, labels, dy = _xent_inputs(n, c, dtype, cuda, seed=c % 97)
    loss, lse = tx._xent_fwd_cuda(x, labels, smoothing, h2f)
    want_loss, want_lse = tx.xent_fwd_ref(x, labels, smoothing, h2f)
    half = loss.dtype != torch.float32
    _held_to(loss, want_loss, 1e-5, 2.0 ** -7 if half else 1e-5)
    _held_to(lse, want_lse, 1e-5, 1e-5)
    dyl = dy.to(loss.dtype)
    dx = tx._xent_bwd_cuda(x, labels, lse, dyl, smoothing, h2f)
    want_dx = tx.xent_bwd_ref(x, labels, want_lse, dyl, smoothing, h2f)
    scale = float(want_dx.float().abs().max())
    _held_to(dx, want_dx, 1e-6 * scale, 2.0 ** -7 if half else 0.0)
    xf = x.float()
    no_target = torch.logsumexp(xf[:3], 1) - smoothing * xf[:3].mean(1)
    _held_to(loss[:3], no_target.to(loss.dtype), 1e-5,
             2.0 ** -7 if half else 1e-5)
    again = tx._xent_fwd_cuda(x, labels, smoothing, h2f)
    assert torch.equal(again[0], loss) and torch.equal(again[1], lse)
    assert torch.equal(tx._xent_bwd_cuda(x, labels, lse, dyl, smoothing, h2f),
                       dx)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 2048, 200, 30528])
def test_softmax_cross_entropy_launches_on_the_gate_only(cuda, c):
    """On the gate one xent_fwd and one xent_bwd a forward + backward,
    never the plain version; off it neither kernel (the reference's XLA
    path)."""
    from apex_tpu_torch.ops import xentropy as tx
    x, labels, dy = _xent_inputs(16, c, torch.float32, cuda, seed=3)
    x.requires_grad_(True)
    before = (tx.XENT_FWD.launches, tx.XENT_BWD.launches)
    loss = tx.softmax_cross_entropy(x, labels, 0.1)
    loss.backward(dy)
    torch.cuda.synchronize()
    gate = tx._use_pallas(c)
    assert (tx.XENT_FWD.launches - before[0],
            tx.XENT_BWD.launches - before[1]) == ((1, 1) if gate else (0, 0))
    assert bool(torch.isfinite(loss[:3]).all()) == gate


WELFORD_CASES = {
    # (rows, C, dtype, mean): ResNet-50's BatchNorm inputs under --sync-bn
    # at batch 128 and 224x224, a ragged row count, a large mean
    "r50_401408x256_bf16": (401408, 256, torch.bfloat16, 0.0),
    "r50_100352x512_f32": (100352, 512, torch.float32, 0.0),
    "r50_6272x2048_f32": (6272, 2048, torch.float32, 0.0),
    "ragged_100001x384_bf16": (100001, 384, torch.bfloat16, 0.0),
    "large_mean_50000x256_f32": (50000, 256, torch.float32, 300.0),
    "seven_rows_fp16": (7, 128, torch.float16, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WELFORD_CASES))
def test_welford_kernel_matches_plain_on_card(cuda, case):
    """Mean within rtol 1e-5 / atol 1e-6, var rtol 1e-4 / atol 1e-5 (the
    reference's tolerances), the count exact, one launch, the same bits
    twice."""
    from apex_tpu_torch.ops import welford as tw
    n, c, dtype, mean = WELFORD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(n % 101)
    noise = torch.randn(n, c, generator=g, device=cuda)
    x = (mean + (0.05 if mean else 1.0) * noise).to(dtype)
    before = tw.WELFORD.launches
    got = tw.welford_mean_var(x)
    torch.cuda.synchronize()
    assert tw.WELFORD.launches == before + 1
    want = tw.welford_mean_var_ref(x)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)
    assert got[2].shape == () and float(got[2]) == float(want[2]) == n
    again = tw.welford_mean_var(x)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_welford_off_the_gate_runs_the_plain_version_on_card(cuda):
    from apex_tpu_torch.ops import welford as tw
    x = torch.randn(1000, 64, device=cuda)
    before = tw.WELFORD.launches
    got = tw.welford_mean_var(x)
    assert tw.WELFORD.launches == before
    assert all(torch.equal(a, b)
               for a, b in zip(got, tw.welford_mean_var_ref(x)))
    with pytest.raises(TypeError, match="float32"):
        tw.welford_mean_var(x.double().reshape(-1, 128))


# ---------------------------------------------------------------------------
# the fused attention dropout (every flash body's DROP instantiation) and
# the wrapper's padding and copies (F5)
# ---------------------------------------------------------------------------
#
# Each body against its twin at the same seed (FLASH_TOL); the keep mask
# read out of the kernels bit for bit: with q = k = 0 every visible p is
# 1/n, so with V one-hot on a window of D keys the output is nonzero on
# that window exactly where the pair is kept, with dO one-hot on a
# window of D query rows dV is nonzero exactly where kept, and with K
# one-hot on a window of D keys (dP all ones, O taken as zeros so di is
# 0) dQ is nonzero exactly where kept.

DROP_CASES = {
    # name: (b, h, hk, sq, sk, d, causal, seg kind, dtype, rate): each
    # kernel on its attn.flash_route (bf16 at D 64/128/256 the
    # tensor-core bodies, bf16 from D 1024 the wide tensor-core bodies;
    # the rest the CUDA cores)
    "tc_gpt_causal": (2, 12, 12, 256, 256, 64, True, None, torch.bfloat16,
                      0.1),
    "tc_bert_packed": (2, 16, 16, 192, 192, 64, False, "packed",
                       torch.bfloat16, 0.1),
    "tc_gqa_12_to_4_ragged": (2, 12, 4, 200, 200, 64, True, "ragged",
                              torch.bfloat16, 0.25),
    "tc_d128_cross_causal": (2, 4, 4, 130, 70, 128, True, None,
                             torch.bfloat16, 0.5),
    "fma_f32_gqa_s300": (2, 12, 4, 300, 300, 64, True, "ragged",
                         torch.float32, 0.1),
    "fma_bf16_d32": (2, 8, 8, 256, 256, 32, True, None, torch.bfloat16,
                     0.1),
    "fma_f32_d16_cross": (1, 4, 2, 70, 130, 16, False, None, torch.float32,
                          0.9),
    # F5b: the DROP bodies at D 256 and 512
    "fma_f32_d256_gqa_ragged": (2, 4, 2, 130, 130, 256, True, "ragged",
                                torch.float32, 0.1),
    "fma_bf16_d256_packed": (2, 4, 4, 128, 128, 256, False, "packed",
                             torch.bfloat16, 0.1),
    # the D-256 tensor-core forward and dk/dv's DROP instantiations
    "tc_d256_causal_s200": (2, 4, 4, 200, 200, 256, True, None,
                            torch.bfloat16, 0.1),
    "tc_d256_gqa_4_to_2_packed": (2, 4, 2, 192, 192, 256, True, "packed",
                                  torch.bfloat16, 0.1),
    "tc_d256_cross_causal_r25": (2, 4, 4, 130, 70, 256, True, None,
                                 torch.bfloat16, 0.25),
    "tc_d256_cross_causal_r50": (2, 4, 4, 130, 70, 256, True, None,
                                 torch.bfloat16, 0.5),
    "tc_d160_ragged": (2, 4, 4, 130, 130, 160, True, "ragged",
                       torch.bfloat16, 0.1),
    "tc_d200_gqa_packed": (1, 4, 2, 100, 100, 200, False, "packed",
                           torch.bfloat16, 0.5),
    "fma_bf16_d512_cross_causal": (1, 2, 2, 70, 100, 512, True, None,
                                   torch.bfloat16, 0.1),
    "fma_f32_d512": (1, 2, 1, 64, 64, 512, False, None, torch.float32,
                     0.25),
    # F5c: the wide bodies' DROP instantiations
    "wide_f32_d1024_gqa_ragged": (2, 4, 2, 70, 70, 1024, True, "ragged",
                                  torch.float32, 0.1),
    "wide_bf16_d1024_cross_causal": (1, 2, 2, 70, 100, 1024, True, None,
                                     torch.bfloat16, 0.1),
    "wide_bf16_d4096_packed": (1, 2, 2, 48, 48, 4096, False, "packed",
                               torch.bfloat16, 0.25),
    # the D-256 tensor-core dq with grouped-query heads at Sq != Sk, and
    # the wide tensor-core forward's DROP instantiation over three key
    # tiles and four column slices
    "tc_d256_gqa_sq200_sk330": (1, 4, 2, 200, 330, 256, False, None,
                                torch.bfloat16, 0.1),
    "wide_tc_bf16_d1024_gqa_causal_ragged": (2, 4, 2, 200, 200, 1024, True,
                                             "ragged", torch.bfloat16, 0.1),
    # F7: the split wide bodies' DROP instantiations past 8192
    "wide_f32_d8200_gqa_causal": (1, 2, 1, 40, 40, 8200, True, None,
                                  torch.float32, 0.1),
    "wide_tc_bf16_d16384_cross": (1, 2, 2, 70, 100, 16384, False, None,
                                  torch.bfloat16, 0.1),
    # bf16 at D 512 on the wide tensor-core bodies (the case above named
    # fma_bf16_d512 runs them too now), and the f32 wide forward in
    # register tiles: padded from 640, two slices at 2048, sixteen at
    # 16384
    "wide_tc_bf16_d512_gqa_packed_s300": (1, 4, 2, 300, 300, 512, False,
                                          "packed", torch.bfloat16, 0.1),
    "wide_tc_bf16_d300_causal_ragged": (2, 2, 2, 130, 130, 300, True,
                                        "ragged", torch.bfloat16, 0.25),
    "wide_f32_d640_cross": (1, 2, 2, 70, 100, 640, False, None,
                            torch.float32, 0.25),
    "wide_f32_d2048_gqa_packed_causal": (1, 4, 2, 130, 130, 2048, True,
                                         "packed", torch.float32, 0.1),
    "wide_f32_d16384_cross_causal": (1, 2, 1, 40, 70, 16384, True, None,
                                     torch.float32, 0.1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DROP_CASES))
def test_dropout_bodies_match_the_twins_on_card(cuda, name):
    b, h, hk, sq, sk, d, causal, kind, dt, rate = DROP_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(41)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=cuda).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=g, device=cuda).to(dt)
            for _ in range(2))
    seg = None if kind is None else _seg(kind, b, sq, cuda)
    seed = torch.tensor([-123457], dtype=torch.int32, device=cuda)
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg, True, rate,
                                  seed)
    got = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg, rate,
                               seed)
    torch.cuda.synchronize()
    wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, seg, rate, seed)
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, seg, rate,
                              seed)
    torch.testing.assert_close(o, wo, **FLASH_TOL[dt])
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **FLASH_TOL[dt])
    again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg,
                                 rate, seed)
    assert all(torch.equal(a, w) for a, w in zip(again, got))
    assert torch.equal(attn._flash_fwd_cuda(q, k, v, causal, None, seg, True,
                                            rate, seed)[0], o)
    other = attn._flash_fwd_cuda(q, k, v, causal, None, seg, False, rate,
                                 seed + 1)[0]
    assert not torch.equal(other, o)
    bodies = tuple(FLASH_BODIES.values())
    names = _device_kernel_names(lambda: (
        attn._flash_fwd_cuda(q, k, v, causal, None, seg, True, rate, seed),
        attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg, rate,
                             seed)), "flash_", want=bodies)
    # each body seen (a short profiler session may drop a kernel's
    # record, so the count of names is not held), each on its route
    _assert_flash_routes(names, dt, d)
    # the bodies' last template argument is DROP
    assert all(re.search(r"_kernel(_tc_wide|_tc|_wide)?<([^>]*, )?true>", n)
               for n in names)
    wide = attn._kernel_width(d) >= (512 if dt == torch.bfloat16 else 1024)
    assert all(("_wide<" in n) == wide for n in names)


def _keep_mask_readout():
    """chip_smoke.py's readout of the kernels' keep mask (one copy of it),
    loaded from the checkout's root."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.keep_mask_readout


KEEP_CASES = {
    # name: (b, h, sq, sk, d, causal, dtype, rate)
    "tc_causal": (2, 3, 200, 200, 64, True, torch.bfloat16, 0.1),
    "tc_d128_cross": (1, 2, 70, 150, 128, False, torch.bfloat16, 0.5),
    "tc_d256_causal": (1, 2, 130, 130, 256, True, torch.bfloat16, 0.1),
    "tc_d256_cross": (1, 2, 70, 300, 256, False, torch.bfloat16, 0.25),
    "wide_tc_d1024_causal_cross": (1, 2, 130, 1100, 1024, True,
                                   torch.bfloat16, 0.1),
    "wide_tc_d2048_cross": (1, 2, 70, 300, 2048, False, torch.bfloat16,
                            0.25),
    "wide_tc_d512_causal": (1, 2, 130, 130, 512, True, torch.bfloat16, 0.1),
    "wide_tc_d512_cross": (1, 2, 70, 600, 512, False, torch.bfloat16, 0.25),
    "wide_f32_d1024_cross": (1, 2, 70, 300, 1024, False, torch.float32,
                             0.25),
    "fma_f32": (2, 3, 130, 97, 32, False, torch.float32, 0.25),
    "fma_bf16_d16_causal": (1, 2, 90, 90, 16, True, torch.bfloat16, 0.9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KEEP_CASES))
def test_dropout_keep_mask_read_out_of_the_kernels(cuda, name):
    b, h, sq, sk, d, causal, dt, rate = KEEP_CASES[name]
    seed = torch.tensor([2 ** 31 - 2], dtype=torch.int32, device=cuda)
    want = attn.dropout_keep_ref(seed, b, h, sq, sk, rate)
    if causal:
        want &= (torch.arange(sk, device=cuda)[None, :]
                 <= torch.arange(sq, device=cuda)[:, None])
    read = _keep_mask_readout()
    fwd, dv, dq = (read(b, h, sq, sk, d, dt, causal, rate, seed, cuda, side)
                   for side in ("fwd", "dv", "dq"))
    assert torch.equal(fwd, want)
    assert torch.equal(dv, want)
    assert torch.equal(dq, want)
    kept = float(attn.dropout_keep_ref(seed, b, h, sq, sk, rate)
                 .float().mean())
    assert abs(kept - (1.0 - rate)) < 0.01


F5_CASES = {
    # name: (make q, k, v on the card from a generator): each held with
    # its gradients against the twins
    "d8": lambda g, dev: [torch.randn(2, 3, 70, 8, generator=g, device=dev)
                          for _ in range(3)],
    "d80_bf16": lambda g, dev: [torch.randn(
        2, 4, 130, 80, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)],
    "d96_bf16": lambda g, dev: [torch.randn(
        2, 8, 128, 96, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)],
    "transposed_q": lambda g, dev: [torch.randn(
        2, 100, 4, 64, generator=g, device=dev).transpose(1, 2)] + [
        torch.randn(2, 4, 100, 64, generator=g, device=dev)
        for _ in range(2)],
    "q_8_bytes_off": lambda g, dev: [torch.randn(
        4 + 2 * 4 * 64 * 64, generator=g, device=dev).to(torch.bfloat16)[
        4:].view(2, 4, 64, 64)] + [
        torch.randn(2, 4, 64, 64, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(2)],
    "bh_65600_f32": lambda g, dev: [torch.randn(
        65600, 1, 16, 16, generator=g, device=dev) for _ in range(3)],
    # F5b: head dims past 128, padded to 256 and 512
    "d160_bf16": lambda g, dev: [torch.randn(
        2, 4, 100, 160, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)],
    "d192_f32": lambda g, dev: [torch.randn(1, 4, 90, 192, generator=g,
                                            device=dev) for _ in range(3)],
    "d300_bf16": lambda g, dev: [torch.randn(
        1, 2, 70, 300, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)],
    # F5c: head dims past 512, padded to 1024 and 2048
    "d640_bf16": lambda g, dev: [torch.randn(
        2, 2, 70, 640, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)],
    "d1024_f32": lambda g, dev: [torch.randn(1, 2, 90, 1024, generator=g,
                                             device=dev) for _ in range(3)],
    "d1500_f32": lambda g, dev: [torch.randn(1, 1, 33, 1500, generator=g,
                                             device=dev) for _ in range(3)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(F5_CASES))
def test_f5_inputs_compute_with_gradients_on_card(cuda, name):
    """What the card refused before F5's, F5b's and F5c's repairs: head
    dims 8, 80, 96, 160, 192, 300, 640 and 1500 (padded) and 1024, a
    transposed q, a q 8 bytes off
    its alignment (copied), B*H = 65600 (B*H on the grid's x): forward
    and gradients against the twins, with dropout on for the bf16
    cases."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = F5_CASES[name](g, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(q.dtype)
    rate = 0.1 if q.dtype == torch.bfloat16 else 0.0
    seed = 12345 if rate else None
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    counts = [kx.launches for kx in (attn.FLASH_FWD, attn.FLASH_DQ,
                                     attn.FLASH_DKV)]
    o = attn.flash_attention(qq, kk, vv, causal=True, dropout_rate=rate,
                             dropout_seed=seed)
    o.backward(do)
    torch.cuda.synchronize()
    assert [kx.launches - c for kx, c in zip(
        (attn.FLASH_FWD, attn.FLASH_DQ, attn.FLASH_DKV), counts)] == [1, 1, 1]
    wo, lse = attn.flash_fwd_ref(q, k, v, True, None, None, rate, seed)
    want = (wo,) + attn.flash_bwd_ref(q, k, v, o.detach(), lse, do, True,
                                      None, None, rate, seed)
    for a, w in zip((o.detach(), qq.grad, kk.grad, vv.grad), want):
        assert a.shape == w.shape and a.dtype == w.dtype
        torch.testing.assert_close(a, w, **FLASH_TOL[q.dtype])
