"""The port's kernels and engine on the card (skipped without one).

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has only PyTorch:

    python -m pytest --noconftest -q tests/torch_port/test_torch_port_cuda.py

The flash-attention kernel is held against its plain PyTorch version
(``flash_attention_ref``) on the same inputs, f32 with TF32 off,
``atol=rtol=1e-4`` (the kernel sums each row in its own order and uses
the online softmax).  The engine on the card must give the CPU
engine's greedy tokens and must not sync the host inside a window.
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
