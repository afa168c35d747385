#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (found through CUDA_HOME, PATH or
/usr/local/cuda).  Phases, each printing its own lines; any failure
exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — every kernel source under ``apex_tpu_torch/csrc`` with one
   ``nvcc`` each, all started together, for sm_90a, with the build
   seconds and the ptxas register/spill report;
3. kernel vs plain (flash) — the flash-attention kernel against its
   plain PyTorch version on the card at the shapes the serving path gives
   it (f32, TF32 off, ``atol=rtol=1e-4``; rows that see no key must be
   exactly 0), and its time beside the plain version's, the one-call
   PyTorch equivalent's and the card's bound;
4. serve — ``apex_tpu_torch.serving.Engine`` at GPT-2 small's widths
   (random weights from seed 0) serves 16 greedy requests, prompts of
   32..900 tokens, 64 new tokens each; every request must complete with
   its token count, and every prefill must have launched the kernel.
   The serve repeats 3 times on the warm engine: each repeat prints its
   numbers, a summary gives their median and spread, and every repeat
   must give the first one's tokens;
5. consistency (serve) — for two of those requests, a no-cache greedy
   recompute (plain attention) must give the engine's tokens;
6. profile (serve) — device time by kernel in one admission burst and
   one decode window, from ``torch.profiler``;
7. kernel vs plain (flat) — flat_accumulate, flat_unscale_norm and
   flat_sgd against their plain twins at ResNet-50's one amp-O2 bucket
   (25,557,032 elements) and at a ragged length, f32 and bf16 grads, an
   injected NaN/Inf, first step and nesterov on and off, the overflow
   gate (p and buf must keep their bits); each timed beside its plain
   twin, the bytes bound and (flat_sgd) ``torch._fused_sgd_``;
8. train — ``apex_tpu_torch.examples.imagenet_main_amp.train`` runs
   ResNet-50, amp O2, batch 128 at 224x224, ``grad_accum=2``: 3 repeats
   of 9 steps (the first of each a warm-up, so 24 timed), then 4 steps at
   ``grad_accum=1``; losses must be finite and the kernels' launch
   counts exact;
9. consistency (train) — ResNet-18, batch 8 at 64x64, ``grad_accum=2``,
   from the same seed on the card and on the CPU (plain twins): the
   first loss within rtol 1e-5; at O2 after 1 step the final f32
   masters within ten times what the CPU run itself moves by with
   another summation order (measured in the run), at O0 with lr 0.01
   after 2 steps within a tenth of the nearest of three wrong updates
   run on the CPU (lr 4% high, momentum or weight decay dropped); each
   limit must reject the wrong updates it names; O2 after 3 steps is
   printed;
10. profile (train) — device time by kernel over one step at
    ``grad_accum`` 2 and 1: busy share, the top device items, and the
    flat kernels' share.

Kernel times are device milliseconds per call, from CUDA events around
calls queued behind a device-side spin that outlasts the host's
launching them, so the host's launch overhead is not in them.

The line before the last is the ``kernels`` JSON record (every kernel);
the last line is ``{"ok": true, "device": {...}}``.  Nothing of JAX is
imported.  It runs in about two and a half minutes, the kernels' build
included.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

ATOL = RTOL = 1e-4
F32_PEAK = 67e12        # H100 SXM f32 outside the tensor cores, FLOP/s
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3, bytes/s


_SPIN = {}


def _spin(ms: float) -> None:
    """Queue a device-side spin of about ``ms`` milliseconds on the
    current stream (``torch.cuda._sleep``, its clock calibrated once)."""
    import torch
    if not _SPIN:
        cycles = 20_000_000
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _SPIN["cycles_per_ms"] = cycles / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _SPIN["cycles_per_ms"]))


def _ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters``
    calls queued behind a device spin that outlasts the host's launching
    them, so the events time the device's work and not the host's launch
    overhead.  Fails if the spin ended before the host had queued the
    last call (then the time would include host gaps)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        _spin(2.0 * host_ms + 1.0)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        hidden = not start.query()          # the device still spins
        end.synchronize()
        if hidden:
            return start.elapsed_time(end) / iters
        host_ms *= 4.0
    raise SystemExit("chip_smoke FAILED: the device spin never outlasted "
                     "the host's launches")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _ragged_ids(lengths, s, device):
    import torch
    from apex_tpu_torch.ops.attention import packed_segment_ids
    base = (torch.arange(s, device=device)[None, :]
            < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    return packed_segment_ids(base)


def _packed_ids(b, s, device):
    import torch
    from apex_tpu_torch.ops.attention import packed_segment_ids
    base = torch.zeros(b, s, dtype=torch.int32, device=device)
    base[:, : s // 3] = 1
    base[:, s // 3: s - s // 5] = 2
    return packed_segment_ids(base)


def _visible(seg, sq, sk, causal, device):
    """(B, Sq, Sk) bool: the (row, col) pairs the function must compute."""
    import torch
    if seg is None:
        vis = torch.ones(1, sq, sk, dtype=torch.bool, device=device)
    else:
        vis = seg[0][:, :, None] == seg[1][:, None, :]
    if causal:
        vis = vis & (torch.arange(sk, device=device)[None, :]
                     <= torch.arange(sq, device=device)[:, None])
    return vis


def kernel_phase(dev, smi: str) -> dict:
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as attn

    gen = torch.Generator(device=dev).manual_seed(1)
    S = 1024
    cases = [
        # name, b, h, hk, s, d, causal, segment ids
        ("gpt2_prefill_ragged", 4, 12, 12, S, 64, True,
         _ragged_ids([1024, 700, 333, 57], S, dev)),
        ("engine_bucket_1024", 1, 12, 12, S, 64, True,
         _ragged_ids([900], S, dev)),
        ("gqa_12_to_4", 2, 12, 4, 512, 64, True,
         _ragged_ids([512, 301], 512, dev)),
        ("non_causal_packed", 2, 12, 12, 384, 64, False,
         _packed_ids(2, 384, dev)),
        ("below_one_block", 2, 12, 12, 20, 64, True, None),
        ("d128", 2, 8, 8, 256, 128, True, _ragged_ids([256, 77], 256, dev)),
    ]
    worst = 0.0
    timed = {}
    for name, b, h, hk, s, d, causal, seg in cases:
        q = torch.randn(b, h, s, d, generator=gen, device=dev)
        k = torch.randn(b, hk, s, d, generator=gen, device=dev)
        v = torch.randn(b, hk, s, d, generator=gen, device=dev)
        out = attn.flash_attention(q, k, v, causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        ref = attn.flash_attention_ref(q, k, v, causal=causal,
                                       segment_ids=seg)
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, atol=ATOL, rtol=RTOL))
        zero_ok = True
        if seg is not None:
            pad = (seg[0] < 0)[:, None, :, None].expand_as(out)
            zero_ok = bool(torch.all(out[pad] == 0.0))
        print(f"kernel flash_fwd {name} q={tuple(q.shape)} "
              f"k={tuple(k.shape)} causal={causal} "
              f"seg={seg is not None} max_abs_err={err:.3e} "
              f"pass={ok and zero_ok} (atol={ATOL}, rtol={RTOL})",
              flush=True)
        _check(ok, f"flash_fwd {name}: max_abs_err {err} over tolerance")
        _check(zero_ok, f"flash_fwd {name}: a row that sees no key is "
                        "not exactly 0")
        worst = max(worst, err)
        if name in ("gpt2_prefill_ragged", "engine_bucket_1024"):
            timed[name] = (q, k, v, causal, seg)

    row = {}
    for name, (q, k, v, causal, seg) in timed.items():
        b, h, s, d = q.shape
        vis = _visible(seg, s, s, causal, dev)
        pairs = int(vis.sum()) * h
        ops = 4.0 * d * pairs                    # q.k and p.v, 2 per MAC
        # q, k, v read once, o written once, both id vectors read once
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + 8 * b * s
        t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_BYTES_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        ms = _ms(lambda: attn.flash_attention(q, k, v, causal=causal,
                                              segment_ids=seg), iters=20)
        plain_ms = _ms(lambda: attn.flash_attention_ref(
            q, k, v, causal=causal, segment_ids=seg), iters=5, warmup=1)
        mask = vis[:, None]                      # True = attend
        lib_ms = _ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=20)
        print(f"time flash_fwd {name} q={tuple(q.shape)}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {ops:.4e} FLOP, "
              f"{nbytes} B), {ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
              f"[{smi}]", flush=True)
        if name == "gpt2_prefill_ragged":
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms)
    return dict(name="flash_fwd", route="cuda",
                source="apex_tpu_torch/csrc/flash_fwd.cu",
                replaces="apex_tpu/ops/attention.py:411 (_fwd_pallas)",
                max_abs_err=worst, atol=ATOL, rtol=RTOL, **row)


GPT2_SMALL = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                  n_kv_heads=12, ffn=3072, max_seq=1024, eos_token=50256)


SERVE_REPEATS = 3


def _serve_once(eng, cfg, lens, rep: int):
    """One 16-request serve on the warm engine; returns its requests,
    results, launch counts and metrics."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build, serving

    rng = np.random.default_rng(0)          # the same prompts every repeat
    reqs = [serving.Request(
        id=f"s{rep}r{i:02d}", max_new_tokens=64,
        prompt=rng.integers(0, cfg.eos_token, n).tolist())
        for i, n in enumerate(lens)]
    prefills0, windows0 = eng.n_prefills, eng.decode_windows
    prefill_s0, decode_s0 = eng.prefill_s, eng.decode_s
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        _check(eng.submit(r) == "queue", f"{r.id} was shed")
    res = eng.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    prefills = eng.n_prefills - prefills0
    windows = eng.decode_windows - windows0
    n_tok = 0
    for r in reqs:
        out = res[r.id]
        _check(out.verdict == serving.COMPLETED,
               f"{r.id} ended {out.verdict} ({out.reason})")
        n = len(out.tokens)
        _check(n == r.max_new_tokens or (
            0 < n < r.max_new_tokens and out.tokens[-1] == cfg.eos_token),
            f"{r.id}: {n} tokens for max_new_tokens={r.max_new_tokens}")
        _check(all(0 <= t < cfg.vocab_size for t in out.tokens),
               f"{r.id}: token out of range")
        n_tok += n
    eng.arena.check_accounting()
    _check(prefills == len(reqs), f"{prefills} prefills for {len(reqs)}")
    _check(launches["flash_fwd"] == cfg.n_layers * prefills,
           f"flash_fwd launched {launches['flash_fwd']} times over "
           f"{prefills} prefills of {cfg.n_layers} layers")
    for name, n in launches.items():
        if name != "flash_fwd":
            _check(n == 0, f"kernel {name} launched {n} times while "
                           "serving, a path that does not run it")
    prefill_s, decode_s = eng.prefill_s - prefill_s0, eng.decode_s - decode_s0
    metrics = dict(
        wall=wall, tokens=n_tok, tok_s=n_tok / wall,
        ttft_ms=1e3 * sum(res[r.id].ttft_s for r in reqs) / len(reqs),
        win_ms=1e3 * decode_s / max(windows, 1), windows=windows,
        prefill_s=prefill_s, decode_s=decode_s,
        rest_s=wall - prefill_s - decode_s)
    return reqs, res, launches, metrics


def serve_phase(dev, smi: str, entry: dict):
    import numpy as np
    import torch
    from apex_tpu_torch import serving

    cfg = serving.DecoderConfig(**GPT2_SMALL)
    params = serving.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = serving.Engine(params, cfg, page_size=16, n_pages=512,
                         max_slots=8, pages_per_slot=64, window=8,
                         device=dev)
    print(f"serve arena {json.dumps(eng.arena.describe())}", flush=True)
    # warm-up: one short request (cuBLAS handles, allocator)
    eng.submit(serving.Request(id="warmup", prompt=list(range(40)),
                               max_new_tokens=9))
    eng.serve()
    _check(eng.results["warmup"].verdict == serving.COMPLETED, "warm-up")

    lens = np.linspace(32, 900, 16).astype(int)
    runs = []
    for rep in range(SERVE_REPEATS):
        reqs, res, launches, m = _serve_once(eng, cfg, lens, rep)
        if runs:
            first_reqs, first_res = runs[0][0], runs[0][1]
            for a, b in zip(first_reqs, reqs):
                _check(res[b.id].tokens == first_res[a.id].tokens,
                       f"repeat {rep}: {b.id} differs from {a.id}")
        runs.append((reqs, res, launches, m))
        print(f"serve {rep + 1}/{SERVE_REPEATS} gpt2-small 16 requests "
              f"prompts {lens.min()}..{lens.max()} x 64 new tokens: "
              f"{m['tokens']} tokens in {m['wall']:.4f} s = "
              f"{m['tok_s']:.1f} tokens/s, mean TTFT {m['ttft_ms']:.2f} ms, "
              f"{m['win_ms']:.3f} ms per decode window of {eng.window} steps "
              f"({m['windows']} windows); split: prefill "
              f"{m['prefill_s']:.4f} s, decode windows {m['decode_s']:.4f} s, "
              f"rest {m['rest_s']:.4f} s (host clock, each ends in a device "
              f"read-back); flash_fwd launches {launches['flash_fwd']} "
              f"[{smi}]", flush=True)
    for key, label in (("tok_s", "tokens/s"), ("ttft_ms", "mean TTFT ms"),
                       ("win_ms", "ms per decode window"),
                       ("prefill_s", "prefill s"), ("decode_s", "decode s")):
        vals = [m[key] for *_, m in runs]
        print(f"serve summary {label}: median {float(np.median(vals)):.4f}, "
              f"min {min(vals):.4f}, max {max(vals):.4f} over "
              f"{len(vals)} repeats in this run [{smi}]", flush=True)
    print(f"serve repeats: all {SERVE_REPEATS} gave the same tokens",
          flush=True)
    reqs, res, launches, _ = runs[0]
    entry["launches"] = launches["flash_fwd"]
    return eng, reqs, res


def consistency_phase(eng, reqs, res) -> None:
    import torch
    from apex_tpu_torch import serving
    from apex_tpu_torch.ops.attention import flash_attention_ref

    params, cfg = eng.params, eng.cfg
    dev = params["embed"].device
    picks = [min(reqs, key=lambda r: len(r.prompt)),
             max(reqs, key=lambda r: len(r.prompt))]
    for r in picks:
        seq = list(r.prompt)
        engine_tokens = res[r.id].tokens
        for i, tok in enumerate(engine_tokens):
            with torch.no_grad():
                logits, _, _ = serving.prefill_forward(
                    params, cfg, torch.tensor([seq], device=dev),
                    torch.tensor([len(seq)], device=dev),
                    attention=flash_attention_ref)
            _check(tuple(logits.shape) == (1, cfg.vocab_size)
                   and bool(torch.isfinite(logits).all()),
                   f"{r.id}: recompute logits not finite or misshapen")
            nxt = int(torch.argmax(logits[0]))
            if nxt != tok:
                top = torch.topk(logits[0], 2)
                raise SystemExit(
                    f"chip_smoke FAILED: {r.id} step {i}: engine {tok}, "
                    f"no-cache recompute {nxt} (top-2 logits "
                    f"{top.values.tolist()})")
            seq.append(nxt)
        print(f"consistency {r.id}: prompt {len(r.prompt)}, "
              f"{len(engine_tokens)} greedy tokens identical to the "
              "no-cache recompute", flush=True)


def profile_phase(eng, smi: str) -> None:
    """Device time by kernel in one admission burst (a prefill per slot)
    and in the decode window that follows, from ``torch.profiler``.  It
    runs after the measured phases; the profiler slows the host, so the
    busy share it shows is a lower bound on the unprofiled run's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import serving

    rng = np.random.default_rng(1)
    n = eng.arena.spec.max_slots
    for i in range(n):
        eng.submit(serving.Request(
            id=f"profile{i}", max_new_tokens=64,
            prompt=rng.integers(0, eng.cfg.eos_token, 500).tolist()))
    for label, step in ((f"admission of {n} prompts of 500", eng._admit),
                        ("decode window", eng._decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                tot, cnt = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
        busy_us = sum(t for t, _ in by_name.values())
        launches = sum(c for _, c in by_name.values())
        print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
              f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
              f"{launches} device kernels [{smi}]", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (t_us, c) in top:
            print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
                  flush=True)
    eng.serve()


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

RESNET50_BUCKET = 25_557_032     # ResNet-50's one amp-O2 bucket (elements)
FLAT_RAGGED = RESNET50_BUCKET + 3
FLAT_TOL = {"flat_accumulate": (0.0, 0.0), "flat_unscale_norm": (0.0, 1e-5),
            "flat_sgd": (1e-7, 1e-6)}
FLAT_SOURCE = "apex_tpu_torch/csrc/multi_tensor.cu"
FLAT_REPLACES = {
    "flat_accumulate": "apex_tpu/ops/multi_tensor.py:207 (flat_accumulate, "
                       "body _accumulate_kernel :190)",
    "flat_unscale_norm": "apex_tpu/ops/multi_tensor.py:270 "
                         "(flat_unscale_norm, body _unscale_norm_kernel :255)",
    "flat_sgd": "apex_tpu/ops/multi_tensor.py:465 (flat_sgd, body "
                "_sgd_kernel :446)"}


def _close(name, got, want, what):
    import torch
    atol, rtol = FLAT_TOL[name]
    err = float((got.float() - want.float()).abs().nan_to_num(0.0).max()) \
        if got.numel() else 0.0
    ok = bool(torch.allclose(got.float(), want.float(), atol=atol,
                             rtol=rtol, equal_nan=True))
    _check(ok, f"{name} {what}: max_abs_err {err} over tolerance "
               f"(atol={atol}, rtol={rtol})")
    return err


def _bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_PEAK
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


FLAT_SYMBOL = {"flat_accumulate": "accumulate_kernel",
               "flat_unscale_norm": "unscale_norm",
               "flat_sgd": "sgd_kernel"}


def _wrapper_device_split(fn, symbol: str, calls: int = 10):
    """Device time per call of ``fn`` from ``torch.profiler``: of the
    kernels whose name holds ``symbol``, and of all its device work;
    and the device kernels it launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    own = total = 0.0
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.time_range.elapsed_us() / 1e3
            total += t
            count += 1
            if symbol in e.name:
                own += t
    _check(own > 0, f"the profiler saw no {symbol} on the device")
    return own / calls, total / calls, count / calls


def flat_kernel_phase(dev, smi: str) -> list:
    """rows 6, 7, 10 against their plain twins on the card, then timed at
    the shapes a ResNet-50 O2 grad-accum step gives them."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=dev).manual_seed(2)

    def vec(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, device=dev).to(dtype)

    worst = {k: 0.0 for k in FLAT_TOL}
    for n in (RESNET50_BUCKET, FLAT_RAGGED):
        for gdt in (torch.bfloat16, torch.float32):
            for poison in (None, "nan", "inf"):
                acc, g = vec(n), vec(n, gdt)
                if poison:
                    g[n // 3] = float(poison)
                want, wflag = mt.flat_accumulate_ref(acc, g, 1.0)
                _, flag = mt.flat_accumulate(acc, g)
                torch.cuda.synchronize()
                _check(int(flag) == int(wflag) == (poison is not None),
                       f"flat_accumulate flag {int(flag)} for {poison}")
                worst["flat_accumulate"] = max(
                    worst["flat_accumulate"], _close(
                        "flat_accumulate", acc, want,
                        f"n={n} g={gdt} poison={poison} flag={int(flag)}"))
        for poison in (None, "inf"):
            x = vec(n)
            if poison:
                x[n - 1] = float(poison)
            inv = torch.full((), 1.0 / 2 ** 16, device=dev)
            want = mt.flat_unscale_norm_ref(x, inv)
            out, nsq, flag = mt.flat_unscale_norm(x, inv)
            torch.cuda.synchronize()
            _check(int(flag) == int(want[2]) == (poison is not None),
                   f"flat_unscale_norm flag {int(flag)} for {poison}")
            worst["flat_unscale_norm"] = max(
                worst["flat_unscale_norm"],
                _close("flat_unscale_norm", out, want[0],
                       f"out n={n} poison={poison} flag={int(flag)}"))
            if poison is None:
                _close("flat_unscale_norm", nsq, want[1], f"norm_sq n={n}")
                again = mt.flat_unscale_norm(x, inv)[1]
                _check(bool(torch.equal(again, nsq)),
                       "flat_unscale_norm: the sum differs run to run")
        for gdt in (torch.float32, torch.bfloat16):
            for nesterov in (False, True):
                for first in (0, 1):
                    for gs in (1.0, 1024.0):
                        p, g, buf = vec(n), vec(n, gdt), vec(n)
                        kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4,
                                  nesterov=nesterov,
                                  first_run=torch.tensor(first, device=dev),
                                  grad_scale=torch.tensor(gs, device=dev))
                        wp, wb = mt.flat_sgd_ref(p, g, buf, **kw)
                        mt.flat_sgd(p, g, buf, **kw)
                        torch.cuda.synchronize()
                        what = (f"n={n} g={gdt} nesterov={nesterov} "
                                f"first={first} grad_scale={gs}")
                        worst["flat_sgd"] = max(
                            worst["flat_sgd"],
                            _close("flat_sgd", p, wp, "p " + what),
                            _close("flat_sgd", buf, wb, "buf " + what))
        p, g, buf = vec(n), vec(n, torch.bfloat16), vec(n)
        g[7] = float("nan")
        p0, b0 = p.clone(), buf.clone()
        mt.flat_sgd(p, g, buf, lr=0.1, momentum=0.9, weight_decay=1e-4,
                    found_inf=torch.ones((), dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        _check(bool(torch.equal(p, p0) and torch.equal(buf, b0)),
               "flat_sgd with found_inf set changed p or buf")
        print(f"kernel flat kernels n={n}: flat_accumulate (g f32/bf16, "
              f"clean/NaN/Inf: flag set exactly when poisoned), "
              f"flat_unscale_norm (clean/Inf; the sum of squares the same "
              f"bits on a second run), flat_sgd (g f32/bf16 x nesterov x "
              f"first x grad_scale 1/1024; found_inf=1 leaves p and buf "
              f"bit-unchanged) all within tolerance; worst max_abs_err so "
              f"far {worst} (atol, rtol: {FLAT_TOL})", flush=True)

    # time each at the main path's shapes: acc f32 += bf16 model grads;
    # unscale of the f32 accumulators; sgd of the f32 masters by the f32
    # unscaled grads with an f32 momentum buffer
    n = RESNET50_BUCKET
    acc, g16, x = vec(n), vec(n, torch.bfloat16), vec(n)
    p, g, buf = vec(n), vec(n), vec(n)
    one = torch.ones((), device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), device=dev)
    first = torch.zeros((), dtype=torch.int32, device=dev)
    sgd_kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, first_run=first,
                  grad_scale=one)

    def sgd_plain():                 # the CPU branch of flat_sgd, on the card
        wp, wb = mt.flat_sgd_ref(p, g, buf, **sgd_kw)
        keep = zero_i == 0
        return torch.where(keep, wp, p), torch.where(keep, wb, buf)

    timings = {
        "flat_accumulate": (
            lambda: mt.flat_accumulate(acc, g16),
            lambda: mt.flat_accumulate_ref(acc, g16), None,
            (4 + 2 + 4) * n, 2 * n,
            "null: no one call adds and flags the non-finite RESULT"),
        "flat_unscale_norm": (
            lambda: mt.flat_unscale_norm(x, one),
            lambda: mt.flat_unscale_norm_ref(x, one), None,
            (4 + 4) * n + 8, 3 * n,
            "null: no one call unscales, sums squares and flags"),
        "flat_sgd": (
            lambda: mt.flat_sgd(p, g, buf, found_inf=zero_i, **sgd_kw),
            sgd_plain,
            lambda: torch._fused_sgd_(
                [p], [g], [buf], weight_decay=1e-4, momentum=0.9, lr=0.1,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False, grad_scale=one, found_inf=zero_f),
            (4 + 4 + 4 + 4 + 4) * n + 12, 8 * n,
            "torch._fused_sgd_ (tensor grad_scale and found_inf)"),
    }
    entries = []
    for name, (kern, plain, lib, nbytes, ops, lib_note) in timings.items():
        ms = _ms(kern, iters=50, warmup=3)
        own_ms, all_ms, per_call = _wrapper_device_split(
            kern, FLAT_SYMBOL[name])
        print(f"profile {name} n={n}, 10 wrapper calls: its kernels "
              f"{own_ms:.4f} ms a call, all device work {all_ms:.4f} ms a "
              f"call in {per_call:g} device kernels (the rest: the "
              f"wrapper's fills and scalar ops) [{smi}]", flush=True)
        plain_ms = _ms(plain, iters=10, warmup=2)
        lib_ms = _ms(lib, iters=50, warmup=3) if lib else None
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"time {name} n={n}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'%.4f ms' % lib_ms if lib_ms else 'n/a'} ({lib_note}), "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops} "
              f"FLOP), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s = "
              f"{100 * bound_ms / ms:.1f}% of the HBM bound [{smi}]",
              flush=True)
        atol, rtol = FLAT_TOL[name]
        entries.append(dict(
            name=name, route="cuda", source=FLAT_SOURCE,
            replaces=FLAT_REPLACES[name], launches=0,
            max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            atol=atol, rtol=rtol))
    return entries


TRAIN = dict(arch="resnet50", opt_level="O2", batch=128, image=224)
TRAIN_REPEATS, TRAIN_STEPS, ACCUM = 3, 9, 2


def _train_once(dev, grad_accum: int, steps: int, step_events=None):
    """One run of the trainer with the launch counts zeroed just before
    it; returns the result and the counts read just after."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp

    def on_step(step):
        if step_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            step_events.append(ev)

    _build.reset_launch_counts()
    res = main_amp.train(device=dev, grad_accum=grad_accum, steps=steps,
                         log=None, on_step=on_step, **TRAIN)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS}
    _check(all(math.isfinite(v) for v in res.losses),
           f"train: non-finite loss {res.losses}")
    want = {"flash_fwd": 0, "flat_accumulate": grad_accum * steps
            if grad_accum > 1 else 0,
            "flat_unscale_norm": steps if grad_accum > 1 else 0,
            "flat_sgd": steps}
    _check(launches == want, f"train grad_accum={grad_accum}: launches "
                             f"{launches}, expected {want}")
    return res, launches


def train_phase(dev, smi: str, entries: list) -> None:
    import numpy as np
    import torch

    runs = []
    torch.cuda.reset_peak_memory_stats(dev)
    for rep in range(TRAIN_REPEATS):
        events = []
        res, launches = _train_once(dev, ACCUM, TRAIN_STEPS, events)
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        runs.append((res, launches, step_ms))
        print(f"train {rep + 1}/{TRAIN_REPEATS} resnet50 O2 batch "
              f"{res.batch} {res.image}x{res.image} grad_accum {ACCUM}: "
              f"{TRAIN_STEPS} steps, {res.imgs_per_sec:.1f} imgs/s over "
              f"the {TRAIN_STEPS - 1} after the first, "
              f"{1e3 * res.step_seconds:.2f} ms/step (host clock), device "
              f"ms/step median {float(np.median(step_ms)):.2f} (CUDA events "
              f"between steps), losses {[round(v, 4) for v in res.losses]}, "
              f"launches {launches} [{smi}]", flush=True)
    imgs = [r.imgs_per_sec for r, _, _ in runs]
    ms = [1e3 * r.step_seconds for r, _, _ in runs]
    print(f"train summary resnet50 O2 b128 224 grad_accum {ACCUM}: imgs/s "
          f"median {float(np.median(imgs)):.1f} (min {min(imgs):.1f}, max "
          f"{max(imgs):.1f}); ms/step median {float(np.median(ms)):.2f} "
          f"(min {min(ms):.2f}, max {max(ms):.2f}) over {TRAIN_REPEATS} "
          f"repeats, {TRAIN_REPEATS * (TRAIN_STEPS - 1)} timed steps; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          f" GiB [{smi}]", flush=True)
    res1, launches1 = _train_once(dev, 1, 4)
    print(f"train resnet50 O2 b128 224 grad_accum 1: 4 steps, "
          f"{res1.imgs_per_sec:.1f} imgs/s over the 3 after the first, "
          f"{1e3 * res1.step_seconds:.2f} ms/step, losses "
          f"{[round(v, 4) for v in res1.losses]}, launches {launches1} "
          f"[{smi}]", flush=True)
    first_launches = runs[0][1]
    for e in entries:
        e["launches"] = first_launches[e["name"]]


CONSIST = dict(arch="resnet18", batch=8, image=64, grad_accum=2, seed=0,
               log=None)
FIRST_LOSS_RTOL = 1e-5
ORDER_FACTOR = MUTANT_FACTOR = 10.0
# wrong updates, run on the CPU, that show what a limit rejects
MUTANTS = {"lr 4% high": lambda lr: dict(lr=1.04 * lr),
           "momentum dropped": lambda lr: dict(momentum=0.0),
           "weight decay dropped": lambda lr: dict(weight_decay=0.0)}
# (opt level, lr, steps, what sets the masters' limit, the mutants the
# limit must reject): "order" is ORDER_FACTOR x the CPU's own
# summation-order yardstick, "mutants" the nearest of the named wrong
# updates / MUTANT_FACTOR, None prints the reading only
CONSIST_CASES = (
    ("O2", 0.1, 1, "order", ("lr 4% high",)),
    ("O0", 0.01, 2, "mutants", tuple(MUTANTS)),
    ("O2", 0.1, 3, None, ()))


def _gap(got, want, init) -> float:
    """||got - want|| / ||want - init|| over every leaf (L2): how far two
    runs' weights are apart, as a share of how far training moved them."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(want, init))
    return math.sqrt(num / den)


def _loss_rel(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def train_consistency_phase(dev) -> None:
    """ResNet-18, batch 8 at 64x64, ``grad_accum=2``, from the same seed
    on the card (kernels, cuDNN) and on the CPU (plain twins, oneDNN),
    in the cases of ``CONSIST_CASES``.

    The first loss comes from identical weights: rtol 1e-5.  After that
    the runs differ by the order in which each convolution sums, which
    the CPU run shows by itself with oneDNN off (the summation-order
    yardstick, measured in this run).  The final f32 masters (the f32
    params at O0) are compared by their gap as a share of their
    displacement (``_gap``), the later losses within ten times the
    yardstick's loss difference.  At O2 after one step (``first_run``)
    the masters' limit is ten times the yardstick; it must reject an lr
    4% high.  At O0 after two steps (the momentum blend) the yardstick
    moves from one CPU to another by four orders of magnitude, so the
    limit is a tenth of the gap of the nearest wrong update (``MUTANTS``,
    run on the CPU): the card must be ten times closer to the CPU's
    update than dropping weight decay or momentum, or a 4% lr error,
    would put it.  O2 after three steps is printed and held only to its
    first loss."""
    import torch
    from apex_tpu_torch._tree import tree_leaves, tree_map
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp
    from apex_tpu_torch.models import resnet18

    params, stats = resnet18().init(CONSIST["seed"], "cpu")
    init = [t.numpy() for t in tree_leaves(params)]

    def run(device, opt_level, steps, **hypers):
        var = tuple(tree_map(lambda t: t.to(device), v)
                    for v in (params, stats))
        res = main_amp.train(device=device, opt_level=opt_level,
                             steps=steps, variables=var, **CONSIST,
                             **hypers)
        work = (res.opt.masters if res.opt.masters is not None
                else res.opt.params)
        return res.losses, [m.float().cpu().numpy()
                            for m in tree_leaves(work)]

    for opt_level, lr, steps, limit, must_reject in CONSIST_CASES:
        card_l, card_m = run(dev, opt_level, steps, lr=lr)
        cpu_l, cpu_m = run("cpu", opt_level, steps, lr=lr)
        torch.backends.mkldnn.enabled = False
        try:
            order_l, order_m = run("cpu", opt_level, steps, lr=lr)
        finally:
            torch.backends.mkldnn.enabled = True
        _check(all(math.isfinite(v) for v in card_l + cpu_l),
               f"train consistency: non-finite loss {card_l} {cpu_l}")
        rel0 = abs(card_l[0] - cpu_l[0]) / abs(cpu_l[0])
        rel, gap = _loss_rel(card_l, cpu_l), _gap(card_m, cpu_m, init)
        order_rel = _loss_rel(order_l, cpu_l)
        order_gap = _gap(order_m, cpu_m, init)
        mutants = {}
        for name, hypers in (MUTANTS.items() if limit else ()):
            mut_l, mut_m = run("cpu", opt_level, steps,
                               **{"lr": lr, **hypers(lr)})
            mutants[name] = _gap(mut_m, cpu_m, init)
        rel_tol = max(FIRST_LOSS_RTOL, ORDER_FACTOR * order_rel)
        gap_tol = {"order": ORDER_FACTOR * order_gap, None: math.inf,
                   "mutants": min([mutants[k] for k in must_reject]
                                  or [math.inf]) / MUTANT_FACTOR}[limit]
        held = {"order": f"tol {gap_tol:.3e} = {ORDER_FACTOR:g} x the "
                         "yardstick",
                "mutants": f"tol {gap_tol:.3e} = the nearest named wrong "
                           f"update / {MUTANT_FACTOR:g}",
                None: "printed only"}[limit]
        print(f"consistency train resnet18 {opt_level} lr {lr} b8 64x64 "
              f"grad_accum 2, {steps} step(s): card losses "
              f"{[round(v, 6) for v in card_l]}, cpu "
              f"{[round(v, 6) for v in cpu_l]}; first loss rel diff "
              f"{rel0:.3e} (tol {FIRST_LOSS_RTOL}), max loss rel diff "
              f"{rel:.3e} ({f'tol {rel_tol:.3e}' if limit else held}), "
              f"masters' gap {gap:.3e} of their displacement ({held}); "
              f"cpu summation-order yardstick: loss {order_rel:.3e}, gap "
              f"{order_gap:.3e}"
              + ("; wrong updates on the cpu (gap): " + ", ".join(
                  f"{k} {g:.3e} ({'rejected' if g > gap_tol else 'passes'}"
                  f"{', must be rejected' if k in must_reject else ''})"
                  for k, g in mutants.items()) if mutants else ""),
              flush=True)
        _check(rel0 <= FIRST_LOSS_RTOL,
               f"train consistency: first loss differs by {rel0}")
        if limit is None:
            continue
        _check(rel <= rel_tol, f"train consistency {opt_level}: losses "
                               f"differ by {rel}")
        _check(gap <= gap_tol, f"train consistency {opt_level}: masters' "
                               f"gap {gap} after {steps} step(s)")
        for name in must_reject:
            _check(mutants[name] > gap_tol,
                   f"train consistency {opt_level}: the limit after "
                   f"{steps} step(s) does not reject '{name}'")


def train_profile_phase(dev, smi: str, grad_accum: int) -> None:
    """Device time by kernel over one training step (the second of a
    2-step run; the first warms up), from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(step):
        if step == 0:
            prof.start()
            clock["t0"] = time.perf_counter()
        else:
            torch.cuda.synchronize()
            clock["wall"] = time.perf_counter() - clock["t0"]
            prof.stop()

    main_amp.train(device=dev, grad_accum=grad_accum, steps=2, log=None,
                   on_step=on_step, **TRAIN)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    wall = 1e3 * clock["wall"]
    flat = sum(t for name, (t, _) in by_name.items()
               if any(k in name for k in FLAT_SYMBOL.values()))
    flat /= 1e3
    print(f"profile train step resnet50 O2 b128 grad_accum {grad_accum}: "
          f"wall "
          f"{wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}"
          f"%), {sum(c for _, c in by_name.values())} device kernels; split:"
          f" flat tail (accumulate/unscale/sgd) {flat:.3f} ms "
          f"({100 * flat / busy:.2f}% of busy), forward+backward and other "
          f"device work {busy - flat:.2f} ms, rest (device idle) "
          f"{wall - busy:.2f} ms [{smi}]", flush=True)
    for name, (t_us, c) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:12]:
        print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
              flush=True)
    for name, (t_us, c) in sorted(by_name.items()):
        if any(k in name for k in FLAT_SYMBOL.values()):
            print(f"profile   flat {t_us / 1e3:9.3f} ms {c:4d}x {name[:80]}",
                  flush=True)



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention, multi_tensor  # noqa: F401
    # (importing the op modules registers their kernels)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all({k.library for k in _build.KERNELS})
    for k in _build.KERNELS:
        k.function()                       # loads its library
    print(f"build {len({k.library for k in _build.KERNELS})} source(s), "
          f"{len(_build.KERNELS)} kernel(s) "
          f"({', '.join(k.name for k in _build.KERNELS)}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(1 for line in log.splitlines()
                     if "spill" in line and not
                     ("0 bytes spill stores" in line
                      and "0 bytes spill loads" in line))
        print(f"ptxas {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"{spills} with spills", flush=True)

    with torch.no_grad():
        entry = kernel_phase(dev, smi)
        eng, reqs, res = serve_phase(dev, smi, entry)
        consistency_phase(eng, reqs, res)
        profile_phase(eng, smi)
        del eng
        flat_entries = flat_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    train_phase(dev, smi, flat_entries)
    train_consistency_phase(dev)
    for grad_accum in (ACCUM, 1):
        train_profile_phase(dev, smi, grad_accum)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "atol", "rtol")
    kernels = [{k: e[k] for k in keys} for e in [entry] + flat_entries]
    _check(len(kernels) == len(_build.KERNELS),
           f"the kernels line has {len(kernels)} entries for "
           f"{len(_build.KERNELS)} kernels")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
