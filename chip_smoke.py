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
   The serve repeats twice on the warm engine: each repeat prints its
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
   ResNet-50, amp O2, batch 128 at 224x224, ``grad_accum=2``: 2 repeats
   of 9 steps (the first of each a warm-up, so 16 timed), then 4 steps at
   ``grad_accum=1``; losses must be finite and the kernels' launch
   counts exact;
9. consistency (train) — ResNet-18, batch 8 at 64x64, ``grad_accum=2``,
   from the same seed on the card and on the CPU (plain twins): the
   first loss within rtol 1e-5; at O2 after 1 step the final f32
   masters within ten times what the CPU run itself moves by with
   another summation order (measured in the run), at O0 with lr 0.01
   after 2 steps, from the nearer of the CPU's two summation orders,
   within a tenth of the nearer of two wrong updates run on the CPU (lr
   4% high, momentum dropped; weight decay dropped is printed); each
   limit must reject the wrong updates it names; O2 after 3 steps is
   printed;
10. profile (train) — device time by kernel over one step at
    ``grad_accum`` 2 and 1: busy share, the top device items, and the
    flat kernels' share;
11. kernel vs plain (BERT) — the LayerNorm forward and backward kernels
    against their twins at BERT-Large's (4096, 1024) bf16 (LN and RMS),
    in f32 and at a wide shape (one bf16 rounding, or f32 within 1e-5;
    dw/db within 1e-4 of their scale; the same bits run to run);
    flat_l2norm (rtol 1e-5, the same bits run to run, NaN/Inf
    propagate) and both flat_lamb stages (the twin's bits exactly; with
    ``found_inf`` set p, m and v keep theirs) at BERT-Large's one O2
    bucket of 334,096,384 elements in 292 segments; each timed beside
    its twin, its bytes bound and a one-call PyTorch yardstick;
12. train (BERT) — BERT-Large (24 x 1024, 16 heads, FFN 4096, vocab
    30528), amp O2, FusedLAMB (lr 1e-3, weight decay 0.01, max grad norm
    1), padded batches of 8 x 512 (lengths 128..512 from
    ``default_rng(1)``), the step of ``examples/bert/pretrain_mlm.py``
    built from the port's API: 2 warm-up and 8 timed steps, ms per step,
    real tokens per second, peak memory, finite losses and exact launch
    counts (49 LayerNorm forwards and backwards, one flat_l2norm and one
    of each LAMB stage per bucket, a step);
13. profile (BERT) — one step under ``torch.profiler``: busy share, the
    largest device items, the five kernels' share;
14. train (BERT, flash) — the same BERT-Large step on the example's
    default unmasked 8 x 512 batch and on a packed one (``--packed``),
    both through flash attention with gradients: 2 warm-up and 4 timed
    steps each, finite losses, exact launch counts (24 flash forwards,
    dq and dk/dv a step besides the LayerNorm and LAMB counts);
15. consistency (BERT) — a 2-layer BERT at BERT-Large's widths, one O2
    step on the card and on the CPU from the same seed, on a padded and
    on an unmasked batch: the masters within a tenth of the nearest of
    three wrong updates run on the CPU (trust ratio, global clip or
    weight decay dropped);
16. kernel vs plain (attention training) — the flash forward with its
    logsumexp and the dq, dk/dv kernels against their twins on the card
    at the GPT block's (8, 12, 512, 64) bf16 causal, BERT-Large's (8,
    16, 512, 64) bf16 unmasked and packed with pad rows, grouped-query
    heads (12 to 4) at Sq = 200, and f32 (within 1e-4; bf16 within 2e-2,
    one bf16 rounding); rows that see no key (and keys no row sees) give
    exact zeros; the same bits on a second run; each timed beside its
    twin, its bound and SDPA's forward or backward;
17. kernel vs plain (Adam) — flat_adam at GPT-2 small's one O2 bucket
    (124,046,592 elements) and a ragged length, AdamW and Adam with and
    without bias correction: the twin's bits exactly; with ``found_inf``
    set p, m and v keep theirs; timed beside its twin, the bytes bound
    and ``torch._fused_adamw_``;
18. train (GPT block) — ``apex_tpu_torch.examples.gpt_train_block`` at
    GPT-2 small's widths (12 x 768, 12 heads, seq 512, batch 8, vocab
    50257), amp O2, FusedAdam lr 3e-4: 2 warm-up and 8 timed steps, ms
    per step, tokens/s, peak memory, finite losses and exact launch
    counts (12 flash forwards, dq and dk/dv, 25 LayerNorm forwards and
    backwards, one flat_unscale_norm and one flat_adam per bucket, a
    step);
19. profile (GPT block) — one step under ``torch.profiler``: busy share,
    the largest device items, the port's kernels' share;
20. consistency (GPT block) — a 2-layer stack at GPT-2 small's widths,
    one O2 step (bf16 model) and two O0 steps (f32 model) on the card
    and on the CPU from one seed (FusedAdam eps 1e-4): the masters within
    a tenth of the nearest wrong update run on the CPU that each case
    names (O2: attention not causal, bias correction dropped; O0: those
    and lr 4% high); and three O0 steps with FusedNovoGrad (lr 1e-2,
    weight decay 0.1, the clip at 1), held to a tenth of the nearest of
    reg_inside_moment flipped, beta2 used for beta1 and lr 4% high;
21. kernel vs plain (optimizer tail) — flat_scale, flat_axpby,
    flat_adagrad and flat_novograd against their twins at GPT-2 small's
    O2 bucket (124,046,592 elements in its 148 leaves) and at a ragged
    length: the twin's bits (atol 0), the flag raised by a planted inf
    and NaN, found_inf keeping every bit, the same bits on a second run;
    each timed beside its twin, its bytes bound and a one-call PyTorch
    yardstick where there is one;
22. train (GPT block, NovoGrad) — the same GPT-2 small step with
    FusedNovoGrad at the reference's defaults (lr 1e-3) through the flat
    pipeline with max_grad_norm 1: 2 warm-up and 4 timed steps, ms per
    step, tokens/s, peak memory, losses finite and falling, exact launch
    counts (one flat_novograd a bucket a step, no flat_adam), and one
    profiled step (busy share, the port's kernels' share);
23. train (legacy fp16_utils) — FP16_Optimizer(FusedAdagrad) with a
    dynamic loss scale on the GPT stack cut to 2 layers (widths and
    vocabulary kept, bf16 model): 3 steps of scaled backward, packed
    master grads, clip_master_grads (flat_l2norm and flat_scale a
    bucket) and step; the second step's planted inf is skipped with every
    bit kept and the scale halves; exact launch counts.

Kernel times are device milliseconds per call, from CUDA events around
calls queued behind a device-side spin that outlasts the host's
launching them, so the host's launch overhead is not in them.

The line before the last is the ``kernels`` JSON record (every kernel);
the last line is ``{"ok": true, "device": {...}}``.  Nothing of JAX is
imported.
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


SERVE_REPEATS = 2


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


def _bound(nbytes: float, ops: float, peak: float = F32_PEAK):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# kernel: (names of its device kernels, how many of them a call launches)
FLAT_SYMBOL = {"flat_accumulate": (("accumulate_kernel",), 1),
               "flat_unscale_norm": (("unscale_norm", "sum_combine"), 2),
               "flat_sgd": (("sgd_kernel",), 1)}


def _owns(name: str, symbols) -> bool:
    return any(sym in name for sym in symbols)


def _wrapper_device_split(fn, symbols, own_per_call: int, calls: int = 10):
    """Device time per call of ``fn`` from ``torch.profiler``: of its own
    kernels (names holding one of ``symbols``, ``own_per_call`` of them a
    call), and of all the device work captured; and the device kernels
    captured per call.  After other profiles in the same process the
    profiler has dropped the first few kernels of a window, so the own
    time is the mean of the own kernels it did capture times their
    number a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    own = total = 0.0
    count = n_own = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.time_range.elapsed_us() / 1e3
            total += t
            count += 1
            if _owns(e.name, symbols):
                own += t
                n_own += 1
    _check(n_own > 0, f"the profiler saw no {symbols} on the device")
    return own / n_own * own_per_call, total / calls, count / calls


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
            kern, *FLAT_SYMBOL[name])
        print(f"profile {name} n={n}, 10 wrapper calls: its kernels "
              f"{own_ms:.4f} ms a call, all device work captured "
              f"{all_ms:.4f} ms a call in {per_call:g} device kernels (the "
              f"rest: the wrapper's fills and scalar ops) [{smi}]",
              flush=True)
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
TRAIN_REPEATS, TRAIN_STEPS, ACCUM = 2, 9, 2


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
    want = {k.name: 0 for k in _build.KERNELS}
    want.update({"flat_accumulate": grad_accum * steps
                 if grad_accum > 1 else 0,
                 "flat_unscale_norm": steps if grad_accum > 1 else 0,
                 "flat_sgd": steps})
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
# At O0 the limit is a tenth of the nearer of "lr 4% high" and "momentum
# dropped": dropping weight decay (1e-4 at lr 0.01, two steps) moves the
# masters by 2.7e-4 of their displacement on a CPU whose two orders agree
# to 6e-6, as little as the card's own summation order moves them
# (1.3e-4-7.0e-4), so no limit holds it apart; it is printed, and held by
# the kernel phase (flat_sgd against its twin, bit for bit).
CONSIST_CASES = (
    ("O2", 0.1, 1, "order", ("lr 4% high",)),
    ("O0", 0.01, 2, "mutants", ("lr 4% high", "momentum dropped")),
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
    limit is a tenth of the gap of the nearest wrong update it names
    (``MUTANTS``, run on the CPU): the card must be ten times closer to
    the CPU's update than dropping momentum or a 4% lr error would put
    it (weight decay: see ``CONSIST_CASES``).  On the card's machine the CPU's two orders (oneDNN on
    and off) end 5.6e-2 apart there, and the card lands beside one or
    the other as cuDNN picks its convolution algorithms in the run
    (1.348e-4 from oneDNN on in most runs, 7.0e-4 from oneDNN off in
    one): it is held to the nearer of the two.  O2 after three steps is
    printed and held only to its first loss."""
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
        if limit == "mutants":
            # after two steps the CPU's own two summation orders end
            # further apart than a wrong update moves the masters, and
            # the card lands beside one or the other (cuDNN picks its
            # algorithms per run): hold it to the nearer
            gap = min(gap, _gap(card_m, order_m, init))
            rel = min(rel, _loss_rel(card_l, order_l))
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
              f"masters' gap {gap:.3e} of their displacement"
              f"{' from the nearer cpu order' if limit == 'mutants' else ''}"
              f" ({held}); "
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
               if any(_owns(name, syms) for syms, _ in FLAT_SYMBOL.values()))
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
        if any(_owns(name, syms) for syms, _ in FLAT_SYMBOL.values()):
            print(f"profile   flat {t_us / 1e3:9.3f} ms {c:4d}x {name[:80]}",
                  flush=True)


# ---------------------------------------------------------------------------
# the BERT MLM pretraining path
# ---------------------------------------------------------------------------

BERT = dict(batch=8, seq=512, lengths=(128, 512), warmup=2, steps=8)
BERT_LAMB = dict(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0)
BERT_LAYERS = 24
LN_PER_STEP = 1 + 2 * BERT_LAYERS        # embedding LN + 2 per layer
# kernel: (source, replaces, tolerance (atol, rtol) against its twin,
# (names of its device kernels, how many a call launches))
BERT_KERNELS = {
    "layer_norm_fwd": (
        "apex_tpu_torch/csrc/layer_norm.cu",
        "apex_tpu/ops/layer_norm.py:118 (_fwd_2d, body _ln_fwd_kernel :63)",
        (2e-2, 2e-2), (("ln_fwd_kernel",), 1)),
    "layer_norm_bwd": (
        "apex_tpu_torch/csrc/layer_norm.cu",
        "apex_tpu/ops/layer_norm.py:135 (_bwd_2d, body _ln_bwd_kernel :77)",
        (2e-2, 2e-2), (("ln_bwd_",), 3)),
    "flat_l2norm": (
        FLAT_SOURCE, "apex_tpu/ops/multi_tensor.py:325 (flat_l2norm, body "
                     "_l2norm_kernel :314)", (0.0, 1e-5),
        (("sumsq_kernel", "sum_combine"), 2)),
    "flat_lamb_moments": (
        FLAT_SOURCE, "apex_tpu/ops/multi_tensor.py:878 (flat_lamb stage 1, "
                     "body _lamb_moment_kernel :824)", (0.0, 0.0),
        (("lamb_moment_kernel",), 1)),
    "flat_lamb_apply": (
        FLAT_SOURCE, "apex_tpu/ops/multi_tensor.py:897 (flat_lamb stage 2, "
                     "body _apply_update_kernel :838)", (0.0, 0.0),
        (("lamb_apply_kernel",), 1)),
}
# the LayerNorm tolerances by output dtype: one bf16 rounding, or f32
# sums in another order (dx and the f32 dw/db: 1e-4 of their scale)
LN_TOL = {"bf16": (2e-2, 2e-2), "f32": (1e-5, 1e-5), "grad_f32": 1e-4}


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def _held(name, got, want, atol, rtol, what) -> float:
    import torch
    err = _err(got, want)
    ok = bool(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol))
    _check(ok, f"{name} {what}: max_abs_err {err} over tolerance "
               f"(atol={atol}, rtol={rtol})")
    return err


def _ln_checks(dev) -> dict:
    """The LayerNorm kernels against their twins at BERT-L's (4096, 1024)
    bf16 (LN and RMS), in f32, and at a ragged wide shape; returns the
    worst error of each kernel at the main path's dtype."""
    import torch
    from apex_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(3)
    worst = {"layer_norm_fwd": 0.0, "layer_norm_bwd": 0.0}
    for rows, h, dt, rms in ((4096, 1024, torch.bfloat16, False),
                             (4096, 1024, torch.bfloat16, True),
                             (4096, 1024, torch.float32, False),
                             (333, 8192, torch.float32, True)):
        x = (torch.randn(rows, h, generator=g, device=dev) * 3 + 1).to(dt)
        w = (torch.randn(h, generator=g, device=dev) * 0.1 + 1).to(dt)
        b = (torch.randn(h, generator=g, device=dev) * 0.1).to(dt)
        dy = torch.randn(rows, h, generator=g, device=dev).to(dt)
        y = ln._fwd_2d(x, w, b, 1e-5, rms)
        dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
        torch.cuda.synchronize()
        wy = ln._fwd_2d_ref(x, w, b, 1e-5, rms)
        wdx, wdw, wdb = ln._bwd_2d_ref(x, w, dy, 1e-5, rms)
        half = dt == torch.bfloat16
        atol, rtol = LN_TOL["bf16" if half else "f32"]
        what = f"({rows}, {h}) {dt} rms={rms}"
        e_fwd = _held("layer_norm_fwd", y, wy, atol, rtol, what)
        e_dx = _held("layer_norm_bwd", dx, wdx, *((atol, rtol) if half else
                                                  (1e-4, 1e-4)), "dx " + what)
        for nm, got, want in (("dw", dw, wdw), ("db", db, wdb)):
            scale = float(want.abs().max())
            _held("layer_norm_bwd", got, want, LN_TOL["grad_f32"] * scale,
                  LN_TOL["grad_f32"], f"{nm} {what}")
        again = ln._bwd_2d(x, w, dy, 1e-5, rms)
        _check(bool(torch.equal(again[0], dx) and torch.equal(again[1], dw)),
               f"layer_norm_bwd {what}: the result differs run to run")
        if half and not rms:
            worst["layer_norm_fwd"], worst["layer_norm_bwd"] = e_fwd, e_dx
        print(f"kernel layer_norm {what}: fwd max_abs_err {e_fwd:.3e}, dx "
              f"{e_dx:.3e}, dw {_err(dw, wdw):.3e}, db {_err(db, wdb):.3e}; "
              "the same bits on a second run", flush=True)
    return worst


def _bert_bucket(dev, sizes):
    """LAMB inputs at the shape of BERT-L's one O2 bucket: f32 masters,
    bf16 grads, f32 moments, the plan's segment ids."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    n = sum(sizes)
    p = torch.randn(n, generator=g, device=dev) * 0.05
    grad = (torch.randn(n, generator=g, device=dev) * 1e-3).to(torch.bfloat16)
    m = torch.randn(n, generator=g, device=dev) * 1e-4
    v = torch.randn(n, generator=g, device=dev).square() * 1e-7
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=dev),
        torch.tensor(sizes, device=dev), output_size=n)
    return p, grad, m, v, seg


def bert_kernel_phase(dev, smi: str, sizes) -> list:
    """The five kernels of the BERT path against their twins on the card
    at BERT-L's shapes (LayerNorm (4096, 1024) bf16; the flat kernels at
    the O2 bucket of ``sizes``), then timed beside twin, library call and
    bound."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt

    worst = _ln_checks(dev)
    n = sum(sizes)
    p, grad, m, v, seg = _bert_bucket(dev, sizes)
    norm = mt.flat_l2norm(grad)
    torch.cuda.synchronize()
    worst["flat_l2norm"] = _held("flat_l2norm", norm,
                                 mt.flat_l2norm_ref(grad), 0.0, 1e-5,
                                 f"n={n}")
    _check(bool(torch.equal(mt.flat_l2norm(grad), norm)),
           "flat_l2norm: the sum differs run to run")
    for poison in ("nan", "inf"):
        bad = grad.clone()
        bad[n // 3] = float(poison)
        got = float(mt.flat_l2norm(bad))
        _check(math.isnan(got) if poison == "nan" else got == math.inf,
               f"flat_l2norm with an injected {poison} gave {got}")
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              step=torch.tensor(3, dtype=torch.int32, device=dev),
              grad_scale=torch.tensor(1.0, device=dev),
              clip_coeff=torch.tensor(0.5, device=dev))
    want = mt.flat_lamb_ref(p, grad, m, v, seg, sizes, **kw)
    got = mt.flat_lamb(p.clone(), grad, m.clone(), v.clone(), seg, sizes,
                       found_inf=torch.zeros((), dtype=torch.int32,
                                             device=dev), **kw)
    torch.cuda.synchronize()
    worst["flat_lamb_moments"] = max(
        _held("flat_lamb_moments", got[1], want[1], 0.0, 0.0, "m"),
        _held("flat_lamb_moments", got[2], want[2], 0.0, 0.0, "v"))
    worst["flat_lamb_apply"] = _held("flat_lamb_apply", got[0], want[0],
                                     0.0, 0.0, "p")
    del want, got
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    bad = grad.clone()
    bad[7] = float("nan")
    mt.flat_lamb(p, bad, m, v, seg, sizes, found_inf=torch.ones(
        (), dtype=torch.int32, device=dev), **kw)
    torch.cuda.synchronize()
    _check(bool(torch.equal(p, p0) and torch.equal(m, m0)
                and torch.equal(v, v0)),
           "flat_lamb with found_inf set changed p, m or v")
    del p0, m0, v0, bad
    print(f"kernel flat kernels n={n} ({len(sizes)} segments): flat_l2norm "
          f"within rtol 1e-5 of its twin, the same bits on a second run, "
          f"NaN and Inf propagate; flat_lamb stages 1 and 2 equal to their "
          f"twin's bits (masters f32, grads bf16, step 3, clip 0.5); "
          f"found_inf=1 leaves p, m and v bit-unchanged", flush=True)

    # timing at the main path's shapes
    g = torch.Generator(device=dev).manual_seed(5)
    rows, h = BERT["batch"] * BERT["seq"], 1024
    x = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
    w = torch.ones(h, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(h, device=dev, dtype=torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], w, b, 1e-5)
    c1r, c2r, gmul = mt._lamb_scalars(0.9, 0.999, kw["step"], True,
                                      kw["grad_scale"], kw["clip_coeff"], dev)
    upd = torch.empty(n, device=dev)
    hyp = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    mt._lamb_moments(p, grad, m, v, upd, c1r, c2r, gmul, gate=zero, **hyp)
    factor = mt._lamb_trust_factor(p, upd, sizes, 1e-3, 0.01, False)
    per_elem = factor[seg.long()]
    el = rows * h
    timings = {
        # name: (kernel, plain, library, library note, bytes, operations)
        "layer_norm_fwd": (
            lambda: ln._fwd_2d(x, w, b, 1e-5, False),
            lambda: ln._fwd_2d_ref(x, w, b, 1e-5, False),
            lambda: F.layer_norm(x, (h,), w, b, 1e-5), "F.layer_norm",
            2 * el + 2 * el + 4 * h, 8 * el),
        "layer_norm_bwd": (
            lambda: ln._bwd_2d(x, w, dy, 1e-5, False),
            lambda: ln._bwd_2d_ref(x, w, dy, 1e-5, False),
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [h], mean, rstd, w, b, [True, True, True]),
            "aten.native_layer_norm_backward (with saved mean/rstd)",
            2 * el * 3 + 2 * h + 8 * h, 14 * el),
        "flat_l2norm": (
            lambda: mt.flat_l2norm(grad), lambda: mt.flat_l2norm_ref(grad),
            lambda: torch.linalg.vector_norm(grad, dtype=torch.float32),
            "torch.linalg.vector_norm(dtype=float32)", 2 * n + 4, 2 * n),
        "flat_lamb_moments": (
            lambda: mt._lamb_moments(p, grad, m, v, upd, c1r, c2r, gmul,
                                     gate=zero, **hyp),
            lambda: mt._lamb_moments_ref(p, grad, m, v, c1r, c2r, gmul,
                                         **hyp),
            None, "null: no one PyTorch call writes both moments and the "
                  "raw LAMB update (torch._fused_adam_ applies it to p)",
            (4 + 2 + 4 + 4 + 4 + 4 + 4) * n, 15 * n),
        "flat_lamb_apply": (
            lambda: mt._lamb_apply(p, upd, factor, seg, gate=zero),
            lambda: mt._lamb_apply_ref(p, upd, factor, seg),
            lambda: torch.addcmul(p, per_elem, upd, value=-1),
            "torch.addcmul(p, factor[seg_ids], update, value=-1)",
            (4 + 4 + 4 + 4) * n, 2 * n),
    }
    entries = []
    for name, (kern, plain, lib, lib_note, nbytes, ops) in timings.items():
        source, replaces, (atol, rtol), symbol = BERT_KERNELS[name]
        ms = _ms(kern, iters=20, warmup=3)
        own_ms, all_ms, per_call = _wrapper_device_split(kern, *symbol)
        plain_ms = _ms(plain, iters=5, warmup=1)
        lib_ms = _ms(lib, iters=20, warmup=3) if lib else None
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"time {name}: kernel {ms:.4f} ms (its own kernels {own_ms:.4f}"
              f" ms; all device work captured {all_ms:.4f} ms in "
              f"{per_call:g} device kernels a call, profiler), plain {plain_ms:.4f} ms, library "
              f"{'%.4f ms' % lib_ms if lib_ms else 'n/a'} ({lib_note}), "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops} "
              f"FLOP), {100 * bound_ms / ms:.1f}% of the bound [{smi}]",
              flush=True)
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            atol=atol, rtol=rtol))
    return entries


def bert_batches(rng, n, batch, seq, lengths, vocab, device):
    """Padded MLM batches: lengths uniform in ``lengths``, tokens in
    [1, vocab) on real positions (0 on padding), the mask 1 on real
    positions, labels in [0, vocab) there and -1 on padding.  Returns
    ``[(tokens, labels, mask, real tokens)]``."""
    import numpy as np
    import torch
    out = []
    for _ in range(n):
        lens = rng.integers(lengths[0], lengths[1] + 1, batch)
        real = np.arange(seq)[None, :] < lens[:, None]
        tokens = np.where(real, rng.integers(1, vocab, (batch, seq)), 0)
        labels = np.where(real, rng.integers(0, vocab, (batch, seq)), -1)
        out.append((torch.from_numpy(tokens).to(device),
                    torch.from_numpy(labels).to(device),
                    torch.from_numpy(real.astype(np.int32)).to(device),
                    int(real.sum())))
    return out


def bert_setup(model, params, device, **lamb):
    """amp O2 over ``params`` (f32, moved to ``device``) and a FusedLAMB
    over the result, with the training step of
    ``examples/bert/pretrain_mlm.py``, through its port
    (``apex_tpu_torch.examples.bert_pretrain_mlm.setup``); returns
    ``(opt, amp_state, step)``, ``step(amp_state, tokens, labels,
    attention_mask=None, segment_ids=None, positions=None) -> (loss,
    amp_state)``."""
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain
    return pretrain.setup(model, params, device, **{**BERT_LAMB, **lamb})


def _bert_launches_expected(steps: int, buckets: int) -> dict:
    from apex_tpu_torch import _build
    want = {k.name: 0 for k in _build.KERNELS}
    want.update({"layer_norm_fwd": LN_PER_STEP * steps,
                 "layer_norm_bwd": LN_PER_STEP * steps,
                 "flat_l2norm": buckets * steps,
                 "flat_lamb_moments": buckets * steps,
                 "flat_lamb_apply": buckets * steps})
    return want


def bert_train_phase(dev, smi: str, entries: list, params) -> tuple:
    """BERT-L (24 x 1024, 16 heads, FFN 4096, vocab 30528, 512 positions)
    at amp O2 with FusedLAMB on padded batches of 8 x 512 from
    ``default_rng(1)``: warm-up steps, then timed steps with the launch
    counts zeroed just before them and read just after."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import bert_large
    from apex_tpu_torch.models.bert import f32_out_matmul_route

    model = bert_large(dtype=torch.bfloat16, max_seq_len=BERT["seq"])
    torch.cuda.reset_peak_memory_stats(dev)
    opt, amp_state, step = bert_setup(model, params, dev)
    plan = opt._plan
    print(f"bert plan {json.dumps(plan.describe())}; MLM head GEMM route "
          f"{f32_out_matmul_route(torch.zeros(1, dtype=torch.bfloat16, device=dev))}",
          flush=True)
    rng = np.random.default_rng(1)
    batches = bert_batches(rng, 4, BERT["batch"], BERT["seq"],
                           BERT["lengths"], model.vocab_size, dev)
    for i in range(BERT["warmup"]):
        loss, amp_state = step(amp_state, *batches[i % 4][:3])
    torch.cuda.synchronize()
    steps = BERT["steps"]
    _build.reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses, real = [], 0
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        tokens, labels, mask, n_real = batches[i % 4]
        loss, amp_state = step(amp_state, tokens, labels, mask)
        losses.append(loss)
        real += n_real
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    losses = [float(x) for x in losses]
    _check(all(math.isfinite(x) for x in losses),
           f"bert train: non-finite loss {losses}")
    want = _bert_launches_expected(steps, len(plan.buckets))
    _check(launches == want, f"bert train: launches {launches}, expected "
                             f"{want}")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"train bert-large O2 FusedLAMB b{BERT['batch']} s{BERT['seq']} "
          f"padded (lengths {BERT['lengths'][0]}..{BERT['lengths'][1]}): "
          f"{steps} timed steps after {BERT['warmup']} warm-up, "
          f"{1e3 * wall / steps:.2f} ms/step (host clock), device ms/step "
          f"median {float(np.median(step_ms)):.2f} (min {min(step_ms):.2f}, "
          f"max {max(step_ms):.2f}; CUDA events between steps), "
          f"{real / wall:.1f} real tokens/s ({real / steps:.0f} real of "
          f"{BERT['batch'] * BERT['seq']} positions a step), losses "
          f"{[round(x, 4) for x in losses]}, loss scale "
          f"{float(amp_state.scaler.loss_scale):.0f}, peak device memory "
          f"{peak:.2f} GiB, launches {launches} ({LN_PER_STEP} LN fwd and "
          f"bwd, one l2norm and one of each LAMB stage per bucket, a step) "
          f"[{smi}]", flush=True)
    for e in entries:
        e["launches"] = launches[e["name"]]
    return opt, amp_state, step, batches


BERT_CONSIST = dict(num_layers=2, batch=2, seq=128, lengths=(32, 128))
# eps of the check's step (the main run keeps FusedLAMB's 1e-6): at 1e-6
# one step's update is close to sign(g), and bf16 activations summed in
# another order flip the sign of near-zero gradients (on the CPU, oneDNN
# off or one thread moved the masters by 0.028-0.032 of their
# displacement, over a tenth of the clip mutant's 0.11); at 1e-4 those
# moves are 0.0055-0.0061 and the clip mutant's 0.357
BERT_CONSIST_LAMB = dict(eps=1e-4)
BERT_FIRST_LOSS_RTOL = 2e-3
BERT_MUTANTS = {"trust ratio dropped": None,
                "global clip dropped": dict(max_grad_norm=0.0),
                "weight decay dropped": dict(weight_decay=0.0)}


def bert_consistency_phase(dev) -> None:
    """One O2 FusedLAMB step (eps 1e-4: ``BERT_CONSIST_LAMB``) of a
    2-layer BERT at BERT-L's widths (hidden 1024, 16 heads, vocab 30528),
    batch 2 x 128, padded (the masked attention) and unmasked (flash
    attention with gradients), from the same seed on the card (kernels)
    and on the CPU (plain twins).  The first loss comes from identical
    weights but bf16 activations summed in each device's order: rtol
    2e-3.  The final f32 masters' gap (``_gap``: as a share of their
    displacement) must be under a tenth of the nearest of three wrong
    updates run on the CPU (the trust ratio, the global clip or the
    weight decay dropped), so the limit rejects each."""
    import numpy as np
    import torch
    from apex_tpu_torch._tree import tree_leaves
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.ops import multi_tensor as mt

    cfg = BERT_CONSIST
    model = BertModel(vocab_size=30528, hidden_size=1024, num_heads=16,
                      num_layers=cfg["num_layers"], max_seq_len=512,
                      dtype=torch.bfloat16)
    params = model.init(0, "cpu")
    init = [t.numpy() for t in tree_leaves(params)]
    (padded,) = bert_batches(np.random.default_rng(2), 1, cfg["batch"],
                             cfg["seq"], cfg["lengths"], model.vocab_size,
                             "cpu")
    rng = np.random.default_rng(3)
    batches = {
        "padded": dict(zip(("tokens", "labels", "attention_mask"),
                           padded[:3])),
        "unmasked": {k: torch.from_numpy(rng.integers(
            0, model.vocab_size, (cfg["batch"], cfg["seq"])))
            for k in ("tokens", "labels")}}

    def run(device, inputs, **lamb):
        opt, state, step = bert_setup(model, params, device,
                                      **{**BERT_CONSIST_LAMB, **lamb})
        loss, state = step(state, **{k: t.to(device)
                                     for k, t in inputs.items()})
        return float(loss), [m.float().cpu().numpy()
                             for m in tree_leaves(opt.masters)]

    for kind, inputs in batches.items():
        card_l, card_m = run(dev, inputs)
        cpu_l, cpu_m = run("cpu", inputs)
        gaps = {}
        for name, lamb in BERT_MUTANTS.items():
            if lamb is None:                      # every trust ratio 1
                real = mt._lamb_trust_factor
                mt._lamb_trust_factor = (lambda p, u, sizes, lr, wd, nv:
                                         torch.full((len(sizes),),
                                                    mt._f32_value(lr)))
                try:
                    _, mut_m = run("cpu", inputs)
                finally:
                    mt._lamb_trust_factor = real
            else:
                _, mut_m = run("cpu", inputs, **lamb)
            gaps[name] = _gap(mut_m, cpu_m, init)
        rel0 = abs(card_l - cpu_l) / abs(cpu_l)
        gap = _gap(card_m, cpu_m, init)
        limit = min(gaps.values()) / MUTANT_FACTOR
        print(f"consistency train bert 2x1024 vocab 30528 O2 FusedLAMB b"
              f"{cfg['batch']} s{cfg['seq']} {kind}, 1 step: card loss "
              f"{card_l:.6f}, cpu {cpu_l:.6f} (rel diff {rel0:.3e}, tol "
              f"{BERT_FIRST_LOSS_RTOL}); masters' gap {gap:.3e} of their "
              f"displacement, tol {limit:.3e} = the nearest wrong update / "
              f"{MUTANT_FACTOR:g}; wrong updates on the cpu (gap): "
              + ", ".join(f"{k} {g:.3e} "
                          f"({'rejected' if g > limit else 'passes'})"
                          for k, g in gaps.items()), flush=True)
        _check(rel0 <= BERT_FIRST_LOSS_RTOL,
               f"bert consistency {kind}: first loss differs by {rel0}")
        _check(gap <= limit, f"bert consistency {kind}: masters' gap {gap} "
                             f"over {limit}")
        for name, g in gaps.items():
            _check(g > limit, f"bert consistency {kind}: the limit does not "
                              f"reject '{name}'")


def bert_profile_phase(dev, smi: str, step, amp_state, batches) -> None:
    """Device time by kernel over one BERT-L training step, from
    ``torch.profiler``: the busy share, the largest device items and the
    five kernels' share of busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens, labels, mask, _ = batches[0]
    loss, amp_state = step(amp_state, tokens, labels, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, amp_state = step(amp_state, tokens, labels, mask)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    ours = {k: sum(t for name, (t, _) in by_name.items()
                   if _owns(name, v[3][0])) / 1e3
            for k, v in BERT_KERNELS.items()}
    total = sum(ours.values())
    print(f"profile train step bert-large O2 b{BERT['batch']} "
          f"s{BERT['seq']}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), "
          f"{sum(c for _, c in by_name.values())} device kernels; the five "
          f"BERT kernels {total:.3f} ms ({100 * total / busy:.2f}% of busy): "
          + ", ".join(f"{s} {t:.3f} ms" for s, t in ours.items())
          + f"; rest (device idle) {wall - busy:.2f} ms [{smi}]", flush=True)
    for name, (t_us, c) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:14]:
        print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
              flush=True)


# ---------------------------------------------------------------------------
# the GPT block path (and BERT's unmasked and packed batches): flash
# attention with gradients, flat_adam
# ---------------------------------------------------------------------------

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core rate, FLOP/s
FLASH_BWD_SOURCE = "apex_tpu_torch/csrc/flash_bwd.cu"
# kernel: (source, replaces, (names of its device kernels, a call's count))
GPT_KERNELS = {
    "flash_dq": (FLASH_BWD_SOURCE,
                 "apex_tpu/ops/attention.py:670 (_bwd_pallas dq call, body "
                 "_dq_kernel :503)", (("flash_dq_kernel",), 1)),
    "flash_dkv": (FLASH_BWD_SOURCE,
                  "apex_tpu/ops/attention.py:702 (_bwd_pallas dk/dv call, "
                  "body _dkv_kernel :544)", (("flash_dkv_kernel",), 1)),
    "flat_adam": (FLAT_SOURCE,
                  "apex_tpu/ops/multi_tensor.py:402 (flat_adam, body "
                  "_adam_kernel :351)", (("adam_kernel",), 1)),
}
# the attention kernels against their twins: f32 within 1e-4 (sums in
# another order); bf16 within one bf16 rounding of each output, plus the
# forward's p rounded against the running row max where the twin rounds
# it against the final one (2e-2); lse (f32) within 1e-4
ATTN_TOL = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 2e-2)}
ATTN_CASES = (
    # name, b, h, hk, s, d, causal, segment ids, dtype
    ("gpt2_block", 8, 12, 12, 512, 64, True, None, "bf16"),
    ("bert_large_unmasked", 8, 16, 16, 512, 64, False, None, "bf16"),
    ("bert_large_packed", 8, 16, 16, 512, 64, False, "packed", "bf16"),
    ("gqa_12_to_4_s200", 2, 12, 4, 200, 64, True, "ragged", "bf16"),
    ("f32_gqa_s300", 2, 12, 4, 300, 64, True, "ragged", "f32"),
    ("f32_d128_packed", 2, 8, 8, 256, 128, False, "packed", "f32"),
)
GPT_BUCKET = 124_046_592        # GPT-2 small's one amp-O2 bucket (elements)
ADAM_RAGGED = 70_001
GPT = dict(layers=12, hidden=768, heads=12, seq=512, batch=8, vocab=50257,
           lr=3e-4, warmup=2, steps=8)
LN_PER_GPT_STEP = 2 * GPT["layers"] + 1   # 2 per block + the final norm


def _dtype(name):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def _pairs(seg, b, h, s, causal, dev) -> int:
    """The (row, col) pairs attention must compute, over every head."""
    vis = _visible(seg, s, s, causal, dev)
    return int(vis.sum()) * h * (b if vis.shape[0] == 1 else 1)


def _attn_costs(b, h, hk, s, d, elt, pairs):
    """(bytes, FLOP) of the forward, dq and dk/dv: each input read once,
    each output written once; 2 FLOP a multiply-add, over the visible
    pairs (forward q.k and p.v; dq also dO.v and ds.k; dk/dv q.k, dO.v,
    p.dO and ds.q)."""
    qb, kvb, rows = elt * b * h * s * d, elt * b * hk * s * d, 4 * b * h * s
    return {"flash_fwd": (2 * qb + 2 * kvb + rows, 4.0 * d * pairs),
            "flash_dq": (3 * qb + 2 * kvb + 2 * rows, 6.0 * d * pairs),
            "flash_dkv": (2 * qb + 4 * kvb + 2 * rows, 8.0 * d * pairs)}


def _bwd_kernel_calls(q, k, v, o, lse, do, causal, seg):
    """The dq and dk/dv kernels, each launched on its own with the
    arguments the wrapper gives them (to time each)."""
    import torch
    from apex_tpu_torch.ops import attention as attn
    (b, h, hk, sq, sk, d), code, qp, kp = attn._geometry(q, k, v, seg)
    di = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    common = (code, b, h, hk, sq, sk, d, int(causal), 1.0 / math.sqrt(d),
              torch.cuda.current_stream().cuda_stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), di.data_ptr())
    return (lambda: attn.FLASH_DQ.launch(*ins, dq.data_ptr(), qp, kp,
                                         *common),
            lambda: attn.FLASH_DKV.launch(*ins, dk.data_ptr(), dv.data_ptr(),
                                          qp, kp, *common))


def attn_train_kernel_phase(dev, smi: str) -> dict:
    """The forward with lse and the dq, dk/dv kernels against their twins
    on the card (the twins' backward takes the kernel's o and lse, so each
    kernel is held on the same inputs), then timed at the GPT block's and
    BERT-L's shapes beside the twins, SDPA and the bound.  Returns the
    worst error of each kernel and the GPT-shape timing rows."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as attn

    gen = torch.Generator(device=dev).manual_seed(6)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for name, b, h, hk, s, d, causal, kind, dtn in ATTN_CASES:
        dt = _dtype(dtn)
        q, k, v, do = (torch.randn(b, n, s, d, generator=gen,
                                   device=dev).to(dt)
                       for n in (h, hk, hk, h))
        seg = {None: None, "packed": _packed_ids(b, s, dev),
               "ragged": _ragged_ids([s, s // 3 + 1] * (b // 2), s,
                                     dev)}[kind]
        o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg, True)
        grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg)
        torch.cuda.synchronize()
        wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, seg)
        wgrads = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, seg)
        atol, rtol = ATTN_TOL[dtn]
        what = f"{name} q={tuple(q.shape)} k={tuple(k.shape)} {dtn}"
        errs = [_held("flash_fwd", o, wo, atol, rtol, "o " + what),
                _held("flash_fwd", lse, wlse, 1e-4, 1e-5, "lse " + what)]
        errs += [_held(kn, g, w, atol, rtol, f"{gn} {what}")
                 for kn, gn, g, w in zip(("flash_dq", "flash_dkv",
                                          "flash_dkv"), ("dq", "dk", "dv"),
                                         grads, wgrads)]
        if seg is not None:
            for t, ids in zip((o,) + grads, (seg[0], seg[0], seg[1],
                                             seg[1])):
                pad = (ids < 0)[:, None, :, None].expand_as(t)
                _check(bool(torch.all(t[pad] == 0)),
                       f"{what}: a row that sees no key (or a key no row "
                       "sees) is not exactly 0")
        again_o, again_lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg,
                                                  True)
        again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg)
        _check(bool(torch.equal(again_o, o) and torch.equal(again_lse, lse)
                    and all(torch.equal(a, g) for a, g in zip(again, grads))),
               f"flash attention {what}: the result differs run to run")
        if dtn == "bf16" and b == 8:
            worst["flash_fwd"] = max(worst["flash_fwd"], errs[0])
            worst["flash_dq"] = max(worst["flash_dq"], errs[2])
            worst["flash_dkv"] = max(worst["flash_dkv"], *errs[3:])
        print(f"kernel flash train {what} causal={causal} seg={kind}: "
              f"max_abs_err o {errs[0]:.3e}, lse {errs[1]:.3e}, dq "
              f"{errs[2]:.3e}, dk {errs[3]:.3e}, dv {errs[4]:.3e} (atol="
              f"{atol}, rtol={rtol}); exact zeros where nothing is seen; "
              "the same bits on a second run", flush=True)
        del q, k, v, do, o, lse, grads, wo, wlse, wgrads, again

    rows = {}
    for name, b, h, hk, s, d, causal, kind, dtn in ATTN_CASES[:2]:
        dt = _dtype(dtn)
        q, k, v, do = (torch.randn(b, n, s, d, generator=gen,
                                   device=dev).to(dt)
                       for n in (h, hk, hk, h))
        o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True)
        dq_fn, dkv_fn = _bwd_kernel_calls(q, k, v, o, lse, do, causal, None)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qq, kk, vv,
                                                 is_causal=causal)
        bwd_plain = lambda: attn.flash_bwd_ref(q, k, v, o, lse, do, causal)
        bwd_lib = lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                              retain_graph=True)
        times = {
            "flash_fwd": (
                lambda: attn._flash_fwd_cuda(q, k, v, causal, None, None,
                                             True),
                lambda: attn.flash_fwd_ref(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                "SDPA forward"),
            "flash_dq": (dq_fn, bwd_plain, bwd_lib,
                         "SDPA backward: dq, dk and dv in one call; plain: "
                         "flash_bwd_ref, all three"),
            "flash_dkv": (dkv_fn, bwd_plain, bwd_lib,
                          "SDPA backward: dq, dk and dv in one call; plain: "
                          "flash_bwd_ref, all three"),
        }
        costs = _attn_costs(b, h, hk, s, d, 2, _pairs(None, b, h, s, causal,
                                                      dev))
        for kname, (kern, plain, lib, note) in times.items():
            ms = _ms(kern, iters=10, warmup=2)
            plain_ms = _ms(plain, iters=3, warmup=1)
            lib_ms = _ms(lib, iters=10, warmup=2)
            nbytes, ops = costs[kname]
            bound_ms, bound_by = _bound(nbytes, ops, BF16_PEAK)
            print(f"time {kname} {name} q={tuple(q.shape)} bf16 causal="
                  f"{causal}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib_ms:.4f} ms ({note}), bound {bound_ms:.4f} "
                  f"ms ({bound_by}: {nbytes} B, {ops:.4e} FLOP at the bf16 "
                  f"rate), {ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                  f"{100 * bound_ms / ms:.2f}% of the bound [{smi}]",
                  flush=True)
            if name == "gpt2_block":
                rows[kname] = dict(ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib_ms)
        del q, k, v, do, o, lse, qq, kk, vv, out
    return dict(worst=worst, rows=rows)


def adam_kernel_phase(dev, smi: str) -> dict:
    """flat_adam against its twin on the card at GPT-2 small's O2 bucket
    and a ragged length: AdamW and Adam, with and without bias
    correction, f32 masters and bf16 grads; the twin's bits exactly (the
    grad scale a power of two); with ``found_inf`` set p, m and v keep
    theirs; then timed beside the twin, the bound and
    ``torch._fused_adamw_``."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=dev).manual_seed(7)

    def vec(n, scale=1.0, dtype=torch.float32):
        return (torch.randn(n, generator=gen, device=dev) * scale).to(dtype)

    worst = 0.0
    for n in (ADAM_RAGGED, GPT_BUCKET):     # the bucket's buffers stay
        p, g = vec(n, 0.02), vec(n, 1e-3, torch.bfloat16)
        m, v = vec(n, 1e-4), vec(n, 1e-3).square()
        for aw in (True, False):
            for bc in (True, False):
                kw = dict(lr=torch.tensor(3e-4, device=dev), beta1=0.9,
                          beta2=0.999, eps=1e-8, weight_decay=0.01,
                          step=torch.tensor(3, dtype=torch.int32,
                                            device=dev),
                          adam_w_mode=aw, bias_correction=bc,
                          grad_scale=torch.tensor(1.0 if bc else 65536.0,
                                                  device=dev))
                want = mt.flat_adam_ref(p, g, m, v, **kw)
                got = mt.flat_adam(p.clone(), g, m.clone(), v.clone(),
                                   found_inf=torch.zeros(
                                       (), dtype=torch.int32, device=dev),
                                   **kw)
                torch.cuda.synchronize()
                for nm, a, w in zip("pmv", got, want):
                    worst = max(worst, _held(
                        "flat_adam", a, w, 0.0, 0.0,
                        f"{nm} n={n} adam_w_mode={aw} bias_correction={bc}"))
                del want, got
        p0, m0, v0 = p.clone(), m.clone(), v.clone()
        bad = g.clone()
        bad[n // 2] = float("inf")
        mt.flat_adam(p, bad, m, v, lr=3e-4, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.01,
                     found_inf=torch.ones((), dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        _check(bool(torch.equal(p, p0) and torch.equal(m, m0)
                    and torch.equal(v, v0)),
               "flat_adam with found_inf set changed p, m or v")
        del p0, m0, v0, bad
        print(f"kernel flat_adam n={n}: AdamW and Adam x bias correction on "
              f"and off (masters f32, grads bf16, step 3, grad scale 1 or "
              f"65536) equal to the twin's bits; found_inf=1 leaves p, m "
              f"and v bit-unchanged", flush=True)

    _check(p.numel() == GPT_BUCKET, "flat_adam is timed at the bucket")
    n = GPT_BUCKET
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    kw = dict(lr=torch.tensor(3e-4, device=dev), beta1=0.9, beta2=0.999,
              eps=1e-8, weight_decay=0.01, step=step,
              grad_scale=torch.ones((), device=dev))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    g32 = g.float()
    fstep = step.float()
    nbytes, ops = (4 + 4 + 2 + 4 + 4 + 4 + 4) * n, 16 * n
    ms = _ms(lambda: mt.flat_adam(p, g, m, v, found_inf=zero, **kw),
             iters=20, warmup=3)
    plain_ms = _ms(lambda: mt.flat_adam_ref(p, g, m, v, **kw), iters=5,
                   warmup=1)
    lib_ms = _ms(lambda: torch._fused_adamw_(
        [p], [g32], [m], [v], [], [fstep], lr=3e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
        iters=20, warmup=3)
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"time flat_adam n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library {lib_ms:.4f} ms (torch._fused_adamw_, f32 grads: 2 "
          f"bytes an element more), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes} B, {ops} FLOP), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
          f"= {100 * bound_ms / ms:.1f}% of the HBM bound [{smi}]",
          flush=True)
    return dict(worst=worst, row=dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=lib_ms))


def _gpt_launches_expected(steps: int, buckets: int) -> dict:
    from apex_tpu_torch import _build
    want = {k.name: 0 for k in _build.KERNELS}
    L = GPT["layers"]
    want.update({"flash_fwd": L * steps, "flash_dq": L * steps,
                 "flash_dkv": L * steps,
                 "layer_norm_fwd": LN_PER_GPT_STEP * steps,
                 "layer_norm_bwd": LN_PER_GPT_STEP * steps,
                 "flat_unscale_norm": buckets * steps,
                 "flat_adam": buckets * steps})
    return want


def gpt_train_phase(dev, smi: str, entries: list):
    """GPT-2 small's block stack (12 x 768, 12 heads, seq 512, batch 8,
    vocab 50257), amp O2, FusedAdam lr 3e-4, through the example's API
    (``apex_tpu_torch.examples.gpt_train_block.setup``): warm-up steps,
    then timed steps with the launch counts zeroed just before them and
    read just after."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import gpt_train_block as ex

    t0 = time.perf_counter()
    model = ex.GPTBlocks(GPT["vocab"], GPT["hidden"], GPT["heads"],
                         GPT["layers"], max_seq=GPT["seq"])
    params = model.init(0, "cpu")
    torch.cuda.reset_peak_memory_stats(dev)
    s = ex.setup(model, params, dev, opt_level="O2", lr=GPT["lr"])
    del params
    sizes = [b.size for b in s.opt._plan.buckets]
    _check(sizes == [GPT_BUCKET], f"gpt: O2 buckets {sizes}, expected one "
                                  f"of {GPT_BUCKET}")
    print(f"gpt-2 small block stack: {sum(sizes)} parameters in one O2 "
          f"bucket, init and setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    tokens = ex.synthetic_tokens(GPT["batch"], GPT["seq"], GPT["vocab"],
                                 device=dev)
    state = s.amp_state
    for _ in range(GPT["warmup"]):
        loss, state = s.step(state, tokens)
    torch.cuda.synchronize()
    steps = GPT["steps"]
    _build.reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        loss, state = s.step(state, tokens)
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    losses = [float(x) for x in losses]
    _check(all(math.isfinite(x) for x in losses),
           f"gpt train: non-finite loss {losses}")
    want = _gpt_launches_expected(steps, len(sizes))
    _check(launches == want, f"gpt train: launches {launches}, expected "
                             f"{want}")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    toks = GPT["batch"] * GPT["seq"]
    print(f"train gpt-2 small block stack O2 FusedAdam b{GPT['batch']} "
          f"s{GPT['seq']}: {steps} timed steps after {GPT['warmup']} "
          f"warm-up, {1e3 * wall / steps:.2f} ms/step (host clock), device "
          f"ms/step median {float(np.median(step_ms)):.2f} (min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}; CUDA events between "
          f"steps), {toks * steps / wall:.1f} tokens/s, losses "
          f"{[round(x, 4) for x in losses]}, loss scale "
          f"{float(state.scaler.loss_scale):.0f}, peak device memory "
          f"{peak:.2f} GiB, launches {launches} ({GPT['layers']} flash fwd, "
          f"dq and dk/dv, {LN_PER_GPT_STEP} LN fwd and bwd, one "
          f"flat_unscale_norm and one flat_adam per bucket, a step) [{smi}]",
          flush=True)
    for e in entries:
        if e["name"] in ("flash_dq", "flash_dkv", "flat_adam"):
            e["launches"] = launches[e["name"]]
    return s, state, tokens


# the device kernels of the GPT step that the port owns
GPT_OWN = {"flash_fwd": ("flash_fwd_kernel",),
           "flash_dq": ("flash_dq_kernel",),
           "flash_dkv": ("flash_dkv_kernel",),
           "layer_norm": ("ln_fwd_kernel", "ln_bwd_"),
           "flat_unscale_norm": ("unscale_norm", "sum_combine"),
           "flat_adam": ("adam_kernel",)}


def gpt_profile_phase(dev, smi: str, s, state, tokens,
                      optimizer: str = "FusedAdam", own=None) -> None:
    """Device time by kernel over one GPT block training step, from
    ``torch.profiler``: the busy share, the largest device items and the
    port's kernels' (``own``, default ``GPT_OWN``) share of busy time."""
    own = GPT_OWN if own is None else own
    import torch
    from torch.profiler import ProfilerActivity, profile

    loss, state = s.step(state, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, state = s.step(state, tokens)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    ours = {k: sum(t for name, (t, _) in by_name.items()
                   if _owns(name, syms)) / 1e3
            for k, syms in own.items()}
    total = sum(ours.values())
    print(f"profile train step gpt-2 small O2 {optimizer} b{GPT['batch']} "
          f"s{GPT['seq']}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), "
          f"{sum(c for _, c in by_name.values())} device kernels; the "
          f"port's kernels {total:.3f} ms ({100 * total / busy:.2f}% of "
          f"busy): " + ", ".join(f"{k} {t:.3f} ms" for k, t in ours.items())
          + f"; rest (device idle) {wall - busy:.2f} ms [{smi}]", flush=True)
    for name, (t_us, c) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:14]:
        print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
              flush=True)


GPT_CONSIST = dict(layers=2, batch=2, seq=128)
GPT_MUTANTS = ("attention not causal", "bias correction dropped",
               "lr 4% high")
# eps of the check's FusedAdam (the main run keeps 1e-8): at 1e-8 Adam's
# first steps move each element by about lr * sign(g), so every gradient
# near the rounding of its sums jumps by up to 2 lr between two summation
# orders.  Measured on a CPU (one thread against all, this config): at
# eps 1e-8 the O2 masters move by 3.8e-2 of their displacement, at 1e-4
# by 8.7e-3; at O0 (f32 model) by 1.3e-4 and 2.0e-6.
GPT_CONSIST_ADAM = dict(eps=1e-4)
# The NovoGrad case's optimizer: the main run's (betas 0.95/0.98, eps
# 1e-8, the clip at 1) with lr 1e-2 and weight decay 0.1.  NovoGrad moves
# an element of a large tensor by about lr / sqrt(its size) a step, so at
# the main run's lr 1e-3 that is within a few ulps of the param, and
# another summation order flips its roundings: measured on a CPU (one
# thread against all, this config, 3 steps) the masters move by 1.1e-5
# of their displacement at lr 1e-3, wd 0.01 (reg_inside_moment flipped:
# 6.8e-5, so no tenth of it holds), by 1.2e-6 at lr 1e-2, wd 0.1 (the
# wrong updates: 9.3e-4, 1.2e-3, 4.0e-2).  The decay makes where it
# enters (inside the moment or not) change the update.
NOVO_MUTANTS = ("reg_inside_moment flipped", "beta2 used for beta1",
                "lr 4% high")
GPT_CONSIST_NOVO = dict(lr=1e-2, weight_decay=0.1)
# (optimizer, opt level, model dtype, steps, first-loss rtol, the wrong
# updates the masters' limit must reject).  At O2 one bf16 step is as far
# from another summation order as lr 4% high is from the right update
# (8.7e-3 against 4.0e-2 on the CPU), so O2 names the two structural
# mutants and O0 (f32, the same CPU noise 2.0e-6) all three; the others
# are printed.
# The last column is the weights' seed: NovoGrad runs at two, and prints
# its first step's gradient gap (card against CPU, same weights) leaf by
# leaf beside the masters' gap, the floor that the masters' gap sits on
# when both devices' optimizers agree.
GPT_CONSIST_CASES = (
    ("FusedAdam", "O2", "bf16", 1, 2e-3, ("attention not causal",
                                          "bias correction dropped"), 0),
    ("FusedAdam", "O0", "f32", 2, 1e-5, GPT_MUTANTS, 0),
    ("FusedNovoGrad", "O0", "f32", 3, 1e-5, NOVO_MUTANTS, 0),
    ("FusedNovoGrad", "O0", "f32", 3, 1e-5, NOVO_MUTANTS, 1))


def _gap_leaves(got, want, ref, names, top: int = 3) -> str:
    """The ``top`` leaves by their share of ``||got - want||^2``, each
    with its own ``||got - want|| / ||want - ref||``."""
    sq = [float(((a - b) ** 2).sum()) for a, b in zip(got, want)]
    own = [float(((b - r) ** 2).sum()) for b, r in zip(want, ref)]
    total = sum(sq) or 1.0
    order = sorted(range(len(sq)), key=lambda i: -sq[i])[:top]
    return ", ".join(f"{names[i]} {sq[i] / total:.3f} (own "
                     f"{math.sqrt(sq[i] / max(own[i], 1e-30)):.2e})"
                     for i in order)


def gpt_consistency_phase(dev) -> None:
    """A 2-layer GPT block stack at GPT-2 small's widths (hidden 768, 12
    heads, vocab 50257), batch 2 x 128, from the same seed on the card
    (kernels) and on the CPU (plain twins): one O2 step with the model in
    bf16, and two O0 steps with the model in f32, with FusedAdam; three
    O0 steps with FusedNovoGrad through the clipped pipeline
    (:func:`novograd_setup`, ``GPT_CONSIST_NOVO``) at two weight seeds,
    with the first step's gradient gap.  The first loss within
    its rtol (f32: 1e-5; bf16 activations summed in each device's order:
    2e-3); the final f32 masters' gap (``_gap``) under a tenth of the
    nearest of the wrong updates the case names (``GPT_CONSIST_CASES``;
    attention not causal, Adam's bias correction dropped, lr 4% high;
    NovoGrad's reg_inside_moment flipped, beta2 used for beta1, lr 4%
    high), run on the CPU, so the limit rejects each it names.
    FusedAdam's eps is ``GPT_CONSIST_ADAM``'s.  Each gap is printed leaf
    by leaf too (``_gap_leaves``)."""
    import torch
    from apex_tpu_torch._tree import (leaf_paths, tree_flatten, tree_leaves,
                                      tree_unflatten)
    from apex_tpu_torch.contrib.multihead_attn import _common
    from apex_tpu_torch.examples import gpt_train_block as ex

    cfg = GPT_CONSIST
    base = ex.GPTBlocks(GPT["vocab"], GPT["hidden"], GPT["heads"],
                        cfg["layers"], max_seq=GPT["seq"],
                        dtype=torch.float32)
    tokens = ex.synthetic_tokens(cfg["batch"], cfg["seq"], GPT["vocab"],
                                 seed=3, device="cpu")

    def grads(device):          # the first step's f32 gradients
        leaves = [t.to(device).requires_grad_() for t in tree_leaves(params)]
        tok = tokens.to(device)
        loss = ex.next_token_loss(
            base(tree_unflatten(treedef, leaves), tok), tok)
        return [t.cpu().numpy() for t in torch.autograd.grad(loss, leaves)]

    def run(device, optimizer, opt_level, dtn, steps, mutant=None):
        model = ex.GPTBlocks(GPT["vocab"], GPT["hidden"], GPT["heads"],
                             cfg["layers"], max_seq=GPT["seq"],
                             dtype=_dtype(dtn))
        high = 1.04 if mutant == "lr 4% high" else 1.0
        real = _common.flash_attention
        if mutant == "attention not causal":
            _common.flash_attention = (lambda q, k, v, causal=False, **kw:
                                       real(q, k, v, causal=False, **kw))
        try:
            if optimizer == "FusedAdam":
                adam = dict(GPT_CONSIST_ADAM)
                if mutant == "bias correction dropped":
                    adam["bias_correction"] = False
                s = ex.setup(model, params, device, opt_level=opt_level,
                             lr=GPT["lr"] * high, **adam)
            else:
                novo = dict(GPT_CONSIST_NOVO)
                novo["lr"] *= high
                if mutant == "reg_inside_moment flipped":
                    novo["reg_inside_moment"] = True
                if mutant == "beta2 used for beta1":
                    novo["beta1"] = 0.98
                s, _ = novograd_setup(model, params, device, opt_level,
                                      **novo)
            state, losses = s.amp_state, []
            for _ in range(steps):
                loss, state = s.step(state, tokens.to(device))
                losses.append(float(loss))
        finally:
            _common.flash_attention = real
        work = s.opt.masters if s.opt.masters is not None else s.opt.params
        return losses, [m.float().cpu().numpy() for m in tree_leaves(work)]

    for optimizer, opt_level, dtn, steps, loss_rtol, must_reject, seed in \
            GPT_CONSIST_CASES:
        params = base.init(seed, "cpu")
        init = [t.numpy() for t in tree_leaves(params)]
        treedef = tree_flatten(params)[1]
        names = leaf_paths(treedef)
        mutants = GPT_MUTANTS if optimizer == "FusedAdam" else NOVO_MUTANTS
        case = (optimizer, opt_level, dtn, steps)
        card_l, card_m = run(dev, *case)
        cpu_l, cpu_m = run("cpu", *case)
        gaps = {name: _gap(run("cpu", *case, name)[1], cpu_m, init)
                for name in mutants}
        _check(all(math.isfinite(x) for x in card_l + cpu_l),
               f"gpt consistency: non-finite loss {card_l} {cpu_l}")
        rel0 = abs(card_l[0] - cpu_l[0]) / abs(cpu_l[0])
        gap = _gap(card_m, cpu_m, init)
        limit = min(gaps[k] for k in must_reject) / MUTANT_FACTOR
        hyp = (f"FusedAdam eps {GPT_CONSIST_ADAM['eps']:g}"
               if optimizer == "FusedAdam" else
               f"FusedNovoGrad lr {GPT_CONSIST_NOVO['lr']:g} weight decay "
               f"{GPT_CONSIST_NOVO['weight_decay']:g} max_grad_norm "
               f"{NOVO_GPT['max_grad_norm']:g}")
        print(f"consistency train gpt 2x768 vocab 50257 {opt_level} (model "
              f"{dtn}) {hyp} seed {seed} b"
              f"{cfg['batch']} s{cfg['seq']}, {steps} step(s): card losses "
              f"{[round(x, 6) for x in card_l]}, cpu "
              f"{[round(x, 6) for x in cpu_l]} (first rel diff {rel0:.3e}, "
              f"tol {loss_rtol}); masters' gap {gap:.3e} of their "
              f"displacement, tol {limit:.3e} = the nearest named wrong "
              f"update / {MUTANT_FACTOR:g}; wrong updates on the cpu (gap): "
              + ", ".join(f"{k} {g:.3e} ("
                          f"{'rejected' if g > limit else 'passes'}"
                          f"{', must be rejected' if k in must_reject else ''}"
                          ")" for k, g in gaps.items()), flush=True)
        print("consistency   masters' gap by leaf (share of the gap^2): "
              + _gap_leaves(card_m, cpu_m, init, names), flush=True)
        if optimizer == "FusedNovoGrad":
            g_card, g_cpu = grads(dev), grads("cpu")
            zero = [0.0 * g for g in g_cpu]
            print(f"consistency   first-step gradient gap card vs cpu "
                  f"{_gap(g_card, g_cpu, zero):.3e} of the gradient; by "
                  f"leaf: " + _gap_leaves(g_card, g_cpu, zero, names),
                  flush=True)
        _check(rel0 <= loss_rtol, f"gpt consistency {optimizer} {opt_level}"
                                  f": first loss differs by {rel0}")
        _check(gap <= limit, f"gpt consistency {optimizer} {opt_level}: "
                             f"masters' gap {gap} over {limit}")
        for name in must_reject:
            _check(gaps[name] > limit, f"gpt consistency {optimizer} "
                                       f"{opt_level}: the limit does not "
                                       f"reject '{name}'")


BERT_FLASH = dict(warmup=2, steps=4)


def bert_flash_train_phase(dev, smi: str, params) -> None:
    """BERT-L at amp O2 with FusedLAMB on the example's default unmasked
    8 x 512 batch and on a packed one (``--packed``), both through flash
    attention with gradients: warm-up steps, then timed steps with exact
    launch counts (24 flash forwards, dq and dk/dv a step)."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain
    from apex_tpu_torch.models import bert_large

    model = bert_large(dtype=torch.bfloat16, max_seq_len=BERT["seq"])
    for packed in (False, True):
        opt, state, step = bert_setup(model, params, dev)
        inputs, real, kept = pretrain.synthetic_batch(
            model.vocab_size, BERT["batch"], BERT["seq"], packed, dev)
        for _ in range(BERT_FLASH["warmup"]):
            loss, state = step(state, **inputs)
        torch.cuda.synchronize()
        steps = BERT_FLASH["steps"]
        _build.reset_launch_counts()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        t0 = time.perf_counter()
        events[0].record()
        losses = []
        for i in range(steps):
            loss, state = step(state, **inputs)
            losses.append(loss)
            events[i + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = sorted(a.elapsed_time(b) for a, b in zip(events,
                                                           events[1:]))
        launches = {k.name: k.launches for k in _build.KERNELS}
        losses = [float(x) for x in losses]
        _check(all(math.isfinite(x) for x in losses),
               f"bert flash train: non-finite loss {losses}")
        want = _bert_launches_expected(steps, len(opt._plan.buckets))
        want.update({k: BERT_LAYERS * steps for k in ("flash_fwd",
                                                      "flash_dq",
                                                      "flash_dkv")})
        _check(launches == want, f"bert flash train: launches {launches}, "
                                 f"expected {want}")
        kind = "packed" if packed else "unmasked"
        print(f"train bert-large O2 FusedLAMB b{BERT['batch']} s{BERT['seq']}"
              f" {kind} (flash attention with gradients): {steps} timed steps"
              f" after {BERT_FLASH['warmup']} warm-up, "
              f"{1e3 * wall / steps:.2f} ms/step (host clock), device "
              f"ms/step {[round(x, 2) for x in step_ms]} (CUDA events "
              f"between steps, sorted), "
              f"{real * steps / wall:.1f} real tokens/s "
              f"({real} real of {BERT['batch'] * BERT['seq']} a "
              f"step, {kept} sequences), losses "
              f"{[round(x, 4) for x in losses]}, launches {launches} "
              f"[{smi}]", flush=True)
        del opt, state, step, inputs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the optimizer tail: flat_scale, flat_axpby, flat_adagrad, flat_novograd;
# GPT-2 small with FusedNovoGrad and the clip; FP16_Optimizer over
# FusedAdagrad with clip_master_grads
# ---------------------------------------------------------------------------

_MT = "apex_tpu/ops/multi_tensor.py"
# kernel: (source, replaces, (names of its device kernels, a call's count))
OPT_TAIL_KERNELS = {
    "flat_scale": (FLAT_SOURCE, f"{_MT}:115 (flat_scale :104, body "
                                "_scale_kernel :90)", (("scale_kernel",), 1)),
    "flat_axpby": (FLAT_SOURCE, f"{_MT}:162 (flat_axpby :154, body "
                                "_axpby_kernel :141)", (("axpby_kernel",), 1)),
    "flat_adagrad": (FLAT_SOURCE, f"{_MT}:554 (flat_adagrad :537, body "
                                  "_adagrad_kernel :528)",
                     (("adagrad_kernel",), 1)),
    "flat_novograd": (FLAT_SOURCE, f"{_MT}:775 (flat_novograd :731, body "
                                   "_novograd_apply_kernel :715)",
                      (("novograd_kernel",), 1)),
}
TAIL_RAGGED = ADAM_RAGGED       # 70,001: not a multiple of the vector width
# bytes an element each moves at the timed shapes (each input read once,
# each output written once) and its f32 operations an element
TAIL_COST = {"flat_scale": (4 + 4, 1),               # f32 x -> f32 out
             "flat_axpby": (4 + 4 + 4, 3),           # f32 x, y -> f32 out
             "flat_adagrad": (4 + 4 + 2 + 4 + 4, 10),  # p, h rw; g bf16
             "flat_novograd": (4 + 4 + 2 + 4 + 4, 9)}  # p, m rw; g bf16
# FusedNovoGrad at the reference's defaults (lr 1e-3, betas 0.95/0.98,
# eps 1e-8, no decay), the flat pipeline's global-norm clip at 1.0
NOVO_GPT = dict(lr=1e-3, max_grad_norm=1.0, warmup=2, steps=4)
# FP16_Optimizer(FusedAdagrad(bf16 params), dynamic_loss_scale=True) on
# the GPT stack cut to 2 layers (widths and vocabulary kept); the step
# ``bad_step`` gets a planted non-finite gradient
LEGACY = dict(layers=2, steps=3, bad_step=1, lr=1e-2, max_norm=1.0)


def opt_tail_kernel_phase(dev, smi: str, sizes) -> list:
    """flat_scale, flat_axpby, flat_adagrad and flat_novograd against their
    twins on the card at GPT-2 small's O2 bucket (``sizes``: its 148
    leaves, 124,046,592 elements) and at a ragged length: the twin's bits
    (atol 0: the grad scale a power of two), the non-finite flag on a
    planted inf and a planted NaN (scale, axpby), the ``found_inf`` gate
    from such a flag keeping every bit (adagrad, novograd), the same bits
    on a second run; then each timed beside its twin, its bytes bound and
    a one-call PyTorch yardstick where there is one."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=dev).manual_seed(9)
    f32, bf16 = torch.float32, torch.bfloat16

    def vec(n, scale=1.0, dtype=f32):
        return (torch.randn(n, generator=gen, device=dev) * scale).to(dtype)

    def dev_f(v):
        return torch.tensor(v, dtype=f32, device=dev)

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), device=dev)
    worst = {k: 0.0 for k in OPT_TAIL_KERNELS}

    def held(name, got, want, what):
        worst[name] = max(worst[name], *(
            _held(name, a, w, 0.0, 0.0, what) for a, w in zip(got, want)))

    def same_twice(name, first, second, what):
        _check(all(bool(torch.equal(a, b)) for a, b in zip(first, second)),
               f"{name} {what}: the result differs run to run")

    _check(sum(sizes) == GPT_BUCKET, f"tail: GPT sizes sum {sum(sizes)}")
    for n, segs in ((TAIL_RAGGED, [TAIL_RAGGED - 337, 4, 333]),
                    (GPT_BUCKET, list(sizes))):
        x, g = vec(n), vec(n, 1e-2, bf16)
        for xdt, odt in ((f32, f32), (bf16, bf16), (f32, bf16)):
            xs, sc = x.to(xdt), dev_f(0.37)
            got = mt.flat_scale(xs, sc, odt)
            again = mt.flat_scale(xs, sc, odt)
            want = mt.flat_scale_ref(xs, sc, odt)
            what = f"n={n} x {xdt} out {odt}"
            held("flat_scale", got, want, what)
            same_twice("flat_scale", got, again, what)
        for xdt, ydt, odt in ((f32, f32, f32), (f32, bf16, f32),
                              (bf16, bf16, bf16)):
            xs, ys, a, b = x.to(xdt), g.to(ydt), dev_f(0.7), dev_f(-1.3)
            got = mt.flat_axpby(a, xs, b, ys, odt)
            again = mt.flat_axpby(a, xs, b, ys, odt)
            want = mt.flat_axpby_ref(a, xs, b, ys, odt)
            what = f"n={n} x {xdt} y {ydt} out {odt}"
            held("flat_axpby", got, want, what)
            same_twice("flat_axpby", got, again, what)
        for poison in ("inf", "nan"):
            for at in (n // 2, n - 1):
                bad = x.clone()
                bad[at] = float(poison)
                flags = [mt.flat_scale(bad, 2.0)[1],
                         mt.flat_scale(bad, 1.0, bf16)[1],
                         mt.flat_axpby(1.0, bad, 2.0, g)[1],
                         mt.flat_axpby(1.0, g, 2.0, bad)[1]]
                _check([int(f) for f in flags] == [1, 1, 1, 1],
                       f"tail flags {[int(f) for f in flags]} on a {poison} "
                       f"at {at} of {n}")
        p, h = vec(n, 0.02), vec(n, 1e-3).square()
        for wd, gs in ((0.0, 1.0), (0.01, 1024.0)):
            kw = dict(lr=dev_f(1e-2), eps=1e-10, weight_decay=wd,
                      grad_scale=dev_f(gs))
            got = mt.flat_adagrad(p.clone(), g, h.clone(), found_inf=zero_i,
                                  **kw)
            again = mt.flat_adagrad(p.clone(), g, h.clone(), **kw)
            want = mt.flat_adagrad_ref(p, g, h, **kw)
            what = f"n={n} p f32 g bf16 wd={wd} grad_scale={gs}"
            held("flat_adagrad", got, want, what)
            same_twice("flat_adagrad", got, again, what)
            del got, again, want
        m, v = vec(n, 1e-3), vec(len(segs), 1e-1).square()
        offs = mt.segment_offsets(segs, dev)
        for avg, rim, iz, first in ((True, False, False, 0),
                                    (True, False, False, 1),
                                    (False, True, True, 1),
                                    (True, True, False, 0),
                                    (False, False, True, 0)):
            kw = dict(lr=dev_f(1e-3), beta1=0.95, beta2=0.98, eps=1e-8,
                      weight_decay=0.01,
                      first_run=torch.tensor(first, dtype=torch.int32,
                                             device=dev),
                      grad_averaging=avg, init_zero=iz,
                      reg_inside_moment=rim, grad_scale=dev_f(4.0))
            got = mt.flat_novograd(p.clone(), g, m.clone(), v.clone(), segs,
                                   seg_offsets=offs, found_inf=zero_i, **kw)
            again = mt.flat_novograd(p.clone(), g, m.clone(), v.clone(),
                                     segs, seg_offsets=offs, **kw)
            want = mt.flat_novograd_ref(p, g, m, v, segs, **kw)
            what = (f"n={n} in {len(segs)} segments, p f32 g bf16, "
                    f"grad_averaging={avg} reg_inside_moment={rim} "
                    f"init_zero={iz} first={first}")
            held("flat_novograd", got, want, what)
            same_twice("flat_novograd", got, again, what)
            del got, again, want
        for poison in ("inf", "nan"):
            bad = g.clone()
            bad[n - 1] = float(poison)
            flag = mt.flat_unscale_norm(bad, one)[2]
            _check(int(flag) == 1, f"flat_unscale_norm missed a {poison}")
            old = [t.clone() for t in (p, h, m, v)]
            mt.flat_adagrad(p, bad, h, lr=1e-2, eps=1e-10, found_inf=flag)
            mt.flat_novograd(p, bad, m, v, segs, lr=1e-3, beta1=0.95,
                             beta2=0.98, eps=1e-8, seg_offsets=offs,
                             found_inf=flag)
            torch.cuda.synchronize()
            _check(all(bool(torch.equal(a, b))
                       for a, b in zip((p, h, m, v), old)),
                   f"flat_adagrad/flat_novograd with found_inf set by a "
                   f"{poison} changed a buffer (n={n})")
        print(f"kernel tail n={n}: flat_scale (f32/bf16 in and out), "
              f"flat_axpby (f32 and bf16 x, y), flat_adagrad (decay and "
              f"grad scale on and off), flat_novograd ({len(segs)} segments"
              f"; grad averaging x reg inside the moment, init_zero, first "
              f"step) equal to the twin's bits, the same bits on a second "
              f"run; a planted inf and NaN raise the flag of flat_scale and "
              f"flat_axpby, and found_inf from them leaves p, h, m and v "
              f"bit-unchanged", flush=True)
        del x, g, p, h, m, v

    n = GPT_BUCKET
    x, y, g = vec(n), vec(n), vec(n, 1e-3, bf16)
    p, h, m = vec(n, 0.02), vec(n, 1e-3).square(), vec(n, 1e-4)
    v = vec(len(sizes), 1e-1).square()
    offs = mt.segment_offsets(sizes, dev)
    a, b, lr_ada, lr_novo = dev_f(0.7), dev_f(-1.3), dev_f(1e-2), dev_f(1e-3)
    later = torch.zeros((), dtype=torch.int32, device=dev)   # not step 1
    ada_kw = dict(lr=lr_ada, eps=1e-10, weight_decay=0.0, grad_scale=one)
    novo_kw = dict(lr=lr_novo, beta1=0.95, beta2=0.98, eps=1e-8,
                   first_run=later, grad_scale=one)
    keep = zero_i == 0

    def adagrad_plain():             # the CPU branch of flat_adagrad
        wp, wh = mt.flat_adagrad_ref(p, g, h, **ada_kw)
        return torch.where(keep, wp, p), torch.where(keep, wh, h)

    def novograd_plain():            # the CPU branch of flat_novograd
        wp, wm, wv = mt.flat_novograd_ref(p, g, m, v, sizes, **novo_kw)
        return (torch.where(keep, wp, p), torch.where(keep, wm, m),
                torch.where(keep, wv, v))

    x_lib, found_f = x.clone(), torch.zeros((), device=dev)
    g32, steps_t = g.float(), torch.ones((), device=dev)

    def adagrad_lib():
        torch._fused_adagrad_([p], [g32], [h], [steps_t], lr=1e-2,
                              lr_decay=0.0, weight_decay=0.0, eps=1e-10,
                              maximize=False)

    timings = {
        "flat_scale": (
            lambda: mt.flat_scale(x, one), lambda: mt.flat_scale_ref(x, one),
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                [x_lib], found_f, one),
            "torch._amp_foreach_non_finite_check_and_unscale_ (in place; it "
            "flags the INPUT, where flat_scale flags the f32 product)"),
        "flat_axpby": (
            lambda: mt.flat_axpby(a, x, b, y),
            lambda: mt.flat_axpby_ref(a, x, b, y), None,
            "null: no one PyTorch call computes a*x + b*y (torch.add takes "
            "no factor on x) and flags the result"),
        "flat_adagrad": (
            lambda: mt.flat_adagrad(p, g, h, found_inf=zero_i, **ada_kw),
            adagrad_plain, adagrad_lib,
            "torch._fused_adagrad_ (f32 grads: 20 bytes an element, 2 more)"),
        "flat_novograd": (
            lambda: mt.flat_novograd(p, g, m, v, sizes, seg_offsets=offs,
                                     found_inf=zero_i, **novo_kw),
            novograd_plain, None,
            "null: PyTorch has no NovoGrad; the wrapper's time includes its "
            "per-segment norms (torch._foreach_norm over g) before the "
            "kernel"),
    }
    entries = []
    for name, (kern, plain, lib, note) in timings.items():
        source, replaces, (symbols, per_call) = OPT_TAIL_KERNELS[name]
        ms = _ms(kern, iters=20, warmup=3)
        own_ms, all_ms, _ = _wrapper_device_split(kern, symbols, per_call)
        plain_ms = _ms(plain, iters=5, warmup=1)
        lib_ms = _ms(lib, iters=20, warmup=3) if lib else None
        per_elt, flop = TAIL_COST[name]
        nbytes, ops = per_elt * n, flop * n
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"time {name} n={n}: wrapper {ms:.4f} ms (its kernel "
              f"{own_ms:.4f} ms; the profiler captured {all_ms:.4f} ms of "
              f"device work a call), plain {plain_ms:.4f} ms, "
              f"library {'%.4f ms' % lib_ms if lib_ms else 'n/a'} ({note}), "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops} FLOP)"
              f", {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s = "
              f"{100 * bound_ms / ms:.1f}% of the bound; the kernel alone "
              f"{100 * bound_ms / own_ms:.1f}% [{smi}]", flush=True)
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            atol=0.0, rtol=0.0))
    return entries


def novograd_setup(model, params, device, opt_level: str = "O2",
                   lr: float = NOVO_GPT["lr"],
                   max_grad_norm: float = NOVO_GPT["max_grad_norm"], **novo):
    """The GPT block step of ``gpt_train_block.setup`` built from the
    port's public API with ``FusedNovoGrad`` in the place of
    ``FusedAdam`` and the flat pipeline's global-norm clip on (its
    ``clip_coef`` folds into the optimizer's grad scale).  Returns the
    ``Setup`` and the list that each step appends its pre-clip gradient
    norm to (device scalars)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch._tree import tree_map
    from apex_tpu_torch.examples import gpt_train_block as ex
    from apex_tpu_torch.optimizers import FusedNovoGrad

    params = tree_map(lambda t: t.to(device), params)
    params, amp_state = amp.initialize(params, opt_level=opt_level,
                                       device=device)
    opt = FusedNovoGrad(params, lr=lr, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **novo)
    del params
    pipe = amp_state.flat_pipeline(optimizer=opt,
                                   max_grad_norm=max_grad_norm)
    wrapped = amp_state.wrap_forward(
        lambda p, tokens: ex.next_token_loss(model(p, tokens), tokens),
        cast_argnums=())
    norms = []

    def step(state, tokens):
        loss, flat = pipe.scaled_value_and_grad(wrapped, state.scaler,
                                                opt.params, tokens)
        opt.step(flat)
        norms.append(flat.grad_norm)
        return loss, amp.update_scaler(state, flat.found_inf)

    return ex.Setup(model=model, opt=opt, amp_state=amp_state,
                    step=step), norms


def novograd_train_phase(dev, smi: str, params, entries: list) -> None:
    """GPT-2 small's block stack (the FusedAdam phase's widths, batch and
    data, weights from seed 0), amp O2, ``FusedNovoGrad`` at the reference's defaults
    through the flat pipeline with ``max_grad_norm`` 1: warm-up steps,
    then timed steps with the launch counts zeroed just before them and
    read just after (one flat_novograd a bucket a step, no flat_adam);
    losses finite and falling; one profiled step."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import gpt_train_block as ex

    t0 = time.perf_counter()
    model = ex.GPTBlocks(GPT["vocab"], GPT["hidden"], GPT["heads"],
                         GPT["layers"], max_seq=GPT["seq"])
    torch.cuda.reset_peak_memory_stats(dev)
    s, norms = novograd_setup(model, params, dev, "O2")
    sizes = [b.size for b in s.opt._plan.buckets]
    _check(sizes == [GPT_BUCKET], f"novograd: O2 buckets {sizes}")
    tokens = ex.synthetic_tokens(GPT["batch"], GPT["seq"], GPT["vocab"],
                                 device=dev)
    state, losses = s.amp_state, []
    for _ in range(NOVO_GPT["warmup"]):
        loss, state = s.step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = NOVO_GPT["steps"]
    _build.reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        loss, state = s.step(state, tokens)
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in norms]
    _check(all(math.isfinite(x) for x in losses),
           f"novograd train: non-finite loss {losses}")
    _check(losses[-1] < losses[0], f"novograd train: the loss did not fall "
                                   f"{losses}")
    want = _gpt_launches_expected(steps, len(sizes))
    want.update(flat_adam=0, flat_novograd=len(sizes) * steps)
    _check(launches == want, f"novograd train: launches {launches}, "
                             f"expected {want}")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    toks = GPT["batch"] * GPT["seq"]
    print(f"train gpt-2 small block stack O2 FusedNovoGrad lr "
          f"{NOVO_GPT['lr']:g} (betas 0.95/0.98, eps 1e-8), max_grad_norm "
          f"{NOVO_GPT['max_grad_norm']:g}, b{GPT['batch']} s{GPT['seq']}: "
          f"{steps} timed steps after {NOVO_GPT['warmup']} warm-up (setup "
          f"and warm-up {setup_s:.1f} s), {1e3 * wall / steps:.2f} ms/step "
          f"(host clock), device ms/step median "
          f"{float(np.median(step_ms)):.2f} (min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}), {toks * steps / wall:.1f} tokens/s, losses "
          f"{[round(x, 4) for x in losses]}, pre-clip grad norms "
          f"{[round(x, 3) for x in gnorms]} (the clip engaged in "
          f"{sum(x > NOVO_GPT['max_grad_norm'] for x in gnorms)} of "
          f"{len(gnorms)}), peak device memory {peak:.2f} "
          f"GiB, launches {launches} [{smi}]", flush=True)
    own = dict(GPT_OWN, flat_novograd=("novograd_kernel",))
    del own["flat_adam"]
    gpt_profile_phase(dev, smi, s, state, tokens, "FusedNovoGrad", own)
    for e in entries:
        if e["name"] == "flat_novograd":
            e["launches"] = launches["flat_novograd"]


def legacy_train_phase(dev, smi: str, params, entries: list) -> None:
    """The legacy mixed-precision API on the GPT stack cut to
    ``LEGACY['layers']`` layers (widths and vocabulary kept, the first
    blocks of the seed-0 weights): the model in bf16
    (``fp16_utils.tree_to_half``), ``FP16_Optimizer(FusedAdagrad,
    dynamic_loss_scale=True)`` (f32 masters), and per step the
    reference's order: gradients of the scaled loss, packed in the
    optimizer's plan, unscaled to f32 master grads,
    ``clip_master_grads`` on the packed buffers (flat_l2norm and
    flat_scale a bucket), then ``step`` (its unscale by 1: the grads come
    unscaled).  Step ``LEGACY['bad_step']`` gets a planted inf: it is
    skipped with every bit of params, masters and state kept, and the
    loss scale halves.  Launch counts exact."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch._tree import tree_map
    from apex_tpu_torch.amp import value_and_grad
    from apex_tpu_torch.examples import gpt_train_block as ex
    from apex_tpu_torch.fp16_utils import FP16_Optimizer, tree_to_half
    from apex_tpu_torch.optimizers import FusedAdagrad

    L = LEGACY["layers"]
    model = ex.GPTBlocks(GPT["vocab"], GPT["hidden"], GPT["heads"], L,
                         max_seq=GPT["seq"])
    cut = {k: v for k, v in params.items()
           if not k.startswith("block") or int(k[5:]) < L}
    half = tree_to_half(tree_map(lambda t: t.to(dev), cut))
    fopt = FP16_Optimizer(FusedAdagrad(half, lr=LEGACY["lr"]),
                          dynamic_loss_scale=True)
    del half
    opt, plan = fopt.optimizer, fopt.optimizer._plan
    tokens = ex.synthetic_tokens(GPT["batch"], GPT["seq"], GPT["vocab"],
                                 device=dev)

    def scaled_loss(p):
        return fopt.scale(ex.next_token_loss(model(p, tokens), tokens))

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    losses, norms, scales = [], [], []
    t0 = time.perf_counter()
    for i in range(LEGACY["steps"]):
        scale = fopt.loss_scale
        (loss, _), grads = value_and_grad(scaled_loss, fopt.params)
        packed = plan.pack_grads(grads)
        if i == LEGACY["bad_step"]:
            packed[0][packed[0].numel() // 3] = float("inf")
            before = [t.clone() for t in (opt._param_bufs + opt._master_bufs
                                          + opt.opt_state["sum"])]
        master = [g.float() / scale for g in packed]
        clipped, norm = fopt.clip_master_grads(master, LEGACY["max_norm"])
        fopt.step(clipped, grad_scale_extra=1.0 / scale)
        losses.append(float(loss) / scale)
        norms.append(float(norm))
        scales.append(fopt.loss_scale)
        bad = i == LEGACY["bad_step"]
        _check(fopt.overflow == bad, f"legacy step {i}: overflow "
                                     f"{fopt.overflow}")
        if bad:
            after = opt._param_bufs + opt._master_bufs + opt.opt_state["sum"]
            _check(all(bool(torch.equal(a, b))
                       for a, b in zip(after, before)),
                   "legacy: the skipped step changed a buffer")
            _check(fopt.loss_scale == scale / 2,
                   f"legacy: the scale went {scale} -> {fopt.loss_scale}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    steps, nb = LEGACY["steps"], len(plan.buckets)
    want = {k.name: 0 for k in _build.KERNELS}
    want.update({"flash_fwd": L * steps, "flash_dq": L * steps,
                 "flash_dkv": L * steps,
                 "layer_norm_fwd": (2 * L + 1) * steps,
                 "layer_norm_bwd": (2 * L + 1) * steps,
                 "flat_l2norm": nb * steps, "flat_scale": nb * steps,
                 "flat_adagrad": nb * (steps - 1)})
    _check(launches == want, f"legacy: launches {launches}, expected {want}")
    _check(all(math.isfinite(x) for x in losses),
           f"legacy: non-finite loss {losses}")
    print(f"train legacy fp16_utils: FP16_Optimizer(FusedAdagrad lr "
          f"{LEGACY['lr']:g}, dynamic loss scale) on the gpt stack at {L} "
          f"layers (h{GPT['hidden']}, vocab {GPT['vocab']}, bf16 model, "
          f"{sum(b.size for b in plan.buckets)} params in {nb} bucket(s)), "
          f"b{GPT['batch']} s{GPT['seq']}, clip_master_grads to "
          f"{LEGACY['max_norm']:g} on the packed grads: {steps} steps in "
          f"{wall:.2f} s, losses {[round(x, 4) for x in losses]}, pre-clip "
          f"norms {[round(x, 3) for x in norms]}, loss scales {scales} (step "
          f"{LEGACY['bad_step']} had a planted inf: skipped with every bit "
          f"kept, the scale halved), launches {launches} [{smi}]",
          flush=True)
    for e in entries:
        if e["name"] in ("flat_adagrad", "flat_scale"):
            e["launches"] = launches[e["name"]]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from apex_tpu_torch import _build
    from apex_tpu_torch._tree import tree_leaves
    from apex_tpu_torch.examples import gpt_train_block
    from apex_tpu_torch.models import bert_large
    from apex_tpu_torch.ops import (attention, layer_norm,  # noqa: F401
                                    multi_tensor)
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
        spilled, entry = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill" in line and not ("0 bytes spill stores" in line
                                          and "0 bytes spill loads" in line):
                spilled.append(f"{entry} ({line.strip()})")
        print(f"ptxas {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"{len(spilled)} with spills"
              + "".join(f"; {s}" for s in spilled), flush=True)

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
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bert_params = bert_large(max_seq_len=BERT["seq"]).init(0, "cpu")
    # amp O2 makes one bucket of every leaf, in flatten order
    sizes = [t.numel() for t in tree_leaves(bert_params)]
    print(f"bert-large init on the cpu: {sum(sizes)} parameters in "
          f"{len(sizes)} tensors, {time.perf_counter() - t0:.1f} s",
          flush=True)
    with torch.no_grad():
        bert_entries = bert_kernel_phase(dev, smi, sizes)
    torch.cuda.empty_cache()
    opt, amp_state, step, batches = bert_train_phase(dev, smi, bert_entries,
                                                     bert_params)
    bert_profile_phase(dev, smi, step, amp_state, batches)
    del opt, amp_state, step, batches
    torch.cuda.empty_cache()
    bert_flash_train_phase(dev, smi, bert_params)
    del bert_params
    bert_consistency_phase(dev)

    with torch.no_grad():
        attn_res = attn_train_kernel_phase(dev, smi)
        adam_res = adam_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    rows = dict(attn_res["rows"], flat_adam=adam_res["row"])
    worst = dict(attn_res["worst"], flat_adam=adam_res["worst"])
    gpt_entries = [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=0, max_abs_err=worst[name],
             atol=0.0 if name == "flat_adam" else ATTN_TOL["bf16"][0],
             rtol=0.0 if name == "flat_adam" else ATTN_TOL["bf16"][1],
             **rows[name])
        for name, (source, replaces, _) in GPT_KERNELS.items()]
    s, state, tokens = gpt_train_phase(dev, smi, gpt_entries)
    gpt_profile_phase(dev, smi, s, state, tokens)
    del s, state, tokens
    torch.cuda.empty_cache()
    gpt_consistency_phase(dev)

    t0 = time.perf_counter()
    gpt_params = gpt_train_block.GPTBlocks(
        GPT["vocab"], GPT["hidden"], GPT["heads"], GPT["layers"],
        max_seq=GPT["seq"]).init(0, "cpu")
    gpt_sizes = [t.numel() for t in tree_leaves(gpt_params)]
    print(f"gpt-2 small init on the cpu: {sum(gpt_sizes)} parameters in "
          f"{len(gpt_sizes)} tensors, {time.perf_counter() - t0:.1f} s",
          flush=True)
    with torch.no_grad():
        tail_entries = opt_tail_kernel_phase(dev, smi, gpt_sizes)
    torch.cuda.empty_cache()
    novograd_train_phase(dev, smi, gpt_params, tail_entries)
    torch.cuda.empty_cache()
    legacy_train_phase(dev, smi, gpt_params, tail_entries)
    del gpt_params
    torch.cuda.empty_cache()

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "atol", "rtol")
    kernels = [{k: e[k] for k in keys}
               for e in [entry] + flat_entries + bert_entries + gpt_entries
               + tail_entries]
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
