#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths (ResNet,
BERT, the GPT block and ``models.GPTModel``), its fused softmax, cross
entropy, Welford statistics and attention dropout, on one GPU.

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
    dq and dk/dv a step besides the LayerNorm and LAMB counts); one
    unmasked step under ``torch.profiler``: busy and idle time,
    attention's share of busy time;
15. consistency (BERT) — a 2-layer BERT at BERT-Large's widths, one O2
    step on the card and on the CPU from the same seed, on a padded and
    on an unmasked batch: the masters within a tenth of the nearest of
    three wrong updates run on the CPU (trust ratio, global clip or
    weight decay dropped);
16. kernel vs plain (attention training) — the flash forward with its
    logsumexp and the dq, dk/dv kernels against their twins on the card
    at the GPT block's (8, 12, 512, 64) bf16 causal, BERT-Large's (8,
    16, 512, 64) bf16 unmasked and packed with pad rows, grouped-query
    heads (12 to 4) at Sq = 200, f32, and bf16 at D 128 (causal at S
    130, packed) and D 32, and GPTModel's (8, 12, 1024, 64) bf16 causal
    with and without the segment ids of phase 35's packed rows (within
    1e-4; bf16 within 2e-2, one bf16 rounding); rows that see no key (and keys no row sees) give exact
    zeros; the same bits on a second run; each case prints the route
    each kernel took, read from the device kernels' names under the
    profiler (each kernel's ``ops.attention.flash_route``: the tensor-core
    bodies for bf16 at D 64 and 128 and the forward and dk/dv at D 32, the
    register-tile forward and dk/dv for f32 there, the CUDA-core bodies
    otherwise at these widths); every
    tensor-core body's ptxas registers
    and spills (0 spill bytes required) and the host microseconds of one
    TMA tensor map; at GPT's and BERT-L's unmasked shapes each kernel
    timed beside its twin, its bound and SDPA's forward or backward in
    the same call, with the ratios to SDPA;
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
    attention's share of it, the largest device items, the port's
    kernels' share;
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
    bit kept and the scale halves; exact launch counts;
24. kernel vs plain (softmax) — softmax_fwd (unmasked and causal),
    softmax_masked_fwd and softmax_bwd against their plain versions at
    GPT-2 small's causal (8, 12, 1024, 1024) and BERT-Large's (8, 16,
    512, 512) scores with Megatron's padding mask (lengths 128..512 from
    ``default_rng(1)``) and without, bf16, and in f32 and fp16 at BERT's
    shape, rows of 2048 and 4096 and a ragged row count (f32 forward
    within 1e-6; bf16/fp16 within one rounding; the backward within
    1e-5 of max |dx|; fully masked rows exact zeros; the same bits on a
    second run); off the gate (sk 200, masked sq 12) the plain version
    with the reference's launches; each timed beside its plain version,
    its bytes bound and a one-call PyTorch yardstick;
25. path (softmax attention) — ``FusedScaleMaskSoftmax`` in Megatron's
    unfused attention (bf16 ``q @ k^T``, the module, ``@ v``), forward
    and backward, at GPT-2 small's (8, 12, 1024, 64) causal and
    BERT-Large's (8, 16, 512, 64) with the padding mask: exact launch
    counts (one softmax forward and one softmax_bwd a step), the output
    and dq, dk, dv within 2e-2 of each scale of the flash kernels'
    (causal) or of plain f32 attention with the mask on the alive rows
    (dead query rows exact zeros), ms per forward + backward and peak
    memory;
26. kernel vs plain (cross entropy) — xent_fwd and xent_bwd against
    their plain versions at BERT-L's (4096, 30592) f32 MLM logits
    (Megatron's padded vocabulary), GPT-2's (8192, 50304) bf16 with
    ``half_to_float`` and the gate's edge (64, 65536), label smoothing 0
    and 0.1, labels -1, C and C + 5 (no target term): f32 losses and lse
    within rtol 1e-5, dx within 1e-6 of max |dx|, half within one
    rounding, the same bits twice; timed beside the plain version, the
    bytes bound and ``F.cross_entropy`` (forward; the backward has no
    one-call yardstick);
27. train (BERT, vocab 30592) — BERT-Large at the padded vocabulary
    (the earlier phases' weights, the embedding padded from seed 5),
    amp O2, FusedLAMB, the unmasked 8 x 512 batch: 2 warm-up and 4
    timed steps, exact launch counts (one xent_fwd and one xent_bwd a
    step; the vocab-30528 phases above count none);
28. BERT proxy — the example's default 4 x h128 model at vocab 2048
    trains 3 steps on the card with exact launch counts; its device ms a
    step (CUDA events between 4 steps) and the busy ms of one profiled
    step, whose flash kernels must be the D-32 bodies of their routes
    (all three on the tensor cores); one O0 step on a packed 2 x 128
    batch (labels -1 on padding) on the card and the CPU, the params
    within a tenth of the nearest of three wrong updates (label
    smoothing 0.1, padding not masked, lr 4% high), the card's step with
    exact f32 flash launches (4 forwards, 4 dq, 4 dk/dv) on the D-32
    register-tile bodies, read from the device kernels' names;
29. kernel vs plain (Welford) — welford_mean_var at ResNet-50's
    SyncBatchNorm inputs at batch 128 and 224x224 ((401,408, 256) bf16
    and f32, (100,352, 512), (6,272, 2048)), a ragged (100,001, 384) and
    a large mean (300 + 0.05 noise, against f64 too): mean and var
    within the reference's tolerances, the count exact, the same bits
    twice; off the gate (C = 64) the plain version; timed beside the
    plain version, the bytes bound and ``torch.var_mean`` (f32 input);
30. train (ResNet-50, ``--sync-bn``) — amp O2, batch 128 at 224x224,
    grad_accum 2, SyncBatchNorm at world size 1 in turns with plain
    BatchNorm (2 warm-up and 4 timed steps each, exact launch counts);
    welford_mean_var on every SyncBatchNorm input of one forward against
    the module's own statistics; one O0 step of a SyncBN ResNet-18 on
    the card and the CPU: the params within a tenth of lr 4% high, the
    running statistics within a tenth of a biased running variance;
31. kernel vs plain (attention dropout; run after phase 20) — the
    dropout bodies of the flash forward, dq and dk/dv at rate 0.1
    against their twins at the same seed (``DROP_CASES``: GPT's and
    BERT-L's unmasked and packed shapes, GQA 12 to 4 ragged, f32 GQA at
    S 300 on the CUDA cores, D 32, Sq 130 / Sk 70 causal; ATTN_TOL),
    exact zeros where nothing is seen, the same bits twice, each route
    from the kernels' names; the keep mask read out of the forward (V
    one-hot on a window of D keys, windows swept over Sk, q = k = 0) and
    of dk/dv (dO one-hot), equal to ``dropout_keep_ref`` bit for bit,
    and another seed's mask within 0.01 of a 0.9 keep fraction; the
    inputs F5 repaired (D 8, 80 and 96, a transposed q, a q 8 bytes off,
    B*H 65,600) with gradients against the twins; each dropout body
    timed at GPT's and BERT-L's shapes beside the same body at rate 0 (in
    turns), the twin, SDPA with ``dropout_p=0.1`` and the bound;
32. path (attention dropout) — in bf16 training, forward and backward,
    rate 0.1, launches counted from 0 before each: 12 x
    ``SelfMultiheadAttn(768, 12, bias, norm-add)`` at GPT-2 small's T
    512, B 8, causal (2 steps after a warm-up); ``EncdecMultiheadAttn(
    1024, 16)`` (Transformer-big's decoder cross-attention) at Tq 256, Tk
    384, B 16 on its three branches; ``fmha_packed`` over the 4,096-token
    BERT packed buffer at H 16, D 64 (the tail exact zeros);
    ``SelfMultiheadAttn(768, 8)`` (D 96);
33. consistency (attention dropout) — a 2-layer f32 dropout stack at
    768 wide on the card and the CPU from the same seeds: output and
    gradients within 1e-3 of their scale, and the CPU at other seeds
    outside it;
34. wide heads (F5b, F5c) — the flash bodies at head dims 160 and 200
    (padded), 256 and 512 (bf16 at 256 on the tensor cores, the rest on
    the CUDA cores) and the wide bodies at 640 (padded) and 1024 ((4, 2,
    512, D); bf16 D 1024 at (8, 2, 512, 1024), the shape it is timed
    at; the bf16 forward there on the wide tensor-core body), f32 and
    bf16, dropout 0.1 and 0, against their twins with each kernel's
    route (``ops.attention.flash_route``) and DROP instantiation read
    from the device kernels' names; the ptxas registers and spills of
    the D-256 and wide tensor-core bodies; the three timed at
    ``SelfMultiheadAttn(1024, 4)``'s (8, 4, 512, 256) and
    ``SelfMultiheadAttn(2048, 2)``'s (8, 2, 512, 1024) bf16 causal
    shapes beside the twin, SDPA and the bound (and the f32 wide bodies
    at the latter); each module trained 2 SGD steps at dropout 0.1 and
    0 with exact launch counts and profiled routes; the f32 forward and
    dk/dv at (8, 12, 512, 64) and (8, 8, 512, 128) in register tiles
    beside their CUDA-core bodies in turns, the dq, SDPA f32 and the
    bound, with every register-tile body's ptxas registers and spills
    (none in the forward and dq at 16 and 32 and dk/dv at 32);
    the f32 forward, dq and dk/dv at D 32 and 16 (register tiles) in
    turns with their CUDA-core bodies at (8, 12, 512, D) causal and the
    BERT proxy's (8, 4, 512, 32) unmasked, beside SDPA f32 and the bound;
    the forward, dq and dk/dv at (8, 2, 512, 640) causal, bf16 and f32
    (padded to the D-1024 bodies), beside SDPA;
35. train (GPTModel; run after phase 20) — ``models.GPTModel`` at GPT-2
    small's published widths (12 x 768, 12 heads, vocab 50257, 1024
    positions), amp O2, FusedAdam lr 3e-4 through the flat pipeline,
    b8 x s1024: learned positions (2 warm-up and 8 timed steps) and RoPE
    on packed rows (``data.pack_dataset`` over sequences of 32..1024
    tokens; 2 + 4); first flat_unscale_norm and flat_adam against their
    twins at each model's own bucket size; then ms per step (host clock and CUDA events), tokens/s
    (real tokens when packed), peak memory, losses finite and falling,
    exact launch counts (12 flash forwards, dq and dk/dv, 25 LayerNorm
    forwards and backwards, one flat_unscale_norm and one flat_adam a
    step, nothing else), and one profiled step each (busy share, GEMMs'
    and the port's kernels' shares, the largest device items);
36. consistency (GPTModel) — the model cut to 2 layers at those widths,
    f32 (O0), 3 FusedAdam steps on the card and the CPU from one seed,
    learned positions and packed RoPE rows: the first loss within rtol
    1e-5, the params within a tenth of the nearest wrong update run on
    the CPU (attention not causal or packed segments not masked; lr 4%
    high);
37. narrow heads (run after phase 34) — the bf16 forward, dq and dk/dv
    at D 16 and 32 on the tensor cores: first one 64 x D x 64 product of
    each kind at D 16, 32 and 64 against ``torch.matmul`` (every
    shared-memory descriptor of the 32-, 64- and 128-byte swizzles);
    then causal and not, ragged S 200, Sq != Sk (keys no row sees),
    grouped-query heads, segment ids with rows that see no key, heads of
    12, 17, 24 and 31 padded, the BERT proxy's (8, 4, 512, 32), dropout
    0.1, against the twins (ATTN_TOL) with each kernel's route read from
    the device kernels' names; the keep masks bit for bit; q off 16
    bytes; the new bodies' ptxas lines (0 spills); then at (8, 12, 512,
    32) and (8, 12, 512, 16) causal and the proxy's shape, the forward
    and dk/dv in turns with their CUDA-core bodies and the D-64 bodies on
    zero-padded operands, beside the twin, SDPA and the bound; the same
    edge cases in f32 (every kernel in register tiles) against the twins
    with their routes, and the f32 keep masks bit for bit;
38. amp O1 and offload — ResNet-50 at O1 (b128 at 224x224, FusedSGD,
    ``grad_accum`` 2 and 1) beside phase 8's O2 figures, with the
    convolutions' kernels from a profiled step and the host time the
    O1 mode adds; card against CPU at O1 on ResNet-18 and the BERT
    proxy (the first loss, the proxy's first gradient per leaf, the
    params after one step, each limit printed with the planted faults it
    rejects); the BERT proxy and BERT-Large at O1 with their kernel
    launches; the DCGAN example (two scalers in one ``state_dict``);
    the GPT block at GPT-2 small's widths plain, under plain
    recomputation and with ``--offload-activations`` (loss and grads
    alike, peak device memory and device ms of each);
39. checkpoint, resume and offload — the native checkpoint library
    must load; ResNet-50 O2 b128 x 224 through the ImageNet example's
    main() with deterministic cuDNN, preempted at step 4 of 8 by
    ``--checkpoint-dir --save-every 2 --preempt-at-step 4`` and resumed
    by the same command, at ``grad_accum`` 1 and 2 and through
    ``--checkpoint`` (v1), each equal to the uninterrupted run bit for
    bit, and preempted at step 3 the restored state equal to the saved;
    GPT-2 small's block stack at O2 with FusedAdam: v1 and v2 save and
    restore ms and bytes, the ms an async v2 save blocks the loop beside
    a step's, the async file untorn by the next step, the v2 restore one
    host-to-device copy a packed buffer; BERT-L O2 FusedLAMB b8 x 512
    with ``offload_state`` against resident in turns (bits equal, ms a
    step, peak and held device memory) and a v2 save and restore of the
    offloaded optimizer, its state pinned on the host through both.

Phase 11 also reads every LayerNorm forward's route (the register body
up to h 8192 at 16-byte alignment, the wide one past it and off it)
from the device kernels' names, times the forward at GPT-2's (4096,
768) bf16, BERT-L's width in f32 and h 8192, and stage 2 of LAMB (which
walks the segment-start table) on a bf16 p; phases 13 and 19 check that
the profiled steps' LayerNorm forwards ran the register body.

Phase 11's LayerNorm cases include GPTModel's (8192, 768) bf16.  Each
phase prints its host seconds (``phase seconds``; phase 34 its F5c part
as well), and a summary line lists them all.

Kernel times are device milliseconds per call, from CUDA events around
calls queued behind a device-side spin that outlasts the host's
launching them, so the host's launch overhead is not in them.

The line before the last is the ``kernels`` JSON record (every kernel);
the last line is ``{"ok": true, "device": {...}}``.  The flash kernels'
entries name the ``body`` their timed row took ("tensor cores", "CUDA
cores", "wide tensor cores" or "wide CUDA cores") and its ``shape``:
flash_fwd's is GPT-2 small's bf16 training shape (its launches those of
the GPT step), with the serve path's f32 row under ``serve_f32``; each
of the three carries its dropout body's figures under ``dropout``
(launches those of phase 32's 12-layer stack); the wide heads' under
``d256`` and ``d1024``; the BERT proxy's (8, 4, 512, 32) rows under
``d32_proxy``, with their launches in phase 28's 3 steps; the f32 D-32
rows (GPT-2 small's batch, heads and seq, causal) under ``d32_f32`` and
the proxy's f32 O0 shape under ``d32_proxy_f32``, with their launches in
phase 28's card O0 step.  The kernels of
the GPTModel step carry their launches in phase 35's timed steps under
``gpt_model_launches``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import collections
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


def _prime_profiler() -> None:
    """Runs 64 small kernels and a 20 ms spin just after a
    ``torch.profiler`` session starts, before the kernels a check counts:
    on an H100 the first kernels of a session are sometimes missing from
    its records (one of 22 counted flash forwards in one run; every
    kernel of a short session in others)."""
    import torch
    x = torch.zeros(1024, device="cuda")
    for _ in range(64):
        x.add_(1.0)
    _spin(20.0)
    torch.cuda.synchronize()


def _primed_events(prof) -> list:
    """The device events of a session begun with :func:`_prime_profiler`,
    by start time, without the primer's (those up to its spin)."""
    import torch
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    return events[spins[-1] + 1:] if spins else events


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


def _case_ids(kind, b, s, device):
    """The (q_ids, kv_ids) of an ``ATTN_CASES`` segment kind: none,
    "packed" (three segments and a padded tail a row), "ragged" (rows
    of length s and s // 3 + 1 in turns), "gpt_model" (the packed RoPE
    rows that phase 35 trains on)."""
    import torch
    from apex_tpu_torch.ops.attention import packed_segment_ids
    if kind is None:
        return None
    if kind == "packed":
        return _packed_ids(b, s, device)
    if kind == "ragged":
        return _ragged_ids([s, s // 3 + 1] * (b // 2), s, device)
    cfg = GPT_MODEL
    _check((b, s) == (cfg["batch"], cfg["seq"]),
           f"gpt_model segment ids are ({cfg['batch']}, {cfg['seq']}), "
           f"asked for ({b}, {s})")
    ids = gpt_model_batch("packed_rope", b, s, cfg["vocab"], seed=1,
                          lengths=cfg["lengths"])[2]
    return packed_segment_ids(torch.from_numpy(ids).long().to(device))


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


def _profile_step(fn):
    """(host wall ms, {device kernel name: (us, count)}) of one call of
    ``fn`` under ``torch.profiler``, the card idle before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    return wall, by_name


def _owns(name: str, symbols) -> bool:
    return any(sym in name for sym in symbols)


def _wrapper_device_split(fn, symbols, own_per_call: int, calls: int = 10):
    """Device time per call of ``fn`` from ``torch.profiler``: of its own
    kernels (names holding one of ``symbols``, ``own_per_call`` of them a
    call), and of all the device work captured; and the device kernels
    captured per call.  After other profiles in the same process the
    profiler has dropped the first kernels of a window, so the session
    is primed (:func:`_prime_profiler`), read again (up to 3 sessions)
    while it holds none of the own kernels, and the own time is the mean
    of the own kernels it did capture times their number a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _prime_profiler()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        own = total = 0.0
        count = n_own = 0
        for e in _primed_events(prof):
            t = e.time_range.elapsed_us() / 1e3
            total += t
            count += 1
            if _owns(e.name, symbols):
                own += t
                n_own += 1
        if n_own:
            break
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
        worst["flat_unscale_norm"] = max(
            worst["flat_unscale_norm"],
            _unscale_norm_held(dev, gen, n, torch.float32))
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


def train_phase(dev, smi: str, entries: list) -> dict:
    """ResNet-50 O2 b128 x 224; returns its figures by ``grad_accum``
    (imgs/s and host ms a step, medians; device ms a step at ACCUM) for
    phase 38's O1 lines."""
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
    return {ACCUM: dict(imgs=float(np.median(imgs)),
                        ms=float(np.median(ms)),
                        device_ms=float(np.median(
                            [m for _, _, s in runs for m in s]))),
            1: dict(imgs=res1.imgs_per_sec, ms=1e3 * res1.step_seconds)}


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


def _aten_f32_convs():
    """A context in which the port's CPU convolutions are aten's own f32
    sums (oneDNN, or thnn with oneDNN off) instead of its f64 sums
    (``apex_tpu_torch._numerics.conv2d``): the two CPU summation orders
    that the consistency phase's yardstick compares, as an f32 trainer
    on a CPU sums."""
    import contextlib
    import torch.nn.functional as F
    from apex_tpu_torch import _numerics

    @contextlib.contextmanager
    def ctx():
        real = _numerics.conv2d
        _numerics.conv2d = F.conv2d
        try:
            yield
        finally:
            _numerics.conv2d = real
    return ctx()


def train_consistency_phase(dev) -> None:
    """ResNet-18, batch 8 at 64x64, ``grad_accum=2``, from the same seed
    on the card (kernels, cuDNN) and on the CPU (plain twins, aten's f32
    convolutions: oneDNN, see ``_aten_f32_convs``), in the cases of
    ``CONSIST_CASES``.

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
        with _aten_f32_convs():
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


def _profile_second_step(dev, **train_kw):
    """(host wall ms, {device kernel name: (us, count)}) of the second
    step of a 2-step ImageNet run (the first warms up), from
    ``torch.profiler``."""
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

    main_amp.train(device=dev, steps=2, log=None, on_step=on_step,
                   **train_kw)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    return 1e3 * clock["wall"], by_name


def train_profile_phase(dev, smi: str, grad_accum: int) -> None:
    """Device time by kernel over one training step (the second of a
    2-step run; the first warms up), from ``torch.profiler``."""
    wall, by_name = _profile_second_step(dev, grad_accum=grad_accum, **TRAIN)
    busy = sum(t for t, _ in by_name.values()) / 1e3
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
        # the main path's shapes take the register body (ln.fwd_route)
        (2e-2, 2e-2), (("ln_fwd_reg_kernel",), 1)),
    "layer_norm_bwd": (
        "apex_tpu_torch/csrc/layer_norm.cu",
        "apex_tpu/ops/layer_norm.py:135 (_bwd_2d, body _ln_bwd_kernel :77)",
        # device kernels a call: by route, ln.BWD_DEVICE_KERNELS
        (2e-2, 2e-2), (("ln_bwd_",), None)),
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


# the LayerNorm checks: rows, h, dtype, rms, elements x and dy start past
# a 16-byte boundary; the backward's route follows from h and alignment
LN_CASES = (
    (4096, 1024, "bf16", False, 0),      # BERT-L
    (4096, 1024, "bf16", True, 0),
    (4096, 768, "bf16", False, 0),       # GPT-2 small
    (8192, 768, "bf16", False, 0),       # GPTModel at b8 x s1024
    (4096, 1024, "f32", False, 0),
    (333, 128, "bf16", True, 0),         # rows ragged against the chunk
    (333, 4096, "bf16", False, 0),
    (333, 8192, "f32", True, 0),         # the fused limit, 8 vectors a thread
    (65, 16384, "f32", False, 0),        # past it: three launches
    (333, 1024, "bf16", False, 1),       # 2 bytes off: three launches
)
# the device kernel of each forward route (neither name holds the other)
LN_FWD_KERNELS = {"register": "ln_fwd_reg_kernel", "wide": "ln_fwd_kernel"}
# the device kernels of each backward route, in launch order
LN_BWD_KERNELS = {"fused": ("ln_bwd_fused_kernel", "ln_bwd_combine_kernel"),
                  "three": ("ln_bwd_dx_kernel", "ln_bwd_partial_kernel",
                            "ln_bwd_combine_kernel")}


def _ln_bwd_routes(prof, case_routes) -> None:
    """Checks that the backward of every case ran the device kernels of
    the route the wrapper chose, in order, from one ``torch.profiler``
    session over every case (two backward calls a case)."""
    import torch
    names = [e.name for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and "ln_bwd_" in e.name), key=lambda e: e.time_range.start)]
    want = [(what, k) for what, route in case_routes
            for k in LN_BWD_KERNELS[route] * 2]
    _check(len(names) == len(want), f"the profiler saw {len(names)} ln_bwd_ "
           f"kernels on the device where {len(want)} were launched")
    for got, (what, sym) in zip(names, want):
        _check(sym in got, f"layer_norm_bwd {what}: the device ran {got} "
               f"where its route launches {sym}")


def _ln_fwd_routes(prof, case_routes) -> None:
    """Checks that the forward of every case ran the device kernel of the
    route the wrapper chose, from the same session as
    :func:`_ln_bwd_routes` (one forward call a case)."""
    import torch
    names = [e.name for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and "ln_fwd_" in e.name), key=lambda e: e.time_range.start)]
    _check(len(names) == len(case_routes), f"the profiler saw {len(names)} "
           f"ln_fwd_ kernels on the device where {len(case_routes)} were "
           "launched")
    for got, (what, route) in zip(names, case_routes):
        _check(LN_FWD_KERNELS[route] in got, f"layer_norm_fwd {what}: the "
               f"device ran {got} where its route launches "
               f"{LN_FWD_KERNELS[route]}")


def _ln_checks(dev) -> dict:
    """The LayerNorm kernels against their twins at BERT-L's (4096, 1024)
    and GPT-2's (4096, 768) bf16 (LN and RMS), in f32, at ragged row
    counts, and on both routes of each (the forward's register body and
    the backward's fused body up to their limit, the wide body and three
    launches past it and for an x and dy 2 bytes off alignment), each
    route read from the device kernels' names; returns the worst error
    of each kernel at the main path's dtype."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(3)
    worst = {"layer_norm_fwd": 0.0, "layer_norm_bwd": 0.0}
    case_routes, fwd_routes = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _prime_profiler()
    for rows, h, dtn, rms, off in LN_CASES:
        dt = _dtype(dtn)

        def tensor(scale, shift):
            t = (torch.randn(rows * h + off, generator=g, device=dev) * scale
                 + shift).to(dt)
            return t[off:].view(rows, h)

        x = tensor(3, 1)
        w = (torch.randn(h, generator=g, device=dev) * 0.1 + 1).to(dt)
        b = (torch.randn(h, generator=g, device=dev) * 0.1).to(dt)
        dy = tensor(1, 0)
        route, fwd_route = ln.bwd_route(x, dy), ln.fwd_route(x)
        y = ln._fwd_2d(x, w, b, 1e-5, rms)
        dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
        torch.cuda.synchronize()
        wy = ln._fwd_2d_ref(x, w, b, 1e-5, rms)
        wdx, wdw, wdb = ln._bwd_2d_ref(x, w, dy, 1e-5, rms)
        half = dt == torch.bfloat16
        atol, rtol = LN_TOL["bf16" if half else "f32"]
        what = (f"({rows}, {h}) {dt} rms={rms}, x and dy "
                f"{off * x.element_size()} bytes off 16, {fwd_route} / "
                f"{route} routes")
        e_fwd = _held("layer_norm_fwd", y, wy, atol, rtol, what)
        e_dx = _held("layer_norm_bwd", dx, wdx, *((atol, rtol) if half else
                                                  (1e-4, 1e-4)), "dx " + what)
        for nm, got, want in (("dw", dw, wdw), ("db", db, wdb)):
            scale = float(want.abs().max())
            _held("layer_norm_bwd", got, want, LN_TOL["grad_f32"] * scale,
                  LN_TOL["grad_f32"], f"{nm} {what}")
        again = ln._bwd_2d(x, w, dy, 1e-5, rms)
        _check(all(torch.equal(a, c) for a, c in zip(again, (dx, dw, db))),
               f"layer_norm_bwd {what}: the result differs run to run")
        case_routes.append((what, route))
        fwd_routes.append((what, fwd_route))
        if half and not rms and h == 1024 and off == 0:
            worst["layer_norm_fwd"], worst["layer_norm_bwd"] = e_fwd, e_dx
        print(f"kernel layer_norm {what}: fwd max_abs_err {e_fwd:.3e}, dx "
              f"{e_dx:.3e}, dw {_err(dw, wdw):.3e}, db {_err(db, wdb):.3e}; "
              "the same bits on a second run", flush=True)
        del x, dy, y, dx, dw, db, wy, wdx, wdw, wdb, again
    torch.cuda.synchronize()
    prof.stop()
    _ln_bwd_routes(prof, case_routes)
    _ln_fwd_routes(prof, fwd_routes)
    for what, route in fwd_routes:
        print(f"route layer_norm_fwd {what}: {LN_FWD_KERNELS[route]}",
              flush=True)
    _check([r for _, r in fwd_routes] ==
           ["register" if h <= ln.FUSED_MAX_H and off == 0 else "wide"
            for _, h, _, _, off in LN_CASES],
           f"layer_norm_fwd routes {fwd_routes}: expected the register body "
           f"up to h {ln.FUSED_MAX_H} and the wide one past it and off "
           "alignment")
    for what, route in case_routes:
        print(f"route layer_norm_bwd {what}: {len(LN_BWD_KERNELS[route])} "
              f"device kernels ({', '.join(LN_BWD_KERNELS[route])})",
              flush=True)
    _check([r for _, r in case_routes] ==
           ["fused" if h <= ln.FUSED_MAX_H and off == 0 else "three"
            for _, h, _, _, off in LN_CASES],
           f"layer_norm_bwd routes {case_routes}: expected the fused body "
           f"up to h {ln.FUSED_MAX_H} and three launches past it and off "
           "alignment")
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
    offs = mt.segment_offsets(sizes, dev)
    want = mt.flat_lamb_ref(p, grad, m, v, sizes, **kw)
    got = mt.flat_lamb(p.clone(), grad, m.clone(), v.clone(), sizes,
                       found_inf=torch.zeros((), dtype=torch.int32,
                                             device=dev), seg_offsets=offs,
                       **kw)
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
    mt.flat_lamb(p, bad, m, v, sizes, found_inf=torch.ones(
        (), dtype=torch.int32, device=dev), seg_offsets=offs, **kw)
    torch.cuda.synchronize()
    _check(bool(torch.equal(p, p0) and torch.equal(m, m0)
                and torch.equal(v, v0)),
           "flat_lamb with found_inf set changed p, m or v")
    del p0, m0, v0, bad
    # stage 2 on a bf16 p (the reference's bf16-params path): its cast
    p16 = p.to(torch.bfloat16)
    upd16 = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(
        6), device=dev) * 1e-3
    fac16 = _lamb_factor_table(dev, len(sizes))
    got16 = p16.clone()
    mt._lamb_apply(got16, upd16, fac16, offs, gate=torch.zeros(
        (), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    _held("flat_lamb_apply", got16, mt._lamb_apply_ref(p16, upd16, fac16,
                                                       sizes), 0.0, 0.0,
          "bf16 p")
    print(f"kernel flat kernels n={n} ({len(sizes)} segments): flat_l2norm "
          f"within rtol 1e-5 of its twin, the same bits on a second run, "
          f"NaN and Inf propagate; flat_lamb stages 1 and 2 equal to their "
          f"twin's bits (masters f32, grads bf16, step 3, clip 0.5; stage 2 "
          f"also on a bf16 p), stage 2 walking the segment-start table; "
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
    sizes_dev = torch.tensor(sizes, device=dev)    # the twin's, copied once
    el = rows * h
    # stage 2 must read the f32 update and read and write p: 12 B/elt
    # (it reads no per-element segment id)
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
            lambda: mt._lamb_apply(p, upd, factor, offs, gate=zero),
            lambda: mt._lamb_apply_ref(p, upd, factor, sizes_dev),
            lambda: torch.addcmul(p, per_elem, upd, value=-1),
            "torch.addcmul(p, factor[seg_ids], update, value=-1)",
            (4 + 4 + 4) * n, 2 * n),
    }
    entries = []
    for name, (kern, plain, lib, lib_note, nbytes, ops) in timings.items():
        source, replaces, (atol, rtol), symbol = BERT_KERNELS[name]
        if symbol[1] is None:
            symbol = (symbol[0], ln.BWD_DEVICE_KERNELS[ln.bwd_route(x, dy)])
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
    ms16 = _ms(lambda: mt._lamb_apply(got16, upd16, fac16, offs, gate=zero),
               iters=20, warmup=3)
    b16, _ = _bound((2 + 2 + 4) * n, 2 * n)
    print(f"time flat_lamb_apply bf16 p: kernel {ms16:.4f} ms, bound "
          f"{b16:.4f} ms (bytes: 8 B/elt), {100 * b16 / ms16:.1f}% of the "
          f"bound [{smi}]", flush=True)
    del p16, upd16, got16
    _ln_bwd_time_at(dev, smi, rows, 768, "GPT-2 small")
    for shape in LN_FWD_TIMED:
        _ln_fwd_time_at(dev, smi, *shape)
    return entries


def _lamb_factor_table(dev, nseg):
    """A per-segment factor table of LAMB's scale (lr times a trust
    ratio near 1)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(7)
    return 1e-3 * (0.5 + torch.rand(nseg, generator=g, device=dev))


# the LayerNorm forward timed beyond BERT-L's (4096, 1024) bf16: rows, h,
# dtype, what
LN_FWD_TIMED = ((4096, 768, "bf16", "GPT-2 small"),
                (4096, 1024, "f32", "BERT-L's width in f32"),
                (4096, 8192, "bf16", "h 8192"),
                (1024, 8192, "f32", "h 8192 in f32"))


def _ln_fwd_time_at(dev, smi: str, rows: int, h: int, dtn: str,
                    what: str) -> None:
    """The LayerNorm forward timed at (rows, h) beside its twin,
    ``F.layer_norm`` and the bytes bound."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln
    dt = _dtype(dtn)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(rows, h, generator=g, device=dev).to(dt)
    w = (torch.randn(h, generator=g, device=dev) * 0.1 + 1).to(dt)
    b = (torch.randn(h, generator=g, device=dev) * 0.1).to(dt)
    route = ln.fwd_route(x)
    kern = lambda: ln._fwd_2d(x, w, b, 1e-5, False)
    ms = _ms(kern, iters=20, warmup=3)
    plain_ms = _ms(lambda: ln._fwd_2d_ref(x, w, b, 1e-5, False), iters=5,
                   warmup=1)
    lib_ms = _ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5), iters=20,
                 warmup=3)
    el, sz = rows * h, x.element_size()
    nbytes, ops = 2 * el * sz + 2 * h * sz, 8 * el
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"time layer_norm_fwd ({rows}, {h}) {dtn} ({what}, {route} "
          f"route): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms (F.layer_norm), bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes} B, {ops} FLOP), {100 * bound_ms / ms:.1f}% "
          f"of the bound [{smi}]", flush=True)


def _ln_bwd_time_at(dev, smi: str, rows: int, h: int, what: str) -> None:
    """The LayerNorm backward timed at (rows, h) bf16 beside its twin,
    ``aten.native_layer_norm_backward`` and the bytes bound."""
    import torch
    from apex_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(8)
    x, dy = (torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    w = torch.ones(h, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(h, device=dev, dtype=torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], w, b, 1e-5)
    route = ln.bwd_route(x, dy)
    kern = lambda: ln._bwd_2d(x, w, dy, 1e-5, False)
    ms = _ms(kern, iters=20, warmup=3)
    own_ms, all_ms, per_call = _wrapper_device_split(
        kern, ("ln_bwd_",), ln.BWD_DEVICE_KERNELS[route])
    plain_ms = _ms(lambda: ln._bwd_2d_ref(x, w, dy, 1e-5, False), iters=5,
                   warmup=1)
    lib_ms = _ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [h], mean, rstd, w, b, [True, True, True]), iters=20,
        warmup=3)
    el = rows * h
    nbytes, ops = 2 * el * 3 + 2 * h + 8 * h, 14 * el
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"time layer_norm_bwd ({rows}, {h}) bf16 ({what}, {route} route): "
          f"kernel {ms:.4f} ms (its own kernels {own_ms:.4f} ms; all device "
          f"work captured {all_ms:.4f} ms in {per_call:g} device kernels a "
          f"call, profiler), plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
          f"ms (aten.native_layer_norm_backward with saved mean/rstd), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops} FLOP), "
          f"{100 * bound_ms / ms:.1f}% of the bound [{smi}]", flush=True)


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


def _bert_launches_expected(steps: int, buckets: int,
                            layers: int = BERT_LAYERS, flash: bool = False,
                            xent: bool = False) -> dict:
    """A BERT step's exact launch counts: LayerNorm (the embedding's and
    two a layer), one flat_l2norm and one of each LAMB stage a bucket;
    on a flash batch the forward, dq and dk/dv once a layer; one
    xent_fwd and xent_bwd where the vocabulary is on the cross entropy's
    gate."""
    from apex_tpu_torch import _build
    want = {k.name: 0 for k in _build.KERNELS}
    want.update({"layer_norm_fwd": (1 + 2 * layers) * steps,
                 "layer_norm_bwd": (1 + 2 * layers) * steps,
                 "flat_l2norm": buckets * steps,
                 "flat_lamb_moments": buckets * steps,
                 "flat_lamb_apply": buckets * steps})
    if flash:
        want.update({k: layers * steps
                     for k in ("flash_fwd", "flash_dq", "flash_dkv")})
    if xent:
        want.update(xent_fwd=steps, xent_bwd=steps)
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


def _ln_fwd_in_profile(by_name, per_step: int, what: str, smi: str) -> None:
    """Checks that a profiled step's LayerNorm forwards ran the register
    body: ln_fwd_reg_kernel records (``per_step`` launches a step, by the
    launch counts; a session may lose its first records) and none of the
    wide ln_fwd_kernel."""
    count = {r: sum(c for name, (_, c) in by_name.items() if k in name)
             for r, k in LN_FWD_KERNELS.items()}
    ms = sum(t for name, (t, _) in by_name.items()
             if LN_FWD_KERNELS["register"] in name) / 1e3
    print(f"profile train step {what}: layer_norm forward {count['register']}"
          f" x {LN_FWD_KERNELS['register']} ({ms:.3f} ms), "
          f"{count['wide']} x {LN_FWD_KERNELS['wide']} [{smi}]", flush=True)
    _check(count["wide"] == 0 and 0 < count["register"] <= per_step,
           f"{what}: a step's LayerNorm forwards ran {count}, expected "
           f"{per_step} of the register body")


def bert_profile_phase(dev, smi: str, step, amp_state, batches) -> None:
    """Device time by kernel over one BERT-L training step, from
    ``torch.profiler``: the busy share, the largest device items and the
    five kernels' share of busy time."""
    tokens, labels, mask, _ = batches[0]
    loss, amp_state = step(amp_state, tokens, labels, mask)
    wall, by_name = _profile_step(
        lambda: step(amp_state, tokens, labels, mask))
    busy = sum(t for t, _ in by_name.values()) / 1e3
    ours = {k: sum(t for name, (t, _) in by_name.items()
                   if _owns(name, v[3][0])) / 1e3
            for k, v in BERT_KERNELS.items()}
    total = sum(ours.values())
    _ln_fwd_in_profile(by_name, LN_PER_STEP, "bert-large", smi)
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
    # name, b, h, hk, sq, sk, d, causal, segment ids, dtype
    ("gpt2_block", 8, 12, 12, 512, 512, 64, True, None, "bf16"),
    ("bert_large_unmasked", 8, 16, 16, 512, 512, 64, False, None, "bf16"),
    ("bert_large_packed", 8, 16, 16, 512, 512, 64, False, "packed", "bf16"),
    ("gqa_12_to_4_s200", 2, 12, 4, 200, 200, 64, True, "ragged", "bf16"),
    ("f32_gqa_s300", 2, 12, 4, 300, 300, 64, True, "ragged", "f32"),
    ("f32_d128_packed", 2, 8, 8, 256, 256, 128, False, "packed", "f32"),
    ("d128_causal_s130", 2, 8, 8, 130, 130, 128, True, None, "bf16"),
    ("d128_packed", 2, 8, 8, 256, 256, 128, False, "packed", "bf16"),
    ("d32_causal", 2, 8, 8, 256, 256, 32, True, None, "bf16"),
    # query and key lengths apart (the wrapper takes Sk from k)
    ("cross_sq130_sk70_causal", 2, 8, 8, 130, 70, 64, True, None, "bf16"),
    ("cross_sq200_sk330_d128", 1, 8, 4, 200, 330, 128, False, None, "bf16"),
    # GPTModel's attention at b8 x s1024 (phase 35), causal; its packed
    # RoPE rows' segment ids (gpt_model_batch, the phase's seed)
    ("gpt_model_causal", 8, 12, 12, 1024, 1024, 64, True, None, "bf16"),
    ("gpt_model_packed", 8, 12, 12, 1024, 1024, 64, True, "gpt_model",
     "bf16"),
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


def _bwd_kernel_calls(q, k, v, o, lse, do, causal, seg, rate=0.0,
                      seed=None, cuda_cores=False, out=None):
    """The dq and dk/dv kernels, each launched on its own with the
    arguments the wrapper gives them (to time each).  ``cuda_cores``:
    the CUDA-core bodies instead, through their own entry points
    (``apex_flash_{dq,dkv}_cuda_cores``: every width they have, 16..512;
    not counted as launches), to time them beside the routed bodies on
    the same inputs.  ``out``: a list that receives the (dq, dk, dv)
    tensors the calls write."""
    import ctypes
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    (b, h, hk, sq, sk, d), code, qp, kp = attn._geometry(q, k, v, seg)
    di = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if out is not None:
        out.extend((dq, dk, dv))
    common = (code, b, h, hk, sq, sk, d, int(causal), 1.0 / math.sqrt(d),
              *attn._dropout_args(rate, seed, q.device),
              torch.cuda.current_stream().cuda_stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), di.data_ptr())
    launch_dq, launch_dkv = attn.FLASH_DQ.launch, attn.FLASH_DKV.launch
    if cuda_cores:
        lib = _build.library("flash_bwd")
        fns = []
        for sym, kern in (("apex_flash_dq_cuda_cores", attn.FLASH_DQ),
                          ("apex_flash_dkv_cuda_cores", attn.FLASH_DKV)):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int

            def launch(*args, fn=fn, sym=sym):
                rc = fn(*args)
                _check(rc == 0, f"{sym} failed to launch: CUDA error {rc}")
            fns.append(launch)
        launch_dq, launch_dkv = fns
    # each call holds di, whose pointer it passes: freed, its block would
    # go to the next tensor of its size (an lse), which the kernel would
    # then read as di
    return (lambda di=di: launch_dq(*ins, dq.data_ptr(), qp, kp, *common),
            lambda di=di: launch_dkv(*ins, dk.data_ptr(), dv.data_ptr(), qp,
                                     kp, *common))


def _fwd_kernel_call(q, k, v, causal, rate=0.0, seed=None,
                     cuda_cores=False, out=None):
    """The forward (with lse) launched on its own with the arguments the
    wrapper gives it.  ``cuda_cores``: the CUDA-core body instead, through
    its own entry point (``apex_flash_fwd_cuda_cores``: 16..512; not
    counted as a launch), to time it beside the routed body on the
    same inputs.  ``out``: a list that receives the (o, lse) it writes."""
    import ctypes
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    (b, h, hk, sq, sk, d), code, qp, kp = attn._geometry(q, k, v, None)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    if out is not None:
        out.extend((o, lse))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), qp, kp, code, b, h, hk, sq, sk, d, int(causal),
            1.0 / math.sqrt(d), *attn._dropout_args(rate, seed, q.device),
            torch.cuda.current_stream().cuda_stream)
    # the call holds o and lse, whose pointers it passes
    if not cuda_cores:
        return lambda keep=(o, lse): attn.FLASH_FWD.launch(*args)
    fn = _build.library("flash_fwd").apex_flash_fwd_cuda_cores
    fn.argtypes, fn.restype = attn.FLASH_FWD.argtypes, ctypes.c_int

    def launch(keep=(o, lse)):
        rc = fn(*args)
        _check(rc == 0, f"apex_flash_fwd_cuda_cores failed to launch: CUDA "
               f"error {rc}")
    return launch


FLASH_SYMS = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_kernel",
              "flash_dkv": "flash_dkv_kernel"}


def _flash_routes(prof, case_launches, drop: bool) -> dict:
    """{case: {kernel: route}}: the route each flash kernel took in each
    case, read from the device kernels' names in one ``torch.profiler``
    session over every case ("tensor cores" for a ``..._kernel_tc``,
    wgmma + TMA; "CUDA cores" for the FMA body).  One stream runs its
    kernels in launch order, so each kernel's device events, by start
    time, fall to the cases in turn by ``case_launches``, [(case,
    {kernel: launches})].  Every name must carry the ``DROP`` template
    argument ``drop`` (the bodies' last: ``..., true>`` with dropout, or
    ``<true>`` in the wide forward, whose only one it is).
    (One session: on an H100, short sessions of a small case's few calls
    came back without their kernels.)  "wide CUDA cores" is a
    ``..._kernel_wide`` (D 1024..8192, F5c), "wide tensor cores" a
    ``..._kernel_tc_wide`` (the bf16 forward there)."""
    import re
    import torch
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    routes = {case: {} for case, _ in case_launches}
    for kname, sym in FLASH_SYMS.items():
        names = [e.name for e in events if sym in e.name]
        want = sum(n[kname] for _, n in case_launches)
        _check(len(names) == want, f"the profiler saw {len(names)} "
               f"{sym} on the device where {want} were launched")
        # the template arguments' last, DROP (the wide forward's only one)
        drops = {x: re.search(sym + r"(_tc_wide|_tc|_wide)?<([^>]*, )?"
                              r"(true|false)>", x) for x in names}
        wrong = {x for x, m in drops.items()
                 if not m or m.group(3) != str(drop).lower()}
        _check(not wrong, f"{kname}: the bodies {wrong} are not the DROP="
               f"{str(drop).lower()} instantiation")
        i = 0
        for case, n in case_launches:
            seen = set(names[i:i + n[kname]])
            i += n[kname]
            kinds = {"wide tensor cores" if sym + "_tc_wide" in x else
                     "tensor cores" if sym + "_tc" in x else
                     "wide CUDA cores" if sym + "_wide" in x else
                     "CUDA cores" for x in seen}
            _check(len(kinds) == 1,
                   f"{case}: {kname} took the routes {seen}")
            routes[case][kname] = kinds.pop()
    return routes


def _flash_records_complete(prof, counts: dict) -> bool:
    """Whether a ``torch.profiler`` session holds a device record of every
    flash kernel launch ``counts`` ({kernel: launches}) names."""
    import torch
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return all(sum(FLASH_SYMS[kn] in n for n in names) == counts.get(kn, 0)
               for kn in FLASH_SYMS)


def _ptxas_report(log: str, marker: str) -> list:
    """(entry, registers line, spill line) of every kernel whose mangled
    name holds ``marker``, from a library's ptxas report."""
    out = []
    entry = spill = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            spill = None
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry \
                and marker in entry:
            out.append((entry, line.split(":", 1)[-1].strip(), spill))
    return out


def attn_train_kernel_phase(dev, smi: str) -> dict:
    """The forward with lse and the dq, dk/dv kernels against their twins
    on the card (the twins' backward takes the kernel's o and lse, so each
    kernel is held on the same inputs), then timed at the GPT block's and
    BERT-L's shapes beside the twins, SDPA and the bound.  Returns the
    worst error of each kernel and the GPT-shape timing rows."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn

    gen = torch.Generator(device=dev).manual_seed(6)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    kern = {"flash_fwd": attn.FLASH_FWD, "flash_dq": attn.FLASH_DQ,
            "flash_dkv": attn.FLASH_DKV}
    case_launches = []
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _prime_profiler()
    for name, b, h, hk, sq, sk, d, causal, kind, dtn in ATTN_CASES:
        before = {kn: kt.launches for kn, kt in kern.items()}
        dt = _dtype(dtn)
        s = sq       # segment ids take one length: only sq == sk cases
        q, k, v, do = (torch.randn(b, n, length, d, generator=gen,
                                   device=dev).to(dt)
                       for n, length in ((h, sq), (hk, sk), (hk, sk),
                                         (h, sq)))
        seg = _case_ids(kind, b, s, dev)
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
        case_launches.append(
            (name, {kn: kt.launches - before[kn] for kn, kt in kern.items()}))
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
    torch.cuda.synchronize()
    prof.stop()
    case_routes = _flash_routes(prof, case_launches, drop=False)
    del prof
    for name, b, h, hk, sq, sk, d, causal, kind, dtn in ATTN_CASES:
        routes = case_routes[name]
        want = _flash_route_of(d, dtn)
        _check(routes == want, f"{name}: routes {routes}, expected {want} "
               "(ops.attention.flash_route)")
        print(f"route {name} {dtn} D {d} Sq {sq} Sk {sk}: "
              + ", ".join(f"{kn} {r}" for kn, r in routes.items()),
              flush=True)

    # tensor-core bodies a library holds: the forward, dq and dk/dv at D
    # 16, 32, 64, 128 and 256, and their wide bodies; each at rate 0 and
    # with dropout
    for lib, n_tc in (("flash_fwd", 12), ("flash_bwd", 24)):
        _check(lib in _build.build_logs, f"no ptxas report of {lib}: its "
               "library was loaded without the log of its build")
        tc_kernels = _ptxas_report(_build.build_logs[lib], "_tc")
        _check(len(tc_kernels) == n_tc, f"ptxas reported {len(tc_kernels)} "
               f"tensor-core bodies in {lib}, expected {n_tc} (with and "
               "without dropout each)")
        for entry, regs, spill in tc_kernels:
            print(f"ptxas tensor-core body {entry}: {regs}; {spill}",
                  flush=True)
            _check(spill is not None and "0 bytes spill stores" in spill
                   and "0 bytes spill loads" in spill,
                   f"ptxas reports spills for {entry}: {spill}")
    encode = _build.library("flash_fwd").apex_flash_map_encode_us
    encode.argtypes = [ctypes.c_void_p, ctypes.c_int]
    encode.restype = ctypes.c_double
    buf = torch.empty(96 * 512 * 64, dtype=torch.bfloat16, device=dev)
    map_us = encode(buf.data_ptr(), 10000)
    del buf
    _check(map_us > 0, "encoding a TMA tensor map failed")
    print(f"host: one TMA tensor map encodes in {map_us:.3f} us (mean of "
          f"10000); the tensor-core forward encodes 3 a call "
          f"({3 * map_us:.3f} us), dq and dk/dv 4 each ({4 * map_us:.3f} "
          "us)",
          flush=True)

    rows, ratios = {}, {}
    for name, b, h, hk, s, _, d, causal, kind, dtn in ATTN_CASES[:2]:
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
                                   library_ms=lib_ms,
                                   body=case_routes[name][kname])
            ratios[name, kname] = ms / lib_ms
        print(f"time ratio {name}: flash_fwd / SDPA forward "
              f"{ratios[name, 'flash_fwd']:.2f}x, flash_dkv / SDPA backward "
              f"{ratios[name, 'flash_dkv']:.2f}x, flash_dq / SDPA backward "
              f"{ratios[name, 'flash_dq']:.2f}x [{smi}]", flush=True)
        del q, k, v, do, o, lse, qq, kk, vv, out
    return dict(worst=worst, rows=rows)


def _adam_held(dev, gen, n: int, gdt=None):
    """flat_adam against its twin at ``n`` elements, f32 masters and
    ``gdt`` (default bf16) grads: AdamW and Adam, with and without bias
    correction, the twin's bits exactly (the grad scale a power of two);
    with ``found_inf`` set p, m and v keep theirs.  Returns the worst
    error and the (p, g, m, v) it drew."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt
    gdt = gdt or torch.bfloat16

    def vec(n, scale=1.0, dtype=torch.float32):
        return (torch.randn(n, generator=gen, device=dev) * scale).to(dtype)

    worst = 0.0
    p, g = vec(n, 0.02), vec(n, 1e-3, gdt)
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
          f"and off (masters f32, grads {gdt}, step 3, grad scale 1 or "
          f"65536) equal to the twin's bits; found_inf=1 leaves p, m "
          f"and v bit-unchanged", flush=True)
    return worst, (p, g, m, v)


def _unscale_norm_held(dev, gen, n: int, dtype) -> float:
    """flat_unscale_norm against its twin at ``n`` elements of ``dtype``
    (FLAT_TOL), clean and with an Inf in the last element: the output,
    the sum of squares (the same bits on a second run) and the flag.
    Returns the worst error of the output."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt
    worst = 0.0
    inv = torch.full((), 1.0 / 2 ** 16, device=dev)
    for poison in (None, "inf"):
        x = torch.randn(n, generator=gen, device=dev).to(dtype)
        if poison:
            x[n - 1] = float(poison)
        want = mt.flat_unscale_norm_ref(x, inv)
        out, nsq, flag = mt.flat_unscale_norm(x, inv)
        torch.cuda.synchronize()
        _check(int(flag) == int(want[2]) == (poison is not None),
               f"flat_unscale_norm n={n} {dtype}: flag {int(flag)} for "
               f"{poison}")
        worst = max(worst, _close("flat_unscale_norm", out, want[0],
                                  f"out n={n} {dtype} poison={poison}"))
        if poison is None:
            _close("flat_unscale_norm", nsq, want[1],
                   f"norm_sq n={n} {dtype}")
            again = mt.flat_unscale_norm(x, inv)[1]
            _check(bool(torch.equal(again, nsq)),
                   f"flat_unscale_norm n={n} {dtype}: the sum differs run "
                   "to run")
        del x, want, out, nsq, flag
    print(f"kernel flat_unscale_norm n={n} {dtype}: out within FLAT_TOL "
          f"{FLAT_TOL['flat_unscale_norm']} of the twin, clean and with an "
          f"Inf (flagged); the same sum of squares on a second run",
          flush=True)
    return worst


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
    worst = 0.0
    for n in (ADAM_RAGGED, GPT_BUCKET):     # the bucket's buffers stay
        err, (p, g, m, v) = _adam_held(dev, gen, n)
        worst = max(worst, err)

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


def _gpt_launches_expected(steps: int, buckets: int, layers: int = 0
                           ) -> dict:
    """Every kernel's launches in ``steps`` GPT steps of ``layers``
    (default GPT's) layers: 3 flash kernels a layer, 2 LayerNorms a layer
    and the final one, one unscale and one Adam a bucket."""
    from apex_tpu_torch import _build
    want = {k.name: 0 for k in _build.KERNELS}
    L = layers or GPT["layers"]
    want.update({"flash_fwd": L * steps, "flash_dq": L * steps,
                 "flash_dkv": L * steps,
                 "layer_norm_fwd": (2 * L + 1) * steps,
                 "layer_norm_bwd": (2 * L + 1) * steps,
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
        if e["name"] in ("flash_fwd", "flash_dq", "flash_dkv", "flat_adam"):
            e["launches"] = launches[e["name"]]
    return s, state, tokens


# the device kernels of the GPT step that the port owns
GPT_OWN = {"flash_fwd": ("flash_fwd_kernel",),
           "flash_dq": ("flash_dq_kernel",),
           "flash_dkv": ("flash_dkv_kernel",),
           "layer_norm": ("ln_fwd_", "ln_bwd_"),
           "flat_unscale_norm": ("unscale_norm", "sum_combine"),
           "flat_adam": ("adam_kernel",)}


def gpt_profile_phase(dev, smi: str, s, state, tokens,
                      optimizer: str = "FusedAdam", own=None) -> None:
    """Device time by kernel over one GPT block training step, from
    ``torch.profiler``: the busy share, the largest device items and the
    port's kernels' (``own``, default ``GPT_OWN``) share of busy time."""
    own = GPT_OWN if own is None else own
    loss, state = s.step(state, tokens)
    wall, by_name = _profile_step(lambda: s.step(state, tokens))
    busy = sum(t for t, _ in by_name.values()) / 1e3
    ours = {k: sum(t for name, (t, _) in by_name.items()
                   if _owns(name, syms)) / 1e3
            for k, syms in own.items()}
    total = sum(ours.values())
    _ln_fwd_in_profile(by_name, LN_PER_GPT_STEP, f"gpt-2 small {optimizer}",
                       smi)
    attn_ms = sum(t for k, t in ours.items() if k.startswith("flash_"))
    print(f"profile train step gpt-2 small O2 {optimizer}: attention "
          f"(flash_fwd + flash_dq + flash_dkv) {attn_ms:.3f} ms, "
          f"{100 * attn_ms / busy:.2f}% of busy {busy:.2f} ms [{smi}]",
          flush=True)
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


# GPT-2 small's published widths as ``models.GPTModel`` (12 x 768, 12
# heads, vocab 50257, 1024 positions), 8 rows of 1024 tokens, amp O2,
# FusedAdam lr 3e-4: learned positions on a fixed random batch, and RoPE
# on packed rows (``pack_dataset`` over sequences of 32..1024 tokens)
GPT_MODEL = dict(layers=12, hidden=768, heads=12, vocab=50257,
                 max_seq_len=1024, seq=1024, batch=8, lr=3e-4, warmup=2,
                 steps={"learned": 8, "packed_rope": 4}, lengths=(32, 1024))
# words in the names of cuBLAS's GEMM kernels on the card
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# the kernels a GPTModel step launches (the vocab-parallel loss is plain)
GPT_MODEL_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "layer_norm_fwd",
                     "layer_norm_bwd", "flat_unscale_norm", "flat_adam")


def gpt_model_batch(kind: str, batch: int, seq: int, vocab: int, seed: int,
                    lengths=None):
    """numpy (tokens, labels, segment_ids, positions) for ``kind``
    "learned" (a fixed random batch; no segments) or "packed_rope"
    (sequences of ``lengths`` tokens from ``default_rng(seed)`` through
    ``data.pack_dataset``, its first batch); labels are the tokens
    shifted by one."""
    import numpy as np
    from apex_tpu_torch.data import pack_dataset
    rng = np.random.default_rng(seed)
    if kind == "learned":
        tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
        return tokens, np.roll(tokens, -1, axis=1), None, None
    lo, hi = lengths or (32, seq)

    def stream():
        while True:
            yield rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))

    p = next(pack_dataset(stream(), max_len=seq, rows_per_batch=batch,
                          buffer_batches=1))
    return (p["tokens"], np.roll(p["tokens"], -1, axis=1), p["segment_ids"],
            p["positions"])


def gpt_model_setup(model, params, device, opt_level: str, lr: float,
                    packed: bool, **adam):
    """``GPTModel.loss`` under amp with a bucketed FusedAdam through the
    flat pipeline: the GPT block example's ``setup`` with the model's
    loss as the objective; the step takes (tokens, labels[, segment_ids,
    positions])."""
    from apex_tpu_torch.examples import gpt_train_block as ex
    if packed:
        def loss_fn(p, tokens, labels, seg, pos):
            return model.loss(p, tokens, labels, seg, pos)
    else:
        def loss_fn(p, tokens, labels):
            return model.loss(p, tokens, labels)
    return ex.setup(model, params, device, opt_level=opt_level, lr=lr,
                    loss_fn=loss_fn, **adam)


def _on(device, arrays):
    """The non-None numpy arrays as int64 tensors on ``device``."""
    import torch
    return tuple(torch.from_numpy(a).long().to(device) for a in arrays
                 if a is not None)


def gpt_model_phase(dev, smi: str, entries: list) -> None:
    """``models.GPTModel`` at GPT-2 small's widths (``GPT_MODEL``), amp O2
    and FusedAdam through the flat pipeline, learned positions (2 warm-up
    and 8 timed steps) and RoPE on packed rows (2 + 4).  First
    flat_unscale_norm and flat_adam are held against their twins at
    each model's own bucket size and dtypes.  Then ms a step on the
    host clock and by CUDA events, tokens/s (real tokens when packed),
    peak memory, finite and falling losses, and the launches of the
    timed steps, zeroed just before them: exactly 12 flash forwards, dq
    and dk/dv, 25 LayerNorm forwards and backwards and one
    flat_unscale_norm and flat_adam a step, nothing else.  Then one
    profiled step: busy share, the port's kernels' share, the largest
    device items.  Each kernel entry of ``GPT_MODEL_KERNELS`` gets the
    launches under ``gpt_model_launches``."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import GPTModel

    cfg = GPT_MODEL
    for kind in ("learned", "packed_rope"):
        rope = kind == "packed_rope"
        t0 = time.perf_counter()
        model = GPTModel(cfg["vocab"], cfg["hidden"], cfg["heads"],
                         cfg["layers"], max_seq_len=cfg["max_seq_len"],
                         use_rope=rope, dtype=torch.bfloat16)
        params = model.init(0, "cpu")
        s = gpt_model_setup(model, params, dev, "O2", cfg["lr"], rope)
        del params
        sizes = [b.size for b in s.opt._plan.buckets]
        _check(len(sizes) == 1, f"gpt model {kind}: O2 buckets {sizes}")
        # the flat tail's two kernels at this bucket's size and dtypes
        # (grads in the model's dtype, f32 masters), before the counts
        # are zeroed
        bucket = s.opt._plan.buckets[0]
        _check(bucket.dtype == torch.float32, f"gpt model {kind}: masters "
               f"{bucket.dtype}")
        with torch.no_grad():
            tail_gen = torch.Generator(device=dev).manual_seed(15)
            _unscale_norm_held(dev, tail_gen, sizes[0], bucket.model_dtype)
            _adam_held(dev, tail_gen, sizes[0], bucket.model_dtype)
        torch.cuda.empty_cache()
        # the peak from here: the model's state and the steps
        torch.cuda.reset_peak_memory_stats(dev)
        np_batch = gpt_model_batch(kind, cfg["batch"], cfg["seq"],
                                   cfg["vocab"], seed=1,
                                   lengths=cfg["lengths"])
        batch = _on(dev, np_batch)
        real = (int((np_batch[2] > 0).sum()) if rope
                else cfg["batch"] * cfg["seq"])
        what = (f"gpt-2 small GPTModel {'RoPE, packed' if rope else 'learned'}"
                f" O2 FusedAdam b{cfg['batch']} s{cfg['seq']}")
        print(f"{what}: {sizes[0]} parameters in one O2 bucket, init and "
              f"setup {time.perf_counter() - t0:.1f} s"
              + (f"; {real} real tokens of {cfg['batch'] * cfg['seq']} in "
                 f"{int(np_batch[2].max(axis=1).sum())} sequences"
                 if rope else ""), flush=True)
        state = s.amp_state
        for _ in range(cfg["warmup"]):
            loss, state = s.step(state, *batch)
        torch.cuda.synchronize()
        steps = cfg["steps"][kind]
        _build.reset_launch_counts()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        losses = []
        t0 = time.perf_counter()
        events[0].record()
        for i in range(steps):
            loss, state = s.step(state, *batch)
            losses.append(loss)
            events[i + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _build.KERNELS}
        losses = [float(x) for x in losses]
        _check(all(math.isfinite(x) for x in losses)
               and losses[-1] < losses[0],
               f"{what}: losses {losses} not finite and falling")
        want = _gpt_launches_expected(steps, len(sizes), cfg["layers"])
        _check(launches == want, f"{what}: launches {launches}, expected "
                                 f"{want}")
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        per_step = {k: launches[k] // steps for k in GPT_MODEL_KERNELS}
        print(f"train {what}: {steps} timed steps after {cfg['warmup']} "
              f"warm-up, {1e3 * wall / steps:.2f} ms/step (host clock), "
              f"device ms/step median {float(np.median(step_ms)):.2f} (min "
              f"{min(step_ms):.2f}, max {max(step_ms):.2f}; CUDA events "
              f"between steps), {real * steps / wall:.1f} "
              f"{'real ' if rope else ''}tokens/s, losses "
              f"{[round(x, 4) for x in losses]}, loss scale "
              f"{float(state.scaler.loss_scale):.0f}, peak device memory "
              f"{peak:.2f} GiB, launches a step {per_step} (every other "
              f"kernel 0) [{smi}]", flush=True)
        for e in entries:
            if e["name"] in GPT_MODEL_KERNELS:
                e.setdefault("gpt_model_launches", {})[kind] = \
                    launches[e["name"]]

        loss, state = s.step(state, *batch)
        wall, by_name = _profile_step(lambda: s.step(state, *batch))
        busy = sum(t for t, _ in by_name.values()) / 1e3
        ours = {k: sum(t for name, (t, _) in by_name.items()
                       if _owns(name, syms)) / 1e3
                for k, syms in GPT_OWN.items()}
        gemm = sum(t for name, (t, _) in by_name.items()
                   if any(w in name.lower() for w in GEMM_NAMES)) / 1e3
        _ln_fwd_in_profile(by_name, 2 * cfg["layers"] + 1, what, smi)
        print(f"profile train step {what}: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
              f"{sum(c for _, c in by_name.values())} device kernels; GEMMs "
              f"{gemm:.3f} ms ({100 * gemm / busy:.1f}% of busy); the port's "
              f"kernels {sum(ours.values()):.3f} ms "
              f"({100 * sum(ours.values()) / busy:.2f}% of busy): "
              + ", ".join(f"{k} {t:.3f} ms" for k, t in ours.items())
              + f"; rest (device idle) {wall - busy:.2f} ms [{smi}]",
              flush=True)
        for name, (t_us, c) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])[:14]:
            print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
                  flush=True)
        del s, state, batch, loss
        torch.cuda.empty_cache()


# packed rows of sequences of 16..64 tokens: several segments a row, so
# that "segments not masked" changes the loss
GPT_MODEL_CONSIST = dict(layers=2, batch=2, seq=128, steps=3,
                         lengths=(16, 64))
# the wrong updates each case's limit must reject, run on the CPU
# (a structural one a case, and the nearest: lr 4% high; Adam's bias
# correction is the GPT block check's)
GPT_MODEL_MUTANTS = {"learned": ("attention not causal", "lr 4% high"),
                     "packed_rope": ("segments not masked", "lr 4% high")}


def gpt_model_consistency_phase(dev) -> None:
    """``models.GPTModel`` cut to 2 layers at GPT-2 small's widths
    (hidden 768, 12 heads, vocab 50257), f32 (O0), FusedAdam lr 3e-4 eps
    1e-4 (``GPT_CONSIST_ADAM``), 3 steps from the same weights on the
    card (kernels) and on the CPU (plain twins): learned positions on a
    random 2 x 128 batch, and RoPE on 2 packed rows of 128.  The first
    loss within rtol 1e-5; the final params' gap (``_gap``) under a tenth
    of the nearest wrong update of ``GPT_MODEL_MUTANTS`` (attention not
    causal, packed segments not masked, lr 4% high), run on the CPU, and
    each of them rejected."""
    import torch
    from apex_tpu_torch._tree import leaf_paths, tree_flatten, tree_leaves
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models import gpt as gpt_mod

    cfg, big = GPT_MODEL_CONSIST, GPT_MODEL
    for kind, mutants in GPT_MODEL_MUTANTS.items():
        rope = kind == "packed_rope"
        model = GPTModel(big["vocab"], big["hidden"], big["heads"],
                         cfg["layers"], max_seq_len=big["max_seq_len"],
                         use_rope=rope, dtype=torch.float32)
        params = model.init(0, "cpu")
        init = [t.numpy() for t in tree_leaves(params)]
        names = leaf_paths(tree_flatten(params)[1])
        np_batch = gpt_model_batch(kind, cfg["batch"], cfg["seq"],
                                   big["vocab"], seed=3,
                                   lengths=cfg["lengths"])

        def run(device, mutant=None):
            adam = dict(GPT_CONSIST_ADAM)
            if mutant == "bias correction dropped":
                adam["bias_correction"] = False
            lr = big["lr"] * (1.04 if mutant == "lr 4% high" else 1.0)
            real_fa, real_ids = gpt_mod.flash_attention, \
                gpt_mod.packed_segment_ids
            if mutant == "attention not causal":
                gpt_mod.flash_attention = (
                    lambda q, k, v, causal=False, **kw:
                    real_fa(q, k, v, causal=False, **kw))
            if mutant == "segments not masked":
                gpt_mod.packed_segment_ids = lambda ids: None
            try:
                s = gpt_model_setup(model, params, device, "O0", lr, rope,
                                    **adam)
                batch = _on(device, np_batch)
                state, losses = s.amp_state, []
                for _ in range(cfg["steps"]):
                    loss, state = s.step(state, *batch)
                    losses.append(loss)
            finally:
                gpt_mod.flash_attention = real_fa
                gpt_mod.packed_segment_ids = real_ids
            losses = [float(x) for x in losses]
            return losses, [t.float().cpu().numpy()
                            for t in tree_leaves(s.opt.params)]

        card_l, card_m = run(dev)
        cpu_l, cpu_m = run("cpu")
        gaps = {m: _gap(run("cpu", m)[1], cpu_m, init) for m in mutants}
        _check(all(math.isfinite(x) for x in card_l + cpu_l),
               f"gpt model consistency {kind}: non-finite loss {card_l} "
               f"{cpu_l}")
        rel0 = abs(card_l[0] - cpu_l[0]) / abs(cpu_l[0])
        gap = _gap(card_m, cpu_m, init)
        limit = min(gaps.values()) / MUTANT_FACTOR
        print(f"consistency train GPTModel {kind} 2x768 vocab 50257 O0 "
              f"(f32) FusedAdam eps {GPT_CONSIST_ADAM['eps']:g} b"
              f"{cfg['batch']} s{cfg['seq']}, {cfg['steps']} steps: card "
              f"losses {[round(x, 6) for x in card_l]}, cpu "
              f"{[round(x, 6) for x in cpu_l]} (first rel diff {rel0:.3e}, "
              f"tol 1e-05); params' gap {gap:.3e} of their displacement, "
              f"tol {limit:.3e} = the nearest wrong update / "
              f"{MUTANT_FACTOR:g}; wrong updates on the cpu (gap): "
              + ", ".join(f"{k} {g:.3e}" for k, g in gaps.items()),
              flush=True)
        print("consistency   params' gap by leaf (share of the gap^2): "
              + _gap_leaves(card_m, cpu_m, init, names), flush=True)
        _check(rel0 <= 1e-5, f"gpt model consistency {kind}: first loss "
                             f"differs by {rel0}")
        _check(gap <= limit, f"gpt model consistency {kind}: params' gap "
                             f"{gap} over {limit}")
        for name, g in gaps.items():
            _check(g > limit, f"gpt model consistency {kind}: the limit "
                              f"does not reject '{name}'")


BERT_FLASH = dict(warmup=2, steps=4)


def _flash_step_profile(what: str, fn, smi: str) -> None:
    """One training step ``fn`` under the profiler: its wall, busy and
    idle device time, attention's (the three flash kernels') share of
    busy time, and the largest device items."""
    wall, by_name = _profile_step(fn)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    flash = {k: sum(t for name, (t, _) in by_name.items()
                    if _owns(name, GPT_OWN[k])) / 1e3
             for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    attn_ms = sum(flash.values())
    print(f"profile train step {what}: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%), rest (device idle) "
          f"{wall - busy:.2f} ms, {sum(c for _, c in by_name.values())} "
          f"device kernels; attention {attn_ms:.3f} ms, "
          f"{100 * attn_ms / busy:.2f}% of busy: "
          + ", ".join(f"{k} {t:.3f} ms" for k, t in flash.items())
          + f" [{smi}]", flush=True)
    for name, (t_us, c) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:10]:
        print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
              flush=True)


def bert_flash_train_phase(dev, smi: str, params) -> None:
    """BERT-L at amp O2 with FusedLAMB on the example's default unmasked
    8 x 512 batch and on a packed one (``--packed``), both through flash
    attention with gradients: warm-up steps, then timed steps with exact
    launch counts (24 flash forwards, dq and dk/dv a step); then one
    unmasked step under the profiler, with attention's share of busy
    time."""
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
        want = _bert_launches_expected(steps, len(opt._plan.buckets),
                                       flash=True)
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
        if not packed:
            _flash_step_profile(f"bert-large O2 FusedLAMB b{BERT['batch']} "
                                f"s{BERT['seq']} unmasked (flash)",
                                lambda: step(state, **inputs), smi)
        del opt, state, step, inputs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 5: the fused attention dropout of the six flash bodies, the
# attention modules in training, contrib.fmha, and what F5 repaired
# ---------------------------------------------------------------------------

DROP_RATE = 0.1     # GPT-2's attn_pdrop, BERT's attention_probs_dropout_prob
DROP_SEED = -123457
# the attention cases held with dropout (ATTN_CASES by name)
DROP_CASES = ("gpt2_block", "bert_large_unmasked", "bert_large_packed",
              "gqa_12_to_4_s200", "f32_gqa_s300", "d32_causal",
              "cross_sq130_sk70_causal")
# the keep mask read out of the kernels: name, b, h, sq, sk, d, causal,
# dtype (the tensor cores, the CUDA cores in f32 and the bf16 dq at D 32,
# the bf16 forward and dk/dv on the tensor cores there, the wide
# tensor-core forward, dq and dk/dv)
DROP_KEEP_CASES = (
    ("gpt2_block", 8, 12, 512, 512, 64, True, "bf16"),
    ("f32_s300", 2, 12, 300, 300, 64, True, "f32"),
    ("d32_sq130_sk70", 2, 8, 130, 70, 32, False, "bf16"),
    # the wide tensor-core bodies: two windows of keys, the forward's and
    # dk/dv's four column slices, dq's two
    ("d1024_bf16", 1, 2, 200, 1100, 1024, True, "bf16"),
)
# the path: 12 layers at GPT-2 small's widths; Transformer-big's decoder
# cross-attention (Vaswani et al. 2017: d_model 1024, 16 heads) at Tq
# 256, Tk 384; contrib.fmha at BERT-Large's heads over the BERT packed
# lengths; SelfMultiheadAttn(768, 8), whose heads are 96 wide (F5)
SMHA = dict(layers=12, hidden=768, heads=12, seq=512, batch=8, steps=2)
ENCDEC = dict(hidden=1024, heads=16, tq=256, tk=384, batch=16)
FMHA = dict(heads=16, head_dim=64)
D96 = dict(hidden=768, heads=8, seq=512, batch=8)
# the path's three flash calls held against the twins at exactly their
# shapes, the operands laid out as the module lays them out: name, b, h,
# sq, sk, d, causal, layout ("encdec": q of its own projection, k and v
# chunks of one 2E projection; "fmha": the (1, H, total, D) views of one
# (total, 3, H, D) buffer over the BERT packed sequences; "self": chunks
# of one 3E projection), all split into heads as strided views
DROP_PATH_CASES = (
    ("encdec_tq256_tk384", ENCDEC["batch"], ENCDEC["heads"], ENCDEC["tq"],
     ENCDEC["tk"], ENCDEC["hidden"] // ENCDEC["heads"], False, "encdec"),
    ("fmha_packed_4096", 1, FMHA["heads"], BERT["batch"] * BERT["seq"],
     BERT["batch"] * BERT["seq"], FMHA["head_dim"], False, "fmha"),
    ("smha_768_8_d96", D96["batch"], D96["heads"], D96["seq"], D96["seq"],
     D96["hidden"] // D96["heads"], True, "self"),
)
# card against CPU: a 2-layer f32 dropout stack; its limit, of each
# tensor's scale: two layers of f32 attention (the kernels within 1e-4 of
# their twins), LayerNorm and projections summed in each device's order
DROP_CONSIST = dict(layers=2, hidden=768, heads=12, seq=128, batch=2,
                    tol=1e-3)
# F5: what the card refused before (name, shape of q, k/v, dtype, q made
# transposed or 8 bytes off its alignment)
F5_CASES = (
    ("d8", (2, 3, 70, 8), (2, 3, 70, 8), "f32", None),
    ("d80", (2, 4, 130, 80), (2, 4, 130, 80), "bf16", None),
    ("d96", (2, 8, 256, 96), (2, 8, 256, 96), "bf16", None),
    ("transposed_q", (2, 4, 100, 64), (2, 4, 100, 64), "f32", "transposed"),
    ("q_8_bytes_off", (2, 4, 64, 64), (2, 4, 64, 64), "bf16", "offset"),
    ("bh_65600", (65600, 1, 16, 16), (65600, 1, 16, 16), "f32", None),
)


def keep_mask_readout(b, h, sq, sk, d, dt, causal, rate, seed, dev, side):
    """The (b, h, sq, sk) keep mask the kernels drew at ``rate`` and
    ``seed``, read window by window with q = 0 (every visible p is 1/n):
    ``side="fwd"``, V one-hot on a window of D keys, the output is
    nonzero there exactly where a pair is kept; ``side="dv"``, dO one-hot
    on a window of D query rows, dV[key, c] is nonzero exactly where
    (r0 + c, key) is kept; ``side="dq"``, K one-hot on a window of D keys,
    V's and dO's first columns ones (dP = 1) and O taken as zeros (di =
    0), so dS = p * keep * dP / (1 - rate) * scale and dQ[row, c] is
    nonzero exactly where (row, w0 + c) is kept.  Hidden pairs read 0.
    (The card tests of ``tests/torch_port/test_torch_port_cuda.py`` read
    the mask with this one too.)"""
    import torch
    from apex_tpu_torch.ops import attention as attn
    q = torch.zeros(b, h, sq, d, dtype=dt, device=dev)
    k = v = torch.zeros(b, h, sk, d, dtype=dt, device=dev)
    got = torch.zeros(b, h, sq, sk, dtype=torch.bool, device=dev)
    if side == "dq":
        lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True)[1]
        ones = torch.zeros_like(v)
        ones[..., 0] = 1
        do = torch.zeros_like(q)
        do[..., 0] = 1
        for w0 in range(0, sk, d):
            n = min(d, sk - w0)
            kw = torch.zeros_like(k)
            kw[:, :, w0:w0 + n, :n] = torch.eye(n, dtype=dt, device=dev)
            dq = attn._flash_bwd_cuda(q, kw, ones, torch.zeros_like(q), lse,
                                      do, causal, None, None, rate, seed)[0]
            got[..., w0:w0 + n] = dq[..., :n] != 0
        return got
    if side == "fwd":
        for w0 in range(0, sk, d):
            n = min(d, sk - w0)
            vw = torch.zeros_like(v)
            vw[:, :, w0:w0 + n, :n] = torch.eye(n, dtype=dt, device=dev)
            o = attn._flash_fwd_cuda(q, k, vw, causal, None, None, False,
                                     rate, seed)[0]
            got[..., w0:w0 + n] = o[..., :n] != 0
        return got
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True)
    for r0 in range(0, sq, d):
        n = min(d, sq - r0)
        do = torch.zeros_like(q)
        do[:, :, r0:r0 + n, :n] = torch.eye(n, dtype=dt, device=dev)
        dv = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, None,
                                  rate, seed)[2]
        got[:, :, r0:r0 + n, :] = (dv[..., :n] != 0).transpose(-1, -2)
    return got


def _fmha_buffer(dev):
    """(cu_seqlens int32 on ``dev``, total): the BERT packed batch's
    sequences (``bert_batches``' lengths) laid end to end in one buffer of
    BERT's batch x seq tokens, the tail past the last one padding."""
    import numpy as np
    import torch
    from apex_tpu_torch.data import pack_sequences
    rng = np.random.default_rng(1)
    seqlen = BERT["seq"]
    lens = rng.integers(seqlen // 4, seqlen, size=2 * BERT["batch"])
    pk = pack_sequences([rng.integers(1, 100, size=m) for m in lens],
                        max_len=seqlen)
    segs = pk["segment_ids"][:BERT["batch"]]
    kept = [int((r == s).sum()) for r in segs for s in np.unique(r[r > 0])]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(kept)]),
                      dtype=torch.int32, device=dev)
    return cu, BERT["batch"] * seqlen


def _path_operands(gen, b, h, sq, sk, d, layout, dev):
    """bf16 q, k, v, dO and the segment ids of one of DROP_PATH_CASES,
    laid out as its module lays them out (see there)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn._common import split_heads
    from apex_tpu_torch.ops.attention import packed_segment_ids

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    seg = None
    if layout == "fmha":
        cu, _ = _fmha_buffer(dev)
        qkv = randn(sq, 3, h, d)
        q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
        base = torch.zeros(1, sq, dtype=torch.int32, device=dev)
        for i in range(cu.numel() - 1):
            base[0, int(cu[i]):int(cu[i + 1])] = i + 1
        seg = packed_segment_ids(base)
    elif layout == "encdec":
        q = split_heads(randn(sq, b, h * d), h)
        k, v = (split_heads(t, h)
                for t in torch.chunk(randn(sk, b, 2 * h * d), 2, dim=-1))
    else:
        q, k, v = (split_heads(t, h)
                   for t in torch.chunk(randn(sq, b, 3 * h * d), 3, dim=-1))
    return q, k, v, randn(b, h, sq, d), seg


def _f5_inputs(gen, qshape, kshape, dt, kind, dev):
    import torch
    if kind == "transposed":
        b, h, s, d = qshape
        q = torch.randn(b, s, h, d, generator=gen, device=dev).transpose(1, 2)
    elif kind == "offset":
        n = math.prod(qshape)
        q = torch.randn(4 + n, generator=gen, device=dev).to(dt)[4:]
        q = q.view(qshape)
    else:
        q = torch.randn(qshape, generator=gen, device=dev)
    q = q.to(dt)
    k, v = (torch.randn(kshape, generator=gen, device=dev).to(dt)
            for _ in range(2))
    return q, k, v, torch.randn(qshape, generator=gen, device=dev).to(dt)


def dropout_kernel_phase(dev, smi: str) -> dict:
    """The dropout bodies of the forward with lse and the dq, dk/dv
    kernels against their twins at the same seed (ATTN_TOL) at the
    DROP_CASES shapes: exact zeros on rows that see no key, the same bits
    twice, the route of each read from the device kernels' names (the
    DROP=true bodies); the same through ``flash_attention`` at the
    shapes and layouts of the path's three other calls (DROP_PATH_CASES);
    the
    keep mask read out of the forward and of dk/dv, bit for bit against
    ``dropout_keep_ref``, and another seed's mask with its keep fraction;
    the F5 inputs with gradients against the twins; then each dropout
    body timed at GPT's and BERT-L's shapes beside the same body at rate
    0 (in turns), the twin, SDPA with ``dropout_p`` and the bound.
    Returns {kernel: its dropout figures at GPT's shape}."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.ops import attention as attn

    gen = torch.Generator(device=dev).manual_seed(8)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    kern = {"flash_fwd": attn.FLASH_FWD, "flash_dq": attn.FLASH_DQ,
            "flash_dkv": attn.FLASH_DKV}
    worst = dict.fromkeys(kern, 0.0)
    cases = {c[0]: c for c in ATTN_CASES}
    case_launches = []
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _prime_profiler()
    for cname in DROP_CASES:
        name, b, h, hk, sq, sk, d, causal, kind, dtn = cases[cname]
        before = {kn: kt.launches for kn, kt in kern.items()}
        dt = _dtype(dtn)
        q, k, v, do = (torch.randn(b, n, length, d, generator=gen,
                                   device=dev).to(dt)
                       for n, length in ((h, sq), (hk, sk), (hk, sk),
                                         (h, sq)))
        seg = _case_ids(kind, b, sq, dev)
        fwd = lambda: attn._flash_fwd_cuda(q, k, v, causal, None, seg, True,
                                           DROP_RATE, seed)
        o, lse = fwd()
        grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg,
                                     DROP_RATE, seed)
        torch.cuda.synchronize()
        wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, seg, DROP_RATE,
                                      seed)
        wgrads = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, seg,
                                    DROP_RATE, seed)
        atol, rtol = ATTN_TOL[dtn]
        what = (f"{name} q={tuple(q.shape)} k={tuple(k.shape)} {dtn} "
                f"dropout {DROP_RATE}")
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
        again_o, again_lse = fwd()
        again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg,
                                     DROP_RATE, seed)
        _check(bool(torch.equal(again_o, o) and torch.equal(again_lse, lse)
                    and all(torch.equal(a, g) for a, g in zip(again, grads))),
               f"flash attention {what}: the result differs run to run")
        case_launches.append(
            (name, {kn: kt.launches - before[kn] for kn, kt in kern.items()}))
        worst["flash_fwd"] = max(worst["flash_fwd"], errs[0])
        worst["flash_dq"] = max(worst["flash_dq"], errs[2])
        worst["flash_dkv"] = max(worst["flash_dkv"], *errs[3:])
        print(f"kernel flash dropout {what} causal={causal} seg={kind}: "
              f"max_abs_err o {errs[0]:.3e}, lse {errs[1]:.3e}, dq "
              f"{errs[2]:.3e}, dk {errs[3]:.3e}, dv {errs[4]:.3e} (atol="
              f"{atol}, rtol={rtol}); exact zeros where nothing is seen; "
              "the same bits on a second run", flush=True)
        del q, k, v, do, o, lse, grads, wo, wlse, wgrads, again
    for name, b, h, sq, sk, d, causal, layout in DROP_PATH_CASES:
        q, k, v, do, seg = _path_operands(gen, b, h, sq, sk, d, layout, dev)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        before = {kn: kt.launches for kn, kt in kern.items()}
        with torch.enable_grad():
            o = attn.flash_attention(qq, kk, vv, causal=causal,
                                     segment_ids=seg, dropout_rate=DROP_RATE,
                                     dropout_seed=seed)
            o.backward(do)
        torch.cuda.synchronize()
        case_launches.append(
            (name, {kn: kt.launches - before[kn] for kn, kt in kern.items()}))
        wo, lse = attn.flash_fwd_ref(q, k, v, causal, None, seg, DROP_RATE,
                                     seed)
        want = (wo,) + attn.flash_bwd_ref(q, k, v, o.detach(), lse, do,
                                          causal, None, seg, DROP_RATE, seed)
        del lse
        atol, rtol = ATTN_TOL["bf16"]
        what = (f"path shape {name} q={tuple(q.shape)} k={tuple(k.shape)} "
                f"bf16 dropout {DROP_RATE}")
        errs = [_held(kn, a, w, atol, rtol, f"{gn} {what}")
                for kn, gn, a, w in zip(
                    ("flash_fwd", "flash_dq", "flash_dkv", "flash_dkv"),
                    ("o", "dq", "dk", "dv"),
                    (o.detach(), qq.grad, kk.grad, vv.grad), want)]
        worst["flash_fwd"] = max(worst["flash_fwd"], errs[0])
        worst["flash_dq"] = max(worst["flash_dq"], errs[1])
        worst["flash_dkv"] = max(worst["flash_dkv"], *errs[2:])
        print(f"kernel flash dropout {what} causal={causal} ({layout}'s "
              f"strided operands{', packed segment ids' if seg else ''}): "
              "o, dq, dk, dv max_abs_err "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f" (atol={atol}, rtol={rtol})", flush=True)
        del q, k, v, do, qq, kk, vv, o, want
    torch.cuda.synchronize()
    prof.stop()
    case_routes = _flash_routes(prof, case_launches, drop=True)
    del prof
    for name, b, h, sq, sk, d, causal, _ in DROP_PATH_CASES:
        routes = case_routes[name]
        _check(set(routes.values()) == {"tensor cores"},
               f"{name} dropout: routes {routes}, expected tensor cores")
        print(f"route dropout {name} bf16 D {d} (kernel width "
              f"{attn._kernel_width(d)}): "
              + ", ".join(f"{kn} {r}" for kn, r in routes.items()),
              flush=True)
    for cname in DROP_CASES:
        name, b, h, hk, sq, sk, d, causal, kind, dtn = cases[cname]
        routes = case_routes[name]
        want = _flash_route_of(d, dtn)
        _check(routes == want,
               f"{name} dropout: routes {routes}, expected {want}")
        print(f"route dropout {name} {dtn} D {d}: "
              + ", ".join(f"{kn} {r}" for kn, r in routes.items()),
              flush=True)

    for name, b, h, sq, sk, d, causal, dtn in DROP_KEEP_CASES:
        dt = _dtype(dtn)
        vis = _visible(None, sq, sk, causal, dev)[:, None]
        want = attn.dropout_keep_ref(seed, b, h, sq, sk, DROP_RATE) & vis
        fwd, dv, dq = (keep_mask_readout(b, h, sq, sk, d, dt, causal,
                                         DROP_RATE, seed, dev, side)
                       for side in ("fwd", "dv", "dq"))
        _check(bool(torch.equal(fwd, want)), f"keep mask {name}: the "
               f"forward dropped {int((fwd != want).sum())} pairs other "
               "than dropout_keep_ref's")
        _check(bool(torch.equal(dv, want)), f"keep mask {name}: dk/dv "
               f"dropped {int((dv != want).sum())} pairs other than "
               "dropout_keep_ref's")
        _check(bool(torch.equal(dq, want)), f"keep mask {name}: dq "
               f"dropped {int((dq != want).sum())} pairs other than "
               "dropout_keep_ref's")
        other = keep_mask_readout(b, h, sq, sk, d, dt, causal, DROP_RATE,
                                  seed + 1, dev, "fwd")
        n_vis = float(vis.sum()) * b * h
        kept = float(other.sum()) / n_vis
        _check(not torch.equal(other, fwd) and abs(kept - (1 - DROP_RATE))
               < 0.01, f"keep mask {name}: another seed kept {kept:.5f} of "
               f"the visible pairs (want {1 - DROP_RATE} +- 0.01) or the "
               "same mask")
        print(f"keep mask {name} ({b}, {h}, {sq}, {sk}) D {d} {dtn} causal="
              f"{causal}: the forward's, dq's and dk/dv's masks equal "
              f"dropout_keep_ref bit for bit ({int(want.sum())} of "
              f"{int(n_vis)} visible pairs kept, "
              f"{float(want.sum()) / n_vis:.5f}); seed + 1: another mask, "
              f"{kept:.5f} kept", flush=True)
        del want, fwd, dv, dq, other

    for name, qshape, kshape, dtn, kind in F5_CASES:
        dt = _dtype(dtn)
        q, k, v, do = _f5_inputs(gen, qshape, kshape, dt, kind, dev)
        rate = DROP_RATE if dtn == "bf16" else 0.0
        sd = DROP_SEED if rate else None
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        before = {kn: kt.launches for kn, kt in kern.items()}
        with torch.enable_grad():
            o = attn.flash_attention(qq, kk, vv, causal=True,
                                     dropout_rate=rate, dropout_seed=sd)
            o.backward(do)
        torch.cuda.synchronize()
        _check(all(kt.launches - before[kn] == 1 for kn, kt in kern.items()),
               f"F5 {name}: the kernels did not launch once each")
        wo, lse = attn.flash_fwd_ref(q, k, v, True, None, None, rate, sd)
        want = (wo,) + attn.flash_bwd_ref(q, k, v, o.detach(), lse, do, True,
                                          None, None, rate, sd)
        atol, rtol = ATTN_TOL[dtn]
        errs = [_held("flash", a, w, atol, rtol, f"F5 {name} {gn}")
                for gn, a, w in zip(("o", "dq", "dk", "dv"),
                                    (o.detach(), qq.grad, kk.grad, vv.grad),
                                    want)]
        print(f"F5 {name} q={tuple(q.shape)} (contiguous "
              f"{q.is_contiguous()}, start mod 16 {q.data_ptr() % 16}) "
              f"{dtn} causal dropout {rate}: o, dq, dk, dv max_abs_err "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f" (atol={atol}, rtol={rtol})", flush=True)
        del q, k, v, do, qq, kk, vv, o, want

    rows = {}
    for cname in ("gpt2_block", "bert_large_unmasked"):
        name, b, h, hk, s, _, d, causal, _, dtn = cases[cname]
        q, k, v, do = (torch.randn(b, n, s, d, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for n in (h, hk, hk, h))
        o0, lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True)
        od, _ = attn._flash_fwd_cuda(q, k, v, causal, None, None, True,
                                     DROP_RATE, seed)
        dq0, dkv0 = _bwd_kernel_calls(q, k, v, o0, lse, do, causal, None)
        dqd, dkvd = _bwd_kernel_calls(q, k, v, od, lse, do, causal, None,
                                      DROP_RATE, seed)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qq, kk, vv,
                                                 is_causal=causal,
                                                 dropout_p=DROP_RATE)
        bwd_plain = lambda: attn.flash_bwd_ref(q, k, v, od, lse, do, causal,
                                               None, None, DROP_RATE, seed)
        bwd_lib = lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                              retain_graph=True)
        times = {
            "flash_fwd": (
                lambda: attn._flash_fwd_cuda(q, k, v, causal, None, None,
                                             True, DROP_RATE, seed),
                lambda: attn._flash_fwd_cuda(q, k, v, causal, None, None,
                                             True),
                lambda: attn.flash_fwd_ref(q, k, v, causal, None, None,
                                           DROP_RATE, seed),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, dropout_p=DROP_RATE),
                "SDPA forward, dropout_p 0.1"),
            "flash_dq": (dqd, dq0, bwd_plain, bwd_lib,
                         "SDPA backward with dropout_p 0.1: dq, dk and dv "
                         "in one call; plain: flash_bwd_ref, all three"),
            "flash_dkv": (dkvd, dkv0, bwd_plain, bwd_lib,
                          "SDPA backward with dropout_p 0.1: dq, dk and dv "
                          "in one call; plain: flash_bwd_ref, all three"),
        }
        pairs = _pairs(None, b, h, s, causal, dev)
        costs = _attn_costs(b, h, hk, s, d, 2, pairs)
        for kname, (drop, zero, plain, lib, note) in times.items():
            # in turns: rate 0, dropout, dropout, rate 0
            z1, d1, d2, z2 = (_ms(f, iters=10, warmup=2)
                              for f in (zero, drop, drop, zero))
            ms, zero_ms = (d1 + d2) / 2, (z1 + z2) / 2
            plain_ms = _ms(plain, iters=3, warmup=1)
            lib_ms = _ms(lib, iters=10, warmup=2)
            nbytes, ops = costs[kname]
            bound_ms, bound_by = _bound(nbytes, ops, BF16_PEAK)
            print(f"time {kname} dropout {DROP_RATE} {name} q="
                  f"{tuple(q.shape)} bf16 causal={causal}: kernel {ms:.4f} "
                  f"ms ({d1:.4f}, {d2:.4f}), the same body at rate 0 "
                  f"{zero_ms:.4f} ms ({z1:.4f}, {z2:.4f}; dropout "
                  f"{ms / zero_ms:.2f}x), plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms ({note}; kernel {ms / lib_ms:.2f}x), "
                  f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
                  f"{ops:.4e} FLOP at the bf16 rate; the hash's ~10 integer "
                  f"operations a pair, {10 * pairs:.3e} here, not counted), "
                  f"{100 * bound_ms / ms:.2f}% of the bound [{smi}]",
                  flush=True)
            if name == "gpt2_block":
                rows[kname] = dict(
                    rate=DROP_RATE, ms=ms, rate0_ms=zero_ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=worst[kname],
                    atol=ATTN_TOL["bf16"][0], rtol=ATTN_TOL["bf16"][1],
                    shape="(8, 12, 512, 64) bf16 causal",
                    body=case_routes[name][kname])
        del q, k, v, do, o0, od, lse, qq, kk, vv, out
    return rows


def _path_counts(fn, what: str, want: dict):
    """``fn()`` with every launch count set to 0 just before it; checks
    the counts read just after against ``want`` (kernels not named: 0)."""
    import torch
    from apex_tpu_torch import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in _build.KERNELS if k.launches}
    _check(got == want, f"{what}: launches {got}, expected {want}")
    return out, got


def dropout_path_phase(dev, smi: str) -> dict:
    """The slice's modules in training at full width, bf16, dropout 0.1,
    forward and backward, each with its launches counted from 0: 12
    ``SelfMultiheadAttn(768, 12, bias, norm-add)`` layers at GPT-2
    small's T 512, B 8, causal, seeds drawn from a card generator; an
    ``EncdecMultiheadAttn(1024, 16)`` at Tq 256, Tk 384, B 16 on each of
    its three branches (flash; the key-padding mask; need_weights);
    ``fmha_packed`` over the 4,096-token BERT packed buffer at H 16, D
    64; ``SelfMultiheadAttn(768, 8)`` (D 96, padded to 128).  Finite
    losses and exact launch counts (the kernels are held against their
    twins at these calls' shapes in ``dropout_kernel_phase``,
    DROP_PATH_CASES); returns the flash launches of the 12-layer stack's
    run."""
    import numpy as np
    import torch
    from apex_tpu_torch.contrib.fmha import fmha_packed
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)

    bf16 = torch.bfloat16
    dgen = torch.Generator(device=dev).manual_seed(11)
    gen = torch.Generator(device=dev).manual_seed(12)

    def leaves(params):
        return [t for p in params for sub in p.values() for t in sub.values()]

    def step(layers, x, w, **kw):
        """Forward and backward of ``layers`` [(module, params)] on x."""
        h, probs = x, None
        for mod, p in layers:
            h, probs = mod(p, h, generator=dgen, **kw)
        loss = (h.float() * w).mean()
        grads = torch.autograd.grad(loss, [x] + leaves(
            [p for _, p in layers]))
        return loss.detach(), grads, probs

    def finite(loss, grads, what):
        _check(math.isfinite(float(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads),
            f"{what}: a non-finite loss or gradient")

    E, L = SMHA["hidden"], SMHA["layers"]
    mha = SelfMultiheadAttn(E, SMHA["heads"], dropout=DROP_RATE, bias=True,
                            include_norm_add=True)
    init = torch.Generator().manual_seed(0)
    params = [{n: {k: t.requires_grad_() for k, t in sub.items()}
               for n, sub in mha.init(init, dev).items()} for _ in range(L)]
    layers = [(mha, p) for p in params]
    x = torch.randn(SMHA["seq"], SMHA["batch"], E, generator=gen,
                    device=dev).to(bf16).requires_grad_()
    w = torch.randn(x.shape, generator=gen, device=dev)
    step(layers, x, w, attn_mask="causal")           # warm-up
    n = SMHA["steps"]
    per = {"flash_fwd": L, "flash_dq": L, "flash_dkv": L,
           "layer_norm_fwd": L, "layer_norm_bwd": L}
    t0 = time.perf_counter()
    (losses, counts) = _path_counts(
        lambda: [step(layers, x, w, attn_mask="causal")[0]
                 for _ in range(n)],
        f"{L} x SelfMultiheadAttn dropout {DROP_RATE}",
        {k: n * c for k, c in per.items()})
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    _check(all(math.isfinite(v) for v in losses) and losses[0] != losses[1],
           f"SelfMultiheadAttn stack: losses {losses} (non-finite, or the "
           "same bits under two dropout seeds)")
    print(f"path {L} x SelfMultiheadAttn({E}, {SMHA['heads']}, dropout="
          f"{DROP_RATE}, bias, norm-add) T {SMHA['seq']} B "
          f"{SMHA['batch']} bf16 causal, training: {n} forward + backward "
          f"steps in {1e3 * wall / n:.2f} ms/step (host clock), losses "
          f"{[round(v, 6) for v in losses]}, launches {counts} [{smi}]",
          flush=True)
    del params, layers, x, w

    enc = EncdecMultiheadAttn(ENCDEC["hidden"], ENCDEC["heads"],
                              dropout=DROP_RATE)
    ep = {n: {k: t.requires_grad_() for k, t in sub.items()}
          for n, sub in enc.init(init, dev).items()}
    b, tq, tk, e = ENCDEC["batch"], ENCDEC["tq"], ENCDEC["tk"], \
        ENCDEC["hidden"]
    qx = torch.randn(tq, b, e, generator=gen, device=dev).to(bf16) \
        .requires_grad_()
    mem = torch.randn(tk, b, e, generator=gen, device=dev).to(bf16)
    w = torch.randn(tq, b, e, generator=gen, device=dev)
    lengths = np.random.default_rng(1).integers(tk // 4, tk + 1, size=b)
    kpm = (torch.arange(tk, device=dev)[None, :]
           >= torch.as_tensor(lengths, device=dev)[:, None])
    flash = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    for branch, kw, want in (("flash", {}, flash),
                             ("key-padding mask",
                              dict(key_padding_mask=kpm), {}),
                             ("need_weights", dict(need_weights=True), {})):
        (loss, grads, probs), _ = _path_counts(
            lambda: step([(lambda p, h, **k: enc(p, h, mem, **k), ep)], qx,
                         w, **kw),
            f"EncdecMultiheadAttn {branch}", want)
        finite(loss, grads, f"EncdecMultiheadAttn {branch}")
        if branch == "need_weights":
            _check(tuple(probs.shape) == (b, ENCDEC["heads"], tq, tk),
                   f"EncdecMultiheadAttn probs {tuple(probs.shape)}")
        print(f"path EncdecMultiheadAttn({e}, {ENCDEC['heads']}, dropout="
              f"{DROP_RATE}) Tq {tq} Tk {tk} B {b} bf16, {branch}: loss "
              f"{float(loss):.6f}, launches {want or 'none (plain path)'}",
              flush=True)
    del ep, qx, mem, w, grads

    cu, total = _fmha_buffer(dev)
    hh, dd = FMHA["heads"], FMHA["head_dim"]
    qkv = torch.randn(total, 3, hh, dd, generator=gen, device=dev).to(bf16) \
        .requires_grad_()
    wo = torch.randn(total, hh, dd, generator=gen, device=dev)

    def fmha_step():
        out = fmha_packed(qkv, cu, DROP_RATE, generator=dgen)
        loss = (out.float() * wo).mean()
        return out.detach(), loss.detach(), torch.autograd.grad(loss, qkv)[0]

    (out, loss, g), _ = _path_counts(fmha_step, "fmha_packed", flash)
    end = int(cu[-1])
    _check(math.isfinite(float(loss)) and bool(torch.all(out[end:] == 0))
           and bool(torch.all(g[end:] == 0)) and bool(
               torch.isfinite(g).all()),
           "fmha_packed: a non-finite loss, or the tail past cu_seqlens[-1] "
           "not exact zeros")
    print(f"path fmha_packed qkv ({total}, 3, {hh}, {dd}) bf16, "
          f"{cu.numel() - 1} sequences, {end} real tokens, p_dropout "
          f"{DROP_RATE}: loss {float(loss):.6f}, the {total - end}-token "
          f"tail exact zeros (output and grad), launches {flash}",
          flush=True)
    del qkv, wo, out, g

    m96 = SelfMultiheadAttn(D96["hidden"], D96["heads"], dropout=DROP_RATE)
    p96 = {n: {k: t.requires_grad_() for k, t in sub.items()}
           for n, sub in m96.init(init, dev).items()}
    x = torch.randn(D96["seq"], D96["batch"], D96["hidden"], generator=gen,
                    device=dev).to(bf16).requires_grad_()
    w = torch.randn(x.shape, generator=gen, device=dev)
    (loss, grads, _), _ = _path_counts(
        lambda: step([(m96, p96)], x, w, attn_mask="causal"),
        "SelfMultiheadAttn(768, 8)", flash)
    finite(loss, grads, "SelfMultiheadAttn(768, 8)")
    print(f"path SelfMultiheadAttn({D96['hidden']}, {D96['heads']}) (head "
          f"dim 96, padded to 128: F5) T {D96['seq']} B {D96['batch']} "
          f"bf16 causal dropout {DROP_RATE}: loss {float(loss):.6f}, "
          f"launches {flash}", flush=True)
    return counts


# F5b: head dims past 128.  SelfMultiheadAttn(1024, 4) (Transformer-big's
# width in four heads, D 256; the same D as Gemma-class heads) trained
# at T 512, B 8, bf16, causal, dropout 0.1 and 0; the kernels held
# against the twins at its shape and at f32, at D 512 and at padded D
# 160 and 200 (name, b, h, s, d, dtype, dropout rate)
WIDE = dict(hidden=1024, heads=4, seq=512, batch=8, steps=2)
# F5c: SelfMultiheadAttn(2048, 2), head dim 1024, the wide bodies
WIDE_1024 = dict(WIDE, hidden=2048, heads=2)
# SelfMultiheadAttn(2048, 4), head dim 512: bf16 on the wide tensor-core
# bodies, timed (beside the D-512 CUDA-core bodies) and trained
WIDE_512 = dict(WIDE, hidden=2048, heads=4)
WIDE_CASES = (
    ("smha_1024_4", WIDE["batch"], WIDE["heads"], WIDE["seq"], 256, "bf16",
     DROP_RATE),
    ("smha_1024_4_rate0", WIDE["batch"], WIDE["heads"], WIDE["seq"], 256,
     "bf16", 0.0),
    ("d256_f32_s300", 2, 4, 300, 256, "f32", DROP_RATE),
    ("d256_f32_s300_rate0", 2, 4, 300, 256, "f32", 0.0),
    ("d160_bf16_s200", 2, 4, 200, 160, "bf16", DROP_RATE),
    ("d200_bf16_s190_rate0", 2, 2, 190, 200, "bf16", 0.0),
    ("d512_bf16_s300", 2, 2, 300, 512, "bf16", DROP_RATE),
    ("d512_f32_s130_rate0", 1, 2, 130, 512, "f32", 0.0),
    # the f32 forward and dk/dv at 256 and 512 in register tiles, one CTA
    # on a whole row (D 320 padded to 512)
    ("d512_f32_s300", 2, 2, 300, 512, "f32", DROP_RATE),
    ("d320_f32_s200_rate0", 2, 2, 200, 320, "f32", 0.0),
    # F5c: the wide bodies at D 1024 and at D 640 (padded to 1024)
    ("d640_f32", 4, 2, 512, 640, "f32", DROP_RATE),
    ("d640_f32_rate0", 4, 2, 512, 640, "f32", 0.0),
    ("d640_bf16", 4, 2, 512, 640, "bf16", DROP_RATE),
    ("d640_bf16_rate0", 4, 2, 512, 640, "bf16", 0.0),
    ("d1024_f32", 4, 2, 512, 1024, "f32", DROP_RATE),
    ("d1024_f32_rate0", 4, 2, 512, 1024, "f32", 0.0),
    # (at the batch they are timed at)
    ("d1024_bf16", WIDE_1024["batch"], 2, 512, 1024, "bf16", DROP_RATE),
    ("d1024_bf16_rate0", WIDE_1024["batch"], 2, 512, 1024, "bf16", 0.0),
    # F7: past 8192, padded to the next multiple of 8192 (8200 -> 16384)
    ("d8200_f32", 1, 2, 96, 8200, "f32", DROP_RATE),
    ("d8200_f32_rate0", 1, 2, 96, 8200, "f32", 0.0),
    ("d8200_bf16", 1, 2, 96, 8200, "bf16", DROP_RATE),
    ("d8200_bf16_rate0", 1, 2, 96, 8200, "bf16", 0.0),
    ("d16384_f32", 1, 2, 70, 16384, "f32", DROP_RATE),
    ("d16384_f32_rate0", 1, 2, 70, 16384, "f32", 0.0),
    ("d16384_bf16", 1, 2, 70, 16384, "bf16", DROP_RATE),
    ("d16384_bf16_rate0", 1, 2, 70, 16384, "bf16", 0.0),
)


def _flash_route_of(d: int, dt: str) -> dict:
    """{kernel: route} of the three flash kernels at head dim ``d``
    (before padding) and dtype name ``dt``: ``ops.attention.flash_route``,
    the one rule the wrappers and the on-card tests read too."""
    from apex_tpu_torch.ops import attention as attn
    return {kn: attn.flash_route(kn, _dtype(dt), d) for kn in FLASH_SYMS}


def wide_head_phase(dev, smi: str) -> dict:
    """F5b, F5c and F7: flash at head dims past 128: bf16 at 256 (and
    160, 200 padded to it) on the tensor-core forward, dq and dk/dv; f32
    at 256 and 512 (320 padded to it) with the forward, dq and dk/dv in
    register tiles, one CTA on a whole row; bf16 at 512 and from 1024 (D 640 padded to it; past 8192 the next multiple
    of 8192, F7) on the wide tensor-core bodies, f32 from 1024 on the
    wide CUDA-core bodies (register tiles, the column slices of a row
    block a thread-block cluster sharing the scores: 1024 of O's and dQ's
    columns a CTA, 512 of dK's and dV's up to D 4096).  Each WIDE_CASES
    case causal, forward with lse, dq and dk/dv against the twins
    (ATTN_TOL), the same bits twice, each body's route and DROP
    instantiation read from the device kernels' names; then, for
    ``SelfMultiheadAttn(1024, 4)`` (D
    256), ``(2048, 4)`` (D 512) and ``(2048, 2)`` (D 1024), the three
    bodies timed at the module's (8, heads, 512, D) bf16 causal shape,
    rate 0 and 0.1, beside the twin, SDPA and the bound (at D 512 the
    wide tensor-core dq and dk/dv also beside the CUDA-core bodies in
    turns), and f32 at that shape beside SDPA's f32 (at D 256 and 512 the
    register-tile forward, dq and dk/dv beside their CUDA-core bodies in
    turns); the f32 forward, dq and dk/dv at GPT-2's and Llama's head
    dims (``F32_NARROW_SHAPES``; register tiles, beside their CUDA-core
    bodies in turns) beside SDPA's f32; the f32 forward, dq and dk/dv
    (register tiles, in turns with their CUDA-core bodies) at D 16 and 32
    and the BERT proxy's unmasked shape (``F32_NARROWEST_SHAPES``) beside
    SDPA's f32; the forward, dq and dk/dv at D 640 beside SDPA
    (``_d640_times``); each
    module trained 2 steps at each rate (forward, backward, an SGD update
    of its params), finite losses, exact launch counts and the routes of a
    profiled step; the bf16 forward, dq and dk/dv at D 2048, 4096 and
    8192 held and timed (``_wide_widths``), and the f32 ones there
    (``_f32_widths``); the ptxas registers and spills of the D-256
    and wide tensor-core bodies and of every f32 register-tile forward,
    dq and dk/dv.  Returns {kernel: {"d256": its D-256 figures, "d512": ...,
    "d1024": ...}}, and each kernel's f32 "d32_f32" and
    "d32_proxy_f32"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn

    # reports loaded by phase 16: the D-256 forward, dq and dk/dv and the
    # wide forward, dq and dk/dv, each at rate 0 and with DROP
    wide_ptxas = {}
    for lib, kind, marker, n in (("flash_fwd", "D-256", "ILi256E", 2),
                                 ("flash_bwd", "D-256", "ILi256E", 4),
                                 ("flash_fwd", "wide", "_tc_wide", 2),
                                 ("flash_bwd", "wide", "_tc_wide", 4)):
        found = [r for r in _ptxas_report(_build.build_logs.get(lib, ""),
                                          "_tc") if marker in r[0]]
        _check(len(found) == n, f"ptxas reported {len(found)} {kind} "
               f"tensor-core bodies in {lib}, expected {n} (rate 0, DROP)")
        for entry, regs, spill in found:
            print(f"ptxas {kind} tensor-core body {entry}: {regs}; {spill} "
                  f"[{smi}]", flush=True)
            if kind == "wide":
                kn = next(k for k, sym in FLASH_SYMS.items()
                          if sym + "_tc_wide" in entry)
                wide_ptxas.setdefault(kn, []).append(
                    f"{entry}: {regs}; {spill}")

    # the f32 register-tile forward, dq and dk/dv (the wide CUDA-core
    # bodies), rate 0 and DROP: their registers and spills, every one at
    # "d1024" and those of D 256 and 512 there too (the forward's and
    # dq's W 256 and 512; dk/dv's key rows a CTA and W, 64 x 256 at D 256
    # and 32 x 512 from D 512, and 16 x 1024 past D 4096); the forward's,
    # dq's and dk/dv's at 16, 32, 64 and 128 (W 16..128, 64 key rows) are
    # printed, the forward's and dq's at 16 and 32 and dk/dv's at 32 with
    # no spills (dk/dv's three CTAs at 16 spill 24 bytes, by choice)
    f32_ptxas = {}
    widths = {"flash_fwd": {"d256": "IfLi256E", "d512": "IfLi512E"},
              "flash_dq": {"d256": "IfLi256E", "d512": "IfLi512E"},
              "flash_dkv": {"d256": "IfLi64ELi256E", "d512": "IfLi32ELi512E"}}
    for lib, kn in (("flash_fwd", "flash_fwd"), ("flash_bwd", "flash_dq"),
                    ("flash_bwd", "flash_dkv")):
        found = _ptxas_report(_build.build_logs.get(lib, ""),
                              FLASH_SYMS[kn] + "_wideIf")
        # each geometry at rate 0 and DROP: the forward's and dq's W 16,
        # 32, 64, 128, 256, 512 and 1024, dk/dv's 64 x 16, 64 x 32, 64 x
        # 64, 64 x 128, 64 x 256, 32 x 512 and 16 x 1024
        want = 14
        _check(len(found) == want, f"ptxas reported {len(found)} f32 wide "
               f"{kn} bodies in {lib}, expected {want}")
        for entry, regs, spill in found:
            print(f"ptxas f32 wide {kn} body {entry}: {regs}; {spill} "
                  f"[{smi}]", flush=True)
            if (kn != "flash_dkv" and ("IfLi16E" in entry
                                       or "IfLi32E" in entry)) \
                    or (kn == "flash_dkv" and "IfLi64ELi32E" in entry):
                _check(spill is not None and "0 bytes spill stores" in spill
                       and "0 bytes spill loads" in spill,
                       f"ptxas reports spills for {entry}: {spill}")
            line = f"{entry}: {regs}; {spill}"
            f32_ptxas.setdefault((kn, "d1024"), []).append(line)
            for key, marker in widths[kn].items():
                if FLASH_SYMS[kn] + "_wide" + marker in entry:
                    f32_ptxas.setdefault((kn, key), []).append(line)

    gen = torch.Generator(device=dev).manual_seed(13)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    kern = {"flash_fwd": attn.FLASH_FWD, "flash_dq": attn.FLASH_DQ,
            "flash_dkv": attn.FLASH_DKV}
    wide_s = {"cases": 0.0}
    for drop in (True, False):
        case_launches = []
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        _prime_profiler()
        for name, b, h, s, d, dtn, rate in WIDE_CASES:
            if (rate > 0) != drop:
                continue
            t_case = time.perf_counter()
            dt = _dtype(dtn)
            q, k, v, do = (torch.randn(b, h, s, d, generator=gen,
                                       device=dev).to(dt) for _ in range(4))
            before = {kn: kt.launches for kn, kt in kern.items()}
            o, lse = attn._flash_fwd_cuda(q, k, v, True, None, None, True,
                                          rate, seed)
            grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None,
                                         None, rate, seed)
            torch.cuda.synchronize()
            wo, wlse = attn.flash_fwd_ref(q, k, v, True, None, None, rate,
                                          seed)
            wgrads = attn.flash_bwd_ref(q, k, v, o, lse, do, True, None,
                                        None, rate, seed)
            atol, rtol = ATTN_TOL[dtn]
            what = f"{name} {tuple(q.shape)} {dtn} causal dropout {rate}"
            errs = [_held("flash_fwd", o, wo, atol, rtol, "o " + what),
                    _held("flash_fwd", lse, wlse, 1e-4, 1e-5, "lse " + what)]
            errs += [_held(kn, g, w, atol, rtol, f"{gn} {what}")
                     for kn, gn, g, w in zip(
                         ("flash_dq", "flash_dkv", "flash_dkv"),
                         ("dq", "dk", "dv"), grads, wgrads)]
            again = attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None,
                                         None, rate, seed)
            torch.cuda.synchronize()
            case_launches.append((name, {kn: kt.launches - before[kn]
                                         for kn, kt in kern.items()}))
            _check(all(torch.equal(a, g) for a, g in zip(again, grads)),
                   f"flash {what}: the gradients differ run to run")
            print(f"kernel flash wide head {what}: max_abs_err o "
                  f"{errs[0]:.3e}, lse {errs[1]:.3e}, dq {errs[2]:.3e}, dk "
                  f"{errs[3]:.3e}, dv {errs[4]:.3e} (atol={atol}, rtol="
                  f"{rtol}); the same bits on a second run", flush=True)
            del q, k, v, do, o, lse, grads, wo, wlse, wgrads, again
            if d > 512:
                wide_s["cases"] += time.perf_counter() - t_case
        torch.cuda.synchronize()
        prof.stop()
        routes = _flash_routes(prof, case_launches, drop=drop)
        for name, _, _, _, d, dtn, rate in WIDE_CASES:
            if (rate > 0) == drop:
                want = _flash_route_of(d, dtn)
                _check(routes[name] == want,
                       f"wide heads {name}: routes {routes[name]}, expected "
                       f"{want}")
        print(f"route flash wide heads (DROP={str(drop).lower()}): " + "; "
              .join(f"{c} {r}" for c, r in routes.items()), flush=True)
        del prof

    rows = {}
    for key, mod_cfg in (("d256", WIDE), ("d512", WIDE_512),
                         ("d1024", WIDE_1024)):
        t0 = time.perf_counter()
        for kn, row in _wide_times(dev, smi, gen, seed, mod_cfg).items():
            rows.setdefault(kn, {})[key] = row
        t1 = time.perf_counter()
        _wide_module_steps(dev, smi, gen, mod_cfg)
        torch.cuda.empty_cache()
        if key != "d256":
            wide_s[f"times {key}"] = t1 - t0
            wide_s[f"module steps {key}"] = time.perf_counter() - t1
    for kn, lines in wide_ptxas.items():
        if kn in rows:
            rows[kn]["d1024"]["ptxas"] = lines
    for (kn, key), lines in f32_ptxas.items():
        rows[kn][key]["ptxas_f32"] = lines
    t0 = time.perf_counter()
    _wide_widths(dev, smi, gen, seed)
    wide_s["widths"] = time.perf_counter() - t0
    wide_s.update(_f32_widths(dev, smi, gen, seed, WIDE_FWD_SHAPES,
                              "widths"))
    wide_s.update(_f32_widths(dev, smi, gen, seed, F32_NARROW_SHAPES,
                              "D 64 and 128"))
    wide_s.update(_f32_widths(dev, smi, gen, seed, F32_NARROWEST_SHAPES,
                              "D 16 and 32", rows))
    t0 = time.perf_counter()
    _d640_times(dev, smi, gen)
    wide_s["D 640"] = time.perf_counter() - t0
    print("phase seconds 34, its D-512, F5c and F7 part (D 512 to 16384): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in wide_s.items())
          + f", together {sum(wide_s.values()):.1f} s", flush=True)
    return rows


def _in_turns(calls: dict, iters: int = 10) -> dict:
    """{name: [ms, ms]}: each call timed twice by ``_ms``, in the order
    a, b, b, a (a call's two turns bracket the other's)."""
    names = list(calls)
    order = names + names[::-1]
    out = {n: [] for n in names}
    for n in order:
        out[n].append(_ms(calls[n], iters))
    return out


def _cuda_core_turns(q, k, v, o, lse, do, rate, sd, kernels,
                     causal=True) -> dict:
    """The routed ``kernels`` (of "flash_fwd", "flash_dq", "flash_dkv")
    and the CUDA-core bodies of their width (``apex_flash_*_cuda_cores``)
    on the same inputs, in turns: {kernel: (routed ms, CUDA-core ms)},
    each the mean of its two turns.  The CUDA-core bodies' outputs are
    held to the twins too, so the two time the same function."""
    import torch
    from apex_tpu_torch.ops import attention as attn
    routed = dict(zip(("flash_dq", "flash_dkv"), _bwd_kernel_calls(
        q, k, v, o, lse, do, causal, None, rate, sd)))
    routed["flash_fwd"] = _fwd_kernel_call(q, k, v, causal, rate, sd)
    cc_out, cc_fwd = [], []
    cc = dict(zip(("flash_dq", "flash_dkv"), _bwd_kernel_calls(
        q, k, v, o, lse, do, causal, None, rate, sd, cuda_cores=True,
        out=cc_out)))
    cc["flash_fwd"] = _fwd_kernel_call(q, k, v, causal, rate, sd,
                                       cuda_cores=True, out=cc_fwd)
    for kn in kernels:
        cc[kn]()
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL["bf16" if q.dtype == torch.bfloat16 else "f32"]
    what = (f"of the CUDA-core body {tuple(q.shape)} causal={causal} "
            f"dropout {rate}")
    if "flash_fwd" in kernels:
        wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, None, rate, sd)
        _held("flash_fwd", cc_fwd[0], wo, atol, rtol, f"o {what}")
        _held("flash_fwd", cc_fwd[1], wlse, 1e-4, 1e-5, f"lse {what}")
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, None, rate,
                              sd)
    for kn, gn, g, w in zip(("flash_dq", "flash_dkv", "flash_dkv"),
                            ("dq", "dk", "dv"), cc_out, want):
        if kn in kernels:
            _held(kn, g, w, atol, rtol, f"{gn} {what}")
    out = {}
    for kn in kernels:
        t = _in_turns({"routed": routed[kn], "cuda cores": cc[kn]})
        print(f"time {kn} {tuple(q.shape)} {str(q.dtype)[6:]} "
              f"{'causal' if causal else 'unmasked'} dropout {rate} "
              f"in turns: routed {t['routed'][0]:.4f} / "
              f"{t['routed'][1]:.4f} ms, CUDA cores "
              f"{t['cuda cores'][0]:.4f} / {t['cuda cores'][1]:.4f} ms",
              flush=True)
        out[kn] = (sum(t["routed"]) / 2, sum(t["cuda cores"]) / 2)
    return out


def _sdpa_f32(q, k, v, do, causal=True) -> tuple:
    """SDPA's f32 forward and backward at q's shape, causal or not, on the
    first backend that takes it of memory-efficient attention and the
    math path, pinned with ``torch.nn.attention.sdpa_kernel``: (backend
    name, forward ms, backward ms, relative error of its output against
    an f64 evaluation).  TF32 products (a 10-bit mantissa) would leave an
    error near 1e-3; f32 ones near 1e-6."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    s = s / math.sqrt(q.shape[-1])
    n = q.shape[2]
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                     device=q.device).triu(1), float("-inf"))
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
    del s
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
                out = F.scaled_dot_product_attention(qq, kk, vv,
                                                     is_causal=causal)
                fwd = _ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), 3)
                bwd = _ms(lambda: torch.autograd.grad(
                    out, (qq, kk, vv), do, retain_graph=True), 3)
        except RuntimeError as e:
            print(f"SDPA f32 {tuple(q.shape)}: {backend.name} refused "
                  f"({str(e).splitlines()[0][:120]})", flush=True)
            continue
        err = float((out.detach().double() - ref).abs().max()
                    / ref.abs().max())
        return backend.name, fwd, bwd, err
    _check(False, f"SDPA took no f32 backend at {tuple(q.shape)}")


def _wide_times(dev, smi: str, gen, seed, cfg: dict) -> dict:
    """The three flash bodies at ``SelfMultiheadAttn(cfg hidden, heads)``'s
    (batch, heads, seq, head dim) bf16 causal shape, rate 0 and 0.1,
    beside the twin, SDPA and the bound: {kernel: {"rate0": row,
    "dropout": row}}.  At D 512 the wide tensor-core dq and dk/dv are
    also timed beside the D-512 CUDA-core bodies in turns
    (``cuda_cores_ms``); and the f32 bodies at that shape (rate 0) beside
    SDPA's f32 forward and backward, at D 256 and 512 the register-tile
    forward, dq and dk/dv also beside their CUDA-core bodies in turns
    (``{"f32": {"ms_in_turns": ..., "cuda_cores_ms": ...}}``)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as attn

    b, h, s = cfg["batch"], cfg["heads"], cfg["seq"]
    d = cfg["hidden"] // h
    body = _flash_route_of(d, "bf16")
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    pairs = _pairs(None, b, h, s, True, dev)
    costs = _attn_costs(b, h, h, s, d, 2, pairs)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    sd_o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    lib_bwd = _ms(lambda: torch.autograd.grad(sd_o, (qq, kk, vv), do,
                                              retain_graph=True), 10)
    rows = {}
    for rate in (0.0, DROP_RATE):
        sd = seed if rate else None
        fwd = lambda: attn._flash_fwd_cuda(q, k, v, True, None, None, True,
                                           rate, sd)
        o, lse = fwd()
        dq_call, dkv_call = _bwd_kernel_calls(q, k, v, o, lse, do, True,
                                              None, rate, sd)
        times = {"flash_fwd": _ms(fwd, 10), "flash_dq": _ms(dq_call, 10),
                 "flash_dkv": _ms(dkv_call, 10)}
        cc = (_cuda_core_turns(q, k, v, o, lse, do, rate, sd,
                               ("flash_dq", "flash_dkv")) if d == 512 else {})
        plain = {"flash_fwd": _ms(lambda: attn.flash_fwd_ref(
                     q, k, v, True, None, None, rate, sd), 3, 1)}
        plain["flash_dq"] = plain["flash_dkv"] = _ms(
            lambda: attn.flash_bwd_ref(q, k, v, o, lse, do, True, None, None,
                                       rate, sd), 3, 1)
        lib = {"flash_fwd": _ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, dropout_p=rate), 10)}
        if rate:
            sdr = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                 dropout_p=rate)
            lib["flash_dq"] = lib["flash_dkv"] = _ms(
                lambda: torch.autograd.grad(sdr, (qq, kk, vv), do,
                                            retain_graph=True), 10)
        else:
            lib["flash_dq"] = lib["flash_dkv"] = lib_bwd
        for kn in times:
            nbytes, ops = costs[kn]
            # bf16 operands: the card's bf16 rate, whatever unit the
            # body computes on
            bound_ms, bound_by = _bound(nbytes, ops, BF16_PEAK)
            row = dict(ms=times[kn], plain_ms=plain[kn], bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib[kn],
                       shape=f"({b}, {h}, {s}, {d}) bf16 causal",
                       rate=rate, body=body[kn])
            turns = ""
            if kn in cc:
                row.update(ms_in_turns=cc[kn][0], cuda_cores_ms=cc[kn][1])
                turns = (f", in turns {cc[kn][0]:.4f} ms against the "
                         f"CUDA-core body's {cc[kn][1]:.4f} "
                         f"({cc[kn][1] / cc[kn][0]:.2f}x)")
            rows.setdefault(kn, {})["rate0" if rate == 0 else "dropout"] = row
            print(f"time {kn} D {d} ({b}, {h}, {s}, {d}) bf16 causal dropout "
                  f"{rate} ({body[kn]}): kernel {times[kn]:.4f} ms "
                  f"({ops / times[kn] / 1e9:.1f} TFLOP/s){turns}, plain "
                  f"{plain[kn]:.4f} ms, SDPA "
                  f"{'forward' if kn == 'flash_fwd' else 'backward (dq, dk, dv)'}"
                  f" {lib[kn]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                  f" [{smi}]", flush=True)
        if body["flash_dq"] == "wide tensor cores":
            pair = times["flash_dq"] + times["flash_dkv"]
            print(f"time flash backward pair D {d} dropout {rate}: dq + "
                  f"dk/dv {pair:.4f} ms, {pair / lib['flash_dq']:.2f}x "
                  f"SDPA's backward, {pair / plain['flash_dq']:.2f}x the "
                  f"twin [{smi}]", flush=True)
        del o, lse
    # f32 at the same shape (rate 0): register tiles (the wide CUDA-core
    # bodies); at 256 and 512 also in turns with their CUDA-core bodies
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    fwd32 = lambda: attn._flash_fwd_cuda(q32, k32, v32, True, None, None,
                                         True)
    o32, lse32 = fwd32()
    calls = dict(zip(FLASH_SYMS, (fwd32,) + _bwd_kernel_calls(
        q32, k32, v32, o32, lse32, do32, True, None)))
    costs32 = _attn_costs(b, h, h, s, d, 4, pairs)
    body32 = _flash_route_of(d, "f32")
    cc32 = ({} if d > 512 else _cuda_core_turns(
        q32, k32, v32, o32, lse32, do32, 0.0, None,
        ("flash_fwd", "flash_dq", "flash_dkv")))
    backend, lib_f, lib_b, lib_err = _sdpa_f32(q32, k32, v32, do32)
    print(f"SDPA f32 ({b}, {h}, {s}, {d}) causal: backend {backend}, "
          f"output within {lib_err:.2e} of an f64 evaluation (TF32 "
          f"{'likely' if lib_err > 1e-5 else 'not used'}; allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}) [{smi}]",
          flush=True)
    for kn, call in calls.items():
        t32 = _ms(call, 3)
        bound_ms, bound_by = _bound(*costs32[kn])
        lib32 = lib_f if kn == "flash_fwd" else lib_b
        rows[kn]["f32"] = dict(ms=t32, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib32, library=f"SDPA {backend}",
                               body=body32[kn],
                               shape=f"({b}, {h}, {s}, {d}) f32 causal")
        turns = ""
        if kn in cc32:
            rows[kn]["f32"].update(ms_in_turns=cc32[kn][0],
                                   cuda_cores_ms=cc32[kn][1])
            turns = (f", in turns {cc32[kn][0]:.4f} ms against the "
                     f"CUDA-core body's {cc32[kn][1]:.4f} "
                     f"({cc32[kn][1] / cc32[kn][0]:.2f}x)")
        print(f"time {kn} D {d} ({b}, {h}, {s}, {d}) f32 causal dropout "
              f"0.0 ({body32[kn]}): kernel {t32:.4f} ms "
              f"({costs32[kn][1] / t32 / 1e9:.1f} TFLOP/s){turns}, SDPA f32 "
              f"{'forward' if kn == 'flash_fwd' else 'backward'} "
              f"({backend}) {lib32:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; operations at the f32 FMA rate) [{smi}]",
              flush=True)
    pair = rows["flash_dq"]["f32"]["ms"] + rows["flash_dkv"]["f32"]["ms"]
    print(f"time flash backward pair D {d} ({b}, {h}, {s}, {d}) f32 causal "
          f"dropout 0.0 ({body32['flash_dq']}): dq + dk/dv {pair:.4f} ms, "
          f"{pair / lib_b:.2f}x SDPA f32's backward ({backend}) [{smi}]",
          flush=True)
    del q32, k32, v32, do32, o32, lse32, calls
    return rows


# a head of 640 (513..1023 pad to 1024), timed: (batch, heads, seq, D)
D640_SHAPE = (8, 2, 512, 640)


def _d640_times(dev, smi: str, gen) -> None:
    """The forward, dq and dk/dv at ``D640_SHAPE`` causal, bf16 and f32,
    rate 0: the D-1024 bodies alone on operands padded with zeros
    beforehand (each kernel by itself), and the wrappers, which pad D 640
    to 1024 themselves (their copies included: the forward, and the
    backward's dq and dk/dv together with di); held against the twins;
    beside SDPA's forward and backward at D 640 (bf16 its default
    backend, f32 ``_sdpa_f32``: no TF32) and the bound of D 640's useful
    work (bf16 at the tensor cores' rate, f32 at the FMA rate)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as attn
    b, h, s, d = D640_SHAPE
    w = attn._kernel_width(d)
    pairs = _pairs(None, b, h, s, True, dev)
    for dtn in ("bf16", "f32"):
        dt = _dtype(dtn)
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       .to(dt) for _ in range(4))
        fwd = lambda: attn._flash_fwd_cuda(q, k, v, True, None, None, True)
        o, lse = fwd()
        bwd = lambda: attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None,
                                           None)
        grads = bwd()
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[dtn]
        what = f"({b}, {h}, {s}, {d}) {dtn} causal (padded to {w})"
        wo, wlse = attn.flash_fwd_ref(q, k, v, True)
        _held("flash_fwd", o, wo, atol, rtol, "o " + what)
        want = attn.flash_bwd_ref(q, k, v, o, lse, do, True)
        for kn, gn, g, x in zip(("flash_dq", "flash_dkv", "flash_dkv"),
                                ("dq", "dk", "dv"), grads, want):
            _held(kn, g, x, atol, rtol, f"{gn} {what}")
        del wo, wlse, want, grads
        pad = [torch.nn.functional.pad(t, (0, w - d)) for t in (q, k, v, do)]
        po, plse = attn._flash_fwd_cuda(*pad[:3], True, None, None, True)
        kernel = dict(zip(("flash_dq", "flash_dkv"), _bwd_kernel_calls(
            *pad[:3], po, plse, pad[3], True, None)))
        kernel["flash_fwd"] = _fwd_kernel_call(*pad[:3], True)
        kms = {kn: _ms(call, 5) for kn, call in kernel.items()}
        wrap_f, wrap_b = _ms(fwd, 5), _ms(bwd, 5)
        if dtn == "f32":
            backend, lib_f, lib_b, _ = _sdpa_f32(q, k, v, do)
        else:
            backend = "default backend"
            lib_f = _ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 5)
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
            lib_b = _ms(lambda: torch.autograd.grad(
                out, (qq, kk, vv), do, retain_graph=True), 5)
            del qq, kk, vv, out
        costs = _attn_costs(b, h, h, s, d, 2 if dtn == "bf16" else 4, pairs)
        peak = BF16_PEAK if dtn == "bf16" else F32_PEAK
        body = _flash_route_of(d, dtn)
        for kn in ("flash_fwd", "flash_dq", "flash_dkv"):
            bound_ms, bound_by = _bound(*costs[kn], peak)
            lib = lib_f if kn == "flash_fwd" else lib_b
            print(f"time {kn} D 640 {what} ({body[kn]}): the D-{w} body "
                  f"alone {kms[kn]:.4f} ms (SDPA "
                  f"{'forward' if kn == 'flash_fwd' else 'backward'}, "
                  f"{backend}, {lib:.4f} ms: kernel {kms[kn] / lib:.2f}x), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, D 640's useful "
                  f"work) [{smi}]", flush=True)
        pair = kms["flash_dq"] + kms["flash_dkv"]
        print(f"time flash D 640 {what} through the wrappers (padding "
              f"included): forward {wrap_f:.4f} ms ({wrap_f / lib_f:.2f}x "
              f"SDPA's), backward {wrap_b:.4f} ms ({wrap_b / lib_b:.2f}x "
              f"SDPA's); the D-{w} dq + dk/dv alone {pair:.4f} ms "
              f"({pair / lib_b:.2f}x) [{smi}]", flush=True)
        del q, k, v, do, o, lse, pad, po, plse, kernel


# the wide bodies at the wider widths, each at D 1024's bytes
# (B·H·S·D = 8·2·512·1024): (batch, heads, seq, head dim)
WIDE_FWD_SHAPES = ((4, 2, 512, 2048), (2, 2, 512, 4096), (1, 2, 512, 8192))


def _wide_widths(dev, smi: str, gen, seed) -> None:
    """The bf16 forward, dq and dk/dv at ``WIDE_FWD_SHAPES``, causal,
    rate 0 and 0.1: held against the twins and to the same bits on a
    second call, then timed beside SDPA's forward and backward, the twin
    and the bound.  Every column slice computes the whole of S (and
    dP), so the FLOP the tensor-core bodies execute grow with D while
    the useful ones (4·D a pair forward, 6·D dq, 8·D dk/dv), which the
    lines' TFLOP/s count, stay."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as attn

    atol, rtol = ATTN_TOL["bf16"]
    for b, h, s, d in WIDE_FWD_SHAPES:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        costs = _attn_costs(b, h, h, s, d, 2, _pairs(None, b, h, s, True,
                                                     dev))
        body = _flash_route_of(d, "bf16")
        for rate in (0.0, DROP_RATE):
            sd = seed if rate else None
            fwd = lambda: attn._flash_fwd_cuda(q, k, v, True, None, None,
                                               True, rate, sd)
            o, lse = fwd()
            again = fwd()
            wo, wlse = attn.flash_fwd_ref(q, k, v, True, None, None, rate,
                                          sd)
            what = f"({b}, {h}, {s}, {d}) bf16 causal dropout {rate}"
            _held("flash_fwd", o, wo, atol, rtol, "o " + what)
            _held("flash_fwd", lse, wlse, 1e-4, 1e-5, "lse " + what)
            _check(torch.equal(again[0], o) and torch.equal(again[1], lse),
                   f"flash forward {what}: the bits differ run to run")
            grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None,
                                         None, rate, sd)
            wgrads = attn.flash_bwd_ref(q, k, v, o, lse, do, True, None,
                                        None, rate, sd)
            for kn, gn, g, w in zip(("flash_dq", "flash_dkv", "flash_dkv"),
                                    ("dq", "dk", "dv"), grads, wgrads):
                _held(kn, g, w, atol, rtol, f"{gn} {what}")
            again = attn._flash_bwd_cuda(q, k, v, o, lse, do, True, None,
                                         None, rate, sd)
            _check(all(torch.equal(a, g) for a, g in zip(again, grads)),
                   f"flash backward {what}: the bits differ run to run")
            del again, wo, wlse, grads, wgrads
            dq_call, dkv_call = _bwd_kernel_calls(q, k, v, o, lse, do, True,
                                                  None, rate, sd)
            times = {"flash_fwd": _ms(fwd, 10), "flash_dq": _ms(dq_call, 10),
                     "flash_dkv": _ms(dkv_call, 10)}
            lib_fwd = _ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=rate), 10)
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                 dropout_p=rate)
            lib_bwd = _ms(lambda: torch.autograd.grad(
                out, (qq, kk, vv), do, retain_graph=True), 10)
            plain = _ms(lambda: attn.flash_bwd_ref(
                q, k, v, o, lse, do, True, None, None, rate, sd), 3, 1)
            del qq, kk, vv, out, o, lse
            for kn, ms in times.items():
                nbytes, ops = costs[kn]
                bound_ms, bound_by = _bound(nbytes, ops, BF16_PEAK)
                lib = lib_fwd if kn == "flash_fwd" else lib_bwd
                extra = ("" if kn == "flash_fwd" else
                         f", twin (dq, dk, dv) {plain:.4f} ms")
                print(f"time {kn} D {d} {what} ({body[kn]}): kernel "
                      f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s useful)"
                      f"{extra}, SDPA "
                      f"{'forward' if kn == 'flash_fwd' else 'backward'} "
                      f"{lib:.4f} ms (kernel {ms / lib:.2f}x), bound "
                      f"{bound_ms:.4f} ms ({bound_by}) [{smi}]", flush=True)
            pair = times["flash_dq"] + times["flash_dkv"]
            print(f"time flash backward pair D {d} {what}: dq + dk/dv "
                  f"{pair:.4f} ms ({pair / lib_bwd:.2f}x SDPA's backward) "
                  f"[{smi}]", flush=True)
        del q, k, v, do


# the f32 bodies at the head dims f32 training and serving run them at:
# GPT-2 small's (8, 12, 512, 64) and a Llama-class (8, 8, 512, 128); the
# forward, dq and dk/dv there in register tiles, one CTA on a row
F32_NARROW_SHAPES = ((8, 12, 512, 64), (8, 8, 512, 128))
# GPT-2 small's batch, heads and seq at D 32 and 16, causal, and the BERT
# proxy's (8, 4, 512, 32) unmasked (the shape it trains at --opt-level
# O0): the f32 forward, dq and dk/dv there in register tiles, 128 threads
# a CTA (b, h, s, d, causal)
F32_NARROWEST_SHAPES = ((8, 12, 512, 32, True), (8, 12, 512, 16, True),
                        (8, 4, 512, 32, False))


def _f32_widths(dev, smi: str, gen, seed, shapes, label: str,
                rows=None) -> dict:
    """The f32 forward, dq and dk/dv at ``shapes`` (``WIDE_FWD_SHAPES``:
    the wide bodies, register tiles on the CUDA cores, the column slices
    of a row block a cluster sharing the scores; ``F32_NARROW_SHAPES``
    and ``F32_NARROWEST_SHAPES``: the register-tile forward, dq and dk/dv
    with one CTA on a row), causal (or as a shape's fifth item says),
    rate 0 and 0.1: held against the twins and to the same bits on a
    second call, then timed beside SDPA's f32 forward and backward
    (``_sdpa_f32``: no TF32), the twin and the bound at the f32 FMA rate;
    up to D 128 each kernel whose body is not the CUDA-core one also in
    turns with its CUDA-core body (``_cuda_core_turns``).  Up to D 8192
    one cluster spans a row block, so the FLOP executed are the useful
    ones (4·D a pair forward, 6·D dq, 8·D dk/dv).  Returns the seconds of
    its forward and backward parts, named with ``label``; into ``rows``
    (where given) each kernel's rate-0 row at D 32, "d32_f32" causal and
    "d32_proxy_f32" unmasked."""
    import torch
    from apex_tpu_torch.ops import attention as attn

    atol, rtol = ATTN_TOL["f32"]
    fwd_s, bwd_s = f"f32 forward {label}", f"f32 backward {label}"
    secs = {fwd_s: 0.0, bwd_s: 0.0}
    for shape in shapes:
        b, h, s, d = shape[:4]
        causal = shape[4] if len(shape) > 4 else True
        mask = "causal" if causal else "unmasked"
        t0 = time.perf_counter()
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       for _ in range(4))
        costs = _attn_costs(b, h, h, s, d, 4, _pairs(None, b, h, s, causal,
                                                     dev))
        backend, lib_f, lib_b, lib_err = _sdpa_f32(q, k, v, do, causal)
        body = _flash_route_of(d, "f32")
        secs[fwd_s] += time.perf_counter() - t0
        for rate in (0.0, DROP_RATE):
            t0 = time.perf_counter()
            sd = seed if rate else None
            fwd = lambda: attn._flash_fwd_cuda(q, k, v, causal, None, None,
                                               True, rate, sd)
            o, lse = fwd()
            again = fwd()
            wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, None, rate,
                                          sd)
            what = f"({b}, {h}, {s}, {d}) f32 {mask} dropout {rate}"
            errs = {"flash_fwd": _held("flash_fwd", o, wo, atol, rtol,
                                       "o " + what)}
            _held("flash_fwd", lse, wlse, 1e-4, 1e-5, "lse " + what)
            _check(torch.equal(again[0], o) and torch.equal(again[1], lse),
                   f"flash forward {what}: the bits differ run to run")
            del again, wo, wlse
            times = {"flash_fwd": _ms(fwd, 5)}
            plain = {"flash_fwd": _ms(lambda: attn.flash_fwd_ref(
                q, k, v, causal, None, None, rate, sd), 2, 1)}
            secs[fwd_s] += time.perf_counter() - t0
            t0 = time.perf_counter()
            grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None,
                                         None, rate, sd)
            wgrads = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None,
                                        None, rate, sd)
            for kn, gn, g, w in zip(("flash_dq", "flash_dkv", "flash_dkv"),
                                    ("dq", "dk", "dv"), grads, wgrads):
                err = _held(kn, g, w, atol, rtol, f"{gn} {what}")
                errs[kn] = max(errs.get(kn, 0.0), err)
            again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None,
                                         None, rate, sd)
            _check(all(torch.equal(a, g) for a, g in zip(again, grads)),
                   f"flash backward {what}: the bits differ run to run")
            del again, grads, wgrads
            dq_call, dkv_call = _bwd_kernel_calls(q, k, v, o, lse, do,
                                                  causal, None, rate, sd)
            times.update(flash_dq=_ms(dq_call, 5), flash_dkv=_ms(dkv_call, 5))
            plain["flash_dq"] = plain["flash_dkv"] = _ms(
                lambda: attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None,
                                           None, rate, sd), 2, 1)
            turns = {}
            if d <= 128:
                # the register-tile bodies beside the CUDA-core bodies
                # they replace, in turns
                turns = _cuda_core_turns(
                    q, k, v, o, lse, do, rate, sd,
                    tuple(kn for kn, r in body.items() if r != "CUDA cores"),
                    causal)
            del o, lse
            for kn, ms in times.items():
                nbytes, ops = costs[kn]
                bound_ms, bound_by = _bound(nbytes, ops)
                lib_ms = lib_f if kn == "flash_fwd" else lib_b
                lib = (f"SDPA f32 {'forward' if kn == 'flash_fwd' else 'backward'}"
                       f" ({backend}, within {lib_err:.2e} of f64) "
                       f"{lib_ms:.4f} ms (kernel {ms / lib_ms:.2f}x)"
                       if rate == 0 else "SDPA f32: no dropout case timed")
                print(f"time {kn} D {d} {what} ({body[kn]}): kernel "
                      f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s), "
                      f"max_abs_err {errs[kn]:.3e}, twin {plain[kn]:.4f} "
                      f"ms, {lib}, bound {bound_ms:.4f} ms ({bound_by}; the "
                      f"f32 FMA rate) [{smi}]", flush=True)
            pair = times["flash_dq"] + times["flash_dkv"]
            print(f"time flash backward pair D {d} {what}: dq + dk/dv "
                  f"{pair:.4f} ms"
                  + (f" ({pair / lib_b:.2f}x SDPA f32's backward)"
                     if rate == 0 else "") + f" [{smi}]", flush=True)
            if rows is not None and d == 32 and rate == 0:
                for kn, ms in times.items():
                    bound_ms, bound_by = _bound(*costs[kn])
                    rows.setdefault(kn, {})[
                        "d32_f32" if causal else "d32_proxy_f32"] = dict(
                        ms=ms, ms_in_turns=turns[kn][0],
                        cuda_cores_ms=turns[kn][1], plain_ms=plain[kn],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_f if kn == "flash_fwd" else lib_b,
                        max_abs_err=errs[kn], atol=atol, rtol=rtol,
                        body=body[kn], shape=f"({b}, {h}, {s}, {d}) f32 {mask}")
            secs[bwd_s] += time.perf_counter() - t0
        del q, k, v, do
    return secs



# the bf16 forward, dq and dk/dv at head dims 16 and 32 on the tensor
# cores (flash_{fwd,dq,dkv}_kernel_tc at the head's own width: one panel
# of 32 or 64 bytes a row, the 32- and 64-byte swizzles): each case
# against the twins, with its routes from the device kernels' names
NARROW_CASES = (
    # name, b, h, hk, sq, sk, d, causal, segment ids, dropout rate
    ("d32_causal", 2, 8, 8, 256, 256, 32, True, None, 0.0),
    ("d32_unmasked", 2, 8, 8, 256, 256, 32, False, None, 0.0),
    ("d16_causal", 2, 8, 8, 256, 256, 16, True, None, 0.0),
    ("d16_unmasked", 2, 8, 8, 256, 256, 16, False, None, 0.0),
    ("d32_causal_s200", 2, 8, 8, 200, 200, 32, True, None, 0.0),
    ("d16_s200", 2, 8, 8, 200, 200, 16, False, None, 0.0),
    ("d32_sq130_sk70_causal", 2, 8, 8, 130, 70, 32, True, None, 0.0),
    # keys past Sq that no row sees under the causal mask
    ("d16_sq70_sk200_causal_gqa", 1, 8, 4, 70, 200, 16, True, None, 0.0),
    ("d32_sq200_sk330", 1, 8, 8, 200, 330, 32, False, None, 0.0),
    ("d32_gqa_8_to_2_causal", 2, 8, 2, 256, 256, 32, True, None, 0.0),
    ("d16_gqa_8_to_2_ragged", 2, 8, 2, 200, 200, 16, False, "ragged", 0.0),
    # pad rows that see no key (exact zeros, lse -1e30)
    ("d32_packed", 2, 8, 8, 256, 256, 32, False, "packed", 0.0),
    ("d16_packed_causal", 2, 8, 8, 192, 192, 16, True, "packed", 0.0),
    # heads of 17..31 padded to 32 (and 9..15 to 16)
    ("d24_causal", 2, 8, 8, 256, 256, 24, True, None, 0.0),
    ("d17_packed", 2, 8, 8, 192, 192, 17, False, "packed", 0.0),
    ("d31_gqa_s200", 2, 8, 4, 200, 200, 31, True, None, 0.0),
    ("d12_causal", 2, 8, 8, 130, 130, 12, True, None, 0.0),
    # the BERT example's default proxy: (8, 4, 512, 32) unmasked
    ("proxy_d32", 8, 4, 4, 512, 512, 32, False, None, 0.0),
    ("d32_dropout_causal", 2, 8, 8, 256, 256, 32, True, None, DROP_RATE),
    ("d16_dropout_packed", 2, 8, 8, 192, 192, 16, False, "packed",
     DROP_RATE),
    ("d32_dropout_gqa_s200", 2, 8, 4, 200, 200, 32, False, None, DROP_RATE),
)
# (name, b, h, sq, sk, d, causal): the keep masks read out of the
# forward, dk/dv and dq bodies against dropout_keep_ref
NARROW_KEEP_CASES = (("d32_causal", 1, 2, 100, 100, 32, True),
                     ("d16_unmasked_sq70_sk90", 1, 2, 70, 90, 16, False))
# timed: GPT-2 small's batch, heads and seq at D 32 and 16, causal, and
# the BERT proxy's own (8, 4, 512, 32) unmasked
NARROW_SHAPES = ((8, 12, 512, 32, True), (8, 12, 512, 16, True),
                 (8, 4, 512, 32, False))


def _wgmma_probe(dev, smi: str) -> None:
    """One 64 x D x 64 product of each kind the tensor-core bodies run
    (``apex_wgmma_probe``: S = A.B^T K-major, O = P.V MN-major, A, B and V
    by TMA with the swizzle of the body's panels) at D 16, 32 and 64 (the
    64-column panels' known-good layout as the control), against
    ``torch.matmul`` in f32 on the same bf16 values: every descriptor of
    the narrow bodies proven before the bodies are trusted."""
    import ctypes
    import torch
    from apex_tpu_torch import _build
    fn = _build.library("flash_fwd").apex_wgmma_probe
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(37)
    for d in (16, 32, 64):
        a, b, v = (torch.randn(64, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        p = torch.rand(64, 64, generator=gen, device=dev).to(torch.bfloat16)
        s = torch.full((64, 64), float("nan"), device=dev)
        o = torch.full((64, d), float("nan"), device=dev)
        rc = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), p.data_ptr(),
                s.data_ptr(), o.data_ptr(), d,
                torch.cuda.current_stream().cuda_stream)
        _check(rc == 0, f"apex_wgmma_probe D {d}: CUDA error {rc}")
        torch.cuda.synchronize()
        want_s = torch.matmul(a.float(), b.float().t())
        want_o = torch.matmul(p.float(), v.float())
        es = _held("wgmma probe", s, want_s, 1e-4, 1e-5, f"S = A.B^T D {d}")
        eo = _held("wgmma probe", o, want_o, 1e-4, 1e-5, f"O = P.V D {d}")
        print(f"kernel wgmma probe D {d} (swizzle {min(2 * d, 128)} bytes): "
              f"S = A.B^T (K-major) max_abs_err {es:.3e}, O = P.V "
              f"(MN-major, n{min(d, 64)}) {eo:.3e} against torch.matmul f32 "
              f"(atol 1e-4, rtol 1e-5) [{smi}]", flush=True)


def _narrow_case(gen, case, dev, dtn="bf16") -> tuple:
    """One ``NARROW_CASES`` case through the wrappers in ``dtn`` ("bf16"
    or "f32"): held against the twins, exact zeros where nothing is seen,
    the same bits twice.  Returns the worst errors {kernel: err} and
    {kernel: launches}."""
    import torch
    from apex_tpu_torch.ops import attention as attn
    name, b, h, hk, sq, sk, d, causal, kind, rate = case
    kern = {"flash_fwd": attn.FLASH_FWD, "flash_dq": attn.FLASH_DQ,
            "flash_dkv": attn.FLASH_DKV}
    before = {kn: kt.launches for kn, kt in kern.items()}
    q, k, v, do = (torch.randn(b, n, length, d, generator=gen, device=dev)
                   .to(_dtype(dtn))
                   for n, length in ((h, sq), (hk, sk), (hk, sk), (h, sq)))
    seg = _case_ids(kind, b, sq, dev)
    sd = (torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
          if rate else None)
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg, True, rate, sd)
    grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg,
                                 rate, sd)
    torch.cuda.synchronize()
    wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, seg, rate, sd)
    wgrads = attn.flash_bwd_ref(q, k, v, o, lse, do, causal, None, seg,
                                rate, sd)
    atol, rtol = ATTN_TOL[dtn]
    what = f"{name} q={tuple(q.shape)} k={tuple(k.shape)} {dtn} rate {rate}"
    errs = {"flash_fwd": _held("flash_fwd", o, wo, atol, rtol, "o " + what)}
    el = _held("flash_fwd", lse, wlse, 1e-4, 1e-5, "lse " + what)
    for kn, gn, g, w in zip(("flash_dq", "flash_dkv", "flash_dkv"),
                            ("dq", "dk", "dv"), grads, wgrads):
        errs[kn] = max(errs.get(kn, 0.0), _held(kn, g, w, atol, rtol,
                                                f"{gn} {what}"))
    if seg is not None:
        for t, ids in zip((o,) + grads, (seg[0], seg[0], seg[1], seg[1])):
            pad = (ids < 0)[:, None, :, None].expand_as(t)
            _check(bool(torch.all(t[pad] == 0)),
                   f"{what}: a row that sees no key (or a key no row sees) "
                   "is not exactly 0")
        _check(bool(torch.all(lse.view(b, h, sq)[(seg[0] < 0)[:, None, :]
                                                 .expand(b, h, sq)]
                              == -1e30)),
               f"{what}: a row that sees no key has an lse other than -1e30")
    if causal and sk > sq:
        _check(bool(torch.all(grads[1][:, :, sq:] == 0)
                    and torch.all(grads[2][:, :, sq:] == 0)),
               f"{what}: keys no row sees have nonzero dk or dv")
    again_o, again_lse = attn._flash_fwd_cuda(q, k, v, causal, None, seg,
                                              True, rate, sd)
    again = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, seg,
                                 rate, sd)
    _check(bool(torch.equal(again_o, o) and torch.equal(again_lse, lse)
                and all(torch.equal(a, g) for a, g in zip(again, grads))),
           f"{what}: the result differs run to run")
    print(f"kernel flash narrow {what} causal={causal} seg={kind}: "
          f"max_abs_err o {errs['flash_fwd']:.3e}, lse {el:.3e}, dq "
          f"{errs['flash_dq']:.3e}, dk/dv {errs['flash_dkv']:.3e} (atol="
          f"{atol}, rtol={rtol}); exact zeros where nothing is seen; the "
          "same bits on a second run", flush=True)
    return errs, {kn: kt.launches - before[kn] for kn, kt in kern.items()}


def _narrow_off_alignment(gen, dev) -> None:
    """q 8 bytes past a 16-byte boundary at D 16 and 32 bf16 (TMA needs
    16): the wrapper clones it to an aligned start (``_align`` is 16
    there), so the forward, dq and dk/dv run their tensor-core bodies and
    give the twins' result, with gradients."""
    import torch
    from apex_tpu_torch.ops import attention as attn
    atol, rtol = ATTN_TOL["bf16"]
    for d in (16, 32):
        _check(attn._align(torch.bfloat16, d) == 16,
               f"_align(bf16, {d}) is not TMA's 16 bytes")
        base = torch.randn(4 + 2 * 4 * 96 * d, generator=gen, device=dev)
        q = base.to(torch.bfloat16)[4:].view(2, 4, 96, d)
        _check(q.data_ptr() % 16 == 8, "the off-alignment q is aligned")
        k, v, do = (torch.randn(2, 4, 96, d, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(3))
        kern = (attn.FLASH_FWD, attn.FLASH_DQ, attn.FLASH_DKV)
        before = [kt.launches for kt in kern]
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = attn.flash_attention(qq, kk, vv, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        _check([kt.launches - n for kt, n in zip(kern, before)] == [1, 1, 1],
               f"D {d} off alignment: not one forward, one dq and one dk/dv "
               "launch")
        qa = q.contiguous().clone()
        wo, wlse = attn.flash_fwd_ref(qa, k, v, True)
        want = attn.flash_bwd_ref(qa, k, v, o.detach(), wlse, do, True)
        errs = [_held("flash_fwd", o.detach(), wo, atol, rtol,
                      f"o D {d} q off 16 bytes")]
        errs += [_held("flash_dq" if gn == "dq" else "flash_dkv", g, w,
                       atol, rtol, f"{gn} D {d} q off 16 bytes")
                 for gn, g, w in zip(("dq", "dk", "dv"),
                                     (qq.grad, kk.grad, vv.grad), want)]
        print(f"kernel flash narrow D {d} bf16 causal, q 8 bytes past a "
              f"16-byte boundary (cloned by the wrapper): max_abs_err o "
              f"{errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv "
              f"{errs[3]:.3e}", flush=True)


def _narrow_times(dev, smi: str, gen, shape) -> dict:
    """At ``shape`` (b, h, s, d, causal) bf16, rate 0: the forward, dq and
    dk/dv on their tensor-core bodies, the old CUDA-core bodies
    (``apex_flash_{fwd,dq,dkv}_cuda_cores``, held to the twins too) and
    the D-64 tensor-core bodies on the operands padded with zeros to 64
    (a padded baseline, its scale 1/8: the same work), in turns; then
    each kernel's twin, SDPA's bf16 forward / backward (the default
    backend) and the bound.  Returns {kernel: row}."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as attn
    b, h, s, d, causal = shape
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True)
    pad = [torch.nn.functional.pad(t, (0, 64 - d)) for t in (q, k, v, do)]
    po, plse = attn._flash_fwd_cuda(*pad[:3], causal, None, None, True)
    routed = dict(zip(("flash_dq", "flash_dkv"), _bwd_kernel_calls(
        q, k, v, o, lse, do, causal, None)))
    routed["flash_fwd"] = _fwd_kernel_call(q, k, v, causal)
    cc_out, cc_fwd = [], []
    cc = dict(zip(("flash_dq", "flash_dkv"), _bwd_kernel_calls(
        q, k, v, o, lse, do, causal, None, cuda_cores=True, out=cc_out)))
    cc["flash_fwd"] = _fwd_kernel_call(q, k, v, causal, cuda_cores=True,
                                       out=cc_fwd)
    padded = dict(zip(("flash_dq", "flash_dkv"), _bwd_kernel_calls(
        *pad[:3], po, plse, pad[3], causal, None)))
    padded["flash_fwd"] = _fwd_kernel_call(*pad[:3], causal)
    for call in cc.values():
        call()
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL["bf16"]
    what = f"({b}, {h}, {s}, {d}) bf16 causal={causal}"
    wo, wlse = attn.flash_fwd_ref(q, k, v, causal)
    want = attn.flash_bwd_ref(q, k, v, o, lse, do, causal)
    errs = {"flash_fwd": _held("flash_fwd", o, wo, atol, rtol, "o " + what),
            "flash_dq": 0.0, "flash_dkv": 0.0}
    _held("flash_fwd", cc_fwd[0], wo, atol, rtol,
          f"o of the CUDA-core body {what}")
    grads = attn._flash_bwd_cuda(q, k, v, o, lse, do, causal, None, None)
    for kn, gn, g, c, w in zip(("flash_dq", "flash_dkv", "flash_dkv"),
                               ("dq", "dk", "dv"), grads, cc_out, want):
        errs[kn] = max(errs[kn], _held(kn, g, w, atol, rtol,
                                       f"{gn} {what}"))
        _held(kn, c, w, atol, rtol, f"{gn} of the CUDA-core body {what}")
    lib_f = _ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal), 10)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
    lib_b = _ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                            retain_graph=True), 10)
    plain = {"flash_fwd": _ms(lambda: attn.flash_fwd_ref(q, k, v, causal),
                              3, 1)}
    plain["flash_dq"] = plain["flash_dkv"] = _ms(
        lambda: attn.flash_bwd_ref(q, k, v, o, lse, do, causal), 3, 1)
    costs = _attn_costs(b, h, h, s, d, 2, _pairs(None, b, h, s, causal, dev))
    rows = {}
    for kn in ("flash_fwd", "flash_dq", "flash_dkv"):
        t = _in_turns({"tensor cores": routed[kn], "CUDA cores": cc[kn],
                       "padded to 64": padded[kn]})
        mean = {n: sum(x) / 2 for n, x in t.items()}
        ms = mean["tensor cores"]
        nbytes, ops = costs[kn]
        bound_ms, bound_by = _bound(nbytes, ops, BF16_PEAK)
        lib = lib_f if kn == "flash_fwd" else lib_b
        print(f"time {kn} narrow {what} in turns: "
              + ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in xs)
                          + " ms" for n, xs in t.items())
              + f"; plain {plain[kn]:.4f} ms, SDPA "
              f"{'forward' if kn == 'flash_fwd' else 'backward'} {lib:.4f} "
              f"ms (kernel {ms / lib:.2f}x), bound {bound_ms:.4f} ms "
              f"({bound_by}), {ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
              f"{mean['CUDA cores'] / ms:.2f}x faster than the CUDA-core "
              f"body, {mean['padded to 64'] / ms:.2f}x than D 64 padded "
              f"[{smi}]", flush=True)
        rows[kn] = dict(ms=ms, plain_ms=plain[kn], bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib,
                        max_abs_err=errs[kn], atol=atol, rtol=rtol,
                        padded_64_ms=mean["padded to 64"],
                        cuda_cores_ms=mean["CUDA cores"],
                        body=_flash_route_of(d, "bf16")[kn],
                        shape=f"({b}, {h}, {s}, {d}) bf16 "
                              f"{'causal' if causal else 'unmasked'}")
    pair = rows["flash_dq"]["ms"] + rows["flash_dkv"]["ms"]
    print(f"time flash backward pair narrow {what}: dq + dk/dv {pair:.4f} "
          f"ms ({pair / lib_b:.2f}x SDPA bf16's backward) [{smi}]",
          flush=True)
    return rows


def narrow_head_phase(dev, smi: str, proxy_launches: dict) -> dict:
    """Phase 37: the bf16 forward, dq and dk/dv at D 16 and 32 on the
    tensor cores.  The descriptors first (``_wgmma_probe``); then every
    ``NARROW_CASES`` case against the twins with its routes read from the
    device kernels' names (``..._kernel_tc`` all three), and in f32
    (``..._kernel_wide`` all three, register tiles), the keep masks of
    both bit for bit, an operand off 16 bytes, the ptxas registers and spills
    of the narrow bodies (0 spill bytes); then the times at
    ``NARROW_SHAPES`` in turns with the CUDA-core bodies and the padded
    D-64 bodies beside SDPA and the bound.
    Returns {kernel: {"d32_proxy": the proxy shape's row, its launches in
    phase 28's steps}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn

    _wgmma_probe(dev, smi)
    gen = torch.Generator(device=dev).manual_seed(38)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    # bf16 (the tensor cores), then f32 (register tiles, 128 threads a
    # CTA): the same edge cases, each kernel's route from its device name
    for dtn, route in (("bf16", "tensor cores"), ("f32", "wide CUDA cores")):
        for drop in (False, True):
            cases = [c for c in NARROW_CASES if (c[-1] > 0) == drop]
            case_launches = []
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            _prime_profiler()
            for case in cases:
                errs, launches = _narrow_case(gen, case, dev, dtn)
                case_launches.append((case[0], launches))
                if case[0] == "proxy_d32" and dtn == "bf16":
                    worst = errs
            torch.cuda.synchronize()
            prof.stop()
            case_routes = _flash_routes(prof, case_launches, drop=drop)
            del prof
            for case in cases:
                name, d = case[0], case[6]
                want = _flash_route_of(d, dtn)
                _check(set(want.values()) == {route},
                       f"flash_route at {dtn} D {d}: {want}")
                _check(case_routes[name] == want, f"{name} {dtn}: routes "
                       f"{case_routes[name]}, expected {want}")
                print(f"route narrow {name} {dtn} D {d} (kernel width "
                      f"{attn._kernel_width(d)}) dropout {case[-1]}: "
                      + ", ".join(f"{kn} {r}" for kn, r in
                                  case_routes[name].items()), flush=True)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    for name, b, h, sq, sk, d, causal in NARROW_KEEP_CASES:
        vis = _visible(None, sq, sk, causal, dev)[:, None]
        want = attn.dropout_keep_ref(seed, b, h, sq, sk, DROP_RATE) & vis
        for dtn in ("bf16", "f32"):
            for side in ("fwd", "dv", "dq"):
                got = keep_mask_readout(b, h, sq, sk, d, _dtype(dtn), causal,
                                        DROP_RATE, seed, dev, side)
                _check(bool(torch.equal(got, want)), f"keep mask narrow "
                       f"{name} {dtn} {side}: {int((got != want).sum())} "
                       "pairs other than dropout_keep_ref's")
            print(f"keep mask narrow {name} ({b}, {h}, {sq}, {sk}) D {d} "
                  f"{dtn} causal={causal}: the forward's, dk/dv's and dq's "
                  f"masks equal dropout_keep_ref bit for bit "
                  f"({int(want.sum())} pairs kept)", flush=True)
    _narrow_off_alignment(gen, dev)

    for lib, kn in (("flash_fwd", "flash_fwd"), ("flash_bwd", "flash_dq"),
                    ("flash_bwd", "flash_dkv")):
        for d in (16, 32):
            found = _ptxas_report(_build.build_logs.get(lib, ""),
                                  f"{FLASH_SYMS[kn]}_tcILi{d}E")
            _check(len(found) == 2, f"ptxas reported {len(found)} {kn} "
                   f"tensor-core bodies at D {d}, expected 2 (rate 0, DROP)")
            for entry, regs, spill in found:
                print(f"ptxas narrow tensor-core body {entry}: {regs}; "
                      f"{spill} [{smi}]", flush=True)
                _check(spill is not None and "0 bytes spill stores" in spill
                       and "0 bytes spill loads" in spill,
                       f"ptxas reports spills for {entry}: {spill}")

    rows = {}
    for shape in NARROW_SHAPES:
        got = _narrow_times(dev, smi, gen, shape)
        if shape == NARROW_SHAPES[-1]:
            rows = got
    out = {}
    for kn, row in rows.items():
        row.update(max_abs_err=max(row["max_abs_err"], worst[kn]),
                   launches=proxy_launches[kn])
        out[kn] = {"d32_proxy": row}
    return out


def _wide_module_steps(dev, smi: str, gen, cfg: dict) -> None:
    """``SelfMultiheadAttn(cfg hidden, heads)`` trained ``cfg steps`` SGD
    steps at rate 0.1 and 0 (bf16, causal): finite losses and gradients,
    one launch of each flash kernel a step, the routes of a profiled
    run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn

    E, H = cfg["hidden"], cfg["heads"]
    x = torch.randn(cfg["seq"], cfg["batch"], E, generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn(x.shape, generator=gen, device=dev)
    dgen = torch.Generator(device=dev).manual_seed(14)
    init = torch.Generator().manual_seed(1)
    flash = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    for rate in (DROP_RATE, 0.0):
        mod = SelfMultiheadAttn(E, H, dropout=rate)
        params = {n: {k: t.requires_grad_() for k, t in sub.items()}
                  for n, sub in mod.init(init, dev).items()}
        leaves = [t for sub in params.values() for t in sub.values()]

        def train_step():
            out, _ = mod(params, x, attn_mask="causal", generator=dgen)
            loss = (out.float() * w).mean()
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for t, g in zip(leaves, grads):
                    t.sub_(1e-2 * g.to(t.dtype))
            return loss.detach(), grads

        train_step()                                   # warm-up
        # a session that comes back without the flash kernels' records
        # (an H100 profiler fault, not the kernels': the launch counts are
        # checked apart) is read again, up to three sessions
        for _ in range(3):
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            _prime_profiler()
            (results, counts) = _path_counts(
                lambda: [train_step() for _ in range(cfg["steps"])],
                f"SelfMultiheadAttn({E}, {H}) dropout {rate}",
                {kn: cfg["steps"] * c for kn, c in flash.items()})
            prof.stop()
            if _flash_records_complete(prof, counts):
                break
            print(f"SelfMultiheadAttn({E}, {H}) dropout {rate}: the profiler "
                  f"session lacks flash kernel records; profiling again",
                  flush=True)
        routes = _flash_routes(prof, [(f"rate {rate}", counts)],
                               drop=rate > 0)
        del prof
        want = _flash_route_of(E // H, "bf16")
        _check(routes[f"rate {rate}"] == want,
               f"SelfMultiheadAttn({E}, {H}): routes {routes}, expected "
               f"{want}")
        losses = [float(l) for l, _ in results]
        _check(all(math.isfinite(v) for v in losses) and all(
            bool(torch.isfinite(g).all()) for _, gs in results for g in gs),
            f"SelfMultiheadAttn({E}, {H}) dropout {rate}: a non-finite "
            f"loss or gradient ({losses})")
        print(f"path SelfMultiheadAttn({E}, {H}) (head dim {E // H}: "
              f"{'F5c' if E // H > 512 else 'F5b'}; {want['flash_fwd']}) T "
              f"{cfg['seq']} B "
              f"{cfg['batch']} bf16 causal dropout {rate}, training "
              f"(SGD lr 1e-2): losses {[round(v, 6) for v in losses]}, "
              f"launches {counts}, routes {routes[f'rate {rate}']} [{smi}]",
              flush=True)
        del params, leaves, results


def dropout_consistency_phase(dev) -> None:
    """A 2-layer f32 ``SelfMultiheadAttn(768, 12, dropout 0.1, bias,
    norm-add)`` stack, causal, one forward and backward on the card and
    on the CPU from the same params, input and per-layer seeds: output
    and gradients within ``DROP_CONSIST["tol"]`` of each tensor's scale;
    the CPU run at other seeds must fall outside it."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn

    c = DROP_CONSIST
    mha = SelfMultiheadAttn(c["hidden"], c["heads"], dropout=DROP_RATE,
                            bias=True, include_norm_add=True)
    init = torch.Generator().manual_seed(3)
    cpu_params = [mha.init(init, "cpu") for _ in range(c["layers"])]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(c["seq"], c["batch"], c["hidden"], generator=g)
    w = torch.randn(x.shape, generator=g)

    def run(device, seeds):
        ps = [{n: {k: t.to(device).requires_grad_() for k, t in sub.items()}
               for n, sub in p.items()} for p in cpu_params]
        xx = x.to(device).requires_grad_()
        h = xx
        for p, sd in zip(ps, seeds):
            h, _ = mha(p, h, attn_mask="causal", dropout_seed=sd)
        loss = (h * w.to(device)).sum()
        grads = torch.autograd.grad(
            loss, [xx] + [t for p in ps for sub in p.values()
                          for t in sub.values()])
        return [t.detach().cpu() for t in [h] + list(grads)]

    seeds = [101, 102]
    card, cpu = run(dev, seeds), run("cpu", seeds)
    wrong = run("cpu", [s + 7 for s in seeds])

    def gap(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                    1e-30)
                   for x, y in zip(a, b))

    got, bad = gap(card, cpu), gap(wrong, cpu)
    _check(got <= c["tol"] < bad,
           f"dropout card vs cpu: gap {got:.3e} of scale (limit "
           f"{c['tol']}), other seeds' gap {bad:.3e} (must exceed it)")
    print(f"consistency dropout: {c['layers']} x SelfMultiheadAttn("
          f"{c['hidden']}, {c['heads']}, dropout {DROP_RATE}) f32 T "
          f"{c['seq']} B {c['batch']} causal, card vs CPU: output and "
          f"{len(card) - 1} gradients within {got:.3e} of their scale "
          f"(limit {c['tol']}); the CPU at other seeds {bad:.3e} away",
          flush=True)


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


# ---------------------------------------------------------------------------
# transformer.functional: the fused softmax (softmax_fwd, softmax_masked_fwd,
# softmax_bwd) at GPT-2 small's and BERT-Large's attention widths, and
# FusedScaleMaskSoftmax inside an unfused attention
# ---------------------------------------------------------------------------

_SM = "apex_tpu/ops/softmax.py"
SOFTMAX_SOURCE = "apex_tpu_torch/csrc/softmax.cu"
SOFTMAX_REPLACES = {
    "softmax_fwd": f"{_SM}:99 (_rows_call :94, body _plain_fwd_kernel :75)",
    "softmax_masked_fwd": f"{_SM}:166 (_sms_fwd :143, body "
                          "_masked_fwd_kernel :69)",
    "softmax_bwd": f"{_SM}:196 (_softmax_vjp :184, body "
                   "_softmax_bwd_kernel :87)",
}
# the kernels against their plain versions: f32 forward within atol 1e-6
# (exp's rounding and the sum's order); bf16/fp16 within one rounding of
# the output dtype (rtol 2^-7 / 2^-10); the backward within 1e-5 of
# max |dx| (f32 sums in another order, then one rounding in bf16/fp16)
SOFTMAX_RTOL = {"f32": 0.0, "bf16": 2.0 ** -7, "fp16": 2.0 ** -10}
SOFTMAX_FWD_ATOL = {"f32": 1e-6, "bf16": 1e-12, "fp16": 2.0 ** -24}
SOFTMAX_BWD_ATOL = 1e-5                 # of max |dx|
GPT_ATTN = (8, 12, 1024, 64)            # b, heads, seq, head dim
BERT_ATTN = (8, 16, 512, 64)
SOFTMAX_CASES = (
    # name, x shape (b, np, sq, sk), kind, dtype
    ("gpt2_small_causal", GPT_ATTN[:3] + GPT_ATTN[2:3], "causal", "bf16"),
    ("bert_large_masked", BERT_ATTN[:3] + BERT_ATTN[2:3], "masked", "bf16"),
    ("bert_large_unmasked", BERT_ATTN[:3] + BERT_ATTN[2:3], "unmasked",
     "bf16"),
    ("bert_large_masked_f32", BERT_ATTN[:3] + BERT_ATTN[2:3], "masked",
     "f32"),
    ("bert_large_unmasked_fp16", BERT_ATTN[:3] + BERT_ATTN[2:3], "unmasked",
     "fp16"),
    ("bert_large_masked_fp16", BERT_ATTN[:3] + BERT_ATTN[2:3], "masked",
     "fp16"),
    ("causal_f32_s2048", (1, 4, 2048, 2048), "causal", "f32"),
    ("masked_bf16_s4096", (1, 2, 64, 4096), "masked", "bf16"),
    ("unmasked_ragged_rows", (1, 3, 7, 384), "unmasked", "bf16"),
)
# off the reference's gate: the plain version on the card, and the
# backward's kernel only where the reference runs it (sk on the gate)
SOFTMAX_OFF_GATE = (
    # name, x shape, kind, expected (forward, backward) kernel launches
    ("sk200_unmasked", (2, 4, 64, 200), "unmasked", (0, 0)),
    ("sk200_masked", (2, 4, 64, 200), "masked", (0, 0)),
    ("sk200_causal", (2, 4, 200, 200), "causal", (0, 0)),
    ("sq12_masked", (2, 4, 12, 512), "masked", (0, 1)),
)
SOFTMAX_PATH = dict(warmup=1, steps=3, tol=2e-2)   # tol: of each scale


def _sm_dtype(name):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "fp16": torch.float16}[name]


def _bert_padding_mask(b, sq, sk, device):
    """Megatron's BERT padding mask ``pad_q | pad_k`` (b, 1, sq, sk) bool
    from the lengths 128..512 of the BERT training phase's first batch
    (``default_rng(1)``), scaled from 512 to each side's length."""
    import numpy as np
    import torch
    lens = np.random.default_rng(1).integers(BERT["lengths"][0],
                                             BERT["lengths"][1] + 1, b)

    def pad(n):
        return np.arange(n)[None, :] >= (lens * n // BERT["seq"])[:, None]
    m = pad(sq)[:, None, :, None] | pad(sk)[:, None, None, :]
    return torch.from_numpy(m).to(device)


def _softmax_inputs(gen, shape, kind, dtn, dev):
    import torch
    dt = _sm_dtype(dtn)
    x = (torch.randn(shape, generator=gen, device=dev) * 4).to(dt)
    dy = torch.randn(shape, generator=gen, device=dev).to(dt)
    mask = (_bert_padding_mask(shape[0], shape[2], shape[3], dev)
            if kind == "masked" else None)
    return x, dy, mask


def _softmax_calls(x, mask, kind, scale):
    """(the forward kernel's wrapper, its plain version) on x, both
    taking the mask as the public op hands it to them."""
    from apex_tpu_torch.ops import softmax as sm
    b, np_, sq, sk = x.shape
    if kind == "causal":
        x3 = x.reshape(b * np_, sq, sk)
        return (lambda: sm._softmax_fwd(x3, scale, causal=True),
                lambda: sm.scaled_upper_triang_masked_softmax_ref(x3, scale))
    if kind == "unmasked":
        return (lambda: sm._softmax_fwd(x, scale, causal=False),
                lambda: sm.scaled_masked_softmax_ref(x, None, scale))
    m8 = sm._byte_mask(mask, b, sq, sk)
    return (lambda: sm._softmax_masked_fwd(x, m8, scale),
            lambda: sm.scaled_masked_softmax_ref(x, mask, scale))


def _softmax_bytes(shape, kind, elt) -> int:
    """Each input read once (the causal forward: the lower triangle),
    each output written once."""
    b, np_, sq, sk = shape
    n = b * np_ * sq * sk
    if kind == "causal":
        return elt * (b * np_ * sq * (sq + 1) // 2 + n)
    if kind == "masked":
        return 2 * elt * n + b * sq * sk
    return 2 * elt * n


def softmax_kernel_phase(dev, smi: str) -> list:
    """softmax_fwd (unmasked and causal), softmax_masked_fwd and
    softmax_bwd against their plain versions on the card at GPT-2
    small's causal (8, 12, 1024, 1024) and BERT-Large's (8, 16, 512,
    512) masked and unmasked scores (bf16; f32 and fp16 at BERT's;
    rows of 2048 and 4096 and a ragged row count), within the stated
    tolerances, exact zeros on dead rows, the same bits on a second run,
    one launch a call; off the gate the plain version and no forward
    launch; then the main shapes timed beside the plain version, the
    bytes bound and a one-call PyTorch yardstick."""
    import torch
    from apex_tpu_torch.ops import softmax as sm

    gen = torch.Generator(device=dev).manual_seed(12)
    kern = {"causal": sm.SOFTMAX_FWD, "unmasked": sm.SOFTMAX_FWD,
            "masked": sm.SOFTMAX_MASKED_FWD}
    worst = {name: 0.0 for name in SOFTMAX_REPLACES}
    for name, shape, kind, dtn in SOFTMAX_CASES:
        x, dy, mask = _softmax_inputs(gen, shape, kind, dtn, dev)
        scale = 1.0 / math.sqrt(64)
        fwd, plain = _softmax_calls(x, mask, kind, scale)
        k = kern[kind]
        before = (k.launches, sm.SOFTMAX_BWD.launches)
        y = fwd()
        dx = sm._softmax_bwd(y, dy.reshape(y.shape), scale)
        torch.cuda.synchronize()
        _check((k.launches, sm.SOFTMAX_BWD.launches)
               == (before[0] + 1, before[1] + 1),
               f"softmax {name}: one launch of {k.name} and of softmax_bwd "
               f"expected")
        want_y = plain()
        want_dx = sm.softmax_vjp_ref(y, dy.reshape(y.shape), scale)
        what = f"{name} x={tuple(shape)} {dtn} {kind}"
        e_y = _held(k.name, y, want_y, SOFTMAX_FWD_ATOL[dtn],
                    SOFTMAX_RTOL[dtn], "y " + what)
        scale_dx = float(want_dx.float().abs().max())
        e_dx = _held("softmax_bwd", dx, want_dx,
                     SOFTMAX_BWD_ATOL * scale_dx, SOFTMAX_RTOL[dtn],
                     "dx " + what)
        dead = 0
        if mask is not None:
            rows = mask.all(dim=-1, keepdim=True).expand(shape[0], shape[1],
                                                         shape[2], shape[3])
            dead = int(rows[..., 0].sum())
            _check(bool(torch.all(y[rows] == 0) and torch.all(dx[rows] == 0)),
                   f"softmax {what}: a fully masked row is not exact zeros")
        if kind == "causal":
            upper = torch.ones(shape[2], shape[3], dtype=torch.bool,
                               device=dev).triu(1)
            _check(bool(torch.all(y[:, upper] == 0)),
                   f"softmax {what}: the upper triangle is not exact zeros")
        again_y = fwd()
        again_dx = sm._softmax_bwd(y, dy.reshape(y.shape), scale)
        _check(bool(torch.equal(again_y, y) and torch.equal(again_dx, dx)),
               f"softmax {what}: the result differs run to run")
        if dtn == "bf16" and shape[0] == 8:
            worst[k.name] = max(worst[k.name], e_y)
            worst["softmax_bwd"] = max(worst["softmax_bwd"], e_dx)
        print(f"kernel softmax {what}: max_abs_err y {e_y:.3e} (atol "
              f"{SOFTMAX_FWD_ATOL[dtn]:g}, rtol {SOFTMAX_RTOL[dtn]:g}), dx "
              f"{e_dx:.3e} (atol {SOFTMAX_BWD_ATOL:g} x max|dx| "
              f"{scale_dx:.3e}); {dead} fully masked rows exact zeros; the "
              "same bits on a second run", flush=True)
        del x, dy, mask, y, dx, want_y, want_dx, again_y, again_dx

    for name, shape, kind, (n_fwd, n_bwd) in SOFTMAX_OFF_GATE:
        x, dy, mask = _softmax_inputs(gen, shape, kind, "bf16", dev)
        x.requires_grad_()
        before = {k.name: k.launches for k in (sm.SOFTMAX_FWD,
                                               sm.SOFTMAX_MASKED_FWD,
                                               sm.SOFTMAX_BWD)}
        with torch.enable_grad():
            if kind == "causal":
                b, np_, sq, sk = shape
                y = sm.scaled_upper_triang_masked_softmax(
                    x.reshape(b * np_, sq, sk), 0.125).reshape(shape)
                want = sm.scaled_upper_triang_masked_softmax_ref(
                    x.detach().reshape(b * np_, sq, sk), 0.125
                ).reshape(shape)
            else:
                y = sm.scaled_masked_softmax(x, mask, 0.125)
                want = sm.scaled_masked_softmax_ref(x.detach(), mask, 0.125)
            n_after_fwd = sm.SOFTMAX_FWD.launches + \
                sm.SOFTMAX_MASKED_FWD.launches
            (dx,) = torch.autograd.grad(y, x, dy)
        torch.cuda.synchronize()
        fwd_launches = n_after_fwd - before["softmax_fwd"] - \
            before["softmax_masked_fwd"]
        bwd_launches = sm.SOFTMAX_BWD.launches - before["softmax_bwd"]
        _check((fwd_launches, bwd_launches) == (n_fwd, n_bwd),
               f"softmax off the gate {name}: launches (fwd, bwd) "
               f"{(fwd_launches, bwd_launches)}, the reference's gate gives "
               f"{(n_fwd, n_bwd)}")
        _check(bool(torch.equal(y.detach(), want)),
               f"softmax off the gate {name}: not the plain version's bits")
        print(f"kernel softmax off the gate {name} x={tuple(shape)} {kind}: "
              f"the plain version's bits, launches forward {fwd_launches}, "
              f"backward {bwd_launches} (the reference's gate)", flush=True)
        del x, dy, mask, y, want, dx

    entries, rows = [], {}
    timed = (("softmax_fwd", SOFTMAX_CASES[0]),
             ("softmax_masked_fwd", SOFTMAX_CASES[1]),
             ("softmax_fwd", SOFTMAX_CASES[2]),
             ("softmax_bwd", SOFTMAX_CASES[0]),
             ("softmax_bwd", SOFTMAX_CASES[1]))
    for kname, (name, shape, kind, dtn) in timed:
        x, dy, mask = _softmax_inputs(gen, shape, kind, dtn, dev)
        scale = 0.125
        elt = x.element_size()
        fwd, plain = _softmax_calls(x, mask, kind, scale)
        b, np_, sq, sk = shape
        if kname == "softmax_bwd":
            y = fwd()
            kern_fn = lambda: sm._softmax_bwd(y, dy.reshape(y.shape), scale)
            plain_fn = lambda: sm.softmax_vjp_ref(y, dy.reshape(y.shape),
                                                  scale)
            lib_fn = lambda: torch._softmax_backward_data(
                dy.reshape(y.shape), y, -1, y.dtype)
            note = ("torch._softmax_backward_data: (dy - sum(y dy)) y "
                    "without the scale")
            nbytes = 3 * elt * x.numel()
        else:
            kern_fn, plain_fn = fwd, plain
            nbytes = _softmax_bytes(shape, kind, elt)
            if kind == "causal":
                upper = torch.ones(sq, sk, dtype=torch.bool,
                                   device=dev).triu(1)
                lib_fn = lambda: torch._masked_softmax(x, upper, -1, 0)
                note = ("torch._masked_softmax with the (sq, sk) causal "
                        "mask: no scale, -inf fill")
            elif kind == "masked":
                full = mask.expand(shape).contiguous()
                lib_fn = lambda: torch._masked_softmax(x, full, -1, 2)
                note = ("torch._masked_softmax with the mask expanded to "
                        "(b, np, sq, sk) beforehand: no scale, -inf fill, "
                        "np-fold mask bytes")
            else:
                lib_fn = lambda: torch.softmax(x, -1)
                note = "torch.softmax: no scale"
        ms = _ms(kern_fn, iters=20, warmup=3)
        plain_ms = _ms(plain_fn, iters=5, warmup=1)
        lib_ms = _ms(lib_fn, iters=20, warmup=3)
        ops = 5.0 * x.numel()
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"time {kname} {name} x={tuple(shape)} {dtn} {kind}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms ({note}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} "
              f"B), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s = "
              f"{100 * bound_ms / ms:.1f}% of the bound [{smi}]", flush=True)
        if kname not in rows:
            rows[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=lib_ms)
        del x, dy, mask
    for kname, replaces in SOFTMAX_REPLACES.items():
        entries.append(dict(
            name=kname, route="cuda", source=SOFTMAX_SOURCE,
            replaces=replaces, launches=0, max_abs_err=worst[kname],
            atol=(SOFTMAX_FWD_ATOL["bf16"] if kname != "softmax_bwd"
                  else SOFTMAX_BWD_ATOL), rtol=SOFTMAX_RTOL["bf16"],
            **rows[kname]))
    return entries


def _unfused_attention(fsm, q, k, v, mask):
    """Megatron's core attention around the fused softmax: bf16 scores
    ``q @ k^T``, ``FusedScaleMaskSoftmax`` (scale 1/sqrt(d)), ``@ v``."""
    import torch
    return torch.matmul(fsm(torch.matmul(q, k.transpose(-1, -2)), mask), v)


def _attn_grads(fn, q, k, v, do):
    import torch
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = fn(qq, kk, vv)
        grads = torch.autograd.grad(out, (qq, kk, vv), do)
    return (out.detach(),) + grads


def softmax_attention_phase(dev, smi: str, entries: list) -> None:
    """``FusedScaleMaskSoftmax`` inside an unfused attention, forward and
    backward, at GPT-2 small's attention (causal, (8, 12, 1024, 64) bf16)
    and BERT-Large's ((8, 16, 512, 64) bf16, the padding mask): warm-up,
    then steps with the launch counts zeroed just before and read just
    after (one softmax_fwd or softmax_masked_fwd and one softmax_bwd a
    step, nothing else of the port's); the output and dq, dk, dv within
    2e-2 of each one's scale of the flash kernels' (causal) or of plain
    f32 attention with the same mask on the alive rows (BERT; dead query
    rows exact zeros); ms per forward + backward and peak memory."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    gen = torch.Generator(device=dev).manual_seed(13)
    total = {name: 0 for name in SOFTMAX_REPLACES}
    for name, (b, h, s, d), causal in (("gpt2_small", GPT_ATTN, True),
                                       ("bert_large", BERT_ATTN, False)):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        fsm = FusedScaleMaskSoftmax(
            input_in_bf16=True, scale=scale,
            attn_mask_type=(AttnMaskType.causal if causal
                            else AttnMaskType.padding))
        mask = None if causal else _bert_padding_mask(b, s, s, dev)
        if mask is not None:         # dead query rows get no gradient
            alive = ~mask.all(dim=-1, keepdim=True)
            do = do * alive
        fn = lambda q_, k_, v_: _unfused_attention(fsm, q_, k_, v_, mask)
        for _ in range(SOFTMAX_PATH["warmup"]):
            _attn_grads(fn, q, k, v, do)
        torch.cuda.synchronize()
        steps = SOFTMAX_PATH["steps"]
        _build.reset_launch_counts()
        for _ in range(steps):
            got = _attn_grads(fn, q, k, v, do)
        torch.cuda.synchronize()
        launches = {kk.name: kk.launches for kk in _build.KERNELS}
        want = {kk.name: 0 for kk in _build.KERNELS}
        want.update({"softmax_bwd": steps,
                     ("softmax_fwd" if causal else "softmax_masked_fwd"):
                     steps})
        _check(launches == want, f"softmax attention {name}: launches "
                                 f"{launches}, expected {want}")
        for kname in total:
            total[kname] += launches[kname]
        _check(all(bool(torch.isfinite(t).all()) for t in got),
               f"softmax attention {name}: non-finite output or gradient")
        if causal:
            ref = _attn_grads(lambda q_, k_, v_: attn.flash_attention(
                q_, k_, v_, causal=True, scale=scale), q, k, v, do)
            against = "the flash kernels"
        else:
            def plain(q_, k_, v_):
                sc = torch.matmul(q_.float(), k_.float().transpose(-1, -2))
                p = torch.softmax((sc * scale).masked_fill(mask, -10000.0),
                                  dim=-1)
                return torch.matmul(p, v_.float())
            ref = _attn_grads(plain, q, k, v, do.float())
            against = "plain f32 attention with the mask"
            dead = (~alive).expand_as(got[0])
            _check(bool(torch.all(got[0][dead] == 0)),
                   f"softmax attention {name}: a dead query row is not 0")
        errs = []
        for gname, g, w in zip(("o", "dq", "dk", "dv"), got, ref):
            diff = (g.float() - w.float()).abs()
            if not causal and gname == "o":
                diff = diff * alive      # dead rows: zeros here, mean(v) there
            err, sc = float(diff.max()), float(w.float().abs().max())
            _check(err <= SOFTMAX_PATH["tol"] * sc,
                   f"softmax attention {name} {gname}: max_abs_err {err} "
                   f"over {SOFTMAX_PATH['tol']} x scale {sc} against "
                   f"{against}")
            errs.append(f"{gname} {err:.3e} (scale {sc:.3e})")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _attn_grads(fn, q, k, v, do)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        ms = _ms(lambda: _attn_grads(fn, q, k, v, do), iters=5, warmup=1)
        print(f"path softmax attention {name} q=({b}, {h}, {s}, {d}) bf16 "
              f"{'causal' if causal else 'padding mask'}: "
              f"FusedScaleMaskSoftmax in q@k^T -> softmax -> @v, "
              f"{ms:.4f} ms per forward + backward, peak "
              f"{peak:.1f} MiB above the inputs; against {against}: "
              f"{', '.join(errs)} (limit {SOFTMAX_PATH['tol']} x scale); "
              f"launches {dict((kk, launches[kk]) for kk in total)} in "
              f"{steps} steps [{smi}]", flush=True)
        del q, k, v, do, got, ref
    for e in entries:
        e["launches"] = total[e["name"]]


# ---------------------------------------------------------------------------
# the fused cross entropy on its gate (xent_fwd, xent_bwd), BERT at vocab
# 30592 and the example's proxy; Welford and SyncBatchNorm at world size 1
# ---------------------------------------------------------------------------

_XE = "apex_tpu/ops/xentropy.py"
XENT_SOURCE = "apex_tpu_torch/csrc/xentropy.cu"
WELFORD_SOURCE = "apex_tpu_torch/csrc/welford.cu"
SLICE8_REPLACES = {
    "xent_fwd": f"{_XE}:115 (_xent_fwd :103, body _fwd_kernel :47)",
    "xent_bwd": f"{_XE}:141 (_xent_bwd :129, body _bwd_kernel :64)",
    "welford_mean_var": "apex_tpu/ops/welford.py:83 (welford_mean_var :70, "
                        "body _welford_kernel :43)",
}
XENT_CASES = (
    # name, rows, C, logits dtype, half_to_float
    ("bert_large_30592", 4096, 30592, "f32", False),  # BERT-L, Megatron's vocab
    ("gpt2_50304_h2f", 8192, 50304, "bf16", True),    # GPT-2's, padded alike
    ("edge_65536", 64, 65536, "f32", False),          # the gate's edge
)
# the kernels against their plain versions: f32 losses and lse within
# rtol 1e-5 (the kernel rescales its sum of exponentials online), dx
# within 1e-6 of max |dx| (the same formula, exp rounding apart); losses
# in bf16 within one rounding
XENT_RTOL = 1e-5
XENT_DX_ATOL = 1e-6
HALF_RTOL = 2.0 ** -7
XENT_VOCAB = 30592          # bert-large-uncased's 30522 padded to 128
BERT_XENT = dict(warmup=2, steps=4)
PROXY = dict(steps=3, batch=2, seq=128)
PROXY_LAMB = dict(eps=1e-4)
PROXY_FIRST_LOSS_RTOL = 1e-4
WELFORD_CASES = (
    # name, rows, C, dtype, mean: ResNet-50's BatchNorm inputs under
    # --sync-bn at batch 128 and 224x224, a ragged row count, a large mean
    # (300 + 0.05 noise, tests/test_parallel.py's case)
    ("r50_401408x256_bf16", 401408, 256, "bf16", 0.0),
    ("r50_401408x256_f32", 401408, 256, "f32", 0.0),
    ("r50_100352x512_f32", 100352, 512, "f32", 0.0),
    ("r50_6272x2048_f32", 6272, 2048, "f32", 0.0),
    ("ragged_100001x384_bf16", 100001, 384, "bf16", 0.0),
    ("large_mean_50000x256_f32", 50000, 256, "f32", 300.0),
)
WELFORD_ROW = "r50_401408x256_f32"     # the kernels line's (SyncBN's dtype)
WELFORD_TOL = dict(mean=(1e-6, 1e-5), var=(1e-5, 1e-4))   # (atol, rtol)
SYNCBN = dict(warmup=2, steps=4)


def _xent_inputs(gen, n, c, dtn, dev):
    """Logits 2 x normal, labels uniform in [0, C) with -1, C and C + 5
    on the first three rows, dy normal."""
    import torch
    x = (torch.randn(n, c, generator=gen, device=dev) * 2).to(_dtype(dtn))
    labels = torch.randint(0, c, (n,), generator=gen, device=dev)
    labels[:3] = torch.tensor([-1, c, c + 5], device=dev)
    dy = torch.randn(n, generator=gen, device=dev)
    return x, labels, dy


def xent_kernel_phase(dev, smi: str) -> list:
    """xent_fwd and xent_bwd against their plain versions on the card at
    BERT-L's (4096, 30592) f32 MLM logits, GPT-2's (8192, 50304) bf16 with
    ``half_to_float`` and the gate's edge (64, 65536), label smoothing 0
    and 0.1, labels -1, C and C + 5 with no target term; the same bits on
    a second run; each case timed beside the plain version, the bytes
    bound and ``F.cross_entropy`` (forward)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import xentropy as tx

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20)
    worst = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    rows = {}
    for name, n, c, dtn, h2f in XENT_CASES:
        for s in (0.0, 0.1):
            x, labels, dy = _xent_inputs(gen, n, c, dtn, dev)
            before = (tx.XENT_FWD.launches, tx.XENT_BWD.launches)
            loss, lse = tx._xent_fwd_cuda(x, labels, s, h2f)
            dyl = dy.to(loss.dtype)
            dx = tx._xent_bwd_cuda(x, labels, lse, dyl, s, h2f)
            torch.cuda.synchronize()
            _check((tx.XENT_FWD.launches, tx.XENT_BWD.launches)
                   == (before[0] + 1, before[1] + 1),
                   f"xent {name}: one launch of each kernel expected")
            want_loss, want_lse = tx.xent_fwd_ref(x, labels, s, h2f)
            want_dx = tx.xent_bwd_ref(x, labels, lse, dyl, s, h2f)
            what = f"{name} ({n}, {c}) {dtn} h2f={h2f} s={s}"
            half = loss.dtype != torch.float32
            rtol = HALF_RTOL if half else XENT_RTOL
            e_loss = _held("xent_fwd", loss, want_loss, XENT_RTOL, rtol,
                           "loss " + what)
            e_lse = _held("xent_fwd", lse, want_lse, XENT_RTOL, XENT_RTOL,
                          "lse " + what)
            scale = float(want_dx.float().abs().max())
            e_dx = _held("xent_bwd", dx, want_dx, XENT_DX_ATOL * scale,
                         HALF_RTOL if half else 0.0, "dx " + what)
            xf = x[:3].float()
            no_target = torch.logsumexp(xf, 1) - s * xf.mean(1)
            _held("xent_fwd", loss[:3], no_target.to(loss.dtype), XENT_RTOL,
                  rtol, "labels -1, C, C + 5 (no target term) " + what)
            again = tx._xent_fwd_cuda(x, labels, s, h2f)
            _check(bool(torch.equal(again[0], loss)
                        and torch.equal(again[1], lse)
                        and torch.equal(tx._xent_bwd_cuda(
                            x, labels, lse, dyl, s, h2f), dx)),
                   f"xent {what}: the result differs run to run")
            if name == XENT_CASES[0][0]:
                worst["xent_fwd"] = max(worst["xent_fwd"], e_loss, e_lse)
                worst["xent_bwd"] = max(worst["xent_bwd"], e_dx)
            print(f"kernel xent {what}: max_abs_err loss {e_loss:.3e}, lse "
                  f"{e_lse:.3e} (rtol {XENT_RTOL:g}"
                  f"{f', {HALF_RTOL:g} in {loss.dtype}' if half else ''}), "
                  f"dx {e_dx:.3e} (atol {XENT_DX_ATOL:g} x max|dx| "
                  f"{scale:.3e}); labels -1, C, C + 5 without a target "
                  "term; the same bits on a second run", flush=True)
            del again, want_loss, want_lse, want_dx
            if s == 0.0:
                del x, labels, dy, loss, lse, dx
                continue
            elt, out = x.element_size(), loss.element_size()
            valid = labels.clamp(0, c - 1)
            calls = {
                "xent_fwd": (lambda: tx._xent_fwd_cuda(x, labels, s, h2f),
                             lambda: tx.xent_fwd_ref(x, labels, s, h2f),
                             lambda: F.cross_entropy(
                                 x, valid, reduction="none",
                                 label_smoothing=s),
                             n * c * elt + n * (8 + out + 4)),
                "xent_bwd": (lambda: tx._xent_bwd_cuda(x, labels, lse, dyl,
                                                       s, h2f),
                             lambda: tx.xent_bwd_ref(x, labels, lse, dyl, s,
                                                     h2f),
                             None, n * c * (elt + out) + n * (8 + 4 + 4))}
            for kname, (kern, plain, lib, nbytes) in calls.items():
                ms = _ms(kern, iters=20, warmup=3)
                plain_ms = _ms(plain, iters=5, warmup=1)
                lib_ms = _ms(lib, iters=20, warmup=3) if lib else None
                bound_ms, bound_by = _bound(nbytes, 5.0 * n * c)
                note = ("F.cross_entropy(reduction='none', label_smoothing), "
                        "labels clamped into [0, C)" if lib else
                        "no one PyTorch call computes softmax minus the "
                        "smoothed one-hot from a saved lse: autograd's "
                        "cross-entropy backward is nll_loss_backward, then "
                        "_log_softmax_backward_data")
                print(f"time {kname} {what}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, library "
                      f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                      f"({note}), bound {bound_ms:.4f} ms ({bound_by}: "
                      f"{nbytes} B), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s ="
                      f" {100 * bound_ms / ms:.1f}% of the bound [{smi}]",
                      flush=True)
                if name == XENT_CASES[0][0]:
                    rows[kname] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=lib_ms)
            del x, labels, dy, loss, lse, dx, valid, calls
            torch.cuda.empty_cache()
    print(f"phase xent kernels {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return [dict(name=k, route="cuda", source=XENT_SOURCE,
                 replaces=SLICE8_REPLACES[k], launches=0,
                 max_abs_err=worst[k],
                 atol=XENT_RTOL if k == "xent_fwd" else XENT_DX_ATOL,
                 rtol=XENT_RTOL if k == "xent_fwd" else 0.0, **rows[k])
            for k in ("xent_fwd", "xent_bwd")]


def bert_xent_train_phase(dev, smi: str, params, entries: list) -> None:
    """BERT-L at Megatron's padded vocabulary, 30592 (on the cross
    entropy's gate), amp O2, FusedLAMB, the example's unmasked 8 x 512
    batch: the earlier phases' weights with the word embedding padded by
    64 rows from seed 5, 2 warm-up and 4 timed steps, exact launch counts
    (one xent_fwd and one xent_bwd a step)."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain
    from apex_tpu_torch.models import bert_large

    t_phase = time.perf_counter()
    emb = params["embed"]["weight"]
    pad = torch.randn(XENT_VOCAB - emb.shape[0], emb.shape[1],
                      generator=torch.Generator().manual_seed(5)) * 0.02
    padded = dict(params, embed=dict(params["embed"],
                                     weight=torch.cat([emb, pad])))
    model = bert_large(dtype=torch.bfloat16, max_seq_len=BERT["seq"],
                       vocab_size=XENT_VOCAB)
    torch.cuda.reset_peak_memory_stats(dev)
    opt, state, step = bert_setup(model, padded, dev)
    del padded
    inputs, real, _ = pretrain.synthetic_batch(XENT_VOCAB, BERT["batch"],
                                               BERT["seq"], False, dev)
    for _ in range(BERT_XENT["warmup"]):
        loss, state = step(state, **inputs)
    torch.cuda.synchronize()
    steps = BERT_XENT["steps"]
    _build.reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        loss, state = step(state, **inputs)
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    losses = [float(v) for v in losses]
    _check(all(math.isfinite(v) for v in losses),
           f"bert xent train: non-finite loss {losses}")
    want = _bert_launches_expected(steps, len(opt._plan.buckets),
                                   flash=True, xent=True)
    _check(launches == want, f"bert xent train: launches {launches}, "
                             f"expected {want}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"train bert-large vocab {XENT_VOCAB} O2 FusedLAMB b{BERT['batch']}"
          f" s{BERT['seq']} unmasked (the cross entropy on its gate): "
          f"{steps} timed steps after {BERT_XENT['warmup']} warm-up, "
          f"{1e3 * wall / steps:.2f} ms/step (host clock), device ms/step "
          f"{[round(v, 2) for v in step_ms]} (CUDA events between steps, "
          f"sorted), {real * steps / wall:.1f} real tokens/s, losses "
          f"{[round(v, 4) for v in losses]}, peak device memory {peak:.2f} "
          f"GiB, launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    for e in entries:
        e["launches"] = launches[e["name"]]


def bert_proxy_phase(dev, smi: str) -> None:
    """The example's default proxy (4 x h128, vocab 2048: on the cross
    entropy's gate) trains 3 steps on the card through ``train()`` with
    exact launch counts; then one O0 FusedLAMB step (eps 1e-4) of the
    proxy on a packed 2 x 128 batch (labels -1 on padding) on the card
    and on the CPU from one seed: the first loss within rtol 1e-4 (f32
    on both), the params within a tenth of the nearest of three wrong
    updates run on the CPU (label smoothing 0.1, the padding not masked,
    lr 4% high).  Also the proxy's device ms a step
    (``tools/bert_proxy_step.py``) and its flash bodies at D 32 by name;
    the card's O0 step launches each f32 flash kernel once a layer, on the
    D-32 register-tile bodies (``PROXY_F32_FLASH_BODIES``, read from the
    device kernels' names in a profiled step).  Returns the flash
    kernels' launches in the 3 steps, and as "flash_fwd_f32",
    "flash_dq_f32" and "flash_dkv_f32" the f32 ones in the card's O0
    step."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch._tree import tree_leaves
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain
    from apex_tpu_torch.tools import bert_proxy_step as proxy_step

    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    res = pretrain.train(steps=PROXY["steps"], device=dev, log=None)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS}
    _check(all(math.isfinite(v) for v in res.losses),
           f"bert proxy: non-finite loss {res.losses}")
    model = pretrain.model_for(False, PROXY["seq"], "O0")
    want = _bert_launches_expected(PROXY["steps"],
                                   len(res.opt._plan.buckets),
                                   layers=model.num_layers, flash=True,
                                   xent=True)
    _check(launches == want, f"bert proxy: launches {launches}, expected "
                             f"{want}")
    # the step again (tools/bert_proxy_step.py): its device ms, and the
    # device names of its flash kernels under the profiler (a session may
    # lose a record, so the counts are the counters' above)
    step = proxy_step.measure(dev)
    for kn, body in PROXY_FLASH_BODIES.items():
        names = step["flash"][kn][1]
        _check(names and all(body in n for n in names),
               f"bert proxy profiled step: {kn} ran {names}, expected "
               f"{body}")
    device = ("not measured" if step["device_ms"] is None
              else f"{step['device_ms']:.3f}")
    print(f"train bert proxy ({model.num_layers} x h{model.hidden_size}, "
          f"vocab {model.vocab_size}) O2 b8 s512 on the card: losses "
          f"{[round(v, 4) for v in res.losses]}, "
          f"{res.tokens_per_sec:.1f} tokens/s over the steps after the "
          f"first, launches {launches}; device ms a step {device} (CUDA "
          f"events around {proxy_step.STEPS} steps queued behind a device "
          f"spin), host pace {float(np.median(step['pace_ms'])):.3f} ms a "
          f"step (CUDA events between steps), {step['busy_ms']:.3f} ms busy "
          "in a profiled step, of which attention "
          f"{sum(ms for ms, _ in step['flash'].values()):.3f} ("
          + ", ".join(f"{kn} {step['flash'][kn][0]:.3f} ms on {body}"
                      for kn, body in PROXY_FLASH_BODIES.items())
          + f") [{smi}]", flush=True)

    params = model.init(0, "cpu")
    init = [t.numpy() for t in tree_leaves(params)]
    batch, real, _ = pretrain.synthetic_batch(model.vocab_size,
                                              PROXY["batch"], PROXY["seq"],
                                              True, "cpu")
    real_loss = pretrain.softmax_cross_entropy_loss

    def run(device, lr=1e-3, **loss_kw):
        def loss(logits, labels, smoothing=0.0, padding_idx=0,
                 half_to_float=False):
            kw = dict(smoothing=smoothing, padding_idx=padding_idx,
                      half_to_float=half_to_float)
            return real_loss(logits, labels, **{**kw, **loss_kw})
        pretrain.softmax_cross_entropy_loss = loss
        try:
            opt, state, step = pretrain.setup(
                model, params, device, opt_level="O0", lr=lr, **PROXY_LAMB)
            out, _ = step(state, **{k: t.to(device)
                                    for k, t in batch.items()})
            value = float(out)
        finally:
            pretrain.softmax_cross_entropy_loss = real_loss
        return value, [p.float().cpu().numpy()
                       for p in tree_leaves(opt.params)]

    from torch.profiler import ProfilerActivity, profile
    _build.reset_launch_counts()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _prime_profiler()
    card_l, card_p = run(dev)
    torch.cuda.synchronize()
    prof.stop()
    counts = {k.name: k.launches for k in _build.KERNELS}
    f32_flash = {kn: counts[kn] for kn in PROXY_F32_FLASH_BODIES}
    _check(f32_flash == dict.fromkeys(PROXY_F32_FLASH_BODIES,
                                      model.num_layers),
           f"bert proxy O0 step: f32 flash launches {f32_flash}, expected "
           f"{model.num_layers} of each")
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "flash_" in e.name]
    del prof
    for kn, body in PROXY_F32_FLASH_BODIES.items():
        seen = [n for n in names if FLASH_SYMS[kn] in n]
        _check(seen and all(body in n for n in seen),
               f"bert proxy O0 step: {kn} ran {seen}, expected {body}")
    print(f"route bert proxy O0 step (f32, D 32): launches {f32_flash}, "
          + ", ".join(f"{kn} on {body}" for kn, body in
                      PROXY_F32_FLASH_BODIES.items()), flush=True)
    cpu_l, cpu_p = run("cpu")
    mutants = {"label smoothing 0.1": run("cpu", smoothing=0.1)[1],
               "padding not masked": run("cpu", padding_idx=-2)[1],
               "lr 4% high": run("cpu", lr=1.04e-3)[1]}
    gaps = {k: _gap(v, cpu_p, init) for k, v in mutants.items()}
    limit = min(gaps.values()) / MUTANT_FACTOR
    rel0 = abs(card_l - cpu_l) / abs(cpu_l)
    gap = _gap(card_p, cpu_p, init)
    print(f"consistency train bert proxy O0 FusedLAMB (eps 1e-4) packed b"
          f"{PROXY['batch']} s{PROXY['seq']} ({real} real tokens, labels -1 "
          f"on padding), 1 step: card loss {card_l:.6f}, cpu {cpu_l:.6f} "
          f"(rel diff {rel0:.3e}, tol {PROXY_FIRST_LOSS_RTOL}); params' gap "
          f"{gap:.3e} of their displacement, tol {limit:.3e} = the nearest "
          f"wrong update / {MUTANT_FACTOR:g}; wrong updates on the cpu "
          "(gap): " + ", ".join(f"{k} {g:.3e}" for k, g in gaps.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    _check(rel0 <= PROXY_FIRST_LOSS_RTOL,
           f"bert proxy consistency: first loss differs by {rel0}")
    _check(gap <= limit, f"bert proxy consistency: params' gap {gap} over "
                         f"{limit}")
    return dict({k: launches[k] for k in ("flash_fwd", "flash_dq",
                                          "flash_dkv")},
                **{f"{kn}_f32": n for kn, n in f32_flash.items()})


# the BERT proxy's flash bodies at its D 32, bf16: all three on the tensor
# cores (the device kernels' names)
PROXY_FLASH_BODIES = {"flash_fwd": "flash_fwd_kernel_tc<32, false>",
                      "flash_dkv": "flash_dkv_kernel_tc<32, false>",
                      "flash_dq": "flash_dq_kernel_tc<32, false>"}
# and its f32 bodies at --opt-level O0: all three in register tiles
PROXY_F32_FLASH_BODIES = {
    "flash_fwd": "flash_fwd_kernel_wide<float, 32, false>",
    "flash_dq": "flash_dq_kernel_wide<float, 32, false>",
    "flash_dkv": "flash_dkv_kernel_wide<float, 64, 32, false>"}


def welford_kernel_phase(dev, smi: str) -> dict:
    """welford_mean_var against its plain version on the card at
    ResNet-50's BatchNorm inputs under --sync-bn (batch 128, 224x224), a
    ragged row count and a large mean (mean and var within the
    reference's tolerances, the count exact, the same bits on a second
    run; at the large mean both against an f64 evaluation); off the gate
    the plain version and no launch; each case timed beside the plain
    version, the bytes bound and ``torch.var_mean`` (f32 input)."""
    import torch
    from apex_tpu_torch.ops import welford as tw

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    worst, row = 0.0, None
    for name, n, c, dtn, mean in WELFORD_CASES:
        noise = torch.randn(n, c, generator=gen, device=dev)
        x = (mean + (0.05 if mean else 1.0) * noise).to(_dtype(dtn))
        del noise
        before = tw.WELFORD.launches
        got = tw.welford_mean_var(x)
        torch.cuda.synchronize()
        _check(tw.WELFORD.launches == before + 1,
               f"welford {name}: one launch expected")
        want = tw.welford_mean_var_ref(x)
        what = f"{name} ({n}, {c}) {dtn}"
        e_mean = _held("welford_mean_var", got[0], want[0],
                       *WELFORD_TOL["mean"], "mean " + what)
        e_var = _held("welford_mean_var", got[1], want[1],
                      *WELFORD_TOL["var"], "var " + what)
        _check(got[2].shape == () and float(got[2]) == float(want[2]) == n,
               f"welford {what}: count {float(got[2])}, expected {n}")
        again = tw.welford_mean_var(x)
        _check(all(bool(torch.equal(a, b)) for a, b in zip(again, got)),
               f"welford {what}: the result differs run to run")
        worst = max(worst, e_mean, e_var)
        f64 = ""
        if mean:
            xd = x.double()
            md, vd = xd.mean(0), xd.var(0, unbiased=False)
            f64 = (f"; against f64: var rel err kernel "
                   f"{float(((got[1].double() - vd).abs() / vd).max()):.3e}, "
                   f"plain "
                   f"{float(((want[1].double() - vd).abs() / vd).max()):.3e};"
                   f" mean abs err kernel "
                   f"{float((got[0].double() - md).abs().max()):.3e}, plain "
                   f"{float((want[0].double() - md).abs().max()):.3e}")
            del xd, md, vd
        print(f"kernel welford {what}: max_abs_err mean {e_mean:.3e} (atol "
              f"{WELFORD_TOL['mean'][0]:g}, rtol {WELFORD_TOL['mean'][1]:g}),"
              f" var {e_var:.3e} (atol {WELFORD_TOL['var'][0]:g}, rtol "
              f"{WELFORD_TOL['var'][1]:g}), count {int(got[2])} exact; the "
              f"same bits on a second run{f64}", flush=True)
        nbytes = n * c * x.element_size() + 8 * c + 4
        ms = _ms(lambda: tw.welford_mean_var(x), iters=20, warmup=3)
        plain_ms = _ms(lambda: tw.welford_mean_var_ref(x), iters=5, warmup=1)
        lib_ms = (_ms(lambda: torch.var_mean(x, 0, correction=0), iters=20,
                      warmup=3) if dtn == "f32" else None)
        bound_ms, bound_by = _bound(nbytes, 4.0 * n * c)
        print(f"time welford_mean_var {what}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'} "
              f"(torch.var_mean(x, 0, correction=0)"
              f"{'' if lib_ms is not None else ': timed on f32 input only'}),"
              f" bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B), "
              f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s = "
              f"{100 * bound_ms / ms:.1f}% of the bound [{smi}]", flush=True)
        if name == WELFORD_ROW:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms)
        del x, got, want, again
        torch.cuda.empty_cache()
    x = torch.randn(1000, 64, generator=gen, device=dev)
    before = tw.WELFORD.launches
    got = tw.welford_mean_var(x)
    plain = tw.welford_mean_var_ref(x)
    _check(tw.WELFORD.launches == before
           and all(bool(torch.equal(a, b)) for a, b in zip(got, plain)),
           "welford off the gate (C = 64): a launch, or not the plain "
           "version's bits")
    print(f"kernel welford off the gate (1000, 64): the plain version's "
          f"bits, no launch; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(name="welford_mean_var", route="cuda", source=WELFORD_SOURCE,
                replaces=SLICE8_REPLACES["welford_mean_var"], launches=0,
                max_abs_err=worst, atol=WELFORD_TOL["var"][0],
                rtol=WELFORD_TOL["var"][1], **row)


def _syncbn_run(dev, sync_bn: bool):
    """ResNet-50 O2 b128 224 grad_accum 2: 2 warm-up and 4 timed steps
    (host clock from a sync after the second step, CUDA events between
    steps), exact launch counts over all six."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp

    events, clock = [], {}
    warm, steps = SYNCBN["warmup"], SYNCBN["steps"]

    def on_step(step):
        if step == warm - 1:
            torch.cuda.synchronize()
            clock["t0"] = time.perf_counter()
        if step >= warm - 1:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    _build.reset_launch_counts()
    res = main_amp.train(device=dev, grad_accum=ACCUM, steps=warm + steps,
                         log=None, on_step=on_step, sync_bn=sync_bn, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - clock["t0"]
    launches = {k.name: k.launches for k in _build.KERNELS}
    _check(all(math.isfinite(v) for v in res.losses),
           f"syncbn train (sync_bn={sync_bn}): non-finite loss {res.losses}")
    n = warm + steps
    want = {k.name: 0 for k in _build.KERNELS}
    want.update({"flat_accumulate": ACCUM * n, "flat_unscale_norm": n,
                 "flat_sgd": n})
    _check(launches == want, f"syncbn train (sync_bn={sync_bn}): launches "
                             f"{launches}, expected {want}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return res, wall / steps, step_ms, launches


def syncbn_train_phase(dev, smi: str, entry: dict) -> None:
    """ResNet-50 amp O2 with ``--sync-bn`` at world size 1 (batch 128 at
    224x224, grad_accum 2) in turns with plain BatchNorm in the same call;
    the public ``welford_mean_var`` held on every SyncBatchNorm input of
    one forward against SyncBatchNorm's own f32 statistics; a card-vs-CPU
    SyncBN ResNet-18 O0 step: the params within a tenth of lr 4% high,
    the running statistics within a tenth of a biased running variance,
    both wrong updates run on the CPU."""
    import functools
    import torch
    from apex_tpu_torch._tree import tree_leaves, tree_map
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp
    from apex_tpu_torch.models import resnet18, resnet50
    from apex_tpu_torch.ops import welford as tw
    from apex_tpu_torch.parallel import SyncBatchNorm
    from apex_tpu_torch.parallel import sync_batchnorm as sbn

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = {True: [], False: []}
    for sync_bn in (True, False, True, False):
        res, sec, step_ms, launches = _syncbn_run(dev, sync_bn)
        ms[sync_bn].append(1e3 * sec)
        print(f"train resnet50 O2 b{res.batch} {res.image} grad_accum "
              f"{ACCUM} "
              f"{'--sync-bn (world size 1)' if sync_bn else 'BatchNorm'}: "
              f"{SYNCBN['steps']} timed steps after {SYNCBN['warmup']} "
              f"warm-up, {1e3 * sec:.2f} ms/step (host clock), "
              f"{res.batch / sec:.1f} imgs/s, device ms/step "
              f"{[round(v, 2) for v in step_ms]} (CUDA events, sorted), "
              f"losses {[round(v, 4) for v in res.losses]}, launches "
              f"{launches} [{smi}]", flush=True)
    batch = TRAIN["batch"]
    print(f"train summary --sync-bn vs BatchNorm (in turns): ms/step "
          f"{[round(v, 2) for v in ms[True]]} vs "
          f"{[round(v, 2) for v in ms[False]]}, imgs/s "
          f"{[round(1e3 * batch / v, 1) for v in ms[True]]} vs "
          f"{[round(1e3 * batch / v, 1) for v in ms[False]]}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)

    # the public op on each SyncBatchNorm input of one forward
    real_stats, seen = sbn.sync_batch_norm_stats, []

    def checked(xc, group=None):
        mean, var, n = real_stats(xc, group)
        gate = tw._use_pallas(xc.shape[1])
        before = tw.WELFORD.launches
        got = tw.welford_mean_var(xc)
        what = f"SyncBatchNorm input {tuple(xc.shape)} {xc.dtype}"
        _check(tw.WELFORD.launches == before + int(gate),
               f"welford on the {what}: launches")
        e_m = _held("welford_mean_var", got[0], mean, *WELFORD_TOL["mean"],
                    "mean of the " + what)
        e_v = _held("welford_mean_var", got[1], var, *WELFORD_TOL["var"],
                    "var of the " + what)
        _check(float(got[2]) == float(n), f"welford count on the {what}")
        seen.append((tuple(xc.shape), gate, e_m, e_v))
        return mean, var, n

    model = resnet50(norm_cls=functools.partial(SyncBatchNorm,
                                                channel_last=False))
    params, stats = model.init(0, dev)
    x = torch.randn(batch, TRAIN["image"], TRAIN["image"], 3,
                    generator=torch.Generator(device=dev).manual_seed(22),
                    device=dev).to(torch.bfloat16)
    sbn.sync_batch_norm_stats = checked
    try:
        with torch.no_grad():
            model.apply(params, stats, x, train=True)
        torch.cuda.synchronize()
    finally:
        sbn.sync_batch_norm_stats = real_stats
    on = sum(1 for s in seen if s[1])
    print(f"welford_mean_var on the {len(seen)} SyncBatchNorm inputs of one "
          f"resnet50 forward (b{batch} {TRAIN['image']}, bf16 data, f32 "
          f"model): {on} on the gate (the kernel), {len(seen) - on} off it "
          f"(C = 64: the plain version); max_abs_err mean "
          f"{max(s[2] for s in seen):.3e}, var {max(s[3] for s in seen):.3e}"
          f" against SyncBatchNorm's own statistics; shapes "
          f"{sorted({s[0] for s in seen})}", flush=True)
    del model, params, stats, x
    torch.cuda.empty_cache()

    # card vs CPU: one O0 step of a SyncBN ResNet-18
    class BiasedRunningVar(SyncBatchNorm):
        """The wrong update: the running variance takes the biased batch
        variance (n / (n - 1) dropped)."""

        def running_update(self, stats, mean, var, n):
            return super().running_update(stats, mean, var,
                                          torch.full_like(n, 1e30))

    rp, rs = resnet18(norm_cls=SyncBatchNorm).init(CONSIST["seed"], "cpu")
    init_p = [t.numpy() for t in tree_leaves(rp)]
    init_s = [t.numpy() for t in tree_leaves(rs)]

    def run(device, lr=0.01, norm=None):
        var = tuple(tree_map(lambda t: t.to(device), v) for v in (rp, rs))
        real_norm = main_amp.SyncBatchNorm
        if norm is not None:
            main_amp.SyncBatchNorm = norm
        try:
            res = main_amp.train(device=device, opt_level="O0", steps=1,
                                 variables=var, sync_bn=True, lr=lr,
                                 **CONSIST)
        finally:
            main_amp.SyncBatchNorm = real_norm
        return ([p.float().cpu().numpy() for p in tree_leaves(res.opt.params)],
                [s.float().cpu().numpy()
                 for s in tree_leaves(res.batch_stats)], res.losses[0])

    card_p, card_s, card_l = run(dev)
    cpu_p, cpu_s, cpu_l = run("cpu")
    lr_p = run("cpu", lr=0.0104)[0]
    biased_s = run("cpu", norm=BiasedRunningVar)[1]
    p_gap, s_gap = _gap(card_p, cpu_p, init_p), _gap(card_s, cpu_s, init_s)
    p_lim = _gap(lr_p, cpu_p, init_p) / MUTANT_FACTOR
    s_lim = _gap(biased_s, cpu_s, init_s) / MUTANT_FACTOR
    rel0 = abs(card_l - cpu_l) / abs(cpu_l)
    print(f"consistency train resnet18 --sync-bn O0 lr 0.01 b8 64x64 "
          f"grad_accum 2, 1 step: loss card {card_l:.6f}, cpu {cpu_l:.6f} "
          f"(rel diff {rel0:.3e}, tol {FIRST_LOSS_RTOL}); params' gap "
          f"{p_gap:.3e} of their displacement (tol {p_lim:.3e} = lr 4% high "
          f"/ {MUTANT_FACTOR:g}); running statistics' gap {s_gap:.3e} of "
          f"their displacement (tol {s_lim:.3e} = a biased running variance"
          f" / {MUTANT_FACTOR:g}); phase {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    _check(rel0 <= FIRST_LOSS_RTOL,
           f"syncbn consistency: first loss differs by {rel0}")
    _check(p_gap <= p_lim, f"syncbn consistency: params' gap {p_gap} over "
                           f"{p_lim}")
    _check(s_gap <= s_lim, f"syncbn consistency: running statistics' gap "
                           f"{s_gap} over {s_lim}")
    entry["launches"] = 0       # SyncBN's statistics are the plain ones


# ---------------------------------------------------------------------------
# phase 38: amp O1 (the op-list rewrite) and activation offload
# ---------------------------------------------------------------------------

O1_STEPS = 4
# card against CPU at O1: the BERT proxy's first loss (three times its
# reading of 1.6e-4 on an H100), and its first gradient's worst leaf
# (max |card - cpu| over max |cpu|; the BERT O1 CPU test's bound)
O1_FIRST_LOSS_RTOL = 5e-4
# ResNet-18's first loss at O1: a few times the card's reading of 7.4e-4
# (the CPU's own one-ulp spread reads 8.1e-4)
O1_RESNET_FIRST_LOSS_RTOL = 2e-3
O1_GRAD_LEAF_TOL = 5e-2
O1_SPREAD_FACTOR = 3.0           # ResNet at O1: see o1_consistency_phase
O1_BERT_STEPS = 3
DCGAN_STEPS = 5
OFFLOAD_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_offload.py:16


def _is_conv(name: str) -> bool:
    return any(s in name for s in ("fprop", "dgrad", "wgrad", "conv"))


def o1_resnet_phase(dev, smi: str, o2: dict) -> dict:
    """ResNet-50 at O1, b128 x 224, FusedSGD, ``grad_accum`` 2 and 1: the
    imgs/s and device ms a step beside phase 8's O2, the launches of the
    flat tail, the convolutions' device kernels (bf16 cuDNN ones, not
    phase 10's f32 FFMA ones) from a profiled step, and the host time the
    mode adds: one forward enqueued under ``auto_cast`` against the same
    forward without it, both behind an idle device."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch._tree import tree_leaves
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp
    from apex_tpu_torch.models import resnet50

    cfg = dict(TRAIN, opt_level="O1")
    launches = {}
    for ga in (ACCUM, 1):
        events = []

        def on_step(step):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        _build.reset_launch_counts()
        res = main_amp.train(device=dev, grad_accum=ga, steps=O1_STEPS,
                             log=None, on_step=on_step, **cfg)
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in _build.KERNELS}
        want = {k.name: 0 for k in _build.KERNELS}
        want.update({"flat_accumulate": ga * O1_STEPS if ga > 1 else 0,
                     "flat_unscale_norm": O1_STEPS if ga > 1 else 0,
                     "flat_sgd": O1_STEPS})
        _check(all(math.isfinite(v) for v in res.losses),
               f"O1 train: non-finite loss {res.losses}")
        _check(got == want, f"O1 train grad_accum={ga}: launches {got}, "
                            f"expected {want}")
        _check(all(t.dtype == torch.float32
                   for t in tree_leaves(res.opt.params)),
               "O1 train: the params are not f32")
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        launches[f"resnet50_o1_ga{ga}"] = {k: v for k, v in got.items()
                                           if v}
        o2_line = o2.get(ga, {})
        print(f"train resnet50 O1 batch {res.batch} {res.image}x"
              f"{res.image} grad_accum {ga}: {O1_STEPS} steps, "
              f"{res.imgs_per_sec:.1f} imgs/s over the {O1_STEPS - 1} after "
              f"the first, {1e3 * res.step_seconds:.2f} ms/step (host "
              f"clock), device ms/step median "
              f"{float(np.median(step_ms)):.2f} (CUDA events between "
              f"steps); O2 in phase 8 of this run: "
              f"{o2_line.get('imgs', float('nan')):.1f} imgs/s, "
              f"{o2_line.get('ms', float('nan')):.2f} ms/step (host clock)"
              + (f", device ms/step median {o2_line['device_ms']:.2f}"
                 if "device_ms" in o2_line else "")
              + f"; losses {[round(v, 4) for v in res.losses]}, launches "
              f"{launches[f'resnet50_o1_ga{ga}']} [{smi}]", flush=True)

    # one profiled O1 step (the second of two, as phase 10 profiles O2):
    # the convolutions' device kernels and the device's busy time
    wall, by_name = _profile_second_step(dev, **dict(cfg, grad_accum=1))
    busy = sum(t for t, _ in by_name.values()) / 1e3
    convs = collections.Counter({n: c for n, (_, c) in by_name.items()
                                 if _is_conv(n)})
    f32 = {n: c for n, c in convs.items()
           if "f32f32_f32f32" in n or "ffma" in n or "<float," in n
           or "engine<float" in n}
    bf16 = {n: c for n, c in convs.items() if "bf16" in n}
    conv_ms = sum(by_name[n][0] for n in convs) / 1e3
    print(f"profile resnet50 O1 b128 grad_accum 1 (the second of 2 steps): "
          f"wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"{sum(c for _, c in by_name.values())} device kernels; "
          f"{sum(convs.values())} convolution kernels ({conv_ms:.2f} ms), "
          f"of which {sum(bf16.values())} bf16 and {sum(f32.values())} "
          f"f32; top convolutions: "
          + "; ".join(f"{c}x {n[:90]}" for n, c in convs.most_common(4))
          + f" [{smi}]", flush=True)
    for name, (t_us, c) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:8]:
        print(f"profile   {t_us / 1e3:9.3f} ms {c:6d}x {name[:90]}",
              flush=True)
    _check(bf16 and not f32, f"O1 step: convolutions ran f32 kernels "
                             f"{sorted(f32)[:3]}")

    # the host time of the mode: one forward, enqueued behind an idle device
    model = resnet50()
    params, stats = model.init(0, dev)
    x = torch.randn(128, 224, 224, 3, device=dev)
    y = torch.randint(0, 1000, (128,), device=dev)

    def loss_fn(p, bs, xx, yy):
        logits, _ = model.apply(p, bs, xx, train=True)
        return F.cross_entropy(logits.float(), yy.long())

    _, st = amp.initialize(params, opt_level="O1", device=dev)
    wrapped = st.wrap_forward(loss_fn)
    host = {"O1 (auto_cast)": [], "no mode (f32)": []}
    for _ in range(4):
        for what, fn in (("O1 (auto_cast)", wrapped),
                         ("no mode (f32)", loss_fn)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                fn(params, stats, x, y)
            host[what].append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
    med = {k: float(np.median(v[1:])) for k, v in host.items()}
    add = med["O1 (auto_cast)"] - med["no mode (f32)"]
    print(f"host resnet50 forward b128 enqueue (median of 3 after one warm-"
          f"up, device idle at the start): O1 {med['O1 (auto_cast)']:.2f} ms"
          f", no mode {med['no mode (f32)']:.2f} ms: the mode adds "
          f"{add:.2f} ms a forward, {ACCUM * add:.2f} ms a grad_accum-"
          f"{ACCUM} step (the backward runs in the autograd engine, outside "
          f"the mode) [{smi}]", flush=True)
    del params, stats, x, y
    return launches


def o1_consistency_phase(dev) -> None:
    """Card against CPU at O1, from one seed: ResNet-18 (``CONSIST``: b8
    64x64, ``grad_accum`` 2; one step at lr 0.1, phase 9's O2 case) and
    the BERT proxy (one FusedLAMB step, eps 1e-4, on the packed batch).

    Three limits, each printed with the planted faults (run on the CPU)
    it rejects: the first loss (the proxy's within ``O1_FIRST_LOSS_RTOL``,
    which must reject unmasked padding; ResNet-18's within
    ``O1_RESNET_FIRST_LOSS_RTOL``, which rejects none, see below);
    the proxy's first gradient, before the optimizer, within
    ``O1_GRAD_LEAF_TOL`` of each leaf's largest entry (it must reject
    label smoothing 0.1 and unmasked padding); the params after the
    step.  Phases 9 and 15's rule for those (the params' gap, ``_gap``,
    under a tenth of the nearest wrong update) cannot hold at O1, where
    bf16 roundings move a first step by more than a wrong update does:
    the CPU alone, from an init moved by one ulp, lands further from its
    own step than "lr 4% high" does.  So each case's params are held to
    ``O1_SPREAD_FACTOR`` times that one-ulp spread, measured in the run
    (the rule of the O1 CPU tests, ``test_torch_port_amp_o1.py``).  The
    proxy's LAMB takes ``m / sqrt(v)`` on its first step, so an element
    whose gradient is within bf16 noise of zero moves a whole ``lr``
    either way.

    ResNet-18 holds no gradient, and its first loss no planted fault:
    under O1 its BatchNorms (flax's arithmetic: bf16 squares, and a
    backward that sums bf16-rounded, nearly cancelling terms) make its
    first step chaotic, the gradient 0.30 of its norm from the f32 one
    in the reference itself (``test_torch_port_amp_o1.py``), and a
    one-ulp change of the init moves the CPU's first loss about as far
    as f32 arithmetic (O0) does."""
    from apex_tpu_torch._tree import tree_leaves, tree_map
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp
    from apex_tpu_torch.models import resnet18

    params, stats = resnet18().init(CONSIST["seed"], "cpu")
    init = [t.numpy() for t in tree_leaves(params)]
    ulp = tree_map(_next_ulp, params)

    def run(device, lr=0.1, start=params, opt_level="O1"):
        var = tuple(tree_map(lambda t: t.to(device), v)
                    for v in (start, stats))
        res = main_amp.train(device=device, opt_level=opt_level, steps=1,
                             variables=var, lr=lr, **CONSIST)
        return res.losses, [m.float().cpu().numpy()
                            for m in tree_leaves(res.opt.params)]

    card_l, card_m = run(dev)
    cpu_l, cpu_m = run("cpu")
    ulp_l, ulp_m = run("cpu", start=ulp)
    spread = _gap(ulp_m, cpu_m, init)
    lspread = _loss_rel(ulp_l, cpu_l)
    f32_l, _ = run("cpu", opt_level="O0")
    _o1_held("resnet18 O1 lr 0.1 b8 64x64 grad_accum 2, 1 step", card_l,
             cpu_l, (O1_RESNET_FIRST_LOSS_RTOL,
                     f"a few times the card's reading (the cpu's one-ulp "
                     f"spread {lspread:.3e})"),
             {"f32 arithmetic (O0)": _loss_rel(f32_l, cpu_l)}, (), None,
             _gap(card_m, cpu_m, init),
             {"lr 4% high": _gap(run("cpu", lr=0.104)[1], cpu_m, init)},
             (O1_SPREAD_FACTOR * spread,
              f"{O1_SPREAD_FACTOR:g} x the cpu's one-ulp spread "
              f"{spread:.3e}"))

    model = pretrain.model_for(False, PROXY["seq"], "O1")
    bparams = model.init(0, "cpu")
    binit = [t.numpy() for t in tree_leaves(bparams)]
    batch, real, _ = pretrain.synthetic_batch(model.vocab_size,
                                              PROXY["batch"], PROXY["seq"],
                                              True, "cpu")
    real_loss = pretrain.softmax_cross_entropy_loss
    bulp = tree_map(_next_ulp, bparams)

    def brun(device, lr=1e-3, start=bparams, **loss_kw):
        """(first loss, first gradient per leaf, params after one step)."""
        def loss(logits, labels, smoothing=0.0, padding_idx=0,
                 half_to_float=False):
            kw = dict(smoothing=smoothing, padding_idx=padding_idx,
                      half_to_float=half_to_float)
            return real_loss(logits, labels, **{**kw, **loss_kw})
        pretrain.softmax_cross_entropy_loss = loss
        try:
            opt, state, step = pretrain.setup(
                model, start, device, opt_level="O1", lr=lr, **PROXY_LAMB)
            grads = []
            opt_step = opt.step

            def capture(g, found_inf=None):
                grads.extend(tree_leaves(g))
                return opt_step(g, found_inf=found_inf)

            opt.step = capture
            scale = float(state.scaler.loss_scale)
            out, _ = step(state, **{k: t.to(device)
                                    for k, t in batch.items()})
            value = float(out)
        finally:
            pretrain.softmax_cross_entropy_loss = real_loss
        return ([value], [g.float().cpu().numpy() / scale for g in grads],
                [p.float().cpu().numpy() for p in tree_leaves(opt.params)])

    card_l, card_g, card_p = brun(dev)
    cpu_l, cpu_g, cpu_p = brun("cpu")
    faults = {"label smoothing 0.1": brun("cpu", smoothing=0.1),
              "padding not masked": brun("cpu", padding_idx=-2),
              "lr 4% high": brun("cpu", lr=1.04e-3)}
    spread = _gap(brun("cpu", start=bulp)[2], cpu_p, binit)
    _o1_held(f"bert proxy O1 FusedLAMB (eps 1e-4) packed b{PROXY['batch']} "
             f"s{PROXY['seq']} ({real} real tokens), 1 step", card_l, cpu_l,
             (O1_FIRST_LOSS_RTOL, "a few times the card's readings"),
             {k: _loss_rel(v[0], cpu_l) for k, v in faults.items()},
             ("padding not masked",),
             (_worst_leaf(card_g, cpu_g),
              {k: _worst_leaf(faults[k][1], cpu_g)
               for k in ("label smoothing 0.1", "padding not masked")}),
             _gap(card_p, cpu_p, binit),
             {k: _gap(v[2], cpu_p, binit) for k, v in faults.items()},
             (O1_SPREAD_FACTOR * spread,
              f"{O1_SPREAD_FACTOR:g} x the cpu's one-ulp spread "
              f"{spread:.3e}"))


def _next_ulp(t):
    """``t`` moved by one ulp towards +inf."""
    import torch
    return torch.nextafter(t, torch.full_like(t, float("inf")))


def _worst_leaf(got, want) -> float:
    """The largest over leaves of ``max |got - want| / max |want|``."""
    import numpy as np
    return max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
               for a, b in zip(got, want))


def _rejects(tol, readings) -> str:
    return ", ".join(f"{k} {g:.3e} ({'rejected' if g > tol else 'passes'})"
                     for k, g in readings.items())


def _o1_held(what, card_l, cpu_l, loss_limit, loss_faults, must_reject,
             grad, gap, gaps, limit) -> None:
    """Prints and checks one O1 card-vs-CPU case.  ``loss_limit``: the
    first loss's ``(rtol, what it is)``; ``loss_faults``: the planted
    faults' first-loss distances from the CPU's, of which those named in
    ``must_reject`` must exceed it; ``grad``: None, or ``(the card's
    worst leaf, {fault: worst leaf})``, every fault beyond
    ``O1_GRAD_LEAF_TOL``; ``gap`` and ``gaps``: the params' gap and the
    faults', ``limit``: ``(tol, what it is)``."""
    rel0 = _loss_rel(card_l[:1], cpu_l[:1])
    tol, held = limit
    ltol, lheld = loss_limit
    print(f"consistency O1 {what}: card losses "
          f"{[round(v, 6) for v in card_l]}, cpu "
          f"{[round(v, 6) for v in cpu_l]}; first loss rel diff "
          f"{rel0:.3e}, tol {ltol:.3e} = {lheld}, planted on the cpu: "
          f"{_rejects(ltol, loss_faults)}", flush=True)
    if grad is not None:
        print(f"consistency O1 {what}: first gradient's worst leaf (max "
              f"|card - cpu| / max |cpu|) {grad[0]:.3e}, tol "
              f"{O1_GRAD_LEAF_TOL:g}, planted on the cpu: "
              f"{_rejects(O1_GRAD_LEAF_TOL, grad[1])}", flush=True)
    print(f"consistency O1 {what}: params' gap {gap:.3e} of their "
          f"displacement, tol {tol:.3e} = {held}, planted on the cpu: "
          f"{_rejects(tol, gaps)}", flush=True)
    _check(all(math.isfinite(v) for v in card_l + cpu_l),
           f"O1 consistency {what}: non-finite loss")
    _check(rel0 <= ltol,
           f"O1 consistency {what}: first loss differs by {rel0}")
    for k in must_reject:
        _check(loss_faults[k] > ltol,
               f"O1 consistency {what}: the first-loss limit does not "
               f"reject '{k}'")
    if grad is not None:
        _check(grad[0] <= O1_GRAD_LEAF_TOL,
               f"O1 consistency {what}: first gradient's worst leaf "
               f"{grad[0]} over {O1_GRAD_LEAF_TOL}")
        for k, g in grad[1].items():
            _check(g > O1_GRAD_LEAF_TOL, f"O1 consistency {what}: the "
                                         f"gradient limit does not reject "
                                         f"'{k}'")
    _check(gap <= tol, f"O1 consistency {what}: gap {gap} over {tol}")


def o1_bert_phase(dev, smi: str) -> dict:
    """The BERT example at O1: its default proxy and ``--large``, a few
    steps each, with exact launch counts (flash forward, dq and dk/dv a
    layer, LayerNorm forward and backward, the cross entropy where the
    vocabulary is on its gate, the LAMB tail)."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain

    launches = {}
    for large in (False, True):
        _build.reset_launch_counts()
        res = pretrain.train(large=large, steps=O1_BERT_STEPS,
                             opt_level="O1", device=dev, log=None)
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in _build.KERNELS}
        model = pretrain.model_for(large, 512, "O1")
        want = _bert_launches_expected(
            O1_BERT_STEPS, len(res.opt._plan.buckets),
            layers=model.num_layers, flash=True,
            xent=model.vocab_size % 128 == 0)
        what = "bert-large" if large else "bert proxy"
        key = "bert_large_o1" if large else "bert_proxy_o1"
        _check(all(math.isfinite(v) for v in res.losses),
               f"O1 {what}: non-finite loss {res.losses}")
        _check(got == want, f"O1 {what}: launches {got}, expected {want}")
        launches[key] = {k: v for k, v in got.items() if v}
        print(f"train {what} O1 FusedLAMB b8 s512 unmasked: "
              f"{O1_BERT_STEPS} steps, {1e3 * res.step_seconds:.2f} ms/step "
              f"(host clock), {res.tokens_per_sec:.1f} tokens/s over the "
              f"steps after the first, losses "
              f"{[round(v, 4) for v in res.losses]}, launches (flash, "
              f"LayerNorm, cross entropy, LAMB tail) "
              f"{launches[key]} [{smi}]",
              flush=True)
    return launches


def dcgan_phase(dev, smi: str) -> dict:
    """The DCGAN example (two models, two FusedAdam, two scalers) for a
    few steps at O1: both scalers in one ``amp.state_dict``, which round-
    trips; one ``flat_adam`` a bucket per optimizer step."""
    import torch
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.examples import dcgan_main_amp as dcgan

    _build.reset_launch_counts()
    res = dcgan.train(steps=DCGAN_STEPS, device=dev, log=None)
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in _build.KERNELS}
    buckets = (len(res.opt_d._plan.buckets)
               + len(res.opt_g._plan.buckets))
    want = {k.name: 0 for k in _build.KERNELS}
    want["flat_adam"] = buckets * DCGAN_STEPS
    sd = res.state_dict
    again = amp.state_dict(*amp.load_state_dict(sd, res.amp_d, res.amp_g))
    print(f"train dcgan O1 b16 nz32: {DCGAN_STEPS} steps, lossD "
          f"{[round(v, 4) for v in res.losses_d]}, lossG "
          f"{[round(v, 4) for v in res.losses_g]}, "
          f"{1e3 * res.step_seconds:.2f} ms/step (host clock), launches "
          f"{ {k: v for k, v in got.items() if v} }; amp.state_dict {sd}, "
          f"round trip {'equal' if again == sd else again} [{smi}]",
          flush=True)
    _check(all(math.isfinite(v) for v in res.losses_d + res.losses_g),
           "dcgan: non-finite loss")
    _check(got == want, f"dcgan: launches {got}, expected {want}")
    _check(sorted(sd) == ["loss_scaler0", "loss_scaler1"],
           f"dcgan: state_dict keys {sorted(sd)}")
    _check(again == sd, f"dcgan: state_dict round trip {again} != {sd}")
    return {"dcgan_o1": {k: v for k, v in got.items() if v}}


def offload_phase(dev, smi: str) -> dict:
    """The GPT block stack at GPT-2 small's widths (12 x h768, b8 s512,
    vocab 50257, bf16 compute, amp O2's bf16 params) with
    ``--offload-activations`` against the same step without it and
    against plain recomputation (each block under ``offload_checkpoint``
    with no names): the loss and every gradient within ``OFFLOAD_TOL``,
    peak device memory (``max_memory_allocated``) and the
    forward+backward's device ms (CUDA events) of each; then the
    example's own step with offload for a few steps, with its launches
    (each block's forward runs in the forward and again, up to its GELU,
    in the backward)."""
    import numpy as np
    import torch
    from apex_tpu_torch import _build, amp, offload
    from apex_tpu_torch._tree import tree_leaves
    from apex_tpu_torch.examples import gpt_train_block as ex

    g = GPT
    params = ex.GPTBlocks(g["vocab"], g["hidden"], g["heads"], g["layers"],
                          max_seq=g["seq"]).init(0, dev)
    params, _ = amp.initialize(params, opt_level="O2", device=dev)
    tokens = ex.synthetic_tokens(g["batch"], g["seq"], g["vocab"],
                                 device=dev)
    class Recomputed(ex.GPTBlocks):
        OFFLOAD_NAMES = ()          # remat with nothing on the host

    out = {}
    for name, cls, off in (("plain", ex.GPTBlocks, False),
                           ("recomputed", Recomputed, True),
                           ("offloaded", ex.GPTBlocks, True)):
        model = cls(g["vocab"], g["hidden"], g["heads"], g["layers"],
                    max_seq=g["seq"], offload_activations=off)

        def fwd_bwd():
            return amp.value_and_grad(
                lambda p, t: ex.next_token_loss(model(p, t), t), params,
                tokens)

        fwd_bwd()                                   # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        offload.host_copies.clear()
        ms = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            (loss, _), grads = fwd_bwd()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated(dev) - base
        copies = dict(offload.host_copies)
        _, by_name = _profile_step(fwd_bwd)
        busy = sum(t for t, _ in by_name.values()) / 1e3
        memcpy = sum(t for n, (t, _) in by_name.items()
                     if n.startswith("Memcpy")) / 1e3
        out[name] = (float(loss), [t.float() for t in tree_leaves(grads)],
                     peak, float(np.median(ms)), copies, busy, memcpy)
        del grads
    l0, g0 = out["plain"][:2]
    worst = {k: max(float(((a - b).abs() - OFFLOAD_TOL["rtol"] * b.abs())
                          .max()) for a, b in zip(v[1], g0))
             for k, v in out.items() if k != "plain"}
    print(f"offload gpt block 12 x h768 b8 s512 bf16 forward+backward: "
          + "; ".join(f"{k}: loss {v[0]:.6f}, peak device memory above the "
                      f"params and inputs {v[2] / 2**30:.3f} GiB, device ms "
                      f"median of 3 {v[3]:.2f} (CUDA events), device busy "
                      f"{v[5]:.2f} ms of which copies {v[6]:.2f} (one "
                      f"profiled call), host copies {v[4]}"
                      for k, v in out.items())
          + "; grads' worst |diff| - rtol*|plain| "
          + ", ".join(f"{k} {w:.3e}" for k, w in worst.items())
          + f" (atol {OFFLOAD_TOL['atol']:g}, rtol {OFFLOAD_TOL['rtol']:g})"
          f" [{smi}]", flush=True)
    for k, v in out.items():
        _check(abs(v[0] - l0) <= OFFLOAD_TOL["atol"] + OFFLOAD_TOL["rtol"]
               * abs(l0), f"offload: {k} loss {v[0]} against {l0}")
    for k, w in worst.items():
        _check(w <= OFFLOAD_TOL["atol"], f"offload: {k} grads differ by {w}")
    _check(out["offloaded"][4] == {"ffn_hidden": 3 * g["layers"]},
           f"offload: host copies {out['offloaded'][4]}")
    _check(out["recomputed"][4] == {}, "recompute: host copies "
                                       f"{out['recomputed'][4]}")
    _check(out["offloaded"][2] < out["plain"][2],
           f"offload: peak memory {out['offloaded'][2]} not under "
           f"{out['plain'][2]}")
    del out, g0, params

    _build.reset_launch_counts()
    res = ex.train(steps=3, device=dev, offload_activations=True, log=None)
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in _build.KERNELS}
    _check(all(math.isfinite(v) for v in res.losses),
           f"offload train: non-finite loss {res.losses}")
    for kn in ("flash_fwd", "layer_norm_fwd"):
        _check(got[kn] > 0, f"offload train: {kn} never launched")
    print(f"train gpt block O2 --offload-activations: 3 steps, "
          f"{1e3 * res.step_seconds:.2f} ms/step (host clock), "
          f"{res.tokens_per_sec:.1f} tokens/s, losses "
          f"{[round(v, 4) for v in res.losses]}, launches "
          f"{ {k: v for k, v in got.items() if v} } [{smi}]", flush=True)
    return {"gpt_block_offload": {k: v for k, v in got.items() if v}}


def o1_offload_phase(dev, smi: str, o2: dict) -> dict:
    """Phase 38: amp O1 and activation offload.  Returns each path's
    launches by kernel."""
    import torch
    launches = o1_resnet_phase(dev, smi, o2)
    torch.cuda.empty_cache()
    o1_consistency_phase(dev)
    launches.update(o1_bert_phase(dev, smi))
    torch.cuda.empty_cache()
    launches.update(dcgan_phase(dev, smi))
    launches.update(offload_phase(dev, smi))
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 39: checkpoint, resume and optimizer state offload
# ---------------------------------------------------------------------------

# (a) ResNet-50 v1.5 O2 FusedSGD b128 x 224 through the example's main()
CKPT_RUN = ["--arch", "resnet50", "--opt-level", "O2", "--batch-size", "128",
            "--image-size", "224"]
CKPT_STEPS, CKPT_EVERY, CKPT_PREEMPT, CKPT_PREEMPT_OFF = 8, 2, 4, 3
# (b) GPT-2 small's block stack at O2 with FusedAdam: save and restore
CKPT_GPT_TIMED = 3            # steps timed without a save
# (c) BERT-L O2 FusedLAMB b8 x 512 unmasked, resident and offloaded in turns
OFFLOAD_BERT = dict(batch=8, seq=512, steps=3,
                    turns=(False, True, True, False))


def _host_state(res) -> dict:
    """Host copies of what a resumed run is held to: params, masters,
    momentum, BatchNorm statistics, loss scale and growth tracker, the
    optimizer's step clock."""
    import torch
    from apex_tpu_torch._tree import tree_leaves
    opt = res.opt
    out = {"params": [b.cpu() for b in opt._param_bufs],
           "masters": [b.cpu() for b in opt._master_bufs],
           "state": {k: [b.cpu() for b in v]
                     for k, v in opt.opt_state.items()},
           "batch_stats": [t.cpu() for t in tree_leaves(res.batch_stats)],
           "loss_scale": res.amp_state.scaler.loss_scale.cpu(),
           "growth_tracker": res.amp_state.scaler.growth_tracker.cpu(),
           "step": opt.step_count.cpu()}
    torch.cuda.synchronize()
    return out


def _bits_differ(a: dict, b: dict) -> list:
    """The names of the entries of two ``_host_state`` dicts whose bits
    differ (an empty list: equal bit for bit)."""
    import torch
    from apex_tpu_torch._tree import tree_leaves

    def raw(t):
        return t.reshape(-1).view(torch.uint8)

    bad = []
    for k in a:
        la, lb = tree_leaves(a[k]), tree_leaves(b[k])
        if len(la) != len(lb) or not all(
                x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(raw(x), raw(y)) for x, y in zip(la, lb)):
            bad.append(k)
    return bad


def _ckpt_main(argv):
    """The ImageNet example's main() on ``argv``, its printed lines kept;
    returns (result, lines, launches by kernel)."""
    import contextlib
    import io
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp
    buf = io.StringIO()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        res = main_amp.main(argv)
    import torch
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in _build.KERNELS if k.launches}
    return res, buf.getvalue().splitlines(), got


def ckpt_resnet_phase(dev, smi: str, tmp: str) -> dict:
    """(a) ResNet-50 O2 b128 x 224 through the example's own main() with
    deterministic cuDNN: an uninterrupted 8-step run; ``--checkpoint-dir
    D --save-every 2 --steps 8 --preempt-at-step 4`` (a clean exit with a
    final file at step 4); the same command again (``resumed at step 4``,
    finishes).  The final masters, params, momentum, batch_stats, loss
    scale and step count bit for bit against the uninterrupted run; the
    same with ``--checkpoint F`` (v1, 4 steps then 8) and with
    ``--grad-accum 2``; at ``--preempt-at-step 3`` the state restored
    from the file against the state saved.  Returns the resumed runs'
    launches."""
    import os
    import torch
    cudnn = torch.backends.cudnn
    old = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    print("checkpoint phase: cuDNN deterministic, no autotuning, for every "
          "run of (a) (the example's default autotunes)", flush=True)
    launches = {}
    try:
        for ga in (1, ACCUM):
            base = CKPT_RUN + ["--steps", str(CKPT_STEPS),
                               "--grad-accum", str(ga)]
            t0 = time.perf_counter()
            want, _, _ = _ckpt_main(base)
            want_state = _host_state(want)
            n_buckets = len(want.opt._plan.buckets)
            del want
            d = os.path.join(tmp, f"resnet-ga{ga}")
            cmd = base + ["--checkpoint-dir", d, "--save-every",
                          str(CKPT_EVERY), "--preempt-at-step",
                          str(CKPT_PREEMPT)]
            cut, lines, _ = _ckpt_main(cmd)
            _check(cut.preempted and int(cut.opt.step_count) == CKPT_PREEMPT,
                   f"checkpoint ga{ga}: the run was not preempted at step "
                   f"{CKPT_PREEMPT}: {lines[-3:]}")
            files = sorted(os.listdir(d))
            _check(files == [f"step-{s}.ckpt" for s in
                             range(CKPT_EVERY, CKPT_PREEMPT + 1, CKPT_EVERY)],
                   f"checkpoint ga{ga}: files {files}")
            _check(any(f"preempted: final checkpoint durable at step "
                       f"{CKPT_PREEMPT}" in l for l in lines),
                   f"checkpoint ga{ga}: no preemption line in {lines}")
            del cut
            got, lines, counts = _ckpt_main(cmd)
            _check(any(l.startswith(f"resumed at step {CKPT_PREEMPT} scale")
                       for l in lines),
                   f"checkpoint ga{ga}: no 'resumed at step "
                   f"{CKPT_PREEMPT}' in {lines[:3]}")
            rest = CKPT_STEPS - CKPT_PREEMPT
            _check(not got.preempted and len(got.losses) == rest,
                   f"checkpoint ga{ga}: the resumed run took "
                   f"{len(got.losses)} steps")
            want_counts = {"flat_sgd": rest * n_buckets}
            if ga > 1:
                want_counts.update(flat_accumulate=ga * rest * n_buckets,
                                   flat_unscale_norm=rest * n_buckets)
            _check(counts == want_counts,
                   f"checkpoint ga{ga}: launches {counts}, expected "
                   f"{want_counts}")
            launches[f"resnet50_resume_ga{ga}"] = counts
            bad = _bits_differ(_host_state(got), want_state)
            del got
            _check(not bad, f"checkpoint ga{ga}: preempted at "
                            f"{CKPT_PREEMPT} and resumed differs from the "
                            f"uninterrupted run in {bad}")
            print(f"checkpoint resnet50 O2 b128 224 grad_accum {ga}: "
                  f"--checkpoint-dir --save-every {CKPT_EVERY} "
                  f"--preempt-at-step {CKPT_PREEMPT} then the same command: "
                  f"masters, params, momentum, batch_stats, loss scale and "
                  f"step count equal the uninterrupted {CKPT_STEPS}-step "
                  f"run bit for bit; resumed run's launches {counts}; "
                  f"{time.perf_counter() - t0:.1f} s for the three runs "
                  f"[{smi}]", flush=True)
            if ga > 1:
                continue
            # v1: --checkpoint F, 4 steps then the same file to step 8
            f = os.path.join(tmp, "resnet.v1")
            _ckpt_main(CKPT_RUN + ["--steps", str(CKPT_PREEMPT),
                                   "--checkpoint", f])
            got, lines, _ = _ckpt_main(base + ["--checkpoint", f])
            _check(any(l.startswith(f"resumed at step {CKPT_PREEMPT} ")
                       for l in lines), f"checkpoint v1: {lines[:3]}")
            bad = _bits_differ(_host_state(got), want_state)
            del got
            _check(not bad, f"checkpoint v1: resumed differs in {bad}")
            print(f"checkpoint resnet50 v1 (--checkpoint, {CKPT_PREEMPT} "
                  f"steps then {CKPT_STEPS}): equal to the uninterrupted "
                  f"run bit for bit [{smi}]", flush=True)
            # at step 3 the resumed run's batches differ (the reference's
            # pool restarts): the restored state equals the saved state
            d3 = os.path.join(tmp, "resnet-at3")
            cut, _, _ = _ckpt_main(CKPT_RUN + [
                "--steps", str(CKPT_STEPS), "--checkpoint-dir", d3,
                "--save-every", str(CKPT_EVERY), "--preempt-at-step",
                str(CKPT_PREEMPT_OFF)])
            _check(cut.preempted, "checkpoint at 3: not preempted")
            saved = _host_state(cut)
            del cut
            got, _, _ = _ckpt_main(CKPT_RUN + [
                "--steps", str(CKPT_PREEMPT_OFF), "--checkpoint-dir", d3])
            _check(got.start_step == CKPT_PREEMPT_OFF and not got.losses,
                   f"checkpoint at 3: resumed at {got.start_step}")
            bad = _bits_differ(_host_state(got), saved)
            del got
            _check(not bad, f"checkpoint at 3: restored differs from saved "
                            f"in {bad}")
            print(f"checkpoint resnet50 --preempt-at-step "
                  f"{CKPT_PREEMPT_OFF}: the restored state equals the saved "
                  f"state bit for bit [{smi}]", flush=True)
    finally:
        cudnn.deterministic, cudnn.benchmark = old
    return launches


def _synced_ms(fn):
    """(result, ms) of ``fn()`` on the host clock, the card synchronized
    before each clock read."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _packed_copy(opt) -> list:
    return ([b.clone() for b in opt._param_bufs]
            + [b.clone() for b in opt._master_bufs]
            + [b.clone() for k in sorted(opt.opt_state)
               for b in opt.opt_state[k]])


def _packed_equal(opt, want) -> bool:
    import torch
    have = _packed_copy(opt)
    return len(have) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a.to(b.device), b)
        for a, b in zip(have, want))


def ckpt_gpt_phase(dev, smi: str, tmp: str) -> dict:
    """(b) GPT-2 small's block stack, amp O2, FusedAdam (one bucket of
    124,046,592; params, masters and both moments in a file): bytes
    written, v1 and v2 save and restore ms (synchronized clock reads),
    the ms an AsyncCheckpointer v2 save blocks the loop for beside a
    step's ms without a save; an async save followed at once by a step
    gives a file equal to the state before the step; the v2 restore
    adopts the buffers, one host-to-device copy per packed buffer."""
    import os
    import numpy as np
    import torch
    from apex_tpu_torch import checkpoint as ck
    from apex_tpu_torch.examples import gpt_train_block as ex
    from apex_tpu_torch.optimizers import _base

    model = ex.GPTBlocks(GPT["vocab"], GPT["hidden"], GPT["heads"],
                         GPT["layers"], max_seq=GPT["seq"])
    s = ex.setup(model, model.init(0, "cpu"), dev, opt_level="O2",
                 lr=GPT["lr"])
    tokens = ex.synthetic_tokens(GPT["batch"], GPT["seq"], GPT["vocab"],
                                 device=dev)
    state = s.amp_state
    for _ in range(GPT["warmup"]):
        _, state = s.step(state, tokens)
    step_ms = []
    for _ in range(CKPT_GPT_TIMED):
        (_, state), ms = _synced_ms(lambda: s.step(state, tokens))
        step_ms.append(ms)
    opt = s.opt
    n_bufs = 2 + sum(len(v) for v in opt.opt_state.values())
    fig = {}
    # an async v2 save, then a step at once
    want = _packed_copy(opt)
    p2 = os.path.join(tmp, "gpt.v2")
    ac = ck.AsyncCheckpointer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ac.save_training_state(p2, optimizer=opt, step=1,
                           amp_state=state.state_dict())
    fig["async_blocked_ms"] = 1e3 * (time.perf_counter() - t0)
    (_, state), fig["step_after_save_ms"] = _synced_ms(
        lambda: s.step(state, tokens))
    _, fig["async_wait_ms"] = _synced_ms(ac.wait_until_finished)
    ac.close()
    fig["v2_bytes"] = os.path.getsize(p2)
    _check(not _packed_equal(opt, want), "ckpt gpt: the step after the save "
                                         "changed nothing")
    adopted = []
    real_adopt = _base._adopt

    def counting(dst, src):
        adopted.append((dst.device.type, src.device.type))
        real_adopt(dst, src)

    _base._adopt = counting
    try:
        _, fig["v2_restore_ms"] = _synced_ms(lambda: ck.load_training_state(
            p2, opt.params, opt))
    finally:
        _base._adopt = real_adopt
    _check(_packed_equal(opt, want), "ckpt gpt: the async v2 file is not "
                                     "the state from before the next step")
    _check(adopted == [("cuda", "cpu")] * n_bufs,
           f"ckpt gpt: the v2 restore made {adopted}, expected one "
           f"host-to-device copy into each of the {n_bufs} packed buffers")
    # a second async save: the pinned staging buffers of the first are
    # cached by PyTorch's host allocator now
    ac = ck.AsyncCheckpointer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ac.save_training_state(p2, optimizer=opt, step=1,
                           amp_state=state.state_dict())
    fig["async2_blocked_ms"] = 1e3 * (time.perf_counter() - t0)
    (_, state), fig["step_after_save2_ms"] = _synced_ms(
        lambda: s.step(state, tokens))
    _, fig["async2_wait_ms"] = _synced_ms(ac.wait_until_finished)
    ac.close()
    os.remove(p2)
    del want
    fig["v2_save_bytes"], fig["v2_save_ms"] = _synced_ms(
        lambda: ck.save_training_state(p2, optimizer=opt, step=2))
    os.remove(p2)
    p1 = os.path.join(tmp, "gpt.v1")
    fig["v1_bytes"], fig["v1_save_ms"] = _synced_ms(
        lambda: ck.save_training_state(p1, optimizer=opt, step=2,
                                       format="v1"))
    want = _packed_copy(opt)
    _, state = s.step(state, tokens)
    _, fig["v1_restore_ms"] = _synced_ms(lambda: ck.load_training_state(
        p1, opt.params, opt))
    _check(_packed_equal(opt, want), "ckpt gpt: the v1 restore is not the "
                                     "saved state")
    os.remove(p1)
    del want, s, opt
    torch.cuda.empty_cache()
    gb = fig["v2_bytes"] / 1e9
    print(f"checkpoint gpt-2 small O2 FusedAdam (one bucket of "
          f"{GPT_BUCKET}): v2 file {fig['v2_bytes']} bytes, v1 file "
          f"{fig['v1_bytes']} bytes; v2 save {fig['v2_save_ms']:.1f} ms "
          f"({gb / fig['v2_save_ms'] * 1e3:.2f} GB/s), v2 restore "
          f"{fig['v2_restore_ms']:.1f} ms, v1 save {fig['v1_save_ms']:.1f} "
          f"ms, v1 restore {fig['v1_restore_ms']:.1f} ms (host clock, card "
          f"synchronized before each read; files in a temporary directory, "
          f"reads warm); async v2 save blocks the loop "
          f"{fig['async_blocked_ms']:.2f} ms, the step right after it "
          f"{fig['step_after_save_ms']:.2f} ms, a step without a save "
          f"median {float(np.median(step_ms)):.2f} ms (of "
          f"{[round(v, 2) for v in step_ms]}), the wait for the write "
          f"after that step {fig['async_wait_ms']:.1f} ms; a second "
          f"async save (pinned buffers cached) blocks "
          f"{fig['async2_blocked_ms']:.2f} ms, the step after it "
          f"{fig['step_after_save2_ms']:.2f} ms, the wait "
          f"{fig['async2_wait_ms']:.1f} ms; the async file "
          f"equals the state before the step, the v2 restore made "
          f"{n_bufs} host-to-device copies ({n_bufs} packed buffers) "
          f"[{smi}]", flush=True)
    return fig


def offload_state_phase(dev, smi: str, tmp: str) -> dict:
    """(c) BERT-L, amp O2, FusedLAMB, b8 x 512 unmasked, 3 steps a run,
    ``--offload-state`` against resident in turns (ABBA): the final
    masters, params and moments bit for bit, ms a step (CUDA events) and
    ``max_memory_allocated`` over the steps (and in the setup) of each,
    the device memory held between steps; then a v2 save and restore of the offloaded optimizer, its
    state in pinned host memory after both.  Returns the offloaded run's
    launches."""
    import gc
    import os
    import torch
    from apex_tpu_torch import _build, checkpoint as ck
    from apex_tpu_torch.examples import bert_pretrain_mlm as ex
    from apex_tpu_torch.models import bert_large

    c = OFFLOAD_BERT
    model = bert_large(dtype=torch.bfloat16, max_seq_len=c["seq"])
    t0 = time.perf_counter()
    params = model.init(0, "cpu")
    print(f"offload: bert-large init on the cpu "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    inputs, _, _ = ex.synthetic_batch(model.vocab_size, c["batch"],
                                      c["seq"], False, dev)
    runs, final, launches = [], {}, None
    for off in c["turns"]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        opt, state, step = ex.setup(model, params, dev, offload_state=off)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for bufs in opt.opt_state.values():
            _check(all(b.is_pinned() == off and (b.device.type == "cpu")
                       == off for b in bufs),
                   f"offload={off}: the state lives on {bufs[0].device}")
        state_bytes = sum(b.numel() * b.element_size()
                          for v in opt.opt_state.values() for b in v)
        _build.reset_launch_counts()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(c["steps"] + 1)]
        events[0].record()
        losses = []
        for i in range(c["steps"]):
            loss, state = step(state, **inputs)
            losses.append(loss)
            events[i + 1].record()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in _build.KERNELS if k.launches}
        if off:
            launches = got
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        held = torch.cuda.memory_allocated(dev)
        # the bytes the live tensors asked for: memory_allocated counts
        # whole allocator blocks, whose unsplit tails (up to 1 MiB a
        # block) depend on the turn's allocation history
        held_req = torch.cuda.memory_stats(dev)[
            "requested_bytes.all.current"]
        peak = torch.cuda.max_memory_allocated(dev)
        host = [b.cpu() for b in opt._param_bufs + opt._master_bufs] + [
            b.cpu() for k in sorted(opt.opt_state)
            for b in opt.opt_state[k]]
        runs.append(dict(off=off, ms=ms, peak=peak, held=held,
                         held_req=held_req, setup_peak=setup_peak,
                         losses=[float(v) for v in losses], got=got))
        if off not in final:
            final[off] = host
        else:
            _check(all(torch.equal(a, b) for a, b in zip(host, final[off])),
                   f"offload={off}: two turns differ")
        if off and len([r for r in runs if r["off"]]) == 2:
            # a v2 save and restore of the offloaded optimizer
            p = os.path.join(tmp, "bert.v2")
            nbytes, save_ms = _synced_ms(lambda: ck.save_training_state(
                p, optimizer=opt, step=c["steps"]))
            # one more step, so a restore that does nothing fails below
            step(state, **inputs)
            torch.cuda.synchronize()
            _check(not all(torch.equal(a.cpu(), b) for a, b in zip(
                opt._param_bufs + opt._master_bufs, host)),
                "offload: the step after the v2 save changed nothing")
            _, restore_ms = _synced_ms(lambda: ck.load_training_state(
                p, opt.params, opt))
            os.remove(p)
            for bufs in opt.opt_state.values():
                _check(all(b.is_pinned() for b in bufs),
                       "offload: the state left pinned host memory in the "
                       "v2 save or restore")
            _check(all(torch.equal(a, b) for a, b in zip(
                [b.cpu() for b in opt._param_bufs + opt._master_bufs]
                + [b.cpu() for k in sorted(opt.opt_state)
                   for b in opt.opt_state[k]], host)),
                "offload: the v2 restore is not the saved state")
            print(f"offload v2 checkpoint of the offloaded BERT-L "
                  f"optimizer: {nbytes} bytes, save {save_ms:.1f} ms, "
                  f"restore {restore_ms:.1f} ms (host clock, synchronized); "
                  f"the moments stayed in pinned host memory through both "
                  f"[{smi}]", flush=True)
        del opt, state, step, losses
    _check(all(torch.equal(a, b) for a, b in zip(final[True], final[False])),
           "offload: the offloaded run's masters, params or moments differ "
           "from the resident run's")
    res = [r for r in runs if not r["off"]]
    off = [r for r in runs if r["off"]]
    _check(res[0]["got"] == off[0]["got"],
           f"offload: launches {off[0]['got']} against {res[0]['got']}")
    _check(off[0]["got"].get("flat_lamb_moments") == c["steps"]
           and off[0]["got"].get("flat_l2norm") == c["steps"],
           f"offload: LAMB launches {off[0]['got']}")
    _check(min(r["held_req"] for r in res)
           - max(r["held_req"] for r in off) >= state_bytes,
           f"offload: live tensors hold {max(r['held_req'] for r in off)} "
           f"bytes of the device between steps against "
           f"{min(r['held_req'] for r in res)} resident ({state_bytes} "
           f"bytes of state)")
    _check(max(r["peak"] for r in off) < min(r["peak"] for r in res),
           "offload: the peak device memory is not lower")
    print("offload bert-large O2 FusedLAMB b8 s512 unmasked, 3 steps a "
          "turn, turns resident/offloaded/offloaded/resident: "
          + "; ".join(f"{'offloaded' if r['off'] else 'resident'} ms/step "
                      f"{[round(v, 2) for v in r['ms']]} (CUDA events), "
                      f"max_memory_allocated over the steps "
                      f"{r['peak'] / 2**30:.3f} GiB (in the setup "
                      f"{r['setup_peak'] / 2**30:.3f}), held between steps "
                      f"{r['held'] / 2**30:.3f} GiB ({r['held_req']} bytes "
                      f"requested by live tensors)"
                      for r in runs)
          + f"; LAMB state {state_bytes / 2**30:.3f} GiB; final masters, "
          f"params and moments equal bit for bit; losses "
          f"{runs[0]['losses']}; offloaded launches {launches} [{smi}]",
          flush=True)
    return {"bert_large_offload_state": launches}


def checkpoint_phase(dev, smi: str) -> dict:
    """Phase 39: checkpoint, resume and optimizer state offload; every
    file under one temporary directory, removed at the end.  Returns each
    path's launches by kernel."""
    import shutil
    import tempfile
    import torch
    from apex_tpu_torch import _native
    _check(_native.available(), f"the native checkpoint library did not "
                                f"load: {_native.load_error}")
    print("native checkpoint library (csrc/apex_c.cpp, g++): loaded",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="apex_ckpt_")
    try:
        launches = ckpt_resnet_phase(dev, smi, tmp)
        torch.cuda.empty_cache()
        ckpt_gpt_phase(dev, smi, tmp)
        torch.cuda.empty_cache()
        launches.update(offload_state_phase(dev, smi, tmp))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


class _PhaseClock:
    """Host-clock seconds of each phase: ``with clock(name): ...`` prints
    the phase's seconds when it ends; ``summary`` prints every phase's
    in run order and their total."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name: str):
        import contextlib

        @contextlib.contextmanager
        def phase():
            t0 = time.perf_counter()
            yield
            self.seconds[name] = time.perf_counter() - t0
            print(f"phase seconds {name}: {self.seconds[name]:.1f} s",
                  flush=True)
        return phase()

    def summary(self, smi: str) -> None:
        print("phase seconds, in run order: " + "; ".join(
            f"{k} {v:.1f}" for k, v in self.seconds.items())
            + f"; total {sum(self.seconds.values()):.1f} s [{smi}]",
            flush=True)


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
                                    multi_tensor, softmax, welford,
                                    xentropy)
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

    timed = _PhaseClock()
    with timed("3-6 serve: kernel, serve, consistency, profile"), \
            torch.no_grad():
        entry = kernel_phase(dev, smi)
        eng, reqs, res = serve_phase(dev, smi, entry)
        consistency_phase(eng, reqs, res)
        profile_phase(eng, smi)
        del eng
    with timed("7 kernel vs plain (flat)"), torch.no_grad():
        flat_entries = flat_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("8 train (ResNet-50)"):
        o2_figures = train_phase(dev, smi, flat_entries)
    with timed("9 consistency (train)"):
        train_consistency_phase(dev)
    with timed("10 profile (train)"):
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
    with timed("11 kernel vs plain (BERT)"), torch.no_grad():
        bert_entries = bert_kernel_phase(dev, smi, sizes)
    torch.cuda.empty_cache()
    with timed("12-13 train and profile (BERT-L)"):
        opt, amp_state, step, batches = bert_train_phase(
            dev, smi, bert_entries, bert_params)
        bert_profile_phase(dev, smi, step, amp_state, batches)
        del opt, amp_state, step, batches
    torch.cuda.empty_cache()
    with timed("14 train (BERT-L, flash)"):
        bert_flash_train_phase(dev, smi, bert_params)
    with timed("26 kernel vs plain (cross entropy)"), torch.no_grad():
        xent_entries = xent_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("27 train (BERT, vocab 30592)"):
        bert_xent_train_phase(dev, smi, bert_params, xent_entries)
    del bert_params
    torch.cuda.empty_cache()
    with timed("28 BERT proxy"):
        proxy_launches = bert_proxy_phase(dev, smi)
    with timed("15 consistency (BERT)"):
        bert_consistency_phase(dev)

    with timed("16-17 kernel vs plain (flash train, flat_adam)"), \
            torch.no_grad():
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
    # the forward's entry: the bf16 training shape's body (GPT-2 small,
    # its launches from the GPT step), the serve path's f32 body beside it
    entry["serve_f32"] = dict(
        {k: entry[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms", "atol",
                               "rtol")},
        body=_flash_route_of(64, "f32")["flash_fwd"],
        shape="(4, 12, 1024, 64) f32 causal ragged")
    entry.update(rows["flash_fwd"], max_abs_err=worst["flash_fwd"],
                 atol=ATTN_TOL["bf16"][0], rtol=ATTN_TOL["bf16"][1],
                 shape="(8, 12, 512, 64) bf16 causal", launches=0)
    with timed("18-19 train and profile (GPT block)"):
        s, state, tokens = gpt_train_phase(dev, smi, [entry] + gpt_entries)
        gpt_profile_phase(dev, smi, s, state, tokens)
        del s, state, tokens
    torch.cuda.empty_cache()
    with timed("20 consistency (GPT block)"):
        gpt_consistency_phase(dev)
    with timed("35 train (GPTModel)"):
        gpt_model_phase(dev, smi, [entry] + flat_entries + bert_entries
                        + gpt_entries)
    with timed("36 consistency (GPTModel)"):
        gpt_model_consistency_phase(dev)

    with timed("31 kernel vs plain (attention dropout)"), torch.no_grad():
        drop_rows = dropout_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("32 path (attention dropout)"):
        drop_counts = dropout_path_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("33 consistency (attention dropout)"):
        dropout_consistency_phase(dev)
    with timed("34 wide heads (F5b, F5c)"):
        wide_rows = wide_head_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("37 narrow heads (D 16 and 32, bf16 and f32)"):
        narrow_rows = narrow_head_phase(dev, smi, proxy_launches)
    torch.cuda.empty_cache()
    for e in [entry] + gpt_entries:
        if e["name"] in drop_rows:
            e["dropout"] = dict(drop_rows[e["name"]],
                                launches=drop_counts[e["name"]])
        if e["name"] in wide_rows:
            e.update(wide_rows[e["name"]])
        if e["name"] in narrow_rows:
            e.update(narrow_rows[e["name"]])
        for key in ("d32_f32", "d32_proxy_f32"):
            if key in e:
                e[key]["launches"] = proxy_launches[e["name"] + "_f32"]

    t0 = time.perf_counter()
    gpt_params = gpt_train_block.GPTBlocks(
        GPT["vocab"], GPT["hidden"], GPT["heads"], GPT["layers"],
        max_seq=GPT["seq"]).init(0, "cpu")
    gpt_sizes = [t.numel() for t in tree_leaves(gpt_params)]
    print(f"gpt-2 small init on the cpu: {sum(gpt_sizes)} parameters in "
          f"{len(gpt_sizes)} tensors, {time.perf_counter() - t0:.1f} s",
          flush=True)
    with timed("21 kernel vs plain (optimizer tail)"), torch.no_grad():
        tail_entries = opt_tail_kernel_phase(dev, smi, gpt_sizes)
    torch.cuda.empty_cache()
    with timed("22 train (GPT block, NovoGrad)"):
        novograd_train_phase(dev, smi, gpt_params, tail_entries)
    torch.cuda.empty_cache()
    with timed("23 train (legacy fp16_utils)"):
        legacy_train_phase(dev, smi, gpt_params, tail_entries)
    del gpt_params
    torch.cuda.empty_cache()

    with timed("24 kernel vs plain (softmax)"), torch.no_grad():
        softmax_entries = softmax_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("25 path (softmax attention)"):
        softmax_attention_phase(dev, smi, softmax_entries)
    torch.cuda.empty_cache()

    with timed("29 kernel vs plain (Welford)"), torch.no_grad():
        welford_entry = welford_kernel_phase(dev, smi)
    torch.cuda.empty_cache()
    with timed("30 train (ResNet-50, --sync-bn)"):
        syncbn_train_phase(dev, smi, welford_entry)
    torch.cuda.empty_cache()
    with timed("38 amp O1 and offload"):
        o1_launches = o1_offload_phase(dev, smi, o2_figures)
    torch.cuda.empty_cache()
    with timed("39 checkpoint, resume and offload"):
        ckpt_launches = checkpoint_phase(dev, smi)
    torch.cuda.empty_cache()
    timed.summary(smi)
    all_entries = ([entry] + flat_entries + bert_entries + gpt_entries
                   + tail_entries + softmax_entries + xent_entries
                   + [welford_entry])
    for e in all_entries:
        # the launches on phase 38's paths (O1 and offload), by path
        paths = {path: got[e["name"]] for path, got in o1_launches.items()
                 if got.get(e["name"])}
        if paths:
            e["o1_offload_launches"] = paths
        # phase 39's paths (resumed ResNet-50 runs, BERT-L --offload-state)
        paths = {path: got[e["name"]] for path, got in ckpt_launches.items()
                 if got.get(e["name"])}
        if paths:
            e["ckpt_offload_launches"] = paths

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "atol", "rtol")
    kernels = [dict({k: e[k] for k in keys},
                    **{k: e[k] for k in ("body", "shape", "serve_f32",
                                         "dropout", "d256", "d512",
                                         "d1024", "d32_proxy", "d32_f32",
                                         "d32_proxy_f32",
                                         "gpt_model_launches",
                                         "o1_offload_launches",
                                         "ckpt_offload_launches")
                       if k in e})
               for e in all_entries]
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
