"""Flash attention on the card, forward and backward, and its plain
PyTorch twins.

:func:`flash_attention` is the port of ``apex_tpu.ops.attention.
flash_attention``: (B, H, S, D) layout, f32 or bf16, causal and segment
masks, grouped-query heads (k/v may carry fewer heads than q), exact
zeros for a query row that sees no key, the fused probability dropout
(the reference's counter hash of (seed, b*H + h, q row, key); no mask is
stored, every kernel rebuilds it: :func:`dropout_keep_ref`), and
gradients for q, k and v.  A tensor on the card goes to the hand-written
kernels: ``csrc/flash_fwd.cu`` (the port of the TPU kernel
``_fwd_pallas``, with the logsumexp output when a gradient will be
needed) and ``csrc/flash_bwd.cu`` (the dq and dk/dv kernels of
``_bwd_pallas``).  A tensor on the CPU goes to the twins
:func:`flash_fwd_ref` and :func:`flash_bwd_ref`, the same functions in
plain PyTorch, which repeat the reference kernels' arithmetic (bf16
roundings of ``p`` and ``ds`` included).  There is no other switch, and
nothing falls back.  As the reference pads D to its lanes, the wrappers
pad a head dim that is not a kernel width (16, 32, ..., 8192, the powers
of two, then the multiples of 8192) with zeros up to the next one
(:func:`_kernel_width`) and copy a strided or misaligned operand; every
head dim runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build

_NEG = -1e30
# the kernels' widths up to 8192, others padded: 1024 and wider (bf16: 512
# and wider) run the wide bodies; past 8192 a head pads to a multiple of
# WIDE_SPLIT
HEAD_DIMS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
WIDE_SPLIT = 8192          # csrc/hopper_mma.cuh: wide::SPLIT
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = {torch.float32: 16, torch.bfloat16: 8}   # one 4-element vector

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# ..., scale, dropout seed pointer (null: none), keep threshold, keep
# scale, stream
_DROP_ARGS = [_F, _P, _U, _F, _P]
FLASH_FWD = _build.Kernel("flash_fwd", "apex_flash_fwd",
                          [_P] * 7 + [_I] * 8 + _DROP_ARGS)
FLASH_DQ = _build.Kernel("flash_bwd", "apex_flash_dq",
                         [_P] * 9 + [_I] * 8 + _DROP_ARGS, name="flash_dq")
FLASH_DKV = _build.Kernel("flash_bwd", "apex_flash_dkv",
                          [_P] * 10 + [_I] * 8 + _DROP_ARGS, name="flash_dkv")

SegmentIds = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _default_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def packed_segment_ids(segment_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q_ids, kv_ids)`` for a packed batch's base segment array
    ``(B, S)`` (1.. per sequence, 0 on padding).  Padding gets disjoint
    ids per side (-1 on q, -2 on kv), so pad rows attend nowhere and
    output exact zeros."""
    return (torch.where(segment_ids > 0, segment_ids, -1),
            torch.where(segment_ids > 0, segment_ids, -2))


def _repeat_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """Grouped-query k/v repeated across the ``h`` query heads."""
    return x if x.shape[1] == h else x.repeat_interleave(h // x.shape[1],
                                                         dim=1)


# ---------------------------------------------------------------------------
# the fused probability dropout: the reference's counter hash
# ---------------------------------------------------------------------------
#
# apex_tpu/ops/attention.py:_fmix32/_keep_mask in int32 wraparound with
# logical shifts.  Here the 32 bits live in int64 tensors in [0, 2**32):
# torch's >> on int32 is arithmetic, and each product is taken in 16-bit
# halves so no int64 product overflows.

_M32 = 0xFFFFFFFF
_HEAD_MUL, _ROW_MUL, _COL_MUL = 0x9E3779B9, 0x9D62D51F, 0x78A76A79


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for ``x`` in [0, 2**32) and a constant m."""
    hi = ((x >> 16) * m) & 0xFFFF
    return ((x & 0xFFFF) * m + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer, as the reference's (``_fmix32``)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(rate: float) -> int:
    """The unsigned 32-bit hash below which a pair is kept, worked out
    in Python doubles as the reference does."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """``1 / (1 - rate)``; its product with an f32 tensor rounds it to
    f32, the reference's weakly typed constant."""
    return float(1.0 / (1.0 - rate))


def dropout_keep_ref(seed, b: int, h: int, sq: int, sk: int, rate: float,
                     device=None) -> torch.Tensor:
    """Bool ``(B, H, Sq, Sk)`` keep mask: the reference's
    ``dropout_keep_ref``, bit for bit.  ``seed``: an int32 as a Python
    int or a one-element integer tensor (read on its device, no host
    sync)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        s = seed.reshape(()).to(device=device, dtype=torch.int64) & _M32
    else:
        s = torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    head = _fmix32((s + _mul32(ar(b * h), _HEAD_MUL)) & _M32)
    key = (head[:, None, None] + _mul32(ar(sq), _ROW_MUL)[None, :, None]
           + _mul32(ar(sk), _COL_MUL)[None, None, :]) & _M32
    return (_fmix32(key) < keep_threshold(rate)).reshape(b, h, sq, sk)


def _dropped(x: torch.Tensor, keep: torch.Tensor, rate: float
             ) -> torch.Tensor:
    """``keep * x / (1 - rate)``, in x's f32."""
    return torch.where(keep, x * keep_scale(rate), 0.0)


def attention_ref(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  mask: Optional[torch.Tensor] = None,
                  dropout_rate: float = 0.0, dropout_seed=None
                  ) -> torch.Tensor:
    """Plain attention; ``mask`` is additive ``(B, 1|H, Sq, Sk)`` or
    None.  Grouped-query shapes repeat k/v across the query heads.  f32
    throughout (no TF32: the caller leaves
    ``torch.backends.cuda.matmul.allow_tf32`` at its default False).
    Dropout drops the probabilities with the kernels' hash
    (:func:`dropout_keep_ref`), so both drop the same pairs."""
    k, v = _repeat_kv(k, q.shape[1]), _repeat_kv(v, q.shape[1])
    sc = scale if scale is not None else _default_scale(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sc
    if mask is not None:
        s = s + mask
    if causal:
        sq, sk = s.shape[-2:]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(col > row, _NEG)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("attention_ref: dropout_rate > 0 requires "
                             "dropout_seed (an int32; vary it per step)")
        p = _dropped(p, dropout_keep_ref(dropout_seed, *p.shape,
                                         dropout_rate, p.device),
                     dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _visible(q, k, causal: bool, segment_ids: SegmentIds
             ) -> Optional[torch.Tensor]:
    """Bool ``(B|1, 1, Sq, Sk)``: the (row, col) pairs that attend, or
    None when nothing masks."""
    sq, sk = q.shape[2], k.shape[2]
    ok = None
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids
        ok = (q_ids[:, None, :, None] == kv_ids[:, None, None, :])
    if causal:
        tri = (torch.arange(sk, device=q.device)[None, :]
               <= torch.arange(sq, device=q.device)[:, None])[None, None]
        ok = tri if ok is None else ok & tri
    return ok


def flash_fwd_ref(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  segment_ids: SegmentIds = None, rate: float = 0.0,
                  seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel in plain PyTorch: ``(o, lse)``, ``lse`` f32
    ``(B*H, Sq)``.  The arithmetic of the reference's one-KV-block kernel
    (``_fwd_kernel_1kv``): f32 scores of the operands, masked scores set
    to -1e30, ``p = exp(s - rowmax)`` selected to 0 where masked, the
    row sum ``l`` of the unrounded, undropped ``p``; with ``rate > 0``,
    ``p`` becomes ``keep * p / (1 - rate)`` (:func:`dropout_keep_ref` at
    ``seed``) for ``P.V`` only; ``p`` rounded to v's dtype for ``P.V``,
    ``o = pv * (1/l)`` (0 where ``l == 0``: a row that sees no key gives
    exact zeros), ``lse = m + log(l)`` (-1e30 where ``l == 0``)."""
    b, h, sq, d = q.shape
    sc = scale if scale is not None else _default_scale(d)
    kx, vx = _repeat_kv(k, h), _repeat_kv(v, h)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * sc
    ok = _visible(q, k, causal, segment_ids)
    if ok is not None:
        s = torch.where(ok, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = _dropped(p, dropout_keep_ref(seed, b, h, sq, k.shape[2], rate,
                                         q.device), rate)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vx.float())
    has = l > 0.0
    o = pv * torch.where(has, 1.0 / l, 0.0)
    lse = torch.where(has, m + torch.log(l), _NEG)
    return o.to(q.dtype), lse.reshape(b * h, sq)


def flash_bwd_ref(q, k, v, o, lse, do, causal: bool = False,
                  scale: Optional[float] = None,
                  segment_ids: SegmentIds = None, rate: float = 0.0,
                  seed=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels in plain PyTorch: ``(dq, dk, dv)`` from the
    forward's ``o`` and ``lse`` (``(B*H, Sq)`` f32), the arithmetic of
    ``_dq_kernel``/``_dkv_kernel``: ``p = exp(s - lse)`` selected to 0
    where masked (``lse = -1e30`` on a row that sees no key makes exp
    overflow there), ``di = rowsum(dO * O)`` in f32, ``ds = p * (dp -
    di) * scale``; with ``rate > 0`` (the forward's mask at ``seed``)
    ``dp`` is ``keep * dp / (1 - rate)`` and dV takes ``keep * p / (1 -
    rate)``, while ``ds`` keeps the undropped ``p``; ``p`` rounds to
    dO's dtype before ``dV``, ``ds`` to q's before ``dQ`` and ``dK``; the
    grouped-query heads' dk/dv sum in f32 before their one rounding."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else _default_scale(d)
    kx, vx = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * sc
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    ok = _visible(q, k, causal, segment_ids)
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    di = (dof * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    pd = p
    if rate > 0.0:
        keep = dropout_keep_ref(seed, b, h, sq, sk, rate, q.device)
        dp, pd = _dropped(dp, keep, rate), _dropped(p, keep, rate)
    ds = (p * (dp - di) * sc).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(do.dtype).float(), dof)
    if hk != h:
        dk = dk.reshape(b, hk, h // hk, sk, d).sum(dim=2)
        dv = dv.reshape(b, hk, h // hk, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        segment_ids: SegmentIds = None) -> torch.Tensor:
    """The output of :func:`flash_fwd_ref` (rows that see no key are
    exact zeros; plain softmax over an all-masked row would give the
    mean of V)."""
    return flash_fwd_ref(q, k, v, causal, scale, segment_ids)[0]


def _fwd(q, k, v, causal, scale, segment_ids, need_lse, rate, seed):
    if q.device.type == "cpu":
        o, lse = flash_fwd_ref(q, k, v, causal, scale, segment_ids, rate,
                               seed)
        return o, (lse if need_lse else None)
    return _flash_fwd_cuda(q, k, v, causal, scale, segment_ids, need_lse,
                           rate, seed)


def _bwd(q, k, v, o, lse, do, causal, scale, segment_ids, rate, seed):
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, causal, scale, segment_ids,
                             rate, seed)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, segment_ids,
                           rate, seed)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps ``o``, the f32
    ``lse`` and the dropout seed (no probability tensor, no mask); the
    backward recomputes P and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, seed, causal, scale, rate):
        seg = None if q_ids is None else (q_ids, kv_ids)
        o, lse = _fwd(q, k, v, causal, scale, seg, True, rate, seed)
        ctx.save_for_backward(q, k, v, o, lse, q_ids, kv_ids, seed)
        ctx.causal, ctx.scale, ctx.rate = causal, scale, rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_ids, kv_ids, seed = ctx.saved_tensors
        seg = None if q_ids is None else (q_ids, kv_ids)
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                          ctx.scale, seg, ctx.rate, seed)
        return dq, dk, dv, None, None, None, None, None, None


def _seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as one int32 on ``device``, which the kernels
    read through a pointer.  A tensor seed must already be that one int32
    on q's device: it is passed by reference, so a captured graph replays
    the value its buffer holds then.  A Python int in int32's range is
    copied to the device at each call (a captured graph would replay the
    value it had at capture)."""
    if isinstance(seed, torch.Tensor):
        if (seed.numel() != 1 or seed.dtype != torch.int32
                or seed.device != device):
            raise ValueError(f"flash_attention: a dropout_seed tensor must "
                             f"be one int32 on {device} (q's device), got "
                             f"a {seed.dtype} tensor of shape "
                             f"{tuple(seed.shape)} on {seed.device}")
        return seed.reshape(1)
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"flash_attention: dropout_seed {seed} is not an "
                         "int32")
    return torch.tensor([seed], dtype=torch.int32, device=device)


def draw_seed(rate: float, generator: Optional[torch.Generator],
              seed=None):
    """The int32 seed of one call's dropout, or None at rate 0: ``seed``
    when the caller gives one, else one draw in [0, 2**31 - 1) from
    ``generator`` on its device (no host sync), the port's stand-in for
    flax's ``rngs={"dropout": key}``.  The modules with dropout take their
    seed from here."""
    if rate == 0.0:
        return None
    if seed is not None:
        return seed
    if generator is None:
        raise ValueError("attention dropout > 0 in training needs a "
                         "generator or a dropout_seed")
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    segment_ids: SegmentIds = None,
                    dropout_rate: float = 0.0, dropout_seed=None
                    ) -> torch.Tensor:
    """Scaled-dot-product attention, (B, H, S, D) layout, differentiable
    in q, k and v.

    ``segment_ids``: optional ``(q_ids (B, Sq), kv_ids (B, Sk))``;
    attention is masked where the ids differ.  k/v may carry fewer
    heads than q (``H % HK == 0``): query head ``h`` attends kv head
    ``h // (H // HK)``.  Mixed q/k/v dtypes are promoted to one
    (``torch.promote_types``) first.  ``scale`` defaults to
    ``1/sqrt(D)``.  The
    logsumexp is computed only when a gradient will be needed (grad
    enabled and any of q, k, v requiring it).

    ``dropout_rate`` in [0, 1) with ``dropout_seed`` (an int32: a Python
    int, or a one-element int32 tensor on q's device, read by reference;
    vary it per step) drops the
    probabilities of P.V with the reference's counter hash, and the
    backward drops the same pairs; the caller owns the train/eval
    switch (rate 0 in eval)."""
    h, hk = q.shape[1], k.shape[1]
    if h % hk or v.shape[1] != hk:
        raise ValueError(
            f"flash_attention: q heads ({h}) must be a multiple of kv "
            f"heads ({hk}, v: {v.shape[1]})")
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash_attention: dropout_rate must be in [0, 1), "
                         f"got {dropout_rate!r}")
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("flash_attention: dropout_rate > 0 requires "
                         "dropout_seed (an int32; vary it per step)")
    seed = _seed_tensor(dropout_seed, q.device) if rate > 0.0 else None
    # one dtype for q, k and v (the reference promotes before the kernel
    # or its fallback, so both paths agree on mixed inputs)
    if not (q.dtype == k.dtype == v.dtype):
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        q_ids, kv_ids = (None, None) if segment_ids is None else segment_ids
        return _FlashAttention.apply(q, k, v, q_ids, kv_ids, seed,
                                     bool(causal), scale, rate)
    return _fwd(q, k, v, causal, scale, segment_ids, False, rate, seed)[0]


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, device, shape,
           align: Optional[int] = None) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention kernel takes {name} in {dtype} "
                        f"(float32 or bfloat16, as q), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention kernel takes a contiguous "
                         f"{name}")
    align = align or _ALIGN[dtype]
    if t.data_ptr() % align:
        raise ValueError(f"flash_attention kernel reads {name} in "
                         f"{align}-byte words; its data must start "
                         f"{align}-byte aligned")


# the three flash kernels, which take one route by dtype and kernel width
_FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
_TC_ROUTES = ("tensor cores", "wide tensor cores")


def flash_route(kernel: str, dtype, d: int) -> str:
    """The body that ``kernel`` ("flash_fwd", "flash_dq" or "flash_dkv")
    takes on the card for operands of ``dtype`` at head dim ``d`` (padded
    to its kernel width first); all three take the same route.  bf16:
    "tensor cores" (``..._kernel_tc``, wgmma + TMA) at D 16, 32, 64, 128
    and 256, "wide tensor cores" (``..._kernel_tc_wide``) at 512 and every
    width from 1024, a CTA on a slice of the output's columns (256 of
    O's, 512 of dQ's, 256 of dK's and dV's).  f32: "wide CUDA cores"
    (``..._kernel_wide``, register tiles on the CUDA cores) at every
    width: from 1024 a thread-block cluster of column slices sharing the
    scores, a CTA on 32 rows and 1024 of O's or dQ's columns, or on 32
    key rows and 512 of dK's and dV's, 16 and 1024 past D 4096; at 256
    and 512 one CTA spans the row (64 query rows in the forward and dq,
    64 key rows at 256 and 32 at 512 in dk/dv); at 64 and 128 one CTA on
    a row too (64 query rows, 64 key rows); at 16 and 32 the same with 128
    threads a CTA.  The C dispatchers of ``csrc/flash_fwd.cu`` and
    ``csrc/flash_bwd.cu`` route the same way, apart from a forward with no
    keys, which takes the FMA body (``flash_fwd_kernel``, "CUDA cores")
    for f32 up to 128 and bf16 up to 512, the wide CUDA-core body past
    it; the ``apex_flash_*_cuda_cores`` entry points keep the FMA bodies
    of every width for timing in turns."""
    if kernel not in _FLASH_KERNELS:
        raise ValueError(f"flash_route: no kernel {kernel!r} (one of "
                         f"{sorted(_FLASH_KERNELS)})")
    # csrc/hopper_mma.cuh: wide::narrow_takes, row_takes and takes (f32);
    # wide::TC_MIN_D (bf16)
    if dtype != torch.bfloat16:
        return "wide CUDA cores"
    return "wide tensor cores" if _kernel_width(d) >= 512 else "tensor cores"


def _align(dtype, d: int) -> int:
    """The bytes q, k, v and dO must start aligned to: TMA's 16 where the
    call's kernels take either tensor-core route (:func:`flash_route`),
    else one 4-element vector."""
    tc = flash_route("flash_fwd", dtype, d) in _TC_ROUTES
    return 16 if tc else _ALIGN[dtype]


def _kernel_width(d: int) -> int:
    """The kernel width a head dim runs at: the next of
    :data:`HEAD_DIMS`, and past 8192 the next multiple of
    :data:`WIDE_SPLIT` (the reference pads D to its lanes the same way, and
    takes any D).  The f32 register-tile bodies take a row of 256 or 512
    whole (the forward, dq and dk/dv) and split a wider one into slices of
    1024 columns (512 in dk/dv up to D 4096), a cluster of up to 8 slices
    sharing the scores; the bf16 bodies into their slices of 256 and 512
    columns.  Every multiple of 8192 holds whole clusters and slices."""
    for w in HEAD_DIMS:
        if d <= w:
            return w
    return -(-d // WIDE_SPLIT) * WIDE_SPLIT


def _operands(*ts):
    """q, k, v (and dO) as the kernels take them: the head dim padded
    with zeros to its kernel width (zeros add nothing to q.k, give zero
    columns of P.V and leave rowsum(dO * O) as it is), a strided operand
    copied, a contiguous one that starts off its alignment cloned."""
    dt = ts[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes q in float32 or "
                        f"bfloat16, got {dt}")
    d = ts[0].shape[-1]
    w = _kernel_width(d)
    out = []
    for t in ts:
        if w != d:
            t = torch.nn.functional.pad(t, (0, w - d))
        t = t.contiguous()
        if t.data_ptr() % _align(t.dtype, w):
            t = t.clone()
        out.append(t)
    return out


def _ids(segment_ids: SegmentIds) -> SegmentIds:
    if segment_ids is None:
        return None
    return tuple(t.to(torch.int32).contiguous() for t in segment_ids)


def _geometry(q, k, v, segment_ids):
    """Checks what every kernel takes; returns ``(dims, dtype code, q_ids
    pointer, kv_ids pointer)``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, D) tensors")
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if _kernel_width(d) != d:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS} or a multiple of {WIDE_SPLIT}, got "
                         f"{d}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes q in float32 or "
                        f"bfloat16, got {q.dtype}")
    align = _align(q.dtype, d)
    _check("q", q, q.dtype, q.device, (b, h, sq, d), align)
    _check("k", k, q.dtype, q.device, (b, hk, sk, d), align)
    _check("v", v, q.dtype, q.device, (b, hk, sk, d), align)
    q_ptr = kv_ptr = None
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids
        _check("q_ids", q_ids, torch.int32, q.device, (b, sq), align=4)
        _check("kv_ids", kv_ids, torch.int32, q.device, (b, sk), align=4)
        q_ptr, kv_ptr = q_ids.data_ptr(), kv_ids.data_ptr()
    return (b, h, hk, sq, sk, d), _DTYPE_CODE[q.dtype], q_ptr, kv_ptr


def _dropout_args(rate: float, seed, device) -> tuple:
    """The kernels' last three dropout arguments: the seed's device
    pointer (None: no dropout), the keep threshold and the keep scale."""
    if rate == 0.0:
        return None, 0, 1.0
    _check("dropout_seed", seed, torch.int32, device, (1,), align=4)
    return seed.data_ptr(), keep_threshold(rate), keep_scale(rate)


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _flash_fwd_cuda(q, k, v, causal, scale, segment_ids, need_lse,
                    rate=0.0, seed=None):
    d = q.shape[-1]
    sc = float(scale if scale is not None else _default_scale(d))
    q, k, v = _operands(q, k, v)
    segment_ids = _ids(segment_ids)
    dims, code, q_ptr, kv_ptr = _geometry(q, k, v, segment_ids)
    b, h, hk, sq, sk, w = dims
    drop = _dropout_args(rate, seed, q.device)
    o = torch.empty_like(q)
    lse = (torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    if o.numel() == 0:
        return _unpad(o, d), lse
    with torch.cuda.device(q.device):
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), q_ptr, kv_ptr, code, b,
            h, hk, sq, sk, w, int(bool(causal)), sc, *drop,
            torch.cuda.current_stream(q.device).cuda_stream)
    return _unpad(o, d), lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, segment_ids,
                    rate=0.0, seed=None):
    d = q.shape[-1]
    sc = float(scale if scale is not None else _default_scale(d))
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    # di = rowsum(dO * O) in f32: plain XLA in the reference, a torch op here
    di = (do.float() * o.float()).sum(dim=-1)
    q, k, v, do = _operands(q, k, v, do.to(q.dtype))
    segment_ids = _ids(segment_ids)
    dims, code, q_ptr, kv_ptr = _geometry(q, k, v, segment_ids)
    b, h, hk, sq, sk, w = dims
    _check("do", do, q.dtype, q.device, q.shape, _align(q.dtype, w))
    _check("lse", lse, torch.float32, q.device, (b * h, sq), align=4)
    drop = _dropout_args(rate, seed, q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return tuple(_unpad(t.zero_(), d) for t in (dq, dk, dv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (code, b, h, hk, sq, sk, w, int(bool(causal)), sc, *drop,
              stream)
    with torch.cuda.device(q.device):
        FLASH_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                        dq.data_ptr(), q_ptr, kv_ptr, *common)
        FLASH_DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), q_ptr, kv_ptr, *common)
    return tuple(_unpad(t, d) for t in (dq, dk, dv))
