"""Flash attention on the card, forward and backward, and its plain
PyTorch twins.

:func:`flash_attention` is the port of ``apex_tpu.ops.attention.
flash_attention`` without dropout: (B, H, S, D) layout, f32 or bf16,
causal and segment masks, grouped-query heads (k/v may carry fewer heads
than q), exact zeros for a query row that sees no key, and gradients for
q, k and v.  A tensor on the card goes to the hand-written kernels:
``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_fwd_pallas``, with
the logsumexp output when a gradient will be needed) and
``csrc/flash_bwd.cu`` (the dq and dk/dv kernels of ``_bwd_pallas``).  A
tensor on the CPU goes to the twins :func:`flash_fwd_ref` and
:func:`flash_bwd_ref`, the same functions in plain PyTorch, which repeat
the reference kernels' arithmetic (bf16 roundings of ``p`` and ``ds``
included).  There is no other switch, and nothing falls back: a tensor
on the card that the kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build

_NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = {torch.float32: 16, torch.bfloat16: 8}   # one 4-element vector
DROPOUT_TODO = (
    "flash_attention's fused probability dropout (the counter-hash mask "
    "of apex_tpu/ops/attention.py:_keep_mask) is not ported yet: ROADMAP "
    "Queue 1, slice 4 item 11a; pass dropout_rate=0")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FLASH_FWD = _build.Kernel("flash_fwd", "apex_flash_fwd",
                          [_P] * 7 + [_I] * 8 + [_F, _P])
FLASH_DQ = _build.Kernel("flash_bwd", "apex_flash_dq",
                         [_P] * 9 + [_I] * 8 + [_F, _P], name="flash_dq")
FLASH_DKV = _build.Kernel("flash_bwd", "apex_flash_dkv",
                          [_P] * 10 + [_I] * 8 + [_F, _P], name="flash_dkv")

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


def attention_ref(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention; ``mask`` is additive ``(B, 1|H, Sq, Sk)`` or
    None.  Grouped-query shapes repeat k/v across the query heads.  f32
    throughout (no TF32: the caller leaves
    ``torch.backends.cuda.matmul.allow_tf32`` at its default False)."""
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
                  segment_ids: SegmentIds = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel in plain PyTorch: ``(o, lse)``, ``lse`` f32
    ``(B*H, Sq)``.  The arithmetic of the reference's one-KV-block kernel
    (``_fwd_kernel_1kv``): f32 scores of the operands, masked scores set
    to -1e30, ``p = exp(s - rowmax)`` selected to 0 where masked, the
    row sum ``l`` of the unrounded ``p``, ``p`` rounded to v's dtype for
    ``P.V``, ``o = pv * (1/l)`` (0 where ``l == 0``: a row that sees no
    key gives exact zeros), ``lse = m + log(l)`` (-1e30 where ``l ==
    0``)."""
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
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vx.float())
    has = l > 0.0
    o = pv * torch.where(has, 1.0 / l, 0.0)
    lse = torch.where(has, m + torch.log(l), _NEG)
    return o.to(q.dtype), lse.reshape(b * h, sq)


def flash_bwd_ref(q, k, v, o, lse, do, causal: bool = False,
                  scale: Optional[float] = None,
                  segment_ids: SegmentIds = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels in plain PyTorch: ``(dq, dk, dv)`` from the
    forward's ``o`` and ``lse`` (``(B*H, Sq)`` f32), the arithmetic of
    ``_dq_kernel``/``_dkv_kernel``: ``p = exp(s - lse)`` selected to 0
    where masked (``lse = -1e30`` on a row that sees no key makes exp
    overflow there), ``di = rowsum(dO * O)`` in f32, ``ds = p * (dp -
    di) * scale``; ``p`` rounds to dO's dtype before ``dV``, ``ds`` to
    q's before ``dQ`` and ``dK``; the grouped-query heads' dk/dv sum in
    f32 before their one rounding."""
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
    ds = (p * (dp - di) * sc).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
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


def _fwd(q, k, v, causal, scale, segment_ids, need_lse):
    if q.device.type == "cpu":
        o, lse = flash_fwd_ref(q, k, v, causal, scale, segment_ids)
        return o, (lse if need_lse else None)
    return _flash_fwd_cuda(q, k, v, causal, scale, segment_ids, need_lse)


def _bwd(q, k, v, o, lse, do, causal, scale, segment_ids):
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, causal, scale, segment_ids)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, segment_ids)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps ``o`` and the
    f32 ``lse`` (no probability tensor); the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, causal, scale):
        seg = None if q_ids is None else (q_ids, kv_ids)
        o, lse = _fwd(q, k, v, causal, scale, seg, need_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, q_ids, kv_ids)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_ids, kv_ids = ctx.saved_tensors
        seg = None if q_ids is None else (q_ids, kv_ids)
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                          ctx.scale, seg)
        return dq, dk, dv, None, None, None, None


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
    enabled and any of q, k, v requiring it).  ``dropout_rate > 0``
    raises ``NotImplementedError`` (:data:`DROPOUT_TODO`) on every
    device."""
    h, hk = q.shape[1], k.shape[1]
    if h % hk or v.shape[1] != hk:
        raise ValueError(
            f"flash_attention: q heads ({h}) must be a multiple of kv "
            f"heads ({hk}, v: {v.shape[1]})")
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash_attention: dropout_rate must be in [0, 1), "
                         f"got {dropout_rate!r}")
    if rate > 0.0:
        raise NotImplementedError(DROPOUT_TODO)
    # one dtype for q, k and v (the reference promotes before the kernel
    # or its fallback, so both paths agree on mixed inputs)
    if not (q.dtype == k.dtype == v.dtype):
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        q_ids, kv_ids = (None, None) if segment_ids is None else segment_ids
        return _FlashAttention.apply(q, k, v, q_ids, kv_ids, bool(causal),
                                     scale)
    return _fwd(q, k, v, causal, scale, segment_ids, need_lse=False)[0]


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


def _align(dtype, d: int) -> int:
    """The bytes q, k, v and dO must start aligned to: TMA's 16 where the
    kernels take the tensor-core route (bf16 at D 64 and 128), else one
    4-element vector."""
    return 16 if dtype == torch.bfloat16 and d in (64, 128) else _ALIGN[dtype]


def _geometry(q, k, v, segment_ids):
    """Checks what every kernel takes; returns ``(dims, dtype code, q_ids
    pointer, kv_ids pointer)``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, D) tensors")
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if max(b * h, b * hk) > 65535:
        raise ValueError(f"flash_attention kernel: B*H = {b * h} exceeds "
                         "the grid's 65535")
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


def _flash_fwd_cuda(q, k, v, causal, scale, segment_ids, need_lse):
    dims, code, q_ptr, kv_ptr = _geometry(q, k, v, segment_ids)
    b, h, hk, sq, sk, d = dims
    o = torch.empty_like(q)
    lse = (torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    if o.numel() == 0:
        return o, lse
    sc = scale if scale is not None else _default_scale(d)
    with torch.cuda.device(q.device):
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), q_ptr, kv_ptr, code, b,
            h, hk, sq, sk, d, int(bool(causal)), float(sc),
            torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, segment_ids):
    dims, code, q_ptr, kv_ptr = _geometry(q, k, v, segment_ids)
    b, h, hk, sq, sk, d = dims
    _check("o", o, q.dtype, q.device, q.shape)
    _check("do", do, q.dtype, q.device, q.shape, _align(q.dtype, d))
    _check("lse", lse, torch.float32, q.device, (b * h, sq), align=4)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # di = rowsum(dO * O) in f32: plain XLA in the reference, a torch op here
    di = (do.float() * o.float()).sum(dim=-1)
    sc = float(scale if scale is not None else _default_scale(d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (code, b, h, hk, sq, sk, d, int(bool(causal)), sc, stream)
    with torch.cuda.device(q.device):
        FLASH_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                        dq.data_ptr(), q_ptr, kv_ptr, *common)
        FLASH_DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), q_ptr, kv_ptr, *common)
    return dq, dk, dv
