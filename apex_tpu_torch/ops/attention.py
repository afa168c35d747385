"""Flash-attention forward on the card, and its plain PyTorch twin.

:func:`flash_attention` is the port of ``apex_tpu.ops.attention.
flash_attention`` on its inference path (forward only, no dropout):
(B, H, S, D) layout, causal and segment masks, grouped-query heads
(k/v may carry fewer heads than q), and exact zeros for a query row
that sees no key.  A tensor on the card goes to the hand-written kernel
``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_fwd_pallas``); a
tensor on the CPU goes to :func:`flash_attention_ref`, the same
function in plain PyTorch over :func:`attention_ref`.  There is no
other switch, and nothing falls back: a tensor on the card that the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build

_NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
BACKWARD_TODO = (
    "flash_attention on the card is forward only: its backward kernels "
    "(ROADMAP Queue 2 rows 2-3, dq and dk/dv) are not ported yet, so a "
    "call that would need gradients for q, k or v raises rather than "
    "return an output with none; run it under torch.no_grad(), or on the "
    "CPU, where flash_attention_ref is differentiable")

FLASH_FWD = _build.Kernel(
    "flash_fwd", "apex_flash_fwd_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p])


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


def attention_ref(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention; ``mask`` is additive ``(B, 1|H, Sq, Sk)`` or
    None.  Grouped-query shapes repeat k/v across the query heads.  f32
    throughout (no TF32: the caller leaves
    ``torch.backends.cuda.matmul.allow_tf32`` at its default False)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
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


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        segment_ids: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None
                        ) -> torch.Tensor:
    """:func:`flash_attention` in plain PyTorch: the segment mask as an
    additive mask on :func:`attention_ref`, then exact zeros on every
    row that sees no key (plain softmax over an all-masked row would
    give the mean of V)."""
    if segment_ids is None:
        return attention_ref(q, k, v, causal=causal, scale=scale)
    q_ids, kv_ids = segment_ids
    same = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    o = attention_ref(q, k, v, causal=causal, scale=scale,
                      mask=torch.where(same, 0.0, _NEG))
    visible = same
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        visible = visible & (torch.arange(sk, device=q.device)[None, :]
                             <= torch.arange(sq, device=q.device)[:, None])
    any_kv = visible.any(dim=-1)                       # (B, 1, Sq)
    return torch.where(any_kv[..., None], o, 0.0).to(q.dtype)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    segment_ids: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Scaled-dot-product attention, (B, H, S, D) layout, forward only
    on the card: with grad enabled and any of q, k, v requiring grad it
    raises ``NotImplementedError`` there (the backward kernels are not
    ported), never an output detached from them.

    ``segment_ids``: optional ``(q_ids (B, Sq), kv_ids (B, Sk))``;
    attention is masked where the ids differ.  k/v may carry fewer
    heads than q (``H % HK == 0``): query head ``h`` attends kv head
    ``h // (H // HK)``.  ``scale`` defaults to ``1/sqrt(D)``."""
    h, hk = q.shape[1], k.shape[1]
    if h % hk or v.shape[1] != hk:
        raise ValueError(
            f"flash_attention: q heads ({h}) must be a multiple of kv "
            f"heads ({hk}, v: {v.shape[1]})")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segment_ids)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(BACKWARD_TODO)
    return _flash_fwd_cuda(q, k, v, causal, scale, segment_ids)


def _check(name: str, t: torch.Tensor, dtype, device, shape,
           align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention kernel takes {dtype} {name}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention kernel takes a contiguous "
                         f"{name}")
    if t.data_ptr() % align:
        raise ValueError(f"flash_attention kernel reads {name} in "
                         f"{align}-byte words; its data must start "
                         f"{align}-byte aligned")


def _flash_fwd_cuda(q, k, v, causal, scale, segment_ids) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, D) tensors")
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel: B*H = {b * h} exceeds "
                         "the grid's 65535")
    _check("q", q, torch.float32, q.device, (b, h, sq, d))
    _check("k", k, torch.float32, q.device, (b, hk, sk, d))
    _check("v", v, torch.float32, q.device, (b, hk, sk, d))
    q_ptr = kv_ptr = None
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids
        _check("q_ids", q_ids, torch.int32, q.device, (b, sq), align=4)
        _check("kv_ids", kv_ids, torch.int32, q.device, (b, sk), align=4)
        q_ptr, kv_ptr = q_ids.data_ptr(), kv_ids.data_ptr()
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    sc = scale if scale is not None else _default_scale(d)
    with torch.cuda.device(q.device):
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            q_ptr, kv_ptr, b, h, hk, sq, sk, d, int(bool(causal)),
            float(sc), torch.cuda.current_stream(q.device).cuda_stream)
    return o
