"""Fused LayerNorm / RMSNorm, forward and backward, and the plain twins.

The port of ``apex_tpu.ops.layer_norm``.  On the reference's gate
(:func:`_use_pallas`: the last dim a multiple of 128, one 8-row block
within the per-operand budget) the op is a ``torch.autograd.Function``
mirroring the reference's ``_norm_affine`` custom VJP: the forward saves
``x, w, b`` and the backward recomputes the statistics.  A tensor on the
card goes to the hand-written kernels of ``csrc/layer_norm.cu`` (the
port of ``_fwd_2d`` / ``_bwd_2d``); a tensor on the CPU goes to their
plain twins (:func:`_fwd_2d_ref`, :func:`_bwd_2d_ref`, the kernel
bodies' formulas in plain PyTorch).  The forward has two hand-written
bodies, chosen by :func:`fwd_route` on shape and layout: the register
one (rows in registers from 16-byte loads, a persistent grid) for rows
up to :data:`FUSED_MAX_H` that start 16-byte aligned, one block a row
otherwise ("wide").  So has the backward, chosen by :func:`bwd_route`:
the fused one (two launches, one read of x and dy) under the same rule,
three launches otherwise.  Off the gate the reference computes
the XLA formula and its autodiff, and so does the port: the plain
formula under torch's autograd, on either device (the reference's own
routing, not a fallback).  There is no other switch; a tensor on the
card that the kernels do not take raises.

All statistics and sums are f32 whatever the storage dtype; the output
and ``dx`` take ``x``'s dtype, ``dw``/``db`` come back f32 and are cast
to the params' dtypes; RMSNorm's bias gradient is zero.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build, _numerics

LANE = 128
_VMEM_BUDGET = 1024 * 1024  # the reference's per-operand block budget
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_CHUNK = 64         # rows of one dw/db partial (three launches)
_MAX_CHUNKS = 65535         # the grid's y limit (three launches)
FUSED_MAX_H = 8192          # the widest row the register forward and the
                            # fused backward hold in registers
                            # (csrc/layer_norm.cu)
# device kernels one backward call launches, by route
BWD_DEVICE_KERNELS = {"fused": 2, "three": 3}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

LN_FWD = _build.Kernel(
    "layer_norm", "apex_layer_norm_fwd",
    [_P, _I, _P, _P, _I, _P, _L, _I, _F, _I, _I, _P], name="layer_norm_fwd")
LN_BWD = _build.Kernel(
    "layer_norm", "apex_layer_norm_bwd",
    [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _I, _I,
     _I, _P], name="layer_norm_bwd")


def _use_pallas(h: int) -> bool:
    """The reference's gate: the kernels take the last dim when it is a
    multiple of 128 and one 8-row f32 block fits the 1 MiB budget."""
    return h % LANE == 0 and 8 * h * 4 <= _VMEM_BUDGET


# ---------------------------------------------------------------------------
# the plain formulas (the reference's XLA path and test oracles)
# ---------------------------------------------------------------------------

def layer_norm_ref(x, weight=None, bias=None, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * _numerics.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm_ref(x, weight=None, eps=1e-5):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * _numerics.rsqrt(ms + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _stats(xf, eps, rms):
    """``(xhat, rstd)`` of f32 rows, the kernel bodies' order."""
    if rms:
        rstd = _numerics.rsqrt((xf * xf).mean(1, keepdim=True) + eps)
        return xf * rstd, rstd
    xc = xf - xf.mean(1, keepdim=True)
    rstd = _numerics.rsqrt((xc * xc).mean(1, keepdim=True) + eps)
    return xc * rstd, rstd


def _fwd_2d_ref(x2d, w, b, eps, rms):
    """``_ln_fwd_kernel`` in plain PyTorch: y in x's dtype."""
    xhat, _ = _stats(x2d.float(), eps, rms)
    return (xhat * w.float() + b.float()).to(x2d.dtype)


def _bwd_2d_ref(x2d, w, dy2d, eps, rms):
    """``_ln_bwd_kernel`` in plain PyTorch: ``(dx in x's dtype, dw f32,
    db f32)``, dw/db summed over the rows."""
    xhat, rstd = _stats(x2d.float(), eps, rms)
    dy = dy2d.float()
    dyw = dy * w.float()
    m2 = (dyw * xhat).mean(1, keepdim=True)
    if rms:
        dx = (dyw - xhat * m2) * rstd
    else:
        dx = (dyw - dyw.mean(1, keepdim=True) - xhat * m2) * rstd
    return dx.to(x2d.dtype), (dy * xhat).sum(0), dy.sum(0)


# ---------------------------------------------------------------------------
# the wrappers: CUDA tensor -> kernel, CPU tensor -> twin
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, device, shape) -> None:
    if len(shape) == 2 and shape[0] >= 2 ** 31:
        raise ValueError(f"fused_layer_norm kernel: {shape[0]} rows exceed "
                         "the grid's 2^31 - 1 blocks")
    if t.device != device:
        raise ValueError(f"fused_layer_norm: {name} is on {t.device}, "
                         f"x on {device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_layer_norm kernel takes {name} in float32 "
                        f"or bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_layer_norm: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_layer_norm kernel takes a contiguous {name}")


def _params_for_kernel(w, b):
    """w and b in one dtype: as they are when they share one, else both
    f32 (exact: the kernel reads them in f32 anyway)."""
    if w.dtype == b.dtype:
        return w, b
    return w.float(), b.float()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _fwd_2d(x2d, w, b, eps, rms):
    if x2d.device.type == "cpu":
        return _fwd_2d_ref(x2d, w, b, eps, rms)
    rows, h = x2d.shape
    dev = x2d.device
    _check("x", x2d, dev, (rows, h))
    w, b = _params_for_kernel(w.contiguous(), b.contiguous())
    _check("weight", w, dev, (h,))
    _check("bias", b, dev, (h,))
    y = torch.empty_like(x2d)
    if rows:
        reg = fwd_route(x2d) == "register"
        with torch.cuda.device(dev):
            LN_FWD.launch(x2d.data_ptr(), _DTYPE_CODE[x2d.dtype], w.data_ptr(),
                          b.data_ptr(), _DTYPE_CODE[w.dtype], y.data_ptr(),
                          rows, h, float(eps), int(bool(rms)), int(reg),
                          _stream(dev))
    return y


def fwd_route(x2d: torch.Tensor) -> str:
    """The forward body a (rows, h) call takes on the card:
    ``"register"`` (each row in registers from 16-byte loads, a
    persistent grid) when h is a multiple of 8 up to
    :data:`FUSED_MAX_H` and x starts 16-byte aligned, else ``"wide"``
    (one block a row, scalar loads, any h and row start).  A dispatch on
    shape and layout: both bodies are hand-written kernels."""
    h = x2d.shape[-1]
    if h % 8 == 0 and h <= FUSED_MAX_H and x2d.data_ptr() % 16 == 0:
        return "register"
    return "wide"


def bwd_route(x2d: torch.Tensor, dy2d: torch.Tensor) -> str:
    """The backward body a (rows, h) call takes on the card: ``"fused"``
    (two launches that read x and dy once) when h is a multiple of 8 up
    to :data:`FUSED_MAX_H` and x and dy start 16-byte aligned (its
    16-byte vector loads), else ``"three"`` (dx, the dw/db partials and
    their combine, scalar loads, any row start).  A dispatch on shape
    and layout: both bodies are hand-written kernels."""
    h = x2d.shape[-1]
    if (h % 8 == 0 and h <= FUSED_MAX_H and x2d.data_ptr() % 16 == 0
            and dy2d.data_ptr() % 16 == 0):
        return "fused"
    return "three"


def _chunking(rows: int, route: str) -> Tuple[int, int]:
    """``(rows a dw/db partial sums, partials)``: a fixed function of the
    row count, so the bits are the same on every card.  The fused body
    takes about 1/1024 of the rows a CTA (8 .. 64, a multiple of 8)."""
    if route == "fused":
        per_chunk = min(64, max(8, -(-rows // 1024) * 8))
    else:
        per_chunk = max(ROWS_PER_CHUNK, -(-rows // _MAX_CHUNKS))
    return per_chunk, -(-rows // per_chunk)


def _bwd_2d(x2d, w, dy2d, eps, rms):
    if x2d.device.type == "cpu":
        return _bwd_2d_ref(x2d, w, dy2d, eps, rms)
    rows, h = x2d.shape
    dev = x2d.device
    _check("x", x2d, dev, (rows, h))
    dy2d = dy2d.contiguous()
    _check("dy", dy2d, dev, (rows, h))
    if dy2d.dtype != x2d.dtype:
        raise TypeError(f"fused_layer_norm backward: dy is {dy2d.dtype}, "
                        f"x {x2d.dtype}")
    w = w.contiguous()
    _check("weight", w, dev, (h,))
    dx = torch.empty_like(x2d)
    dw = torch.empty(h, dtype=torch.float32, device=dev)
    db = torch.empty(h, dtype=torch.float32, device=dev)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    route = bwd_route(x2d, dy2d)
    per_chunk, chunks = _chunking(rows, route)
    # the three-launch body keeps each row's statistics for its second
    # kernel; null scratch asks the C entry point for the fused body
    stats = ((None, None) if route == "fused" else
             tuple(torch.empty(rows, dtype=torch.float32, device=dev)
                   for _ in range(2)))
    part = torch.empty(2, chunks, h, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        LN_BWD.launch(x2d.data_ptr(), _DTYPE_CODE[x2d.dtype], w.data_ptr(),
                      _DTYPE_CODE[w.dtype], dy2d.data_ptr(), dx.data_ptr(),
                      *(None if t is None else t.data_ptr() for t in stats),
                      part[0].data_ptr(), part[1].data_ptr(), dw.data_ptr(),
                      db.data_ptr(), rows, h, float(eps), int(bool(rms)),
                      per_chunk, chunks, _stream(dev))
    return dx, dw, db


class _NormAffine(torch.autograd.Function):
    """The reference's ``_norm_affine`` custom VJP: save ``x, w, b``,
    recompute the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, w, b, eps, rms):
        h = x.shape[-1]
        x2d = x.reshape(-1, h)
        ctx.save_for_backward(x, w, b)
        ctx.eps, ctx.rms = eps, rms
        return _fwd_2d(x2d.contiguous(), w, b, eps, rms).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        h = x.shape[-1]
        dx, dw, db = _bwd_2d(x.reshape(-1, h).contiguous(), w,
                             dy.reshape(-1, h), ctx.eps, ctx.rms)
        db = torch.zeros_like(b) if ctx.rms else db.to(b.dtype)
        return dx.reshape(x.shape), dw.to(w.dtype), db, None, None


def _affine(x, weight, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x.shape[-1]
    w = weight if weight is not None else torch.ones(h, device=x.device)
    b = bias if bias is not None else torch.zeros(h, device=x.device)
    return w, b


def fused_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                     memory_efficient: bool = True) -> torch.Tensor:
    """LayerNorm over the last dim.  ``memory_efficient`` is accepted for
    the reference's API: the backward always recomputes the
    statistics."""
    del memory_efficient
    w, b = _affine(x, weight, bias)
    if not _use_pallas(x.shape[-1]):
        return layer_norm_ref(x, w, b, eps)
    return _NormAffine.apply(x, w, b, float(eps), False)


def fused_rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                   eps: float = 1e-5, memory_efficient: bool = True
                   ) -> torch.Tensor:
    """RMSNorm over the last dim."""
    del memory_efficient
    w, b = _affine(x, weight, None)
    if not _use_pallas(x.shape[-1]):
        return rms_norm_ref(x, w, eps)
    return _NormAffine.apply(x, w, b, float(eps), True)
