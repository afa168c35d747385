"""Scaled, masked and causal softmax over the last dim, forward and
backward: the port of ``apex_tpu.ops.softmax``.

``softmax(x * scale)`` per row in f32, masked entries filled with -10000
after the scale; a row whose max is at most -5000 (every entry masked)
gives exact zeros; the output takes x's dtype.  The backward is the
softmax VJP from the saved output ``y``: ``dx = (dy - sum(y * dy)) * y *
scale`` in f32, cast to y's dtype; masked entries have ``y == 0``, so it
needs no mask.

Layouts match the reference:
  scaled_masked_softmax:              x (b, np, sq, sk), mask (b, 1, sq, sk)
                                      (nonzero = masked) or None
  scaled_upper_triang_masked_softmax: x (attn_batches, sq, sq)

The reference routes on its gate (:func:`_use_pallas`: sk a multiple of
128, at most 4096; the masked forward also needs a row block that divides
sq, :func:`_divisor_block`) to three Pallas kernels, and otherwise to
the XLA formula.  The port keeps the gate exactly.  On it, a tensor on
the card goes to the hand-written kernels of ``csrc/softmax.cu``
(``softmax_fwd`` for the unmasked and causal forward, ROADMAP Queue 2
row 17; ``softmax_masked_fwd``, row 18; ``softmax_bwd``, row 19) and a
tensor on the CPU to their plain versions, the ``*_ref`` functions
below.  Off it the plain versions run on either device, as the
reference's XLA path does (not a fallback: the reference's own routing).
The backward's gate is sk's alone, so it may launch its kernel where the
forward did not (masked, sq not a multiple of 8).  The reference's
dispatch-preference switch (``op_enabled``) has no counterpart here.

On the gate the masked kernel reads the mask as the reference's
``mask.reshape(b * sq, sk)`` does: one ``(sq, sk)`` mask a batch row,
never copied across the heads; a mask of any other size raises
``TypeError`` (a ``(1, 1, sq, sk)`` mask with b > 1 included), as the
reference's reshape does.  A ``bool`` or ``uint8`` mask is read in
place; any other dtype costs one ``(b, sq, sk)`` byte mask per call
(``mask != 0``: one read of the mask, b * sq * sk bytes written).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from apex_tpu_torch import _build

LANE = 128
_MAX_SK = 4096          # the reference's row-length cap
_NEG = -10000.0         # the reference's mask fill value

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ALIGN = 16             # the kernels move 16-byte vectors

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

SOFTMAX_FWD = _build.Kernel(
    "softmax", "apex_softmax_fwd", [_P, _I, _P, _L, _I, _I, _I, _F, _P],
    name="softmax_fwd")
SOFTMAX_MASKED_FWD = _build.Kernel(
    "softmax", "apex_softmax_masked_fwd",
    [_P, _I, _P, _P, _L, _I, _I, _I, _F, _P], name="softmax_masked_fwd")
SOFTMAX_BWD = _build.Kernel(
    "softmax", "apex_softmax_bwd", [_P, _P, _I, _P, _L, _I, _F, _P],
    name="softmax_bwd")


# ---------------------------------------------------------------------------
# the reference's gate, copied exactly
# ---------------------------------------------------------------------------

def _block_rows_cap(sk: int) -> int:
    rows = max(8, min(256, (512 * 1024) // (sk * 4)))
    return rows - rows % 8


def _divisor_block(sq: int, cap: int) -> int:
    """Largest multiple of 8 that divides sq, at most cap (0 if none)."""
    br = min(cap, sq)
    br -= br % 8
    while br >= 8:
        if sq % br == 0:
            return br
        br -= 8
    return 0


def _use_pallas(sk: int) -> bool:
    return sk % LANE == 0 and sk <= _MAX_SK


# ---------------------------------------------------------------------------
# the plain versions (the reference's XLA path and the kernels' twins)
# ---------------------------------------------------------------------------

def _finish_rows_ref(xf):
    m = xf.amax(dim=-1, keepdim=True)
    e = torch.exp(xf - m)
    s = e.sum(dim=-1, keepdim=True)
    return torch.where(m > _NEG / 2, e / s, 0.0)


def scaled_masked_softmax_ref(x, mask, scale):
    xf = x.float() * scale
    if mask is not None:
        xf = torch.where(mask != 0, _NEG, xf)
    return _finish_rows_ref(xf).to(x.dtype)


def scaled_upper_triang_masked_softmax_ref(x, scale):
    sq = x.shape[-1]
    causal = torch.ones(sq, sq, dtype=torch.bool, device=x.device).tril()
    xf = torch.where(causal, x.float() * scale, _NEG)
    return _finish_rows_ref(xf).to(x.dtype)


def softmax_vjp_ref(y, dy, scale):
    """The backward's formula: ``(dy - sum(y * dy)) * y * scale`` in f32,
    in y's dtype."""
    yf, dyf = y.float(), dy.float()
    inner = (yf * dyf).sum(dim=-1, keepdim=True)
    return ((dyf - inner) * yf * scale).to(y.dtype)


# ---------------------------------------------------------------------------
# the wrappers: CUDA tensor -> kernel, CPU tensor -> plain version
# ---------------------------------------------------------------------------

def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _for_kernel(name: str, t: torch.Tensor, device, dtype=None):
    """``t`` contiguous and 16-byte aligned (a copy only when it is
    not), after checking its device and dtype."""
    if t.device != device:
        raise ValueError(f"softmax kernel: {name} is on {t.device}, x on "
                         f"{device}")
    if dtype is None and t.dtype not in _DTYPE_CODE:
        raise TypeError(f"softmax kernel takes {name} in float32, bfloat16 "
                        f"or float16, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"softmax kernel: {name} is {t.dtype}, expected "
                        f"{dtype}")
    t = t.contiguous()
    if t.data_ptr() % _ALIGN:
        t = t.clone()
    return t


def _rows(x: torch.Tensor) -> int:
    rows = x.numel() // x.shape[-1]
    if rows >= 2 ** 31:
        raise ValueError(f"softmax kernel: {rows} rows exceed the grid's "
                         "2^31 - 1 blocks")
    return rows


def _byte_mask(mask: torch.Tensor, b: int, sq: int, sk: int):
    """The mask as the reference's ``mask.reshape(b * sq, sk)`` reads it,
    in bytes (nonzero = masked)."""
    if mask.numel() != b * sq * sk:
        raise TypeError(
            f"cannot reshape mask of shape {tuple(mask.shape)} (size "
            f"{mask.numel()}) into shape ({b * sq}, {sk}) (size "
            f"{b * sq * sk}): the masked kernel reads one (sq, sk) mask a "
            "batch row and broadcasts none")
    m = mask.reshape(b, sq, sk)
    if m.dtype == torch.bool:
        return m.contiguous().view(torch.uint8)
    if m.dtype == torch.uint8:
        return m
    return (m != 0).view(torch.uint8)


def _softmax_fwd(x, scale, causal: bool):
    """Rows of x, unmasked or causal (query ``r % sq`` of flat row r)."""
    sq = x.shape[-2]
    if x.device.type == "cpu":
        if causal:
            return scaled_upper_triang_masked_softmax_ref(x, scale)
        return scaled_masked_softmax_ref(x, None, scale)
    dev = x.device
    x = _for_kernel("x", x, dev)
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(dev):
            SOFTMAX_FWD.launch(x.data_ptr(), _DTYPE_CODE[x.dtype], y.data_ptr(),
                               _rows(x), x.shape[-1], sq, int(causal),
                               float(scale), _stream(dev))
    return y


def _softmax_masked_fwd(x, mask, scale):
    """x (b, np, sq, sk), mask (b, sq, sk) bytes."""
    b, np_, sq, sk = x.shape
    if x.device.type == "cpu":
        return scaled_masked_softmax_ref(x, mask.reshape(b, 1, sq, sk),
                                         scale)
    dev = x.device
    x = _for_kernel("x", x, dev)
    mask = _for_kernel("mask", mask, dev, torch.uint8)
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(dev):
            SOFTMAX_MASKED_FWD.launch(
                x.data_ptr(), _DTYPE_CODE[x.dtype], mask.data_ptr(),
                y.data_ptr(), _rows(x), sk, sq, np_, float(scale),
                _stream(dev))
    return y


def _softmax_bwd(y, dy, scale):
    if y.device.type == "cpu":
        return softmax_vjp_ref(y, dy, scale)
    dev = y.device
    y = _for_kernel("y", y, dev)
    dy = _for_kernel("dy", dy, dev, y.dtype)
    if dy.shape != y.shape:
        raise ValueError(f"softmax backward: dy has shape {tuple(dy.shape)}, "
                         f"y {tuple(y.shape)}")
    dx = torch.empty_like(y)
    if y.numel():
        with torch.cuda.device(dev):
            SOFTMAX_BWD.launch(y.data_ptr(), dy.data_ptr(),
                               _DTYPE_CODE[y.dtype], dx.data_ptr(), _rows(y),
                               y.shape[-1], float(scale), _stream(dev))
    return dx


# ---------------------------------------------------------------------------
# the reference's routing and its custom VJPs
# ---------------------------------------------------------------------------

def _sms_fwd(x, mask, scale):
    b, np_, sq, sk = x.shape
    if not _use_pallas(sk):
        return scaled_masked_softmax_ref(x, mask, scale)
    if mask is None:
        return _softmax_fwd(x, scale, causal=False)
    if _divisor_block(sq, _block_rows_cap(sk)) == 0:
        return scaled_masked_softmax_ref(x, mask, scale)
    return _softmax_masked_fwd(x, _byte_mask(mask, b, sq, sk), scale)


def _suts_fwd(x, scale):
    ab, sq, sk = x.shape
    if sq != sk:
        raise AssertionError("upper-triang variant requires square attention")
    if _use_pallas(sk) and _divisor_block(sq, _block_rows_cap(sk)):
        return _softmax_fwd(x, scale, causal=True)
    return scaled_upper_triang_masked_softmax_ref(x, scale)


def _softmax_vjp(y, dy, scale):
    if not _use_pallas(y.shape[-1]):
        return softmax_vjp_ref(y, dy, scale)
    return _softmax_bwd(y, dy, scale)


class _ScaledMaskedSoftmax(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_scaled_masked_softmax_p``):
    save the output, no gradient for the mask or the scale."""

    @staticmethod
    def forward(ctx, x, mask, scale):
        y = _sms_fwd(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _softmax_vjp(y, dy, ctx.scale), None, None


class _ScaledUpperTriangMaskedSoftmax(torch.autograd.Function):
    """``_scaled_upper_triang_masked_softmax_p``: masked entries have
    ``y == 0``, so the shared backward gives them zero gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        y = _suts_fwd(x, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _softmax_vjp(y, dy, ctx.scale), None


def _check_static_scale(scale) -> float:
    """scale is a Python number (the reference's static, non-differentiable
    argument); a tensor raises."""
    if isinstance(scale, torch.Tensor) or not isinstance(scale,
                                                         numbers.Real):
        raise TypeError(
            f"scale must be a static Python number (it is non-"
            f"differentiable), got {type(scale).__name__}")
    return float(scale)


def scaled_masked_softmax(x, mask, scale):
    """softmax(x*scale masked_fill(mask, -10000)) over the last dim.

    x: (b, np, sq, sk); mask: (b, 1, sq, sk) with nonzero = masked, or
    None.  scale: Python number.  Reference:
    scaled_masked_softmax_cuda.forward."""
    return _ScaledMaskedSoftmax.apply(x, mask, _check_static_scale(scale))


def scaled_upper_triang_masked_softmax(x, scale):
    """Causal softmax(x*scale) for (attn_batches, sq, sq) inputs.
    scale: Python number.  Reference:
    scaled_upper_triang_masked_softmax_cuda.forward."""
    return _ScaledUpperTriangMaskedSoftmax.apply(x, _check_static_scale(scale))


def generic_scaled_masked_softmax(x, mask, scale):
    """The reference's generic variant (any sk): the same op, whose plain
    path already takes any sk."""
    return scaled_masked_softmax(x, mask, scale)
