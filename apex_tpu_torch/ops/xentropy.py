"""Softmax cross entropy with label smoothing: the port of
``apex_tpu.ops.xentropy``.

Per row of logits, ``loss = lse - (1 - eps) * x[target] - eps *
mean(x)``; the backward recomputes the softmax from the saved ``lse``:
``dx = dy * (softmax(x) - (1 - eps) * onehot - eps / C)``.  All math in
f32; the losses (and the gradient) take the logits' dtype unless the
logits are f32 or ``half_to_float``.

The reference routes on its gate (:func:`_use_pallas`: C a multiple of
128, at most 65536) to a Pallas kernel pair and otherwise to an XLA
formula.  The port keeps the gate.  On it, a tensor on the card goes to
the hand-written kernels of ``csrc/xentropy.cu`` (``xent_fwd``, ROADMAP
Queue 2 row 20, writing the losses and the f32 lse; ``xent_bwd``, row
21, recomputing p from that lse) and a tensor on the CPU to their plain
versions, :func:`xent_fwd_ref` and :func:`xent_bwd_ref`.  Off the gate
(BERT-Large's C = 30528, GPT-2's 50257) the plain versions run on either
device, forward and backward, as the reference's XLA path does (its own
routing, not a fallback).

Labels outside ``[0, C)`` follow the reference on each side of the gate.
On it the kernel's one-hot is ``col == label``, so such a row has no
target term: ``loss = lse - eps * mean(x)``.  Off it the reference
gathers with ``take_along_axis``: a negative label counts from the end
once, one out of range gathers NaN.  In the backward both sides give
such a row no one-hot term.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch import _build

LANE = 128
_MAX_C = 65536

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ALIGN = 16             # the kernels move 16-byte vectors

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

XENT_FWD = _build.Kernel(
    "xentropy", "apex_xent_fwd", [_P, _I, _P, _P, _I, _P, _L, _I, _F, _F,
                                  _P], name="xent_fwd")
XENT_BWD = _build.Kernel(
    "xentropy", "apex_xent_bwd", [_P, _I, _P, _P, _P, _P, _I, _L, _I, _F,
                                  _F, _P], name="xent_bwd")


def _use_pallas(c: int) -> bool:
    return c % LANE == 0 and c <= _MAX_C


def _loss_dtype(logits, half_to_float):
    return torch.float32 if half_to_float else logits.dtype


# ---------------------------------------------------------------------------
# the plain versions (the reference's XLA path and the kernels' twins)
# ---------------------------------------------------------------------------

def _target_logit(xf, labels, onehot: bool):
    """The target logit of each row.  ``onehot`` (the gate): the
    kernel's ``col == label``, 0 for a label out of range.  Otherwise
    ``take_along_axis``'s rules: negative labels wrap once, out of range
    gives NaN."""
    c = xf.shape[1]
    if onehot:
        ok = (labels >= 0) & (labels < c)
        xt = xf.gather(1, labels.clamp(0, c - 1)[:, None])[:, 0]
        return torch.where(ok, xt, torch.zeros_like(xt))
    idx = torch.where(labels < 0, labels + c, labels)
    ok = (idx >= 0) & (idx < c)
    xt = xf.gather(1, idx.clamp(0, c - 1)[:, None])[:, 0]
    return torch.where(ok, xt, torch.full_like(xt, float("nan")))


def xent_fwd_ref(logits, labels, smoothing, half_to_float, onehot=True):
    """``(losses in the loss dtype, lse f32)`` of logits ``(N, C)`` and
    int64 labels ``(N,)``; ``onehot`` picks the gate's label rule."""
    xf = logits.float()
    lse = torch.logsumexp(xf, dim=1)
    loss = lse - (1.0 - smoothing) * _target_logit(xf, labels, onehot)
    loss = loss - smoothing * xf.mean(dim=1)
    return loss.to(_loss_dtype(logits, half_to_float)), lse


def xent_bwd_ref(logits, labels, lse, dy, smoothing, half_to_float):
    """``dx = dy * (exp(x - lse) - (1 - s) * onehot - s / C)`` in the
    loss dtype; a label out of range has no one-hot term."""
    s = smoothing
    c = logits.shape[1]
    dx = torch.exp(logits.float() - lse[:, None])
    if s:
        dx = dx - s / c
    # the one-hot term at the label only (no (N, C) one-hot buffer):
    # (p - (1 - s)) - s / c there, a zero row for a label out of range
    ok = (labels >= 0) & (labels < c)
    idx = labels.clamp(0, c - 1)[:, None]
    p_t = torch.exp(logits.float().gather(1, idx) - lse[:, None])
    at_t = p_t - (1.0 - s)
    if s:
        at_t = at_t - s / c
    dx.scatter_(1, idx, torch.where(ok[:, None], at_t, dx.gather(1, idx)))
    dx = dx * dy.float()[:, None]
    return dx.to(_loss_dtype(logits, half_to_float))


# ---------------------------------------------------------------------------
# the wrappers: CUDA tensor -> kernel, CPU tensor -> plain version
# ---------------------------------------------------------------------------

def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _for_kernel(name: str, t: torch.Tensor, device, shape, dtypes):
    """``t`` contiguous and 16-byte aligned (a copy only when it is
    not), after checking its device, shape and dtype."""
    if t.device != device:
        raise ValueError(f"xentropy kernel: {name} is on {t.device}, the "
                         f"logits on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"xentropy kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"xentropy kernel takes {name} in "
                        f"{', '.join(str(d) for d in dtypes)}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % _ALIGN:
        t = t.clone()
    return t


def _xent_fwd_cuda(logits, labels, smoothing, half_to_float):
    n, c = logits.shape
    dev = logits.device
    x = _for_kernel("logits", logits, dev, (n, c), tuple(_DTYPE_CODE))
    t = _for_kernel("labels", labels, dev, (n,), (torch.int64,))
    loss = torch.empty(n, dtype=_loss_dtype(logits, half_to_float),
                       device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            XENT_FWD.launch(x.data_ptr(), _DTYPE_CODE[x.dtype], t.data_ptr(),
                            loss.data_ptr(), _DTYPE_CODE[loss.dtype],
                            lse.data_ptr(), n, c, 1.0 - smoothing,
                            smoothing, _stream(dev))
    return loss, lse


def _xent_bwd_cuda(logits, labels, lse, dy, smoothing, half_to_float):
    n, c = logits.shape
    dev = logits.device
    x = _for_kernel("logits", logits, dev, (n, c), tuple(_DTYPE_CODE))
    t = _for_kernel("labels", labels, dev, (n,), (torch.int64,))
    lse = _for_kernel("lse", lse, dev, (n,), (torch.float32,))
    dyf = _for_kernel("dy", dy.float(), dev, (n,), (torch.float32,))
    dx = torch.empty(n, c, dtype=_loss_dtype(logits, half_to_float),
                     device=dev)
    if n:
        with torch.cuda.device(dev):
            XENT_BWD.launch(x.data_ptr(), _DTYPE_CODE[x.dtype], t.data_ptr(),
                            lse.data_ptr(), dyf.data_ptr(), dx.data_ptr(),
                            _DTYPE_CODE[dx.dtype], n, c, 1.0 - smoothing,
                            smoothing / c, _stream(dev))
    return dx


def _xent_fwd(logits, labels, smoothing, half_to_float):
    """The gate's forward: the kernel on the card, its twin on the CPU."""
    if logits.device.type == "cpu":
        return xent_fwd_ref(logits, labels, smoothing, half_to_float)
    return _xent_fwd_cuda(logits, labels, smoothing, half_to_float)


def _xent_bwd(logits, labels, lse, dy, smoothing, half_to_float):
    if logits.device.type == "cpu":
        return xent_bwd_ref(logits, labels, lse, dy, smoothing,
                            half_to_float)
    return _xent_bwd_cuda(logits, labels, lse, dy, smoothing, half_to_float)


class _SoftmaxXentropy(torch.autograd.Function):
    """The reference's ``custom_vjp``: save the logits, the labels and
    the per-row lse; no gradient for the labels."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, half_to_float):
        if _use_pallas(logits.shape[1]):
            loss, lse = _xent_fwd(logits, labels, smoothing, half_to_float)
        else:
            loss, lse = xent_fwd_ref(logits, labels, smoothing,
                                     half_to_float, onehot=False)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.half_to_float = smoothing, half_to_float
        return loss

    @staticmethod
    def backward(ctx, dy):
        logits, labels, lse = ctx.saved_tensors
        bwd = _xent_bwd if _use_pallas(logits.shape[1]) else xent_bwd_ref
        return (bwd(logits, labels, lse, dy, ctx.smoothing,
                    ctx.half_to_float), None, None, None)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          smoothing: float = 0.0,
                          half_to_float: bool = False) -> torch.Tensor:
    """Per-example label-smoothed cross entropy: logits ``(N, C)``,
    labels ``(N,)`` int; returns losses ``(N,)``."""
    return _SoftmaxXentropy.apply(logits, labels.long(), float(smoothing),
                                  bool(half_to_float))


def softmax_cross_entropy_ref(logits, labels, smoothing=0.0,
                              half_to_float=False):
    """Plain oracle: label-smoothed log-softmax NLL."""
    xf = logits.float()
    logp = torch.log_softmax(xf, dim=1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    smooth = -logp.mean(dim=1)
    loss = (1.0 - smoothing) * nll + smoothing * smooth
    return loss.to(_loss_dtype(logits, half_to_float))
