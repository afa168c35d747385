"""Softmax cross entropy with label smoothing: the port of
``apex_tpu.ops.xentropy``.

Per row of logits, ``loss = lse - (1 - eps) * x[target] - eps *
mean(x)``; the backward recomputes the softmax from the saved ``lse``:
``dx = dy * (softmax(x) - (1 - eps) * onehot - eps / C)``.  All math in
f32; the losses (and the gradient) take the logits' dtype unless the
logits are f32 or ``half_to_float``.

The reference routes on its gate (:func:`_use_pallas`: C a multiple of
128, at most 65536) to a Pallas kernel pair (ROADMAP Queue 2 rows
20-21) and otherwise to this XLA formula.  The port keeps the gate.  Off
it (BERT-Large's C = 30528) the formula runs as torch ops on either
device, forward and backward, as in the reference.  On it the CPU runs
the same formula as the kernels' plain twin, and the card raises: those
kernels are not ported yet.

Label indexing follows the reference's ``take_along_axis``: a negative
label counts from the end, one out of range gathers NaN; its one-hot row
is zero.
"""

from __future__ import annotations

import torch

LANE = 128
_MAX_C = 65536

KERNELS_TODO = ("the fused cross-entropy kernels for C % 128 == 0 "
                "(ROADMAP Queue 2 rows 20-21) are not ported yet")


def _use_pallas(c: int) -> bool:
    return c % LANE == 0 and c <= _MAX_C


def _loss_dtype(logits, half_to_float):
    return torch.float32 if half_to_float else logits.dtype


def _target_logit(xf, labels):
    """``take_along_axis(xf, labels[:, None], 1)[:, 0]`` with JAX's
    index rules: negative labels wrap once, out of range gives NaN."""
    c = xf.shape[1]
    idx = torch.where(labels < 0, labels + c, labels)
    ok = (idx >= 0) & (idx < c)
    xt = xf.gather(1, idx.clamp(0, c - 1)[:, None])[:, 0]
    return torch.where(ok, xt, torch.full_like(xt, float("nan")))


class _SoftmaxXentropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, half_to_float):
        xf = logits.float()
        lse = torch.logsumexp(xf, dim=1)
        loss = lse - (1.0 - smoothing) * _target_logit(xf, labels)
        loss = loss - smoothing * xf.mean(dim=1)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.half_to_float = smoothing, half_to_float
        return loss.to(_loss_dtype(logits, half_to_float))

    @staticmethod
    def backward(ctx, dy):
        logits, labels, lse = ctx.saved_tensors
        s = ctx.smoothing
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
        return (dx.to(_loss_dtype(logits, ctx.half_to_float)), None, None,
                None)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          smoothing: float = 0.0,
                          half_to_float: bool = False) -> torch.Tensor:
    """Per-example label-smoothed cross entropy: logits ``(N, C)``,
    labels ``(N,)`` int; returns losses ``(N,)``."""
    if _use_pallas(logits.shape[1]) and logits.device.type != "cpu":
        raise NotImplementedError(KERNELS_TODO)
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
