"""Rotary position embedding: the port of ``apex_tpu.ops.rope``.

``t`` (s, b, np, hn) rotated by ``freqs`` (s, 1, 1, rot): the first
``rot`` channels become ``t * cos + rotate_half(t) * sin`` with
``cos``/``sin`` of ``freqs`` cast to t's dtype; the trailing channels
pass through.  ``interleaved`` pairs channels (0, 1), (2, 3), ... in
place of the two halves.

Plain elementwise torch: the reference has no Pallas kernel here (its
op is XLA), so neither does the port.  Like the reference's
``custom_vjp``, the gradient is the exact transpose of the rotation,
``dt = dy * cos + rotate_half^T(dy * sin)``, computed in dy's dtype with
the same roundings, and saves only ``freqs``; ``freqs`` gets no
gradient.  :func:`rope_ref` is the same forward under torch's autograd.
"""

from __future__ import annotations

import torch


def _rotate_half(t):
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], dim=-1)


def _rotate_half_interleaved(t):
    return torch.stack([-t[..., 1::2], t[..., 0::2]], dim=-1).reshape(t.shape)


def _rotate_half_T(t):
    # transpose of _rotate_half: (u1, u2) -> (u2, -u1)
    half = t.shape[-1] // 2
    return torch.cat([t[..., half:], -t[..., :half]], dim=-1)


def _rotate_half_interleaved_T(t):
    return torch.stack([t[..., 1::2], -t[..., 0::2]], dim=-1).reshape(t.shape)


def _split_rotary(t, freqs):
    rot_dim = freqs.shape[-1]
    return t[..., :rot_dim], t[..., rot_dim:]


def _rope(t, freqs, interleaved):
    t_rot, t_pass = _split_rotary(t, freqs)
    cos = torch.cos(freqs).to(t.dtype)
    sin = torch.sin(freqs).to(t.dtype)
    rot = _rotate_half_interleaved(t_rot) if interleaved else \
        _rotate_half(t_rot)
    y = t_rot * cos + rot * sin
    return torch.cat([y, t_pass], dim=-1) if t_pass.shape[-1] else y


class _Rope(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, freqs, interleaved):
        ctx.save_for_backward(freqs)
        ctx.interleaved = interleaved
        return _rope(t, freqs, interleaved)

    @staticmethod
    def backward(ctx, dy):
        (freqs,) = ctx.saved_tensors
        dy_rot, dy_pass = _split_rotary(dy, freqs)
        cos = torch.cos(freqs).to(dy.dtype)
        sin = torch.sin(freqs).to(dy.dtype)
        # exact transpose of y = (C + S.R) t:  dt = C dy + R^T (S dy)
        rot_T = _rotate_half_interleaved_T if ctx.interleaved else \
            _rotate_half_T
        dt = dy_rot * cos + rot_T(dy_rot * sin)
        if dy_pass.shape[-1]:
            dt = torch.cat([dt, dy_pass], dim=-1)
        return dt, None, None


def fused_apply_rotary_pos_emb(t, freqs, interleaved=False):
    """t (s, b, np, hn) rotated by freqs (s, 1, 1, hn); rotary dim =
    freqs' last dim (trailing channels pass through, the reference's
    behaviour)."""
    return _Rope.apply(t, freqs, bool(interleaved))


def rope_ref(t, freqs, interleaved=False):
    """Autodiff-friendly oracle."""
    return _rope(t, freqs, interleaved)
