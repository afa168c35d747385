"""Host-independent f32 arithmetic for the CPU paths: roots and convolutions.

aten's CPU ``torch.sqrt`` on f32 is not correctly rounded on every host
(on an AMD EPYC host, 170,159 of 10**6 inputs in [0, 3) are one ulp
off, with the vector path on or off), while numpy, XLA and the card
are.  The root in f64 rounded back to f32 is correctly rounded: a
53-bit root of a 24-bit input rounds once, correctly (53 >= 2*24 + 2).
So every CPU root that a twin holds bit for bit against the JAX package
goes through :func:`sqrt`, and the host no longer decides the bits.

aten's CPU f32 convolution (oneDNN) sums in an order that depends on the
host and its thread count, and through a ResNet's population-4
BatchNorms that rounding reaches the gradients at several percent of a
leaf's largest entry (ResNet-50 at width 8 on 4 images: 0.0236 with 8
threads, 0.0258 with 1, against an f64 evaluation).  :func:`conv2d`
sums in f64 and rounds once, so a CPU convolution gives the same bits on
every host (products of f32 operands are exact in f64, and the f64 sum
misses the exact one by far less than an f32 ulp)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` correctly rounded in x's dtype.  On the CPU, a float
    narrower than f64 takes its root in f64; on the card (whose f32
    ``sqrt`` is correctly rounded) and in f64 it is ``torch.sqrt``."""
    if (x.device.type == "cpu" and x.is_floating_point()
            and x.dtype != torch.float64):
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` in x's dtype, from the f64 root on the CPU (the
    CPU's f32 ``torch.rsqrt`` is off the rounded root at 26% of inputs,
    XLA's at 18%, and in different places, so twins that take it drift
    apart through a training step); ``torch.rsqrt`` on the card."""
    if (x.device.type == "cpu" and x.is_floating_point()
            and x.dtype != torch.float64):
        return torch.rsqrt(x.double()).to(x.dtype)
    return torch.rsqrt(x)


def conv2d(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """``F.conv2d(x, w, **kw)`` in x's dtype.  On the CPU, a float
    narrower than f64 is summed in f64 and rounded once (its gradients
    too, through the casts); on the card, and inside an amp O1 call
    (whose rule gives a convolution its half operands and result), it
    is ``F.conv2d``."""
    from apex_tpu_torch.amp import wrap

    if (x.device.type == "cpu" and x.is_floating_point()
            and x.dtype != torch.float64 and not wrap.active()):
        return F.conv2d(x.double(), w.double(), **kw).to(x.dtype)
    return F.conv2d(x, w, **kw)
