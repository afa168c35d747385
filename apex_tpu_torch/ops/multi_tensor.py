"""Flat-buffer kernels of the training path, and their plain twins.

The port of three TPU kernels of ``apex_tpu.ops.multi_tensor``:

- :func:`flat_accumulate` — ``acc += g * scale`` in place over an f32
  accumulator bucket, with the non-finite flag of the RESULT (so one bad
  microbatch latches through every later add);
- :func:`flat_unscale_norm` — ``out = x * inv_scale`` plus the squared
  L2 norm of the unscaled values and the non-finite flag, from one read;
- :func:`flat_sgd` — one SGD step (weight decay, momentum, dampening,
  nesterov) in place on the param and momentum buckets.

A tensor on the card goes to the hand-written kernel of
``csrc/multi_tensor.cu``; a tensor on the CPU goes to the plain twin
(``*_ref``, the same function in plain PyTorch, out of place, mirroring
the JAX package's ``*_ref`` oracles).  There is no other switch and
nothing falls back: a tensor on the card that the kernel does not take
raises.

Scalars that live on the device (``inv_scale``, ``first_run``,
``found_inf``) pass to a kernel as device pointers, never through a
host read; the host-side hypers (``lr``, ``momentum``, ...) are Python
floats passed by value.  :func:`flat_sgd` takes the optional overflow
flag itself: on the card the kernel writes nothing when it is set, on
the CPU the twin's result is selected away with ``torch.where`` — both
leave p and the momentum buffer as they were, the reference's
select-on-skip, and neither syncs the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch import _build

THREADS = 256           # threads per block of the streaming kernels
MAX_BLOCKS = 1024       # the grid's cap: same for every card, so the
#                         per-block partial sums (and the norm) are too
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = {torch.float32: 16, torch.bfloat16: 8}   # one 4-element vector

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

ACCUMULATE = _build.Kernel(
    "multi_tensor", "apex_flat_accumulate",
    [_P, _P, _I, _F, _P, _L, _I, _P], name="flat_accumulate")
UNSCALE_NORM = _build.Kernel(
    "multi_tensor", "apex_flat_unscale_norm",
    [_P, _P, _I, _P, _P, _P, _P, _P, _L, _I, _P], name="flat_unscale_norm")
SGD = _build.Kernel(
    "multi_tensor", "apex_flat_sgd",
    [_P, _I, _P, _I, _P, _F, _F, _F, _F, _P, _P, _P, _I, _I, _L, _I, _P],
    name="flat_sgd")

Scalar = Union[float, torch.Tensor]


def grid_blocks(n: int) -> int:
    """Blocks of the streaming kernels for an ``n``-element buffer."""
    vectors = (n + 3) // 4
    return max(1, min(MAX_BLOCKS, (vectors + THREADS - 1) // THREADS))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _nonfinite(x: torch.Tensor) -> torch.Tensor:
    """i32 0-d flag: 1 iff any element is non-finite."""
    return (~torch.isfinite(x)).any().to(torch.int32)


def _f32_value(v) -> float:
    """``v`` rounded to f32, as the Python float torch then takes exactly."""
    return float(np.float32(v))


def _as_f32_scalar(v: Scalar, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), _f32_value(v), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the plain twins (mirror apex_tpu/ops/multi_tensor.py's *_ref)
# ---------------------------------------------------------------------------

def flat_accumulate_ref(acc: torch.Tensor, g: torch.Tensor, scale: Scalar = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(acc + g * scale, found_inf)``, out of place."""
    if acc.dtype != torch.float32:
        raise ValueError(f"accumulator must be f32, got {acc.dtype}")
    r = acc + _f32(g) * _as_f32_scalar(scale, acc.device)
    return r, _nonfinite(r)


def flat_unscale_norm_ref(x: torch.Tensor, inv_scale: Scalar, out_dtype=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x * inv_scale, sum of squares of the f32 product, found_inf)``."""
    out_dtype = out_dtype or x.dtype
    y = _f32(x) * _as_f32_scalar(inv_scale, x.device)
    return y.to(out_dtype), torch.sum(y * y), _nonfinite(y)


def flat_sgd_ref(p, g, momentum_buf, *, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, first_run=False,
                 grad_scale: Scalar = 1.0):
    """One SGD step, out of place; returns ``(p, momentum_buf)``.  Divides
    by ``grad_scale`` (the kernel multiplies by its reciprocal)."""
    dev = p.device
    pf = _f32(p)
    gf = _f32(g) / _as_f32_scalar(grad_scale, dev)
    gf = gf + _f32_value(weight_decay) * pf
    if momentum != 0.0:
        first = (first_run.to(device=dev, dtype=torch.bool)
                 if isinstance(first_run, torch.Tensor)
                 else torch.full((), bool(first_run), device=dev))
        mom = _f32_value(momentum)
        keep = float(np.float32(1.0) - np.float32(dampening))
        buf = torch.where(first, gf, mom * momentum_buf + keep * gf)
        step = gf + mom * buf if nesterov else buf
    else:
        buf = momentum_buf
        step = gf
    return (pf - _f32_value(lr) * step).to(p.dtype), buf


# ---------------------------------------------------------------------------
# the wrappers: CUDA tensor -> kernel, CPU tensor -> twin
# ---------------------------------------------------------------------------

def _check(fn: str, name: str, t: torch.Tensor, device, n: int,
           dtypes) -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn} kernel takes {name} in "
                        f"{[str(d) for d in dtypes]}, got {t.dtype}")
    if t.numel() != n:
        raise ValueError(f"{fn}: {name} has {t.numel()} elements, "
                         f"expected {n}")
    if not t.is_contiguous():
        raise ValueError(f"{fn} kernel takes a contiguous {name}")
    if t.data_ptr() % _ALIGN[t.dtype]:
        raise ValueError(f"{fn} kernel reads {name} in {_ALIGN[t.dtype]}-"
                         "byte vectors; its data must start aligned")


def _device_scalar(fn: str, name: str, v, device, dtype) -> torch.Tensor:
    """A 0-d device tensor for a scalar the kernel reads by pointer."""
    if isinstance(v, torch.Tensor):
        if v.device != device or v.numel() != 1:
            raise ValueError(f"{fn}: {name} must be one element on "
                             f"{device}, got {tuple(v.shape)} on {v.device}")
        return v.reshape(()).to(dtype).contiguous()
    return torch.full((), v, dtype=dtype, device=device)


def _host_float(fn: str, name: str, v) -> float:
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        raise TypeError(f"{fn}: {name} is passed by value; a device tensor "
                        "would need a host read")
    return float(v)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flat_accumulate(acc: torch.Tensor, g: torch.Tensor, scale: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``acc += g * scale`` in place over flat buffers in ONE
    read-modify-write; returns ``(acc, found_inf i32)``.  ``acc`` is f32;
    ``g`` is f32 or bf16 (accumulated in f32).  The flag covers the
    accumulated result."""
    if acc.dtype != torch.float32:
        raise ValueError(f"accumulator must be f32, got {acc.dtype}")
    if acc.device.type == "cpu":
        r, bad = flat_accumulate_ref(acc, g, scale)
        acc.copy_(r)
        return acc, bad
    fn, dev, n = "flat_accumulate", acc.device, acc.numel()
    _check(fn, "acc", acc, dev, n, (torch.float32,))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    s = _host_float(fn, "scale", scale)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            ACCUMULATE.launch(acc.data_ptr(), g.data_ptr(),
                              _DTYPE_CODE[g.dtype], s, flag.data_ptr(), n,
                              grid_blocks(n), _stream(dev))
    return acc, flag


def flat_unscale_norm(x: torch.Tensor, inv_scale: Scalar, out_dtype=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``out = x * inv_scale`` over a flat gradient buffer, plus the
    squared L2 norm of the unscaled f32 values and the non-finite flag,
    from one sweep.  Returns ``(out, norm_sq f32, found_inf i32)``.
    ``inv_scale`` may be a device scalar (read by the kernel through its
    pointer)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return flat_unscale_norm_ref(x, inv_scale, out_dtype)
    fn, dev, n = "flat_unscale_norm", x.device, x.numel()
    _check(fn, "x", x, dev, n, tuple(_DTYPE_CODE))
    if out_dtype != x.dtype:
        raise TypeError(f"{fn} kernel writes out in x's dtype ({x.dtype}), "
                        f"asked for {out_dtype}")
    inv = _device_scalar(fn, "inv_scale", inv_scale, dev, torch.float32)
    out = torch.empty_like(x)
    norm_sq = torch.zeros((), dtype=torch.float32, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        blocks = grid_blocks(n)
        part_sum = torch.empty(blocks, dtype=torch.float32, device=dev)
        part_flag = torch.empty(blocks, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            UNSCALE_NORM.launch(x.data_ptr(), out.data_ptr(),
                                _DTYPE_CODE[x.dtype], inv.data_ptr(),
                                norm_sq.data_ptr(), flag.data_ptr(),
                                part_sum.data_ptr(), part_flag.data_ptr(), n,
                                blocks, _stream(dev))
    return out, norm_sq, flag


def flat_sgd(p: torch.Tensor, g: torch.Tensor, momentum_buf: torch.Tensor, *,
             lr, momentum=0.0, dampening=0.0, weight_decay=0.0,
             nesterov=False, first_run=False, grad_scale: Scalar = 1.0,
             found_inf: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step in place on ``p`` (f32 or bf16) and ``momentum_buf``
    (f32); returns them.  ``first_run`` (bool or device scalar) selects
    ``buf = g``; ``grad_scale`` (float or device scalar) divides ``g``;
    ``found_inf`` (optional device i32/bool scalar) leaves both buffers
    untouched when set."""
    if p.device.type == "cpu":
        new_p, new_b = flat_sgd_ref(
            p, g, momentum_buf, lr=lr, momentum=momentum,
            dampening=dampening, weight_decay=weight_decay,
            nesterov=nesterov, first_run=first_run, grad_scale=grad_scale)
        if found_inf is not None:
            keep = found_inf.to(p.device) == 0
            new_p = torch.where(keep, new_p, p)
            new_b = torch.where(keep, new_b, momentum_buf)
        p.copy_(new_p)
        if new_b is not momentum_buf:
            momentum_buf.copy_(new_b)
        return p, momentum_buf
    fn, dev, n = "flat_sgd", p.device, p.numel()
    use_momentum = momentum != 0.0
    _check(fn, "p", p, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "momentum_buf", momentum_buf, dev, n, (torch.float32,))
    hyper = [_host_float(fn, k, v) for k, v in
             (("lr", lr), ("momentum", momentum), ("dampening", dampening),
              ("weight_decay", weight_decay))]
    if isinstance(grad_scale, torch.Tensor):
        inv = 1.0 / _device_scalar(fn, "grad_scale", grad_scale, dev,
                                   torch.float32)
    else:
        inv = torch.full((), float(np.float32(1.0) / np.float32(grad_scale)),
                         dtype=torch.float32, device=dev)
    first = _device_scalar(fn, "first_run", first_run, dev, torch.int32)
    gate = (None if found_inf is None else
            _device_scalar(fn, "found_inf", found_inf, dev, torch.int32))
    if n:
        with torch.cuda.device(dev):
            SGD.launch(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
                       _DTYPE_CODE[g.dtype], momentum_buf.data_ptr(), *hyper,
                       inv.data_ptr(), first.data_ptr(),
                       None if gate is None else gate.data_ptr(),
                       int(bool(nesterov)), int(use_momentum), n,
                       grid_blocks(n), _stream(dev))
    return p, momentum_buf
