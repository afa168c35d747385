"""Flat-buffer kernels of the training paths, and their plain twins.

The port of the eleven TPU kernels of ``apex_tpu.ops.multi_tensor``:

- :func:`flat_accumulate` — ``acc += g * scale`` in place over an f32
  accumulator bucket, with the non-finite flag of the RESULT (so one bad
  microbatch latches through every later add);
- :func:`flat_unscale_norm` — ``out = x * inv_scale`` plus the squared
  L2 norm of the unscaled values and the non-finite flag, from one read;
- :func:`flat_l2norm` — the L2 norm of a flat buffer (f32 sums), LAMB's
  global-gradient-norm prologue;
- :func:`flat_sgd` — one SGD step (weight decay, momentum, dampening,
  nesterov) in place on the param and momentum buckets;
- :func:`flat_adam` — one Adam or AdamW step (bias correction on or off)
  in place on the param and both moment buckets;
- :func:`flat_lamb` — one LAMB step: stage 1 (moments in place plus the
  raw update) and stage 2 (``p -= lr * trust * update`` in place), with
  the per-tensor trust ratios between them from
  :func:`flat_segment_sumsq` (plain PyTorch, as the reference's is XLA);
- :func:`flat_scale` — ``out = x * scale`` plus the non-finite flag of
  the f32 product (contrib.clip_grad's scale pass);
- :func:`flat_axpby` — ``out = a * x + b * y`` plus the flag;
- :func:`flat_adagrad` — one Adagrad step in place on the param and
  sum-of-squares buckets;
- :func:`flat_novograd` — one NovoGrad step: the per-tensor second
  moment from segment norms (plain PyTorch, as the reference's is XLA),
  then one kernel in place on the param and first-moment buckets.

A tensor on the card goes to the hand-written kernel of
``csrc/multi_tensor.cu``; a tensor on the CPU goes to the plain twin
(``*_ref``, the same function in plain PyTorch, out of place, mirroring
the JAX package's ``*_ref`` oracles).  There is no other switch and
nothing falls back: a tensor on the card that the kernel does not take
raises.

Scalars that live on the device (``inv_scale``, ``first_run``,
``found_inf``, the LAMB and Adam step clock, LAMB's clip factor, Adam's
learning rate) pass to a kernel as device pointers, never through a host
read; the other hypers (``momentum``, the betas, ...) are Python floats
passed by value.  :func:`flat_sgd`, :func:`flat_adam`,
:func:`flat_lamb`, :func:`flat_adagrad` and :func:`flat_novograd` take
the optional overflow flag
themselves: on the card the kernels write nothing when it is set, on
the CPU the twin's result is selected away with ``torch.where`` — both
leave every buffer as it was, the reference's select-on-skip, and
neither syncs the host.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch import _build

THREADS = 256           # threads per block of the streaming kernels
MAX_BLOCKS = 1024       # the grid's cap: same for every card, so the
#                         per-block partial sums (and the norm) are too
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# flat_scale and flat_axpby also read and write f16
_IO_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# one 4-element vector
_ALIGN = {torch.float32: 16, torch.bfloat16: 8, torch.float16: 8,
          torch.int32: 16, torch.int64: 8}

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
L2NORM = _build.Kernel(
    "multi_tensor", "apex_flat_l2norm", [_P, _I, _P, _P, _L, _I, _P],
    name="flat_l2norm")
LAMB_MOMENTS = _build.Kernel(
    "multi_tensor", "apex_flat_lamb_moments",
    [_P, _I, _P, _I, _P, _P, _P] + [_F] * 6 + [_P] * 4 + [_L, _I, _P],
    name="flat_lamb_moments")
LAMB_APPLY = _build.Kernel(
    "multi_tensor", "apex_flat_lamb_apply",
    [_P, _I, _P, _P, _P, _P, _L, _I, _P], name="flat_lamb_apply")
ADAM = _build.Kernel(
    "multi_tensor", "apex_flat_adam",
    [_P, _I, _P, _I, _P, _P] + [_F] * 6 + [_P] * 5 + [_I, _L, _I, _P],
    name="flat_adam")
SCALE = _build.Kernel(
    "multi_tensor", "apex_flat_scale", [_P, _I, _P, _I, _P, _P, _L, _I, _P],
    name="flat_scale")
AXPBY = _build.Kernel(
    "multi_tensor", "apex_flat_axpby",
    [_P, _I, _P, _I, _P, _I, _P, _P, _P, _L, _I, _P], name="flat_axpby")
ADAGRAD = _build.Kernel(
    "multi_tensor", "apex_flat_adagrad",
    [_P, _I, _P, _I, _P, _F, _F, _P, _P, _P, _L, _I, _P],
    name="flat_adagrad")
NOVOGRAD = _build.Kernel(
    "multi_tensor", "apex_flat_novograd",
    [_P, _I, _P, _I, _P, _P, _P, _I, _F, _F, _F, _P, _P, _P, _P, _I, _I,
     _L, _I, _P], name="flat_novograd")

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


def _as_flag(v, device) -> torch.Tensor:
    """A bool or device scalar as a 0-d bool tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.bool)
    return torch.full((), bool(v), device=device)


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


def flat_l2norm_ref(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a flat buffer, summed in f32."""
    xf = _f32(x)
    return torch.sqrt(torch.sum(xf * xf))


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
        first = _as_flag(first_run, dev)
        mom = _f32_value(momentum)
        keep = float(np.float32(1.0) - np.float32(dampening))
        buf = torch.where(first, gf, mom * momentum_buf + keep * gf)
        step = gf + mom * buf if nesterov else buf
    else:
        buf = momentum_buf
        step = gf
    return (pf - _f32_value(lr) * step).to(p.dtype), buf


def flat_segment_sumsq(x: torch.Tensor, sizes: Sequence[int]
                       ) -> torch.Tensor:
    """Per-segment sum of squares of a flat buffer, f32 sums; ``(len(sizes),)``.

    The segments are consecutive runs of ``sizes`` elements (a bucket's
    leaves in order).  The reference takes the sorted element-to-segment
    ids and reduces them with XLA's sorted segment sum; the port takes
    the run lengths (:meth:`BucketPlan.segment_sizes`) so that each run
    reduces on its own without a host read and without atomics (the
    ``index_add_`` a segment sum would be on the card is atomic, and its
    order changes from run to run): on the card ``torch._foreach_norm``
    over views of the buffer sums each run in fixed per-chunk partials and
    a per-run cleanup, the same bits every run; on the CPU each run is a
    ``torch.sum`` (cascade summation), since the CPU's f32 norm loses
    precision with the run's length (a relative 1e-3 at tens of millions
    of elements).  The sum of squares is the square of that norm, within
    f32 rounding of the reference's."""
    return segment_norms(x, sizes).square()


def segment_norms(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Per-segment L2 norm of a flat buffer (f32, ``(len(sizes),)``): the
    root of :func:`flat_segment_sumsq`, from the same fixed-order sums."""
    runs = torch.split(x, list(sizes))
    if x.device.type == "cpu":
        return torch.stack([torch.sum(r * r) for r in map(_f32, runs)]
                           ).sqrt()
    return torch.stack(torch._foreach_norm(runs, 2, dtype=torch.float32))


def _lamb_trust_factor(p, update, sizes, lr, weight_decay, use_nvlamb):
    """Per-segment ``lr * trust`` (f32, ``(len(sizes),)``), trust the
    per-tensor ``||p|| / ||update||`` (1 where either norm is 0).  The
    reference gathers it into a per-element buffer (``[seg_ids]``); the
    stage-2 kernel reads it per segment instead, and the plain twin
    gathers."""
    p_norm = torch.sqrt(flat_segment_sumsq(p, sizes))
    u_norm = torch.sqrt(flat_segment_sumsq(update, sizes))
    trust = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                        torch.ones_like(p_norm))
    if not use_nvlamb and float(weight_decay) == 0.0:
        # standard LAMB exempts decay-free tensors from layer adaptation;
        # NVLAMB applies the trust ratio to every layer
        trust = torch.ones_like(trust)
    return _f32_value(lr) * trust


def _bias_corrections(beta1, beta2, step, bias_correction, device):
    """``(c1r, c2r)``: ``1 / (1 - beta**step)`` (1 without bias
    correction), as 0-d f32 tensors on ``device``; ``step`` may be a
    device scalar (nothing is read back)."""
    if not bias_correction:
        one = torch.ones((), device=device)
        return one, one
    t = _as_f32_scalar(step, device)
    b1 = torch.full((), _f32_value(beta1), device=device)
    b2 = torch.full((), _f32_value(beta2), device=device)
    return 1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t)


def _lamb_scalars(beta1, beta2, step, bias_correction, grad_scale,
                  clip_coeff, device):
    """``(c1r, c2r, gmul)``: the bias corrections ``1 / (1 - beta**step)``
    and the gradient multiplier ``clip / grad_scale``, as 0-d f32 tensors
    on ``device`` (``step``, ``grad_scale`` and ``clip_coeff`` may be
    device scalars: nothing is read back)."""
    c1r, c2r = _bias_corrections(beta1, beta2, step, bias_correction,
                                 device)
    gmul = (_as_f32_scalar(clip_coeff, device)
            / _as_f32_scalar(grad_scale, device))
    return c1r, c2r, gmul


def _one_minus(b) -> float:
    return float(np.float32(1.0) - np.float32(b))


def _lamb_moments_ref(p, g, m, v, c1r, c2r, gmul, *, beta1, beta2, eps,
                      weight_decay):
    """Stage 1 in plain PyTorch (``_lamb_moment_kernel``): returns
    ``(m, v, update)``, out of place."""
    gf = _f32(g) * gmul
    m = _f32_value(beta1) * m + _one_minus(beta1) * gf
    v = _f32_value(beta2) * v + _one_minus(beta2) * gf * gf
    update = ((m * c1r) / (torch.sqrt(v * c2r) + _f32_value(eps))
              + _f32_value(weight_decay) * _f32(p))
    return m, v, update


def _lamb_apply_ref(p, update, factor, seg_ids):
    """Stage 2 in plain PyTorch (``_apply_update_kernel``): ``p -
    factor[seg_ids] * update`` in p's dtype, out of place."""
    return (_f32(p) - factor[seg_ids.long()] * update).to(p.dtype)


def flat_lamb_ref(p, g, m, v, seg_ids, sizes, *, lr, beta1, beta2, eps,
                  weight_decay=0.0, step=1, bias_correction=True,
                  grad_scale: Scalar = 1.0, clip_coeff: Scalar = 1.0,
                  use_nvlamb=False):
    """One LAMB step, out of place; returns ``(p, m, v)``."""
    c1r, c2r, gmul = _lamb_scalars(beta1, beta2, step, bias_correction,
                                   grad_scale, clip_coeff, p.device)
    m, v, update = _lamb_moments_ref(p, g, m, v, c1r, c2r, gmul,
                                     beta1=beta1, beta2=beta2, eps=eps,
                                     weight_decay=weight_decay)
    factor = _lamb_trust_factor(_f32(p), update, sizes, lr, weight_decay,
                                use_nvlamb)
    return _lamb_apply_ref(p, update, factor, seg_ids), m, v


def flat_adam_ref(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, step,
                  adam_w_mode=True, bias_correction=True,
                  grad_scale: Scalar = 1.0):
    """One Adam (``adam_w_mode=False``: L2 decay folded into the
    gradient) or AdamW (decoupled decay) step, out of place; returns
    ``(p, m, v)``.  Divides by ``grad_scale`` (the kernel multiplies by
    its reciprocal).  ``lr``, ``step`` and ``grad_scale`` may be device
    scalars."""
    dev = p.device
    pf = _f32(p)
    gf = _f32(g) / _as_f32_scalar(grad_scale, dev)
    wd = _f32_value(weight_decay)
    if not adam_w_mode:
        gf = gf + wd * pf
    m = _f32_value(beta1) * m + _one_minus(beta1) * gf
    v = _f32_value(beta2) * v + _one_minus(beta2) * gf * gf
    c1r, c2r = _bias_corrections(beta1, beta2, step, bias_correction, dev)
    update = (m * c1r) / (torch.sqrt(v * c2r) + _f32_value(eps))
    if adam_w_mode:
        update = update + wd * pf
    return (pf - _as_f32_scalar(lr, dev) * update).to(p.dtype), m, v


def flat_scale_ref(x: torch.Tensor, scale: Scalar, out_dtype=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x * scale in out_dtype, found_inf)``: the product in f32, the
    flag over the f32 product (before the cast)."""
    out_dtype = out_dtype or x.dtype
    y = _f32(x) * _as_f32_scalar(scale, x.device)
    return y.to(out_dtype), _nonfinite(y)


def flat_axpby_ref(a: Scalar, x: torch.Tensor, b: Scalar, y: torch.Tensor,
                   out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a * x + b * y in out_dtype, found_inf)``: f32, each product and
    the sum rounded once, the flag over the f32 result."""
    out_dtype = out_dtype or x.dtype
    dev = x.device
    r = (_as_f32_scalar(a, dev) * _f32(x)
         + _as_f32_scalar(b, dev) * _f32(y))
    return r.to(out_dtype), _nonfinite(r)


def flat_adagrad_ref(p, g, h, *, lr, eps, weight_decay=0.0,
                     grad_scale: Scalar = 1.0):
    """One Adagrad step, out of place; returns ``(p, h)``, ``h`` the
    running f32 sum of squared (decayed) gradients.  Divides by
    ``grad_scale`` (the kernel multiplies by its reciprocal); ``lr`` and
    ``grad_scale`` may be device scalars."""
    dev = p.device
    pf = _f32(p)
    gf = _f32(g) / _as_f32_scalar(grad_scale, dev)
    gf = gf + _f32_value(weight_decay) * pf
    h = h + gf * gf
    return ((pf - _as_f32_scalar(lr, dev) * gf
             / (torch.sqrt(h) + _f32_value(eps))).to(p.dtype), h)


def _novograd_second_moment(g, v_seg, sizes, *, beta2, eps, first,
                            init_zero, grad_scale):
    """NovoGrad's per-tensor second moment and normalizer: ``(v, denom)``,
    both f32 ``(len(sizes),)``.  ``v`` is ``||g / grad_scale||^2`` on the
    first step (times ``1 - beta2`` with ``init_zero``) and ``beta2 * v
    + (1 - beta2) * ||g / grad_scale||^2`` after; ``denom = sqrt(v) +
    eps``.  The norm of each segment is taken of the raw ``g`` and then
    divided by ``grad_scale`` (no scaled copy of the bucket), within f32
    rounding of the reference's norm of the scaled values.  Plain
    PyTorch on both paths, so kernel and twin read the same ``denom``."""
    dev = g.device
    gn_sq = (segment_norms(g, sizes)
             / _as_f32_scalar(grad_scale, dev)).square()
    omb2 = _one_minus(beta2)
    run = _f32_value(beta2) * v_seg + omb2 * gn_sq
    v = torch.where(first, omb2 * gn_sq if init_zero else gn_sq, run)
    return v, torch.sqrt(v) + _f32_value(eps)


def flat_novograd_ref(p, g, m, v_seg, sizes: Sequence[int], *, lr, beta1,
                      beta2, eps, weight_decay=0.0, first_run=False,
                      grad_averaging=True, init_zero=False,
                      reg_inside_moment=False, grad_scale: Scalar = 1.0):
    """One NovoGrad step over a flat bucket of ``len(sizes)`` segments,
    out of place; returns ``(p, m, v_seg)``.  ``v_seg`` is the per-tensor
    second moment (f32, one per segment).  The normalized gradient is
    ``(g / grad_scale) / denom[segment]``, a division, as the kernel
    computes it (the reference's kernel multiplies by a gathered ``1 /
    denom``); ``lr``, ``first_run`` and ``grad_scale`` may be device
    scalars."""
    dev = p.device
    first = _as_flag(first_run, dev)
    v, denom = _novograd_second_moment(
        g, v_seg, sizes, beta2=beta2, eps=eps, first=first,
        init_zero=init_zero, grad_scale=grad_scale)
    pf = _f32(p)
    wd = _f32_value(weight_decay)
    # denom per element (no host-to-device copy of the sizes)
    per_elt = torch.cat([d.expand(n) for d, n in zip(denom, sizes)])
    gn = (_f32(g) / _as_f32_scalar(grad_scale, dev)) / per_elt
    if reg_inside_moment:
        gn = gn + wd * pf
    coeff = _one_minus(beta1) if grad_averaging else 1.0
    m = torch.where(first, gn, _f32_value(beta1) * m + coeff * gn)
    update = m if reg_inside_moment else m + wd * pf
    return (pf - _as_f32_scalar(lr, dev) * update).to(p.dtype), m, v


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


def _inv_scale(fn: str, grad_scale: Scalar, device) -> torch.Tensor:
    """``1 / grad_scale`` as a 0-d f32 device tensor (no host read)."""
    if isinstance(grad_scale, torch.Tensor):
        return 1.0 / _device_scalar(fn, "grad_scale", grad_scale, device,
                                    torch.float32)
    return torch.full((), float(np.float32(1.0) / np.float32(grad_scale)),
                      dtype=torch.float32, device=device)


def _gate(fn: str, found_inf, device) -> Optional[torch.Tensor]:
    return (None if found_inf is None else
            _device_scalar(fn, "found_inf", found_inf, device, torch.int32))


def _keep_unless(found_inf, new, old):
    """The CPU twins' overflow skip: ``old`` where the flag is set."""
    if found_inf is None:
        return new
    return torch.where(found_inf.to(old.device) == 0, new, old)


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
        p.copy_(_keep_unless(found_inf, new_p, p))
        if new_b is not momentum_buf:
            momentum_buf.copy_(_keep_unless(found_inf, new_b, momentum_buf))
        return p, momentum_buf
    fn, dev, n = "flat_sgd", p.device, p.numel()
    use_momentum = momentum != 0.0
    _check(fn, "p", p, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "momentum_buf", momentum_buf, dev, n, (torch.float32,))
    hyper = [_host_float(fn, k, v) for k, v in
             (("lr", lr), ("momentum", momentum), ("dampening", dampening),
              ("weight_decay", weight_decay))]
    inv = _inv_scale(fn, grad_scale, dev)
    first = _device_scalar(fn, "first_run", first_run, dev, torch.int32)
    gate = _gate(fn, found_inf, dev)
    if n:
        with torch.cuda.device(dev):
            SGD.launch(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
                       _DTYPE_CODE[g.dtype], momentum_buf.data_ptr(), *hyper,
                       inv.data_ptr(), first.data_ptr(),
                       None if gate is None else gate.data_ptr(),
                       int(bool(nesterov)), int(use_momentum), n,
                       grid_blocks(n), _stream(dev))
    return p, momentum_buf


def flat_l2norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a flat buffer (f32 or bf16), summed in f32; a 0-d
    f32 tensor on ``x``'s device."""
    if x.device.type == "cpu":
        return flat_l2norm_ref(x)
    fn, dev, n = "flat_l2norm", x.device, x.numel()
    _check(fn, "x", x, dev, n, tuple(_DTYPE_CODE))
    norm = torch.zeros((), dtype=torch.float32, device=dev)
    if n:
        blocks = grid_blocks(n)
        part_sum = torch.empty(blocks, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            L2NORM.launch(x.data_ptr(), _DTYPE_CODE[x.dtype], norm.data_ptr(),
                          part_sum.data_ptr(), n, blocks, _stream(dev))
    return norm


def flat_lamb(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, seg_ids: torch.Tensor, sizes: Sequence[int],
              *, lr, beta1, beta2, eps, weight_decay=0.0, step=1,
              bias_correction=True, grad_scale: Scalar = 1.0,
              clip_coeff: Scalar = 1.0, use_nvlamb=False,
              found_inf: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LAMB step over a flat bucket in place on ``p`` (f32 or bf16),
    ``m`` and ``v`` (f32); returns them.

    The reference's two launches: stage 1 updates the moments and writes
    the raw update ``m_hat / (sqrt(v_hat) + eps) + wd * p`` (g scaled by
    ``clip_coeff / grad_scale``); the per-tensor trust ratios come from
    segment norms over ``sizes`` (:func:`_lamb_trust_factor`); stage 2
    applies ``p -= lr * trust[seg_ids] * update``.  ``seg_ids`` is the
    bucket's sorted i32 element-to-leaf map and ``sizes`` its run lengths
    (the reference's ``num_segments`` is ``len(sizes)``).  ``step``,
    ``grad_scale`` and ``clip_coeff`` may be device scalars;
    ``found_inf`` (optional device i32/bool scalar) leaves ``p``, ``m``
    and ``v`` untouched when set."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step,
              bias_correction=bias_correction, grad_scale=grad_scale,
              clip_coeff=clip_coeff, use_nvlamb=use_nvlamb)
    if p.device.type == "cpu":
        for old, new in zip((p, m, v), flat_lamb_ref(p, g, m, v, seg_ids,
                                                     sizes, **kw)):
            old.copy_(_keep_unless(found_inf, new, old))
        return p, m, v
    fn, dev, n = "flat_lamb", p.device, p.numel()
    _check(fn, "p", p, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "m", m, dev, n, (torch.float32,))
    _check(fn, "v", v, dev, n, (torch.float32,))
    _check(fn, "seg_ids", seg_ids, dev, n, (torch.int32,))
    if sum(sizes) != n:
        raise ValueError(f"{fn}: segment sizes sum to {sum(sizes)}, the "
                         f"bucket has {n} elements")
    _host_float(fn, "lr", lr)
    for name, x in (("step", step), ("grad_scale", grad_scale),
                    ("clip_coeff", clip_coeff)):
        if isinstance(x, torch.Tensor) and (x.device != dev
                                            or x.numel() != 1):
            raise ValueError(f"{fn}: {name} must be one element on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    c1r, c2r, gmul = _lamb_scalars(beta1, beta2, step, bias_correction,
                                   grad_scale, clip_coeff, dev)
    gate = _gate(fn, found_inf, dev)
    if n == 0:
        return p, m, v
    update = torch.empty(n, dtype=torch.float32, device=dev)
    _lamb_moments(p, g, m, v, update, c1r, c2r, gmul, beta1=beta1,
                  beta2=beta2, eps=eps, weight_decay=weight_decay, gate=gate)
    # the twin's norms are of f32 p: the same bits for a bf16 p
    factor = _lamb_trust_factor(p if p.dtype == torch.float32 else _f32(p),
                                update, sizes, lr, weight_decay, use_nvlamb)
    _lamb_apply(p, update, factor, seg_ids, gate=gate)
    return p, m, v


def _lamb_moments(p, g, m, v, update, c1r, c2r, gmul, *, beta1, beta2, eps,
                  weight_decay, gate=None) -> None:
    """Launch stage 1 (``csrc/multi_tensor.cu`` ``lamb_moment_kernel``):
    m, v in place, the raw update into ``update``; the wrapper
    :func:`flat_lamb` has checked the buffers."""
    fn, dev, n = "flat_lamb", p.device, p.numel()
    b1, b2, eps_f, wd = (_f32_value(_host_float(fn, k, x)) for k, x in
                         (("beta1", beta1), ("beta2", beta2), ("eps", eps),
                          ("weight_decay", weight_decay)))
    with torch.cuda.device(dev):
        LAMB_MOMENTS.launch(
            p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
            _DTYPE_CODE[g.dtype], m.data_ptr(), v.data_ptr(),
            update.data_ptr(), b1, _one_minus(b1), b2, _one_minus(b2),
            eps_f, wd, c1r.data_ptr(), c2r.data_ptr(), gmul.data_ptr(),
            None if gate is None else gate.data_ptr(), n, grid_blocks(n),
            _stream(dev))


def _lamb_apply(p, update, factor, seg_ids, gate=None) -> None:
    """Launch stage 2 (``lamb_apply_kernel``): ``p -= factor[seg_ids] *
    update`` in place, ``factor`` the per-segment f32 table."""
    dev, n = p.device, p.numel()
    if factor.dtype != torch.float32 or not factor.is_contiguous():
        raise TypeError("flat_lamb: the trust factor must be a contiguous "
                        "f32 table")
    with torch.cuda.device(dev):
        LAMB_APPLY.launch(p.data_ptr(), _DTYPE_CODE[p.dtype],
                          update.data_ptr(), factor.data_ptr(),
                          seg_ids.data_ptr(),
                          None if gate is None else gate.data_ptr(), n,
                          grid_blocks(n), _stream(dev))


def flat_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, *, lr, beta1, beta2, eps, weight_decay=0.0,
              step=1, adam_w_mode=True, bias_correction=True,
              grad_scale: Scalar = 1.0,
              found_inf: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam/AdamW step over a flat bucket in place on ``p`` (f32 or
    bf16), ``m`` and ``v`` (f32); ``g`` f32 or bf16; returns ``(p, m,
    v)``.  ``lr``, ``step`` (1-based) and ``grad_scale`` may be device
    scalars (the kernel reads ``lr``, the bias corrections and ``1 /
    grad_scale`` through pointers); ``found_inf`` (optional device
    i32/bool scalar) leaves ``p``, ``m`` and ``v`` untouched when set."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, grad_scale=grad_scale)
    if p.device.type == "cpu":
        for old, new in zip((p, m, v), flat_adam_ref(p, g, m, v, **kw)):
            old.copy_(_keep_unless(found_inf, new, old))
        return p, m, v
    fn, dev, n = "flat_adam", p.device, p.numel()
    _check(fn, "p", p, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "m", m, dev, n, (torch.float32,))
    _check(fn, "v", v, dev, n, (torch.float32,))
    b1, b2, eps_f, wd = (_f32_value(_host_float(fn, k, x)) for k, x in
                         (("beta1", beta1), ("beta2", beta2), ("eps", eps),
                          ("weight_decay", weight_decay)))
    if isinstance(step, torch.Tensor) and (step.device != dev
                                           or step.numel() != 1):
        raise ValueError(f"{fn}: step must be one element on {dev}, got "
                         f"{tuple(step.shape)} on {step.device}")
    lr_t = _device_scalar(fn, "lr", lr, dev, torch.float32)
    c1r, c2r = _bias_corrections(beta1, beta2, step, bias_correction, dev)
    inv = _inv_scale(fn, grad_scale, dev)
    gate = _gate(fn, found_inf, dev)
    if n:
        with torch.cuda.device(dev):
            ADAM.launch(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
                        _DTYPE_CODE[g.dtype], m.data_ptr(), v.data_ptr(), b1,
                        _one_minus(b1), b2, _one_minus(b2), eps_f, wd,
                        lr_t.data_ptr(), c1r.data_ptr(), c2r.data_ptr(),
                        inv.data_ptr(), None if gate is None else
                        gate.data_ptr(), int(bool(adam_w_mode)), n,
                        grid_blocks(n), _stream(dev))
    return p, m, v


def flat_scale(x: torch.Tensor, scale: Scalar, out_dtype=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = x * scale`` over a flat buffer (f32, bf16 or f16), in
    ``out_dtype`` (default x's); returns ``(out, found_inf i32)``, the
    flag over the f32 product before the cast.  ``scale`` may be a device
    scalar (read by the kernel through its pointer)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return flat_scale_ref(x, scale, out_dtype)
    fn, dev, n = "flat_scale", x.device, x.numel()
    _check(fn, "x", x, dev, n, tuple(_IO_CODE))
    if out_dtype not in _IO_CODE:
        raise TypeError(f"{fn} kernel writes f32, bf16 or f16, asked for "
                        f"{out_dtype}")
    s = _device_scalar(fn, "scale", scale, dev, torch.float32)
    out = torch.empty(n, dtype=out_dtype, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            SCALE.launch(x.data_ptr(), _IO_CODE[x.dtype], out.data_ptr(),
                         _IO_CODE[out_dtype], s.data_ptr(), flag.data_ptr(),
                         n, grid_blocks(n), _stream(dev))
    return out, flag


def flat_axpby(a: Scalar, x: torch.Tensor, b: Scalar, y: torch.Tensor,
               out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = a * x + b * y`` over flat buffers (each f32, bf16 or f16),
    in ``out_dtype`` (default x's); returns ``(out, found_inf i32)``, the
    flag over the f32 result.  ``a`` and ``b`` may be device scalars."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return flat_axpby_ref(a, x, b, y, out_dtype)
    fn, dev, n = "flat_axpby", x.device, x.numel()
    _check(fn, "x", x, dev, n, tuple(_IO_CODE))
    _check(fn, "y", y, dev, n, tuple(_IO_CODE))
    if out_dtype not in _IO_CODE:
        raise TypeError(f"{fn} kernel writes f32, bf16 or f16, asked for "
                        f"{out_dtype}")
    at = _device_scalar(fn, "a", a, dev, torch.float32)
    bt = _device_scalar(fn, "b", b, dev, torch.float32)
    out = torch.empty(n, dtype=out_dtype, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            AXPBY.launch(x.data_ptr(), _IO_CODE[x.dtype], y.data_ptr(),
                         _IO_CODE[y.dtype], out.data_ptr(),
                         _IO_CODE[out_dtype], at.data_ptr(), bt.data_ptr(),
                         flag.data_ptr(), n, grid_blocks(n), _stream(dev))
    return out, flag


def flat_adagrad(p: torch.Tensor, g: torch.Tensor, h: torch.Tensor, *, lr,
                 eps, weight_decay=0.0, grad_scale: Scalar = 1.0,
                 found_inf: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Adagrad step over a flat bucket in place on ``p`` (f32 or
    bf16) and ``h`` (f32, the running sum of squares); ``g`` f32 or bf16;
    returns ``(p, h)``.  ``lr`` and ``grad_scale`` may be device scalars
    (the kernel reads ``lr`` and ``1 / grad_scale`` through pointers);
    ``found_inf`` (optional device i32/bool scalar) leaves ``p`` and
    ``h`` untouched when set."""
    kw = dict(lr=lr, eps=eps, weight_decay=weight_decay,
              grad_scale=grad_scale)
    if p.device.type == "cpu":
        for old, new in zip((p, h), flat_adagrad_ref(p, g, h, **kw)):
            old.copy_(_keep_unless(found_inf, new, old))
        return p, h
    fn, dev, n = "flat_adagrad", p.device, p.numel()
    _check(fn, "p", p, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "h", h, dev, n, (torch.float32,))
    eps_f, wd = (_f32_value(_host_float(fn, k, x)) for k, x in
                 (("eps", eps), ("weight_decay", weight_decay)))
    lr_t = _device_scalar(fn, "lr", lr, dev, torch.float32)
    inv = _inv_scale(fn, grad_scale, dev)
    gate = _gate(fn, found_inf, dev)
    if n:
        with torch.cuda.device(dev):
            ADAGRAD.launch(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
                           _DTYPE_CODE[g.dtype], h.data_ptr(), eps_f, wd,
                           lr_t.data_ptr(), inv.data_ptr(),
                           None if gate is None else gate.data_ptr(), n,
                           grid_blocks(n), _stream(dev))
    return p, h


def segment_offsets(sizes: Sequence[int], device) -> torch.Tensor:
    """The i64 ``(len(sizes) + 1,)`` table of segment starts (and the
    end) that the NovoGrad kernel walks; built once per bucket
    (:meth:`BucketPlan.segment_offsets`)."""
    return torch.tensor([0] + list(itertools.accumulate(sizes)),
                        dtype=torch.int64, device=device)


def flat_novograd(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v_seg: torch.Tensor, sizes: Sequence[int], *, lr, beta1,
                  beta2, eps, weight_decay=0.0, first_run=False,
                  grad_averaging=True, init_zero=False,
                  reg_inside_moment=False, grad_scale: Scalar = 1.0,
                  seg_offsets: Optional[torch.Tensor] = None,
                  found_inf: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One NovoGrad step over a flat bucket of ``len(sizes)`` segments
    (the bucket's leaves), in place on ``p`` (f32 or bf16), ``m`` (f32)
    and ``v_seg`` (f32, one per segment); ``g`` f32 or bf16; returns
    ``(p, m, v_seg)``.

    The per-segment second moment and ``denom = sqrt(v) + eps`` are plain
    PyTorch (:func:`_novograd_second_moment`, the reference's is XLA);
    the kernel then applies the step, reading ``denom`` per segment
    through ``seg_offsets`` (:func:`segment_offsets`, built once per
    bucket; required for a card tensor, unread on the CPU).  ``lr``,
    ``first_run`` (``step == 1`` of the device step clock),
    ``grad_scale`` and ``found_inf`` may be device scalars: no host
    read.  With ``found_inf`` set the kernel writes nothing and
    ``v_seg`` keeps its value too."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, first_run=first_run,
              grad_averaging=grad_averaging, init_zero=init_zero,
              reg_inside_moment=reg_inside_moment, grad_scale=grad_scale)
    if p.device.type == "cpu":
        for old, new in zip((p, m, v_seg), flat_novograd_ref(
                p, g, m, v_seg, sizes, **kw)):
            old.copy_(_keep_unless(found_inf, new, old))
        return p, m, v_seg
    fn, dev, n = "flat_novograd", p.device, p.numel()
    _check(fn, "p", p, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "g", g, dev, n, tuple(_DTYPE_CODE))
    _check(fn, "m", m, dev, n, (torch.float32,))
    nseg = len(sizes)
    _check(fn, "v_seg", v_seg, dev, nseg, (torch.float32,))
    if sum(sizes) != n:
        raise ValueError(f"{fn}: segment sizes sum to {sum(sizes)}, the "
                         f"bucket has {n} elements")
    if seg_offsets is None:
        raise ValueError(f"{fn}: seg_offsets is required for a card tensor "
                         f"(segment_offsets(sizes, device), built once)")
    _check(fn, "seg_offsets", seg_offsets, dev, nseg + 1, (torch.int64,))
    b1, wd = (_f32_value(_host_float(fn, k, x)) for k, x in
              (("beta1", beta1), ("weight_decay", weight_decay)))
    for name, x in (("beta2", beta2), ("eps", eps)):
        _host_float(fn, name, x)
    first = _device_scalar(fn, "first_run", first_run, dev, torch.int32)
    lr_t = _device_scalar(fn, "lr", lr, dev, torch.float32)
    inv = _inv_scale(fn, grad_scale, dev)
    gate = _gate(fn, found_inf, dev)
    if n == 0:
        return p, m, v_seg
    v, denom = _novograd_second_moment(
        g, v_seg, sizes, beta2=beta2, eps=eps, first=first != 0,
        init_zero=init_zero, grad_scale=grad_scale)
    with torch.cuda.device(dev):
        NOVOGRAD.launch(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(),
                        _DTYPE_CODE[g.dtype], m.data_ptr(), denom.data_ptr(),
                        seg_offsets.data_ptr(), nseg, b1, _one_minus(b1), wd,
                        lr_t.data_ptr(), inv.data_ptr(), first.data_ptr(),
                        None if gate is None else gate.data_ptr(),
                        int(bool(grad_averaging)),
                        int(bool(reg_inside_moment)), n, grid_blocks(n),
                        _stream(dev))
    v_seg.copy_(v if gate is None else torch.where(gate == 0, v, v_seg))
    return p, m, v_seg
