"""Welford batch statistics: the port of ``apex_tpu.ops.welford``.

:func:`welford_mean_var` reduces an ``(N, C)`` array over N to the
per-column mean, the biased variance and the count (a 0-d f32 tensor),
all f32 whatever the input dtype: the local half of SyncBatchNorm's
statistics (the reference's ``syncbn.welford_mean_var`` contract), and
:func:`welford_combine` merges such triples by Chan's parallel rule.

The reference routes on its gate (C a multiple of 128) to a Pallas
kernel (ROADMAP Queue 2 row 22) and otherwise to
:func:`welford_mean_var_ref`.  The port keeps the gate.  On it, a tensor
on the card goes to the hand-written ``welford_mean_var`` of
``csrc/welford.cu`` (per-chunk partials, then a combine in chunk order:
no atomics, the same bits every run) and a tensor on the CPU to the
plain version; off it the plain version runs on either device, as the
reference's fallback does.  The reference's dispatch-preference switch
(``op_enabled``) has no counterpart here.

The reference's SyncBatchNorm takes its statistics from the plain
version (it is differentiable), not from the kernel, and so does
:mod:`apex_tpu_torch.parallel.sync_batchnorm`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from apex_tpu_torch import _build

LANE = 128
_SUB = 256              # rows of the kernel's sub-block (the reference's)
# blocks the kernel aims at (four on each of the H100's 132 SMs); a
# constant, so the chunking, and with it the bits, depend on the shape
_TARGET_BLOCKS = 528

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ALIGN = 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

WELFORD = _build.Kernel(
    "welford", "apex_welford_mean_var",
    [_P, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    name="welford_mean_var")


def _use_pallas(c: int) -> bool:
    return c % LANE == 0


def welford_combine(n_a, mean_a, m2_a, n_b, mean_b, m2_b):
    """Chan's parallel combine of two (count, mean, M2) triples.

    Shapes broadcast; counts are scalars or (1, C).  Guarded for empty
    partitions (n == 0)."""
    n = n_a + n_b
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / safe_n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / safe_n)
    return n, mean, m2


def welford_mean_var_ref(x2d: torch.Tensor):
    """The plain version: ``(mean, mean((x - mean)^2), count)`` in f32,
    differentiable."""
    xf = x2d.float()
    mean = xf.mean(dim=0)
    var = ((xf - mean) ** 2).mean(dim=0)
    return mean, var, torch.full((), float(xf.shape[0]), dtype=torch.float32,
                                 device=xf.device)


def _chunking(rows: int, c: int) -> Tuple[int, int]:
    """(rows a chunk, chunks): chunks of whole 256-row sub-blocks, about
    ``_TARGET_BLOCKS`` blocks of 128 columns in all."""
    def cdiv(a, b):
        return -(-a // b)

    want = max(1, _TARGET_BLOCKS // (c // LANE))
    per = max(_SUB, cdiv(cdiv(rows, want), _SUB) * _SUB)
    return per, cdiv(rows, per)


def _welford_cuda(x2d: torch.Tensor):
    rows, c = x2d.shape
    dev = x2d.device
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"welford kernel takes float32, bfloat16 or float16, "
                        f"got {x2d.dtype}")
    if c // LANE > 65535:
        raise ValueError(f"welford kernel: {c} columns exceed the grid's "
                         f"65535 tiles of {LANE}")
    x = x2d.contiguous()
    if x.data_ptr() % _ALIGN:
        x = x.clone()
    per, chunks = _chunking(rows, c)
    # the chunks' means and M2, then the per-column shifts (the mean of
    # the first 256 rows)
    part = torch.empty(2 * chunks + 1, c, dtype=torch.float32, device=dev)
    part_n = torch.empty(max(chunks, 1), dtype=torch.float32, device=dev)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    var = torch.empty(c, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        WELFORD.launch(x.data_ptr(), _DTYPE_CODE[x.dtype], rows, c, per,
                       chunks, part[:chunks].data_ptr(),
                       part[chunks:2 * chunks].data_ptr(), part_n.data_ptr(),
                       part[2 * chunks].data_ptr(), mean.data_ptr(),
                       var.data_ptr(),
                       count.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    return mean, var, count


def welford_mean_var(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Local Welford stats of an ``(N, C)`` array, reduced over N:
    ``(mean (C,), biased var (C,), count ())``, f32.  C a multiple of 128
    takes the kernel on the card; otherwise the plain version runs."""
    if x2d.dim() != 2:
        raise ValueError(f"welford_mean_var takes an (N, C) array, got shape "
                         f"{tuple(x2d.shape)}")
    if not _use_pallas(x2d.shape[1]) or x2d.device.type == "cpu":
        return welford_mean_var_ref(x2d)
    return _welford_cuda(x2d)
