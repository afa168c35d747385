"""ResNet-18/34/50/101/152 as functions of a parameter tree.

The port of ``apex_tpu.models.resnet`` (v1.5: the stride on the 3x3 of
the bottleneck).  The parameters and BatchNorm statistics are nested
dicts with the flax model's names and layouts — ``Conv_0``,
``BatchNorm_0``, ``Bottleneck_10``, ...; conv kernels HWIO, the dense
kernel (in, out) — so the port's tree flattens, packs and checkpoints
exactly as the reference's.  The forward takes torch's view of each
kernel (OIHW) at use, and the input in the reference's NHWC layout,
whose NCHW view is channels_last: on the card every conv runs
channels_last (on the CPU, NCHW).

Precision is the reference's: every layer computes in ``dtype`` (f32 by
default) whatever the params' dtype, so under amp O2 the bf16 params
and the bf16-cast input are promoted to f32, and the gradient of a bf16
param comes back bf16.  BatchNorm computes in f32; inside an amp O1
call it is flax's decomposition at the dtypes the reference's rewrite
gives it (:func:`_flax_batch_norm`).

BatchNorm has flax's semantics, not ``torch.nn.BatchNorm2d``'s: the
running averages move by ``momentum=0.9`` (the weight of the OLD value)
and the running variance takes the biased batch variance.  With
``norm_cls=SyncBatchNorm`` (:mod:`apex_tpu_torch.parallel`, the
reference's ``norm_cls``) the norms are that module's, named as flax
names them: ``SyncBatchNorm_<k>`` with ``weight``/``bias`` and
``running_mean``/``running_var``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch import _numerics
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp import wrap as amp_wrap

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C), channel order (row parity,
    col parity, C) row-major — what :func:`fold_stem_kernel` expects."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"space_to_depth: spatial dims must be multiples of {block}, "
            f"got {h}x{w} — the default 7x7 stem "
            "(stem_space_to_depth=False) accepts any size")
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               block * block * c)


def fold_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, F) stride-2 stem kernel -> the (4, 4, 4C, F) stride-1
    kernel acting on space_to_depth(2) input (with input padding (2, 1))."""
    w8 = F.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))
    c, f = w7.shape[2], w7.shape[3]
    w4 = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return w4.reshape(4, 4, 4 * c, f)


def batch_norm(x: torch.Tensor, params: Dict, stats: Dict, train: bool,
               momentum: float = BN_MOMENTUM, eps: float = BN_EPS
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """flax ``nn.BatchNorm(dtype=f32)`` on an NCHW tensor: returns
    ``(y, new_stats)`` (``new_stats`` None in eval).  In training the
    batch statistics normalise and the running averages move as
    ``momentum * old + (1 - momentum) * batch`` with the BIASED batch
    variance (torch's own BatchNorm weighs the other way round and takes
    the unbiased one, so it is not used for the update)."""
    x = x.float()
    scale, bias = params["scale"].float(), params["bias"].float()
    if amp_wrap.active():
        return _flax_batch_norm(x, scale, bias, stats, train, momentum, eps)
    if not train:
        return F.batch_norm(x, stats["mean"], stats["var"], scale, bias,
                            training=False, eps=eps), None
    y = F.batch_norm(x, None, None, scale, bias, training=True, eps=eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        new = {"mean": momentum * stats["mean"] + (1.0 - momentum) * mean,
               "var": momentum * stats["var"] + (1.0 - momentum) * var}
    return y, new


def _flax_batch_norm(x, scale, bias, stats, train, momentum, eps):
    """flax ``nn.BatchNorm``'s own decomposition: the fast variance
    ``max(0, E[x^2] - E[x]^2)``, then ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, at the dtypes the reference's O1 rewrite gives each
    of its primitives: a bf16 input stays bf16 (flax's upcast is not in
    the f32 trace), its square is rounded to bf16, the means sum in f32
    and the normalisation promotes to f32.  The dtypes are written out
    and the engine suspended, so that no f32 copy of the input is made
    for a mean or a difference."""
    dims, shape = (0, 2, 3), (1, -1, 1, 1)
    with torch._C.DisableTorchFunction():
        if train:
            mean = x.mean(dim=dims, dtype=torch.float32)
            var = torch.clamp(
                torch.square(x).mean(dim=dims, dtype=torch.float32)
                - torch.square(mean), min=0.0)
        else:
            mean, var = stats["mean"], stats["var"]
        y = (x - mean.reshape(shape)) * (torch.rsqrt(var + eps)
                                         * scale).reshape(shape)
        y = y + bias.reshape(shape)
        if not train:
            return y, None
        with torch.no_grad():
            new = {"mean": momentum * stats["mean"]
                   + (1.0 - momentum) * mean,
                   "var": momentum * stats["var"] + (1.0 - momentum) * var}
    return y, new


class _Scope:
    """flax's automatic names: ``<Class>_<k>`` in call order per parent."""

    def __init__(self, params: Dict, stats: Dict):
        self.params, self.stats = params, stats
        self.new_stats: Dict = {}
        self._count: Dict[str, int] = {}

    def name(self, cls: str) -> str:
        k = self._count.get(cls, 0)
        self._count[cls] = k + 1
        return f"{cls}_{k}"


def _norm_fn(norm_cls: Optional[Callable]) -> Callable:
    """The norm a ResNet applies: :func:`batch_norm` by default; a module
    class (or a ``functools.partial`` of one) is built once with no
    further arguments, as flax builds ``norm_cls()``; any other callable
    is used as it is, with :func:`batch_norm`'s signature."""
    if norm_cls is None:
        return batch_norm
    factory = (norm_cls.func if isinstance(norm_cls, functools.partial)
               else norm_cls)
    return norm_cls() if isinstance(factory, type) else norm_cls


class ResNet:
    """``stage_sizes`` blocks of ``block`` ("BasicBlock" or "Bottleneck")
    per stage, ``width`` stem filters.  ``norm_cls``: optional
    replacement for :func:`batch_norm` with its signature, or a norm
    module class such as ``SyncBatchNorm`` (see :func:`_norm_fn`); its
    ``name`` (default "BatchNorm") names the norms in the tree and its
    ``init(c, device)``, where it has one, makes their leaves."""

    def __init__(self, stage_sizes: Sequence[int], block: str,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.float32,
                 norm_cls: Optional[Callable] = None,
                 stem_space_to_depth: bool = False):
        if block not in ("BasicBlock", "Bottleneck"):
            raise ValueError(f"unknown block {block!r}")
        self.stage_sizes = tuple(stage_sizes)
        self.block = block
        self.expansion = 4 if block == "Bottleneck" else 1
        self.num_classes = num_classes
        self.width = width
        self.dtype = dtype
        self.norm = _norm_fn(norm_cls)
        self.norm_name = getattr(self.norm, "name", "BatchNorm")
        self.stem_space_to_depth = stem_space_to_depth

    # ---- parameters ------------------------------------------------------
    def _block_specs(self):
        """(name, filters, strides, in_channels) of every block."""
        out, cin, k = [], self.width, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                filters = self.width * 2 ** i
                strides = 2 if i > 0 and j == 0 else 1
                out.append((f"{self.block}_{k}", filters, strides, cin))
                cin = filters * self.expansion
                k += 1
        return out, cin

    def init(self, seed: int = 0, device=None, in_channels: int = 3
             ) -> Tuple[Dict, Dict]:
        """``(params, batch_stats)`` in f32 on ``device`` (default: the
        card).  Kernels are flax's ``lecun_normal`` (truncated normal,
        fan-in scaled), BN scale 1 / bias 0 / mean 0 / var 1, the dense
        bias 0, drawn on the CPU from ``seed`` so every device gets the
        same values."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)

        def kernel(*shape):
            fan_in = math.prod(shape[:-1])
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            w = torch.empty(shape)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            return (w * std).to(dev)

        def bn(c):
            if hasattr(self.norm, "init"):
                return self.norm.init(c, dev)
            return ({"scale": torch.ones(c, device=dev),
                     "bias": torch.zeros(c, device=dev)},
                    {"mean": torch.zeros(c, device=dev),
                     "var": torch.ones(c, device=dev)})

        params, stats = {}, {}
        stem = "stem_conv" if self.stem_space_to_depth else "Conv_0"
        params[stem] = (kernel(7, 7, in_channels, self.width)
                        if self.stem_space_to_depth
                        else {"kernel": kernel(7, 7, in_channels, self.width)})
        top = f"{self.norm_name}_0"
        params[top], stats[top] = bn(self.width)
        blocks, cout = self._block_specs()
        for name, filters, strides, cin in blocks:
            p, s = {}, {}
            if self.block == "Bottleneck":
                convs = [(1, cin, filters), (3, filters, filters),
                         (1, filters, filters * 4)]
            else:
                convs = [(3, cin, filters), (3, filters, filters)]
            out_c = filters * self.expansion
            if cin != out_c or strides != 1:
                convs.append((1, cin, out_c))
            for ci, (k, a, b) in enumerate(convs):
                p[f"Conv_{ci}"] = {"kernel": kernel(k, k, a, b)}
                norm = f"{self.norm_name}_{ci}"
                p[norm], s[norm] = bn(b)
            params[name], stats[name] = p, s
        params["Dense_0"] = {"kernel": kernel(cout, self.num_classes),
                             "bias": torch.zeros(self.num_classes,
                                                 device=dev)}
        return params, stats

    # ---- forward ---------------------------------------------------------
    def _conv(self, x, w, strides=1, padding=0):
        # HWIO param -> OIHW view, in the compute dtype; channels_last on
        # the card, NCHW on the CPU (torch's multi-threaded oneDNN conv
        # backward in channels_last segfaults at some small CPU shapes);
        # on the CPU summed in f64 outside amp O1, so the host does not
        # decide the bits
        fmt = (torch.channels_last if x.device.type == "cuda"
               else torch.contiguous_format)
        w = w.to(self.dtype).permute(3, 2, 0, 1).contiguous(memory_format=fmt)
        return _numerics.conv2d(x.to(self.dtype).contiguous(memory_format=fmt),
                                w, stride=strides, padding=padding)

    def _norm(self, scope: _Scope, x, train):
        name = scope.name(self.norm_name)
        y, new = self.norm(x, scope.params[name], scope.stats[name], train)
        if new is not None:
            scope.new_stats[name] = new
        return y

    def _block(self, p, s, x, filters, strides, train):
        scope = _Scope(p, s)
        conv = lambda x, k, st=1, pad=0: self._conv(  # noqa: E731
            x, p[scope.name("Conv")]["kernel"], st, pad)
        residual = x
        if self.block == "Bottleneck":
            y = F.relu(self._norm(scope, conv(x, 1), train))
            y = F.relu(self._norm(scope, conv(y, 3, strides, 1), train))
            y = self._norm(scope, conv(y, 1), train)
        else:
            y = F.relu(self._norm(scope, conv(x, 3, strides, 1), train))
            y = self._norm(scope, conv(y, 3, 1, 1), train)
        if residual.shape != y.shape:
            residual = self._norm(scope, conv(x, 1, strides), train)
        return F.relu(y + residual), scope.new_stats

    def apply(self, params: Dict, batch_stats: Dict, x: torch.Tensor,
              train: bool = True):
        """Logits (f32) of an NHWC batch; in training also the new batch
        statistics: ``(logits, new_batch_stats)``."""
        top = _Scope(params, batch_stats)
        x = x.to(self.dtype)
        if self.stem_space_to_depth:
            x = space_to_depth(x, 2).permute(0, 3, 1, 2)
            x = self._conv(F.pad(x, (2, 1, 2, 1)),
                           fold_stem_kernel(params["stem_conv"]))
        else:
            x = self._conv(x.permute(0, 3, 1, 2),
                           params[top.name("Conv")]["kernel"], 2, 3)
        x = F.relu(self._norm(top, x, train))
        x = F.max_pool2d(x, 3, 2, 1)
        blocks, _ = self._block_specs()
        for name, filters, strides, _ in blocks:
            x, new = self._block(params[name], batch_stats[name], x,
                                 filters, strides, train)
            top.new_stats[name] = new
        x = x.float().mean(dim=(2, 3))
        dense = params["Dense_0"]
        logits = F.linear(x, dense["kernel"].float().t(),
                          dense["bias"].float())
        if train:
            return logits, top.new_stats
        return logits


def resnet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], "BasicBlock", **kw)


def resnet34(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], "BasicBlock", **kw)


def resnet50(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], "Bottleneck", **kw)


def resnet101(**kw) -> ResNet:
    return ResNet([3, 4, 23, 3], "Bottleneck", **kw)


def resnet152(**kw) -> ResNet:
    return ResNet([3, 8, 36, 3], "Bottleneck", **kw)
