"""DCGAN with amp on the card (port of examples/dcgan/main_amp.py: the
multiple-models, multiple-losses amp demo).

Two models, two ``FusedAdam`` optimizers and two loss scalers, one per
loss (the reference's ``amp.initialize(models=[D, G], ..., num_losses)``
pattern), and one ``amp.state_dict`` over both scalers at the end:

    python -m apex_tpu_torch.examples.dcgan_main_amp [--steps 30] \
        [--opt-level O1] [--batch-size 16] [--nz 32] [--device cpu]

The models are the reference's (``Generator`` :23, ``Discriminator`` :37):
a dense layer and two 4x4 stride-2 transposed convolutions up to a
16x16x3 image, two 4x4 stride-2 convolutions and a dense logit down.
Their parameters keep flax's names and layouts (kernels HWIO, dense
``(in, out)``), so the weights carry across unchanged
(:func:`apex_tpu_torch.convert.dcgan_from_jax`); the forward takes
torch's views at use.  flax's ``ConvTranspose`` does not flip its
kernel and ``F.conv_transpose2d`` does, so the forward flips it; flax's
``SAME`` padding at kernel 4 and stride 2 is torch's ``padding=1``; the
activations run NCHW and the dense layers see flax's NHWC order.

Each layer computes in the promoted dtype of its input and its params,
as flax's ``promote_dtype`` does.  At O1 the reference never wraps the
forward: it rounds ``z`` and the real images to bf16 (:80) and the f32
params promote them back, so O1 here is that input rounding and nothing
more.  The overflow skip is branch-free (the flag stays on the device;
the reference reads it on the host).  Data is synthetic: ``z`` normal,
the real images ``tanh`` of a normal, from ``numpy.random``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.data import DevicePrefetcher
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.tensor_parallel.layers import lecun_normal


def _promote(*ts):
    """flax's ``promote_dtype``: every operand in their widest dtype."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _dense(p, x):
    x, w, b = _promote(x, p["kernel"], p["bias"])
    return F.linear(x, w.t(), b)


def _conv(p, x):
    """flax ``Conv(k=4, strides=2, padding='SAME')`` on NCHW."""
    x, w, b = _promote(x, p["kernel"], p["bias"])
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=2, padding=1)


def _conv_transpose(p, x):
    """flax ``ConvTranspose(k=4, strides=2, padding='SAME')`` on NCHW:
    the HWIO kernel flipped (flax does not flip, torch does) and taken
    as torch's (in, out, kh, kw)."""
    x, w, b = _promote(x, p["kernel"], p["bias"])
    w = w.flip(0, 1).permute(2, 3, 0, 1)
    return F.conv_transpose2d(x, w, b, stride=2, padding=1)


def _init_dense(gen, n_in, n_out, dev):
    return {"kernel": lecun_normal((n_in, n_out), gen).to(dev),
            "bias": torch.zeros(n_out, device=dev)}


def _init_conv(gen, c_in, c_out, dev):
    return {"kernel": lecun_normal((4, 4, c_in, c_out), gen).to(dev),
            "bias": torch.zeros(c_out, device=dev)}


class Generator:
    """``z`` (B, nz) -> an NHWC image (B, 16, 16, 3) in [-1, 1]."""

    def __init__(self, ch: int = 16, nz: int = 32):
        self.ch, self.nz = ch, nz

    def init(self, seed: int = 0, device=None) -> Dict:
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        ch = self.ch
        return {"ConvTranspose_0": _init_conv(gen, 4 * ch, 2 * ch, dev),
                "ConvTranspose_1": _init_conv(gen, 2 * ch, 3, dev),
                "Dense_0": _init_dense(gen, self.nz, 16 * 4 * ch, dev)}

    def __call__(self, p: Dict, z: torch.Tensor) -> torch.Tensor:
        h = _dense(p["Dense_0"], z)
        h = F.relu(h.reshape(z.shape[0], 4, 4, 4 * self.ch)
                   .permute(0, 3, 1, 2))
        h = F.relu(_conv_transpose(p["ConvTranspose_0"], h))
        h = _conv_transpose(p["ConvTranspose_1"], h)
        return torch.tanh(h).permute(0, 2, 3, 1)


class Discriminator:
    """An NHWC image (B, 16, 16, 3) -> one logit per image (B,)."""

    def __init__(self, ch: int = 16):
        self.ch = ch

    def init(self, seed: int = 1, device=None) -> Dict:
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        ch = self.ch
        return {"Conv_0": _init_conv(gen, 3, ch, dev),
                "Conv_1": _init_conv(gen, ch, 2 * ch, dev),
                "Dense_0": _init_dense(gen, 4 * 4 * 2 * ch, 1, dev)}

    def __call__(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(_conv(p["Conv_0"], x.permute(0, 3, 1, 2)), 0.2)
        h = F.leaky_relu(_conv(p["Conv_1"], h), 0.2)
        h = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's order
        return _dense(p["Dense_0"], h)[:, 0]


def bce_logits(logit: torch.Tensor, target: float) -> torch.Tensor:
    """The reference's ``bce_logits`` (:49), a stable BCE on logits."""
    return torch.mean(torch.clamp(logit, min=0) - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def losses(netG: Generator, netD: Discriminator, half: torch.dtype):
    """The reference's ``d_loss(pd, pg, z, real)`` and ``g_loss(pg, pd,
    z)`` (:83-94): the inputs rounded to ``half``, the logits read in
    f32."""
    def d_loss(pd, pg, z, real):
        fake = netG(pg, z.to(half))
        dr = netD(pd, real.to(half))
        df = netD(pd, fake)
        return bce_logits(dr.float(), 1.0) + bce_logits(df.float(), 0.0)

    def g_loss(pg, pd, z):
        fake = netG(pg, z.to(half))
        return bce_logits(netD(pd, fake).float(), 1.0)

    return d_loss, g_loss


def synthetic_batches(batch: int, nz: int, steps: int, seed: int = 2):
    """``steps`` pairs ``(z (B, nz), real (B, 16, 16, 3))`` of f32 numpy
    arrays from ``numpy.random.default_rng(seed)``: z normal, the real
    images ``tanh`` of a normal."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        z = rng.standard_normal((batch, nz), dtype=np.float32)
        real = np.tanh(rng.standard_normal((batch, 16, 16, 3),
                                           dtype=np.float32))
        yield z, real


@dataclasses.dataclass
class TrainResult:
    losses_d: List[float]          # one per step, read after the run
    losses_g: List[float]
    step_seconds: float            # host wall per timed step
    device: str
    opt_d: Any
    opt_g: Any
    amp_d: Any
    amp_g: Any
    state_dict: Dict               # amp.state_dict over both scalers


def train(steps: int = 30, opt_level: str = "O1", batch: int = 16,
          nz: int = 32, device=None, variables=None, data=None,
          log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """The reference's loop (:74-120); the body of :func:`main`.
    ``variables``: optional ``(params_g, params_d)`` f32 trees (default:
    ``init`` from seeds 0 and 1); ``data``: optional iterable of ``(z,
    real)`` numpy batches (default: :func:`synthetic_batches`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    netG, netD = Generator(nz=nz), Discriminator()
    if variables is None:
        pG, pD = netG.init(0, dev), netD.init(1, dev)
    else:
        pG, pD = variables
    if log:
        log(f"apex_tpu_torch: dcgan amp {opt_level} b{batch} nz{nz} on "
            f"{dev}")
    # one amp state per loss: the reference's two scalers
    pG, ampG = amp.initialize(pG, opt_level=opt_level, device=dev)
    pD, ampD = amp.initialize(pD, opt_level=opt_level, device=dev)
    optG = FusedAdam(pG, lr=2e-4, beta1=0.5, beta2=0.999)
    optD = FusedAdam(pD, lr=2e-4, beta1=0.5, beta2=0.999)
    half = torch.bfloat16 if opt_level != "O0" else torch.float32
    d_loss, g_loss = losses(netG, netD, half)

    source = data if data is not None else synthetic_batches(batch, nz,
                                                             steps)
    lossesD: List[torch.Tensor] = []
    lossesG: List[torch.Tensor] = []
    t0, done = None, 0
    for step, (z, real) in enumerate(DevicePrefetcher(source, depth=2,
                                                      device=dev)):
        lossD, gD, infD = amp.scaled_value_and_grad(
            d_loss, ampD.scaler, optD.params, optG.params, z, real)
        optD.step(gD, found_inf=infD)
        ampD = amp.update_scaler(ampD, infD)
        lossG, gG, infG = amp.scaled_value_and_grad(
            g_loss, ampG.scaler, optG.params, optD.params, z)
        optG.step(gG, found_inf=infG)
        ampG = amp.update_scaler(ampG, infG)
        lossesD.append(lossD)
        lossesG.append(lossG)
        done = step + 1
        if step == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()      # the first step warms up
        if step % 10 == 0 and log:
            log(f"step {step:3d} lossD {float(lossD):.4f} "
                f"lossG {float(lossG):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0 if t0 is not None else 0.0
    # the reference's checkpoint: one state_dict over BOTH scalers
    sd = amp.state_dict(ampD, ampG)
    ampD, ampG = amp.load_state_dict(sd, ampD, ampG)
    if log:
        log(f"OK: D {float(lossD):.3f} G {float(lossG):.3f} "
            f"scalers {sorted(sd)}")

    def host(xs):
        return [float(v) for v in torch.stack(xs).cpu()] if xs else []

    return TrainResult(
        losses_d=host(lossesD), losses_g=host(lossesG),
        step_seconds=wall / (done - 1) if done > 1 else 0.0,
        device=str(dev), opt_d=optD, opt_g=optG, amp_d=ampD, amp_g=ampG,
        state_dict=sd)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    return train(steps=args.steps, opt_level=args.opt_level,
                 batch=args.batch_size, nz=args.nz, device=args.device)


if __name__ == "__main__":
    main()
