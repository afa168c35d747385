"""ImageNet AMP training on the card (port of examples/imagenet/main_amp.py:
ResNet, amp O0-O3, bucketed FusedSGD, the flat grad-accum pipeline).

Data is synthetic ImageNet-shaped batches (the training math, the amp
plumbing and the throughput accounting are the real thing):

    python -m apex_tpu_torch.examples.imagenet_main_amp --arch resnet50 \
        --opt-level O2 [--batch-size 128] [--steps 20] [--grad-accum 2] \
        [--checkpoint PATH | --checkpoint-dir DIR [--save-every 10] \
         [--preempt-at-step N]] [--device cpu]

Defaults follow the reference: batch 128 at 224x224 on the card (8 at
64x64 on the CPU), lr 0.1, momentum 0.9, weight decay 1e-4.  The step
never syncs the host; the loss is echoed one step in ten.  f32 convs
and matmuls run in full f32 (TF32 off), as the reference's O2 model
computes in f32.  At O1 the params stay f32 and the loss runs under the
op-list rewrite (``AmpState.wrap_forward``): the convolutions and the
dense layer in bf16, the BatchNorms and the loss in f32.

``--sync-bn`` runs ResNet with
:class:`~apex_tpu_torch.parallel.SyncBatchNorm` as the reference's
``norm_cls`` (``main_amp.py:102-108``).  Without
``--ddp`` there is one process, so its statistics are the local ones.
The reference's NHWC model passes ``channel_last=True``; the port's
ResNet is NCHW (in channels_last memory), so it passes
``channel_last=False``: the same reduction over N, H and W.

Checkpoints are the reference's bundle (params, optimizer, amp, and
BatchNorm's ``batch_stats`` as ``extra``; :mod:`apex_tpu_torch.checkpoint`).
``--checkpoint PATH`` resumes from PATH when it exists and writes it (v1,
per leaf) at the end.  ``--checkpoint-dir DIR`` keeps rotating
bucket-native checkpoints (:class:`~apex_tpu_torch.resilience.
CheckpointManager`, every ``--save-every`` steps), resumes from the newest
valid one, and on SIGTERM or at ``--preempt-at-step N`` makes a final
save, waits for it and exits cleanly; rerun the same command to resume
(a run that resumes at or past N takes no notice from it).
A resumed run prints ``resumed at step N scale S``.  ``--steps`` is the
total: a resumed run finishes it.  Saves happen only on cadence steps, so
no other step syncs the host.  As in the reference, a resumed run builds
its pool of batches afresh and starts at its first batch, so it sees the
uninterrupted run's batches only when it resumes at a multiple of 4.

Not ported yet (raises ``NotImplementedError`` naming its item): ``--ddp``
(ROADMAP Queue 1, slice 2 item T2).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp, checkpoint as ckpt
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._tree import tree_map
from apex_tpu_torch.data import DevicePrefetcher
from apex_tpu_torch.models import resnet18, resnet34, resnet50, resnet101
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import SyncBatchNorm
from apex_tpu_torch.resilience import CheckpointManager, PreemptionGuard

ARCHS = {"resnet18": resnet18, "resnet34": resnet34,
         "resnet50": resnet50, "resnet101": resnet101}

DDP_TODO = ("ROADMAP Queue 1, slice 2 item T2 (DDP, and SyncBN over NCCL: "
            "slice 9)")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = by device (128 on the card, 8 on the CPU)")
    p.add_argument("--image-size", type=int, default=0,
                   help="0 = by device (224 on the card, 64 on the CPU)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into N microbatches and "
                        "accumulate flat (one flat_accumulate per bucket "
                        "per microbatch, found_inf latched)")
    p.add_argument("--ddp", action="store_true")
    p.add_argument("--sync-bn", action="store_true")
    p.add_argument("--checkpoint", default="",
                   help="one v1 checkpoint file: resume from it when it "
                        "exists, write it at the end")
    p.add_argument("--checkpoint-dir", default="",
                   help="rotating crash-safe checkpoints (bucket-native "
                        "v2), resume from the newest valid one; overrides "
                        "--checkpoint")
    p.add_argument("--save-every", type=int, default=10,
                   help="checkpoint cadence in steps (--checkpoint-dir)")
    p.add_argument("--preempt-at-step", type=int, default=None,
                   help="give a preemption notice at step N: final "
                        "checkpoint, clean exit (--checkpoint-dir; SIGTERM "
                        "does the same)")
    p.add_argument("--stem-space-to-depth", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


@dataclasses.dataclass
class TrainResult:
    losses: List[float]           # one per step, read after the run
    imgs_per_sec: Optional[float]  # over the steps after the first
    step_seconds: float           # host wall per timed step
    batch: int
    image: int
    device: str
    opt: Any                      # the FusedSGD (params, masters, state)
    amp_state: Any
    batch_stats: Any
    start_step: int = 0           # the step a resumed run started at
    preempted: bool = False


def synthetic_batches(batch: int, size: int, steps: int, seed: int = 1,
                      num_classes: int = 1000):
    """The reference's data: a pool of ``min(4, steps)`` batches from
    ``numpy.random.default_rng(seed)``, NHWC f32 images and i32 labels
    in ``[0, num_classes)``, cycled for ``steps``."""
    nrng = np.random.default_rng(seed)
    pool = [(nrng.standard_normal((batch, size, size, 3), dtype=np.float32),
             nrng.integers(0, num_classes, (batch,)).astype(np.int32))
            for _ in range(min(4, steps))]
    return (pool[i % len(pool)] for i in range(steps))


def train(arch: str = "resnet50", opt_level: str = "O2", batch: int = 0,
          image: int = 0, steps: int = 20, lr: float = 0.1,
          momentum: float = 0.9, weight_decay: float = 1e-4,
          grad_accum: int = 1, device=None, num_classes: int = 1000,
          width: int = 64, stem_space_to_depth: bool = False,
          sync_bn: bool = False, variables=None, seed: int = 0, data=None,
          checkpoint: str = "", checkpoint_dir: str = "",
          save_every: int = 10, preempt_at_step: Optional[int] = None,
          log: Optional[Callable[[str], None]] = print,
          on_step: Optional[Callable[[int], None]] = None) -> TrainResult:
    """Train to step ``steps``; the body of :func:`main`.

    ``checkpoint`` / ``checkpoint_dir`` / ``save_every`` /
    ``preempt_at_step``: the flags of the same names (module docstring);
    a resumed run takes ``steps`` minus its start step.  cuDNN autotunes
    its algorithms on the card unless the caller has set
    ``torch.backends.cudnn.deterministic`` (a resumed run held bit for
    bit to an uninterrupted one needs the same algorithms in both).

    ``sync_bn``: the norms are ``SyncBatchNorm`` (world size 1).
    ``variables``: optional ``(params, batch_stats)`` f32 trees to start
    from (default: ``model.init(seed)``).  ``data``: optional iterable of
    ``(x NHWC f32, y int)`` numpy batches (default: the reference's
    synthetic pool).  ``on_step(step)`` runs at the end of each step's
    host work (the step itself is enqueued, not finished)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the reference's O2 model computes f32 convs and matmuls: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = \
            not torch.backends.cudnn.deterministic
    batch = batch or (128 if dev.type == "cuda" else 8)
    size = image or (224 if dev.type == "cuda" else 64)
    if log:
        log(f"apex_tpu_torch: {arch} amp {opt_level} batch {batch} img "
            f"{size} on {dev}"
            + (f" grad-accum {grad_accum} (flat)" if grad_accum > 1 else "")
            + (" sync-bn" if sync_bn else ""))

    # the reference passes channel_last=True for its NHWC model; the
    # port's is NCHW: the same reduction over N, H and W
    norm_cls = (functools.partial(SyncBatchNorm, channel_last=False)
                if sync_bn else None)
    model = ARCHS[arch](num_classes=num_classes, width=width,
                        stem_space_to_depth=stem_space_to_depth,
                        norm_cls=norm_cls)
    if variables is None:
        params, batch_stats = model.init(seed, dev)
    else:
        params, batch_stats = variables
    params, amp_state = amp.initialize(params, opt_level=opt_level,
                                       device=dev)
    opt = FusedSGD(params, lr=lr, momentum=momentum,
                   weight_decay=weight_decay,
                   master_weights=bool(amp_state.properties.master_weights),
                   masters=amp_state.master_params)

    def loss_fn(p, bs, x, y):
        logits, new_bs = model.apply(p, bs, x, train=True)
        ll = -torch.gather(F.log_softmax(logits.float(), dim=-1), 1,
                           y.long()[:, None])
        return ll.mean(), new_bs

    # O1 rewrites the ops; O2/O3 cast the data input (arg 2) to the model
    # half dtype
    wrapped_loss = amp_state.wrap_forward(loss_fn, cast_argnums=(2,))

    if grad_accum > 1:
        pipe = amp_state.flat_pipeline(optimizer=opt)

        def train_step(p, bs, scaler, x, y):
            def loss_bs(pp, xx, yy):
                return wrapped_loss(pp, bs, xx, yy)

            (loss, new_bs), flat = pipe.scaled_value_and_grad(
                loss_bs, scaler, p, x, y, has_aux=True,
                microbatches=grad_accum)
            # every microbatch folds BN stats from the same input stats:
            # average the N candidates (mean of micro-means == the
            # full-batch mean)
            new_bs = tree_map(lambda a: a.mean(dim=0), new_bs)
            return loss, flat, new_bs, flat.found_inf
    else:
        def train_step(p, bs, scaler, x, y):
            (loss, new_bs), grads, found_inf = amp.scaled_value_and_grad(
                wrapped_loss, scaler, p, bs, x, y, has_aux=True)
            return loss, grads, new_bs, found_inf

    step0 = 0
    mgr = guard = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, keep=3, every=save_every)
        restored = mgr.restore_latest(opt.params, opt,
                                      extra_like=batch_stats)
    elif checkpoint and os.path.exists(checkpoint):
        restored = ckpt.load_training_state(checkpoint, opt.params, opt,
                                            extra_like=batch_stats)
    else:
        restored = None
    if restored is not None:
        _, amp_sd, step0, batch_stats = restored
        if amp_sd:
            amp_state = amp_state.load_state_dict(amp_sd)
        if log:
            log(f"resumed at step {step0} "
                f"scale {float(amp_state.scaler.loss_scale):.0f}")
    if mgr is not None:
        # a notice at a step the run resumes past was given to the run
        # that saved it: the same command, run again, finishes
        guard = PreemptionGuard(
            preempt_at_step=preempt_at_step if preempt_at_step is not None
            and preempt_at_step > step0 else None).install()

    try:
        # --steps is the total: a resumed run finishes it
        remaining = max(0, steps - step0)
        source = data if data is not None else synthetic_batches(
            batch, size, remaining, num_classes=num_classes)
        losses: List[torch.Tensor] = []
        t0 = None
        done = step0
        preempted = False
        for step, (x, y) in enumerate(DevicePrefetcher(source, depth=2,
                                                       device=dev),
                                      start=step0):
            loss, grads, batch_stats, found_inf = train_step(
                opt.params, batch_stats, amp_state.scaler, x, y)
            # branch-free overflow skip: the flag stays on the device
            opt.step(grads, found_inf=found_inf)
            amp_state = amp.update_scaler(amp_state, found_inf)
            losses.append(loss)
            done = step + 1
            if mgr is not None:
                # the amp state is read (a host sync) on cadence steps only
                saved_now = mgr.due(done) and mgr.maybe_save(
                    done, optimizer=opt, amp_state=amp_state.state_dict(),
                    extra=batch_stats)
                if guard.check(done):
                    # make this step durable and exit; a cadence save
                    # just scheduled for it only needs the wait
                    if not saved_now:
                        mgr.save(done, optimizer=opt,
                                 amp_state=amp_state.state_dict(),
                                 extra=batch_stats)
                    mgr.wait()
                    preempted = True
                    if log:
                        log(f"preempted: final checkpoint durable at step "
                            f"{done} — rerun to resume")
                    break
            if step == step0:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()      # the first step warms up
            if step % 10 == 0 and log:
                # one step in ten: a console echo, not a per-step sync
                log(f"step {step:4d} loss {float(loss):.4f} "
                    f"scale {float(amp_state.scaler.loss_scale):.0f}")
            if on_step is not None:
                on_step(step)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        n_timed = done - step0 - 1
        wall = time.perf_counter() - t0 if t0 is not None else 0.0
        imgs = (batch * n_timed / wall if n_timed > 0 and wall > 0
                and not preempted else None)
        if imgs is not None and log:
            log(f"throughput {imgs:.1f} imgs/sec")
        if mgr is not None and not preempted:
            mgr.save(done, optimizer=opt, amp_state=amp_state.state_dict(),
                     extra=batch_stats)
            mgr.wait()
            if log:
                log(f"checkpointed to {checkpoint_dir} (step {done})")
        elif mgr is None and checkpoint:
            ckpt.save_training_state(
                checkpoint, opt.params, opt,
                amp_state=amp_state.state_dict(), step=done,
                extra=batch_stats)
            if log:
                log(f"checkpointed to {checkpoint}")
    finally:
        if guard is not None:
            guard.uninstall()
        if mgr is not None:
            mgr.close()
    return TrainResult(
        losses=[float(v) for v in torch.stack(losses).cpu()] if losses
        else [], imgs_per_sec=imgs,
        step_seconds=wall / n_timed if n_timed > 0 else 0.0, batch=batch,
        image=size, device=str(dev), opt=opt, amp_state=amp_state,
        batch_stats=batch_stats, start_step=step0, preempted=preempted)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    if args.ddp:
        raise NotImplementedError(f"--ddp: {DDP_TODO}")
    if args.preempt_at_step is not None and not args.checkpoint_dir:
        raise ValueError("--preempt-at-step needs --checkpoint-dir (the "
                         "final save goes there)")
    return train(arch=args.arch, opt_level=args.opt_level,
                 batch=args.batch_size, image=args.image_size,
                 steps=args.steps, lr=args.lr, momentum=args.momentum,
                 weight_decay=args.weight_decay, grad_accum=args.grad_accum,
                 device=args.device,
                 stem_space_to_depth=args.stem_space_to_depth,
                 sync_bn=args.sync_bn, checkpoint=args.checkpoint,
                 checkpoint_dir=args.checkpoint_dir,
                 save_every=args.save_every,
                 preempt_at_step=args.preempt_at_step)


if __name__ == "__main__":
    main()
