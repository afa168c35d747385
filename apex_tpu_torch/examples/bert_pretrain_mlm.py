"""BERT MLM pretraining on the card (port of examples/bert/pretrain_mlm.py,
BASELINE config 3: FusedLAMB + FusedLayerNorm + contrib.xentropy).

Synthetic masked-LM batches (no corpus on disk); the amp plumbing, the
LAMB step with masters, the cross entropy and the throughput accounting
are the real thing:

    python -m apex_tpu_torch.examples.bert_pretrain_mlm [--large] \
        [--steps 20] [--batch-size 8] [--seq-len 512] [--opt-level O2] \
        [--packed] [--offload-state] [--device cpu]

The default batch is unmasked (random tokens and labels on every
position), so attention runs through ``flash_attention`` with gradients
(the hand-written forward and dq, dk/dv kernels on the card);
``--packed`` packs a varlen corpus into fixed rows with
:func:`apex_tpu_torch.data.pack_sequences` (segment-masked flash
attention, per-sequence positions, padding out of the loss).  Defaults
follow the reference: batch 8 x 512 on the card (2 x 64 on the CPU), a
4-layer h128 proxy unless ``--large``, lr 1e-3, weight decay 0.01.  The
step never syncs the host; the loss is echoed one step in five.  The
proxy's vocabulary, 2048, is on the fused cross entropy's gate (C % 128
== 0), as is any BERT vocabulary padded to a multiple of 128 (Megatron's
bert-large-uncased, ``bert_large(vocab_size=30592)`` through
:func:`setup`): on the card its losses and gradient come from the
``xent_fwd``/``xent_bwd`` kernels, the padding's label -1 included
(masked by ``padding_idx``).  BERT-Large's 30528 is off the gate.

At ``--opt-level O1`` the params stay f32 (LAMB keeps no masters), the
model computes in bf16 as at O2, and the loss runs under the op-list
rewrite: the flash attention, the fused norms and the cross entropy are
opaque to it and run at their traced dtypes, the MLM logits come back
bf16 and are restored to f32 at the cross entropy.

``--offload-state`` runs FusedLAMB with ``offload_state=True``: its
moments live in pinned host memory between steps, and each step copies
them to the card, runs the same LAMB kernels and copies them back.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._tree import tree_map
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.data import pack_sequences
from apex_tpu_torch.models import BertModel, bert_large
from apex_tpu_torch.optimizers import FusedLAMB


def model_for(large: bool, seq: int, opt_level: str) -> BertModel:
    """BERT-Large, or the reference's 4-layer h128 proxy, computing in
    bf16 unless O0."""
    half = torch.bfloat16 if opt_level != "O0" else torch.float32
    if large:
        return bert_large(dtype=half, max_seq_len=max(seq, 512))
    return BertModel(vocab_size=2048, hidden_size=128, num_heads=4,
                     num_layers=4, max_seq_len=max(seq, 128), dtype=half)


def setup(model: BertModel, params: Dict, device=None,
          opt_level: str = "O2", lr: float = 1e-3,
          weight_decay: float = 0.01, offload_state: bool = False, **lamb):
    """amp over ``params`` (f32, moved to ``device``) and a bucketed
    FusedLAMB over the result (``pretrain_mlm.py:111-115``); returns
    ``(opt, amp_state, step)``, ``step(amp_state, tokens, labels,
    attention_mask=None, segment_ids=None, positions=None) -> (loss,
    amp_state)`` the training step (``:80-89,132-137``)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    params, amp_state = amp.initialize(params, opt_level=opt_level,
                                       device=dev)
    opt = FusedLAMB(params, lr=lr, weight_decay=weight_decay,
                    master_weights=bool(amp_state.properties.master_weights),
                    masters=amp_state.master_params,
                    offload_state=offload_state, **lamb)
    del params
    vocab = model.vocab_size

    def loss_fn(p, tokens, labels, attention_mask=None, segment_ids=None,
                positions=None):
        logits = model.mlm_logits(p, tokens, attention_mask=attention_mask,
                                  segment_ids=segment_ids,
                                  positions=positions)        # (s, b, V)
        flat = logits.transpose(0, 1).reshape(-1, vocab)
        # padding labels (-1) drop out of the cross entropy
        losses = softmax_cross_entropy_loss(flat, labels.reshape(-1),
                                            smoothing=0.0, padding_idx=-1)
        n = torch.clamp((labels.reshape(-1) != -1).sum(), min=1)
        return losses.sum() / n

    wrapped = amp_state.wrap_forward(loss_fn, cast_argnums=())

    def step(state, tokens, labels, attention_mask=None, segment_ids=None,
             positions=None):
        loss, grads, found_inf = amp.scaled_value_and_grad(
            wrapped, state.scaler, opt.params, tokens, labels,
            attention_mask=attention_mask, segment_ids=segment_ids,
            positions=positions)
        # branch-free overflow skip: the flag stays on the device
        opt.step(grads, found_inf=found_inf)
        return loss, amp.update_scaler(state, found_inf)

    return opt, amp_state, step


def synthetic_batch(vocab: int, batch: int, seq: int, packed: bool = False,
                    device=None) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """ONE fixed batch (overfitting it makes the descent visible).
    Unpacked: tokens and labels in ``[0, vocab)`` on every position, from
    ``numpy.random.default_rng(1)`` and ``(2)``.  Packed (the
    reference's ``--packed``): ``2 * batch`` sequences of lengths in
    ``[seq/4, seq)`` from ``default_rng(1)``, packed into rows of
    ``seq`` and cut to ``batch`` rows, labels -1 on padding.  Returns
    ``(the step's keyword tensors on device, real tokens in the batch,
    sequences kept)``."""
    dev = resolve_device(device)
    if not packed:
        tokens = np.random.default_rng(1).integers(0, vocab, (batch, seq))
        labels = np.random.default_rng(2).integers(0, vocab, (batch, seq))
        return ({"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)},
                batch * seq, batch)
    rng = np.random.default_rng(1)
    lens = rng.integers(seq // 4, seq, size=2 * batch)
    pk = pack_sequences([rng.integers(1, vocab, size=n) for n in lens],
                        max_len=seq)
    tokens = pk["tokens"][:batch]
    segs = pk["segment_ids"][:batch]
    labels = rng.integers(0, vocab, size=tokens.shape)
    labels[segs == 0] = -1                  # padding out of the loss
    return ({"tokens": torch.from_numpy(tokens).long().to(dev),
             "labels": torch.from_numpy(labels).to(dev),
             "segment_ids": torch.from_numpy(segs).to(dev),
             "positions": torch.from_numpy(pk["positions"][:batch]).long()
             .to(dev)},
            int((segs > 0).sum()),
            sum(len(np.unique(r[r > 0])) for r in segs))


@dataclasses.dataclass
class TrainResult:
    losses: List[float]             # one per step, read after the run
    tokens_per_sec: Optional[float]  # real tokens, steps after the first
    step_seconds: float
    device: str
    opt: Any
    amp_state: Any


def train(large: bool = False, steps: int = 20, batch: int = 0,
          seq: int = 0, opt_level: str = "O2", lr: float = 1e-3,
          weight_decay: float = 0.01, packed: bool = False,
          offload_state: bool = False, device=None,
          log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """Train ``steps`` steps on one fixed batch from ``model.init(0)``;
    the body of :func:`main`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the MLM head and the masked attention are true f32 GEMMs
        torch.backends.cuda.matmul.allow_tf32 = False
    batch = batch or (8 if dev.type == "cuda" else 2)
    seq = seq or (512 if dev.type == "cuda" else 64)
    model = model_for(large, seq, opt_level)
    if log:
        log(f"apex_tpu_torch: bert ({'large' if large else 'proxy'}) amp "
            f"{opt_level} b{batch} s{seq} on {dev}")
    opt, state, step = setup(model, model.init(0, "cpu"), dev,
                             opt_level=opt_level, lr=lr,
                             weight_decay=weight_decay,
                             offload_state=offload_state)
    inputs, real, kept = synthetic_batch(model.vocab_size, batch, seq,
                                         packed, dev)
    if packed and log:
        log(f"packed: kept {kept} of {2 * batch} varlen seqs in "
            f"{batch} rows, {real / (batch * seq):.0%} tokens real")
    losses: List[torch.Tensor] = []
    t0 = None
    for i in range(steps):
        loss, state = step(state, **inputs)
        losses.append(loss)
        if i == 0:
            float(loss)                   # the first step warms up
            t0 = time.perf_counter()
        if i % 5 == 0 and log:
            # one step in five: a console echo, not a per-step sync
            log(f"step {i:3d} loss {float(loss):.4f} scale "
                f"{float(state.scaler.loss_scale):.0f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0 if t0 is not None else 0.0
    timed = steps - 1
    # packed rows hold padding: count real tokens only
    tps = real * timed / wall if timed > 0 and wall > 0 else None
    if tps is not None and log:
        log(f"step time {1e3 * wall / timed:.1f} ms  ({tps:.0f} tokens/sec)")
    return TrainResult(
        losses=[float(x) for x in torch.stack(losses).cpu()] if losses
        else [], tokens_per_sec=tps,
        step_seconds=wall / timed if timed > 0 else 0.0, device=str(dev),
        opt=opt, amp_state=state)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--large", action="store_true",
                   help="BERT-Large (default: a 4-layer proxy)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=0)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--packed", action="store_true",
                   help="pack a varlen synthetic corpus into fixed rows "
                        "(segment-masked attention, per-sequence "
                        "positions, padding excluded from the loss)")
    p.add_argument("--offload-state", action="store_true",
                   help="keep the LAMB moments in pinned host memory "
                        "between steps")
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    return train(large=args.large, steps=args.steps, batch=args.batch_size,
                 seq=args.seq_len, opt_level=args.opt_level, lr=args.lr,
                 weight_decay=args.weight_decay, packed=args.packed,
                 offload_state=args.offload_state, device=args.device)


if __name__ == "__main__":
    main()
