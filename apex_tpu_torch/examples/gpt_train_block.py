"""GPT block training on the card (port of examples/gpt/train_block.py,
BASELINE config 4: contrib.multihead_attn + FusedAdam).

A causal transformer stack built from ``SelfMultiheadAttn`` (the fused
MHA module, pre-LN norm-add variant, causal mask) and an MLP, a final
LayerNorm and an f32 head tied to the embedding, trained with amp and
``FusedAdam`` on one fixed synthetic next-token batch:

    python -m apex_tpu_torch.examples.gpt_train_block [--steps 20] \
        [--layers 12] [--hidden 768] [--heads 12] [--seq-len 512] \
        [--batch-size 8] [--lr 3e-4] [--opt-level O2] [--device cpu]

Widths default by device as the reference's do: GPT-2 small on the card
(12 layers, hidden 768, 12 heads, seq 512, batch 8, vocab 50257), a
2-layer h128 proxy on the CPU (4 heads, seq 64, batch 2, vocab 2048).
The model computes in bf16 (the reference's ``GPTBlocks.dtype``
default) at every opt level unless its ``dtype`` says otherwise; amp
O2 keeps f32 masters.  The head is ``x.f32 @ emb.T``, an f32 GEMM (TF32
off), as the reference's type promotion gives; the loss is
``log_softmax`` and a gather.  The gradients go through the flat
pipeline (the reference's ``grads_layout="flat"``): packed once, one
``flat_unscale_norm`` per bucket, then one ``flat_adam`` per bucket.
The step never syncs the host; the loss is echoed one step in five.

``--offload-activations`` rematerializes each block
(:func:`apex_tpu_torch.offload.offload_checkpoint`, the reference's
``nn.remat(Block, policy=offload_policy(("ffn_hidden",)))``): the MLP's
GELU output, tagged ``ffn_hidden``, is saved for ``fc2``'s backward in
pinned host memory and comes back for it; the rest of the block is
recomputed in the backward, up to the GELU (``fc2`` is not rerun).
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
from apex_tpu_torch._tree import tree_map
from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.offload import checkpoint_name, offload_checkpoint
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.tensor_parallel import (ColumnParallelLinear,
                                                        RowParallelLinear)

# the reference's widths by device (examples/gpt/train_block.py:109-115)
CARD = dict(layers=12, hidden=768, heads=12, seq=512, batch=8, vocab=50257)
CPU = dict(layers=2, hidden=128, heads=4, seq=64, batch=2, vocab=2048)


class Block:
    """Pre-LN fused self-attention (norm-add, causal), then an MLP."""

    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        self.hidden, self.dtype = hidden, dtype
        self.attn = SelfMultiheadAttn(hidden, heads, bias=True,
                                      include_norm_add=True)
        self.ln2 = FusedLayerNorm(hidden)
        self.fc1 = ColumnParallelLinear(hidden, 4 * hidden)
        self.fc2 = RowParallelLinear(4 * hidden, hidden)

    def init(self, generator: torch.Generator, device) -> Dict:
        return {"attn": self.attn.init(generator, device),
                "ln2": self.ln2.init(device),
                "fc1": self.fc1.init(generator, device),
                "fc2": self.fc2.init(generator, device)}

    def __call__(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        x, _ = self.attn(params["attn"], x, attn_mask="causal")
        h = self.ln2(params["ln2"], x).to(self.dtype)
        # offload tag: the identity unless the block runs under
        # offload_checkpoint (--offload-activations)
        h = checkpoint_name(F.gelu(self.fc1(params["fc1"], h),
                                   approximate="tanh"), "ffn_hidden")
        return x + self.fc2(params["fc2"], h)


class GPTBlocks:
    """Token + learned position embeddings, ``layers`` blocks, a final
    LayerNorm and the tied f32 head; ``offload_activations`` remats each
    block with its ``ffn_hidden`` in pinned host memory.  Parameters are
    a nested dict with the flax model's names (``embed`` (V, h), ``pos`` (max_seq, h),
    ``block<i>/{attn,ln2,fc1,fc2}``, ``lnf``), so the tree flattens in
    the reference's order (``convert.gpt_block_from_jax``)."""

    # the tags that offload_activations sends to the host
    OFFLOAD_NAMES = ("ffn_hidden",)

    def __init__(self, vocab: int, hidden: int, heads: int, layers: int,
                 max_seq: int, dtype: torch.dtype = torch.bfloat16,
                 offload_activations: bool = False):
        self.offload_activations = offload_activations
        self.vocab, self.hidden, self.heads = vocab, hidden, heads
        self.layers, self.max_seq, self.dtype = layers, max_seq, dtype
        self.block = Block(hidden, heads, dtype)
        self.lnf = FusedLayerNorm(hidden)

    def init(self, seed: int = 0, device=None) -> Dict:
        """f32 parameters on ``device`` (default: the card), drawn on the
        CPU from ``seed`` with flax's initializers."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = {
            "embed": (torch.randn(self.vocab, self.hidden, generator=gen)
                      * 0.02).to(dev),
            "pos": (torch.randn(self.max_seq, self.hidden, generator=gen)
                    * 0.02).to(dev)}
        for i in range(self.layers):
            params[f"block{i}"] = self.block.init(gen, dev)
        params["lnf"] = self.lnf.init(dev)
        return params

    def __call__(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (b, s) -> f32 logits (s, b, V)."""
        s = tokens.shape[1]
        emb = params["embed"]
        x = F.embedding(tokens, emb) + params["pos"][:s][None]
        x = x.transpose(0, 1).to(self.dtype)                   # (s, b, h)
        block = self.block
        if self.offload_activations:
            block = offload_checkpoint(self.block,
                                       offload_names=self.OFFLOAD_NAMES)
        for i in range(self.layers):
            x = block(params[f"block{i}"], x)
        x = self.lnf(params["lnf"], x)
        return torch.matmul(x.float(), emb.float().t())


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Mean negative log-likelihood of each next token (the last position
    has none): logits (s, b, V) f32, tokens (b, s)."""
    labels = torch.roll(tokens, -1, dims=1).t().long()     # (s, b)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])
    return -ll[:-1].mean()


def synthetic_tokens(batch: int, seq: int, vocab: int, seed: int = 1,
                     device=None) -> torch.Tensor:
    """ONE fixed batch of token ids in ``[0, vocab)`` from
    ``numpy.random.default_rng(seed)`` (overfitting it makes the descent
    visible)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(
        resolve_device(device))


@dataclasses.dataclass
class Setup:
    model: GPTBlocks
    opt: FusedAdam
    amp_state: Any
    step: Callable          # step(amp_state, *batch) -> (loss, amp_state)


def setup(model, params: Dict, device=None, opt_level: str = "O2",
          lr: float = 3e-4, loss_fn: Optional[Callable] = None,
          **adam) -> Setup:
    """amp over ``params`` (f32, moved to ``device``), a bucketed
    ``FusedAdam`` over the result and the flat gradient pipeline; the
    step of ``examples/gpt/train_block.py:121-143``.  ``loss_fn(params,
    *batch)`` is the objective (default: :func:`next_token_loss` of
    ``model(params, tokens)``, batch ``(tokens,)``); the step is
    ``step(amp_state, *batch)``, so ``models.GPTModel.loss`` trains with
    the same step."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    params, amp_state = amp.initialize(params, opt_level=opt_level,
                                       device=dev)
    opt = FusedAdam(params, lr=lr, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **adam)
    del params
    pipe = amp_state.flat_pipeline(optimizer=opt)

    if loss_fn is None:
        def loss_fn(p, tokens):
            return next_token_loss(model(p, tokens), tokens)

    wrapped = amp_state.wrap_forward(loss_fn, cast_argnums=())

    def step(state, *batch):
        loss, flat = pipe.scaled_value_and_grad(wrapped, state.scaler,
                                                opt.params, *batch)
        # branch-free overflow skip: the flag stays on the device
        opt.step(flat)
        return loss, amp.update_scaler(state, flat.found_inf)

    return Setup(model=model, opt=opt, amp_state=amp_state, step=step)


@dataclasses.dataclass
class TrainResult:
    losses: List[float]             # one per step, read after the run
    tokens_per_sec: Optional[float]  # over the steps after the first
    step_seconds: float             # host wall per timed step
    widths: Dict[str, int]
    device: str
    setup: Setup


def train(layers: int = 0, hidden: int = 0, heads: int = 0, seq: int = 0,
          batch: int = 0, steps: int = 20, lr: float = 3e-4,
          opt_level: str = "O2", device=None,
          offload_activations: bool = False,
          log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """Train ``steps`` steps on one fixed batch from ``model.init(0)``;
    the body of :func:`main`.  A width of 0 takes the device's default
    (:data:`CARD` or :data:`CPU`, vocabulary included)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the head and any f32 layer are true f32 GEMMs: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    base = CARD if dev.type == "cuda" else CPU
    w = dict(base, **{k: v for k, v in dict(
        layers=layers, hidden=hidden, heads=heads, seq=seq,
        batch=batch).items() if v})
    model = GPTBlocks(w["vocab"], w["hidden"], w["heads"], w["layers"],
                      max_seq=max(w["seq"], 128),
                      offload_activations=offload_activations)
    if log:
        log(f"apex_tpu_torch: gpt-block L{w['layers']} h{w['hidden']} "
            f"b{w['batch']} s{w['seq']} amp {opt_level} on {dev}")
    s = setup(model, model.init(0, "cpu"), dev, opt_level=opt_level, lr=lr)
    tokens = synthetic_tokens(w["batch"], w["seq"], w["vocab"], device=dev)
    state = s.amp_state
    losses: List[torch.Tensor] = []
    t0 = None
    for i in range(steps):
        loss, state = s.step(state, tokens)
        losses.append(loss)
        if i == 0:
            float(loss)                   # the first step warms up
            t0 = time.perf_counter()
        if i % 5 == 0 and log:
            # one step in five: a console echo, not a per-step sync
            log(f"step {i:3d} loss {float(loss):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    s.amp_state = state
    wall = time.perf_counter() - t0 if t0 is not None else 0.0
    timed = steps - 1
    tps = (w["batch"] * w["seq"] * timed / wall
           if timed > 0 and wall > 0 else None)
    if tps is not None and log:
        log(f"step time {1e3 * wall / timed:.1f} ms  ({tps:.0f} tokens/sec)")
    return TrainResult(
        losses=[float(x) for x in torch.stack(losses).cpu()] if losses
        else [], tokens_per_sec=tps,
        step_seconds=wall / timed if timed > 0 else 0.0, widths=w,
        device=str(dev), setup=s)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--hidden", type=int, default=0)
    p.add_argument("--heads", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--offload-activations", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    return train(layers=args.layers, hidden=args.hidden, heads=args.heads,
                 seq=args.seq_len, batch=args.batch_size, steps=args.steps,
                 lr=args.lr, opt_level=args.opt_level, device=args.device,
                 offload_activations=args.offload_activations)


if __name__ == "__main__":
    main()
