"""One-time bucket packing for the fused optimizers and the flat pipeline.

The port of ``apex_tpu.multi_tensor_apply.packer``.  A plan is computed
once from a tree of tensors: leaves are grouped by (work dtype, model
dtype), each group packs into one flat bucket (or several, under
``max_bucket_bytes``), and every leaf keeps a static offset.  Leaf
order is the tree's flatten order (:mod:`apex_tpu_torch._tree`, which
is JAX's: sorted dict keys), so :meth:`BucketPlan.layout` equals the
reference plan's field for field for the same tree.

On the card the packed buffers are the persistent representation: the
optimizer keeps params, masters and state packed, and the params the
model computes with are views into the model bucket
(:meth:`BucketPlan.unpack` returns views), so the step never repacks
them.  Gradients are packed once per backward (:meth:`pack_grads`, one
``torch.cat`` per bucket).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch._tree import (TreeDef, leaf_paths, tree_flatten,
                                  tree_leaves, tree_unflatten)
from apex_tpu_torch.ops.multi_tensor import segment_offsets

Tree = Any

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch float dtype (``float32``, ``bfloat16``)."""
    return _DTYPE_NAMES[dtype]


class LeafSpec(NamedTuple):
    index: int            # position in flatten order
    shape: Tuple[int, ...]
    size: int             # element count
    offset: int           # element offset inside the bucket buffer


class Bucket(NamedTuple):
    dtype: torch.dtype        # work (stepped) dtype of every leaf in here
    model_dtype: torch.dtype  # model-param dtype (== dtype without masters)
    leaves: Tuple[LeafSpec, ...]
    size: int                 # total element count (exact, unpadded)


class BucketPlan:
    """Static packing plan for one params tree.

    Built from the WORK tree (masters under mixed precision, else the
    params) plus, when masters exist, the model params tree: buckets
    are keyed on (work dtype, model dtype), so the master -> model
    writeback is one cast-copy per bucket."""

    def __init__(self, treedef: TreeDef, buckets: Sequence[Bucket],
                 max_bucket_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.treedef = treedef
        self.buckets = tuple(buckets)
        self.n_leaves = sum(len(b.leaves) for b in self.buckets)
        self.max_bucket_bytes = max_bucket_bytes
        self.device = torch.device("cpu") if device is None else device
        self._seg_ids: Dict[int, torch.Tensor] = {}
        self._seg_offsets: Dict[int, torch.Tensor] = {}

    @classmethod
    def from_tree(cls, work: Tree, model: Optional[Tree] = None,
                  max_bucket_bytes: Optional[int] = None
                  ) -> Optional["BucketPlan"]:
        """A plan, or None for an empty tree or a non-float leaf.

        ``max_bucket_bytes``: optional cap; a dtype group then splits into
        buckets of at most that many bytes at leaf boundaries (a leaf is
        never split, every bucket holds at least one)."""
        work_leaves, treedef = tree_flatten(work)
        if not work_leaves:
            return None
        model_leaves = (tree_leaves(model) if model is not None
                        else work_leaves)
        if len(model_leaves) != len(work_leaves):
            return None
        groups = {}
        for i, (w, p) in enumerate(zip(work_leaves, model_leaves)):
            if not isinstance(w, torch.Tensor) \
                    or not torch.is_floating_point(w):
                return None
            groups.setdefault((w.dtype, p.dtype), []).append((i, w))
        buckets = []
        for (wdt, mdt), entries in groups.items():
            cap = None
            if max_bucket_bytes is not None:
                itemsize = torch.empty((), dtype=wdt).element_size()
                cap = max(1, int(max_bucket_bytes) // itemsize)
            specs, offset = [], 0
            for i, w in entries:
                size = w.numel()
                if cap is not None and specs and offset + size > cap:
                    buckets.append(Bucket(wdt, mdt, tuple(specs), offset))
                    specs, offset = [], 0
                specs.append(LeafSpec(i, tuple(w.shape), size, offset))
                offset += size
            buckets.append(Bucket(wdt, mdt, tuple(specs), offset))
        return cls(treedef, buckets, max_bucket_bytes=max_bucket_bytes,
                   device=work_leaves[0].device)

    # ---- packing ---------------------------------------------------------
    def pack(self, tree: Tree, dtypes=None) -> List[torch.Tensor]:
        """Tree -> one new flat buffer per bucket (one ``torch.cat`` per
        bucket).  ``dtypes``: per-bucket target dtype (default: the
        leaves' own)."""
        leaves = tree_leaves(tree)
        if len(leaves) != self.n_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, the plan "
                             f"{self.n_leaves}")
        out = []
        for bi, b in enumerate(self.buckets):
            parts = [leaves[s.index].reshape(-1) for s in b.leaves]
            buf = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
            want = dtypes[bi] if dtypes is not None else None
            if want is not None and buf.dtype != want:
                buf = buf.to(want)
            out.append(buf)
        return out

    def pack_work(self, tree: Tree) -> List[torch.Tensor]:
        return self.pack(tree, dtypes=[b.dtype for b in self.buckets])

    def pack_model(self, tree: Tree) -> List[torch.Tensor]:
        return self.pack(tree, dtypes=[b.model_dtype for b in self.buckets])

    def pack_grads(self, tree: Tree) -> List[torch.Tensor]:
        """THE gradient pack: one concatenate per bucket, grads keep
        their own (model) dtype."""
        return self.pack(tree)

    def is_packed(self, obj) -> bool:
        """True iff ``obj`` is one 1-D bucket-sized buffer per bucket."""
        if not isinstance(obj, (list, tuple)) \
                or len(obj) != len(self.buckets):
            return False
        return all(isinstance(buf, torch.Tensor) and buf.dim() == 1
                   and buf.numel() == b.size
                   for buf, b in zip(obj, self.buckets))

    # ---- unpacking (views) -----------------------------------------------
    def _unpack_leaves(self, bufs, dtypes=None) -> List[torch.Tensor]:
        leaves: List[Optional[torch.Tensor]] = [None] * self.n_leaves
        for bi, b in enumerate(self.buckets):
            buf = bufs[bi]
            want = dtypes[bi] if dtypes is not None else None
            for s in b.leaves:
                leaf = buf.narrow(0, s.offset, s.size).view(s.shape)
                if want is not None and leaf.dtype != want:
                    leaf = leaf.to(want)
                leaves[s.index] = leaf
        return leaves

    def unpack(self, bufs) -> Tree:
        """Buffers -> tree in the WORK dtypes (views where no cast)."""
        return tree_unflatten(self.treedef, self._unpack_leaves(
            bufs, [b.dtype for b in self.buckets]))

    def unpack_grads(self, bufs) -> Tree:
        """Buffers -> tree, each leaf a view keeping its buffer's dtype."""
        return tree_unflatten(self.treedef, self._unpack_leaves(bufs))

    def unpack_model(self, bufs) -> Tree:
        """Buffers -> tree in the MODEL dtypes (views where no cast)."""
        return tree_unflatten(self.treedef, self._unpack_leaves(
            bufs, [b.model_dtype for b in self.buckets]))

    # ---- optimizer-state packing ----------------------------------------
    # A state field whose leaves mirror the params (momentum, exp_avg,
    # exp_avg_sq, Adagrad's sum) packs and unpacks like them; a field
    # whose leaves are all 0-d (NovoGrad's per-tensor second moment) packs
    # into one f32 (num leaves,) vector per bucket, indexed by the
    # bucket-local leaf ordinal.  The reference's per-leaf (H,) vector
    # layout (the fp8 amax history) comes with the fp8 slots (ROADMAP
    # T4).
    def pack_state_field(self, field: Tree) -> List[torch.Tensor]:
        leaves = tree_leaves(field)
        if len(leaves) != self.n_leaves:
            raise ValueError("state field does not mirror the plan's tree")
        if all(l.dim() == 0 for l in leaves):
            return [torch.stack([leaves[s.index].to(torch.float32)
                                 for s in b.leaves]) for b in self.buckets]
        return self.pack(field)

    def unpack_state_field(self, bufs) -> Tree:
        """Buffers -> per-leaf tree in the buffers' dtypes (views): 0-d
        leaves from a per-leaf-scalar field (every buffer exactly (num
        leaves,) where the flat layout would not be), else leaves at the
        params' shapes.  Where the two layouts coincide (every param a
        scalar) they agree element for element."""
        scalar = all(tuple(bufs[bi].shape) == (len(b.leaves),)
                     for bi, b in enumerate(self.buckets))
        flat = all(bufs[bi].numel() == b.size
                   for bi, b in enumerate(self.buckets))
        if scalar and not flat:
            leaves: List[Optional[torch.Tensor]] = [None] * self.n_leaves
            for bi, b in enumerate(self.buckets):
                for j, s in enumerate(b.leaves):
                    leaves[s.index] = bufs[bi][j]
            return tree_unflatten(self.treedef, leaves)
        return tree_unflatten(self.treedef, self._unpack_leaves(bufs))

    # ---- segment metadata ------------------------------------------------
    def segment_ids(self, bucket_index: int) -> torch.Tensor:
        """Sorted i32 element -> bucket-local leaf map of one bucket, on
        the plan's device (built once, then cached): the per-tensor
        index the segmented LAMB step reads."""
        ids = self._seg_ids.get(bucket_index)
        if ids is None:
            b = self.buckets[bucket_index]
            dev = self.device
            ids = torch.repeat_interleave(
                torch.arange(len(b.leaves), dtype=torch.int32, device=dev),
                torch.tensor([s.size for s in b.leaves], device=dev),
                output_size=b.size)
            self._seg_ids[bucket_index] = ids
        return ids

    def segment_offsets(self, bucket_index: int) -> torch.Tensor:
        """The i64 ``(num leaves + 1,)`` table of one bucket's leaf starts
        and its end, on the plan's device (built once, then cached): the
        segment table the NovoGrad kernel walks."""
        offs = self._seg_offsets.get(bucket_index)
        if offs is None:
            offs = segment_offsets(self.segment_sizes(bucket_index),
                                   self.device)
            self._seg_offsets[bucket_index] = offs
        return offs

    def num_segments(self, bucket_index: int) -> int:
        return len(self.buckets[bucket_index].leaves)

    def segment_sizes(self, bucket_index: int) -> Tuple[int, ...]:
        """The run lengths of :meth:`segment_ids` (the leaves' sizes in
        bucket order), as host ints."""
        return tuple(s.size for s in self.buckets[bucket_index].leaves)

    # ---- description -------------------------------------------------------
    def describe(self) -> List[dict]:
        return [{"dtype": dtype_name(b.dtype),
                 "model_dtype": dtype_name(b.model_dtype),
                 "leaves": len(b.leaves), "elements": b.size}
                for b in self.buckets]

    # ---- layout ------------------------------------------------------------
    def leaf_paths(self) -> List[str]:
        return leaf_paths(self.treedef)

    def layout(self) -> dict:
        """JSON-able static layout (the checkpoint v2 header's ``plan``
        record): leaf paths plus every bucket's dtypes, size and per-leaf
        shape/offset table — the reference's document, field for field."""
        return {
            "paths": self.leaf_paths(),
            "buckets": [
                {"dtype": dtype_name(b.dtype),
                 "model_dtype": dtype_name(b.model_dtype),
                 "size": b.size,
                 "leaves": [{"index": s.index, "shape": list(s.shape),
                             "offset": s.offset} for s in b.leaves]}
                for b in self.buckets],
        }


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64


def cached_plan(tree: Tree, model: Optional[Tree] = None,
                max_bucket_bytes: Optional[int] = None
                ) -> Optional[BucketPlan]:
    """Memoized :meth:`BucketPlan.from_tree`, keyed on the structure,
    leaf shapes and dtypes, the model dtypes and the cap."""
    leaves, treedef = tree_flatten(tree)
    if not all(isinstance(l, torch.Tensor) for l in leaves):
        return None
    sig = tuple((tuple(l.shape), l.dtype) for l in leaves)
    if model is not None:
        sig += tuple(l.dtype for l in tree_leaves(model))
    key = (treedef, sig, max_bucket_bytes)
    if key not in _PLAN_CACHE:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = BucketPlan.from_tree(
            tree, model, max_bucket_bytes=max_bucket_bytes)
    return _PLAN_CACHE[key]
