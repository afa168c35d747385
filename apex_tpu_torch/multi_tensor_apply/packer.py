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

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch._tree import (TreeDef, leaf_paths, tree_flatten,
                                  tree_leaves, tree_unflatten)

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
                 max_bucket_bytes: Optional[int] = None):
        self.treedef = treedef
        self.buckets = tuple(buckets)
        self.n_leaves = sum(len(b.leaves) for b in self.buckets)
        self.max_bucket_bytes = max_bucket_bytes

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
        return cls(treedef, buckets, max_bucket_bytes=max_bucket_bytes)

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
    # SGD's one state field (the momentum buffer) mirrors the params, so
    # it packs and unpacks like them; the reference's per-leaf scalar and
    # vector fields (NovoGrad, LAMB) come with those optimizers.
    def pack_state_field(self, field: Tree) -> List[torch.Tensor]:
        return self.pack(field)

    def unpack_state_field(self, bufs) -> Tree:
        return tree_unflatten(self.treedef, self._unpack_leaves(bufs))

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
