"""Checkpoint and resume (port of ``apex_tpu.checkpoint``: the reference's
``{'model', 'optimizer', 'amp'}`` bundle of its ImageNet example, SURVEY.md
§5).

One file holds a whole training state: 8 bytes of header length (little
endian), a JSON header, then one contiguous payload.  The files are the
JAX package's, byte for byte in layout, so either side loads what the
other wrote:

- **v1** (``APEX_TPU_CKPT_V1``): per leaf.  The tree flattens in JAX's
  leaf order (:mod:`apex_tpu_torch._tree`), the payload is every leaf's
  bytes in that order, written and read leaf by leaf, and the header
  holds each leaf's shape and numpy dtype name, a crc32 of the
  payload and the f32 L2 norm of the f16/f32/f64 leaves (checked at rtol
  1e-6; bf16 leaves are left out of it, as the reference's numpy leaves
  them out, and the crc covers them).
- **v2** (``APEX_TPU_CKPT_V2``, bucket-native): a bucketed optimizer's
  packed buffers as they are (:meth:`FusedOptimizerBase.packed_snapshot`:
  one copy and one device-to-host transfer per buffer, no per-leaf
  unpack), with the plan's ``layout()`` in the header.  A restore onto an
  optimizer whose plan has the same layout adopts the buffers (one
  host-to-device copy per buffer); any other restore slices them back
  into leaves on the host.

Dtypes travel as raw bytes under numpy's names (``"bfloat16"``,
``"float32"``, ``"int32"``): a tensor is written as its ``uint8`` view and
read back with ``view(dtype)``, so bf16 needs no numpy dtype.  Restored
tensors land on ``device=`` when it is given, else where the template's
leaf lives (a restore into an optimizer: on the optimizer's device).

Every filesystem write goes through the :class:`CheckpointIO` seam, and a
file is published atomically: written to ``<path>.tmp``, fsynced, renamed
over ``path`` and the directory fsynced.  :class:`AsyncCheckpointer`
writes on a worker thread; its copies are taken on the caller's stream
before the call returns, so a later in-place step cannot tear them.
"""

from __future__ import annotations

import copy
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch import _native
from apex_tpu_torch._tree import (TreeDef, leaf_paths, tree_flatten,
                                  tree_unflatten)
from apex_tpu_torch.multi_tensor_apply.packer import (_DTYPE_NAMES,
                                                      dtype_name)

Tree = Any

_MAGIC = "APEX_TPU_CKPT_V1"
_MAGIC_V2 = "APEX_TPU_CKPT_V2"

_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}      # name -> dtype


# ---------------------------------------------------------------------------
# IO seam
# ---------------------------------------------------------------------------
class CheckpointIO:
    """The filesystem operations a checkpoint write performs, as an
    object a test (or a fault injector) can replace.  Reads are not
    hooked: corruption is made by writes that leave bad bytes."""

    def open(self, path: str, mode: str = "wb"):
        return open(path, mode)

    def write_array(self, f, arr: np.ndarray) -> None:
        arr.tofile(f)             # streams; tobytes() would copy first

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())      # durable before the atomic publish

    def replace(self, tmp: str, path: str) -> None:
        os.replace(tmp, path)

    def fsync_dir(self, path: str) -> None:
        try:                      # persist the rename itself
            dfd = os.open(os.path.dirname(os.path.abspath(path)),
                          os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass                  # some filesystems refuse; best effort


_io = CheckpointIO()


def get_io() -> CheckpointIO:
    return _io


def set_io(io: Optional[CheckpointIO]) -> CheckpointIO:
    """Install an IO implementation (None restores the direct one);
    returns the previous one."""
    global _io
    prev = _io
    _io = io if io is not None else CheckpointIO()
    return prev


_side_streams: Dict[int, Any] = {}


def _d2h(buf: torch.Tensor) -> torch.Tensor:
    """ONE contiguous device-to-host transfer of one buffer, into pinned
    memory, on a side stream the call waits for (a host tensor comes back
    as it is).  The caller has made sure the buffer's pending writes are
    done.  Every transfer of a checkpoint write goes through this seam,
    so tests can count them."""
    if buf.device.type != "cuda":
        return buf.detach().contiguous()
    out = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    idx = buf.device.index if buf.device.index is not None \
        else torch.cuda.current_device()
    stream = _side_streams.get(idx)
    if stream is None:
        stream = _side_streams[idx] = torch.cuda.Stream(buf.device)
    with torch.cuda.stream(stream):
        out.copy_(buf, non_blocking=True)
    stream.synchronize()
    return out


def _ready_event(tensors) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream when any of ``tensors``
    lives on the card (None otherwise): what a writer waits on before it
    reads them."""
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in tensors):
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return None


class TemplateMismatchError(ValueError):
    """The checkpoint is intact but does not fit the caller's template
    (another tree, shape or dtype): a caller's fault, not a corrupt file.
    Recovery (``resilience.CheckpointManager.restore_latest``) raises it
    instead of skipping to an older file."""


def _resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} is not known") from None


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_resolve_dtype(name)).element_size()


def _as_tensor(x) -> torch.Tensor:
    """A leaf as a tensor: python and numpy scalars take numpy's dtype
    (``3`` is int64, ``0.5`` float64), as the reference's
    ``np.asarray`` gives them."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))


def _leaf_sig(x) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype name) of a template leaf (a tensor, or a numpy array
    or python scalar) without touching a tensor's data."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), dtype_name(x.dtype)
    a = np.asarray(x)
    return tuple(a.shape), a.dtype.name


def _u8(t: torch.Tensor) -> np.ndarray:
    """The bytes of a host tensor as a numpy u8 view (no copy)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _place(t: torch.Tensor, like, device) -> torch.Tensor:
    dev = device if device is not None else (
        like.device if isinstance(like, torch.Tensor) else None)
    return t.to(dev) if dev is not None and torch.device(dev) != t.device \
        else t


def _treedef_str(td: TreeDef) -> str:
    """``str()`` of the JAX ``PyTreeDef`` of the same tree: recorded in
    the v1 header, as the reference writes it (neither side reads it)."""
    def walk(d):
        if d.kind == "leaf":
            return "*"
        if d.kind == "none":
            return "None"
        if d.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {walk(c)}" for k, c in
                                   zip(d.keys, d.children)) + "}"
        inner = ", ".join(walk(c) for c in d.children)
        if d.kind == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(d.children) == 1 else f"({inner})"
    return f"PyTreeDef({walk(td)})"


# the leaves the checksum reads: numpy's floating dtypes.  bfloat16 is
# not one (the reference's ml_dtypes type is not a numpy floating subtype,
# so its checksum leaves bf16 out), and the crc covers it
_CHECKSUMMED = (torch.float16, torch.float32, torch.float64)


def _checksum(host: Sequence[torch.Tensor]) -> float:
    """The f32 L2 norm over the f16/f32/f64 leaves, squares summed in f64
    leaf by leaf."""
    sq = 0.0
    for t in host:
        if t.dtype in _CHECKSUMMED:
            sq += _native.host_l2norm(
                t.to(torch.float32).reshape(-1).numpy()) ** 2
    return sq ** 0.5


def _crc32(bufs: Sequence[np.ndarray]) -> int:
    """The crc32 of the buffers' bytes one after another."""
    crc = 0
    for b in bufs:
        crc = zlib.crc32(b, crc)
    return int(crc)


def _read_payload(path: str, specs: Sequence[Tuple[torch.dtype, int]]
                  ) -> Tuple[List[torch.Tensor], int]:
    """The payload after the header, read straight into one flat host
    tensor per ``(dtype, elements)`` of ``specs``; returns them and the
    payload's crc32.  The file's payload size is checked against
    ``specs`` before any payload byte is read."""
    want = sum(n * torch.empty((), dtype=dt).element_size()
               for dt, n in specs)
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        start = 8 + hlen
        have = os.fstat(f.fileno()).st_size - start
        if have != want:
            raise ValueError(
                f"checkpoint payload is {have} bytes, header declares "
                f"{want} (truncated or corrupt file?)")
        f.seek(start)
        out: List[torch.Tensor] = []
        crc = 0
        for dt, n in specs:
            arr = torch.empty(n, dtype=dt)
            view = _u8(arr)
            if f.readinto(memoryview(view)) != view.nbytes:
                raise ValueError(f"{path}: payload ends early")
            crc = zlib.crc32(view, crc)
            out.append(arr)
    return out, int(crc)


def _publish(path: str, header: Dict, payload_bufs: Sequence[np.ndarray]
             ) -> int:
    """Write header and payload to ``path + ".tmp"``, fsync, and publish
    atomically, every filesystem touch through the IO seam.  Returns the
    bytes written."""
    hbytes = json.dumps(header).encode()
    tmp = path + ".tmp"
    io = _io
    f = io.open(tmp, "wb")
    try:
        f.write(len(hbytes).to_bytes(8, "little"))
        f.write(hbytes)
        for buf in payload_bufs:
            io.write_array(f, buf)
        io.fsync(f)
    finally:
        f.close()
    io.replace(tmp, path)
    io.fsync_dir(path)
    return 8 + len(hbytes) + sum(int(b.nbytes) for b in payload_bufs)


# ---------------------------------------------------------------------------
# v1: per leaf
# ---------------------------------------------------------------------------
def _save_checkpoint(path: str, tree: Tree, metadata: Optional[Dict],
                     ready=None) -> int:
    if ready is not None:
        ready.synchronize()
    leaves, treedef = tree_flatten(tree)
    host = [_d2h(_as_tensor(l)) for l in leaves]
    payload = [_u8(h) for h in host]
    header = {
        "magic": _MAGIC,
        "treedef": _treedef_str(treedef),
        "shapes": [list(h.shape) for h in host],
        "dtypes": [dtype_name(h.dtype) for h in host],
        "checksum": _checksum(host),
        # integer leaves are invisible to the float checksum
        "payload_crc32": _crc32(payload),
        "metadata": metadata or {},
    }
    return _publish(path, header, payload)


def save_checkpoint(path: str, tree: Tree,
                    metadata: Optional[Dict] = None) -> int:
    """Write a tree of tensors (and JSON-able metadata) to one v1 file;
    returns the bytes written."""
    return _save_checkpoint(path, tree, metadata,
                            _ready_event(tree_flatten(tree)[0]))


def load_checkpoint(path: str, like: Tree, device=None,
                    header: Optional[Dict] = None) -> tuple:
    """Read a v1 file back into the structure of ``like``; returns
    ``(tree, metadata)``.  ``header``: the file's parsed header (from
    :func:`read_checkpoint_header`), which is then not read again."""
    if header is None:
        header = read_checkpoint_header(path)
    if header.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not an apex_tpu checkpoint")
    leaves, treedef = tree_flatten(like)
    if len(leaves) != len(header["shapes"]):
        raise TemplateMismatchError(
            f"checkpoint has {len(header['shapes'])} leaves, template "
            f"has {len(leaves)}")
    for i, (leaf, s, d) in enumerate(zip(leaves, header["shapes"],
                                         header["dtypes"])):
        shape, dname = _leaf_sig(leaf)
        if shape != tuple(s) or dname != d:
            raise TemplateMismatchError(
                f"checkpoint does not match template at leaf {i}: saved "
                f"{tuple(s)}/{d}, template {shape}/{dname}")
    # a truncated or oversized payload fails before any copy
    flat, crc = _read_payload(path, [
        (_resolve_dtype(d), int(np.prod(s, dtype=np.int64)))
        for s, d in zip(header["shapes"], header["dtypes"])])
    if "payload_crc32" in header and crc != header["payload_crc32"]:
        raise ValueError(
            f"checkpoint payload crc mismatch: {crc} != "
            f"{header['payload_crc32']} (corrupt file?)")
    host = [t.reshape(tuple(s)) for t, s in zip(flat, header["shapes"])]
    checksum = _checksum(host)
    if not np.isclose(checksum, header["checksum"], rtol=1e-6):
        raise ValueError(f"checkpoint checksum mismatch: {checksum} != "
                         f"{header['checksum']} (corrupt file?)")
    return tree_unflatten(treedef, [_place(h, l, device)
                                    for h, l in zip(host, leaves)]), \
        header["metadata"]


def read_checkpoint_header(path: str) -> Dict:
    """The JSON header of either format (no payload read).  Raises
    ``ValueError`` on anything that is not a checkpoint, torn files
    included."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(
                f"{path} is not an apex_tpu checkpoint (truncated)")
        hlen = int.from_bytes(head, "little")
        if not 0 < hlen < (1 << 31):
            raise ValueError(f"{path} is not an apex_tpu checkpoint")
        raw = f.read(hlen)
    if len(raw) < hlen:
        raise ValueError(f"{path}: truncated checkpoint header")
    try:
        header = json.loads(raw.decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"{path}: unreadable checkpoint header: {e}")
    if not isinstance(header, dict):
        raise ValueError(f"{path} is not an apex_tpu checkpoint")
    return header


# ---------------------------------------------------------------------------
# v2: bucket-native
# ---------------------------------------------------------------------------
def _v2_metadata(snap: Dict, amp_state, step: int) -> Dict:
    return {"step": step, "opt_step": snap["step"],
            "opt_hypers": {k: v for k, v in snap["hypers"].items()
                           if isinstance(v, (int, float, bool, str))},
            "amp": amp_state}


def _packed_sections(snap: Dict, extra: Optional[Tree]
                     ) -> Tuple[List[Dict], List[torch.Tensor]]:
    """Section docs and the buffers behind them, in payload order:
    params, masters, each state field (sorted), then ``extra`` (e.g.
    BatchNorm statistics) leaf by leaf."""
    docs: List[Dict] = []
    bufs: List[torch.Tensor] = []

    def add(name, blist):
        docs.append({"name": name,
                     "dtypes": [dtype_name(b.dtype) for b in blist],
                     "elements": [int(b.numel()) for b in blist]})
        bufs.extend(blist)

    add("params", snap["param_bufs"])
    if snap["master_bufs"] is not None:
        add("masters", snap["master_bufs"])
    for k in sorted(snap["state"]):
        add("state:" + k, snap["state"][k])
    if extra is not None:
        leaves, treedef = tree_flatten(extra)
        # python scalars take numpy's dtype now, so the header matches
        # the bytes written
        arrs = [_as_tensor(l) for l in leaves]
        docs.append({"name": "extra", "paths": leaf_paths(treedef),
                     "shapes": [list(a.shape) for a in arrs],
                     "dtypes": [dtype_name(a.dtype) for a in arrs]})
        bufs.extend(arrs)
    return docs, bufs


def _write_checkpoint_v2(path: str, plan_doc: Dict, metadata: Dict,
                         section_docs: List[Dict],
                         dev_bufs: List[torch.Tensor], ready=None) -> int:
    """The v2 writer: waits for ``ready``, then one :func:`_d2h` per
    buffer (a bucketed optimizer: one per bucket and field, never per
    leaf) and one sequential publish.  Returns the bytes written."""
    if ready is not None:
        ready.synchronize()
    host = [_u8(_d2h(b)) for b in dev_bufs]
    header = {
        "magic": _MAGIC_V2,
        "plan": plan_doc,
        "sections": section_docs,
        "metadata": metadata,
        "payload_bytes": int(sum(h.nbytes for h in host)),
        "payload_crc32": _crc32(host),
    }
    return _publish(path, header, host)


def _packed_v2_args(optimizer, amp_state, step: int,
                    extra: Optional[Tree]):
    """The v2 writer's inputs from a bucketed optimizer: one front half
    for the sync and async saves, so their files cannot drift apart."""
    snap = optimizer.packed_snapshot()
    docs, bufs = _packed_sections(snap, extra)
    return (snap["plan"].layout(), _v2_metadata(snap, amp_state, step),
            docs, bufs)


def save_training_state_packed(path: str, optimizer, amp_state=None,
                               step: int = 0,
                               extra: Optional[Tree] = None) -> int:
    """Bucket-native (v2) save of a bucketed optimizer: one copy and one
    transfer per packed buffer.  Returns the bytes written."""
    plan_doc, meta, docs, bufs = _packed_v2_args(optimizer, amp_state,
                                                 step, extra)
    return _write_checkpoint_v2(path, plan_doc, meta, docs, bufs,
                                _ready_event(bufs))


def _read_v2(path: str, header: Optional[Dict] = None
             ) -> Tuple[Dict, Dict[str, List[torch.Tensor]]]:
    """Read and check a v2 file; returns ``(header, {section name: host
    tensors})``, flat per bucket (per leaf for ``extra``).  The sizes are
    checked before any payload byte is read; the crc as it is read."""
    if header is None:
        header = read_checkpoint_header(path)
    if header.get("magic") != _MAGIC_V2:
        raise ValueError(f"{path} is not a v2 apex_tpu checkpoint")
    plan = []
    total = 0
    for doc in header["sections"]:
        if doc["name"] == "extra":
            counts = [int(np.prod(s, dtype=np.int64)) if s else 1
                      for s in doc["shapes"]]
        else:
            counts = [int(n) for n in doc["elements"]]
        for d, n in zip(doc["dtypes"], counts):
            plan.append((doc["name"], _resolve_dtype(d), n))
            total += n * _itemsize(d)
    if total != header["payload_bytes"]:
        raise ValueError(
            "checkpoint sections do not add up to the payload "
            f"({total} against {header['payload_bytes']} bytes; corrupt "
            "header?)")
    flat, crc = _read_payload(path, [(dt, n) for _, dt, n in plan])
    sections: Dict[str, List[torch.Tensor]] = {
        doc["name"]: [] for doc in header["sections"]}
    for (name, _, _), arr in zip(plan, flat):
        sections[name].append(arr)
    if crc != header["payload_crc32"]:
        raise ValueError(f"checkpoint payload crc mismatch: {crc} != "
                         f"{header['payload_crc32']} (corrupt file?)")
    return header, sections


def _v2_leaves(plan_doc: Dict, bufs: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Per-bucket flat buffers sliced into per-leaf host tensors (leaf
    order) by the header's offsets: the per-leaf restore.  A state field
    of per-leaf scalars (one element per leaf in every bucket, where the
    flat layout would not fit) gives 0-d leaves, as
    ``BucketPlan.unpack_state_field`` does."""
    bdocs = plan_doc["buckets"]
    leaves: List[Optional[torch.Tensor]] = [None] * len(plan_doc["paths"])
    scalar = all(b.numel() == len(d["leaves"]) for b, d in zip(bufs, bdocs))
    flat = all(b.numel() == int(d["size"]) for b, d in zip(bufs, bdocs))
    for buf, d in zip(bufs, bdocs):
        for j, ld in enumerate(d["leaves"]):
            if scalar and not flat:
                leaves[ld["index"]] = buf[j]
            else:
                shape = tuple(ld["shape"])
                size = int(np.prod(shape, dtype=np.int64)) if shape else 1
                o = int(ld["offset"])
                leaves[ld["index"]] = buf[o:o + size].reshape(shape)
    return leaves  # type: ignore[return-value]


def _load_training_state_v2(path: str, params_like: Tree, optimizer=None,
                            extra_like: Optional[Tree] = None, device=None,
                            header: Optional[Dict] = None):
    """v2 restore: adopt the packed buffers when the optimizer's plan has
    the header's layout (one host-to-device copy per buffer), else slice
    them into leaves on the host and ``load_state_dict`` those (a
    ``fuse_buckets=False`` optimizer, or no optimizer)."""
    header, sects = _read_v2(path, header=header)
    plan_doc = header["plan"]
    meta = header.get("metadata", {})
    paths = plan_doc["paths"]
    like_leaves, like_treedef = tree_flatten(params_like)
    if len(like_leaves) != len(paths):
        raise TemplateMismatchError(
            f"checkpoint has {len(paths)} leaves, template has "
            f"{len(like_leaves)}")
    saved: List[Any] = [None] * len(paths)
    for d in plan_doc["buckets"]:
        for ld in d["leaves"]:
            saved[ld["index"]] = (tuple(ld["shape"]), d["model_dtype"])
    for i, leaf in enumerate(like_leaves):
        if _leaf_sig(leaf) != saved[i]:
            raise TemplateMismatchError(
                f"checkpoint does not match template at leaf {paths[i]}: "
                f"saved {saved[i][0]}/{saved[i][1]}, template "
                f"{_leaf_sig(leaf)[0]}/{_leaf_sig(leaf)[1]}")
    state_fields = sorted(n.split(":", 1)[1] for n in sects
                          if n.startswith("state:"))
    has_masters = "masters" in sects
    plan = getattr(optimizer, "_plan", None) if optimizer is not None \
        else None
    if optimizer is not None:
        if sorted(optimizer.opt_state) != state_fields:
            raise TemplateMismatchError(
                f"checkpoint optimizer state fields {state_fields} do not "
                f"match the restoring optimizer's "
                f"{sorted(optimizer.opt_state)} (different optimizer?)")
        if has_masters != (optimizer.masters is not None):
            raise TemplateMismatchError(
                f"checkpoint {'has' if has_masters else 'lacks'} master "
                f"weights but the restoring optimizer "
                f"{'lacks' if has_masters else 'keeps'} them (different "
                "master_weights= setting?): a partial load would train "
                "from freshly initialized masters")
    if plan is not None and plan.layout() == plan_doc:
        optimizer.load_packed_snapshot(
            meta.get("opt_step", 0), meta.get("opt_hypers", {}),
            sects["params"], sects.get("masters"),
            {k: sects["state:" + k] for k in state_fields})
        params = optimizer.params
    else:
        dev = optimizer.device if optimizer is not None else device
        params = tree_unflatten(like_treedef, [
            _place(l, t, dev) for l, t in
            zip(_v2_leaves(plan_doc, sects["params"]), like_leaves)])
        if optimizer is not None:
            masters = None
            if has_masters:
                masters = tree_unflatten(like_treedef, [
                    l.to(dev) for l in
                    _v2_leaves(plan_doc, sects["masters"])])
            state_tree = {
                k: tree_unflatten(like_treedef, _v2_leaves(
                    plan_doc, sects["state:" + k]))
                for k in state_fields}
            optimizer.load_state_dict({
                "step": meta.get("opt_step", 0),
                "hypers": meta.get("opt_hypers", {}),
                "state": state_tree, "masters": masters})
            optimizer.params = params
    out = (params, meta.get("amp"), meta.get("step", 0))
    if extra_like is not None:
        if "extra" not in sects:
            raise TemplateMismatchError(
                "extra_like given but the checkpoint has no extra section")
        doc = next(d for d in header["sections"] if d["name"] == "extra")
        eleaves, etreedef = tree_flatten(extra_like)
        if len(eleaves) != len(sects["extra"]):
            raise TemplateMismatchError(
                f"checkpoint extra has {len(sects['extra'])} leaves, "
                f"template has {len(eleaves)}")
        restored = []
        for i, (el, arr) in enumerate(zip(eleaves, sects["extra"])):
            shape = tuple(doc["shapes"][i])
            if _leaf_sig(el) != (shape, doc["dtypes"][i]):
                raise TemplateMismatchError(
                    f"checkpoint extra does not match template at "
                    f"{doc['paths'][i]}")
            restored.append(_place(arr.reshape(shape), el, device))
        out = out + (tree_unflatten(etreedef, restored),)
    return out


# ---------------------------------------------------------------------------
# the training-state bundle
# ---------------------------------------------------------------------------
def _training_state_tree(params, optimizer, amp_state, step, extra):
    """The ``{'params', 'extra', 'opt'}`` bundle and its metadata, taken
    on the caller's thread so it is of one step."""
    tree = {"params": params}
    if extra is not None:
        tree["extra"] = extra
    meta: Dict[str, Any] = {"step": step}
    if optimizer is not None:
        sd = optimizer.state_dict()
        meta["opt_step"] = sd.pop("step", 0)
        meta["opt_hypers"] = {
            k: v for k, v in sd.pop("hypers", {}).items()
            if isinstance(v, (int, float, bool, str))}
        tree["opt"] = {k: v for k, v in sd.items() if v is not None}
    if amp_state is not None:
        meta["amp"] = amp_state
    return tree, meta


def _wants_packed(optimizer, format: str, params=None) -> bool:
    if format not in ("auto", "v1", "v2"):
        raise ValueError(f"unknown checkpoint format {format!r}")
    if format == "v1":
        return False
    packed = (optimizer is not None
              and getattr(optimizer, "_plan", None) is not None)
    if format == "v2":
        if not packed:
            raise ValueError(
                "format='v2' requires a bucketed optimizer "
                "(fuse_buckets=True and a tree the packer accepts)")
        if params is not None:
            raise ValueError(
                "format='v2' snapshots the optimizer's own packed params; "
                "an explicit params tree (e.g. EMA weights) cannot be "
                "written packed: pass params=None, or format='v1' to save "
                "the given tree")
        return True
    # auto: an explicit params tree (EMA weights) is honored, per leaf
    return packed and params is None


def save_training_state(path: str, params: Tree = None, optimizer=None,
                        amp_state=None, step: int = 0,
                        extra: Optional[Tree] = None,
                        format: str = "auto") -> int:
    """The reference's ``{'model', 'optimizer', 'amp'}`` bundle in one
    call; returns the bytes written.

    ``amp_state``: ``amp_state.state_dict()`` (JSON-able); ``extra``: any
    other tree (BatchNorm statistics).  ``format="auto"`` writes v2 when
    the optimizer runs bucketed and ``params`` is None, else v1; ``"v1"``
    forces per leaf; ``"v2"`` raises unless v2 can be written."""
    if _wants_packed(optimizer, format, params):
        return save_training_state_packed(path, optimizer,
                                          amp_state=amp_state, step=step,
                                          extra=extra)
    if params is None:
        params = optimizer.params if optimizer is not None else None
    if params is None:
        raise ValueError("params required for a v1 (per-leaf) save")
    tree, meta = _training_state_tree(params, optimizer, amp_state, step,
                                      extra)
    return save_checkpoint(path, tree, meta)


def load_training_state(path: str, params_like: Tree, optimizer=None,
                        extra_like: Optional[Tree] = None, device=None):
    """Inverse of :func:`save_training_state`; restores ``optimizer`` in
    place.  Returns ``(params, amp_state, step)``, or ``(params,
    amp_state, step, extra)`` when ``extra_like`` is given.  Either
    format loads into a bucketed or a per-leaf optimizer."""
    header = read_checkpoint_header(path)
    if header.get("magic") == _MAGIC_V2:
        return _load_training_state_v2(path, params_like, optimizer,
                                       extra_like, device, header=header)
    tree_like = {"params": params_like}
    if extra_like is not None:
        tree_like["extra"] = extra_like
    if optimizer is not None:
        sd = optimizer.state_dict()
        tree_like["opt"] = {k: v for k, v in sd.items()
                            if k not in ("step", "hypers") and v is not None}
    tree, meta = load_checkpoint(path, tree_like, device=device,
                                 header=header)
    if optimizer is not None:
        sd = dict(tree["opt"])
        sd["step"] = meta.get("opt_step", 0)
        sd["hypers"] = meta.get("opt_hypers", {})
        sd.setdefault("masters", None)
        optimizer.load_state_dict(sd)
        optimizer.params = tree["params"]
    out = (tree["params"], meta.get("amp"), meta.get("step", 0))
    if extra_like is not None:
        return out + (tree["extra"],)
    return out


class AsyncCheckpointer:
    """Checkpoint writes on one worker thread.

    ``save()`` / ``save_training_state()`` take their copies on the
    caller's thread: tensor leaves are cloned (on the card, on the
    current stream; a bucketed optimizer's buffers by
    ``packed_snapshot``), containers and metadata copied, and an event
    recorded; the worker waits on the event, moves the copies to pinned
    host memory and writes the file.  At most one save is in flight: a new save
    first waits for the previous one, and a failure of the worker is
    raised at the next call or at ``wait_until_finished()``, with the
    failed write's path and step attached."""

    def __init__(self):
        import concurrent.futures as cf
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="apex_ckpt")
        self._inflight = None          # (future, path, step) or None

    def _join(self) -> None:
        if self._inflight is None:
            return
        (fut, path, step), self._inflight = self._inflight, None
        try:
            fut.result()
        except Exception as e:
            # the failure surfaces at a later call, whose traceback
            # points at another save: name the failed one
            note = (f"[async checkpoint write of {path!r} (step {step}) "
                    "failed]")
            e.checkpoint_path = path
            e.checkpoint_step = step
            e.add_note(note)
            raise

    def _snapshot(self, tree, metadata):
        leaves, treedef = tree_flatten(tree)
        # the step writes in place: the writer reads clones, never the
        # live tensors
        leaves = [l.detach().clone() if isinstance(l, torch.Tensor)
                  else l for l in leaves]
        return (tree_unflatten(treedef, leaves),
                copy.deepcopy(metadata) if metadata is not None else None,
                _ready_event(leaves))

    def save(self, path: str, tree: Tree,
             metadata: Optional[Dict] = None) -> None:
        self._join()
        tree, metadata, ready = self._snapshot(tree, metadata)
        self._inflight = (self._pool.submit(
            _save_checkpoint, path, tree, metadata, ready), path,
            (metadata or {}).get("step"))

    def save_training_state(self, path: str, params: Tree = None,
                            optimizer=None, amp_state=None, step: int = 0,
                            extra: Optional[Tree] = None,
                            format: str = "auto") -> None:
        self._join()
        if _wants_packed(optimizer, format, params):
            plan_doc, meta, docs, bufs = _packed_v2_args(
                optimizer, copy.deepcopy(amp_state), step,
                self._snapshot(extra, None)[0] if extra is not None
                else None)
            self._inflight = (self._pool.submit(
                _write_checkpoint_v2, path, plan_doc, meta, docs, bufs,
                _ready_event(bufs)), path, step)
            return
        if params is None and optimizer is not None:
            params = optimizer.params
        if params is None:
            raise ValueError("params required for a v1 (per-leaf) save")
        tree, meta = _training_state_tree(params, optimizer, amp_state,
                                          step, extra)
        tree, meta, ready = self._snapshot(tree, meta)
        self._inflight = (self._pool.submit(
            _save_checkpoint, path, tree, meta, ready), path, step)

    def wait_until_finished(self) -> None:
        """Block until the in-flight save (if any) is durable."""
        self._join()

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:             # never leak the worker, even after a failure
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
