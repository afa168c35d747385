"""Host -> device input pipeline (port of ``apex_tpu.data.DevicePrefetcher``,
itself the reference's ``data_prefetcher`` of its ImageNet example),
:func:`pack_sequences` and :func:`pack_dataset` (ports of
``apex_tpu.data.pack_sequences`` and ``pack_dataset``).

Each host batch (a tree of numpy arrays or CPU tensors) is copied into
pinned host memory and sent to the card with ``non_blocking`` copies on
a side CUDA stream, ``depth`` batches ahead of the one being consumed.
The consumer's stream waits on the batch's copy event (no host sync)
and the batch's tensors are recorded on it, so the caching allocator
never hands their memory out while the step still reads it.  On the CPU
the batches are plain tensors.

The reference's loop idiom ``x, y = prefetcher.next()`` works too: it
returns None at the end, and keeps returning it.  An error raised by the
source surfaces in the consumer when it reaches the batch that failed,
after the batches before it.  ``close()`` (or the context manager) drops
the batches in flight and closes the source on an early exit.
:func:`prefetch_to_device` is the functional spelling.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._tree import tree_leaves, tree_map


class DevicePrefetcher:
    """Iterate device-resident batches, ``depth`` copies in flight.

    >>> with DevicePrefetcher(loader, depth=2) as pf:
    ...     for x, y in pf:
    ...         step(x, y)    # the next batches' copies already issued
    """

    def __init__(self, it: Iterable[Any], depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self._src = iter(it)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._ready = collections.deque()
        self._error: Optional[BaseException] = None
        self._done = False
        for _ in range(depth):
            if not self._issue():
                break

    @staticmethod
    def _host(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a

    def _issue(self) -> bool:
        """Start the copy of the next host batch; False at exhaustion or
        when the source failed (its error is raised when the consumer
        gets to it)."""
        if self._done:
            return False
        try:
            batch = next(self._src)
        except StopIteration:
            self._done = True
            return False
        except Exception as e:
            self._done = True
            self._error = e
            return False
        host = tree_map(self._host, batch)
        if not self._cuda:
            self._ready.append((tree_map(lambda t: t.to(self.device), host),
                                None))
            return True
        pinned = tree_map(lambda t: t.pin_memory(), host)
        with torch.cuda.stream(self._stream):
            dev = tree_map(lambda t: t.to(self.device, non_blocking=True),
                           pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the pinned buffers must outlive their copies
        self._ready.append((dev, (done, pinned)))
        return True

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if not self._ready:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        batch, pending = self._ready.popleft()
        if pending is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pending[0])
            for t in tree_leaves(batch):
                t.record_stream(stream)
        self._issue()
        return batch

    def next(self):
        """The reference's idiom: the next batch, or None at the end (and
        on every call after it)."""
        try:
            return self.__next__()
        except StopIteration:
            return None

    def close(self) -> None:
        """Drop the batches in flight and close the source (a generator's
        ``close()``); the prefetcher is then exhausted."""
        self._done = True
        self._ready.clear()
        self._error = None
        close = getattr(self._src, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(it: Iterable[Any], depth: int = 2, device=None
                       ) -> DevicePrefetcher:
    """Functional spelling of :class:`DevicePrefetcher`."""
    return DevicePrefetcher(it, depth=depth, device=device)


def pack_sequences(sequences, max_len: int, pad_id: int = 0):
    """Pack variable-length token sequences into fixed (B, max_len) rows
    for segment-masked attention (the reference's fmha packed varlen
    contract; the flash kernels' ``segment_ids`` do the masking).

    First-fit-decreasing bin packing on the host (numpy).  Returns a
    dict of (B, max_len) int32 arrays: ``tokens`` (``pad_id`` in each
    row's tail), ``segment_ids`` (1, 2, ... per packed sequence, 0 on
    padding), ``q_segment_ids`` / ``kv_segment_ids`` (the attention
    form: padding carries -1 on the query side and -2 on the key side,
    so pad rows attend nowhere and output exact zeros) and
    ``positions`` (0-based within each sequence, 0 on padding).  A
    sequence longer than ``max_len``, or an empty one, raises."""
    seqs = [np.asarray(s, dtype=np.int32).reshape(-1) for s in sequences]
    too_long = [i for i, s in enumerate(seqs) if len(s) > max_len]
    if too_long:
        raise ValueError(
            f"pack_sequences: sequence(s) {too_long[:5]} longer than "
            f"max_len={max_len}; truncate or split before packing")
    empty = [i for i, s in enumerate(seqs) if len(s) == 0]
    if empty:
        raise ValueError(
            f"pack_sequences: sequence(s) {empty[:5]} are empty; "
            f"filter them out (and their labels) before packing")

    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    bins = []          # [free, [seq_idx, ...]]
    for i in order:
        need = len(seqs[i])
        for b in bins:
            if b[0] >= need:
                b[0] -= need
                b[1].append(i)
                break
        else:
            bins.append([max_len - need, [i]])

    rows = len(bins)
    tokens = np.full((rows, max_len), pad_id, dtype=np.int32)
    segment_ids = np.zeros((rows, max_len), dtype=np.int32)
    positions = np.zeros((rows, max_len), dtype=np.int32)
    for r, (_, members) in enumerate(bins):
        off = 0
        for seg, i in enumerate(members, start=1):
            n = len(seqs[i])
            tokens[r, off:off + n] = seqs[i]
            segment_ids[r, off:off + n] = seg
            positions[r, off:off + n] = np.arange(n)
            off += n
    return {"tokens": tokens, "segment_ids": segment_ids,
            "positions": positions,
            "q_segment_ids": np.where(segment_ids > 0, segment_ids, -1),
            "kv_segment_ids": np.where(segment_ids > 0, segment_ids, -2)}


def pack_dataset(sequences, max_len: int, rows_per_batch: int,
                 pad_id: int = 0, buffer_batches: int = 8):
    """Stream packed batches from an iterable of token sequences.

    Buffers sequences until they hold ``rows_per_batch * buffer_batches
    * max_len`` tokens, packs the buffer with :func:`pack_sequences`
    (first-fit-decreasing packs best with many candidates), and yields
    dicts shaped as its output with EXACTLY ``rows_per_batch`` rows, so
    every step sees one shape.  Rows left over when a buffer does not
    fill a whole batch go back, unpacked, into the next buffer; only the
    stream's final partial batch is padded with all-padding rows
    (segment 0, which a packed loss leaves out).  Sequences longer than
    ``max_len``, or empty, raise as in :func:`pack_sequences`."""
    pad_fill = {"tokens": pad_id, "segment_ids": 0, "positions": 0,
                "q_segment_ids": -1, "kv_segment_ids": -2}

    def chunks(buf, final):
        """Yield the full batches; return the leftover sequences (or pad
        out the last batch when ``final``)."""
        packed = pack_sequences(buf, max_len, pad_id=pad_id)
        rows = packed["tokens"].shape[0]
        full = rows - rows % rows_per_batch
        for start in range(0, full, rows_per_batch):
            yield {k: v[start:start + rows_per_batch]
                   for k, v in packed.items()}
        leftover = []
        if rows != full:
            tail = {k: v[full:] for k, v in packed.items()}
            if final:
                short = rows_per_batch - tail["tokens"].shape[0]
                yield {k: np.concatenate(
                    [v, np.full((short, max_len), pad_fill[k],
                                dtype=v.dtype)], axis=0)
                    for k, v in tail.items()}
            else:
                segs, toks = tail["segment_ids"], tail["tokens"]
                for r in range(toks.shape[0]):
                    for seg in range(1, int(segs[r].max()) + 1):
                        leftover.append(toks[r][segs[r] == seg])
        return leftover

    # flush by token count: that many tokens make at least
    # rows_per_batch * buffer_batches rows, so each flush emits a full
    # batch and the carry stays below one batch's worth
    buf, toks = [], 0
    threshold = rows_per_batch * buffer_batches * max_len
    for s in sequences:
        buf.append(s)
        toks += len(s)
        if toks >= threshold:
            buf = yield from chunks(buf, final=False)
            toks = sum(len(x) for x in buf)
    if buf:
        yield from chunks(buf, final=True)
