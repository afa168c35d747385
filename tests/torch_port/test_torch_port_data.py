"""apex_tpu_torch.data.DevicePrefetcher and prefetch_to_device: the port's
counterparts of tests/test_data.py's prefetcher cases (all but the mesh
sharding one, which comes with the port's multi-card slice).  The port's
prefetcher has no feeder thread (its copies run on a side CUDA stream),
so the reference's thread checks become checks that ``close()`` drops
the batches in flight and closes the source.  On the CPU the batches
are plain tensors.  Values are compared exactly.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.data import DevicePrefetcher, prefetch_to_device


def _batches(n, b=4):
    for i in range(n):
        yield {"x": np.full((b, 8), i, np.float32),
               "y": np.full((b,), i, np.int32)}


def test_prefetcher_yields_all_batches_in_order_on_device():
    out = list(DevicePrefetcher(_batches(5), depth=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        assert b["x"].dtype == torch.float32 and b["y"].dtype == torch.int32
        assert float(b["x"][0, 0]) == i and int(b["y"][0]) == i


def test_prefetcher_reference_next_idiom():
    pf = DevicePrefetcher(_batches(2), device="cpu")
    seen = 0
    batch = pf.next()
    while batch is not None:
        seen += 1
        batch = pf.next()
    assert seen == 2
    # it keeps returning None after the end
    assert pf.next() is None
    assert pf.next() is None


def test_prefetcher_early_exit_close_releases_the_source():
    src = _batches(100)
    pf = DevicePrefetcher(src, depth=2, device="cpu")
    first = next(iter(pf))
    assert float(first["x"][0, 0]) == 0
    pf.close()                      # abandon mid-stream
    assert pf.next() is None        # a closed prefetcher is exhausted
    with pytest.raises(StopIteration):
        next(src)                   # the generator was closed


def test_prefetcher_context_manager():
    src = _batches(50)
    with DevicePrefetcher(src, depth=2, device="cpu") as pf:
        for _, b in zip(range(3), pf):
            pass
    assert float(b["x"][0, 0]) == 2
    assert pf.next() is None
    with pytest.raises(StopIteration):
        next(src)


def test_prefetcher_propagates_source_errors():
    def bad():
        yield {"x": np.zeros((2,), np.float32)}
        raise RuntimeError("loader died")

    pf = DevicePrefetcher(bad(), depth=1, device="cpu")
    assert pf.next() is not None    # the batch before the failure
    with pytest.raises(RuntimeError, match="loader died"):
        pf.__next__()
    assert pf.next() is None        # raised once, then exhausted


def test_prefetcher_rejects_bad_depth():
    with pytest.raises(ValueError):
        DevicePrefetcher(_batches(1), depth=0, device="cpu")


def test_closed_prefetcher_never_pulls_the_source_again():
    """The reference's close wakes a consumer blocked on its queue; the
    port pulls the source on the consumer's thread, so after close() no
    call may reach the source (here one that would hang)."""
    pulled = []

    def slow():
        yield {"x": np.zeros((2,), np.float32)}
        pulled.append(1)
        raise AssertionError("pulled after close")

    pf = DevicePrefetcher(slow(), depth=1, device="cpu")
    pf.close()
    assert pf.next() is None and pf.next() is None
    assert not pulled


def test_prefetch_to_device_is_the_functional_spelling():
    pf = prefetch_to_device(({"x": torch.ones(2, 4)} for _ in range(3)),
                            depth=2, device="cpu")
    assert isinstance(pf, DevicePrefetcher)
    got = [float(b["x"].sum()) for b in pf]
    assert got == [8.0, 8.0, 8.0]


def test_prefetcher_without_device_means_the_card():
    if torch.cuda.is_available():
        assert DevicePrefetcher(_batches(1)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DevicePrefetcher(_batches(1))
