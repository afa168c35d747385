"""Optimizer state offload (``offload_state=True``) of the port's fused
optimizers: the port's counterparts of tests/test_optimizers.py's offload
cases (:49 stepping like the resident optimizer, :102 state re-homed on
restore) and tests/test_bucketed_optimizers.py:193, for every optimizer
and through the BERT example's ``--offload-state``.

On the CPU the host is the device, so the round trip is two copies a
bucket and field a step; the tests count them through the seam and hold
the offloaded step to the resident one bit for bit (the same kernels on
the same values).  Against the JAX package's offloaded FusedAdam: rtol
1e-6, atol 1e-6 (its own test's tolerance; XLA may contract a product
and a sum into an FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam, FusedLAMB,
                                       FusedNovoGrad, FusedSGD)
from apex_tpu_torch.optimizers import _base as base_mod


def _params(dtype=torch.float32):
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((32, 8))
                                  .astype(np.float32)).to(dtype),
            "b": torch.zeros(16, dtype=dtype),
            "head": torch.from_numpy(rng.standard_normal((8, 4))
                                     .astype(np.float32)).to(dtype)}


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: torch.from_numpy(
        (rng.standard_normal(tuple(p.shape)) * 0.1).astype(np.float32))
        .to(p.dtype), params)


def _eq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


OPTS = {
    "sgd": (FusedSGD, dict(lr=0.1, momentum=0.9, weight_decay=1e-4)),
    "adam": (FusedAdam, dict(lr=1e-2, weight_decay=0.01)),
    "lamb": (FusedLAMB, dict(lr=1e-2, weight_decay=0.01)),
    "novograd": (FusedNovoGrad, dict(lr=1e-2, weight_decay=0.01)),
    "adagrad": (FusedAdagrad, dict(lr=1e-2, weight_decay=0.01)),
}


@pytest.mark.parametrize("kind", sorted(OPTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_offloaded_step_gives_the_resident_bits(kind, dtype, monkeypatch):
    """3 steps, the second skipped on a found_inf: params, masters, state
    and the step clock bit for bit; the state stays on the host and
    crosses to the device once a bucket and field a step."""
    cls, kw = OPTS[kind]
    params = _params(torch.float32 if dtype == "f32" else torch.bfloat16)
    ref = cls(params, **kw)
    off = cls(params, offload_state=True, **kw)
    fetched = []
    real = base_mod.place_on_device
    monkeypatch.setattr(base_mod, "place_on_device",
                        lambda t, d: fetched.append(1) or real(t, d))
    for i, flag in enumerate([0, 1, 0]):
        g = _grads(params, i)
        fi = torch.tensor(flag, dtype=torch.int32)
        ref.step(g, found_inf=fi)
        off.step(g, found_inf=fi)
    n_bufs = sum(len(v) for v in off.opt_state.values())
    assert len(fetched) == 3 * n_bufs
    for bufs in off.opt_state.values():
        assert all(b.device.type == "cpu" and b.dim() == 1 for b in bufs)
    _eq(off.params, ref.params)
    if ref.masters is not None:
        _eq(off.masters, ref.masters)
    _eq(off.state_dict()["state"], ref.state_dict()["state"])
    assert int(off.step_count) == int(ref.step_count) == 2


def test_offload_state_matches_resident_adam():
    """tests/test_optimizers.py:49, against the JAX package's offloaded
    FusedAdam too."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal(256).astype(np.float32)
    gw = (rng.standard_normal(256) * 0.1).astype(np.float32)
    params = {"w": torch.from_numpy(w), "b": torch.zeros(16)}
    g = {"w": torch.from_numpy(gw), "b": torch.full((16,), 0.01)}
    ref = FusedAdam(params, lr=1e-2, weight_decay=0.01)
    off = FusedAdam(params, lr=1e-2, weight_decay=0.01, offload_state=True)
    joff = JAdam({"w": jnp.asarray(w), "b": jnp.zeros(16)}, lr=1e-2,
                 weight_decay=0.01, offload_state=True)
    for _ in range(3):
        ref.step(g)
        off.step(g)
        joff.step({"w": jnp.asarray(gw), "b": jnp.full((16,), 0.01)})
    _eq(off.params, ref.params)
    for a, b in zip(tree_leaves(off.params),
                    jax.tree_util.tree_leaves(joff.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for bufs in off.opt_state.values():
        assert all(b.device.type == "cpu" for b in bufs)


def test_offload_state_rehomed_on_restore():
    """tests/test_optimizers.py:102: load_state_dict lands the restored
    state in the host buffers the optimizer already has."""
    params = {"w": torch.ones(64)}
    opt = FusedAdam(params, lr=1e-3, offload_state=True)
    opt.step({"w": torch.full((64,), 0.1)})
    sd = opt.state_dict()
    opt2 = FusedAdam(params, lr=1e-3, offload_state=True)
    ptrs = {k: [b.data_ptr() for b in v] for k, v in opt2.opt_state.items()}
    opt2.load_state_dict(sd)
    for k, bufs in opt2.opt_state.items():
        assert [b.data_ptr() for b in bufs] == ptrs[k]
        assert all(b.device.type == "cpu" for b in bufs)
    _eq(opt2.state_dict()["state"], sd["state"])
    opt2.params = opt.params
    g = {"w": torch.full((64,), 0.2)}
    _eq(opt2.step(g), opt.step(g))


def test_per_leaf_offload_is_a_no_op(monkeypatch):
    """The per-leaf step runs only on the CPU, where its state is in
    host memory already: the flag moves nothing and reads False."""
    copies = []
    real = base_mod.place_on_device
    monkeypatch.setattr(base_mod, "place_on_device",
                        lambda t, d: copies.append(t) or real(t, d))
    params = _params()
    ref = FusedAdam(params, lr=1e-2, fuse_buckets=False)
    off = FusedAdam(params, lr=1e-2, fuse_buckets=False, offload_state=True)
    assert not off.offload_state
    for i in range(2):
        ref.step(_grads(params, i))
        off.step(_grads(params, i))
    _eq(off.params, ref.params)
    _eq(off.opt_state, ref.opt_state)
    assert copies == []
    assert all(t.device.type == "cpu" for t in tree_leaves(off.opt_state))


def test_offload_state_dict_interloads_with_resident():
    params = _params(torch.bfloat16)
    off = FusedLAMB(params, lr=1e-2, offload_state=True)
    res = FusedLAMB(params, lr=1e-2)
    for i in range(2):
        off.step(_grads(params, i))
    res.load_state_dict(off.state_dict())
    res.params = off.params
    g = _grads(params, 7)
    _eq(res.step(g), off.step(g))
    _eq(res.state_dict()["state"], off.state_dict()["state"])


def test_bert_example_offload_state_gives_the_resident_bits():
    """``--offload-state`` through the BERT example's own train(): the
    2-step proxy at amp O2 with FusedLAMB, offloaded against resident."""
    from apex_tpu_torch.examples import bert_pretrain_mlm as ex
    runs = {off: ex.train(steps=2, batch=2, seq=32, offload_state=off,
                          device="cpu", log=None) for off in (False, True)}
    a, b = runs[False], runs[True]
    assert b.opt.offload_state and not a.opt.offload_state
    assert a.losses == b.losses
    _eq(b.opt.params, a.opt.params)
    _eq(b.opt.masters, a.opt.masters)
    _eq(b.opt.state_dict()["state"], a.opt.state_dict()["state"])
    res = ex.main(["--steps", "1", "--batch-size", "2", "--seq-len", "32",
                   "--offload-state", "--device", "cpu"])
    assert res.opt.offload_state and len(res.losses) == 1
