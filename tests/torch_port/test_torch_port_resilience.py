"""apex_tpu_torch.resilience and the bucket-native (v2) checkpoints: the
port's counterparts of the single-process cases of
tests/test_resilience.py (rotation, corrupt fallback, template mismatch,
orphaned .tmp files, v2 round trips, no per-leaf unpack, v1/v2 interload,
the async double buffer, offloaded snapshot and adoption, preemption on
a cadence step, last-known-good pinning, PreemptionGuard).

Tolerances: none; checkpoints move bytes and every comparison is bit for
bit.
"""

import os
import signal
import time
import warnings

import pytest
import torch

from apex_tpu_torch import checkpoint as ckpt_mod
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.checkpoint import TemplateMismatchError
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.resilience import CheckpointManager, PreemptionGuard


def _train(mgr, steps):
    params = {"w": torch.ones(64)}
    opt = FusedSGD(params, lr=0.1)
    g = {"w": torch.full((64,), 0.01)}
    restored = mgr.restore_latest({"w": torch.zeros(64)}, opt)
    s0 = 0
    if restored is not None:
        _, _, s0 = restored
    for step in range(s0 + 1, steps + 1):
        opt.step(g)
        mgr.maybe_save(step, opt.params, opt)
    mgr.wait()
    return opt, s0


def _eq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def _mixed_tree():
    """bf16 matrices and f32 vectors: two dtype buckets and f32 masters
    (amp O2's mix)."""
    return {
        "w1": torch.linspace(-1.0, 1.0, 256).to(torch.bfloat16)
        .reshape(16, 16),
        "b1": torch.linspace(0.0, 1.0, 16),
        "w2": torch.linspace(0.5, -0.5, 64).to(torch.bfloat16).reshape(8, 8),
        "s": torch.ones(3),
    }


def _grads_for(tree):
    return tree_map(lambda p: (p.float() * 1e-2 + 1e-3).to(p.dtype), tree)


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _opt_states_equal(o1, o2):
    s1, s2 = o1.state_dict(), o2.state_dict()
    assert s1["step"] == s2["step"]
    _eq(s1["state"], s2["state"])
    _eq(o1.params, o2.params)
    if s1["masters"] is not None or s2["masters"] is not None:
        _eq(s1["masters"], s2["masters"])


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------
def test_rotation_keeps_newest_k(tmp_path):
    with CheckpointManager(str(tmp_path), keep=2, every=5) as mgr:
        _train(mgr, 30)
        assert mgr.steps_on_disk() == [25, 30]


def test_resume_continues_from_latest(tmp_path):
    with CheckpointManager(str(tmp_path), keep=3, every=5) as mgr:
        opt1, s0 = _train(mgr, 20)
        assert s0 == 0
    with CheckpointManager(str(tmp_path), keep=3, every=5) as mgr:
        opt2, s0 = _train(mgr, 20)   # "crash" and restart at 20
        assert s0 == 20              # no extra steps run
    _eq(opt1.params, opt2.params)


def test_corrupt_newest_falls_back_to_previous(tmp_path):
    with CheckpointManager(str(tmp_path), keep=3, every=5) as mgr:
        _train(mgr, 15)
        assert mgr.steps_on_disk() == [5, 10, 15]
        p = os.path.join(str(tmp_path), "step-15.ckpt")
        data = open(p, "rb").read()
        open(p, "wb").write(data[:len(data) // 2])   # mid-write crash
        opt = FusedSGD({"w": torch.zeros(64)}, lr=0.1)
        with pytest.warns(UserWarning, match="skipping .*step-15"):
            restored = mgr.restore_latest({"w": torch.zeros(64)}, opt)
        assert restored is not None and restored[2] == 10


def test_empty_dir_returns_none(tmp_path):
    with CheckpointManager(str(tmp_path / "fresh"), every=5) as mgr:
        assert mgr.restore_latest({"w": torch.zeros(4)}) is None


def test_bad_config_rejected(tmp_path):
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), every=0)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), format="v3")


def test_template_mismatch_raises_not_skips(tmp_path):
    with CheckpointManager(str(tmp_path), keep=3, every=5) as mgr:
        _train(mgr, 10)
        with pytest.raises(TemplateMismatchError):
            mgr.restore_latest({"w": torch.zeros(8)})   # wrong shape


def test_gc_never_drops_below_keep_durable(tmp_path):
    with CheckpointManager(str(tmp_path), keep=1, every=5) as mgr:
        opt = FusedSGD({"w": torch.ones(64)}, lr=0.1)
        g = {"w": torch.full((64,), 0.01)}
        for _ in range(5):
            opt.step(g)
        mgr.maybe_save(5, opt.params, opt)
        mgr.wait()
        assert mgr.steps_on_disk() == [5]
        for _ in range(5):
            opt.step(g)
        mgr.maybe_save(10, opt.params, opt)   # step 10 in flight
        assert 5 in mgr.steps_on_disk()
        mgr.wait()
        assert mgr.steps_on_disk() == [10]


def test_orphaned_tmp_cleared_on_init(tmp_path):
    orphan = tmp_path / "step-5.ckpt.tmp"
    orphan.write_bytes(b"garbage from a dead process")
    keep = tmp_path / "notes.tmp"
    keep.write_bytes(b"not a checkpoint's")
    with CheckpointManager(str(tmp_path), keep=3, every=5):
        assert not orphan.exists() and keep.exists()


def test_manager_due_is_the_maybe_save_cadence(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=4)
    assert [s for s in range(1, 13) if mgr.due(s)] == [4, 8, 12]
    assert not mgr.maybe_save(3)       # off cadence: no arguments needed
    mgr.close()


# ---------------------------------------------------------------------------
# v2: bucket-native files
# ---------------------------------------------------------------------------
def test_v2_roundtrip_packed_fast_path(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    for _ in range(3):
        opt.step(_grads_for(tree))
    p = str(tmp_path / "v2.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=3,
                                 amp_state={"loss_scale": 8.0})
    header = ckpt_mod.read_checkpoint_header(p)
    assert header["magic"] == "APEX_TPU_CKPT_V2"
    assert header["plan"] == opt._plan.layout()
    opt2 = FusedAdam(_mixed_tree(), lr=1e-2)
    views = opt2.params
    params, amp_sd, step = ckpt_mod.load_training_state(p, _zeros(tree),
                                                        opt2)
    assert step == 3 and amp_sd == {"loss_scale": 8.0}
    _opt_states_equal(opt, opt2)
    _eq(params, opt.params)
    _eq(views, opt.params)       # adopted in place: old views see it


def test_v2_save_does_zero_per_leaf_unpack(tmp_path, monkeypatch):
    """One copy through ``_device_copy`` and one ``_d2h`` per packed
    buffer, and no unpack, on the save; one ``_adopt`` per buffer on the
    restore."""
    from apex_tpu_torch.multi_tensor_apply.packer import BucketPlan
    from apex_tpu_torch.optimizers import _base as base_mod

    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))
    opt2 = FusedAdam(_mixed_tree(), lr=1e-2)

    def _boom(*a, **k):
        raise AssertionError("per-leaf unpack on the v2 path")
    for name in ("unpack", "unpack_model", "unpack_state_field",
                 "unpack_grads"):
        monkeypatch.setattr(BucketPlan, name, _boom)
    copies, transfers, adopts = [], [], []
    real_copy, real_d2h, real_adopt = (base_mod._device_copy,
                                       ckpt_mod._d2h, base_mod._adopt)
    monkeypatch.setattr(base_mod, "_device_copy",
                        lambda b: copies.append(1) or real_copy(b))
    monkeypatch.setattr(ckpt_mod, "_d2h",
                        lambda b: transfers.append(1) or real_d2h(b))
    monkeypatch.setattr(base_mod, "_adopt",
                        lambda d, s: adopts.append(1) or real_adopt(d, s))
    p = str(tmp_path / "v2.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1)
    n_bufs = (len(opt._param_bufs) + len(opt._master_bufs)
              + sum(len(v) for v in opt.opt_state.values()))
    assert n_bufs == 2 + 2 + 4
    assert len(copies) == n_bufs and len(transfers) == n_bufs
    ckpt_mod.load_training_state(p, _zeros(tree), opt2)
    assert len(adopts) == n_bufs
    monkeypatch.undo()
    _opt_states_equal(opt, opt2)


def test_v1_file_loads_into_bucketed_and_v2_into_perleaf(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    for _ in range(2):
        opt.step(_grads_for(tree))
    p1 = str(tmp_path / "v1.ckpt")
    ckpt_mod.save_training_state(p1, optimizer=opt, step=2, format="v1")
    assert ckpt_mod.read_checkpoint_header(p1)["magic"] == \
        "APEX_TPU_CKPT_V1"
    opt_b = FusedAdam(_mixed_tree(), lr=1e-2)
    ckpt_mod.load_training_state(p1, _zeros(tree), opt_b)
    _opt_states_equal(opt, opt_b)

    p2 = str(tmp_path / "v2.ckpt")
    ckpt_mod.save_training_state(p2, optimizer=opt, step=2, format="v2")
    opt_pl = FusedAdam(_mixed_tree(), lr=1e-2, fuse_buckets=False)
    assert opt_pl._plan is None
    _, _, step = ckpt_mod.load_training_state(p2, _zeros(tree), opt_pl)
    assert step == 2
    _opt_states_equal(opt, opt_pl)


def test_v2_requires_bucketed_optimizer(tmp_path):
    opt = FusedAdam(_mixed_tree(), lr=1e-2, fuse_buckets=False)
    with pytest.raises(ValueError, match="bucketed"):
        ckpt_mod.save_training_state(str(tmp_path / "x.ckpt"),
                                     optimizer=opt, format="v2")
    with pytest.raises(ValueError, match="bucketed"):
        opt.packed_snapshot()


def test_v2_extra_section_roundtrip(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))
    extra = {"bn": {"mean": torch.arange(4.0), "var": torch.ones(4)}}
    p = str(tmp_path / "v2.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1, extra=extra)
    assert ckpt_mod.read_checkpoint_header(p)["sections"][-1]["paths"] == \
        ["['bn']['mean']", "['bn']['var']"]
    out = ckpt_mod.load_training_state(
        p, _zeros(tree), FusedAdam(_mixed_tree(), lr=1e-2),
        extra_like=_zeros(extra))
    _eq(out[3], extra)


def test_explicit_params_are_honored_not_dropped(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))
    ema = tree_map(lambda p: (p.float() * 0.5).to(p.dtype), tree)
    p = str(tmp_path / "ema.ckpt")
    ckpt_mod.save_training_state(p, ema, opt, step=1)
    out = ckpt_mod.load_training_state(p, _zeros(tree),
                                       FusedAdam(_mixed_tree(), lr=1e-2))
    _eq(out[0], ema)
    with pytest.raises(ValueError):
        ckpt_mod.save_training_state(p, ema, opt, step=1, format="v2")


def test_v2_extra_python_scalar_leaves_roundtrip(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))
    extra = {"epoch": 3, "best_loss": 0.125, "bn_mean": torch.arange(4.0)}
    p = str(tmp_path / "v2.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1, extra=extra)
    got = ckpt_mod.load_training_state(
        p, _zeros(tree), FusedAdam(_mixed_tree(), lr=1e-2),
        extra_like={"epoch": 0, "best_loss": 0.0,
                    "bn_mean": torch.zeros(4)})[3]
    assert int(got["epoch"]) == 3 and got["epoch"].dtype == torch.int64
    assert float(got["best_loss"]) == 0.125
    _eq(got["bn_mean"], torch.arange(4.0))


def test_v2_masters_presence_mismatch_raises_not_partial_load(tmp_path):
    tree = _mixed_tree()
    opt_nomaster = FusedAdam(tree, lr=1e-2, master_weights=False)
    opt_nomaster.step(_grads_for(tree))
    p = str(tmp_path / "nm.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt_nomaster, step=1)
    with pytest.raises(TemplateMismatchError, match="master"):
        ckpt_mod.load_training_state(p, _zeros(tree),
                                     FusedAdam(_mixed_tree(), lr=1e-2))
    with pytest.raises(TemplateMismatchError, match="master"):
        ckpt_mod.load_training_state(
            p, _zeros(tree),
            FusedAdam(_mixed_tree(), lr=1e-2, fuse_buckets=False))


def test_v2_template_mismatch_raises(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))
    p = str(tmp_path / "v2.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1)
    bad = dict(tree)
    bad["b1"] = torch.zeros(99)
    with pytest.raises(TemplateMismatchError):
        ckpt_mod.load_training_state(p, bad)
    with pytest.raises(TemplateMismatchError, match="state fields"):
        ckpt_mod.load_training_state(p, _zeros(tree),
                                     FusedSGD(_mixed_tree(), lr=0.1,
                                              momentum=0.9))


def test_v2_async_double_buffer_survives_next_step(tmp_path):
    """The async packed save holds the state of the moment it was
    scheduled, though the next steps write the live buffers in place."""
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    opt.step(g)
    want = {k: [b.clone() for b in v] for k, v in opt.opt_state.items()}
    want_params = [b.clone() for b in opt._param_bufs]
    p = str(tmp_path / "v2.ckpt")
    with ckpt_mod.AsyncCheckpointer() as ac:
        ac.save_training_state(p, optimizer=opt, step=1)
        for _ in range(3):
            opt.step(g)
        ac.wait_until_finished()
    opt2 = FusedAdam(_mixed_tree(), lr=1e-2)
    ckpt_mod.load_training_state(p, _zeros(tree), opt2)
    for k, v in opt2.opt_state.items():
        _eq(v, want[k])
    _eq(opt2._param_bufs, want_params)


def test_manager_v2_auto_and_packed_restore(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    with CheckpointManager(str(tmp_path), keep=2, every=2) as mgr:
        for step in range(1, 5):
            opt.step(g)
            mgr.maybe_save(step, optimizer=opt)
        mgr.wait()
        newest = max(mgr.steps_on_disk())
        assert ckpt_mod.read_checkpoint_header(
            mgr._path(newest))["magic"] == "APEX_TPU_CKPT_V2"
        opt2 = FusedAdam(_mixed_tree(), lr=1e-2)
        out = mgr.restore_latest(_zeros(tree), opt2)
        assert out is not None and out[2] == 4
        _opt_states_equal(opt, opt2)


def test_async_join_attaches_failed_save_identity(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))

    class FailingFsync(ckpt_mod.CheckpointIO):
        def fsync(self, f):
            raise OSError("injected fsync failure")

    bad = str(tmp_path / "bad.ckpt")
    good = str(tmp_path / "good.ckpt")
    prev = ckpt_mod.set_io(FailingFsync())
    try:
        ac = ckpt_mod.AsyncCheckpointer()
        ac.save_training_state(bad, optimizer=opt, step=7)
        with pytest.raises(OSError) as ei:
            ac.save_training_state(good, optimizer=opt, step=8)
    finally:
        ckpt_mod.set_io(prev)
    assert ei.value.checkpoint_path == bad
    assert ei.value.checkpoint_step == 7
    text = "".join(getattr(ei.value, "__notes__", []))
    assert "bad.ckpt" in text and "step 7" in text
    assert not os.path.exists(bad)     # never published
    ac.close()


# ---------------------------------------------------------------------------
# offloaded state
# ---------------------------------------------------------------------------
def test_packed_snapshot_of_offloaded_state_stays_on_host(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2, offload_state=True)
    opt.step(_grads_for(tree))
    snap = opt.packed_snapshot()
    for k, bufs in snap["state"].items():
        for b, live in zip(bufs, opt.opt_state[k]):
            assert b.device.type == "cpu", k
            assert torch.equal(b, live) and b.data_ptr() != live.data_ptr()
    p = str(tmp_path / "off.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1)
    opt2 = FusedAdam(_mixed_tree(), lr=1e-2, offload_state=True)
    ckpt_mod.load_training_state(p, _zeros(tree), opt2)
    _opt_states_equal(opt, opt2)


def test_load_packed_snapshot_offload_adopts_on_host(tmp_path, monkeypatch):
    """A v2 restore into an offloaded optimizer copies each state buffer
    into the host buffers it already has: no device placement."""
    import apex_tpu_torch.optimizers._base as base_mod
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2, offload_state=True)
    opt.step(_grads_for(tree))
    p = str(tmp_path / "off.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1)
    opt2 = FusedAdam(_mixed_tree(), lr=1e-2, offload_state=True)
    ptrs = {k: [b.data_ptr() for b in v] for k, v in opt2.opt_state.items()}

    def _trap(*a, **k):
        raise AssertionError("device placement on the packed restore")
    monkeypatch.setattr(base_mod, "place_on_device", _trap)
    monkeypatch.setattr(base_mod, "place_on_host", _trap)
    ckpt_mod.load_training_state(p, _zeros(tree), opt2)
    monkeypatch.undo()
    for k, bufs in opt2.opt_state.items():
        assert [b.data_ptr() for b in bufs] == ptrs[k]
        assert all(b.device.type == "cpu" for b in bufs)
    _opt_states_equal(opt, opt2)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------
def test_preemption_on_cadence_step_writes_once(tmp_path):
    """A notice on a cadence step waits on the save just scheduled: the
    loop of the ImageNet example writes steps 2 and 4 once each."""
    writes = []

    class CountingIO(ckpt_mod.CheckpointIO):
        def replace(self, tmp, path):
            writes.append(os.path.basename(path))
            super().replace(tmp, path)

    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    prev = ckpt_mod.set_io(CountingIO())
    try:
        with CheckpointManager(str(tmp_path), keep=3, every=2) as mgr, \
                PreemptionGuard(preempt_at_step=4) as guard:
            for step in range(1, 11):
                opt.step(g)
                saved_now = mgr.maybe_save(step, optimizer=opt)
                if guard.check(step):
                    if not saved_now:
                        mgr.save(step, optimizer=opt)
                    mgr.wait()
                    break
    finally:
        ckpt_mod.set_io(prev)
    assert step == 4 and guard.preempted
    assert mgr.steps_on_disk() == [2, 4]
    assert writes == ["step-2.ckpt", "step-4.ckpt"]


def test_preemption_guard_sigterm_surfaces_at_step_boundary():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.check(1)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not guard.preempted and time.time() < deadline:
            time.sleep(0.01)
        assert guard.check(2)
    assert signal.getsignal(signal.SIGTERM) == before


def test_preemption_guard_partial_install_rolls_back():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(signals=(signal.SIGTERM, -1))
    with pytest.raises(ValueError):
        guard.install()
    assert signal.getsignal(signal.SIGTERM) == before
    assert not guard._installed and not guard._old


def test_preemption_guard_at_step_deterministic():
    guard = PreemptionGuard(preempt_at_step=5)
    assert not guard.check(4)
    assert guard.check(5) and guard.check(6)


def test_preemption_guard_programmatic_notice():
    guard = PreemptionGuard()
    guard.notice()
    assert guard.check(1)


def test_preemption_guard_off_the_main_thread_warns_and_degrades():
    import threading
    out = {}

    def run():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            g = PreemptionGuard().install()
            out["w"] = [str(x.message) for x in w]
            out["installed"] = g._installed
            g.notice()
            out["check"] = g.check(1)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not out["installed"] and out["check"]
    assert any("main thread" in m for m in out["w"])


# ---------------------------------------------------------------------------
# last-known-good
# ---------------------------------------------------------------------------
def test_lkg_survives_rotation_and_manager_restart(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    with CheckpointManager(str(tmp_path), keep=2, every=2) as mgr:
        for step in range(1, 5):
            opt.step(g)
            mgr.maybe_save(step, optimizer=opt)
        mgr.wait()
        mgr.mark_good(2)
        for step in range(5, 11):
            opt.step(g)
            mgr.maybe_save(step, optimizer=opt)
        mgr.wait()
        assert 2 in mgr.steps_on_disk()
        assert mgr.steps_on_disk()[-2:] == [8, 10]
        assert mgr.lkg_step() == 2
    mgr2 = CheckpointManager(str(tmp_path), keep=2, every=2)
    assert mgr2.lkg_step() == 2
    mgr2.close()


def test_pin_exempts_from_rotation_until_unpinned(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    with CheckpointManager(str(tmp_path), keep=1, every=1) as mgr:
        opt.step(g)
        mgr.maybe_save(1, optimizer=opt)
        mgr.wait()
        mgr.pin(1)
        for step in (2, 3, 4):
            opt.step(g)
            mgr.maybe_save(step, optimizer=opt)
            mgr.wait()
        assert 1 in mgr.steps_on_disk()
        mgr.unpin(1)
        opt.step(g)
        mgr.maybe_save(5, optimizer=opt)
        mgr.wait()
        assert 1 not in mgr.steps_on_disk()


def test_restore_good_walks_from_lkg_not_newest(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    with CheckpointManager(str(tmp_path), keep=5, every=2) as mgr:
        snapshots = {}
        for step in range(1, 9):
            opt.step(g)
            if mgr.due(step):
                snapshots[step] = [b.clone() for b in opt._param_bufs]
            mgr.maybe_save(step, optimizer=opt)
        mgr.wait()
        mgr.mark_good(4)
        opt2 = FusedAdam(_mixed_tree(), lr=1e-2)
        out = mgr.restore_good(_zeros(tree), opt2)
        assert out is not None and out[2] == 4
        _eq(opt2._param_bufs, snapshots[4])


def test_restore_latest_max_step_filters_and_falls_back(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    g = _grads_for(tree)
    with CheckpointManager(str(tmp_path), keep=5, every=2) as mgr:
        for step in range(1, 9):
            opt.step(g)
            mgr.maybe_save(step, optimizer=opt)
        mgr.wait()
        p4 = mgr._path(4)
        open(p4, "wb").write(open(p4, "rb").read()[:30])
        opt2 = FusedAdam(_mixed_tree(), lr=1e-2)
        with pytest.warns(UserWarning, match="skipping"):
            out = mgr.restore_latest(_zeros(tree), opt2, max_step=4)
        assert out is not None and out[2] == 2


def test_restore_good_without_stamp_degrades_to_latest(tmp_path):
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    with CheckpointManager(str(tmp_path), keep=2, every=1) as mgr:
        opt.step(_grads_for(tree))
        mgr.maybe_save(1, optimizer=opt)
        mgr.wait()
        assert mgr.lkg_step() is None
        out = mgr.restore_good(_zeros(tree),
                               FusedAdam(_mixed_tree(), lr=1e-2))
        assert out is not None and out[2] == 1


def test_corrupt_restore_leaves_the_optimizer_untouched(tmp_path):
    """Every check of a file runs before the optimizer is written: a
    corrupt newest file changes nothing before the walk moves on."""
    tree = _mixed_tree()
    opt = FusedAdam(tree, lr=1e-2)
    opt.step(_grads_for(tree))
    p = str(tmp_path / "c.ckpt")
    ckpt_mod.save_training_state(p, optimizer=opt, step=1)
    raw = bytearray(open(p, "rb").read())
    raw[-3] ^= 0x40
    open(p, "wb").write(bytes(raw))
    opt2 = FusedAdam(_mixed_tree(), lr=1e-2)
    before = [b.clone() for b in opt2._param_bufs]
    with pytest.raises(ValueError, match="crc"):
        ckpt_mod.load_training_state(p, _zeros(tree), opt2)
    _eq(opt2._param_bufs, before)
    assert int(opt2.step_count) == 0
