"""apex_tpu_torch.checkpoint and its native helpers against apex_tpu's.

The port's counterparts of tests/test_native_checkpoint.py, then files
moving both ways between the two packages (v1 and v2; FusedSGD with
momentum and FusedAdam at amp O2), a resumed optimizer and a resumed run
of the ImageNet example against uninterrupted ones.

Tolerances: none.  A checkpoint moves bytes, so every leaf, state field,
step count and amp dict that comes back is compared bit for bit, and a
resumed run must give the uninterrupted run's bits (both runs execute the
same plain CPU steps in the same order).  The files' own checks are the
reference's: payload crc32 exactly, the f32 L2 checksum at rtol 1e-6.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import checkpoint as jckpt
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu_torch import _native
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import checkpoint
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD


def _bits(x) -> np.ndarray:
    """The raw bytes of a torch or JAX leaf (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy()
    a = np.asarray(x)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _assert_bits(a, b):
    # the port's flatten order is JAX's, so it walks JAX trees too
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# the native helpers
# ---------------------------------------------------------------------------
def test_native_library_builds():
    # g++ is part of this image; the build must succeed here
    assert _native.available(), _native.load_error


def test_host_flatten_unflatten_roundtrip():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((17, 5)).astype(np.float32),
              rng.standard_normal(3),
              np.arange(10, dtype=np.int32),
              rng.standard_normal((2, 2, 2)).astype(np.float16)]
    flat = _native.host_flatten(arrays)
    assert flat.nbytes == sum(a.nbytes for a in arrays)
    back = _native.host_unflatten(flat, arrays)
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == a.dtype


def test_host_flatten_matches_numpy_fallback(monkeypatch):
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(100).astype(np.float32) for _ in range(7)]
    flat = _native.host_flatten(arrays)
    want = np.concatenate([a.view(np.uint8) for a in arrays])
    np.testing.assert_array_equal(flat, want)
    monkeypatch.setattr(_native, "lib", lambda: None)
    np.testing.assert_array_equal(_native.host_flatten(arrays), want)
    for a, b in zip(arrays, _native.host_unflatten(want, arrays)):
        np.testing.assert_array_equal(a, b)


def test_host_library_is_keyed_on_its_source_and_failures_raise(
        monkeypatch, tmp_path):
    """The g++ route of _build: the library's name follows a hash of the
    .cpp source; a source that does not compile raises and publishes
    nothing; _native then runs its NumPy fallbacks and says why."""
    from apex_tpu_torch import _build
    (tmp_path / "k.cpp").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    first = _build._lib_path("k", host=True)
    (tmp_path / "k.cpp").write_text("// v2\n")
    assert _build._lib_path("k", host=True) != first
    (tmp_path / "apex_c.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on apex_c.cpp"):
        _build.host_library("apex_c")
    assert not (tmp_path / "_build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "_build").iterdir())
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    assert not _native.available()
    assert "g++ failed" in _native.load_error
    a = [np.arange(5, dtype=np.int32)]
    np.testing.assert_array_equal(
        _native.host_unflatten(_native.host_flatten(a), a)[0], a[0])


def test_host_l2norm():
    x = np.random.default_rng(2).standard_normal(100000).astype(np.float32)
    np.testing.assert_allclose(_native.host_l2norm(x),
                               np.linalg.norm(x.astype(np.float64)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# v1 files (tests/test_native_checkpoint.py)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    p = str(tmp_path / "ckpt.apex")
    checkpoint.save_checkpoint(p, tree, {"note": "hi"})
    back, meta = checkpoint.load_checkpoint(p, tree)
    assert meta["note"] == "hi"
    _assert_bits(back, tree)
    assert back["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.ones(64)}
    p = str(tmp_path / "ckpt.apex")
    checkpoint.save_checkpoint(p, tree)
    raw = bytearray(open(p, "rb").read())
    raw[-16:-12] = b"\xff\xff\xff\xff"    # clobber one float (NaN)
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc|checksum"):
        checkpoint.load_checkpoint(p, tree)


def test_checkpoint_wrong_template_rejected(tmp_path):
    tree = {"a": torch.ones(4), "b": torch.ones(4)}
    p = str(tmp_path / "ckpt.apex")
    checkpoint.save_checkpoint(p, tree)
    with pytest.raises(checkpoint.TemplateMismatchError, match="leaves"):
        checkpoint.load_checkpoint(p, {"a": torch.ones(4)})
    with pytest.raises(checkpoint.TemplateMismatchError, match="leaf 1"):
        checkpoint.load_checkpoint(p, {"a": torch.ones(4),
                                       "b": torch.ones(4, dtype=torch.int32)})


def test_training_state_resume_continues_identically(tmp_path):
    """Save mid-training, restore into a fresh optimizer: training
    continues bit for bit (both formats)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((16, 4))
                                    .astype(np.float32))}
    grads = [{"w": torch.from_numpy(rng.standard_normal((16, 4))
                                    .astype(np.float32) * 0.1)}
             for _ in range(6)]
    for fmt in ("v1", "v2"):
        opt = FusedAdam(params, lr=1e-2)
        for g in grads[:3]:
            opt.step(g)
        p = str(tmp_path / f"train-{fmt}.apex")
        checkpoint.save_training_state(p, optimizer=opt, step=3,
                                       amp_state={"loss_scale": 1024.0},
                                       format=fmt)
        for g in grads[3:]:
            ref = {k: v.clone() for k, v in opt.step(g).items()}
        opt2 = FusedAdam(params, lr=1e-2)
        _, amp_state, step = checkpoint.load_training_state(
            p, tree_map(torch.zeros_like, params), opt2)
        assert step == 3 and amp_state["loss_scale"] == 1024.0
        for g in grads[3:]:
            got = opt2.step(g)
        _assert_bits(got, ref)


def test_truncated_checkpoint_rejected(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "step": torch.tensor(7, dtype=torch.int32)}
    p = str(tmp_path / "c.ckpt")
    checkpoint.save_checkpoint(p, tree)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-16])          # chop the tail
    with pytest.raises(ValueError, match="truncated|bytes"):
        checkpoint.load_checkpoint(p, tree)


def test_integer_leaf_corruption_detected(tmp_path):
    tree = {"w": torch.ones(4), "step": torch.arange(16, dtype=torch.int32)}
    p = str(tmp_path / "c.ckpt")
    checkpoint.save_checkpoint(p, tree)
    data = bytearray(open(p, "rb").read())
    data[-2] ^= 0xFF                         # a byte of an int leaf
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc|checksum"):
        checkpoint.load_checkpoint(p, tree)


def test_async_checkpointer_round_trip(tmp_path):
    tree = {"w": torch.arange(32, dtype=torch.float32),
            "b": torch.ones(4, dtype=torch.bfloat16)}
    p = str(tmp_path / "a.ckpt")
    with checkpoint.AsyncCheckpointer() as ac:
        ac.save(p, tree, metadata={"step": 3})
        ac.wait_until_finished()
        got, meta = checkpoint.load_checkpoint(p, tree)
    assert meta["step"] == 3
    _assert_bits(got, tree)


def test_async_checkpointer_training_state_consistent(tmp_path):
    """The file holds the step at save() time while the optimizer keeps
    stepping (in place) during the write."""
    params = {"w": torch.ones(128)}
    opt = FusedSGD(params, lr=0.1, momentum=0.9)
    g = {"w": torch.full((128,), 0.01)}
    opt.step(g)
    p = str(tmp_path / "t.ckpt")
    with checkpoint.AsyncCheckpointer() as ac:
        ac.save_training_state(p, opt.params, opt, step=1)
        w_at_save = opt.params["w"].clone()
        for _ in range(5):
            opt.step(g)
        ac.wait_until_finished()
    opt2 = FusedSGD({"w": torch.zeros(128)}, lr=0.1, momentum=0.9)
    restored, _, step = checkpoint.load_training_state(
        p, {"w": torch.zeros(128)}, opt2)
    assert step == 1
    _assert_bits(restored, {"w": w_at_save})


def test_async_checkpointer_propagates_worker_errors(tmp_path):
    ac = checkpoint.AsyncCheckpointer()
    ac.save(str(tmp_path / "no" / "such" / "dir" / "x.ckpt"),
            {"w": torch.ones(2)})
    with pytest.raises(FileNotFoundError):
        ac.wait_until_finished()
    ac.close()


def test_async_checkpointer_survives_in_place_writes(tmp_path):
    """The caller may overwrite the saved tensors at once (the port's
    counterpart of the reference's buffer donation): the default leaf
    copy keeps the snapshot."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    p = str(tmp_path / "d.ckpt")
    with checkpoint.AsyncCheckpointer() as ac:
        ac.save(p, {"w": w}, metadata={"step": 4})
        w.zero_()
        ac.wait_until_finished()
    got, meta = checkpoint.load_checkpoint(p, {"w": torch.zeros(1 << 16)})
    assert meta["step"] == 4
    assert float(got["w"][-1]) == float((1 << 16) - 1)


def test_async_checkpointer_empty_metadata_not_torn(tmp_path):
    md = {}
    p = str(tmp_path / "m.ckpt")
    with checkpoint.AsyncCheckpointer() as ac:
        ac.save(p, {"w": torch.ones(1 << 20)}, metadata=md)
        md["late"] = True          # the caller mutates after submit
        ac.wait_until_finished()
    _, meta = checkpoint.load_checkpoint(p, {"w": torch.ones(1 << 20)})
    assert meta == {}


def test_header_and_publish_are_the_references(tmp_path):
    """The container: 8 bytes of header length, the JSON header, the
    payload; no .tmp left; the treedef string as JAX prints it."""
    tree = {"b": [torch.ones(2), None], "a": (torch.zeros(3),)}
    p = str(tmp_path / "h.ckpt")
    n = checkpoint.save_checkpoint(p, tree, {"k": 1})
    assert n == os.path.getsize(p) and not os.path.exists(p + ".tmp")
    h = checkpoint.read_checkpoint_header(p)
    jtree = {"b": [jnp.ones(2), None], "a": (jnp.zeros(3),)}
    assert h["treedef"] == str(jax.tree_util.tree_structure(jtree))
    assert h["shapes"] == [[3], [2]] and h["dtypes"] == ["float32"] * 2


# ---------------------------------------------------------------------------
# files across the two packages
# ---------------------------------------------------------------------------
def _mixed_np():
    rng = np.random.default_rng(5)
    return {"w1": rng.standard_normal((16, 16)).astype(np.float32),
            "b1": rng.standard_normal(16).astype(np.float32),
            "w2": rng.standard_normal((8, 8)).astype(np.float32),
            "s": rng.standard_normal(3).astype(np.float32)}


def _grads_np(k):
    rng = np.random.default_rng(100 + k)
    return {n: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            for n, a in _mixed_np().items()}


OPTS = {"sgd": (FusedSGD, JSGD, dict(lr=0.1, momentum=0.9,
                                     weight_decay=1e-4)),
        "adam": (FusedAdam, JAdam, dict(lr=1e-2, weight_decay=0.01))}


def _port_opt(kind, steps=2):
    cls, _, kw = OPTS[kind]
    params, st = tamp.initialize(
        {k: torch.from_numpy(v) for k, v in _mixed_np().items()},
        opt_level="O2", device="cpu")
    opt = cls(params, masters=st.master_params, **kw)
    for k in range(steps):
        opt.step({n: torch.from_numpy(v).to(torch.bfloat16)
                  for n, v in _grads_np(k).items()})
    return opt, st


def _jax_opt(kind, steps=2):
    _, cls, kw = OPTS[kind]
    params, st = jamp.initialize({k: jnp.asarray(v)
                                  for k, v in _mixed_np().items()},
                                 opt_level="O2")
    opt = cls(params, masters=st.master_params, **kw)
    for k in range(steps):
        opt.step({n: jnp.asarray(v).astype(jnp.bfloat16)
                  for n, v in _grads_np(k).items()})
    return opt, st


def _extra_np():
    return {"bn": {"mean": np.arange(4.0, dtype=np.float32),
                   "var": np.full(4, 2.0, np.float32)}}


def _same_state(port_opt, jax_opt):
    """Every leaf, state field, the masters and the step, bit for bit."""
    ps, js = port_opt.state_dict(), jax_opt.state_dict()
    assert ps["step"] == int(js["step"])
    assert sorted(ps["state"]) == sorted(js["state"])
    for k in ps["state"]:
        _assert_bits(ps["state"][k], js["state"][k])
    _assert_bits(ps["masters"], js["masters"])
    _assert_bits(port_opt.params, jax_opt.params)


@pytest.mark.parametrize("fmt", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_reference_file_loads_in_the_port(tmp_path, kind, fmt):
    jopt, jst = _jax_opt(kind)
    amp_sd = jst.state_dict()
    p = str(tmp_path / f"{kind}.{fmt}")
    jckpt.save_training_state(
        p, optimizer=jopt, amp_state=amp_sd, step=2,
        extra={k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _extra_np().items()}, format=fmt)
    fresh, _ = _port_opt(kind, steps=0)
    like = tree_map(torch.zeros_like, fresh.params)
    extra_like = {"bn": {"mean": torch.zeros(4), "var": torch.zeros(4)}}
    params, got_amp, step, extra = checkpoint.load_training_state(
        p, like, fresh, extra_like=extra_like)
    assert step == 2 and got_amp == amp_sd
    _same_state(fresh, jopt)
    _assert_bits(params, jopt.params)
    _assert_bits(extra, {k: {n: torch.from_numpy(a) for n, a in v.items()}
                         for k, v in _extra_np().items()})


@pytest.mark.parametrize("fmt", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_port_file_loads_in_the_reference(tmp_path, kind, fmt):
    topt, tst = _port_opt(kind)
    amp_sd = tst.state_dict()
    p = str(tmp_path / f"{kind}.{fmt}")
    checkpoint.save_training_state(
        p, optimizer=topt, amp_state=amp_sd, step=2,
        extra={k: {n: torch.from_numpy(a) for n, a in v.items()}
               for k, v in _extra_np().items()}, format=fmt)
    fresh, _ = _jax_opt(kind, steps=0)
    like = jax.tree_util.tree_map(jnp.zeros_like, fresh.params)
    extra_like = {"bn": {"mean": jnp.zeros(4), "var": jnp.zeros(4)}}
    params, got_amp, step, extra = jckpt.load_training_state(
        p, like, fresh, extra_like=extra_like)
    assert step == 2 and got_amp == amp_sd
    _same_state(topt, fresh)
    _assert_bits(topt.params, params)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(extra["bn"][k]),
                                      _extra_np()["bn"][k])


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_v2_plan_docs_of_both_sides_are_equal(tmp_path, kind):
    topt, _ = _port_opt(kind, steps=1)
    jopt, _ = _jax_opt(kind, steps=1)
    assert topt._plan.layout() == jopt._plan.layout()
    pt, pj = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    checkpoint.save_training_state(pt, optimizer=topt, step=1)
    jckpt.save_training_state(pj, optimizer=jopt, step=1)
    ht = checkpoint.read_checkpoint_header(pt)
    hj = jckpt.read_checkpoint_header(pj)
    assert ht["magic"] == hj["magic"] == "APEX_TPU_CKPT_V2"
    assert ht["plan"] == hj["plan"]
    assert ht["sections"] == hj["sections"]
    assert ht["payload_bytes"] == hj["payload_bytes"]


# ---------------------------------------------------------------------------
# the ImageNet example, preempted and resumed
# ---------------------------------------------------------------------------
KW = dict(num_classes=10, width=8)
RUN = dict(arch="resnet_stage1", opt_level="O2", batch=4, image=32,
           device="cpu", log=None, **KW)


@pytest.fixture
def main_amp():
    from apex_tpu_torch.examples import imagenet_main_amp as main_amp
    from apex_tpu_torch.models.resnet import ResNet
    main_amp.ARCHS["resnet_stage1"] = \
        lambda **kw: ResNet((1,), "BasicBlock", **kw)
    yield main_amp
    del main_amp.ARCHS["resnet_stage1"]


def _final(res):
    return {"params": res.opt.params, "masters": res.opt.masters,
            "state": res.opt.state_dict()["state"],
            "stats": res.batch_stats,
            "scale": res.amp_state.scaler.loss_scale,
            "tracker": res.amp_state.scaler.growth_tracker,
            "step": res.opt.step_count}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_imagenet_preempted_and_resumed_gives_the_uninterrupted_bits(
        tmp_path, main_amp, grad_accum):
    want = main_amp.train(steps=8, grad_accum=grad_accum, **RUN)
    d = str(tmp_path / "ckpts")
    cut = main_amp.train(steps=8, grad_accum=grad_accum, checkpoint_dir=d,
                         save_every=2, preempt_at_step=4, **RUN)
    assert cut.preempted and len(cut.losses) == 4
    assert sorted(os.listdir(d)) == ["step-2.ckpt", "step-4.ckpt"]
    # the same command again: the notice at step 4 is spent
    got = main_amp.train(steps=8, grad_accum=grad_accum, checkpoint_dir=d,
                         save_every=2, preempt_at_step=4, **RUN)
    assert got.start_step == 4 and len(got.losses) == 4
    assert not got.preempted
    assert got.losses == want.losses[4:]
    _assert_bits(_final(got), _final(want))
    assert int(got.opt.step_count) == 8


def test_imagenet_v1_checkpoint_resumes_bit_for_bit(tmp_path, main_amp):
    want = main_amp.train(steps=8, **RUN)
    f = str(tmp_path / "one.ckpt")
    main_amp.train(steps=4, checkpoint=f, **RUN)
    assert checkpoint.read_checkpoint_header(f)["magic"] == \
        "APEX_TPU_CKPT_V1"
    got = main_amp.train(steps=8, checkpoint=f, **RUN)
    assert got.start_step == 4
    _assert_bits(_final(got), _final(want))
    assert checkpoint.read_checkpoint_header(f)["metadata"]["step"] == 8


def test_imagenet_restored_state_is_the_saved_state(tmp_path, main_amp):
    """At step 3 the resumed run sees other batches than the
    uninterrupted one (the reference's pool restarts), so what holds
    there is: the state restored equals the state saved, bit for bit."""
    d = str(tmp_path / "ckpts")
    cut = main_amp.train(steps=8, checkpoint_dir=d, save_every=2,
                         preempt_at_step=3, **RUN)
    assert cut.preempted and int(cut.opt.step_count) == 3
    got = main_amp.train(steps=3, checkpoint_dir=d, **RUN)
    assert got.start_step == 3 and got.losses == []
    _assert_bits(_final(got), _final(cut))


def test_imagenet_main_takes_the_checkpoint_flags(tmp_path, main_amp,
                                                  capsys):
    d = str(tmp_path / "ckpts")
    argv = ["--arch", "resnet18", "--batch-size", "2", "--image-size", "32",
            "--steps", "3", "--checkpoint-dir", d, "--save-every", "2",
            "--device", "cpu"]
    res = main_amp.main(argv + ["--preempt-at-step", "1"])
    out = capsys.readouterr().out
    assert res.preempted
    assert "preempted: final checkpoint durable at step 1" in out
    res = main_amp.main(argv)
    out = capsys.readouterr().out
    assert "resumed at step 1 scale" in out and res.start_step == 1
    assert f"checkpointed to {d} (step 3)" in out
    with pytest.raises(ValueError, match="checkpoint-dir"):
        main_amp.main(["--preempt-at-step", "2", "--device", "cpu"])


def test_save_blocks_on_a_slow_disk_not_the_step(tmp_path):
    """The async double buffer on the CPU: a CheckpointIO whose
    write_array blocks until the test has taken one more in-place step.
    The file still holds the values from before that step."""
    opt, _ = _port_opt("adam", steps=1)
    want = {"params": [b.clone() for b in opt._param_bufs],
            "state": {k: [b.clone() for b in v]
                      for k, v in opt.opt_state.items()}}
    stepped = threading.Event()

    class SlowIO(checkpoint.CheckpointIO):
        def write_array(self, f, arr):
            assert stepped.wait(30)
            super().write_array(f, arr)

    prev = checkpoint.set_io(SlowIO())
    try:
        p = str(tmp_path / "slow.ckpt")
        with checkpoint.AsyncCheckpointer() as ac:
            ac.save_training_state(p, optimizer=opt, step=1)
            opt.step({n: torch.from_numpy(v).to(torch.bfloat16)
                      for n, v in _grads_np(7).items()})
            stepped.set()
    finally:
        checkpoint.set_io(prev)
    assert not torch.equal(opt._param_bufs[0], want["params"][0])
    fresh, _ = _port_opt("adam", steps=0)
    checkpoint.load_training_state(p, tree_map(torch.zeros_like,
                                               fresh.params), fresh)
    _assert_bits(fresh._param_bufs, want["params"])
    for k in want["state"]:
        _assert_bits(fresh.opt_state[k], want["state"][k])


@pytest.mark.parametrize("path", [
    "apex_tpu_torch/_native.py", "apex_tpu_torch/_build.py",
    "apex_tpu_torch/checkpoint.py", "apex_tpu_torch/resilience/__init__.py",
    "apex_tpu_torch/resilience/manager.py",
    "apex_tpu_torch/resilience/preemption.py",
    "apex_tpu_torch/optimizers/_base.py", "apex_tpu_torch/data.py",
    "apex_tpu_torch/examples/imagenet_main_amp.py",
    "apex_tpu_torch/examples/bert_pretrain_mlm.py"])
def test_checkpoint_modules_import_neither_jax_nor_ml_dtypes(path):
    """The card's machine has numpy but neither JAX nor its dtype
    package: the checkpoint path names none of them in any import."""
    import ast
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert names
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "apex_tpu", "ml_dtypes")]
