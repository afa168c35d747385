"""The port's ImageNet trainer against the reference's training loop.

``apex_tpu_torch.examples.imagenet_main_amp.train`` runs 3 steps of a
narrow ResNet-18 (width 8, 10 classes, 64x64 inputs, batch 8, lr 0.01)
on the CPU; the same 3 steps run through the JAX package's public
pieces exactly as ``examples/imagenet/main_amp.py:126-170`` wires them
(``amp.initialize``, ``FusedSGD``, ``wrap_forward``, the per-leaf
``amp.scaled_value_and_grad`` or the flat pipeline's
``microbatches=N`` path with the BN candidates averaged,
``opt.step(found_inf=)``, ``amp.update_scaler``).  Both start from the
same numpy weights (the port's init) and see the same numpy batches, at
O0 and O2 with ``grad_accum`` 1 and 2.

Tolerances.  The first loss comes from identical weights: rtol 1e-5.
Each framework sums its convolutions in its own order and SGD carries
that on, so the later steps are held by how far the reference itself
moves when its f32 init changes by one ulp (measured on this config):
- O0: that moves the final params by under 1e-5 of the 3-step
  displacement, so the losses must agree within rtol 1e-5, the params'
  displacement (final minus init) within 1e-4 of its norm, the
  momentum buffers within 1e-4 and the running statistics within 1e-5
  (relative L2 norms);
- O2: bf16 params and grads round, and a last-bit change in a master
  flips some bf16 roundings: the one-ulp change moves the reference's
  final masters by 6-7e-2 of their displacement and its third loss by
  up to 2.7e-3.  So the losses agree within rtol 5e-3, the masters'
  displacement and the momentum within 0.2, the running statistics
  within 4e-3.
The loss scale and the step clock agree exactly; under O2 the bf16
params are exactly the bf16 cast of the masters.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import resnet18 as jresnet18
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu_torch import _build
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.examples import imagenet_main_amp as main_amp
from apex_tpu_torch.models import resnet18

KW = dict(num_classes=10, width=8)
BATCH, SIZE, STEPS = 8, 64, 3
HYPERS = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)
# opt_level: (loss rtol, displacement and momentum, running statistics)
TOL = {"O0": (1e-5, 1e-4, 1e-5), "O2": (5e-3, 0.2, 4e-3)}


def _data():
    return list(main_amp.synthetic_batches(BATCH, SIZE, STEPS,
                                           num_classes=KW["num_classes"]))


def _jax_trajectory(tp, ts, opt_level, grad_accum, data, kw=KW, model=None):
    """examples/imagenet/main_amp.py:126-170 with the JAX package (the
    flax ``model``, ResNet-18 with ``kw`` by default)."""
    model = model if model is not None else jresnet18(**kw)
    params = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    batch_stats = tree_map(lambda t: jnp.asarray(t.numpy()), ts)
    params, amp_state = jamp.initialize(params, opt_level=opt_level)
    opt = JSGD(params, master_weights=bool(
        amp_state.properties.master_weights),
        masters=amp_state.master_params, **HYPERS)

    def loss_fn(p, bs, x, y):
        out, updates = model.apply({"params": p, "batch_stats": bs}, x,
                                   train=True, mutable=["batch_stats"])
        logits = out.astype(jnp.float32)
        ll = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None],
                                  axis=1)
        return jnp.mean(ll), updates["batch_stats"]

    wrapped_loss = amp_state.wrap_forward(loss_fn, cast_argnums=(2,))
    if grad_accum > 1:
        pipe = amp_state.flat_pipeline(optimizer=opt)

        def train_step(p, bs, scaler, x, y):
            def loss_bs(pp, xx, yy):
                return wrapped_loss(pp, bs, xx, yy)

            (loss, new_bs), flat = pipe.scaled_value_and_grad(
                loss_bs, scaler, p, x, y, has_aux=True,
                microbatches=grad_accum)
            new_bs = jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0),
                                            new_bs)
            return loss, flat, new_bs, flat.found_inf
    else:
        def train_step(p, bs, scaler, x, y):
            (loss, new_bs), grads, found_inf = jamp.scaled_value_and_grad(
                wrapped_loss, scaler, p, bs, x, y, has_aux=True)
            return loss, grads, new_bs, found_inf

    jstep = jax.jit(train_step)
    losses = []
    for x, y in data:
        loss, grads, batch_stats, found_inf = jstep(
            opt.params, batch_stats, amp_state.scaler, jnp.asarray(x),
            jnp.asarray(y))
        opt.step(grads, found_inf=found_inf)
        amp_state = jamp.update_scaler(amp_state, found_inf)
        losses.append(float(loss))
    return losses, opt, amp_state, batch_stats


def _f32_leaves(tree):
    return [l.float().numpy() if isinstance(l, torch.Tensor)
            else np.asarray(jnp.asarray(l).astype(jnp.float32))
            for l in tree_leaves(tree)]


def _rel(got, want, origin=None):
    """||got - want|| / ||want - origin|| over all leaves (L2)."""
    got, want = _f32_leaves(got), _f32_leaves(want)
    origin = (_f32_leaves(origin) if origin is not None
              else [np.zeros_like(w) for w in want])
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float(((b - o) ** 2).sum()) for b, o in zip(want, origin))
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_step_trajectory_follows_jax(opt_level, grad_accum):
    loss_rtol, disp_tol, stat_tol = TOL[opt_level]
    tp, ts = resnet18(**KW).init(7, "cpu")
    data = _data()
    res = main_amp.train(arch="resnet18", opt_level=opt_level, batch=BATCH,
                         image=SIZE, steps=STEPS, grad_accum=grad_accum,
                         device="cpu", log=None, variables=(tp, ts),
                         data=data, **KW, **HYPERS)
    jlosses, jopt, jst, jbs = _jax_trajectory(tp, ts, opt_level,
                                              grad_accum, data)
    assert len(res.losses) == STEPS and all(np.isfinite(res.losses))
    np.testing.assert_allclose(res.losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(res.losses, jlosses, rtol=loss_rtol)
    assert int(res.opt.step_count) == int(jopt.step_count) == STEPS
    assert float(res.amp_state.scaler.loss_scale) == \
        float(jst.scaler.loss_scale)
    if opt_level == "O2":
        assert _rel(res.opt.masters, jopt.masters, tp) <= disp_tol
        for t, m in zip(tree_leaves(res.opt.params),
                        tree_leaves(res.opt.masters)):
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, m.to(torch.bfloat16))
    else:
        assert _rel(res.opt.params, jopt.params, tp) <= disp_tol
    assert _rel(res.opt.state_dict()["state"],
                jopt.state_dict()["state"]) <= disp_tol
    assert _rel(res.batch_stats, jbs) <= stat_tol


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_runs_the_plain_twins_on_the_cpu(grad_accum):
    """On the CPU the flat kernels' plain twins run and no kernel
    launches (nothing is built: there is no nvcc here)."""
    _build.reset_launch_counts()
    res = main_amp.train(arch="resnet18", opt_level="O2", batch=4,
                         image=SIZE, steps=2, grad_accum=grad_accum,
                         device="cpu", log=None, **KW)
    assert all(k.launches == 0 for k in _build.KERNELS)
    assert all(np.isfinite(res.losses)) and len(res.losses) == 2
    assert res.imgs_per_sec is not None and res.imgs_per_sec > 0


def test_main_parses_the_reference_flags_and_names_what_waits(capsys):
    res = main_amp.main(["--arch", "resnet18", "--opt-level", "O0",
                         "--batch-size", "4", "--image-size", "32",
                         "--steps", "2", "--grad-accum", "2",
                         "--device", "cpu"])
    assert len(res.losses) == 2
    assert "throughput" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main_amp.main(["--ddp", "--device", "cpu"])
    # the checkpoint flags run (tests/torch_port/
    # test_torch_port_checkpoint.py); a notice with nowhere to save fails
    with pytest.raises(ValueError, match="--checkpoint-dir"):
        main_amp.main(["--preempt-at-step", "3", "--device", "cpu"])
    # --opt-level O1 trains under the op-list rewrite: its first loss is
    # the reference's on the same init and batch within rtol 3e-4
    # (measured 1.0e-4; the same step in f32, O0, reads 5.7e-4)
    res = main_amp.main(["--arch", "resnet18", "--opt-level", "O1",
                         "--device", "cpu", "--batch-size", "4",
                         "--image-size", "64", "--steps", "1"])
    kw = dict(num_classes=1000, width=64)
    tp, ts = resnet18(**kw).init(0, "cpu")
    data = list(main_amp.synthetic_batches(4, 64, 1, num_classes=1000))
    jl, _, _, _ = _jax_trajectory(tp, ts, "O1", 1, data, kw=kw)
    np.testing.assert_allclose(res.losses, jl, rtol=3e-4)


def test_main_runs_sync_bn_at_world_size_one(capsys):
    """``--sync-bn`` without ``--ddp`` trains ResNet with SyncBatchNorm
    norms on their local statistics (one process)."""
    res = main_amp.main(["--sync-bn", "--arch", "resnet18", "--opt-level",
                         "O2", "--batch-size", "4", "--image-size", "32",
                         "--steps", "2", "--grad-accum", "2", "--device",
                         "cpu"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert "sync-bn" in capsys.readouterr().out
    assert sorted(res.batch_stats["SyncBatchNorm_0"]) == ["running_mean",
                                                          "running_var"]
    assert "SyncBatchNorm_1" in res.opt.params["BasicBlock_0"]
    assert not any("BatchNorm_0" == k for k in res.batch_stats)


TRAINING_MODULES = [
    "apex_tpu_torch._tree", "apex_tpu_torch.convert",
    "apex_tpu_torch.amp.flat_pipeline", "apex_tpu_torch.amp.frontend",
    "apex_tpu_torch.amp.lists", "apex_tpu_torch.amp.policies",
    "apex_tpu_torch.amp.scaler", "apex_tpu_torch.amp.wrap",
    "apex_tpu_torch.examples.dcgan_main_amp", "apex_tpu_torch.offload",
    "apex_tpu_torch.data", "apex_tpu_torch.examples.imagenet_main_amp",
    "apex_tpu_torch.models.resnet",
    "apex_tpu_torch.multi_tensor_apply.packer",
    "apex_tpu_torch.ops.multi_tensor", "apex_tpu_torch.ops.welford",
    "apex_tpu_torch.optimizers._base", "apex_tpu_torch.optimizers.fused_sgd",
    "apex_tpu_torch.parallel", "apex_tpu_torch.parallel.sync_batchnorm"]
PACKAGES = {"apex_tpu_torch.parallel"}        # checked at their __init__


@pytest.mark.parametrize("path", [
    m.replace(".", "/") + ("/__init__.py" if m in PACKAGES else ".py")
    for m in TRAINING_MODULES] + ["chip_smoke.py"])
def test_training_modules_and_chip_smoke_import_no_jax(path):
    """The training path's modules and chip_smoke.py name neither jax
    nor the JAX package in any import (the fresh-interpreter check of
    the whole package is in test_torch_port_serving.py)."""
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
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "flax", "apex_tpu")]
