"""``amp.initialize`` and the amp state.

The port of ``apex_tpu.amp.frontend``: :func:`initialize` takes a params
tree, returns the cast params plus an :class:`AmpState` carrying the
policy, the optional f32 masters and the loss-scaler state.  O2 casts
every float param to the half type (BatchNorm's scale and bias
included) and takes the masters from the ORIGINAL f32 values, not from
the rounded half params.  O1 leaves the params in f32, and
:meth:`AmpState.wrap_forward` runs the forward under the op-list
rewrite (:func:`apex_tpu_torch.amp.wrap.auto_cast`) in the half type
``initialize`` was given.  fp8 is not ported yet.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Tuple, Union

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.amp.policies import (Policy, Properties,
                                         opt_level_properties)
from apex_tpu_torch.amp.scaler import (LossScaleConfig, LossScaleState,
                                       update_state)
from apex_tpu_torch.amp.wrap import auto_cast, cast_inputs

Tree = Any


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


@dataclasses.dataclass
class AmpState:
    """Carried amp state: f32 masters (O2), the scaler, static config."""
    master_params: Optional[Tree]
    scaler: LossScaleState
    properties: Properties = dataclasses.field(default_factory=Properties)
    scaler_config: LossScaleConfig = dataclasses.field(
        default_factory=LossScaleConfig)
    half_dtype: Any = torch.bfloat16

    @property
    def policy(self) -> Policy:
        return self.properties.policy(self.half_dtype)

    def wrap_forward(self, fn, cast_argnums=None):
        """This opt level's casting applied to an unmodified forward: O1
        runs it under the op-list rewrite in the half type; O2/O3 cast
        the floating inputs (``cast_argnums``: the data args) to the
        model half dtype; O0 and disabled are the identity."""
        props = self.properties
        if not props.enabled:
            return fn
        if props.patch_torch_functions:
            return auto_cast(fn, self.policy)
        if props.cast_model_type is not None:
            return cast_inputs(fn, props.cast_model_type, cast_argnums)
        return fn

    def flat_pipeline(self, optimizer=None, plan=None,
                      max_grad_norm: float = 0.0, axis_name=None, **kw):
        """A :class:`~apex_tpu_torch.amp.flat_pipeline.FlatGradPipeline`
        for this state (pack once, one fused unscale+norm per bucket)."""
        from apex_tpu_torch.amp.flat_pipeline import FlatGradPipeline
        return FlatGradPipeline(optimizer=optimizer, plan=plan,
                                max_grad_norm=max_grad_norm,
                                axis_name=axis_name, **kw)

    # the reference's serialization contract: the loss scaler's scale and
    # unskipped count (host values: a host-facing, not a per-step, path)
    def state_dict(self):
        return {"loss_scaler0": {
            "loss_scale": float(self.scaler.loss_scale),
            "unskipped": int(self.scaler.growth_tracker)}}

    def load_state_dict(self, sd):
        entry = sd.get("loss_scaler0", {})
        dev = self.scaler.loss_scale.device
        return dataclasses.replace(self, scaler=LossScaleState(
            loss_scale=torch.full(
                (), entry.get("loss_scale", self.scaler_config.init_scale),
                dtype=torch.float32, device=dev),
            growth_tracker=torch.full((), entry.get("unskipped", 0),
                                      dtype=torch.int32, device=dev),
            found_inf=torch.zeros((), dtype=torch.int32, device=dev)))


def initialize(params: Tree, opt_level: str = "O1",
               half_dtype=torch.bfloat16, cast_model_type=None,
               keep_batchnorm_fp32=None, master_weights=None,
               loss_scale: Union[str, float, None] = None,
               enabled: bool = True, fp8=None, device=None
               ) -> Tuple[Tree, AmpState]:
    """Resolve an opt level, cast the params; returns
    ``(cast_params, amp_state)``.  Per-kwarg overrides beat the table.
    The scaler state lives on ``device`` (default: the params')."""
    if fp8 is not None and fp8 is not False:
        raise NotImplementedError(
            "amp fp8 is not ported yet: ROADMAP Queue 1, slice 6 item 17")
    props = opt_level_properties(opt_level, half_dtype)
    if cast_model_type is not None:
        props.cast_model_type = cast_model_type
    if keep_batchnorm_fp32 is not None:
        props.keep_batchnorm_fp32 = keep_batchnorm_fp32
    if master_weights is not None:
        props.master_weights = master_weights
    if loss_scale is not None:
        props.loss_scale = loss_scale
    props.enabled = enabled
    leaves = tree_leaves(params)
    if device is None:
        dev = leaves[0].device if leaves else resolve_device(None)
    else:
        dev = resolve_device(device)
    if not enabled:
        return params, AmpState(
            master_params=None, scaler=LossScaleState.create(1.0, dev),
            properties=props, scaler_config=LossScaleConfig(dynamic=False),
            half_dtype=half_dtype)

    masters = None
    cast_params = params
    if props.cast_model_type is not None:
        cast_params = tree_map(lambda x: x.to(props.cast_model_type)
                               if _is_float(x) else x, params)
        if props.master_weights:
            # from the ORIGINAL values: upcasting the rounded half params
            # would lose their low bits
            masters = tree_map(
                lambda x: x.detach().to(torch.float32, copy=True)
                if _is_float(x) else x, params)

    dynamic = props.loss_scale == "dynamic"
    init_scale = 2.0 ** 16 if dynamic else float(props.loss_scale)
    cfg = LossScaleConfig(init_scale=init_scale, dynamic=dynamic)
    return cast_params, AmpState(
        master_params=masters, scaler=LossScaleState.create(init_scale, dev),
        properties=props, scaler_config=cfg, half_dtype=half_dtype)


def master_params_to_model_params(model_params: Tree,
                                  master_params: Tree) -> Tree:
    """The O2 step tail: f32 masters cast back to the model dtypes."""
    return tree_map(lambda mp, m: m.to(mp.dtype), model_params,
                    master_params)


def update_scaler(state: AmpState, found_inf, skipped=None) -> AmpState:
    return dataclasses.replace(state, scaler=update_state(
        state.scaler, found_inf, state.scaler_config, skipped=skipped))


def state_dict(*states: AmpState) -> dict:
    """N amp states in the reference's multi-scaler layout
    (``loss_scaler0`` .. ``loss_scaler<N-1>``): one AmpState per loss
    plays the part of ``amp.initialize(..., num_losses=N)``."""
    return {f"loss_scaler{i}": s.state_dict()["loss_scaler0"]
            for i, s in enumerate(states)}


def load_state_dict(sd: dict, *states: AmpState):
    """The inverse of :func:`state_dict`: the restored states (one
    AmpState when one was passed, else a tuple in order).  Warns when the
    checkpoint's scaler count differs; an unmatched state keeps its
    config's initial scale."""
    saved = sum(1 for k in sd if k.startswith("loss_scaler"))
    if saved != len(states):
        warnings.warn(
            f"amp.load_state_dict: checkpoint has {saved} loss scaler(s) "
            f"but {len(states)} AmpState(s) were passed; unmatched "
            "states keep their initial scale", stacklevel=2)
    restored = tuple(
        s.load_state_dict({"loss_scaler0": sd.get(f"loss_scaler{i}", {})})
        for i, s in enumerate(states))
    return restored[0] if len(restored) == 1 else restored
