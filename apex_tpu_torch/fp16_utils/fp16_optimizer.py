"""FP16_Optimizer: the port of ``apex_tpu.fp16_utils.fp16_optimizer``
(the reference's legacy master-weights wrapper, older than amp).

Per step: scale the loss, take the gradients of the scaled loss, then
``step(scaled_grads)`` unscales them to f32, checks for overflow (one
bool read to the host), and either skips the step or steps the wrapped
optimizer; the loss scale updates either way:

    opt = FusedAdagrad(half_params, lr=...)
    fopt = FP16_Optimizer(opt, dynamic_loss_scale=True)
    grads = gradients of fopt.scale(loss_fn(params))
    params = fopt.step(grads)

The wrapped optimizer keeps the f32 masters of half params itself
(``FusedOptimizerBase``); this wrapper adds the legacy scaling and
skip surface around it.  Packed gradients (the optimizer plan's
per-bucket buffers) pass through the unscale as a list of buffers, so
``clip_master_grads`` on them is one ``flat_l2norm`` and one
``flat_scale`` per bucket.
"""

from __future__ import annotations

import torch

from apex_tpu_torch._tree import tree_map
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm
from apex_tpu_torch.fp16_utils.loss_scaler import (DynamicLossScaler,
                                                   LossScaler)


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=False):
        self.optimizer = init_optimizer
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.overflow = False
        self.verbose = verbose

    @property
    def loss_scale(self):
        return self.loss_scaler.loss_scale

    @property
    def params(self):
        return self.optimizer.params

    def scale(self, loss):
        """The loss times the current scale (use it inside the loss
        function; the reference's ``fp16_optimizer.backward(loss)``)."""
        return loss * self.loss_scaler.loss_scale

    # the reference's name for the same operation
    scale_loss = scale

    def step(self, scaled_grads, grad_scale_extra=1.0):
        """Unscale, check for overflow, step unless it overflowed; returns
        the params."""
        grads = tree_map(
            lambda g: (g.to(torch.float32)
                       / (self.loss_scaler.loss_scale * grad_scale_extra)),
            scaled_grads)
        self.overflow = self.loss_scaler.has_overflow(grads)
        if not self.overflow:
            self.optimizer.step(grads)
        elif self.verbose:
            print(f"OVERFLOW! Skipping step, scale {self.loss_scale}")
        self.loss_scaler.update_scale(self.overflow)
        return self.optimizer.params

    def clip_master_grads(self, grads, max_norm, norm_type=2.0):
        """Clip (already unscaled) f32 gradients; ``(clipped, norm)``."""
        return clip_grad_norm(grads, max_norm, norm_type)

    def zero_grad(self):
        self.optimizer.zero_grad()

    def state_dict(self):
        sd = {"optimizer": self.optimizer.state_dict(),
              "cur_scale": self.loss_scaler.cur_scale,
              "dynamic": isinstance(self.loss_scaler, DynamicLossScaler)}
        if sd["dynamic"]:
            # the growth window's clock (the reference checkpoints it too)
            sd["cur_iter"] = self.loss_scaler.cur_iter
            sd["last_overflow_iter"] = self.loss_scaler.last_overflow_iter
        return sd

    def load_state_dict(self, sd):
        self.optimizer.load_state_dict(sd["optimizer"])
        if sd.get("dynamic") and not isinstance(self.loss_scaler,
                                                DynamicLossScaler):
            self.loss_scaler = DynamicLossScaler(sd["cur_scale"])
        self.loss_scaler.cur_scale = sd["cur_scale"]
        if isinstance(self.loss_scaler, DynamicLossScaler):
            self.loss_scaler.cur_iter = sd.get("cur_iter", 0)
            self.loss_scaler.last_overflow_iter = sd.get(
                "last_overflow_iter", -1)
