"""Legacy loss scalers: the port of ``apex_tpu.fp16_utils.loss_scaler``
(the reference's ``LossScaler`` (static) and ``DynamicLossScaler``, the
pre-amp API).  The scale is a host float; ``has_overflow`` reads ONE
bool back to the host (one device reduction over every leaf), as the
reference does."""

from __future__ import annotations

import torch

from apex_tpu_torch._tree import tree_leaves, tree_map


def _has_overflow(grads) -> bool:
    leaves = [g for g in tree_leaves(grads)
              if isinstance(g, torch.Tensor) and g.is_floating_point()]
    if not leaves:
        return False
    ok = torch.stack([torch.isfinite(g).all() for g in leaves])
    return not bool(ok.all())


class LossScaler:
    """A static scale; ``has_overflow`` is always False (the reference's
    behaviour)."""

    def __init__(self, scale=1.0):
        self.cur_scale = float(scale)

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_loss(self, loss):
        return loss * self.cur_scale

    def unscale(self, grads):
        inv = 1.0 / self.cur_scale
        return tree_map(lambda g: g * inv, grads)

    def has_overflow(self, grads):
        return False

    def update_scale(self, overflow):
        pass


class DynamicLossScaler(LossScaler):
    """Halve (``/ scale_factor``, not below 1) on an overflow; double
    after ``scale_window`` clean steps.  The reference's defaults (an
    initial 2**32 included)."""

    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0,
                 scale_window=1000):
        super().__init__(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.last_overflow_iter = -1
        self.cur_iter = 0

    def has_overflow(self, grads):
        return _has_overflow(grads)

    def update_scale(self, overflow):
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) % \
                self.scale_window == 0:
            # the reference grows whenever the window condition holds:
            # with scale_window=1 that includes the first clean step
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1
