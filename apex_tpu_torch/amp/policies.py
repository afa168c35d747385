"""Precision policies: the O0-O3 opt-level tables and the dtype
:class:`Policy` each resolves to.

The port of ``apex_tpu.amp.policies``: the same tables, with torch
dtypes.  O1 keeps the params in f32 and computes the listed ops in the
half type (:mod:`apex_tpu_torch.amp.wrap`).  bf16 is the half type, so O2's loss scale defaults to a static
1.0 (fp16 is still selectable through ``half_dtype``, and then O1/O2
default to dynamic scaling).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

Dtype = Any


@dataclasses.dataclass(frozen=True)
class Policy:
    """The dtypes an opt level computes with: params stored in
    ``param_dtype`` (f32 masters when ``master_weights``), listed ops in
    ``compute_dtype``, outputs in ``output_dtype``."""
    param_dtype: Dtype = torch.float32
    compute_dtype: Dtype = torch.float32
    output_dtype: Dtype = torch.float32
    master_weights: bool = False
    keep_norm_fp32: bool = True


@dataclasses.dataclass
class Properties:
    """The reference's option bundle (``apex/amp/frontend.py``)."""
    opt_level: str = "O0"
    cast_model_type: Optional[Dtype] = None
    patch_torch_functions: bool = False
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Union[str, float] = 1.0
    enabled: bool = True
    fp8: Optional[Any] = None

    def policy(self, half_dtype: Dtype = torch.bfloat16) -> Policy:
        f32 = torch.float32
        if self.opt_level == "O0":
            return Policy(f32, f32, f32, master_weights=False)
        if self.opt_level == "O1":
            # params stay f32; the listed ops compute in the half type
            return Policy(f32, half_dtype, f32, master_weights=False)
        if self.opt_level == "O2":
            return Policy(half_dtype, half_dtype, f32, master_weights=True,
                          keep_norm_fp32=bool(self.keep_batchnorm_fp32))
        if self.opt_level == "O3":
            return Policy(half_dtype, half_dtype, half_dtype,
                          master_weights=False, keep_norm_fp32=False)
        raise ValueError(f"unknown opt_level {self.opt_level!r}")


def opt_level_properties(opt_level: str,
                         half_dtype: Dtype = torch.bfloat16) -> Properties:
    """The reference's O0..O3 defaults."""
    fp16_like = half_dtype == torch.float16
    default_dynamic = "dynamic" if fp16_like else 1.0
    tables = {
        "O0": Properties("O0", None, False, None, False, 1.0),
        "O1": Properties("O1", None, True, None, None, default_dynamic),
        "O2": Properties("O2", half_dtype, False, True, True,
                         "dynamic" if fp16_like else default_dynamic),
        "O3": Properties("O3", half_dtype, False, False, False, 1.0),
    }
    if opt_level not in tables:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r}; "
            "options are 'O0', 'O1', 'O2', 'O3'.")
    return tables[opt_level]
