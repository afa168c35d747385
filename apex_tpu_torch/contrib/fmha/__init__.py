from apex_tpu_torch.contrib.fmha.fmha import FMHAFun, fmha_packed  # noqa: F401

__all__ = ["FMHAFun", "fmha_packed"]
