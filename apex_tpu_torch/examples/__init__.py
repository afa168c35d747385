"""Runnable entry points of the port (``python -m apex_tpu_torch.examples.<name>``)."""
