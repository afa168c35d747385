"""Contrib modules of the port (so far: xentropy, multihead_attn,
clip_grad)."""
