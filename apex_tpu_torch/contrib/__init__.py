"""Contrib modules of the port (xentropy, multihead_attn, fmha,
clip_grad)."""
