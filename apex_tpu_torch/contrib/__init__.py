"""Contrib modules of the port (so far: xentropy)."""
