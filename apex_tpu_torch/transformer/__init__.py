"""Transformer building blocks of the port (so far: the tensor-parallel
layers at a tensor-parallel size of 1)."""
