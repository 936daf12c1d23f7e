"""Optimizer-side modules of the port (the JAX package's ``optim``):
``adamw`` (AdamW with a cosine schedule) and ``compression`` (the int8
quantizer the quality tiers use, and error-feedback gradient
compression for a group of one)."""
