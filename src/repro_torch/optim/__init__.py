"""Optimizer-side helpers of the port (the JAX package's ``optim``).
Only the int8 quantizer of ``compression`` is here so far: the quality
tiers' int8 weights use it; the gradient half waits for training
(ROADMAP Queue 1 item 8)."""
