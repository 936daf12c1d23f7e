"""The port's disk checkpoints (the JAX package's ``checkpoint``)."""
