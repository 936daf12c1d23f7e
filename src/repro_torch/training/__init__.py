"""The port's train step (the JAX package's ``training``)."""
