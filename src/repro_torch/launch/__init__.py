"""The port's entry points (the JAX package's ``launch``): ``serve``, one
engine; ``fleet``, a heterogeneous fleet in sync or service mode.  Both
run on the card unless ``--device cpu`` asks for the CPU."""
