"""The port's entry points (the JAX package's ``launch``): ``serve``, one
engine; ``fleet``, a heterogeneous fleet in sync or service mode;
``train``, training with checkpoints and restart.  Each runs on the card
unless ``--device cpu`` asks for the CPU.  The dry-run and roofline
tools for one H100 (``dryrun``, ``reanalyze``, ``report``, over
``steps``, ``op_analysis``, ``roofline`` and ``mesh``) run on the CPU
and need no card."""
