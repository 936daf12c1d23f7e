"""PyTorch/CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points take an explicit ``device`` and default to
``"cuda"``; they run on the CPU only when the caller passes
``device="cpu"`` (the CPU tests do)."""
