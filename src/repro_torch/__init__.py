"""MAR-FL in PyTorch for an NVIDIA H100: the port of the JAX package
``repro``, slice by slice (ROADMAP.md). The JAX package is the
reference every module here is held against; this package imports
neither it nor JAX."""
