"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and wrappers (``ops.py``)."""
