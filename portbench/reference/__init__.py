"""The plain reference: PyTorch and NumPy only. It imports neither JAX,
nor the JAX package, nor anything of the port, and takes nothing the
port has made: it draws its own weights and inputs from the benchmark's
generators (``weights.py``, ``gen.py``) and works out again whatever the
port derives from them."""
