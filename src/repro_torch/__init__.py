"""sTiles on PyTorch and CUDA: the port of the ``repro`` package to an
NVIDIA H100.  The JAX package stays the reference; this package imports
nothing of it and never imports jax."""
