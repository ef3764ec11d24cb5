"""Hand-written CUDA kernels for the sTiles hot path (``csrc/``), their
Python wrappers, and the plain PyTorch versions they are held to
(``ref.py``); ``ops.py`` dispatches between them by device."""
from . import ops, ref

__all__ = ["ops", "ref"]
