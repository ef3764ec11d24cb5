"""Optimizers of the LM substrate: AdamW (``adamw.py``) and the sTiles
banded-arrowhead curvature preconditioner (``arrowhead.py``)."""
