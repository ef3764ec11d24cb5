"""Twins of the JAX package's ``examples/``: ``train_lm``, ``inla_gmrf``
and ``distributed_factorization``, each ``python -m
repro_torch.examples.<name> [--device cpu]`` (the card by default)."""
