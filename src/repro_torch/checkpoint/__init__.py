"""Atomic, keep-k, asynchronous checkpoints of nested tensor trees."""
