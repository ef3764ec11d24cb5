"""Collectives over a mesh dimension's process group
(``sharding/collectives.py``)."""
