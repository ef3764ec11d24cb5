"""Launching the port: meshes over a ``torch.distributed`` world and the
local launcher of ranks (``launch/mesh.py``)."""
