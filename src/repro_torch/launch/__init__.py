"""Launching the port: meshes over a ``torch.distributed`` world and the
local launcher of ranks (``launch/mesh.py``), and the continuous-batching
rung server (``launch/rung_server.py``)."""
