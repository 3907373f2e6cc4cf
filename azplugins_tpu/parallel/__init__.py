"""Multi-device parallelism (device mesh, sharded stepping).

The reference scales by MPI spatial domain decomposition inside HOOMD
(SURVEY §2.12). This engine's distributed axis is the same — space /
particles — expressed as JAX shardings over a device Mesh with XLA
collectives between the devices. See mesh.py.
"""

from .mesh import make_mesh, shard_state

__all__ = ["make_mesh", "shard_state"]
