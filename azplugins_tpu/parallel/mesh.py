"""Device mesh helpers: atom-decomposition sharding of the MD step.

Strategy (round 1): *atom decomposition* — per-particle arrays are sharded
along the particle axis of a 1-D mesh; positions needed for neighbor
gathers are implicitly all-gathered by XLA's SPMD partitioner. Reductions
(net momentum, histograms, evaporator counts) become ``psum`` across devices —
the direct analog of the reference's plugin-level MPI collectives
(/root/reference/src/VelocityCompute.cc:50-63,
/root/reference/src/ParticleEvaporator.cc:96-107). Spatial (halo-exchange)
decomposition via ``ppermute`` is the planned phase-2 upgrade (SURVEY
§2.12).

Counter-based RNG keyed on (tag, timestep) makes trajectories bitwise
identical on 1 or N devices — the property the reference engineers with
replicated seeds.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_state", "particle_sharding"]


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def particle_sharding(mesh: Mesh, axis: str = "d") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def shard_state(state, mesh: Mesh, axis: str = "d"):
    """Place per-particle arrays sharded along the particle dimension.

    Replicates small/topology arrays. Requires N % n_devices == 0.
    """
    n = mesh.devices.size
    if state.N % n != 0:
        raise ValueError(f"N={state.N} must be divisible by mesh size {n}")
    sharded = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())

    def place(x, sh):
        return jax.device_put(x, sh)

    return state.replace(
        position=place(state.position, sharded),
        tag=place(state.tag, sharded),
        velocity=place(state.velocity, sharded),
        typeid=place(state.typeid, sharded),
        image=place(state.image, sharded),
        orientation=place(state.orientation, sharded),
        mass=place(state.mass, sharded),
        diameter=place(state.diameter, sharded),
        charge=place(state.charge, sharded),
        net_force=place(state.net_force, sharded),
        acceleration=place(state.acceleration, sharded),
        angmom=place(state.angmom, sharded),
        moment_inertia=place(state.moment_inertia, sharded),
        net_torque=place(state.net_torque, sharded),
        bond_typeid=place(state.bond_typeid, replicated),
        bond_group=place(state.bond_group, replicated),
        box=jax.tree.map(lambda x: place(x, replicated), state.box),
    )
