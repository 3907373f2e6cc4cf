"""Device-resident simulation state.

The replacement for HOOMD's ``ParticleData``/``SystemDefinition``
substrate (particle arrays consumed by the reference at
/root/reference/src/TwoStepLangevinFlow.h:113-126). State is one immutable
pytree of static-shaped device arrays; a timestep is a pure function
``State -> State`` that XLA compiles once. The user-facing State is in tag
order (index == tag); the engine's hot loop runs the same pytree in the
dense cell-slot order of ops/dense.py, where ``tag`` maps slots back to
user order and negative tags mark empty slots.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils import pytree_dataclass
from .box import Box
from .snapshot import Snapshot

__all__ = ["State", "state_from_snapshot", "state_to_snapshot", "thermalize_momenta"]


@pytree_dataclass
class State:
    """All per-particle and topology arrays plus the box.

    Shapes: N particles, NB bonds. All float arrays are float32;
    ids are int32.
    """

    position: jnp.ndarray  # [N, 3]
    tag: jnp.ndarray  # [N] int32; == index in user (tag) order, permuted in
    # engine slot order; negative marks an empty slot
    velocity: jnp.ndarray  # [N, 3]
    typeid: jnp.ndarray  # [N] int32
    image: jnp.ndarray  # [N, 3] int32
    orientation: jnp.ndarray  # [N, 4] quaternion (w, x, y, z)
    mass: jnp.ndarray  # [N]
    diameter: jnp.ndarray  # [N]
    charge: jnp.ndarray  # [N]
    net_force: jnp.ndarray  # [N, 3] conservative forces at current positions
    acceleration: jnp.ndarray  # [N, 3] effective accel incl. thermostat forces
    angmom: jnp.ndarray  # [N, 4] angular momentum quaternion p = 2 q (0, I w_body)
    moment_inertia: jnp.ndarray  # [N, 3] body-frame principal moments
    net_torque: jnp.ndarray  # [N, 3] lab-frame torques at current positions
    bond_typeid: jnp.ndarray  # [NB] int32
    bond_group: jnp.ndarray  # [NB, 2] int32
    box: Box

    @property
    def N(self) -> int:
        return self.position.shape[0]

    @property
    def n_bonds(self) -> int:
        return self.bond_typeid.shape[0]



def state_from_snapshot(snapshot: Snapshot) -> tuple[State, list[str], list[str]]:
    """Build a device State. Returns (state, particle_types, bond_types)."""
    snapshot.validate()
    p = snapshot.particles
    b = snapshot.bonds
    box_arr = list(snapshot.configuration.box)
    if len(box_arr) == 3:
        box_arr = box_arr + [0.0, 0.0, 0.0]
    box = Box.from_lengths(*box_arr)

    state = State(
        position=jnp.asarray(p.position, dtype=jnp.float32),
        tag=jnp.arange(p.N, dtype=jnp.int32),
        velocity=jnp.asarray(p.velocity, dtype=jnp.float32),
        typeid=jnp.asarray(p.typeid, dtype=jnp.int32),
        image=jnp.asarray(p.image, dtype=jnp.int32),
        orientation=jnp.asarray(p.orientation, dtype=jnp.float32),
        mass=jnp.asarray(p.mass, dtype=jnp.float32),
        diameter=jnp.asarray(p.diameter, dtype=jnp.float32),
        charge=jnp.asarray(p.charge, dtype=jnp.float32),
        net_force=jnp.zeros((p.N, 3), dtype=jnp.float32),
        acceleration=jnp.zeros((p.N, 3), dtype=jnp.float32),
        angmom=jnp.asarray(p.angmom, dtype=jnp.float32),
        moment_inertia=jnp.asarray(p.moment_inertia, dtype=jnp.float32),
        net_torque=jnp.zeros((p.N, 3), dtype=jnp.float32),
        bond_typeid=jnp.asarray(b.typeid, dtype=jnp.int32),
        bond_group=jnp.asarray(b.group, dtype=jnp.int32),
        box=box,
    )
    return state, list(p.types), list(b.types)


def state_to_snapshot(state: State, particle_types, bond_types) -> Snapshot:
    snap = Snapshot(N=state.N, bond_N=state.n_bonds)
    snap.particles.types = list(particle_types)
    snap.bonds.types = list(bond_types)
    p = snap.particles
    # positions may carry unwrapped drift (integrators defer wrapping to
    # the neighbor rebuild); the user-facing snapshot is always wrapped
    pos_w, image_w = state.box.wrap(state.position, state.image)
    p.position[:] = np.asarray(pos_w, dtype=np.float64)
    p.velocity[:] = np.asarray(state.velocity, dtype=np.float64)
    p.typeid[:] = np.asarray(state.typeid)
    p.image[:] = np.asarray(image_w)
    p.orientation[:] = np.asarray(state.orientation, dtype=np.float64)
    p.mass[:] = np.asarray(state.mass, dtype=np.float64)
    p.diameter[:] = np.asarray(state.diameter, dtype=np.float64)
    p.charge[:] = np.asarray(state.charge, dtype=np.float64)
    p.angmom[:] = np.asarray(state.angmom, dtype=np.float64)
    p.moment_inertia[:] = np.asarray(state.moment_inertia, dtype=np.float64)
    L = np.asarray(state.box.L, dtype=np.float64)
    tilt = np.asarray(state.box.tilt, dtype=np.float64)
    snap.configuration.box = [L[0], L[1], L[2], tilt[0], tilt[1], tilt[2]]
    snap.bonds.typeid[:] = np.asarray(state.bond_typeid)
    snap.bonds.group[:] = np.asarray(state.bond_group)
    return snap


def thermalize_momenta(state: State, kT: float, seed: int, mask=None) -> State:
    """Draw Maxwell-Boltzmann velocities and remove net momentum.

    Parity with hoomd's ``thermalize_particle_momenta`` used by the DPD
    statistical test (/root/reference/src/pytest/test_pair_dpd.py:19-35).
    """
    from .rng import Stream, particle_bits, uniform_from_bits

    n = state.N
    tag = state.tag
    words = particle_bits(Stream.THERMALIZE, seed, 0, tag, n_words=8)
    # Box-Muller from uniforms for 3 gaussians per particle
    eps = jnp.float32(1.1754944e-38)
    gauss = []
    for k in range(3):
        u1 = jnp.maximum(uniform_from_bits(words[2 * k], 0.0, 1.0), eps)
        u2 = uniform_from_bits(words[2 * k + 1], 0.0, 1.0)
        g = jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u2)
        gauss.append(g)
    gauss = jnp.stack(gauss, axis=-1)
    sigma = jnp.sqrt(jnp.float32(kT) / state.mass)[:, None]
    vel = gauss * sigma
    if mask is None:
        mask = jnp.ones((n,), dtype=bool)
    mask_f = mask.astype(jnp.float32)[:, None]
    # zero the group's center-of-mass momentum
    mom = jnp.sum(vel * state.mass[:, None] * mask_f, axis=0)
    mtot = jnp.sum(state.mass * mask_f[:, 0])
    vel = vel - (mom / mtot)[None, :]
    new_vel = jnp.where(mask[:, None], vel, state.velocity)
    state = state.replace(velocity=new_vel)

    # angular momenta for particles with nonzero moments of inertia
    # (hoomd thermalizes rotational DOF in the same call)
    inertia = state.moment_inertia
    if bool(jnp.any(inertia > 0)):
        from ..md import rotation as R

        words_r = particle_bits(
            Stream.THERMALIZE_ANGULAR, seed, 0, tag, n_words=8
        )
        gauss_r = []
        for k in range(3):
            u1 = jnp.maximum(uniform_from_bits(words_r[2 * k], 0.0, 1.0), eps)
            u2 = uniform_from_bits(words_r[2 * k + 1], 0.0, 1.0)
            g = jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u2)
            gauss_r.append(g)
        gauss_r = jnp.stack(gauss_r, axis=-1)
        active = inertia > 1e-12
        L_body = jnp.where(
            active, gauss_r * jnp.sqrt(jnp.float32(kT) * inertia), 0.0
        )
        q = state.orientation
        zeros = jnp.zeros((n, 1), jnp.float32)
        p = 2.0 * R.quat_mul(q, jnp.concatenate([zeros, L_body], axis=-1))
        new_p = jnp.where(
            (mask & jnp.any(active, axis=-1))[:, None], p, state.angmom
        )
        state = state.replace(angmom=new_p)
    return state
