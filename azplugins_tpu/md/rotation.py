"""Rigid-rotor integration: symplectic NO_SQUISH quaternion dynamics.

Rebuild of the rotational half of HOOMD's two-step integrators, which
the reference's aniso potential relies on (torque outputs of
/root/reference/src/AnisoPairEvaluatorTwoPatchMorse.h:179-192 exist to be
integrated by HOOMD's NVE/Langevin; BASELINE config 4 "patchy colloids").

Representation (HOOMD convention): orientation quaternion ``q`` (w,x,y,z)
and angular-momentum quaternion ``p = 2 q (0, I w_body)``. Free rotation
uses the symplectic NO_SQUISH splitting of Miller et al., J. Chem. Phys.
116, 8649 (2002): per-axis permutation rotations in the sequence
P3(dt/2) P2(dt/2) P1(dt) P2(dt/2) P3(dt/2); torque kicks advance ``p`` by
``dt * q * (0, t_body)`` per half step (the factor 2 of dp/dt = 2 q (0,t)
times dt/2). Axes with zero moment of inertia are frozen (their torque
component is dropped and their permutation rotation skipped), matching
HOOMD's zero-inertia handling.

All functions are pure jnp over component arrays; quaternions are [N, 4].
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "quat_mul",
    "rotate",
    "rotate_inv",
    "angmom_kick",
    "free_rotation",
    "body_angular_momentum",
    "rotational_kinetic_energy",
]

_EPS = 1e-12


def quat_mul(a, b):
    """Hamilton product of [N,4] quaternions (w, x, y, z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _mul_vec(a, v):
    """a * (0, v): quaternion times pure-vector quaternion."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            -ax * vx - ay * vy - az * vz,
            aw * vx + ay * vz - az * vy,
            aw * vy - ax * vz + az * vx,
            aw * vz + ax * vy - ay * vx,
        ],
        axis=-1,
    )


def rotate(q, v):
    """Rotate [N,3] vectors by [N,4] quaternions (body -> lab for q)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def rotate_inv(q, v):
    """Rotate by the conjugate (lab -> body)."""
    qw = q[..., 0:1]
    qv = -q[..., 1:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def _active(inertia):
    """Per-axis activity mask [N,3]: zero-inertia axes are frozen."""
    return inertia > _EPS


def angmom_kick(q, p, torque_lab, inertia, dt):
    """Half-step torque kick: p += dt * q * (0, t_body).

    ``dt`` here is the full timestep (the 1/2 of the kick cancels the 2 of
    dp/dt = 2 q (0, t)). Torque components on frozen axes are dropped in
    the body frame, as in HOOMD.
    """
    t_body = rotate_inv(q, torque_lab)
    t_body = jnp.where(_active(inertia), t_body, 0.0)
    return p + dt * _mul_vec(q, t_body)


# Permutation operators P1, P2, P3 on (w, x, y, z)
def _perm1(a):
    return jnp.stack([-a[..., 1], a[..., 0], a[..., 3], -a[..., 2]], axis=-1)


def _perm2(a):
    return jnp.stack([-a[..., 2], -a[..., 3], a[..., 0], a[..., 1]], axis=-1)


def _perm3(a):
    return jnp.stack([-a[..., 3], a[..., 2], -a[..., 1], a[..., 0]], axis=-1)


def _axis_rotation(q, p, inertia_k, active_k, perm, dt_k):
    """One NO_SQUISH axis rotation: angle = dt_k * p.(Pk q) / (4 I_k)."""
    qk = perm(q)
    pk = perm(p)
    inv_i = jnp.where(active_k, 1.0 / jnp.maximum(inertia_k, _EPS), 0.0)
    phi = 0.25 * inv_i * jnp.sum(p * qk, axis=-1)
    ang = dt_k * phi
    c = jnp.cos(ang)[..., None]
    s = jnp.sin(ang)[..., None]
    q_new = c * q + s * qk
    p_new = c * p + s * pk
    act = active_k[..., None]
    return jnp.where(act, q_new, q), jnp.where(act, p_new, p)


def free_rotation(q, p, inertia, dt):
    """Torque-free rotation of (q, p) for one timestep.

    NO_SQUISH sequence P3(dt/2) P2(dt/2) P1(dt) P2(dt/2) P3(dt/2);
    renormalizes q at the end to control float32 drift.
    """
    act = _active(inertia)
    ax, ay, az = act[..., 0], act[..., 1], act[..., 2]
    Ix, Iy, Iz = inertia[..., 0], inertia[..., 1], inertia[..., 2]
    half = 0.5 * dt
    q, p = _axis_rotation(q, p, Iz, az, _perm3, half)
    q, p = _axis_rotation(q, p, Iy, ay, _perm2, half)
    q, p = _axis_rotation(q, p, Ix, ax, _perm1, dt)
    q, p = _axis_rotation(q, p, Iy, ay, _perm2, half)
    q, p = _axis_rotation(q, p, Iz, az, _perm3, half)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True), _EPS))
    return q / norm, p


def body_angular_momentum(q, p):
    """L_body [N,3] from the quaternion pair: (0, L) = conj(q) p / 2."""
    qc = q * jnp.asarray([1.0, -1.0, -1.0, -1.0], q.dtype)
    lq = 0.5 * quat_mul(qc, p)
    return lq[..., 1:4]


def rotational_kinetic_energy(q, p, inertia):
    """Sum over particles of L_k^2 / (2 I_k) on active axes."""
    L = body_angular_momentum(q, p)
    act = _active(inertia)
    inv_i = jnp.where(act, 1.0 / jnp.maximum(inertia, _EPS), 0.0)
    return 0.5 * jnp.sum(L * L * inv_i)
