"""Anisotropic pair force driver: forces + torques over the neighbor list.

Rebuild of HOOMD's ``AnisoPotentialPair<Evaluator>`` (SURVEY §2.3).
Same dense masked-row-reduction shape as the isotropic driver, extended
with particle orientations in and torques out — all pair-shaped values are
componentwise [N, M] arrays (see ops/pair_force.py).
With a full neighbor list each particle sums its *own* torque from every
pair (the j-side torque appears when the pair is visited from j's row).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.box import Box
from .pair_force import ForceResult, _pair_tables

__all__ = ["aniso_pair_force"]


def aniso_pair_force(
    energy_force_torque_fn,
    position,
    orientation,
    typeid,
    box: Box,
    nbr_idx,
    tables: dict,
    r_cut_table,
    mode: str = "none",
) -> ForceResult:
    N = position.shape[0]
    T = r_cut_table.shape[0]
    j = jnp.minimum(nbr_idx, N - 1)
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    dx = px[:, None] - px[j]
    dy = py[:, None] - py[j]
    dz = pz[:, None] - pz[j]
    dx, dy, dz = box.min_image_components(dx, dy, dz)
    rsq = dx * dx + dy * dy + dz * dz
    valid = nbr_idx != N
    t_i = typeid[:, None]
    t_j = typeid[j]
    p = _pair_tables(tables, t_i, t_j, T)
    rcut = jnp.take(r_cut_table.reshape(-1), t_i * T + t_j)
    rcutsq = rcut * rcut
    mask = valid & (rsq < rcutsq) & (rcut > 0)

    quat_i = tuple(orientation[:, k][:, None] for k in range(4))  # [N, 1] each
    quat_j = tuple(orientation[:, k][j] for k in range(4))  # [N, M] each
    # sanitize dr for padded slots (evaluator divides by |dr|)
    dx_s = jnp.where(mask, dx, 1.0)
    dy_s = jnp.where(mask, dy, 0.0)
    dz_s = jnp.where(mask, dz, 0.0)

    e, f, ti, _tj = energy_force_torque_fn(
        (dx_s, dy_s, dz_s),
        quat_i,
        quat_j,
        jnp.where(rcut > 0, rcutsq, 4.0),
        p,
        mode == "shift",
    )

    def msum(x):
        return jnp.sum(jnp.where(mask, x, 0.0), axis=1)

    force = jnp.stack([msum(f[0]), msum(f[1]), msum(f[2])], axis=-1)
    energy = 0.5 * msum(e)
    torque = jnp.stack([msum(ti[0]), msum(ti[1]), msum(ti[2])], axis=-1)

    # virial: 0.5 * dr_a * F_b per pair (HOOMD aniso convention)
    virial = jnp.stack(
        [
            0.5 * msum(dx * f[0]),
            0.5 * msum(dx * f[1]),
            0.5 * msum(dx * f[2]),
            0.5 * msum(dy * f[1]),
            0.5 * msum(dy * f[2]),
            0.5 * msum(dz * f[2]),
        ],
        axis=-1,
    )
    return ForceResult(force=force, energy=energy, virial=virial, torque=torque)
