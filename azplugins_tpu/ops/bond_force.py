"""Bond force driver: scatter-add over the static bond table.

Rebuild of HOOMD's ``PotentialBond<Evaluator>`` loop (SURVEY §3.2).
Bond topology is static (scissile Quartic bonds "break" by producing zero
force, never by leaving the table — same as the reference, which retypes
rather than deletes). The two endpoint scatters use ``.at[].add``; on the
GPU a scatter with repeated indices lowers to atomics, whose order varies
run to run (DEVIATIONS.md §14).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.box import Box
from .pair_force import ForceResult

__all__ = ["bond_force"]


def bond_force(
    energy_force_fn,
    position,
    box: Box,
    bond_group,  # [NB, 2] int32
    bond_typeid,  # [NB] int32
    tables: dict,  # each [n_bond_types]
    N: int,
) -> ForceResult:
    a = bond_group[:, 0]
    b = bond_group[:, 1]
    dr = box.min_image(jnp.take(position, a, axis=0) - jnp.take(position, b, axis=0))
    rsq = jnp.sum(dr * dr, axis=-1)
    p = {k: jnp.take(v, bond_typeid) for k, v in tables.items()}
    rsq_safe = jnp.where(rsq > 0, rsq, 1.0)
    e, f_divr = energy_force_fn(rsq_safe, p)

    fvec = f_divr[:, None] * dr  # force on particle a; -fvec on b
    force = jnp.zeros((N, 3), jnp.float32)
    force = force.at[a].add(fvec).at[b].add(-fvec)
    energy = jnp.zeros((N,), jnp.float32)
    energy = energy.at[a].add(0.5 * e).at[b].add(0.5 * e)

    w = 0.5 * f_divr
    vir_terms = jnp.stack(
        [
            w * dr[:, 0] * dr[:, 0],
            w * dr[:, 0] * dr[:, 1],
            w * dr[:, 0] * dr[:, 2],
            w * dr[:, 1] * dr[:, 1],
            w * dr[:, 1] * dr[:, 2],
            w * dr[:, 2] * dr[:, 2],
        ],
        axis=-1,
    )
    virial = jnp.zeros((N, 6), jnp.float32)
    virial = virial.at[a].add(vir_terms).at[b].add(vir_terms)
    return ForceResult(force=force, energy=energy, virial=virial)
