"""Generic pair force driver over the padded neighbor list.

TEST-ORACLE ONLY (except ForceResult and the shared helpers): Simulation
dispatches _compute_dense (ops/dense.py), never this driver — see
ops/neighbor.py. Kept as the independent parity-test reference path.

Rebuild of HOOMD's ``PotentialPair<Evaluator>`` /
``PotentialPairDPDThermo<Evaluator>`` drivers the reference instantiates
(SURVEY §3.2). Instead of one CUDA thread per particle, the whole
``[N, n_max]`` neighbor array is evaluated as fused dense vector math: a
full (two-sided) neighbor list makes the accumulation a row reduction —
no scatter, no atomics.

Layout rule: every large pairwise intermediate is a separate [N, M]
array per vector component, never one array with a trailing axis of 3.

Shift-mode semantics mirror HOOMD: ``none``, ``shift`` (subtract V(rcut)),
``xplor`` (smooth S(r) between r_on and r_cut; falls back to shift when
r_on >= r_cut). Mode is trace-time static.

The DPD thermostat variant adds the dissipative and random forces with a
per-pair counter RNG keyed on sorted tags + timestep, reproducing the
reference's bitwise-reproducible noise discipline
(/root/reference/src/DPDPairEvaluatorGeneralWeight.h:198-255).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import rng as _rng
from ..core.box import Box
from ..utils import pytree_dataclass

__all__ = ["pair_force", "dpd_pair_force", "ForceResult"]


@pytree_dataclass
class ForceResult:
    force: jnp.ndarray  # [N, 3]
    energy: jnp.ndarray  # [N] per-particle (half per pair)
    virial: jnp.ndarray  # [N, 6] (xx, xy, xz, yy, yz, zz), half per pair
    torque: jnp.ndarray | None = None  # [N, 3] for anisotropic potentials

    def __add__(self, other: "ForceResult") -> "ForceResult":
        torque = None
        if self.torque is not None and other.torque is not None:
            torque = self.torque + other.torque
        elif self.torque is not None:
            torque = self.torque
        elif other.torque is not None:
            torque = other.torque
        return ForceResult(
            force=self.force + other.force,
            energy=self.energy + other.energy,
            virial=self.virial + other.virial,
            torque=torque,
        )


def zero_force_result(N: int, with_torque: bool = False) -> ForceResult:
    return ForceResult(
        force=jnp.zeros((N, 3), jnp.float32),
        energy=jnp.zeros((N,), jnp.float32),
        virial=jnp.zeros((N, 6), jnp.float32),
        torque=jnp.zeros((N, 3), jnp.float32) if with_torque else None,
    )


def _gather_pairwise(position, typeid, box: Box, nbr_idx):
    """Common pair geometry, componentwise.

    Returns (j, dx, dy, dz, rsq, valid, t_i, t_j), each pair array [N, M].
    """
    N = position.shape[0]
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
    return j, dx, dy, dz, rsq, valid, t_i, t_j


def _pair_tables(tables: dict, t_i, t_j, T: int):
    """Gather per-pair parameters from [T, T] tables."""
    flat = t_i * T + t_j
    return {k: jnp.take(v.reshape(-1), flat) for k, v in tables.items()}


def _xplor_smooth(e, f, rsq, rcutsq, r_onsq):
    denom = (rcutsq - r_onsq) ** 3
    denom = jnp.where(denom == 0, 1.0, denom)
    s_val = (rcutsq - rsq) ** 2 * (rcutsq + 2.0 * rsq - 3.0 * r_onsq) / denom
    ds_dr_divr = 12.0 * (rsq - r_onsq) * (rcutsq - rsq) / denom
    in_smooth = rsq > r_onsq
    f_new = jnp.where(in_smooth, f * s_val + e * ds_dr_divr, f)
    e_new = jnp.where(in_smooth, e * s_val, e)
    return e_new, f_new


def _accumulate(dx, dy, dz, e, f_divr, mask):
    """Row-reduce masked pair terms into per-particle force/energy/virial."""
    f_divr = jnp.where(mask, f_divr, 0.0)
    e = jnp.where(mask, e, 0.0)
    force = jnp.stack(
        [
            jnp.sum(f_divr * dx, axis=1),
            jnp.sum(f_divr * dy, axis=1),
            jnp.sum(f_divr * dz, axis=1),
        ],
        axis=-1,
    )
    energy = 0.5 * jnp.sum(e, axis=1)
    w = 0.5 * f_divr
    virial = jnp.stack(
        [
            jnp.sum(w * dx * dx, axis=1),
            jnp.sum(w * dx * dy, axis=1),
            jnp.sum(w * dx * dz, axis=1),
            jnp.sum(w * dy * dy, axis=1),
            jnp.sum(w * dy * dz, axis=1),
            jnp.sum(w * dz * dz, axis=1),
        ],
        axis=-1,
    )
    return force, energy, virial


def pair_force(
    energy_force_fn,
    position,
    typeid,
    box: Box,
    nbr_idx,
    tables: dict,
    r_cut_table,
    r_on_table=None,
    mode: str = "none",
) -> ForceResult:
    """Evaluate an isotropic pair potential over the neighbor list.

    Args:
        energy_force_fn: ``(rsq, rcutsq, params) -> (e, f_div_r)`` evaluator.
        tables: dict of ``[T, T]`` parameter tables.
        r_cut_table / r_on_table: ``[T, T]`` cutoff tables (r_cut = 0 disables).
        mode: "none" | "shift" | "xplor" (static).
    """
    T = r_cut_table.shape[0]
    _, dx, dy, dz, rsq, valid, t_i, t_j = _gather_pairwise(position, typeid, box, nbr_idx)
    p = _pair_tables(tables, t_i, t_j, T)
    rcut = jnp.take(r_cut_table.reshape(-1), t_i * T + t_j)
    rcutsq = rcut * rcut
    mask = valid & (rsq < rcutsq) & (rcut > 0)

    rsq_safe = jnp.where(mask, rsq, 1.0)
    rcutsq_safe = jnp.where(rcut > 0, rcutsq, 4.0)
    e, f = energy_force_fn(rsq_safe, rcutsq_safe, p)

    if mode == "shift":
        e_cut, _ = energy_force_fn(rcutsq_safe, rcutsq_safe, p)
        e = e - e_cut
    elif mode == "xplor":
        if r_on_table is None:
            raise ValueError("xplor mode requires r_on")
        r_on = jnp.take(r_on_table.reshape(-1), t_i * T + t_j)
        r_onsq = r_on * r_on
        smooth = r_on < rcut
        e_s, f_s = _xplor_smooth(e, f, rsq_safe, rcutsq_safe, r_onsq)
        e_cut, _ = energy_force_fn(rcutsq_safe, rcutsq_safe, p)
        e = jnp.where(smooth, e_s, e - e_cut)
        f = jnp.where(smooth, f_s, f)
    elif mode != "none":
        raise ValueError(f"unknown shift mode {mode!r}")

    force, energy, virial = _accumulate(dx, dy, dz, e, f, mask)
    return ForceResult(force=force, energy=energy, virial=virial)


def dpd_pair_force(
    position,
    velocity,
    tag,
    typeid,
    box: Box,
    nbr_idx,
    tables: dict,
    r_cut_table,
    kT,
    dt,
    seed: int,
    timestep,
) -> ForceResult:
    """DPD general-weight thermostat force (conservative + drag + random).

    Physics per /root/reference/src/DPDPairEvaluatorGeneralWeight.h:198-255:
      F_C = A (1/r - 1/rcut) * dr
      w_R = (1 - r/rcut)^{s/2} / r
      F_D = -gamma w_R^2 (v_ij . dr) * dr
      F_R = sqrt(6 gamma kT / dt) w_R alpha * dr,  alpha ~ U(-1, 1) per pair
    Only the conservative part contributes to the virial.
    """
    T = r_cut_table.shape[0]
    j, dx, dy, dz, rsq, valid, t_i, t_j = _gather_pairwise(position, typeid, box, nbr_idx)
    p = _pair_tables(tables, t_i, t_j, T)
    rcut = jnp.take(r_cut_table.reshape(-1), t_i * T + t_j)
    rcutsq = rcut * rcut
    mask = valid & (rsq < rcutsq) & (rcut > 0)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    rcut_safe = jnp.where(rcut > 0, rcut, 2.0)

    rinv = 1.0 / jnp.sqrt(rsq_safe)
    r = rsq_safe * rinv
    rcutinv = 1.0 / rcut_safe

    # conservative
    f_cons = p["A"] * (rinv - rcutinv)
    e = p["A"] * (rcut_safe - r) - 0.5 * p["A"] * rcutinv * (rcutsq - rsq_safe)

    # drag: v_ij . r_ij componentwise
    vx, vy, vz = velocity[:, 0], velocity[:, 1], velocity[:, 2]
    rdotv = dx * (vx[:, None] - vx[j]) + dy * (vy[:, None] - vy[j]) + dz * (vz[:, None] - vz[j])
    w_R = jnp.maximum(1.0 - r * rcutinv, 0.0) ** (0.5 * p["s"]) * rinv
    f_drag = -p["gamma"] * w_R * w_R * rdotv

    # random: one symmetric uniform per (pair, timestep)
    alpha = _rng.pair_uniform(
        _rng.Stream.DPD_GENERAL_WEIGHT, seed, timestep, tag[:, None], tag[j],
        rounds=_rng.FAST_ROUNDS,
    )
    kT = jnp.float32(kT)
    dt_arr = jnp.float32(dt)
    sigma_coeff = jnp.where(
        dt_arr > 0, jnp.sqrt(6.0 * p["gamma"] * kT / jnp.maximum(dt_arr, 1e-20)), 0.0
    )
    f_rand = sigma_coeff * w_R * alpha

    f_total = f_cons + f_drag + f_rand
    force, energy, _ = _accumulate(dx, dy, dz, e, f_total, mask)
    # virial from the conservative part only (reference :239)
    _, _, virial = _accumulate(dx, dy, dz, e, f_cons, mask)
    return ForceResult(force=force, energy=energy, virial=virial)
