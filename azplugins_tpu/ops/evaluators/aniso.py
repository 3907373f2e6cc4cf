"""Anisotropic pair evaluators: force + energy + torques (componentwise).

Rebuild of SURVEY §2.3. Layout rule: all pair-shaped values are
separate [N, M] arrays per component (no trailing 3- or 4-axis).
Protocol:

``(dxyz, quat_i, quat_j, rcutsq, params, energy_shift) ->
  (energy, force_xyz, torque_i_xyz, torque_j_xyz)``

where dxyz/force/torque are 3-tuples of arrays and quat_* are 4-tuples
(w, x, y, z).

TwoPatchMorse physics re-derived from
/root/reference/src/AnisoPairEvaluatorTwoPatchMorse.h:127-216: Morse radial
well modulated by patch alignment Omega(gamma) = 1/(1+exp(-omega(gamma^2 -
alpha))) for each particle, gamma = rhat . nhat, patch direction = body x
axis rotated by the particle quaternion; analytic torques from dU/dgamma.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp

__all__ = ["AnisoPairPotentialDef", "ANISO_PAIR_POTENTIALS", "two_patch_morse"]


@dataclasses.dataclass(frozen=True)
class AnisoPairPotentialDef:
    name: str
    spec: dict
    precompute: Callable[[dict], dict]
    energy_force_torque: Callable


def _tpm_precompute(t: dict) -> dict:
    return {
        "M_d": t["M_d"],
        "M_rinv": 1.0 / t["M_r"],
        "r_eq": t["r_eq"],
        "omega": t["omega"],
        "alpha": t["alpha"],
        "repulsion": t["repulsion"],
    }


def _rotate_x(q):
    """Rotate the body-frame x axis by quaternion components (w, x, y, z)."""
    w, x, y, z = q
    nx = 1.0 - 2.0 * (y * y + z * z)
    ny = 2.0 * (x * y + w * z)
    nz = 2.0 * (x * z - w * y)
    return nx, ny, nz


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _morse(r, p):
    """Morse energy and radial derivative, with optional flat bottom."""
    morse_exp = jnp.exp(-(r - p["r_eq"]) * p["M_rinv"])
    one_minus = 1.0 - morse_exp
    U = p["M_d"] * (one_minus * one_minus - 1.0)
    dU_dr = 2.0 * p["M_d"] * p["M_rinv"] * morse_exp * one_minus
    # flat bottom: purely attractive branch clamps U=-M_d, dU=0 for r<r_eq
    flat = (r < p["r_eq"]) & jnp.logical_not(p["repulsion"].astype(bool))
    U = jnp.where(flat, -p["M_d"], U)
    dU_dr = jnp.where(flat, 0.0, dU_dr)
    return U, dU_dr


def two_patch_morse(dxyz, quat_i, quat_j, rcutsq, p, energy_shift: bool):
    dx, dy, dz = dxyz
    rsq = dx * dx + dy * dy + dz * dz
    rsq_safe = jnp.where(rsq > 0, rsq, 1.0)
    rinv = 1.0 / jnp.sqrt(rsq_safe)
    r = rsq_safe * rinv
    ux, uy, uz = dx * rinv, dy * rinv, dz * rinv

    nix, niy, niz = _rotate_x(quat_i)
    njx, njy, njz = _rotate_x(quat_j)

    U, dU_dr_radial = _morse(r, p)

    def omega_terms(gamma):
        g_exp = jnp.exp(-p["omega"] * (gamma * gamma - p["alpha"]))
        Om = 1.0 / (1.0 + g_exp)
        dOm_dg = 2.0 * p["omega"] * gamma * g_exp * Om * Om
        return Om, dOm_dg

    gamma_i = ux * nix + uy * niy + uz * niz
    gamma_j = ux * njx + uy * njy + uz * njz
    Om_i, dOmi = omega_terms(gamma_i)
    Om_j, dOmj = omega_terms(gamma_j)

    e = U * Om_i * Om_j
    dU_dr = dU_dr_radial * Om_i * Om_j
    dU_dgi = dOmi * U * Om_j
    dU_dgj = dOmj * U * Om_i

    # n_perp = -rhat x (rhat x n): the component of n perpendicular to rhat
    # equals n - (rhat.n) rhat, times... expand double cross directly:
    # -u x (u x n) = n - (u.n) u
    nipx, nipy, nipz = nix - gamma_i * ux, niy - gamma_i * uy, niz - gamma_i * uz
    njpx, njpy, njpz = njx - gamma_j * ux, njy - gamma_j * uy, njz - gamma_j * uz

    fx = -dU_dr * ux - rinv * (dU_dgi * nipx + dU_dgj * njpx)
    fy = -dU_dr * uy - rinv * (dU_dgi * nipy + dU_dgj * njpy)
    fz = -dU_dr * uz - rinv * (dU_dgi * nipz + dU_dgj * njpz)

    cix, ciy, ciz = _cross(ux, uy, uz, nix, niy, niz)
    cjx, cjy, cjz = _cross(ux, uy, uz, njx, njy, njz)
    ti = (dU_dgi * cix, dU_dgi * ciy, dU_dgi * ciz)
    tj = (dU_dgj * cjx, dU_dgj * cjy, dU_dgj * cjz)

    if energy_shift:
        # shift uses the raw Morse form at rcut (no flat-bottom clamp),
        # matching /root/reference/src/AnisoPairEvaluatorTwoPatchMorse.h:194-207
        rcut = jnp.sqrt(rcutsq)
        exp_cut = jnp.exp(-(rcut - p["r_eq"]) * p["M_rinv"])
        one_minus_cut = 1.0 - exp_cut
        U_cut = p["M_d"] * (one_minus_cut * one_minus_cut - 1.0)
        e = e - U_cut * Om_i * Om_j

    return e, (fx, fy, fz), ti, tj


ANISO_PAIR_POTENTIALS = {
    "TwoPatchMorse": AnisoPairPotentialDef(
        name="TwoPatchMorse",
        spec={
            "M_d": float,
            "M_r": float,
            "r_eq": float,
            "omega": float,
            "alpha": float,
            "repulsion": bool,
        },
        precompute=_tpm_precompute,
        energy_force_torque=two_patch_morse,
    ),
}
