"""Isotropic pair potential evaluators as pure jnp functions.

Rebuild of the reference evaluator layer (§2.1/2.2 of SURVEY):
each potential is a stateless function ``(rsq, rcutsq, params) -> (energy,
force_div_r)`` evaluated elementwise over the padded neighbor array by the
generic force driver (ops/pair_force.py). No codegen: adding a potential is
registering one function + a param spec (the analog of the reference's
CMake-stamped evaluator template instantiation, src/CMakeLists.txt:59-178).

Branches in the reference C++ become ``jnp.where`` selections; cutoff and
padding masks are applied by the driver, so these functions must only be
*algebraically safe* for garbage inputs (the driver sanitizes rsq > 0).

Physics sources (formulas re-derived, not transcribed):
  * PerturbedLennardJones: /root/reference/src/PairEvaluatorPerturbedLennardJones.h:117-155
  * Colloid (Everaers-Ejtehadi): /root/reference/src/PairEvaluatorColloid.h:101-269
  * ExpandedYukawa: /root/reference/src/PairEvaluatorExpandedYukawa.h:92-115
  * Hertz: /root/reference/src/PairEvaluatorHertz.h:93-110
  * DPD conservative: /root/reference/src/DPDPairEvaluatorGeneralWeight.h:165-183
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

__all__ = [
    "PairPotentialDef",
    "PAIR_POTENTIALS",
    "perturbed_lennard_jones",
    "colloid",
    "expanded_yukawa",
    "hertz",
    "dpd_general_weight_conservative",
    "lennard_jones",
    "morse",
    "gauss",
    "yukawa",
]


@dataclasses.dataclass(frozen=True)
class PairPotentialDef:
    """Registry entry for an isotropic pair potential."""

    name: str
    spec: dict  # user-facing param spec (for TypeParameter)
    precompute: Callable[[dict], dict]  # host tables -> kernel tables
    energy_force: Callable  # (rsq, rcutsq, params) -> (energy, force_div_r)


# ---------------------------------------------------------------------------
# Perturbed Lennard-Jones: WCA core + lambda-scaled attractive tail.
# ---------------------------------------------------------------------------
def _plj_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    eps4 = 4.0 * t["epsilon"]
    return {
        "lj1": eps4 * sigma_6 * sigma_6,
        "lj2": eps4 * sigma_6,
        "lam": t["attraction_scale_factor"],
        "rwcasq": np.cbrt(2.0) * t["sigma"] ** 2,
        "wca_shift": t["epsilon"] * (1.0 - t["attraction_scale_factor"]),
    }


def perturbed_lennard_jones(rsq, rcutsq, p):
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    f = r2inv * r6inv * (12.0 * p["lj1"] * r6inv - 6.0 * p["lj2"])
    e = r6inv * (p["lj1"] * r6inv - p["lj2"])
    in_core = rsq < p["rwcasq"]
    e = jnp.where(in_core, e + p["wca_shift"], e * p["lam"])
    f = jnp.where(in_core, f, f * p["lam"])
    active = p["lj1"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


# ---------------------------------------------------------------------------
# Colloid: integrated LJ (Hamaker); three regimes selected by radii.
# ---------------------------------------------------------------------------
def _colloid_precompute(t: dict) -> dict:
    return {
        "A": t["A"],
        "a_1": t["a_1"],
        "a_2": t["a_2"],
        "sigma_3": t["sigma"] ** 3,
    }


def _colloid_solvent_solvent(rsq, A, sigma_3):
    """Both radii zero: plain LJ with Hamaker A/36 prefactor."""
    sigma_6 = sigma_3 * sigma_3
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    c1 = A * sigma_6 / 36.0
    f = 6.0 * c1 * r2inv * r6inv * (2.0 * sigma_6 * r6inv - 1.0)
    e = c1 * r6inv * (sigma_6 * r6inv - 1.0)
    return e, f


def _colloid_sphere_point(rsq, A, sigma_3, a):
    """One radius zero: point particle vs sphere of radius a."""
    sigma_6 = sigma_3 * sigma_3
    asq = a * a
    am = asq - rsq
    am = jnp.where(am == 0, 1e-20, am)  # contact singularity guard
    am3 = am * am * am
    am6 = am3 * am3
    rsqsq = rsq * rsq
    fR = sigma_3 * A * a * asq / am3
    f = (
        (4.0 / 15.0)
        * fR
        * (2.0 * (asq + rsq) * (asq * (5.0 * asq + 22.0 * rsq) + 5.0 * rsqsq) * sigma_6 / am6 - 5.0)
        / am
    )
    e = (2.0 / 9.0) * fR * (
        1.0
        - (asq * (asq * (asq / 3.0 + 3.0 * rsq) + 4.2 * rsqsq) + rsq * rsqsq) * sigma_6 / am6
    )
    return e, f


def _colloid_sphere_sphere(rsq, A, sigma_3, ai, aj):
    """Both radii nonzero: Everaers-Ejtehadi sphere-sphere form."""
    sigma_6 = sigma_3 * sigma_3
    r = jnp.sqrt(rsq)
    k0 = ai * aj
    k1 = ai + aj
    k2 = ai - aj
    k3 = k1 + r
    k4 = k1 - r
    k5 = k2 + r
    k6 = k2 - r
    # overlap / degenerate guards (padded or touching spheres)
    tiny = 1e-20
    k3 = jnp.where(k3 == 0, tiny, k3)
    k4 = jnp.where(k4 == 0, tiny, k4)
    k5 = jnp.where(k5 == 0, tiny, k5)
    k6 = jnp.where(k6 == 0, tiny, k6)
    k7 = 1.0 / (k3 * k4)
    k8 = 1.0 / (k5 * k6)

    def pow7inv(x):
        xi = 1.0 / x
        x2 = xi * xi
        return x2 * x2 * x2 * xi

    g0 = pow7inv(k3)
    g1 = pow7inv(k4)
    g2 = pow7inv(k5)
    g3 = pow7inv(k6)

    h0 = ((k3 + 5.0 * k1) * k3 + 30.0 * k0) * g0
    h1 = ((k4 + 5.0 * k1) * k4 + 30.0 * k0) * g1
    h2 = ((k5 + 5.0 * k2) * k5 - 30.0 * k0) * g2
    h3 = ((k6 + 5.0 * k2) * k6 - 30.0 * k0) * g3

    g0 = g0 * (42.0 * k0 / k3 + 6.0 * k1 + k3)
    g1 = g1 * (42.0 * k0 / k4 + 6.0 * k1 + k4)
    g2 = g2 * (-42.0 * k0 / k5 + 6.0 * k2 + k5)
    g3 = g3 * (-42.0 * k0 / k6 + 6.0 * k2 + k6)

    fR = A * sigma_6 / r / 37800.0
    e_rep = fR * (h0 - h1 - h2 + h3)
    dUR = e_rep / r + 5.0 * fR * (g0 + g1 - g2 - g3)
    dUA = -A / 3.0 * r * ((2.0 * k0 * k7 + 1.0) * k7 + (2.0 * k0 * k8 - 1.0) * k8)
    f = (dUR + dUA) / r
    ratio = jnp.where(k8 / k7 > 0, k8 / k7, 1.0)
    e = e_rep + A / 6.0 * (2.0 * k0 * (k7 + k8) - jnp.log(ratio))
    return e, f


def colloid(rsq, rcutsq, p):
    A, s3, ai, aj = p["A"], p["sigma_3"], p["a_1"], p["a_2"]
    e_ss, f_ss = _colloid_solvent_solvent(rsq, A, s3)
    e_cs, f_cs = _colloid_sphere_point(rsq, A, s3, jnp.maximum(ai, aj))
    e_cc, f_cc = _colloid_sphere_sphere(rsq, A, s3, ai, aj)
    both_zero = (ai == 0) & (aj == 0)
    both_set = (ai != 0) & (aj != 0)
    e = jnp.where(both_zero, e_ss, jnp.where(both_set, e_cc, e_cs))
    f = jnp.where(both_zero, f_ss, jnp.where(both_set, f_cc, f_cs))
    active = A != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


# ---------------------------------------------------------------------------
# Expanded Yukawa: U = eps exp(-kappa (r - delta)) / (r - delta)
# ---------------------------------------------------------------------------
def _yukawa_precompute(t: dict) -> dict:
    return {"epsilon": t["epsilon"], "kappa": t["kappa"], "delta": t["delta"]}


def expanded_yukawa(rsq, rcutsq, p):
    r = jnp.sqrt(rsq)
    rd = r - p["delta"]
    rd = jnp.where(rd == 0, 1e-20, rd)
    rd_inv = 1.0 / rd
    e = p["epsilon"] * jnp.exp(-p["kappa"] * rd) * rd_inv
    f = e * (p["kappa"] + rd_inv) / r
    active = p["epsilon"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


# ---------------------------------------------------------------------------
# Hertz: U = eps (1 - r/rcut)^{5/2}
# ---------------------------------------------------------------------------
def _hertz_precompute(t: dict) -> dict:
    return {"epsilon": t["epsilon"]}


def hertz(rsq, rcutsq, p):
    r = jnp.sqrt(rsq)
    rcut = jnp.sqrt(rcutsq)
    x = jnp.maximum(1.0 - r / rcut, 0.0)
    ex32 = p["epsilon"] * x * jnp.sqrt(x)
    e = ex32 * x
    f = 2.5 * ex32 / (r * rcut)
    active = p["epsilon"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


# ---------------------------------------------------------------------------
# DPD general weight: conservative branch (thermostat lives in dpd driver).
# ---------------------------------------------------------------------------
def _dpd_precompute(t: dict) -> dict:
    return {"A": t["A"], "gamma": t["gamma"], "s": t["s"]}


def dpd_general_weight_conservative(rsq, rcutsq, p):
    rinv = jnp.where(rsq > 0, 1.0 / jnp.sqrt(rsq), 0.0)
    r = jnp.sqrt(rsq)
    rcut = jnp.sqrt(rcutsq)
    rcutinv = 1.0 / rcut
    f = p["A"] * (rinv - rcutinv)
    e = p["A"] * (rcut - r) - 0.5 * p["A"] * rcutinv * (rcutsq - rsq)
    return e, f


# ---------------------------------------------------------------------------
# HOOMD-core substrate potentials (SURVEY §2.13). azplugins scripts mix
# the plugin potentials with HOOMD's own md.pair classes (e.g. the
# reference's own examples pair plugin barriers with plain LJ solvent),
# so migration needs the textbook set too. Formulas are standard
# literature physics, re-derived: LJ (Jones 1924), Morse (1929),
# Gaussian core (Stillinger 1976), screened Coulomb (Yukawa 1935).
# ---------------------------------------------------------------------------
def _lj_precompute(t: dict) -> dict:
    sigma_6 = t["sigma"] ** 6
    eps4 = 4.0 * t["epsilon"]
    return {"lj1": eps4 * sigma_6 * sigma_6, "lj2": eps4 * sigma_6}


def lennard_jones(rsq, rcutsq, p):
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    f = r2inv * r6inv * (12.0 * p["lj1"] * r6inv - 6.0 * p["lj2"])
    e = r6inv * (p["lj1"] * r6inv - p["lj2"])
    active = p["lj1"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


def _morse_precompute(t: dict) -> dict:
    return {"D0": t["D0"], "alpha": t["alpha"], "r0": t["r0"]}


def morse(rsq, rcutsq, p):
    r = jnp.sqrt(rsq)
    ea = jnp.exp(-p["alpha"] * (r - p["r0"]))
    e = p["D0"] * ea * (ea - 2.0)
    f = 2.0 * p["D0"] * p["alpha"] * ea * (ea - 1.0) / r
    active = p["D0"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


def _gauss_precompute(t: dict) -> dict:
    # vectorized over type-pair tables: no python truthiness on arrays
    s2 = np.asarray(t["sigma"]) ** 2
    sig2inv = np.where(s2 != 0, 1.0 / np.where(s2 != 0, s2, 1.0), 0.0)
    return {"epsilon": t["epsilon"], "sig2inv": sig2inv}


def gauss(rsq, rcutsq, p):
    e = p["epsilon"] * jnp.exp(-0.5 * rsq * p["sig2inv"])
    f = e * p["sig2inv"]
    active = p["epsilon"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


def _plain_yukawa_precompute(t: dict) -> dict:
    return {"epsilon": t["epsilon"], "kappa": t["kappa"]}


def yukawa(rsq, rcutsq, p):
    r = jnp.sqrt(rsq)
    rinv = 1.0 / r
    e = p["epsilon"] * jnp.exp(-p["kappa"] * r) * rinv
    f = e * (p["kappa"] + rinv) * rinv
    active = p["epsilon"] != 0
    return jnp.where(active, e, 0.0), jnp.where(active, f, 0.0)


PAIR_POTENTIALS = {
    "PerturbedLennardJones": PairPotentialDef(
        name="PerturbedLennardJones",
        spec={"epsilon": float, "sigma": float, "attraction_scale_factor": float},
        precompute=_plj_precompute,
        energy_force=perturbed_lennard_jones,
    ),
    "Colloid": PairPotentialDef(
        name="Colloid",
        spec={"A": float, "a_1": float, "a_2": float, "sigma": float},
        precompute=_colloid_precompute,
        energy_force=colloid,
    ),
    "ExpandedYukawa": PairPotentialDef(
        name="ExpandedYukawa",
        spec={"epsilon": float, "kappa": float, "delta": float},
        precompute=_yukawa_precompute,
        energy_force=expanded_yukawa,
    ),
    "Hertz": PairPotentialDef(
        name="Hertz",
        spec={"epsilon": float},
        precompute=_hertz_precompute,
        energy_force=hertz,
    ),
    "DPDGeneralWeight": PairPotentialDef(
        name="DPDGeneralWeight",
        spec={"A": float, "gamma": float, "s": float},
        precompute=_dpd_precompute,
        energy_force=dpd_general_weight_conservative,
    ),
    # HOOMD-core substrate set (SURVEY §2.13)
    "LJ": PairPotentialDef(
        name="LJ",
        spec={"epsilon": float, "sigma": float},
        precompute=_lj_precompute,
        energy_force=lennard_jones,
    ),
    "Morse": PairPotentialDef(
        name="Morse",
        spec={"D0": float, "alpha": float, "r0": float},
        precompute=_morse_precompute,
        energy_force=morse,
    ),
    "Gaussian": PairPotentialDef(
        name="Gaussian",
        spec={"epsilon": float, "sigma": float},
        precompute=_gauss_precompute,
        energy_force=gauss,
    ),
    "Yukawa": PairPotentialDef(
        name="Yukawa",
        spec={"epsilon": float, "kappa": float},
        precompute=_plain_yukawa_precompute,
        energy_force=yukawa,
    ),
}
