"""HOOMD-core substrate potentials (SURVEY §2.13): LJ, Morse, Gaussian,
Yukawa pairs; Harmonic, FENEWCA bonds.

azplugins scripts mix plugin potentials with HOOMD's textbook set, so
migration needs them. Each is checked against an independent float64
numpy oracle over a sweep of separations (force additionally against
-dU/dr by central difference — catches any sign-convention slip), and
the pair set through the full Simulation two-particle path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import azplugins_tpu as az
from azplugins_tpu.ops.evaluators.bond import BOND_POTENTIALS
from azplugins_tpu.ops.evaluators.pair import PAIR_POTENTIALS

RTOL = 1e-5


def _eval(kind, name, params, r, rcut=3.0):
    reg = PAIR_POTENTIALS if kind == "pair" else BOND_POTENTIALS
    d = reg[name]
    p = {k: jnp.float32(v) for k, v in d.precompute(params).items()}
    rsq = jnp.asarray((r * r).astype(np.float32))
    if kind == "pair":
        e, f = d.energy_force(rsq, jnp.float32(rcut * rcut), p)
    else:
        e, f = d.energy_force(rsq, p)
    return np.asarray(e, np.float64), np.asarray(f, np.float64)


def _check(name, got_e, got_f, ref_e, ref_f, rtol=RTOL):
    scale_e = np.maximum(np.abs(ref_e), 2e-2 * np.abs(ref_e).max())
    scale_f = np.maximum(np.abs(ref_f), 2e-2 * np.abs(ref_f).max())
    np.testing.assert_array_less(
        np.abs(got_e - ref_e) / scale_e, rtol, err_msg=f"{name} energy"
    )
    np.testing.assert_array_less(
        np.abs(got_f - ref_f) / scale_f, rtol, err_msg=f"{name} force"
    )


def _force_from_energy(u_fn, r, h=1e-6):
    """-dU/dr / r by central difference — the force_div_r convention."""
    return -(u_fn(r + h) - u_fn(r - h)) / (2 * h) / r


# -- pair oracles ------------------------------------------------------------
def test_lj_oracle():
    eps, sig = 1.7, 1.1
    r = np.linspace(0.95, 2.9, 400, dtype=np.float64)

    def u(r):
        return 4 * eps * ((sig / r) ** 12 - (sig / r) ** 6)

    ge, gf = _eval("pair", "LJ", dict(epsilon=eps, sigma=sig), r)
    _check("lj", ge, gf, u(r), _force_from_energy(u, r))


def test_morse_oracle():
    D0, alpha, r0 = 1.3, 2.5, 1.1
    r = np.linspace(0.7, 2.9, 400, dtype=np.float64)

    def u(r):
        return D0 * (np.exp(-2 * alpha * (r - r0)) - 2 * np.exp(-alpha * (r - r0)))

    ge, gf = _eval("pair", "Morse", dict(D0=D0, alpha=alpha, r0=r0), r)
    _check("morse", ge, gf, u(r), _force_from_energy(u, r), rtol=3e-5)


def test_gaussian_oracle():
    eps, sig = 2.0, 0.9
    r = np.linspace(0.3, 2.9, 400, dtype=np.float64)

    def u(r):
        return eps * np.exp(-0.5 * (r / sig) ** 2)

    ge, gf = _eval("pair", "Gaussian", dict(epsilon=eps, sigma=sig), r)
    _check("gauss", ge, gf, u(r), _force_from_energy(u, r), rtol=3e-5)


def test_yukawa_oracle():
    eps, kappa = 1.4, 1.8
    r = np.linspace(0.5, 2.9, 400, dtype=np.float64)

    def u(r):
        return eps * np.exp(-kappa * r) / r

    ge, gf = _eval("pair", "Yukawa", dict(epsilon=eps, kappa=kappa), r)
    _check("yukawa", ge, gf, u(r), _force_from_energy(u, r), rtol=3e-5)


# -- bond oracles ------------------------------------------------------------
def test_harmonic_oracle():
    k, r0 = 120.0, 1.2
    r = np.linspace(0.6, 1.9, 300, dtype=np.float64)

    def u(r):
        return 0.5 * k * (r - r0) ** 2

    ge, gf = _eval("bond", "Harmonic", dict(k=k, r0=r0), r)
    _check("harmonic", ge, gf, u(r), _force_from_energy(u, r), rtol=2e-4)


def test_fenewca_oracle():
    k, R0, eps, sig, delta = 30.0, 1.5, 1.0, 1.0, 0.1
    r = np.linspace(0.95, 1.45, 300, dtype=np.float64)

    def u(r):
        rs = r - delta
        fene = -0.5 * k * R0**2 * np.log(1 - (rs / R0) ** 2)
        wca = np.where(
            rs < 2 ** (1 / 6) * sig,
            4 * eps * ((sig / rs) ** 12 - (sig / rs) ** 6) + eps,
            0.0,
        )
        return fene + wca

    ge, gf = _eval(
        "bond", "FENEWCA", dict(k=k, R0=R0, epsilon=eps, sigma=sig, delta=delta), r
    )
    # exclude the WCA cut from the central difference (kink)
    keep = np.abs(r - delta - 2 ** (1 / 6) * sig) > 1e-3
    _check(
        "fenewca", ge[keep], gf[keep], u(r)[keep],
        _force_from_energy(u, r)[keep], rtol=2e-4,
    )


# -- end-to-end driver plumbing ---------------------------------------------
@pytest.mark.parametrize(
    "cls,params,rcut",
    [
        (az.pair.LJ, dict(epsilon=1.0, sigma=1.0), 2.5),
        (az.pair.Morse, dict(D0=1.0, alpha=3.0, r0=1.0), 2.5),
        (az.pair.Gaussian, dict(epsilon=1.5, sigma=0.8), 2.5),
        (az.pair.Yukawa, dict(epsilon=1.2, kappa=1.5), 2.5),
    ],
)
def test_pair_two_particle_sim(
    cls, params, rcut, two_particle_snapshot_factory, simulation_factory
):
    d = 1.3
    sim = simulation_factory(two_particle_snapshot_factory(d=d, L=20))
    pot = cls(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=rcut)
    pot.params[("A", "A")] = params
    sim.operations.integrator = az.md.Integrator(
        dt=0.001, methods=[az.md.methods.ConstantVolume()], forces=[pot]
    )
    sim.run(0)
    name = cls._evaluator_name
    dd = PAIR_POTENTIALS[name]
    p = {k: jnp.float32(v) for k, v in dd.precompute(params).items()}
    e_ref, fdr_ref = dd.energy_force(
        jnp.float32(d * d), jnp.float32(rcut * rcut), p
    )
    f = np.asarray(pot.forces)
    # particle 0 sits at -d/2: repulsive force_div_r > 0 pushes it to -x
    np.testing.assert_allclose(
        f[0, 0], -float(fdr_ref) * d, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(f[0], -f[1], rtol=1e-6)
    np.testing.assert_allclose(
        float(np.asarray(pot.energy)), float(e_ref), rtol=1e-5
    )


def test_harmonic_bond_sim_oscillates(
    bonded_two_particle_snapshot_factory, simulation_factory
):
    """Stretched harmonic bond pulls the pair together under NVE and
    conserves energy (sign convention + driver plumbing)."""
    k, r0 = 50.0, 1.0
    sim = simulation_factory(bonded_two_particle_snapshot_factory(d=1.4, L=20))
    b = az.bond.Harmonic()
    b.params["A-A"] = dict(k=k, r0=r0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.001, methods=[az.md.methods.ConstantVolume()], forces=[b]
    )
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.run(0)
    thermo._attach(sim)
    e0 = float(np.asarray(b.energy)) + float(thermo.kinetic_energy)
    p0 = sim.state.get_snapshot().particles.position
    sim.run(60)
    p1 = sim.state.get_snapshot().particles.position
    d1 = np.linalg.norm(p1[0] - p1[1])
    assert d1 < np.linalg.norm(p0[0] - p0[1])  # pulled inward
    e1 = float(np.asarray(b.energy)) + float(thermo.kinetic_energy)
    np.testing.assert_allclose(e1, e0, rtol=1e-3, atol=1e-3)


def test_fenewca_bond_sim_attracts(
    bonded_two_particle_snapshot_factory, simulation_factory
):
    sim = simulation_factory(bonded_two_particle_snapshot_factory(d=1.35, L=20))
    b = az.bond.FENEWCA()
    b.params["A-A"] = dict(k=30.0, R0=1.5, epsilon=1.0, sigma=1.0, delta=0.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.0005, methods=[az.md.methods.ConstantVolume()], forces=[b]
    )
    p0 = sim.state.get_snapshot().particles.position
    sim.run(40)
    p1 = sim.state.get_snapshot().particles.position
    assert np.linalg.norm(p1[0] - p1[1]) < np.linalg.norm(p0[0] - p0[1])
