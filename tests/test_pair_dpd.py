"""DPD thermostat tests: statistical temperature + pair-reproducible noise.

Replicates the reference statistical test
(/root/reference/src/pytest/test_pair_dpd.py:13-46) and adds this
engine's bitwise-reproducibility contract.
"""

import numpy
import pytest

import azplugins_tpu as az


def test_dpd_temperature(simulation_factory, lattice_snapshot_factory):
    """A=0 DPD (drag + noise only) must thermostat NVE to kT=1.5."""
    snap = lattice_snapshot_factory(n=10, a=0.6)
    sim = simulation_factory(snap)
    sim.state.thermalize_particle_momenta(filter=az.filter.All(), kT=1.5)

    integrator = az.md.Integrator(dt=0.01)
    sim.operations.integrator = integrator

    cell = az.md.nlist.Cell(buffer=0.4)
    dpd = az.pair.DPDGeneralWeight(nlist=cell, kT=1.5, default_r_cut=1.0)
    dpd.params[("A", "A")] = dict(A=0.0, gamma=4.5, s=0.5)
    integrator.forces.append(dpd)
    integrator.methods.append(az.md.methods.ConstantVolume(az.filter.All()))

    thermo = az.compute.ThermodynamicQuantities(filter=az.filter.All())
    sim.operations.computes.append(thermo)

    sim.run(10)
    num_samples = 100
    kT = numpy.zeros(num_samples)
    for sample in range(num_samples):
        kT[sample] = thermo.kinetic_temperature
        sim.run(1)
    assert numpy.mean(kT) == pytest.approx(1.5, 0.1)


def test_dpd_trajectory_reproducible(simulation_factory, lattice_snapshot_factory):
    """Same seed -> bitwise identical trajectory (counter RNG contract)."""

    def build():
        snap = lattice_snapshot_factory(n=6, a=0.8)
        sim = simulation_factory(snap, seed=9)
        sim.state.thermalize_particle_momenta(filter=az.filter.All(), kT=1.0)
        integ = az.md.Integrator(dt=0.01)
        dpd = az.pair.DPDGeneralWeight(
            nlist=az.md.nlist.Cell(buffer=0.4), kT=1.0, default_r_cut=1.0
        )
        dpd.params[("A", "A")] = dict(A=5.0, gamma=4.5, s=2.0)
        integ.forces = [dpd]
        integ.methods = [az.md.methods.ConstantVolume()]
        sim.operations.integrator = integ
        return sim

    sim1, sim2 = build(), build()
    # run with different chunking -- per-step physics must be identical
    sim1.run(30)
    for _ in range(3):
        sim2.run(10)
    p1 = sim1.state.get_snapshot().particles.velocity
    p2 = sim2.state.get_snapshot().particles.velocity
    numpy.testing.assert_array_equal(p1, p2)


def test_dpd_conservative_energy_matches(two_particle_snapshot_factory, simulation_factory):
    """kT=0: random force zero, force = A(1 - r/rc) along x."""
    sim = simulation_factory(two_particle_snapshot_factory(d=0.5, L=20))
    integ = az.md.Integrator(dt=0.001)
    dpd = az.pair.DPDGeneralWeight(
        nlist=az.md.nlist.Cell(buffer=0.4), kT=0.0, default_r_cut=1.0
    )
    dpd.params[("A", "A")] = dict(A=2.0, gamma=4.5, s=2.0)
    integ.forces = [dpd]
    integ.methods = [az.md.methods.ConstantVolume()]
    sim.operations.integrator = integ
    sim.run(0)
    numpy.testing.assert_allclose(dpd.forces[1][0], 2.0 * (1 - 0.5), rtol=1e-5)


def test_dpd_conserves_momentum(simulation_factory, lattice_snapshot_factory):
    """DPD's defining property: drag + random forces are pairwise
    antisymmetric (Newton), so total momentum is conserved exactly
    even though the thermostat injects energy (reference
    DPDPairEvaluatorGeneralWeight.h:198-255). Catches any asymmetry in
    the half-stencil / kernel stochastic force scatter."""
    import numpy as np

    sim = simulation_factory(lattice_snapshot_factory(n=8, a=0.9))
    dpd = az.pair.DPDGeneralWeight(
        nlist=az.md.nlist.Cell(buffer=0.4), kT=1.0, default_r_cut=1.0
    )
    dpd.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[dpd]
    )
    sim.run(200)
    snap = sim.state.get_snapshot()
    p = (snap.particles.velocity * snap.particles.mass[:, None]).sum(axis=0)
    v_scale = np.abs(snap.particles.velocity).max()
    assert np.abs(p).max() < 5e-3 * v_scale * snap.particles.N ** 0.5
