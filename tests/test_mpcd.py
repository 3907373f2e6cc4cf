"""MPCD solvent stream in the velocity computes.

Parity targets: the reference's ParticleDataLoader pair abstraction
(/root/reference/src/ParticleDataLoader.h:24-125) lets VelocityCompute and
VelocityFieldCompute read both the HOOMD group and the MPCD particle data
(/root/reference/src/VelocityFieldCompute.h:331-352). Here the MPCD stream
is a second snapshot block carried by the Simulation.
"""

import numpy as np
import numpy.testing
import pytest

import azplugins_tpu as az


def _sim_with_mpcd():
    snap = az.Snapshot(N=2, mpcd_N=3)
    snap.configuration.box = [10, 10, 10, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[0, 0, 0], [1, 0, 0]]
    snap.particles.velocity[:] = [[2.0, 0, 0], [0, 0, 4.0]]
    snap.particles.mass[:] = [1.0, 3.0]
    snap.mpcd.position[:] = [[-2, 0, 0], [2, 2, 0], [0, -3, 1]]
    snap.mpcd.velocity[:] = [[1, 0, 0], [1, 0, 0], [1, 0, 0]]
    snap.mpcd.mass = 0.5
    sim = az.Simulation(seed=3)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.0, methods=[az.md.methods.ConstantVolume()]
    )
    return sim


def test_velocity_compute_with_mpcd():
    sim = _sim_with_mpcd()
    vc = az.compute.VelocityCompute(
        filter=az.filter.All(), include_mpcd_particles=True
    )
    sim.operations.computes.append(vc)
    sim.run(0)
    # (1*2 + 3*0.5, 0, 3*4) / (1 + 3 + 1.5)
    numpy.testing.assert_allclose(
        vc.velocity, [3.5 / 5.5, 0.0, 12.0 / 5.5], atol=1e-6
    )


def test_velocity_compute_mpcd_only():
    """filter=None selects no HOOMD particles (reference default)."""
    sim = _sim_with_mpcd()
    vc = az.compute.VelocityCompute(include_mpcd_particles=True)
    sim.operations.computes.append(vc)
    sim.run(0)
    numpy.testing.assert_allclose(vc.velocity, [1.0, 0.0, 0.0], atol=1e-6)


def test_velocity_field_with_mpcd():
    sim = _sim_with_mpcd()
    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=[2, 0, 0],
        lower_bounds=[-5, 0, 0],
        upper_bounds=[5, 0, 0],
        filter=az.filter.All(),
        include_mpcd_particles=True,
    )
    sim.operations.computes.append(field)
    sim.run(0)
    v = np.asarray(field.velocities)
    assert v.shape == (2, 3)
    # x<0 bin: mpcd at x=-2 (m 0.5, v x=1) only -> v = (1,0,0)
    numpy.testing.assert_allclose(v[0], [1.0, 0.0, 0.0], atol=1e-6)
    # x>=0 bin: A(m1,v(2,0,0)) + A(m3,v(0,0,4)) + 2 mpcd (m.5,v(1,0,0))
    m = 1.0 + 3.0 + 2 * 0.5
    numpy.testing.assert_allclose(
        v[1], [(1 * 2 + 2 * 0.5 * 1) / m, 0.0, 3 * 4 / m], atol=1e-6
    )


def test_mpcd_requires_snapshot_block():
    snap = az.Snapshot(N=1)
    snap.configuration.box = [5, 5, 5, 0, 0, 0]
    snap.particles.types = ["A"]
    sim = az.Simulation(seed=0)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.0, methods=[az.md.methods.ConstantVolume()]
    )
    vc = az.compute.VelocityCompute(
        filter=az.filter.All(), include_mpcd_particles=True
    )
    sim.operations.computes.append(vc)
    with pytest.raises(ValueError, match="MPCD"):
        sim.run(0)


def test_mpcd_checkpoint_roundtrip(tmp_path):
    from azplugins_tpu.io import load_checkpoint, save_checkpoint

    sim = _sim_with_mpcd()
    sim.run(0)
    path = str(tmp_path / "ckpt.azt")
    save_checkpoint(sim, path)
    snap, ts = load_checkpoint(path)
    assert snap.mpcd.N == 3
    numpy.testing.assert_allclose(
        snap.mpcd.position, [[-2, 0, 0], [2, 2, 0], [0, -3, 1]]
    )
    assert snap.mpcd.mass == 0.5


def test_mpcd_snapshot_roundtrip():
    sim = _sim_with_mpcd()
    sim.run(0)
    snap = sim.state.get_snapshot()
    assert snap.mpcd.N == 3
    numpy.testing.assert_allclose(snap.mpcd.velocity, np.ones((3, 3)) * [1, 0, 0])
    assert snap.mpcd.mass == 0.5
