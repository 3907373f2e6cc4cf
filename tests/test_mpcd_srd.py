"""MPCD-SRD solvent dynamics (az.mpcd.SRD).

Physics invariants of stochastic rotation dynamics: collisions conserve
per-cell (hence total) momentum exactly and, without a thermostat,
kinetic energy exactly (rotations are isometries); the cell-level
rescale thermostat drives the solvent temperature to kT; collisions key
on the absolute timestep, so trajectories are bitwise chunking-invariant
and checkpoint-reproducible.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import azplugins_tpu as az


def _solvent_sim(N=4000, L=8.0, kT_init=1.0, seed=3, mpcd_kwargs=None):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=8, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((8, 3)) - 0.5) * L * 0.9
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, np.sqrt(kT_init), (N, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    sim = az.Simulation(seed=7)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=1.5)
    pot.params[("A", "A")] = dict(epsilon=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[pot]
    )
    sim.mpcd_dynamics = az.mpcd.SRD(
        dt=0.02, **(dict(period=5, angle=130.0, cell_size=1.0)
                    | (mpcd_kwargs or {}))
    )
    return sim


def _kT(vel):
    return float(np.mean(np.sum(np.asarray(vel) ** 2, axis=1)) / 3.0)


def test_srd_conserves_momentum_and_energy():
    sim = _solvent_sim()
    v0 = np.asarray(sim._mpcd["velocity"])
    p0 = v0.sum(axis=0)
    e0 = np.sum(v0 * v0)
    sim.run(60)  # 12 collision events
    v1 = np.asarray(sim._mpcd["velocity"])
    assert not np.allclose(v0, v1)  # collisions happened
    np.testing.assert_allclose(v1.sum(axis=0), p0, atol=2e-2)
    np.testing.assert_allclose(np.sum(v1 * v1), e0, rtol=1e-4)
    # positions moved and stayed in the box
    p = np.asarray(sim._mpcd["position"])
    assert np.all(np.abs(p) <= 4.0 + 1e-5)


def test_srd_thermostat_drives_kT():
    sim = _solvent_sim(kT_init=4.0, mpcd_kwargs=dict(kT=1.0))
    assert _kT(sim._mpcd["velocity"]) > 3.0
    sim.run(100)
    assert abs(_kT(sim._mpcd["velocity"]) - 1.0) < 0.15


def test_srd_chunking_invariant():
    a = _solvent_sim(seed=11)
    a.run(40)
    b = _solvent_sim(seed=11)
    for n in (7, 13, 20):
        b.run(n)
    np.testing.assert_array_equal(
        np.asarray(a._mpcd["position"]), np.asarray(b._mpcd["position"])
    )
    np.testing.assert_array_equal(
        np.asarray(a._mpcd["velocity"]), np.asarray(b._mpcd["velocity"])
    )


def test_srd_resume_reproduces():
    """Restarting from the mid-run stream state reproduces the continuous
    solvent trajectory bitwise (collisions key on absolute timestep)."""
    a = _solvent_sim(seed=21)
    a.run(50)
    ref_p = np.asarray(a._mpcd["position"])

    b = _solvent_sim(seed=21)
    b.run(30)
    # simulate a restart: rebuild an identical sim, inject the stream
    c = _solvent_sim(seed=21)
    c._mpcd = {**c._mpcd,
               "position": jnp.asarray(np.asarray(b._mpcd["position"])),
               "velocity": jnp.asarray(np.asarray(b._mpcd["velocity"]))}
    c.timestep = 30
    c.run(20)
    np.testing.assert_array_equal(np.asarray(c._mpcd["position"]), ref_p)


def test_srd_body_force_accelerates():
    sim = _solvent_sim(mpcd_kwargs=dict(body_force=(0.05, 0.0, 0.0), kT=1.0))
    v0x = float(np.asarray(sim._mpcd["velocity"])[:, 0].mean())
    sim.run(50)
    v1x = float(np.asarray(sim._mpcd["velocity"])[:, 0].mean())
    # COM momentum is immune to collisions and the thermostat acts only
    # on relative velocities, so the drift integrates the body force
    np.testing.assert_allclose(v1x - v0x, 0.05 * 50 * 0.02, rtol=0.05)


def test_srd_feeds_velocity_compute():
    sim = _solvent_sim(mpcd_kwargs=dict(body_force=(0.1, 0.0, 0.0)))
    vc = az.compute.VelocityCompute(
        filter=az.filter.All(), include_mpcd_particles=True
    )
    sim.operations.computes.append(vc)
    sim.run(40)
    vc._attach(sim)
    # solvent dominates the count; its x-drift shows in the mean velocity
    assert abs(vc.velocity[0]) > 0.05


def test_srd_plates_confine_and_poiseuille():
    """Slit geometry: bounce-back plates confine the solvent, and a
    tangential body force develops the parabolic Poiseuille profile
    (the classic MPCD validation; measured with the same binning the
    reference's VelocityFieldCompute does)."""
    rng = np.random.default_rng(5)
    N, L = 10000, 10.0
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(
        [L, L, 0.98 * L]
    )
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(seed=9)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    sim.mpcd_dynamics = az.mpcd.SRD(
        dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0,
        body_force=(0.04, 0.0, 0.0), plates=("z", L),
    )
    sim.run(1200)  # develop the flow
    # accumulate the vx(z) profile over several decorrelated snapshots
    nbins = 10
    prof = np.zeros(nbins)
    cntb = np.zeros(nbins)
    for _ in range(8):
        sim.run(50)
        p = np.asarray(sim._mpcd["position"])
        v = np.asarray(sim._mpcd["velocity"])
        assert np.all(np.abs(p[:, 2]) <= L / 2 + 1e-4)  # confined
        b = np.clip(((p[:, 2] / L + 0.5) * nbins).astype(int), 0, nbins - 1)
        np.add.at(prof, b, v[:, 0])
        np.add.at(cntb, b, 1.0)
    prof /= np.maximum(cntb, 1.0)
    center = prof[nbins // 2 - 1 : nbins // 2 + 1].mean()
    walls = (prof[0] + prof[-1]) / 2
    assert center > 0.05, prof  # flow developed
    # near-parabolic with near-no-slip walls (virtual-particle fill; the
    # residual is the half-bin offset from the wall)
    assert center > 3.0 * max(walls, 1e-6), prof
    # symmetry about the mid-plane within statistical noise
    asym = np.abs(prof - prof[::-1]).max()
    assert asym < 0.5 * center + 0.05, prof


def test_srd_checkpoint_roundtrip(tmp_path):
    """A checkpoint carries the advanced solvent stream; restarting at a
    collision-aligned timestep reproduces the continuous solvent
    trajectory bitwise (collisions key on the absolute timestep and the
    stream re-anchors at the restart point, which IS a collision)."""
    from azplugins_tpu.io import load_checkpoint, save_checkpoint

    a = _solvent_sim(seed=31)
    a.run(60)
    ref = np.asarray(a._mpcd["position"])

    b = _solvent_sim(seed=31)
    b.run(30)  # 30 % period(5) == 0: collision-aligned
    path = str(tmp_path / "srd.azt")
    save_checkpoint(b, path)

    snap, ts = load_checkpoint(path)
    assert snap.mpcd.N == 4000
    c = _solvent_sim(seed=31)
    c._set_snapshot(snap)
    c.timestep = ts
    c.run(30)
    np.testing.assert_array_equal(np.asarray(c._mpcd["position"]), ref)


def _coupled_sim(N_s=4000, N_m=32, L=8.0, mass_m=5.0, seed=3,
                 solvent_drift=0.0, kT=None, period=10):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N_m, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["C"]
    snap.particles.position[:] = (rng.random((N_m, 3)) - 0.5) * L
    snap.particles.mass[:] = mass_m
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    snap.mpcd.velocity[:, 0] += solvent_drift
    sim = az.Simulation(seed=13)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    srd = az.mpcd.SRD(dt=0.02, period=period, angle=130.0, cell_size=1.0,
                      kT=kT)
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    return sim


def test_coupling_conserves_momentum_and_energy():
    """A joint collision is a mass-weighted rotation about each cell's
    COM: total (solvent + solute) momentum and kinetic energy are exact
    invariants."""
    sim = _coupled_sim()
    m_m = np.asarray(sim._state.mass)
    v_m0 = np.asarray(sim._state.velocity)
    v_s0 = np.asarray(sim._mpcd["velocity"])
    p0 = v_s0.sum(axis=0) + (m_m[:, None] * v_m0).sum(axis=0)
    e0 = np.sum(v_s0**2) + np.sum(m_m[:, None] * v_m0**2)
    sim.run(60)
    v_m1 = np.asarray(sim.state.get_snapshot().particles.velocity)
    v_s1 = np.asarray(sim._mpcd["velocity"])
    assert not np.allclose(v_m1, v_m0)  # solutes were kicked
    p1 = v_s1.sum(axis=0) + (m_m[:, None] * v_m1).sum(axis=0)
    e1 = np.sum(v_s1**2) + np.sum(m_m[:, None] * v_m1**2)
    np.testing.assert_allclose(p1, p0, atol=5e-2)
    np.testing.assert_allclose(e1, e0, rtol=5e-4)


def test_coupling_advects_solutes():
    """Solutes at rest in a uniformly drifting solvent acquire the drift
    velocity through collisions alone (no explicit drag force)."""
    sim = _coupled_sim(solvent_drift=0.6, period=5)
    sim.run(200)
    v_m = np.asarray(sim.state.get_snapshot().particles.velocity)
    assert abs(v_m[:, 0].mean() - 0.6) < 0.15, v_m[:, 0].mean()
    assert abs(v_m[:, 1].mean()) < 0.15


def test_coupling_chunking_invariant():
    a = _coupled_sim(seed=7)
    a.run(50)
    b = _coupled_sim(seed=7)
    for n in (9, 21, 20):
        b.run(n)
    np.testing.assert_array_equal(
        np.asarray(a.state.get_snapshot().particles.velocity),
        np.asarray(b.state.get_snapshot().particles.velocity),
    )
    np.testing.assert_array_equal(
        np.asarray(a._mpcd["position"]), np.asarray(b._mpcd["position"])
    )


def test_coupling_runs_in_graph_without_chunk_splits():
    """With the default trigger, the joint collision is windowed INSIDE
    the compiled chunk: an aligned 100-step run with period 10 must
    dispatch ONE chunk, not one per collision (each host split costs a
    dispatch + blocking sync)."""
    sim = _coupled_sim(period=10)
    sim.run(10)  # attach + compile + settle alignment
    sim._seg_adapt = False  # quiet the interval-adaptation quantum splits
    coupling = sim.operations.updaters[0]
    assert coupling._ingraph

    calls = []
    orig = sim._run_chunk

    def counting(*args, **kw):
        calls.append(args[3])  # n_steps
        return orig(*args, **kw)

    sim._run_chunk = counting
    sim.run(100)
    assert len(calls) == 1, calls
    # and collisions really happened in that single chunk: the anchor
    # advanced to the last collision clock (110)
    assert int(sim._mpcd["_srd_anchor"][2]) == 110


def test_coupling_custom_trigger_falls_back_to_host():
    """A replaced trigger cannot be windowed; the coupling must fall back
    to host-boundary firing (and still fire)."""
    sim = _coupled_sim(period=10)
    coupling = sim.operations.updaters[0]
    coupling.trigger = az.trigger.Periodic(10, phase=3)
    v0 = np.asarray(sim._state.velocity).copy()
    sim.run(30)
    assert not coupling._ingraph
    v1 = np.asarray(sim.state.get_snapshot().particles.velocity)
    assert not np.allclose(v1, v0)  # collisions still coupled the solutes


def test_srd_rejects_bad_geometry():
    sim = _solvent_sim(mpcd_kwargs=dict(cell_size=0.9))
    with pytest.raises(ValueError, match="multiple"):
        sim.run(5)
    snap = az.Snapshot(N=2, mpcd_N=10)
    snap.configuration.box = [8, 8, 8, 0.2, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    sim2 = az.Simulation(seed=1)
    sim2.create_state_from_snapshot(snap)
    sim2.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    sim2.mpcd_dynamics = az.mpcd.SRD(dt=0.01)
    with pytest.raises(ValueError, match="orthorhombic"):
        sim2.run(5)


# -- round-3 review regressions ---------------------------------------------


def test_srd_plates_require_kT():
    """The no-slip virtual fill samples wall momenta at kT: plates
    without a thermostat target would silently thermalize the boundary
    layer at an arbitrary temperature."""
    with pytest.raises(ValueError, match="kT"):
        az.mpcd.SRD(dt=0.02, plates=("z", 8.0))


def test_srd_plates_seam_binning():
    """Regression: with a grid shift, the layer at the top plate must
    bin into the extra boundary cell, never wrap across the periodic
    seam into the bottom layer — a shared seam cell would rotate
    momentum THROUGH the walls."""
    from azplugins_tpu.core.box import Box

    L = 8.0
    srd = az.mpcd.SRD(dt=0.02, cell_size=1.0, kT=1.0, plates=("z", L))
    srd._validate(Box.cube(L))
    eps = 1e-3
    pos = jnp.asarray(
        [[0.0, 0.0, L / 2 - eps], [0.0, 0.0, -L / 2 + eps]], jnp.float32
    )
    for s in np.linspace(0.0, 0.999, 21):
        shift = jnp.asarray([0.0, 0.0, s], jnp.float32)
        cid = np.asarray(srd._cell_ids(pos, shift))
        assert cid[0] != cid[1], s
    # sanity: an unconfined axis DOES wrap (periodic images share cells)
    srd_p = az.mpcd.SRD(dt=0.02, cell_size=1.0)
    srd_p._validate(Box.cube(L))
    pos_x = jnp.asarray(
        [[L / 2 - eps, 0.0, 0.0], [-L / 2 + eps, 0.0, 0.0]], jnp.float32
    )
    cid = np.asarray(
        srd_p._cell_ids(pos_x, jnp.asarray([0.5, 0.0, 0.0], jnp.float32))
    )
    assert cid[0] == cid[1]


def test_coupling_anchor_matches_md_clock():
    """Regression: the joint collision must act on solvent and solutes
    at the SAME time — after a coupled fire, the solvent anchor sits at
    the MD clock, not one step behind."""
    sim = _coupled_sim(period=10)
    sim.run(10)
    assert int(sim._mpcd["_srd_anchor"][2]) == sim._timestep == 10
    sim.run(7)  # mid-interval: no fire, anchor stays at the collision
    assert int(sim._mpcd["_srd_anchor"][2]) == 10
    sim.run(3)
    assert int(sim._mpcd["_srd_anchor"][2]) == sim._timestep == 20


def test_srd_rebuilds_on_box_change():
    """Regression: the advance closure bakes the box in; a new box
    (set_snapshot) must rebuild it instead of wrapping to stale L."""
    from azplugins_tpu.core.box import Box

    rng = np.random.default_rng(0)

    def stream(L):
        return {
            "position": jnp.asarray(
                (rng.random((64, 3)) - 0.5) * L, jnp.float32
            ),
            "velocity": jnp.asarray(rng.normal(0, 1, (64, 3)), jnp.float32),
        }

    srd = az.mpcd.SRD(dt=0.02, period=1, cell_size=1.0)
    srd._advance(stream(8.0), Box.cube(8.0), 0, 2, seed=1)
    assert srd._dims == (8, 8, 8)
    out = srd._advance(stream(16.0), Box.cube(16.0), 0, 2, seed=1)
    assert srd._dims == (16, 16, 16)
    assert np.all(np.abs(np.asarray(out["position"])) <= 8.0 + 1e-5)
