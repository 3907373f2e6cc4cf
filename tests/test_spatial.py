"""Spatial (x-slab) decomposition: ppermute-migration rebin vs global rebin.

The spatial rebin (parallel/spatial.py) must produce a BITWISE-identical
slot layout to ops.dense.rebin — the local fused sort keys on
(cell, global input row), the same order the global sort uses — so
trajectories cannot depend on which rebin path ran (SURVEY §2.12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import azplugins_tpu as az

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh"
)

from azplugins_tpu.core.state import state_from_snapshot
from azplugins_tpu.ops import dense as D
from azplugins_tpu.parallel import make_mesh, shard_state
from azplugins_tpu.parallel.spatial import spatial_rebin


def _rebin_jit(dense, meta, spec, N, mesh=None, migrate_cap=None):
    """Run a rebin under jit: the production path always jits, and the
    eager 8-device dispatch is ~80x slower on the CPU mesh (pure test
    wall-clock, no extra coverage)."""
    if mesh is None:
        fn = jax.jit(lambda d, m: D.rebin(d, m, spec, N))
    else:
        fn = jax.jit(
            lambda d, m: spatial_rebin(
                d, m, spec, N, mesh=mesh, migrate_cap=migrate_cap
            )
        )
    out_dense, out_meta = fn(dense, meta)
    jax.block_until_ready(out_dense.position)
    return out_dense, out_meta


def _grid_system(N=700, seed=4):
    """Box sized for dims=(8, 4, 4) at r_list=1.8 so 8 devices get 1 plane each."""
    rng = np.random.default_rng(seed)
    L = [14.5, 7.3, 7.3]
    snap = az.Snapshot(N=N)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    state, _, _ = state_from_snapshot(snap)
    spec = D.GridSpec.create(state.box, N, r_cut=1.5, buffer=0.3)
    assert spec.dims[0] == 8, spec.dims
    dense, meta = D.densify(state, spec)
    assert not bool(meta.overflow)
    return dense, meta, spec, N


def _assert_state_equal(a, b):
    for f in (
        "position", "velocity", "acceleration", "typeid", "tag", "image",
        "mass", "orientation",
    ):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )


@pytest.mark.parametrize("drift", [0.0, 1.0])
def test_spatial_rebin_bitwise_matches_global(drift):
    dense, meta, spec, N = _grid_system()
    if drift:
        # unwrapped drift across cell/slab boundaries (< one slab width)
        rng = np.random.default_rng(9)
        S = dense.position.shape[0]
        dpos = jnp.asarray(rng.uniform(-drift, drift, (S, 3)), jnp.float32)
        dpos = jnp.where((dense.tag >= 0)[:, None], dpos, 0.0)
        dense = dense.replace(position=dense.position + dpos)

    ref_dense, ref_meta = _rebin_jit(dense, meta, spec, N)

    mesh = make_mesh(8)
    dense_sh = shard_state(dense, mesh)
    got_dense, got_meta = _rebin_jit(dense_sh, meta, spec, N, mesh=mesh)
    _assert_state_equal(ref_dense, got_dense)
    np.testing.assert_array_equal(
        np.asarray(ref_meta.slot_of), np.asarray(got_meta.slot_of)
    )
    assert bool(got_meta.overflow) == bool(ref_meta.overflow)
    assert not bool(got_meta.overflow)


def test_spatial_rebin_under_jit_sharded():
    dense, meta, spec, N = _grid_system(seed=12)
    mesh = make_mesh(8)
    dense_sh = shard_state(dense, mesh)

    @jax.jit
    def go(d, m):
        return spatial_rebin(d, m, spec, N, mesh=mesh)

    got_dense, got_meta = go(dense_sh, meta)
    ref_dense, _ = D.rebin(dense, meta, spec, N)
    _assert_state_equal(ref_dense, got_dense)


def test_spatial_rebin_flags_fast_particle():
    """A particle jumping two slabs (impossible under the Verlet margin)
    must raise the overflow flag, not silently vanish."""
    dense, meta, spec, N = _grid_system(seed=5)
    slot = int(np.argmax(np.asarray(dense.tag) >= 0))
    jump = jnp.zeros_like(dense.position).at[slot, 0].set(2 * 14.5 / 8 + 0.2)
    dense = dense.replace(position=dense.position + jump)
    mesh = make_mesh(8)
    _, got_meta = _rebin_jit(shard_state(dense, mesh), meta, spec, N, mesh=mesh)
    assert bool(got_meta.overflow)


def test_spatial_rebin_requires_aligned_slabs():
    dense, meta, spec, N = _grid_system()
    mesh = make_mesh(3)
    with pytest.raises(ValueError, match="divisible"):
        spatial_rebin(dense, meta, spec, N, mesh=mesh)


def _slab_sim(seed):
    """LJ fluid in a box whose grid is (8, 4, 4) — one x-plane per device."""
    rng = np.random.default_rng(seed)
    N = 600
    L = [14.5, 7.3, 7.3]
    snap = az.Snapshot(N=N)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    sim = az.Simulation(seed=7)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    lj.params[("A", "A")] = dict(epsilon=5.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
        forces=[lj],
    )
    sim.state.thermalize_particle_momenta(kT=0.8)
    return sim


def test_simulation_spatial_decomposition_bitwise():
    """A spatially-decomposed Simulation reproduces the single-device
    trajectory bitwise (the spatial rebin reproduces the global layout,
    and RNG keys on tags)."""
    ref = _slab_sim(seed=21)
    ref.run(30)
    ref_pos = np.asarray(ref.state.get_snapshot().particles.position)

    sim = _slab_sim(seed=21)
    sim._attach()
    assert sim._grid_spec.dims[0] == 8, sim._grid_spec.dims
    sim.enable_spatial_decomposition(make_mesh(8))
    sim.run(30)
    got_pos = np.asarray(sim.state.get_snapshot().particles.position)
    np.testing.assert_array_equal(ref_pos, got_pos)


def test_spatial_snaps_unaligned_mesh(monkeypatch):
    """A mesh that does not divide the natural Dx*Dy: the grid snaps
    (Dx, Dy) down to a mesh-commensurate product (GridSpec.create
    strip_devices) instead of failing. The 3-strip trajectory matches a
    single-device run on the SAME snapped grid bitwise (the reference
    sim is patched to use the identical strip_devices so both layouts
    agree)."""
    orig = D.GridSpec.create.__func__

    def snapped(cls, box, N, r_cut, buffer, safety=1.18, dx_multiple=1,
                strip_devices=1):
        return orig(cls, box, N, r_cut, buffer, safety, 1, 3)

    monkeypatch.setattr(D.GridSpec, "create", classmethod(snapped))
    ref = _slab_sim(seed=33)
    ref.run(25)
    dims = ref._grid_spec.dims
    assert (dims[0] * dims[1]) % 3 == 0 and dims[0] * dims[1] < 32, dims
    ref_pos = np.asarray(ref.state.get_snapshot().particles.position)

    sim = _slab_sim(seed=33)
    sim.enable_spatial_decomposition(make_mesh(3))
    sim.run(25)
    assert sim._grid_spec.dims == dims
    got_pos = np.asarray(sim.state.get_snapshot().particles.position)
    np.testing.assert_array_equal(ref_pos, got_pos)


def test_enable_spatial_midrun_keeps_trajectory():
    """Enabling spatial decomposition on an incommensurate grid mid-run
    takes the regrid branch — which must NOT roll the trajectory back to
    the last host sync (regression: the branch dropped the dense state
    without syncing first, silently discarding steps)."""
    ref = _slab_sim(seed=27)
    ref.run(50)
    ref_pos = np.asarray(ref.state.get_snapshot().particles.position)

    sim = _slab_sim(seed=27)
    sim.run(30)
    # host sync at t=30: without the fix, this is what the state rolls
    # back to when the regrid branch drops the dense arrays
    _ = np.asarray(sim.state.get_snapshot().particles.position)
    sim.run(20)
    sim.enable_spatial_decomposition(make_mesh(3))  # dims[0]=8 % 3 != 0
    assert sim.timestep == 50
    np.testing.assert_array_equal(
        np.asarray(sim.state.get_snapshot().particles.position), ref_pos
    )


def _droplet_workload_sim(traj_path=None):
    """Evaporating-droplet-style composition (BASELINE config 5 shrunk to
    the 8-slab grid): pair + moving planar barrier + ParticleEvaporator +
    velocity-field observable + aztraj writer."""
    rng = np.random.default_rng(44)
    N = 500
    L = [14.5, 7.3, 7.3]
    snap = az.Snapshot(N=N)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    sim = az.Simulation(seed=11)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    pot.params[("solvent", "solvent")] = dict(epsilon=5.0)
    pot.params[("solvent", "evaporated")] = dict(epsilon=1.0)
    pot.params[("evaporated", "evaporated")] = dict(epsilon=0.0)
    barrier = az.external.PlanarHarmonicBarrier(
        location=az.variant.Ramp(A=3.0, B=2.0, t_start=0, t_ramp=100)
    )
    barrier.params["solvent"] = dict(k=20.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    evap = az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(5),
        solvent_type="solvent",
        evaporated_type="evaporated",
        lo=1.0,
        hi=3.6,
        N_evap_max=4,
    )
    sim.operations.updaters.append(evap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
        forces=[pot, barrier],
    )
    field = az.compute.CartesianVelocityFieldCompute(
        num_bins=[4, 0, 0],
        lower_bounds=[-L[0] / 2, 0, 0],
        upper_bounds=[L[0] / 2, 0, 0],
        filter=az.filter.All(),
    )
    sim.operations.computes.append(field)
    if traj_path is not None:
        sim.operations += az.write.Trajectory(
            trigger=az.trigger.Periodic(10), filename=str(traj_path)
        )
    sim.state.thermalize_particle_momenta(kT=0.8)
    return sim, field


def test_spatial_droplet_workload_bitwise(tmp_path):
    """Updaters (evaporator retype), writers (aztraj), and observables
    (velocity field) all running with spatial decomposition active: the
    8-slab run reproduces the single-device trajectory, typeids, written
    trajectory file, AND observable values bitwise."""
    ref, ref_field = _droplet_workload_sim(tmp_path / "ref.azt")
    ref.run(40)
    ref_snap = ref.state.get_snapshot()
    ref_vel = np.asarray(ref_field.velocities)

    sim, field = _droplet_workload_sim(tmp_path / "spatial.azt")
    sim.enable_spatial_decomposition(make_mesh(8))
    sim.run(40)
    assert sim._grid_spec.dims[0] == 8
    got_snap = sim.state.get_snapshot()

    np.testing.assert_array_equal(
        ref_snap.particles.position, got_snap.particles.position
    )
    np.testing.assert_array_equal(
        ref_snap.particles.velocity, got_snap.particles.velocity
    )
    np.testing.assert_array_equal(
        ref_snap.particles.typeid, got_snap.particles.typeid
    )
    # evaporation actually happened (updater ran under sharding)
    assert (got_snap.particles.typeid == 1).sum() > 0
    np.testing.assert_array_equal(ref_vel, np.asarray(field.velocities))
    assert (tmp_path / "ref.azt").read_bytes() == (
        tmp_path / "spatial.azt"
    ).read_bytes()


@pytest.mark.parametrize("n_dev", [1, 2])
def test_spatial_rebin_degenerate_meshes(n_dev):
    """n=1 (both neighbors are self) and n=2 (left neighbor IS the right
    neighbor) must neither duplicate migrants nor flag spurious overflow —
    the round-3 regression: go_l/go_r double-classified every particle on
    n=1 (perpetual overflow -> grow/recompile loop) and sent each n=2
    migrant through BOTH buffers (silent duplication)."""
    dense, meta, spec, N = _grid_system(seed=6)
    rng = np.random.default_rng(8)
    S = dense.position.shape[0]
    dpos = jnp.asarray(rng.uniform(-1.0, 1.0, (S, 3)), jnp.float32)
    dpos = jnp.where((dense.tag >= 0)[:, None], dpos, 0.0)
    dense = dense.replace(position=dense.position + dpos)

    ref_dense, ref_meta = _rebin_jit(dense, meta, spec, N)
    mesh = make_mesh(n_dev)
    got_dense, got_meta = _rebin_jit(
        shard_state(dense, mesh), meta, spec, N, mesh=mesh
    )
    _assert_state_equal(ref_dense, got_dense)
    assert bool(got_meta.overflow) == bool(ref_meta.overflow)
    assert not bool(got_meta.overflow)


def test_spatial_rebin_migrant_overflow_flag():
    """Tiny migrate_cap forces the migrant-buffer overflow path."""
    dense, meta, spec, N = _grid_system(seed=4)
    rng = np.random.default_rng(3)
    S = dense.position.shape[0]
    dpos = jnp.asarray(rng.uniform(-1.5, 1.5, (S, 3)), jnp.float32)
    dpos = jnp.where((dense.tag >= 0)[:, None], dpos, 0.0)
    dense = dense.replace(position=dense.position + dpos)
    mesh = make_mesh(8)
    _, got_meta = _rebin_jit(
        shard_state(dense, mesh), meta, spec, N, mesh=mesh, migrate_cap=8
    )
    assert bool(got_meta.overflow)


# -- sub-plane strips (round 3): more devices than x planes ------------------


def _strip_system(N=500, seed=4):
    """Cubic box sized for dims=(4, 4, 4) at r_list=1.8: 8 devices own
    half an x plane (2 z-columns) each — sub-plane strips."""
    rng = np.random.default_rng(seed)
    L = [7.3, 7.3, 7.3]
    snap = az.Snapshot(N=N)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    state, _, _ = state_from_snapshot(snap)
    spec = D.GridSpec.create(state.box, N, r_cut=1.5, buffer=0.3)
    assert spec.dims == (4, 4, 4), spec.dims
    dense, meta = D.densify(state, spec)
    assert not bool(meta.overflow)
    return dense, meta, spec, N


@pytest.mark.parametrize("drift", [0.0, 1.0])
def test_spatial_rebin_strips_bitwise(drift):
    """Strips narrower than an x plane (8 devices on 4 planes) still
    reproduce the global rebin bitwise; y/x wraps hop multiple blocks
    around the device ring (the multi-hop ppermute path)."""
    from azplugins_tpu.parallel.spatial import _hop_bound

    dense, meta, spec, N = _strip_system()
    assert _hop_bound(spec.dims, 8) > 1  # genuinely multi-hop
    if drift:
        rng = np.random.default_rng(9)
        S = dense.position.shape[0]
        dpos = jnp.asarray(rng.uniform(-drift, drift, (S, 3)), jnp.float32)
        dpos = jnp.where((dense.tag >= 0)[:, None], dpos, 0.0)
        dense = dense.replace(position=dense.position + dpos)

    ref_dense, ref_meta = _rebin_jit(dense, meta, spec, N)
    mesh = make_mesh(8)
    got_dense, got_meta = _rebin_jit(
        shard_state(dense, mesh), meta, spec, N, mesh=mesh
    )
    _assert_state_equal(ref_dense, got_dense)
    np.testing.assert_array_equal(
        np.asarray(ref_meta.slot_of), np.asarray(got_meta.slot_of)
    )
    assert bool(got_meta.overflow) == bool(ref_meta.overflow)
    assert not bool(got_meta.overflow)


def test_hop_bound_slabs_is_one():
    """Whole-plane slabs keep the single-hop migration of round 2."""
    from azplugins_tpu.parallel.spatial import _hop_bound

    assert _hop_bound((8, 4, 4), 8) == 1
    assert _hop_bound((8, 4, 4), 2) == 1
    assert _hop_bound((8, 4, 4), 1) == 0


def test_simulation_strips_more_devices_than_planes():
    """End-to-end: a cubic box with only 4 x planes decomposed over 8
    devices (impossible for slabs) reproduces the single-device
    trajectory bitwise."""
    def cube_sim(seed):
        rng = np.random.default_rng(seed)
        N = 500
        L = [7.3, 7.3, 7.3]
        snap = az.Snapshot(N=N)
        snap.configuration.box = L + [0, 0, 0]
        snap.particles.types = ["A"]
        snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
        sim = az.Simulation(seed=7)
        sim.create_state_from_snapshot(snap)
        lj = az.pair.Hertz(
            nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5
        )
        lj.params[("A", "A")] = dict(epsilon=5.0)
        sim.operations.integrator = az.md.Integrator(
            dt=0.002,
            methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
            forces=[lj],
        )
        sim.state.thermalize_particle_momenta(kT=0.8)
        return sim

    ref = cube_sim(seed=21)
    ref.run(30)
    assert ref._grid_spec.dims == (4, 4, 4)
    ref_pos = np.asarray(ref.state.get_snapshot().particles.position)

    sim = cube_sim(seed=21)
    sim.enable_spatial_decomposition(make_mesh(8))
    sim.run(30)
    assert sim._grid_spec.dims == (4, 4, 4)
    np.testing.assert_array_equal(
        np.asarray(sim.state.get_snapshot().particles.position), ref_pos
    )


# -- triclinic x spatial (round 4) -------------------------------------------


def _tilted_system(N=700, seed=4, tilt=(0.2, 0.0, 0.1)):
    """Tilted box sized to keep dims with Dx*Dy divisible by 4."""
    rng = np.random.default_rng(seed)
    L = [14.5, 7.3, 7.3]
    snap = az.Snapshot(N=N)
    snap.configuration.box = L + list(tilt)
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    # fractional fill of the tilted box
    frac = rng.random((N, 3)) - 0.5
    Lx, Ly, Lz = L
    xy, xz, yz = tilt
    snap.particles.position[:] = np.stack(
        [
            frac[:, 0] * Lx + frac[:, 1] * xy * Ly + frac[:, 2] * xz * Lz,
            frac[:, 1] * Ly + frac[:, 2] * yz * Lz,
            frac[:, 2] * Lz,
        ],
        axis=1,
    )
    state, _, _ = state_from_snapshot(snap)
    spec = D.GridSpec.create(state.box, N, r_cut=1.5, buffer=0.3)
    assert (spec.dims[0] * spec.dims[1]) % 4 == 0, spec.dims
    dense, meta = D.densify(state, spec)
    assert not bool(meta.overflow)
    return dense, meta, spec, N


@pytest.mark.parametrize("drift", [0.0, 0.5])
def test_spatial_rebin_triclinic_bitwise(drift):
    """A tilted box through spatial_rebin under a 4-device mesh matches
    the global rebin bitwise (the spatial path's
    cell-id/key logic is tilt-agnostic — prove it, don't assume it)."""
    dense, meta, spec, N = _tilted_system()
    if drift:
        rng = np.random.default_rng(9)
        S = dense.position.shape[0]
        dpos = jnp.asarray(rng.uniform(-drift, drift, (S, 3)), jnp.float32)
        dpos = jnp.where((dense.tag >= 0)[:, None], dpos, 0.0)
        dense = dense.replace(position=dense.position + dpos)

    ref_dense, ref_meta = _rebin_jit(dense, meta, spec, N)
    mesh = make_mesh(4)
    got_dense, got_meta = _rebin_jit(
        shard_state(dense, mesh), meta, spec, N, mesh=mesh
    )
    _assert_state_equal(ref_dense, got_dense)
    np.testing.assert_array_equal(
        np.asarray(ref_meta.slot_of), np.asarray(got_meta.slot_of)
    )
    assert bool(got_meta.overflow) == bool(ref_meta.overflow)
    assert not bool(got_meta.overflow)


def test_simulation_spatial_triclinic_bitwise():
    """End-to-end: a tilted-box LJ run with spatial decomposition active
    reproduces the single-device trajectory bitwise (masked dense path +
    strip rebin together)."""

    def tilted_sim(seed):
        rng = np.random.default_rng(seed)
        N = 600
        L = [14.5, 7.3, 7.3]
        tilt = [0.2, 0.0, 0.1]
        snap = az.Snapshot(N=N)
        snap.configuration.box = L + tilt
        snap.particles.types = ["A"]
        frac = rng.random((N, 3)) - 0.5
        snap.particles.position[:] = np.stack(
            [
                frac[:, 0] * L[0] + frac[:, 1] * tilt[0] * L[1]
                + frac[:, 2] * tilt[1] * L[2],
                frac[:, 1] * L[1] + frac[:, 2] * tilt[2] * L[2],
                frac[:, 2] * L[2],
            ],
            axis=1,
        )
        sim = az.Simulation(seed=7)
        sim.create_state_from_snapshot(snap)
        lj = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
        lj.params[("A", "A")] = dict(epsilon=5.0)
        sim.operations.integrator = az.md.Integrator(
            dt=0.002,
            methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
            forces=[lj],
        )
        sim.state.thermalize_particle_momenta(kT=0.8)
        return sim

    ref = tilted_sim(seed=21)
    ref.run(30)
    ref_pos = np.asarray(ref.state.get_snapshot().particles.position)

    sim = tilted_sim(seed=21)
    sim.enable_spatial_decomposition(make_mesh(4))
    sim.run(30)
    np.testing.assert_array_equal(
        np.asarray(sim.state.get_snapshot().particles.position), ref_pos
    )


# -- MPCD solvent under the mesh (round 4) -----------------------------------


def _srd_arrays(N=4096, L=8.0, seed=3):
    rng = np.random.default_rng(seed)
    pos = (rng.random((N, 3)).astype(np.float32) - 0.5) * L
    vel = rng.normal(0, 1.0, (N, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    return jnp.asarray(pos), jnp.asarray(vel)


def test_srd_solvent_sharded_advance():
    """The SRD solvent shards over the particle axis: streaming is
    elementwise, the cell reduction is a partial scatter-add + psum, and
    the per-cell gather reads the replicated table locally. The sharded
    collision matches the single-device one to f32 reduction-regrouping
    tolerance (cell sums regroup across devices — the only divergence,
    DEVIATIONS.md), and the outputs STAY sharded (no silent replication
    through the advance)."""
    from azplugins_tpu.core.box import Box
    from jax.sharding import NamedSharding, PartitionSpec as P

    box = Box.cube(8.0)
    srd = az.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0)
    pos, vel = _srd_arrays()
    mpcd_rep = {"position": pos, "velocity": vel, "mass": 1.0}
    out_rep = srd._advance(dict(mpcd_rep), box, 0, 10, seed=11)

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P("d"))
    srd2 = az.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0, kT=1.0)
    mpcd_sh = {
        "position": jax.device_put(pos, sh),
        "velocity": jax.device_put(vel, sh),
        "mass": 1.0,
    }
    out_sh = srd2._advance(mpcd_sh, box, 0, 10, seed=11)

    np.testing.assert_allclose(
        np.asarray(out_sh["position"]), np.asarray(out_rep["position"]),
        rtol=0, atol=5e-5,
    )
    np.testing.assert_allclose(
        np.asarray(out_sh["velocity"]), np.asarray(out_rep["velocity"]),
        rtol=0, atol=5e-5,
    )
    assert not out_sh["position"].sharding.is_fully_replicated
    assert not out_sh["velocity"].sharding.is_fully_replicated
    # momentum is conserved under the mesh (collisions rotate about COM)
    p0 = np.asarray(vel).sum(axis=0)
    p1 = np.asarray(out_sh["velocity"]).sum(axis=0)
    np.testing.assert_allclose(p1, p0, atol=2e-2)


def test_simulation_spatial_shards_solvent():
    """enable_spatial_decomposition places the MPCD stream sharded over
    the mesh and the run keeps it there (SURVEY §2.12: at production
    ratios the solvent is ~10x the solutes — it must ride the
    distribution axis, not replicate)."""
    rng = np.random.default_rng(5)
    N, N_s = 600, 4096
    L = [14.6, 7.3, 7.3]  # cell_size 7.3/8 divides every edge
    snap = az.Snapshot(N=N, mpcd_N=N_s)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * np.asarray(L)
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    sim = az.Simulation(seed=7)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.5)
    lj.params[("A", "A")] = dict(epsilon=5.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=0.8, default_gamma=1.0)],
        forces=[lj],
    )
    # non-multiple cell_size for the box y/z would fail validation; the
    # solvent grid uses its own cell_size — pick one that divides L
    sim.mpcd_dynamics = az.mpcd.SRD(
        dt=0.002, period=5, angle=130.0, cell_size=7.3 / 8, kT=0.8
    )
    sim.enable_spatial_decomposition(make_mesh(8))
    sim.run(12)
    assert not sim._mpcd["position"].sharding.is_fully_replicated
    assert not sim._mpcd["velocity"].sharding.is_fully_replicated
    # the solvent actually advanced (streaming + at least 2 collisions)
    assert int(sim._mpcd["_srd_anchor"][2]) == 10
