"""Degenerate-shape and fuzz robustness of the production force path.

Small boxes produce grids with 1 or 2 cells per axis (the stencil sees
the whole axis there, GridSpec.create); these shapes must produce
EXACT forces, not just run. Checked against an O(N^2) minimum-image
brute force. The fuzz sweep runs randomized configurations through
every isotropic pair potential and asserts physical invariants
(finiteness, thermostat sanity, momentum conservation under NVE).
"""

import numpy as np
import pytest

import azplugins_tpu as az


def _brute_force_hertz(pos, L, eps, r_cut):
    N = len(pos)
    L = np.asarray(L)
    forces = np.zeros((N, 3))
    for i in range(N):
        d = pos[i] - pos
        d -= np.round(d / L) * L
        rsq = (d * d).sum(axis=1)
        rsq[i] = 1e30
        r = np.sqrt(rsq)
        mask = r < r_cut
        x = np.maximum(1.0 - r / r_cut, 0.0)
        f = np.where(mask, 2.5 * eps * x**1.5 / (r * r_cut), 0.0)
        forces[i] = (f[:, None] * d).sum(axis=0)
    return forces


@pytest.mark.parametrize(
    "L", [(3.0, 3.0, 3.0), (4.0, 4.0, 4.0), (3.2, 6.5, 9.0)]
)
def test_small_grid_forces_match_brute_force(L):
    """Grids with 1-2 cells on some axes give exact forces."""
    rng = np.random.default_rng(17)
    N = 24
    snap = az.Snapshot(N=N)
    snap.configuration.box = list(L) + [0, 0, 0]
    snap.particles.types = ["A"]
    pos = (rng.random((N, 3)) - 0.5) * np.asarray(L)
    snap.particles.position[:] = pos
    sim = az.Simulation(seed=3)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.2)
    pot.params[("A", "A")] = dict(epsilon=3.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.001, methods=[az.md.methods.ConstantVolume()], forces=[pot]
    )
    sim.run(0)
    dims = sim._grid_spec.dims
    assert min(dims) <= 2, dims  # the point of the test
    got = np.asarray(pot.forces)
    ref = _brute_force_hertz(pos, L, 3.0, 1.2)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, atol=5e-5 * scale, rtol=5e-5)


def test_single_particle_runs():
    snap = az.Snapshot(N=1)
    snap.configuration.box = [6, 6, 6, 0, 0, 0]
    snap.particles.types = ["A"]
    sim = az.Simulation(seed=5)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    pot.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=1.0)],
        forces=[pot],
    )
    sim.run(20)
    p = sim.state.get_snapshot().particles.position
    assert np.all(np.isfinite(p))
    assert float(np.asarray(pot.energy)) == 0.0


def test_operations_rebind_on_change(lattice_snapshot_factory):
    """Swapping the integrator or adding a force after a run() must
    rebuild the compiled step loop (regression: the old closure kept
    integrating with the previous scheme — a 'production NVE after
    Langevin equilibration' script silently stayed Langevin)."""
    snap = lattice_snapshot_factory(n=4, a=1.4)
    sim = az.Simulation(seed=6)
    sim.create_state_from_snapshot(snap)
    pot = az.pair.Hertz(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=1.3)
    pot.params[("A", "A")] = dict(epsilon=2.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[pot],
    )
    sim.state.thermalize_particle_momenta(kT=1.0)
    sim.run(20)
    # swap to NVE: momentum must now be conserved (noise off)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.ConstantVolume()], forces=[pot]
    )
    s0 = sim.state.get_snapshot()
    p0 = (s0.particles.velocity * s0.particles.mass[:, None]).sum(axis=0)
    sim.run(30)
    s1 = sim.state.get_snapshot()
    p1 = (s1.particles.velocity * s1.particles.mass[:, None]).sum(axis=0)
    np.testing.assert_allclose(p1, p0, atol=1e-4)

    # adding a second force post-run must take effect (and resize the grid)
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5)
    lj.params[("A", "A")] = dict(epsilon=0.3, sigma=1.0)
    sim.operations.integrator.forces.append(lj)
    sim.run(1)
    assert float(np.asarray(lj.energy)) != 0.0


_FUZZ_CASES = [
    ("Hertz", dict(epsilon=2.0), 1.3),
    ("LJ", dict(epsilon=0.5, sigma=1.0), 2.0),
    ("Gaussian", dict(epsilon=2.0, sigma=0.8), 2.2),
    ("Yukawa", dict(epsilon=1.0, kappa=2.0), 2.2),
    ("Morse", dict(D0=0.5, alpha=3.0, r0=1.0), 2.0),
    ("ExpandedYukawa", dict(epsilon=1.0, kappa=2.0, delta=0.2), 2.2),
]


@pytest.mark.parametrize("name,params,rcut", _FUZZ_CASES)
def test_fuzz_invariants(name, params, rcut):
    """Randomized dilute configs: finite state, sane thermostat, and for
    the NVE leg exact momentum conservation (conservative pair forces)."""
    rng = np.random.default_rng(hash(name) % 2**31)
    n = 5
    N = n**3
    a = 1.4
    L = [n * a] * 3
    snap = az.Snapshot(N=N)
    snap.configuration.box = L + [0, 0, 0]
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    # jittered lattice: random but overlap-free (steep cores explode from
    # genuinely overlapping random starts in any MD engine)
    x = (np.arange(n) + 0.5) * a - L[0] / 2
    grid = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    snap.particles.position[:] = grid + rng.normal(0, 0.08, (N, 3))
    sim = az.Simulation(seed=9)
    sim.create_state_from_snapshot(snap)
    cls = getattr(az.pair, name)
    pot = cls(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=rcut)
    for pair in (("A", "A"), ("A", "B"), ("B", "B")):
        pot.params[pair] = params
    sim.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[pot],
    )
    sim.state.thermalize_particle_momenta(kT=1.0)
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.run(40)
    s = sim.state.get_snapshot()
    assert np.all(np.isfinite(s.particles.position)), name
    assert np.all(np.isfinite(s.particles.velocity)), name
    thermo._attach(sim)
    kT = float(thermo.kinetic_temperature)
    assert 0.05 < kT < 20.0, (name, kT)

    # NVE leg: momentum conserved exactly by the pair-force antisymmetry
    sim.operations.integrator = az.md.Integrator(
        dt=0.001, methods=[az.md.methods.ConstantVolume()], forces=[pot]
    )
    s0 = sim.state.get_snapshot()
    p0 = (s0.particles.velocity * s0.particles.mass[:, None]).sum(axis=0)
    sim.run(30)
    s1 = sim.state.get_snapshot()
    p1 = (s1.particles.velocity * s1.particles.mass[:, None]).sum(axis=0)
    np.testing.assert_allclose(p1, p0, atol=5e-3)


def test_force_removal_preserves_state(lattice_snapshot_factory):
    """Regression: a mid-trajectory re-attach that drops the pair grid
    (swap to a gridless force set) must sync the evolved dense state
    first — positions must not roll back to the last host sync."""
    def make():
        snap = lattice_snapshot_factory(n=4, a=1.4)
        sim = az.Simulation(seed=6)
        sim.create_state_from_snapshot(snap)
        pot = az.pair.Hertz(
            nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=1.3
        )
        pot.params[("A", "A")] = dict(epsilon=2.0)
        sim.operations.integrator = az.md.Integrator(
            dt=0.002, methods=[az.md.methods.ConstantVolume()], forces=[pot]
        )
        sim.state.thermalize_particle_momenta(kT=1.0)
        return sim

    a = make()
    a.run(25)  # dense state evolved, host copy stale
    a.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    a.run(5)

    b = make()
    b.run(25)
    b.state.get_snapshot()  # explicit host sync before the swap
    b.operations.integrator = az.md.Integrator(
        dt=0.002, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    b.run(5)

    np.testing.assert_array_equal(
        np.asarray(a.state.get_snapshot().particles.position),
        np.asarray(b.state.get_snapshot().particles.position),
    )


def test_divergence_raises_clean_error():
    """A blown-up trajectory must fail with a diagnostic, not a compiler OOM.

    Near-overlapping pairs under a steep LJ produce inf forces -> NaN
    positions; the rebin then piles every NaN particle into one cell and
    the overflow grow would request capacity ~ N, which ends in an
    unintelligible compiler out-of-memory error. The engine detects the non-finite
    state at the first overflow and raises RuntimeError instead.
    """
    rng = np.random.default_rng(0)
    L = 12.0
    n_pairs = 32
    centers = rng.uniform(-L / 2 + 1, L / 2 - 1, size=(n_pairs, 3))
    pos = np.concatenate([centers, centers + 1e-4], axis=0)
    snap = az.Snapshot(N=2 * n_pairs)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = pos
    sim = az.Simulation(seed=1)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5
    )
    lj.params[("A", "A")] = dict(
        epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0
    )
    sim.operations.integrator = az.md.Integrator(
        dt=0.005,
        methods=[az.md.methods.ConstantVolume()],
        forces=[lj],
    )
    with pytest.raises(RuntimeError, match="diverged"):
        # plenty of steps for the blow-up to reach the overflow path
        for _ in range(40):
            sim.run(10)
