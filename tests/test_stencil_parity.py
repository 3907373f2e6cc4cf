"""Newton half stencil vs the padded-list oracle and the full stencil.

The XLA half-stencil scans in ops/dense.py are the only production path
for pair, DPD and anisotropic forces. Each case here drives one of them
through its Force object (the production ``_compute_dense``) and compares
it with two references:

* ``oracle``: the padded Verlet list (ops/neighbor.py + ops/pair_force.py
  or ops/aniso_force.py) evaluated in float64 — the same check, with the
  same tolerances, that chip_smoke.py phase 2 runs on the GPU;
* ``full``: the full 27-cell stencil of the same dense driver, whose pair
  distances differ only by the f32 rounding of the other periodic image,
  and whose sums run in another order (same tolerances).
"""

import numpy as np
import pytest

import azplugins_tpu as az
import chip_smoke as cs

REFS = ["oracle", "full"]


def _params_plj(rng):
    return dict(
        epsilon=float(rng.uniform(0.4, 1.4)),
        sigma=float(rng.uniform(0.9, 1.1)),
        attraction_scale_factor=float(rng.uniform(0.0, 1.0)),
    )


def _params_dpd(rng):
    return dict(A=float(rng.uniform(10, 40)), gamma=float(rng.uniform(2, 6)),
                s=float(rng.uniform(0.5, 2.0)))


def _params_patch(rng):
    return dict(M_d=float(rng.uniform(0.8, 2.0)), M_r=float(rng.uniform(0.15, 0.25)),
                r_eq=float(rng.uniform(0.9, 1.1)), omega=float(rng.uniform(10, 20)),
                alpha=float(rng.uniform(0.4, 0.6)), repulsion=True)


def _system(kind, *, T=1, mode="none", r_on=0.0, n=9, a=1.3, tilt=(0, 0, 0),
            seed=3, disable_pair=False):
    """A jittered n^3 lattice (no overlaps) with one force of ``kind``.

    Returns the attached simulation; its dense state and tables are the
    production inputs of the force.
    """
    rng = np.random.default_rng(seed)
    N = n**3
    L = n * a
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, *tilt]
    snap.particles.types = [chr(ord("A") + k) for k in range(T)]
    snap.particles.typeid[:] = rng.integers(0, T, N)
    g = (np.arange(n) + 0.5) * a - L / 2
    frac = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) / L
    frac += rng.normal(0, 0.08 * a / L, frac.shape)
    xy, xz, yz = tilt
    snap.particles.position[:] = np.stack([
        L * (frac[:, 0] + xy * frac[:, 1] + xz * frac[:, 2]),
        L * (frac[:, 1] + yz * frac[:, 2]),
        L * frac[:, 2],
    ], axis=1)
    snap.particles.velocity[:] = rng.normal(0, 1, (N, 3))
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    cell = az.md.nlist.Cell(buffer=0.3)
    if kind == "pair":
        force = az.pair.PerturbedLennardJones(
            nlist=cell, default_r_cut=1.5, default_r_on=r_on, mode=mode)
        make = _params_plj
    elif kind == "dpd":
        force = az.pair.DPDGeneralWeight(nlist=cell, kT=1.2, default_r_cut=1.5)
        make = _params_dpd
    else:
        force = az.pair.TwoPatchMorse(nlist=cell, default_r_cut=1.5, mode=mode)
        make = _params_patch
    types = snap.particles.types
    for i in range(T):
        for j in range(i, T):
            force.params[(types[i], types[j])] = make(rng)
            force.r_cut[(types[i], types[j])] = float(rng.uniform(1.2, 1.5)) if T > 1 else 1.5
    if disable_pair:
        force.r_cut[(types[0], types[-1])] = 0.0
    sim.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[force],
        integrate_rotational_dof=(kind == "aniso"),
    )
    sim._attach()
    sim._prepare()
    assert sim._grid_spec.newton_ok
    return sim


def _check(sim, ref, *, want, masked):
    force = sim._forces()[0]
    tbl = force._device_tables()
    dense, spec, t, ctx = sim._dense, sim._grid_spec, 42, sim._ctx()
    got = cs.dense_terms(force, dense, spec, t, ctx, tbl, want=want,
                         half=True, masked=masked)
    if ref == "oracle":
        other = cs.oracle_terms(force, dense, t, ctx, tbl)
    else:
        other = cs.dense_terms(force, dense, spec, t, ctx, tbl, want=want,
                               half=False, masked=True)
    rows = cs.compare_terms(got, other, list(got),
                            cut=cs.cutoff_terms(force, tbl, t, ctx, dense.box))
    bad = [r for r in rows if not r[3] <= 1.0]
    assert not bad, bad


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("mode", ["none", "shift"])
def test_pair_modes(ref, mode, want):
    _check(_system("pair", mode=mode), ref, want=want, masked=False)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("r_on", [1.0, 2.0])
def test_pair_xplor(ref, r_on):
    """xplor smoothing (r_on < r_cut) and its plain-shift fallback."""
    _check(_system("pair", mode="xplor", r_on=r_on), ref, want="all",
           masked=False)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("masked", [False, True])
def test_dpd(ref, masked):
    """want="all" adds the conservative energy and virial, which have none
    of the random force's ill-conditioning at r_cut (chip_smoke.py)."""
    _check(_system("dpd"), ref, want="all", masked=masked)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("T", [2, 3])
def test_dpd_types(ref, T):
    """Per-type-pair A/gamma/s/r_cut through the one-hot contraction."""
    _check(_system("dpd", T=T, seed=T), ref, want="force", masked=False)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("mode,masked", [("none", False), ("shift", True)])
def test_aniso(ref, mode, masked):
    """TwoPatchMorse force and each side's own torque."""
    _check(_system("aniso", mode=mode), ref, want="force", masked=masked)


@pytest.mark.parametrize("ref", REFS)
def test_aniso_two_types(ref):
    _check(_system("aniso", T=2, mode="shift", seed=5), ref, want="force",
           masked=False)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("want", ["force", "all"])
def test_tilted_box(ref, want):
    """Triclinic pre-shifted stencil; tilted boxes always run masked."""
    sim = _system("pair", mode="shift", tilt=(0.3, -0.1, 0.2), seed=29)
    _check(sim, ref, want=want, masked=True)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("T,want", [(3, "all"), (4, "force")])
def test_pair_many_types(ref, T, want):
    """T x T tables with every pair distinct and one pair disabled."""
    sim = _system("pair", T=T, mode="shift", seed=31 + T, disable_pair=True)
    _check(sim, ref, want=want, masked=False)


@pytest.mark.parametrize("ref", REFS)
def test_odd_cell_count(ref):
    """A 5^3 grid: a cell count that is no multiple of 128 (or of 8)."""
    sim = _system("pair", n=6, a=1.5)
    assert sim._grid_spec.n_cells % 128 != 0
    _check(sim, ref, want="force", masked=False)
