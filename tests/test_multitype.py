"""Dense-path multi-type (T >= 3) parity vs the neighbor-list driver.

The dense _pair_params one-hot contraction unrolls O(T^2); nothing
exercised T >= 3 on the dense path. This cross-checks a
3-type mixture (distinct epsilon/sigma/r_cut per pair, one pair disabled
via r_cut=0) through both the dense half/full stencils and the padded
neighbor-list driver.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import azplugins_tpu as az
from azplugins_tpu.core.state import state_from_snapshot
from azplugins_tpu.ops import dense as D
from azplugins_tpu.ops.evaluators.pair import PAIR_POTENTIALS
from azplugins_tpu.ops.neighbor import NeighborSpec, build_neighbor_list
from azplugins_tpu.ops.pair_force import pair_force


def _three_type_system(N=600, L=12.0, seed=6):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A", "B", "C"]
    snap.particles.typeid[:] = rng.integers(0, 3, N)
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * L
    state, _, _ = state_from_snapshot(snap)
    return state


def _tables():
    """[3,3] parameter tables with every pair distinct; (B,C) disabled."""
    eps = np.array([[1.0, 0.7, 0.4], [0.7, 1.3, 0.0], [0.4, 0.0, 0.9]])
    sig = np.array([[1.0, 1.1, 0.9], [1.1, 1.2, 1.0], [0.9, 1.0, 0.8]])
    lam = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.0], [0.2, 0.0, 0.7]])
    r_cut = np.array([[2.5, 2.2, 2.0], [2.2, 2.6, 0.0], [2.0, 0.0, 2.4]])
    prec = PAIR_POTENTIALS["PerturbedLennardJones"].precompute
    keys = prec({"epsilon": 1.0, "sigma": 1.0, "attraction_scale_factor": 1.0})
    tabs = {k: np.zeros((3, 3), np.float32) for k in keys}
    for a in range(3):
        for b in range(3):
            p = prec(
                {
                    "epsilon": eps[a, b],
                    "sigma": sig[a, b],
                    "attraction_scale_factor": lam[a, b],
                }
            )
            for k, v in p.items():
                tabs[k][a, b] = v
    tabs = {k: jnp.asarray(v) for k, v in tabs.items()}
    return tabs, jnp.asarray(r_cut, jnp.float32)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("mode", ["none", "shift"])
def test_dense_three_types_matches_nlist_driver(half, mode):
    state = _three_type_system()
    tables, r_cut = _tables()
    ef = PAIR_POTENTIALS["PerturbedLennardJones"].energy_force

    nspec = NeighborSpec.create(state.box, state.N, r_cut=2.6, buffer=0.3)
    nld = build_neighbor_list(state.position, state.box, nspec)
    assert not bool(nld.overflow)
    ref = pair_force(
        ef, state.position, state.typeid, state.box, nld.idx,
        tables, r_cut, mode=mode,
    )

    spec = D.GridSpec.create(state.box, state.N, r_cut=2.6, buffer=0.3)
    dense, meta = D.densify(state, spec)
    assert not bool(meta.overflow)
    jb = D.make_jblocks(dense, spec, half=half)
    got = D.dense_pair_force(
        ef, dense, jb, spec, tables, r_cut, mode=mode,
        want="all", masked=True,
    )
    # map slot results back to tag order
    tag = np.asarray(dense.tag)
    keep = tag >= 0
    order = tag[keep]
    f_got = np.zeros((state.N, 3), np.float32)
    e_got = np.zeros((state.N,), np.float32)
    v_got = np.zeros((state.N, 6), np.float32)
    f_got[order] = np.asarray(got.force)[keep]
    e_got[order] = np.asarray(got.energy)[keep]
    v_got[order] = np.asarray(got.virial)[keep]

    scale = max(np.abs(np.asarray(ref.force)).max(), 1.0)
    np.testing.assert_allclose(f_got, np.asarray(ref.force), atol=3e-5 * scale, rtol=3e-5)
    np.testing.assert_allclose(e_got, np.asarray(ref.energy), atol=1e-4, rtol=3e-5)
    np.testing.assert_allclose(v_got, np.asarray(ref.virial), atol=2e-4, rtol=3e-5)
