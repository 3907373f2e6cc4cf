"""Newton half-stencil vs full-stencil parity for the dense DPD and aniso
drivers.

The half form evaluates each unordered pair once and scatters both Newton
sides; physics must match the full stencil to accumulation-order rounding.
DPD noise is keyed on sorted tags (reference
DPDPairEvaluatorGeneralWeight.h:213-231), so the stochastic force is
identical pair-by-pair in both forms — only the f32 summation order
differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import azplugins_tpu as az
from azplugins_tpu.core.state import state_from_snapshot
from azplugins_tpu.ops import dense as D
from azplugins_tpu.ops.evaluators.aniso import ANISO_PAIR_POTENTIALS


def _dense_system(N=500, L=12.0, seed=11, orient=False):
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * L
    state, _, _ = state_from_snapshot(snap)
    vel = rng.normal(0, 1.0, (N, 3)).astype(np.float32)
    state = state.replace(velocity=jnp.asarray(vel))
    if orient:
        q = rng.normal(0, 1.0, (N, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        state = state.replace(orientation=jnp.asarray(q, jnp.float32))
    spec = D.GridSpec.create(state.box, N, r_cut=1.5, buffer=0.3)
    assert spec.newton_ok
    dense, meta = D.densify(state, spec)
    assert not bool(meta.overflow)
    return dense, spec


@pytest.mark.parametrize("want", ["force", "all"])
@pytest.mark.parametrize("masked", [True, False])
def test_dpd_half_matches_full(want, masked):
    dense, spec = _dense_system()
    tables = {
        "A": jnp.full((1, 1), 25.0, jnp.float32),
        "gamma": jnp.full((1, 1), 4.5, jnp.float32),
        "s": jnp.full((1, 1), 0.5, jnp.float32),
    }
    r_cut = jnp.full((1, 1), 1.5, jnp.float32)

    def run(half):
        jb = D.make_jblocks(
            dense, spec, need_velocity=True, need_tag=True, half=half,
            need_typeid=masked,
        )
        return D.dense_dpd_force(
            dense, jb, spec, tables, r_cut, kT=1.2, dt=0.01, seed=7,
            timestep=jnp.int32(42), want=want, masked=masked,
        )

    full = run(False)
    half = run(True)
    f_ref = np.asarray(full.force)
    scale = max(np.abs(f_ref).max(), 1.0)
    np.testing.assert_allclose(
        np.asarray(half.force), f_ref, atol=5e-5 * scale, rtol=5e-5
    )
    if want == "all":
        np.testing.assert_allclose(
            np.asarray(half.energy), np.asarray(full.energy),
            atol=1e-4, rtol=5e-5,
        )
        np.testing.assert_allclose(
            np.asarray(half.virial), np.asarray(full.virial),
            atol=1e-4, rtol=5e-5,
        )


@pytest.mark.parametrize("want", ["force", "all"])
def test_aniso_half_matches_full(want):
    dense, spec = _dense_system(orient=True)
    prec = ANISO_PAIR_POTENTIALS["TwoPatchMorse"].precompute(
        dict(M_d=1.5, M_r=0.2, r_eq=1.0, omega=20.0, alpha=0.6, repulsion=True)
    )
    tables = {k: jnp.full((1, 1), float(v), jnp.float32) for k, v in prec.items()}
    r_cut = jnp.full((1, 1), 1.5, jnp.float32)
    ef = ANISO_PAIR_POTENTIALS["TwoPatchMorse"].energy_force_torque

    def run(half):
        jb = D.make_jblocks(
            dense, spec, need_quat=True, half=half, need_typeid=True,
        )
        return D.dense_aniso_force(
            ef, dense, jb, spec, tables, r_cut,
            mode="shift", want=want, masked=True,
        )

    full = run(False)
    half = run(True)
    for field in ("force", "torque"):
        ref = np.asarray(getattr(full, field))
        got = np.asarray(getattr(half, field))
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(got, ref, atol=5e-5 * scale, rtol=5e-5)
    if want == "all":
        np.testing.assert_allclose(
            np.asarray(half.energy), np.asarray(full.energy),
            atol=1e-4, rtol=5e-5,
        )
        np.testing.assert_allclose(
            np.asarray(half.virial), np.asarray(full.virial),
            atol=1e-4, rtol=5e-5,
        )
