"""Test configuration: the CPU with 8 virtual devices, or the GPU.

Mirrors the reference CI pattern of running the same suite under MPI
(SURVEY §4.6) — here the multi-"rank" axis is a host-platform device mesh,
so the default run forces JAX onto the CPU with 8 virtual devices.

A run that selects exactly the chip tests (``python -m pytest tests/ -m
chip``) leaves JAX on its default platform so they reach the GPU; off the
GPU they skip themselves (tests/test_chip.py).
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr", "").strip() != "chip":
        os.environ["JAX_PLATFORMS"] = "cpu"
        # AZTPU_TEST_DEVICES mirrors the reference's serial-vs-MPI CI
        # axis: the same suite runs on 1 or 8 virtual devices
        # (multi-device tests skip themselves when fewer are present)
        ndev = os.environ.get("AZTPU_TEST_DEVICES", "8")
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={ndev}"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
        assert jax.default_backend() == "cpu", "tests must run on CPU"

    # Persistent XLA compilation cache: the suite's wall-clock is
    # dominated by backend compiles of the fused step chunks, and most
    # tests recompile identical graphs run-over-run. JAX itself honours
    # JAX_COMPILATION_CACHE_DIR when it is set; otherwise the cache lives
    # at a fixed path in the checkout. AZTPU_TEST_NO_COMPILE_CACHE=1 opts
    # out (e.g. to measure cold-compile behavior).
    if not os.environ.get("AZTPU_TEST_NO_COMPILE_CACHE"):
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update(
                "jax_compilation_cache_dir",
                os.path.join(os.path.dirname(__file__), ".jax_compile_cache"),
            )
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def two_particle_snapshot_factory():
    """Two particles at distance d along x, like hoomd's fixture."""

    def make(particle_types=None, d=1.0, L=20.0):
        import azplugins_tpu as az

        snap = az.Snapshot(N=2)
        snap.configuration.box = [L, L, L, 0, 0, 0]
        snap.particles.types = list(particle_types or ["A"])
        snap.particles.position[:] = [[-d / 2, 0, 0], [d / 2, 0, 0]]
        return snap

    return make


@pytest.fixture
def bonded_two_particle_snapshot_factory(two_particle_snapshot_factory):
    """Two bonded particles (reference conftest, src/conftest.py:10-24)."""

    def make(bond_types=None, d=1.0, L=20.0):
        snap = two_particle_snapshot_factory(d=d, L=L)
        snap.bonds.resize(1)
        snap.bonds.types = list(bond_types or ["A-A"])
        snap.bonds.typeid[0] = 0
        snap.bonds.group[0] = [0, 1]
        return snap

    return make


@pytest.fixture
def lattice_snapshot_factory():
    """n^3 simple-cubic lattice with spacing a (like hoomd's fixture)."""

    def make(particle_types=None, n=5, a=1.5):
        import azplugins_tpu as az

        N = n**3
        snap = az.Snapshot(N=N)
        L = n * a
        snap.configuration.box = [L, L, L, 0, 0, 0]
        snap.particles.types = list(particle_types or ["A"])
        x = (np.arange(n) + 0.5) * a - L / 2
        grid = np.stack(np.meshgrid(x, x, x, indexing="ij"), axis=-1).reshape(-1, 3)
        snap.particles.position[:] = grid
        return snap

    return make


@pytest.fixture
def simulation_factory():
    def make(snapshot, seed=42):
        import azplugins_tpu as az

        sim = az.Simulation(seed=seed)
        sim.create_state_from_snapshot(snapshot)
        return sim

    return make


# Per-test duration budget (round-4; the suite's wall-clock crept from
# 484s to 624s across round 3 with nothing enforcing it). CI sets
# AZTPU_TEST_BUDGET_S; any single test whose CALL phase exceeds it fails
# loudly, so a slow regression is caught at the offending test, not as
# mysterious total creep. Unset (default) locally: wall-clock under an
# interactively loaded machine is too noisy to gate on.
import time as _time  # noqa: E402


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    t0 = _time.perf_counter()
    yield
    budget = float(os.environ.get("AZTPU_TEST_BUDGET_S", "0") or 0)
    if budget:
        dt = _time.perf_counter() - t0
        if dt > budget:
            pytest.fail(
                f"{item.nodeid} took {dt:.1f}s, over the per-test "
                f"duration budget AZTPU_TEST_BUDGET_S={budget:.0f}s — "
                "split the test, shrink its shapes, or raise the budget "
                "deliberately in CI",
                pytrace=False,
            )
