"""Checks on the GPU: the chip_smoke.py phases 2-4 as tests.

Run on a machine with a GPU as ``python -m pytest tests/ -m chip`` (the
conftest then leaves JAX on its default platform). Elsewhere each test
skips: the ``gpu`` fixture decides at run time, never at import.
"""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.chip

SYSTEMS = [name for name, _ in cs.systems()]


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests/ -m chip` there")
    return cs.nvidia_smi_line()


@pytest.fixture(scope="module")
def clock(gpu):
    return cs.CompileClock()


def _run(name, clock, card):
    return cs.run_system(name, dict(cs.systems())[name], clock, card)


@pytest.mark.parametrize("name", SYSTEMS)
def test_main_path(gpu, clock, name):
    _run(name, clock, gpu)


@pytest.mark.parametrize(
    "name", ["headline_64k", "dpd_fluid_22k", "patchy_colloids_27k"]
)
def test_force_parity(gpu, clock, name):
    cs.force_parity(name, _run(name, clock, gpu))


def test_nve_drift(gpu, clock):
    assert cs.nve_drift(_run("headline_64k", clock, gpu)) < cs.NVE_DRIFT_BOUND


def test_polymer_bitwise(gpu, clock):
    a = _run("polymer_melt_32k", clock, gpu)
    b = _run("polymer_melt_32k", clock, gpu)
    equal, dmax = cs.trajectories_equal(a, b)
    assert equal, dmax
