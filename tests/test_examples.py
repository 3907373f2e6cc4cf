"""Smoke-run every example end-to-end.

Each ``examples/*.py`` is executed with ``AZTPU_EXAMPLE_FAST=1`` (tiny
system, short run) in a temp cwd. droplet_evaporation is the
BASELINE config-5 composition (SphereArea variant + spherical barrier +
evaporator + Langevin); this is its automated end-to-end check.
"""

import importlib.util
import pathlib
import sys

import pytest

EXAMPLES = sorted(
    p for p in (pathlib.Path(__file__).parent.parent / "examples").glob("*.py")
)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_smoke(path, monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("AZTPU_EXAMPLE_FAST", "1")
    monkeypatch.chdir(tmp_path)  # trajectory/output files land here
    spec = importlib.util.spec_from_file_location(f"example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        mod.main()
    finally:
        sys.modules.pop(spec.name, None)
    out = capsys.readouterr().out
    assert out.strip(), f"{path.stem} produced no output"
