"""azplugins_tpu: a JAX soft-matter MD engine.

A from-scratch JAX/XLA rebuild of the capabilities of
stattlab/azplugins (a HOOMD-blue component), self-contained: it includes
both azplugins' potentials/updaters/computes and the minimal engine
substrate they ride on (state, box, neighbor lists, integrators, variants,
filters). See SURVEY.md at the repo root for the layer map.

Quick start::

    import azplugins_tpu as az

    snap = az.Snapshot(N=1000)
    snap.configuration.box = [20, 20, 20, 0, 0, 0]
    snap.particles.types = ["A"]
    ...  # fill positions

    sim = az.Simulation(seed=7)
    sim.create_state_from_snapshot(snap)

    cell = az.md.nlist.Cell(buffer=0.4)
    lj = az.pair.PerturbedLennardJones(nlist=cell, default_r_cut=3.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)

    integ = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.Langevin(kT=1.0)], forces=[lj]
    )
    sim.operations.integrator = integ
    sim.run(1000)
"""

import os as _os

import jax as _jax

# MD physics must never run through silently-degraded matmuls: on the
# GPU, default-precision f32 dots may run in TF32 on the tensor cores,
# which keeps ~10 mantissa bits (a box-matrix product in TF32 would
# shift boundary-crossing particles by ~1e-3 of the box). The engine
# itself avoids matmuls on physical data (core/box.py is componentwise);
# this guard protects observables and future code.
#
# NOTE: this is a process-global setting that also affects user JAX code
# importing this library. It is skipped if the user already configured
# matmul precision (env var or prior config.update), and can be disabled
# with AZTPU_SET_MATMUL_PRECISION=0.
if (
    _os.environ.get("AZTPU_SET_MATMUL_PRECISION", "1") != "0"
    and _os.environ.get("JAX_DEFAULT_MATMUL_PRECISION") is None
    and _jax.config.jax_default_matmul_precision is None
):
    _jax.config.update("jax_default_matmul_precision", "highest")

from . import compute, external, flow, io, logging, md, mpcd, ops, update, write
from .core import Box, Snapshot, State, variant
from .md import bond, pair
from .md import filter  # noqa: A004 - mirrors hoomd.filter
from .md import trigger
from .simulation import Operations, Simulation
from .version import __version__

__all__ = [
    "Box",
    "Operations",
    "Simulation",
    "Snapshot",
    "State",
    "__version__",
    "bond",
    "compute",
    "external",
    "filter",
    "flow",
    "io",
    "logging",
    "md",
    "ops",
    "pair",
    "trigger",
    "update",
    "variant",
    "write",
]
