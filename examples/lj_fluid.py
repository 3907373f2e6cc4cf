"""Perturbed-LJ fluid, Langevin NVT: the quick-start example.

Melts a simple-cubic lattice, logs temperature/energy, writes a
trajectory. Runs on the GPU or the CPU.
"""

import os

import numpy as np

import azplugins_tpu as az

# CI smoke mode: tiny system + short runs (tests/test_examples.py)
FAST = os.environ.get("AZTPU_EXAMPLE_FAST") == "1"


def make_lattice_snapshot(n_side=None, rho=0.8):
    if n_side is None:
        n_side = 6 if FAST else 10
    N = n_side**3
    L = (N / rho) ** (1 / 3)
    a = L / n_side
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)
    return snap


def main():
    sim = az.Simulation(seed=42)
    sim.create_state_from_snapshot(make_lattice_snapshot())

    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5, mode="shift"
    )
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0)

    sim.operations.integrator = az.md.Integrator(
        dt=0.005,
        methods=[az.md.methods.Langevin(kT=1.2, default_gamma=0.5)],
        forces=[lj],
    )

    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    logger = az.write.Logger()
    logger.add(thermo, ["kinetic_temperature"], prefix="thermo")
    logger["U/N"] = lambda: lj.energy / sim.state.N_particles
    sim.operations += az.write.Table(trigger=500, logger=logger)
    sim.operations += az.write.Trajectory(
        trigger=200 if FAST else 1000, filename="lj_fluid.azt"
    )

    sim.state.thermalize_particle_momenta(kT=1.2)
    sim.run(400 if FAST else 5000)
    print(f"final kT = {thermo.kinetic_temperature:.3f}, U/N = "
          f"{lj.energy / sim.state.N_particles:.3f}")


if __name__ == "__main__":
    main()
