"""Smoke test of the MD engine on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py           # one GPU: phases 1-4
    python chip_smoke.py --four    # four GPUs: phase 5 only

Everything runs in this one process: a second JAX process on the card
would fail for want of memory.

1. Device: print nvidia-smi's name and power limit and ``jax.devices()``;
   fail unless JAX's first device is a GPU (there is no CPU fallback).
2. Force parity at real widths: the dense stencil drivers, compiled for
   the GPU, against the padded Verlet-list oracle (ops/pair_force.py,
   ops/aniso_force.py) evaluated in float64 on the host, on the
   configurations phase 3 produced.
3. Main path: the six bench.py systems, from the same builders, through
   ``Simulation.run`` past their capacity tune; positions finite, no
   capacity overflow, kinetic temperature in its band, positive solvent
   drift in the colloid cell, and an NVE energy-drift bound.
4. Determinism: the polymer melt (bond forces are scatter-adds) run twice
   from one seed must give bitwise-equal trajectories.
5. ``--four`` only: the 64k headline slab system through the spatial
   decomposition over four GPUs against the same system on one GPU: the
   position sharding spans all four devices, the two programs' forces
   agree on one state, and the trajectories agree to a stated bound.

Every check raises on failure, so any failure exits non-zero. The last
line of standard output is one JSON object naming the device; it is
printed only when every phase passed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Tolerances of the force parity (phase 2). The CPU suite holds the half
# stencil to the full stencil at atol = 5e-5 * scale, rtol = 5e-5
# (tests/test_dense_half.py), scale = max(max|ref|, 1): f32 sums of ~100
# pair terms taken in another order. The float64 oracle sees the same f32
# positions, so the same bound applies, plus one stated term per field
# (cutoff_terms): the largest change of ONE pair's contribution when its
# separation moves by delta_r, the f32 rounding of the pre-shifted periodic
# image the stencil reads (x + L rounded to f32: delta_r = sqrt(3) *
# ulp(1.5 L) / 2, ~1.6e-6 at L = 19). Near r_cut that is
#  * a potential discontinuous at r_cut (mode "none" energies, any
#    truncated force): the pair's whole term at r_cut, because the f32 and
#    f64 distances can fall on opposite sides of r_cut;
#  * DPD with weight (1 - r/r_c)^(s/2), s < 2, whose slope diverges at r_c:
#    sigma * (delta_r / r_c)^(s/2) for the random force (measured on the
#    H100 at atol = 5e-5 * scale alone: err/limit 0.84 at the 22k DPD grid,
#    a heavy-tailed maximum over the pairs nearest r_c);
#  * zero for the patch potential (its Morse tail at r_cut is < 1e-5).
PARITY_ATOL = 5e-5
PARITY_RTOL = 5e-5

# Kinetic-temperature bands after the phase-3 run (500 steps). A broken
# force or integrator moves the temperature by orders of magnitude or to
# NaN; the bands only allow the transients of each system's start: a
# lattice melting under a weak Langevin coupling (headline gamma = 0.1,
# relaxation time 10 = 2000 steps), patchy bonds forming from a lattice,
# the droplet's parabolic flow adding kinetic energy on top of kT, and the
# polymer's straight rods melting (a 1/8-size rehearsal on the CPU read
# kinetic T 0.70 after 500 steps: the melt absorbs kinetic energy faster
# than Langevin gamma = 0.5 restores it).
TEMPERATURE_BANDS = {
    "headline_64k": (1.0, 0.25),
    "polymer_melt_32k": (1.0, 0.40),
    "dpd_fluid_22k": (1.0, 0.10),
    "patchy_colloids_27k": (0.3, 0.35),
    "droplet_evaporation_20k": (1.0, 0.30),
    "colloid_hydrodynamics": (1.0, 0.10),  # the SRD solvent's temperature
}

# NVE drift bound: |E(t) - E(0)| / N after a ConstantVolume run of the
# headline system (the repository's verification bound).
NVE_STEPS = 300
NVE_DRIFT_BOUND = 1e-2

# Four-GPU parity (phase 5). The CPU dryrun (__graft_entry__.py) asserts
# that the spatial path's trajectory is bitwise equal to one device's, and
# on the CPU it is. On the H100 it is not (max |dx| 2.7e-4 after 100
# steps of the headline slab system, chip, PR 1): XLA compiles the
# partitioned program with other fusions (the halo exchange splits them),
# so f32 sums and fused multiply-adds round differently, and the liquid's
# chaos grows those last-bit differences. So phase 5 checks (a) the forces
# of the partitioned and the one-device program on one and the same state,
# to the force-parity tolerance above (f32 sums in another order), and
# (b) the trajectories after FOUR_STEPS steps to FOUR_DX_BOUND: rounding
# differences grown by chaos stay far below it, while a fault in the halo
# exchange or the migration (a missed pair carries a force of order 10 to
# 100) displaces particles by order 1 within those steps.
FOUR_STEPS = 100
FOUR_DX_BOUND = 1e-2

WARM_STEPS = 300  # past the capacity tune at step TUNE_AFTER
TUNE_AFTER = 150
TIMED_STEPS = 200


class SmokeFailure(RuntimeError):
    """A phase check failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: the device
# ---------------------------------------------------------------------------
def nvidia_smi_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except FileNotFoundError as e:
        raise SmokeFailure("nvidia-smi not found: no NVIDIA GPU here") from e
    return out.stdout.strip()


def require_gpu(count):
    """Fail unless JAX's devices are GPUs and at least ``count`` exist."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU: first device is {devs[0].platform!r}")
    check(len(devs) >= count, f"need {count} GPUs, JAX found {len(devs)}")
    return devs


def phase_device(count):
    say("== phase 1: device")
    card = nvidia_smi_line()
    say(f"nvidia-smi: {card}")
    devs = require_gpu(count)
    say(f"jax.devices(): {devs}")
    return devs, card


# ---------------------------------------------------------------------------
# Phase 2: dense stencil drivers vs the float64 padded-list oracle
# ---------------------------------------------------------------------------
def _fields(force, want):
    torque = getattr(force, "_produces_torque", False)
    out = ["force"] + (["torque"] if torque else [])
    if want == "all":
        out += ["energy", "virial"]
    return out


def dense_terms(force, dense, spec, timestep, ctx, tbl, *, want, half,
                masked):
    """The production dense driver's result as numpy arrays in TAG order."""
    import jax.numpy as jnp

    from azplugins_tpu.ops import dense as D

    T = np.asarray(tbl["r_cut"]).shape[0]
    jb = D.make_jblocks(
        dense, spec,
        need_velocity=getattr(force, "_needs_velocity_j", False),
        need_tag=getattr(force, "_needs_tag_j", False),
        need_quat=getattr(force, "_needs_quat_j", False),
        half=half, need_typeid=masked or T > 1,
    )
    res = force._compute_dense(
        dense, jb, spec, None, jnp.int32(timestep), ctx, tbl,
        want=want, masked=masked,
    )
    tag = np.asarray(dense.tag)
    valid = tag >= 0
    out = {}
    for k in _fields(force, want):
        a = np.asarray(getattr(res, k))
        t = np.zeros((int(valid.sum()),) + a.shape[1:], a.dtype)
        t[tag[valid]] = a[valid]
        out[k] = t
    return out


def oracle_terms(force, dense, timestep, ctx, tbl):
    """The padded Verlet-list oracle in float64 on the host, TAG order.

    The neighbor list is built in f32 (it only selects candidates within
    r_cut + 0.1); the pair terms are evaluated in float64 on the CPU
    device from the same f32 positions the dense driver saw.
    """
    import jax
    import jax.numpy as jnp

    from azplugins_tpu.ops.neighbor import NeighborSpec, build_neighbor_list

    cpu = jax.devices("cpu")[0]
    tag = np.asarray(dense.tag)
    slots = np.nonzero(tag >= 0)[0]
    slots = slots[np.argsort(tag[slots])]
    N = len(slots)

    def take(a):
        return np.asarray(a)[slots]

    box32 = jax.tree_util.tree_map(np.asarray, dense.box)
    pos32 = take(dense.position)
    r_cut = float(np.asarray(tbl["r_cut"]).max())
    spec = NeighborSpec.create(box32, N, r_cut, 0.1)
    with jax.default_device(cpu):
        for _ in range(6):
            nl = build_neighbor_list(jnp.asarray(pos32), box32, spec)
            if not bool(nl.overflow):
                break
            spec = spec.grow(bool(nl.cell_overflow), bool(nl.nlist_overflow))
        check(not bool(nl.overflow), "oracle neighbor list overflowed")
        idx = np.asarray(nl.idx)

    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype.kind == "f" else a

    with jax.enable_x64(True), jax.default_device(cpu):
        state = dense.replace(
            position=jnp.asarray(f64(pos32)),
            velocity=jnp.asarray(f64(take(dense.velocity))),
            orientation=jnp.asarray(f64(take(dense.orientation))),
            typeid=jnp.asarray(take(dense.typeid)),
            tag=jnp.asarray(take(dense.tag)),
            box=jax.tree_util.tree_map(lambda a: jnp.asarray(f64(a)), box32),
        )
        tbl64 = jax.tree_util.tree_map(lambda a: jnp.asarray(f64(a)), tbl)
        res = force._compute(state, jnp.asarray(idx), timestep, ctx, tbl64)
        return {
            k: np.asarray(getattr(res, k), np.float64)
            for k in ("force", "torque", "energy", "virial")
            if getattr(res, k) is not None
        }


def cutoff_terms(force, tbl, timestep, ctx, box):
    """One pair's worst change near r_cut, per field (see the tolerances)."""
    terms = {"force": 0.0, "torque": 0.0, "energy": 0.0, "virial": 0.0}
    if not hasattr(force, "_def") or not hasattr(force._def, "energy_force"):
        return terms
    rc = np.asarray(tbl["r_cut"], np.float64)
    on = rc > 0
    L = float(np.asarray(box.L, np.float64).max())
    delta_r = np.sqrt(3.0) * float(np.spacing(np.float32(1.5 * L))) / 2
    p = {k: np.asarray(v, np.float64) for k, v in tbl["params"].items()}
    if type(force).__name__ == "DPDGeneralWeight":
        kT = float(force.kT(timestep))
        sigma = np.sqrt(6.0 * p["gamma"] * kT / ctx.dt) if ctx.dt > 0 else 0 * rc
        x = delta_r / np.where(on, rc, 1.0)
        terms["force"] = float(np.where(on, sigma * x ** (0.5 * p["s"]), 0.0).max())
        return terms
    from azplugins_tpu.ops import dense as D

    rcsq = np.where(on, rc * rc, 1.0)
    e, f = D._eval_pair_mode(force._def.energy_force, rcsq, rc, rcsq, p,
                             force.mode, np.asarray(tbl["r_on"], np.float64))
    e = np.where(on, np.abs(np.asarray(e)), 0.0).max()
    f = np.where(on, np.abs(np.asarray(f)), 0.0).max()
    terms.update(force=float(f * rc.max()), energy=float(0.5 * e),
                 virial=float(0.5 * f * rc.max() ** 2))
    return terms


def compare_terms(got, ref, fields, cut=None):
    """Per field: (max |err|, its limit, worst err/limit). ok <=> all <= 1.

    limit = PARITY_ATOL * max(max|ref|, 1) + cut[field] + PARITY_RTOL * |ref|.
    """
    rows = []
    for k in fields:
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        scale = max(float(np.abs(r).max()) if r.size else 0.0, 1.0)
        a = PARITY_ATOL * scale + (cut or {}).get(k, 0.0)
        err = np.abs(g - r)
        lim = a + PARITY_RTOL * np.abs(r)
        ratio = err / lim
        w = np.unravel_index(np.argmax(ratio), ratio.shape)
        rows.append((k, float(err.max()), float(lim[w]), float(ratio[w])))
    return rows


def force_parity(name, sim):
    """Phase-2 check of one simulation's pair force at its current state:
    the production ``want="force"`` and the observables' ``want="all"``."""
    dense, spec = sim._dense, sim._grid_spec
    force = next(f for f in sim._forces() if getattr(f, "_needs_nlist", False))
    tbl = force._device_tables()
    t = sim._timestep
    masked = bool(np.any(np.asarray(dense.box.tilt) != 0)) or not spec.newton_ok
    oracle = oracle_terms(force, dense, t, sim._ctx(), tbl)
    cut = cutoff_terms(force, tbl, t, sim._ctx(), dense.box)
    say(f"{name}: {type(force).__name__}, N={len(oracle['force'])}, "
        f"grid {spec.dims} cap {spec.cap}, timestep {t}")
    for want in ("force", "all"):
        got = dense_terms(force, dense, spec, t, sim._ctx(), tbl, want=want,
                          half=spec.newton_ok, masked=masked)
        for k, err, lim, ratio in compare_terms(got, oracle,
                                                _fields(force, want), cut=cut):
            say(f"  want={want:5s} {k:6s} max|err| {err:.3e}  "
                f"limit {lim:.3e}  worst err/limit {ratio:.3f}")
            check(ratio <= 1.0, f"{name} want={want} {k}: err/limit {ratio:.3f}")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.backend_compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration
            if event.endswith("backend_compile_duration"):
                self.backend_compiles += 1


def systems():
    """(name, builder) of the six benchmark systems, from bench.py."""
    import bench

    return [
        ("headline_64k", lambda: bench.build_sim()[0]),
        ("polymer_melt_32k", bench.build_polymer_melt),
        ("dpd_fluid_22k", bench.build_dpd_fluid),
        ("patchy_colloids_27k", bench.build_patchy),
        ("droplet_evaporation_20k", bench.build_droplet),
        ("colloid_hydrodynamics", bench.build_colloid_hydro),
    ]


def run_system(name, build, clock, card):
    """Build and run one system through Simulation.run; check its physics."""
    import jax

    import azplugins_tpu as az

    c0, n0 = clock.seconds, clock.backend_compiles
    t0 = time.perf_counter()
    sim = build()
    sim.auto_tune_after = TUNE_AFTER
    sim.run(WARM_STEPS)
    warm_s = time.perf_counter() - t0
    compile_s = clock.seconds - c0
    compiles = clock.backend_compiles - n0
    c1, n1 = clock.seconds, clock.backend_compiles
    t0 = time.perf_counter()
    sim.run(TIMED_STEPS)
    jax.block_until_ready(sim._dense.position)
    window_s = time.perf_counter() - t0
    window_compile_s = clock.seconds - c1
    ms = (window_s - window_compile_s) / TIMED_STEPS * 1e3

    snap = sim.state.get_snapshot()
    pos = snap.particles.position
    check(np.isfinite(pos).all(), f"{name}: non-finite positions")
    check(not bool(sim._meta.overflow), f"{name}: cell capacity overflow")
    target, band = TEMPERATURE_BANDS[name]
    if sim._mpcd is not None:
        v = np.asarray(sim._mpcd["velocity"], np.float64)
        drift = float(v[:, 0].mean())
        kT = float(((v - v.mean(axis=0)) ** 2).sum(axis=1).mean() / 3.0)
        what = "solvent kT"
        check(drift > 0, f"{name}: solvent drift {drift:.4g} is not positive")
    else:
        thermo = az.compute.ThermodynamicQuantities()
        sim.operations.computes.append(thermo)
        thermo._attach(sim)
        kT = float(thermo.kinetic_temperature)
        drift = None
        what = "kinetic T"
    check(abs(kT - target) <= band * target,
          f"{name}: {what} {kT:.4f} outside {target} +- {band * 100:.0f}%")
    say(f"{name}: N={snap.particles.N} grid {sim._grid_spec.dims} "
        f"cap {sim._grid_spec.cap} rebuild interval {sim._seg_len}; "
        f"{what} {kT:.4f} (target {target} +- {band * 100:.0f}%)"
        + (f", solvent drift vx {drift:.4f}" if drift is not None else ""))
    say(f"  set-up: {warm_s:.1f} s for the first {WARM_STEPS} steps, of which "
        f"{compile_s:.1f} s tracing+compiling ({compiles} backend compiles)")
    say(f"  informational: {ms:.3f} ms/step over {TIMED_STEPS} steps, host clock "
        f"less {window_compile_s:.1f} s of compiling in the window "
        f"({clock.backend_compiles - n1} backend compiles); not a benchmark; "
        f"on {card}")
    return sim


def nve_drift(sim):
    """Switch the headline system to ConstantVolume; energy drift / N."""
    import azplugins_tpu as az

    integ = sim.operations.integrator
    sim.operations.integrator = az.md.Integrator(
        dt=integ.dt, methods=[az.md.methods.ConstantVolume()],
        forces=list(integ.forces),
    )
    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    sim.run(1)  # rebind the runner to the NVE method
    e0 = thermo.kinetic_energy + thermo.potential_energy
    sim.run(NVE_STEPS)
    e1 = thermo.kinetic_energy + thermo.potential_energy
    return abs(e1 - e0) / sim.state.N_particles


def memory_analysis(sim):
    """compiled.memory_analysis() of the simulation's step chunk."""
    import jax.numpy as jnp

    lowered = sim._run_chunk_bound.lower(
        sim._dense, sim._meta, jnp.int32(sim._timestep), jnp.int32(100),
        jnp.int32(sim._seg_len), True, None,
    )
    return lowered.compile().memory_analysis()


# ---------------------------------------------------------------------------
# Phase 4: determinism
# ---------------------------------------------------------------------------
def trajectories_equal(a, b):
    """(bitwise equal, max |dx|) of two simulations' positions."""
    pa = a.state.get_snapshot().particles.position
    pb = b.state.get_snapshot().particles.position
    return bool(np.array_equal(pa, pb)), float(np.abs(pa - pb).max())


# ---------------------------------------------------------------------------
# Phase 5: four GPUs
# ---------------------------------------------------------------------------
def spatial_parity(n_devices, steps):
    """Headline slab system over an n-device spatial mesh vs one device.

    Returns (devices spanned by the position sharding, trajectories
    bitwise equal, max |dx|, forces bitwise equal, force compare row).
    The forces compare the partitioned program with the one-device
    program on one and the same state (the spatial run's last).
    """
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import build_headline_slab
    from azplugins_tpu.parallel import make_mesh

    ref = build_headline_slab()
    ref.run(steps)
    sim = build_headline_slab()
    sim.enable_spatial_decomposition(make_mesh(n_devices))
    sim.run(steps)
    span = len(sim._dense.position.sharding.device_set)
    equal, dmax = trajectories_equal(ref, sim)

    args = (sim._dense, sim._meta.slot_of)
    t, tbls = jnp.int32(sim._timestep), sim._force_tables()
    f_mesh = np.asarray(sim._compute_net_jit(*args, t, tbls)[0])
    one = jax.devices()[0]
    f_one = np.asarray(
        jax.jit(sim._compute_net)(*jax.device_put(args, one), t, tbls)[0]
    )
    row = compare_terms({"force": f_mesh}, {"force": f_one}, ["force"])[0]
    return span, equal, dmax, bool(np.array_equal(f_mesh, f_one)), row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU spatial-decomposition phase")
    args = ap.parse_args(argv)

    import jax

    devs, card = phase_device(4 if args.four else 1)

    import azplugins_tpu  # noqa: F401  (sets matmul precision "highest")
    import bench

    bench._enable_compile_cache()
    check(jax.config.jax_default_matmul_precision == "highest",
          "matmul precision is not 'highest'")

    if args.four:
        say("== phase 5: spatial decomposition over 4 GPUs vs 1 GPU")
        t0 = time.perf_counter()
        span, equal, dmax, f_equal, row = spatial_parity(4, FOUR_STEPS)
        say(f"headline slab, {FOUR_STEPS} steps: position sharding spans "
            f"{span} devices [{time.perf_counter() - t0:.1f} s]")
        say(f"  forces, 4-GPU vs 1-GPU program on one state: bitwise equal "
            f"{f_equal}; max|err| {row[1]:.3e}  limit {row[2]:.3e}  "
            f"worst err/limit {row[3]:.3f}")
        say(f"  trajectories: bitwise equal {equal}; max |dx| {dmax:.3e} "
            f"(bound {FOUR_DX_BOUND})")
        check(span == 4, f"position sharding spans {span} devices, not 4")
        check(row[3] <= 1.0, f"4-GPU forces differ: err/limit {row[3]:.3f}")
        check(dmax < FOUR_DX_BOUND, f"4-GPU trajectory differs: {dmax:.3e}")
    else:
        clock = CompileClock()
        say("== phase 3: main path (bench.py systems through Simulation.run)")
        sims = {}
        for name, build in systems():
            sims[name] = run_system(name, build, clock, card)
        head = sims["headline_64k"]
        say(f"headline step chunk memory_analysis: {memory_analysis(head)}")

        say("== phase 2: dense stencil drivers vs the float64 oracle")
        for name in ("headline_64k", "dpd_fluid_22k", "patchy_colloids_27k"):
            force_parity(name, sims[name])

        drift = nve_drift(head)
        say(f"headline NVE: |dE|/N = {drift:.3e} over {NVE_STEPS} steps "
            f"(bound {NVE_DRIFT_BOUND})")
        check(drift < NVE_DRIFT_BOUND, f"NVE drift {drift:.3e} too large")

        say("== phase 4: determinism (polymer melt, same seed, twice)")
        again = run_system("polymer_melt_32k", dict(systems())["polymer_melt_32k"],
                           clock, card)
        equal, dmax = trajectories_equal(sims["polymer_melt_32k"], again)
        say(f"polymer melt trajectories bitwise equal: {equal} "
            f"(max |dx| {dmax:.3e})")
        check(equal, "polymer melt is not bitwise reproducible")

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
