"""Benchmark: 64k-particle perturbed-LJ fluid, NVT Langevin (BASELINE.json).

Prints one JSON line per config, the 64k headline LAST:
{"metric", "value", "unit", "vs_baseline", ...extra}. Runs on a GPU only;
it exits non-zero on any other platform and when any config fails.

Config (see BENCH.md): N = 40^3 = 64,000, rho = 0.85, r_cut = 3.0 (the
azplugins PerturbedLennardJones doc example cutoff), Verlet buffer 0.4,
dt = 0.005, Langevin kT = 1.0. vs_baseline is measured TPS divided by an
ESTIMATED HOOMD-blue H100 rate for the same system (no published number
exists; see BASELINE.md — the reference publishes none).

Timing protocol: every timed region ends by fetching ONE scalar sliced
on-device (a true device drain), and is DIFFERENTIAL — the same jitted
computation at two step counts, divided by the step difference — so
dispatch and fetch fixed costs cancel. The benchmark harness is rebuilt
for the GPU in ROADMAP 1.1.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

H100_HOOMD_TPS_ESTIMATE = 1500.0  # an estimate, not a measurement: BENCH.md


def sync_scalar(x):
    """True device drain: fetch one element, sliced on-device first."""
    np.asarray(x[(0,) * x.ndim])


def _enable_compile_cache():
    """Persistent XLA compile cache (same policy as tests/conftest.py).

    Each chunk-runner variant compiles for seconds to minutes; with the
    on-disk cache a repeated invocation warms from disk. JAX itself
    honours JAX_COMPILATION_CACHE_DIR when it is set; otherwise the cache
    lives at a fixed path in the checkout. The cache key covers the HLO
    and compile options, so stale hits cannot change results."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
        )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def _perf_extras(sim):
    """Compile/churn provenance for the JSON output."""
    cap = sim._grid_spec.cap if sim._grid_spec is not None else None
    return {
        "cap": cap,
        "runner_builds": getattr(sim, "_runner_builds", 0),
        # violation replays re-run a whole chunk: a nonzero count during
        # the timed window means the recorded ms/step carries replay work
        "viol_replays": getattr(sim, "_viol_replays", 0),
    }


def build_sim(N_side=40, rho=0.85, seed=12345):
    import azplugins_tpu as az

    N = N_side**3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / N_side
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(N_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), axis=-1
    ).reshape(-1, 3)

    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    # BENCH_BUFFER: Verlet buffer sweep knob — a larger buffer lengthens
    # the rebuild interval but widens r_list (more pair slots in the
    # kernel); 0.4 is the documented default
    cell = az.md.nlist.Cell(buffer=float(os.environ.get("BENCH_BUFFER", "0.4")))
    lj = az.pair.PerturbedLennardJones(nlist=cell, default_r_cut=3.0, mode="none")
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    lang = az.md.methods.Langevin(kT=1.0, default_gamma=0.1)
    sim.operations.integrator = az.md.Integrator(dt=0.005, methods=[lang], forces=[lj])
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim, lj


def time_steps(sim, n_lo, n_hi, reps=3):
    """Differential ms/step of the production ``run()`` path.

    One untimed priming pair first: the lo/hi windows can start at
    different rebuild-schedule offsets, and the first unaligned chunk
    compiles a continuation variant (~5 s) that would poison a timed
    window. Median over reps rejects any residual outlier.
    """
    diffs = []
    sim.run(n_lo)
    sim.run(n_hi)
    sync_scalar(sim._dense.position)
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.run(n_lo)
        sync_scalar(sim._dense.position)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim.run(n_hi)
        sync_scalar(sim._dense.position)
        t_hi = time.perf_counter() - t0
        diffs.append((t_hi - t_lo) / (n_hi - n_lo) * 1e3)
    diffs.sort()
    return diffs[len(diffs) // 2]


def time_force_kernel(sim, lj, n_lo=20, n_hi=120):
    """Isolated force-kernel latency on the PRODUCTION path.

    Same flags as the hot loop (want="force", half-stencil, maskless);
    differential over a traced-length on-device loop.
    """
    import jax
    import jax.numpy as jnp

    from azplugins_tpu.ops import dense as D

    ctx = sim._ctx()
    tbl = lj._device_tables()
    spec = sim._grid_spec

    @jax.jit
    def loop(dense, n):
        def body(i, d):
            # nudge positions so XLA cannot hoist the loop-invariant kernel
            d = d.replace(position=d.position + jnp.float32(1e-9) * i)
            jb = D.make_jblocks(d, spec, half=spec.newton_ok, need_typeid=False)
            r = lj._compute_dense(
                d, jb, spec, None, i, ctx, tbl, want="force", masked=False,
            )
            return d.replace(net_force=r.force)

        return jax.lax.fori_loop(0, n, body, dense)

    sync_scalar(loop(sim._dense, jnp.int32(n_hi)).net_force)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        sync_scalar(loop(sim._dense, jnp.int32(n_lo)).net_force)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        sync_scalar(loop(sim._dense, jnp.int32(n_hi)).net_force)
        t_hi = time.perf_counter() - t0
        best = min(best, (t_hi - t_lo) / (n_hi - n_lo) * 1e3)
    return best


def time_rebin(sim, n_lo=10, n_hi=60, reps=3):
    """Differential cost of one neighbor rebuild (rebin sort), median over
    reps."""
    import jax
    import jax.numpy as jnp

    from azplugins_tpu.ops import dense as D

    spec = sim._grid_spec
    N_tags = sim._state.N
    fields = sim._fields
    # match the production flag: a bond-free system carries an empty
    # slot_of, and the fori_loop carry must keep that shape
    need_slot_of = sim._meta.slot_of.shape[0] > 0

    @jax.jit
    def loop(dense, meta, n):
        def body(i, carry):
            d, mt = carry
            d = d.replace(position=d.position + jnp.float32(1e-9) * i)
            return D.rebin(d, mt, spec, N_tags, fields, need_slot_of)

        return jax.lax.fori_loop(0, n, body, (dense, meta))

    sync_scalar(loop(sim._dense, sim._meta, jnp.int32(n_hi))[0].position)
    diffs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync_scalar(loop(sim._dense, sim._meta, jnp.int32(n_lo))[0].position)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        sync_scalar(loop(sim._dense, sim._meta, jnp.int32(n_hi))[0].position)
        t_hi = time.perf_counter() - t0
        diffs.append((t_hi - t_lo) / (n_hi - n_lo) * 1e3)
    diffs.sort()
    return diffs[len(diffs) // 2]


def _stage(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Extra configs (BASELINE.json configs 2-5): one JSON line each, printed
# BEFORE the headline 64k perturbed-LJ line so last-line parsers still get
# the headline metric. vs_baseline is null — no reference estimate exists
# for these (BASELINE.md: the reference publishes no numbers at all).
# ---------------------------------------------------------------------------
def build_polymer_melt(n_chains=1280, chain_len=25, rho=0.5, seed=14):
    """BASELINE config 2: quartic scissile bonds + ExpandedYukawa pairs."""
    import azplugins_tpu as az

    N = n_chains * chain_len
    L = (N / rho) ** (1 / 3)
    snap = az.Snapshot(N=N, bond_N=n_chains * (chain_len - 1))
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.bonds.types = ["backbone"]
    # straight rods along x on a (y, z) grid: no inter-chain contact ever
    # gets near the ExpandedYukawa delta (random-walk starts overlapped
    # chains into the r < delta divergence -> immediate blow-up on chip);
    # Langevin at kT=1 melts the rods during warmup, same as the LJ lattice
    gy = int(np.floor(np.sqrt(n_chains)))
    gz = (n_chains + gy - 1) // gy
    b = 0
    for c in range(n_chains):
        y = ((c % gy) + 0.5) * L / gy - L / 2
        z = ((c // gy) + 0.5) * L / gz - L / 2
        x0 = -0.97 * (chain_len - 1) / 2
        for m in range(chain_len):
            i = c * chain_len + m
            snap.particles.position[i] = [x0 + 0.97 * m, y, z]
            if m < chain_len - 1:
                snap.bonds.typeid[b] = 0
                snap.bonds.group[b] = [i, i + 1]
                b += 1
    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    bonds = az.bond.Quartic()
    bonds.params["backbone"] = dict(
        k=1434.3, r_0=1.5, b_1=-0.7589, b_2=0.0, U_0=67.2234,
        sigma=1.0, epsilon=1.0, delta=0.0,
    )
    pairs = az.pair.ExpandedYukawa(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5
    )
    pairs.params[("A", "A")] = dict(epsilon=2.0, kappa=1.5, delta=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=1.0, default_gamma=0.5)],
        forces=[bonds, pairs],
    )
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim


def build_dpd_fluid(n_side=28, rho=3.0, seed=5):
    """BASELINE config 3: DPD general-weight thermostat fluid (~22k)."""
    import azplugins_tpu as az

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
    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    dpd = az.pair.DPDGeneralWeight(
        nlist=az.md.nlist.Cell(buffer=0.4), kT=1.0, default_r_cut=1.0
    )
    dpd.params[("A", "A")] = dict(A=25.0, gamma=4.5, s=0.5)
    sim.operations.integrator = az.md.Integrator(
        dt=0.01, methods=[az.md.methods.ConstantVolume()], forces=[dpd]
    )
    return sim


def build_patchy(n_side=30, a=1.5, seed=2):
    """BASELINE config 4: TwoPatchMorse aniso + NO_SQUISH rotation (27k)."""
    import azplugins_tpu as az

    N = n_side**3
    L = n_side * a
    rng = np.random.default_rng(seed)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["P"]
    x = (np.arange(n_side) + 0.5) * a - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.moment_inertia[:] = [0.4, 0.4, 0.4]
    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    patchy = az.pair.TwoPatchMorse(
        nlist=az.md.nlist.Cell(buffer=0.3), default_r_cut=1.6, mode="shift"
    )
    patchy.params[("P", "P")] = dict(
        M_d=1.5, M_r=0.05, r_eq=1.0, omega=20.0, alpha=0.4, repulsion=True
    )
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.Langevin(kT=0.3, default_gamma=1.0)],
        forces=[patchy],
        integrate_rotational_dof=True,
    )
    sim.state.thermalize_particle_momenta(kT=0.3)
    return sim


def build_droplet(R0=20.0, a=1.1, seed=7):
    """BASELINE config 5: droplet with shrinking spherical barrier, LJ93
    wall, ParticleEvaporator, Langevin in parabolic flow (~20k)."""
    import azplugins_tpu as az

    L = 2 * R0 + 4.0
    g = np.arange(-R0, R0 + a, a)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) < R0 * 0.93]
    N = len(pts)
    snap = az.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["solvent", "evaporated"]
    snap.particles.position[:] = pts
    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.PerturbedLennardJones(
        nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.5
    )
    lj.params[("solvent", "solvent")] = dict(
        epsilon=1.0, sigma=1.0, attraction_scale_factor=1.0
    )
    lj.params[("solvent", "evaporated")] = dict(
        epsilon=0.0, sigma=1.0, attraction_scale_factor=0.0
    )
    lj.params[("evaporated", "evaporated")] = dict(
        epsilon=0.0, sigma=1.0, attraction_scale_factor=0.0
    )
    radius = az.variant.SphereArea(R0=R0, alpha=0.05)
    barrier = az.external.SphericalHarmonicBarrier(location=radius)
    barrier.params["solvent"] = dict(k=50.0, offset=0.0)
    barrier.params["evaporated"] = dict(k=0.0, offset=0.0)
    wall = az.external.wall.LJ93(
        walls=[az.external.wall.Plane(origin=(0, 0, -L / 2 + 0.5), normal=(0, 0, 1))]
    )
    wall.params["solvent"] = dict(epsilon=1.0, sigma=1.0, r_cut=3.0)
    wall.params["evaporated"] = dict(epsilon=0.0, sigma=1.0, r_cut=3.0)
    evap = az.update.ParticleEvaporator(
        trigger=az.trigger.Periodic(25),
        solvent_type="solvent", evaporated_type="evaporated",
        lo=R0 / 2, hi=L / 2, N_evap_max=10,
    )
    sim.operations.updaters.append(evap)
    flow = az.flow.ParabolicFlow(mean_velocity=0.5, separation=L - 2.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.002,
        methods=[az.md.methods.LangevinFlow(kT=1.0, flow_field=flow,
                                            default_gamma=1.0)],
        forces=[lj, barrier, wall],
    )
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim


_EXTRA_CONFIGS = [
    ("polymer_melt_32k", build_polymer_melt),
    ("dpd_fluid_22k", build_dpd_fluid),
    ("patchy_colloids_27k", build_patchy),
    ("droplet_evaporation_20k", build_droplet),
]


def bench_extras(failed):
    """Configs 2-5; appends the name of each config that fails to
    ``failed``."""
    which = os.environ.get("BENCH_CONFIGS", "all")
    if which in ("0", "headline"):
        return
    sel = None if which == "all" else set(which.split(","))
    import azplugins_tpu as az

    for name, builder in _EXTRA_CONFIGS:
        if sel is not None and name not in sel:
            continue
        line = {
            "metric": f"timesteps_per_second_{name}",
            "value": 0.0,
            "unit": "steps/s",
            "vs_baseline": None,
            "extra": {},
        }
        try:
            t0 = time.perf_counter()
            sim = builder()
            sim.auto_tune_after = 150
            sim.run(250)  # compile + warm + auto-tune + settle
            sim._seg_adapt = False
            warm_s = time.perf_counter() - t0
            _stage(f"{name}: N={sim._synced_state().N} warm in "
                   f"{warm_s:.1f}s cap={sim._grid_spec.cap}")
            ms = time_steps(sim, 60, 300)
            thermo = az.compute.ThermodynamicQuantities()
            sim.operations.computes.append(thermo)
            thermo._attach(sim)
            line["value"] = round(1e3 / ms, 1)
            line["extra"] = {
                "N": sim._synced_state().N,
                "ms_per_step": round(ms, 3),
                "rebuild_interval": sim._seg_len,
                "kinetic_temperature": round(float(thermo.kinetic_temperature), 3),
                "warm_s": round(warm_s, 1),
                **_perf_extras(sim),
            }
            _stage(f"{name}: {line['value']} TPS")
        except Exception as e:
            # keep measuring the other configs, but the run fails (main)
            _stage(f"{name} FAILED: {type(e).__name__}: {e}")
            line["extra"] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(name)
        print(json.dumps(line), flush=True)


def bench_mpcd():
    """BENCH_MPCD=1: SRD solvent throughput (opt-in; not a BASELINE
    config — the reference delegates MPCD dynamics to HOOMD)."""
    import azplugins_tpu as az

    rng = np.random.default_rng(3)
    Ls = int(os.environ.get("BENCH_MPCD_L", "64"))
    N, L = Ls**3, float(Ls)  # rho a^-3 = 1 at cell_size 1
    snap = az.Snapshot(N=2, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[-1, 0, 0], [1, 0, 0]]
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    sim = az.Simulation(seed=5)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = az.md.Integrator(
        dt=0.02, methods=[az.md.methods.ConstantVolume()], forces=[]
    )
    sim.mpcd_dynamics = az.mpcd.SRD(dt=0.02, period=1, cell_size=1.0, kT=1.0)
    sim.run(50)  # compile + settle
    sync_scalar(sim._mpcd["position"])
    t0 = time.perf_counter()
    sim.run(50)
    sync_scalar(sim._mpcd["position"])
    t_lo = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(450)
    sync_scalar(sim._mpcd["position"])
    t_hi = time.perf_counter() - t0
    ms = (t_hi - t_lo) / 400 * 1e3
    print(json.dumps({
        "metric": f"mpcd_srd_collisions_per_second_{N // 1000}k",
        "value": round(1e3 / ms, 1),
        "unit": "collisions/s",
        "vs_baseline": None,
        "extra": {"N_solvent": N, "ms_per_collision": round(ms, 3)},
    }), flush=True)


def build_colloid_hydro(L=32.0, n=14, seed=11):
    """Colloid hydrodynamics: LJ colloids embedded in a driven SRD solvent
    via CollisionCoupling (the joint collision runs inside the jitted
    chunk; examples/colloid_hydrodynamics at production scale)."""
    import azplugins_tpu as az

    rng = np.random.default_rng(9)
    N_s = int(5 * L**3)  # solvent at density 5 per collision cell
    N_c = n**3
    snap = az.Snapshot(N=N_c, mpcd_N=N_s)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["colloid"]
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    snap.particles.position[:] = np.stack(
        np.meshgrid(x, x, x, indexing="ij"), -1
    ).reshape(-1, 3)
    snap.particles.mass[:] = 5.0
    snap.mpcd.position[:] = (rng.random((N_s, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N_s, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    sim = az.Simulation(seed=seed)
    sim.create_state_from_snapshot(snap)
    lj = az.pair.LJ(nlist=az.md.nlist.Cell(buffer=0.4),
                    default_r_cut=2.0 ** (1 / 6), mode="shift")
    lj.params[("colloid", "colloid")] = dict(epsilon=1.0, sigma=1.0)
    sim.operations.integrator = az.md.Integrator(
        dt=0.005, methods=[az.md.methods.ConstantVolume()], forces=[lj]
    )
    srd = az.mpcd.SRD(dt=0.005, period=20, angle=130.0, cell_size=1.0,
                      kT=1.0, body_force=(0.02, 0.0, 0.0))
    sim.mpcd_dynamics = srd
    sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))
    return sim


def bench_mpcd_coupled():
    """Colloid-hydrodynamics throughput: MD steps/s including the coupled
    collisions (part of the default set)."""
    sim = build_colloid_hydro(
        L=float(os.environ.get("BENCH_MPCD_HYDRO_L", "32"))
    )
    N_c = sim._synced_state().N
    N_s = sim._mpcd["position"].shape[0]
    sim.auto_tune_after = 150
    t0 = time.perf_counter()
    sim.run(260)  # compile + warm + auto-tune + settle (13 collisions)
    sim._seg_adapt = False
    warm_s = time.perf_counter() - t0
    _stage(f"mpcd_coupled: N_c={N_c} N_s={N_s} warm in {warm_s:.1f}s; "
           f"ingraph={sim.operations.updaters[0]._ingraph}")
    ms = time_steps(sim, 100, 400)
    v_s = np.asarray(sim._mpcd["velocity"])
    v_c = np.asarray(sim.state.get_snapshot().particles.velocity)
    print(json.dumps({
        "metric": "timesteps_per_second_colloid_hydrodynamics",
        "value": round(1e3 / ms, 1),
        "unit": "steps/s",
        "vs_baseline": None,
        "extra": {
            "N_colloid": N_c, "N_solvent": N_s, "period": 20,
            "ms_per_step": round(ms, 3),
            "collisions_in_graph": bool(sim.operations.updaters[0]._ingraph),
            "solvent_drift_vx": round(float(v_s[:, 0].mean()), 4),
            "colloid_drift_vx": round(float(v_c[:, 0].mean()), 4),
            "warm_s": round(warm_s, 1),
            **_perf_extras(sim),
        },
    }), flush=True)


def main():
    warm_steps = int(os.environ.get("BENCH_WARM", "200"))
    steps = int(os.environ.get("BENCH_STEPS", "1000"))
    n_side = int(os.environ.get("BENCH_NSIDE", "40"))

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU only; JAX found {dev.platform!r}")
    _stage(f"device: {dev.device_kind} x{len(jax.devices())}")

    _enable_compile_cache()
    failed = []
    if os.environ.get("BENCH_MPCD") == "1":
        bench_mpcd()  # pure-SRD solvent throughput stays opt-in
    if os.environ.get("BENCH_CONFIGS", "all") == "all":
        # colloid hydrodynamics (coupled MPCD) is part of the DEFAULT set:
        # it is the showcase composition of the MPCD touchpoints
        # (/root/reference/src/VelocityFieldCompute.h:331-352)
        try:
            bench_mpcd_coupled()
        except Exception as e:
            # keep measuring the other configs, but the run fails below
            _stage(f"colloid_hydrodynamics FAILED: {type(e).__name__}: {e}")
            print(json.dumps({
                "metric": "timesteps_per_second_colloid_hydrodynamics",
                "value": 0.0, "unit": "steps/s", "vs_baseline": None,
                "extra": {"error": f"{type(e).__name__}: {e}"},
            }), flush=True)
            failed.append("colloid_hydrodynamics")
    bench_extras(failed)  # configs 2-5 first; the headline line prints LAST

    t0 = time.perf_counter()
    sim, lj = build_sim(N_side=n_side)
    sim.auto_tune_after = warm_steps  # run() retunes itself post-warmup
    _stage(f"built sim N={n_side**3} in {time.perf_counter()-t0:.1f}s")
    t_warm0 = time.perf_counter()
    t0 = time.perf_counter()
    sim.run(warm_steps)  # compile + equilibrate + settle capacities
    _stage(f"warmup {warm_steps} steps in {time.perf_counter()-t0:.1f}s")
    # settle: run() auto-tunes at the warmup boundary (auto_tune_after),
    # then the rebuild interval adapts (violation halvings + quantum
    # regrowth) at production temperature; FREEZE it afterwards — the timed
    # windows must have homogeneous per-step cost or the differential is
    # garbage (a replay inside one window made round-2's first TPS negative)
    sim.run(300)
    sim._seg_adapt = False
    warm_s = time.perf_counter() - t_warm0
    _stage(f"tuned: cap={sim._grid_spec.cap} dims={sim._grid_spec.dims} "
           f"seg_len={sim._seg_len}")

    ms_per_step = time_steps(sim, max(steps // 5, 1), steps)
    tps = 1e3 / ms_per_step
    _stage(f"timed: {ms_per_step:.3f} ms/step ({tps:.0f} TPS)")

    kernel_ms = time_force_kernel(sim, lj)
    rebin_ms = time_rebin(sim)
    _stage(f"kernel {kernel_ms:.3f} ms, rebin {rebin_ms:.3f} ms")
    n_builds = int(sim._meta.n_builds)

    # BENCH_SPATIAL=1: re-time the same system with the spatial
    # decomposition path active on a 1-device mesh — measures the
    # slab-local ppermute-rebin's single-device overhead vs the global sort
    spatial_ms = None
    if os.environ.get("BENCH_SPATIAL") == "1":
        from azplugins_tpu.parallel import make_mesh

        sim.enable_spatial_decomposition(make_mesh(1))
        sim.run(50)  # compile the spatial chunk
        sim._seg_adapt = False
        spatial_ms = time_steps(sim, max(steps // 5, 1), steps)
        _stage(f"spatial(1-device) {spatial_ms:.3f} ms/step")

    # physics sanity so the number is honest: temperature near target
    import azplugins_tpu as az

    thermo = az.compute.ThermodynamicQuantities()
    sim.operations.computes.append(thermo)
    thermo._attach(sim)
    kT = thermo.kinetic_temperature

    result = {
        "metric": "timesteps_per_second_64k_perturbed_lj",
        "value": round(tps, 1),
        "unit": "steps/s",
        "vs_baseline": round(tps / H100_HOOMD_TPS_ESTIMATE, 3),
        "extra": {
            "N": sim._synced_state().N,
            "force_kernel_ms": round(kernel_ms, 3),
            "rebin_ms": round(rebin_ms, 3),
            "ms_per_step": round(ms_per_step, 3),
            "nlist_rebuilds": n_builds,
            "rebuild_interval": sim._seg_len,
            "kinetic_temperature": round(float(kT), 3),
            "warm_s": round(warm_s, 1),
            **_perf_extras(sim),
            **(
                {"spatial_ms_per_step": round(spatial_ms, 3)}
                if spatial_ms is not None
                else {}
            ),
            "baseline_note": "vs estimated HOOMD H100 1500 TPS (no published ref numbers)",
        },
    }
    print(json.dumps(result))
    if failed:
        sys.exit(f"configs failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
