"""Simulation: compiles the whole timestep into one jitted loop.

Rebuild of the HOOMD ``Simulation``/``System`` loop the reference
plugs into (SURVEY §3.2). The per-step sequence matches the reference —
methods.step1 -> neighbor check/rebuild -> force computes -> methods.step2
-> triggered updaters — but the entire chunk of steps is one
``lax.fori_loop`` inside one ``jax.jit``.

Execution layout: the hot loop runs in the *dense cell-grid* layout
(ops/dense.py) — particles sorted into cell slots, stencil neighbors read
from a halo-padded grid. Rebinning happens UNCONDITIONALLY every
``seg_len`` steps (no ``lax.cond`` anywhere in the compiled loop — see
run_chunk for the compiler fault that forced this); the Verlet-buffer
check only raises a violation flag that the host answers by halving
``seg_len`` and replaying the chunk. The user-facing tag-ordered State is
materialized lazily (once per run/observable access), so layout
conversions never sit on the step path.

Capacity overflow cannot resize under jit, so chunks are transactional:
the host inspects the overflow flag after each chunk and, on overflow,
grows the slot capacity, recompiles, and replays the chunk from the saved
state (the grow-and-retry idea of src/ParticleEvaporator.cc:81-91).
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from .core.snapshot import Snapshot
from .core.state import State, state_from_snapshot, state_to_snapshot, thermalize_momenta
from .md.force import SimContext
from .ops import dense as D
from .ops.pair_force import ForceResult

__all__ = ["Simulation", "Operations"]

# module-level jitted wrappers: jax.jit caches compilations per wrapper
# object, so these must be created once, not per call
_densify_jit = jax.jit(D.densify, static_argnames=("spec", "fields", "need_slot_of"))
_undensify_jit = jax.jit(D.undensify, static_argnames=("N", "fields"))

# absolute-timestep quantum for rebuild-interval adaptation: interval
# changes only at multiples of this, keeping the rebuild schedule a pure
# function of timestep (chunking-invariant trajectories)
_GROW_QUANTUM = 100


class Operations:
    def __init__(self):
        self.integrator = None
        self.updaters: list = []
        self.computes: list = []
        self.writers: list = []

    def add(self, op):
        """hoomd-style routing: forces go to the integrator, updaters and
        computes to their lists."""
        from .compute import Compute
        from .md.force import Force
        from .update import Updater
        from .write import Writer

        if isinstance(op, Force):
            if self.integrator is None:
                raise RuntimeError("set an integrator before adding forces")
            self.integrator.forces.append(op)
        elif isinstance(op, Updater):
            self.updaters.append(op)
        elif isinstance(op, Compute):
            self.computes.append(op)
        elif isinstance(op, Writer):
            self.writers.append(op)
        else:
            raise TypeError(f"cannot add {op!r}")

    def __iadd__(self, op):
        self.add(op)
        return self


class _StateView:
    """hoomd-like ``sim.state`` accessor (always tag-ordered)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    @property
    def N_particles(self) -> int:
        return self._sim._synced_state().N

    @property
    def particle_types(self) -> list[str]:
        return list(self._sim._particle_types)

    @property
    def bond_types(self) -> list[str]:
        return list(self._sim._bond_types)

    @property
    def box(self):
        return self._sim._synced_state().box

    def get_snapshot(self) -> Snapshot:
        snap = state_to_snapshot(
            self._sim._synced_state(), self._sim._particle_types, self._sim._bond_types
        )
        mpcd = self._sim._mpcd
        if mpcd is not None:
            snap.mpcd.resize(mpcd["position"].shape[0])
            snap.mpcd.position[:] = np.asarray(mpcd["position"])
            snap.mpcd.velocity[:] = np.asarray(mpcd["velocity"])
            snap.mpcd.typeid[:] = np.asarray(mpcd["typeid"])
            snap.mpcd.mass = mpcd["mass"]
            snap.mpcd.types = list(mpcd["types"])
        return snap

    def set_snapshot(self, snapshot: Snapshot):
        self._sim._set_snapshot(snapshot)

    def thermalize_particle_momenta(self, filter=None, kT: float = 1.0):
        sim = self._sim
        state = sim._synced_state()
        mask = None
        if filter is not None:
            typeids = np.asarray(state.typeid)
            mask = jnp.asarray(filter.mask(typeids, sim._particle_types))
        sim._state = thermalize_momenta(state, kT, sim.seed, mask)
        sim._drop_dense()


class Simulation:
    """Owns state + operations; compiles and drives the step loop."""

    def __init__(self, device=None, seed: int = 0):
        self.device = device
        self.seed = int(seed) & 0xFFFF
        self.operations = Operations()
        self._state: State | None = None  # tag order (may be stale vs dense)
        self._particle_types: list[str] = []
        self._bond_types: list[str] = []
        self._timestep = 0
        self._attached = False
        self._prepared = False
        self._grid_spec: D.GridSpec | None = None
        self._dense: State | None = None  # slot order
        self._meta: D.GridMeta | None = None
        self._state_stale = False
        self._run_chunk_bound = None
        self._bound_fp = None
        self._fields: tuple = D.ALL_FIELDS  # rebin payload columns (static)
        # spatial decomposition (parallel/spatial.py): when set, dense
        # slot arrays are sharded into x-slabs over this mesh and the
        # segment rebuild runs the slab-local ppermute-migration rebin
        self._spatial_mesh = None
        self._spatial_migrate_cap: int | None = None
        self.max_chunk = 1000
        # rebuild interval: neighbor structure rebuilds at every timestep
        # divisible by _seg_len (absolute schedule; run() halves it when
        # the Verlet drift check flags a violation and replays, and grows
        # it back by 1 after clean chunks, capped by the violation ceiling)
        self._seg_len = 10
        self._seg_ceiling = 50
        self._clean_quanta = 0
        # set by a violation replay: the restored snapshot's rebuild
        # reference belongs to the pre-halving schedule, so the unaligned
        # prefix up to the next halved-schedule point must run with
        # per-step rebuilds (always valid) — a no-rebin continuation
        # would re-violate against the stale reference and cascade the
        # interval all the way to 1 (observed on the droplet bench)
        self._realign = False
        # False pins the rebuild interval (violation halving still applies;
        # quantum regrowth and chunk-splitting stop) — benchmarking hook
        self._seg_adapt = True
        # automatic post-warmup retune: at this ABSOLUTE timestep, run()
        # performs tune_cell_capacity() (rightsizing the slot capacity and
        # rebuild interval to the equilibrated system — the melt transient
        # inflates both). Fixed-timestep scheduling keeps the tune a pure
        # function of the trajectory, preserving the bitwise
        # chunking-invariance contract (HOOMD's nlist tuning as prior
        # art). None disables; manual tune_cell_capacity() cancels it.
        self.auto_tune_after: int | None = 200
        self._auto_tuned = False
        self._updater_jit: dict = {}
        # optional MPCD solvent dynamics (az.mpcd.SRD); advances the
        # snapshot's mpcd stream alongside the MD trajectory
        self.mpcd_dynamics = None

    # -- state management ------------------------------------------------
    def create_state_from_snapshot(self, snapshot: Snapshot):
        if self._state is not None:
            raise RuntimeError("state already created")
        self._set_snapshot(snapshot)

    def create_state_from_gsd(self, filename: str, frame: int = -1):
        """Initialize from a hoomd-schema GSD file and restore its step.

        HOOMD-parity loader (hoomd.Simulation.create_state_from_gsd):
        reads files written by HOOMD's gsd package or by
        az.io.export_gsd, including dynamic frames (fall back to frame 0
        for omitted chunks). The timestep restores from
        configuration/step, so triggers and RNG streams resume on the
        absolute schedule.
        """
        from .io.gsd import _read_gsd_frame

        snap, step = _read_gsd_frame(filename, frame)
        self.create_state_from_snapshot(snap)
        self.timestep = step

    def _set_snapshot(self, snapshot: Snapshot):
        self._state, self._particle_types, self._bond_types = state_from_snapshot(snapshot)
        # MPCD solvent stream: stored for the computes
        # (include_mpcd_particles); no MPCD dynamics, matching the plugin
        # boundary (/root/reference/src/VelocityFieldCompute.h:331-352)
        mpcd = getattr(snapshot, "mpcd", None)
        if mpcd is not None and mpcd.N > 0:
            self._mpcd = {
                "position": jnp.asarray(mpcd.position, jnp.float32),
                "velocity": jnp.asarray(mpcd.velocity, jnp.float32),
                "typeid": jnp.asarray(mpcd.typeid, jnp.int32),
                "mass": float(mpcd.mass),
                "types": list(mpcd.types),
            }
        else:
            self._mpcd = None
        self._drop_dense()
        self._invalidate()

    def _drop_dense(self):
        self._dense = None
        self._meta = None
        self._state_stale = False
        self._prepared = False

    def _synced_state(self) -> State:
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        if self._state_stale and self._dense is not None:
            if self._grid_spec is None:
                self._state = self._dense
            else:
                self._state = _undensify_jit(
                    self._dense, N=self._state.N, fields=self._fields
                )
            self._state_stale = False
        return self._state

    @property
    def state(self) -> _StateView:
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        return _StateView(self)

    @property
    def timestep(self) -> int:
        return self._timestep

    @timestep.setter
    def timestep(self, value: int):
        self._timestep = int(value)
        # setting the clock at/past the scheduled tune point (checkpoint
        # restart / resume) declares the tune already happened in the
        # earlier process — don't re-fire it with a surprise recompile
        # and rebuild-schedule reset mid-trajectory
        if (
            self.auto_tune_after is not None
            and self._timestep >= self.auto_tune_after
        ):
            self._auto_tuned = True

    def _invalidate(self):
        self._attached = False
        self._prepared = False
        self._run_chunk_bound = None
        self._bound_fp = None

    # -- attach ------------------------------------------------------------
    def _forces(self):
        integ = self.operations.integrator
        return integ.forces if integ is not None else []

    def _attach(self):
        if self._state is None:
            raise RuntimeError("no state; call create_state_from_snapshot first")
        integ = self.operations.integrator
        if integ is not None:
            integ._attach(self)
        for u in self.operations.updaters:
            u._attach(self)
        for c in self.operations.computes:
            c._attach(self)

        # one master grid sized by the largest pair cutoff + largest buffer
        r_cut = 0.0
        buffer = 0.0
        has_pair = False
        for f in self._forces():
            if getattr(f, "_needs_nlist", False):
                has_pair = True
                r_cut = max(r_cut, f._max_r_cut())
                buffer = max(buffer, f.nlist.buffer)
        if has_pair:
            state = self._synced_state()
            # spatial decomposition needs whole z cell columns per
            # device: snap Dx*Dy to a mesh-size-commensurate product at
            # grid creation (whole x planes — slabs — when they divide)
            dxm = (
                int(self._spatial_mesh.shape["d"])
                if self._spatial_mesh is not None
                else 1
            )
            new_spec = D.GridSpec.create(
                state.box, self._state.N, r_cut, buffer, strip_devices=dxm
            )
            # size cap for the *actual* starting configuration (host-side):
            # commensurate lattices concentrate particles far above the mean,
            # and every startup overflow-grow costs a full recompile
            occ_cap = self._max_occupancy_cap(state, new_spec)
            if occ_cap > new_spec.cap:
                new_spec = new_spec.replace(cap=occ_cap)
            if self._grid_spec is None or (
                new_spec.dims != self._grid_spec.dims
                or new_spec.r_cut != self._grid_spec.r_cut
                or new_spec.buffer != self._grid_spec.buffer
                or new_spec.cap > self._grid_spec.cap
            ):
                self._grid_spec = new_spec
                self._drop_dense()
        else:
            if self._grid_spec is not None:
                # sync BEFORE dropping: a mid-trajectory re-attach (ops
                # fingerprint change) must not roll the state back to the
                # last host sync
                self._synced_state()
                self._drop_dense()
            self._grid_spec = None
        new_fields = self._select_fields()
        if new_fields != self._fields:
            self._fields = new_fields
            self._drop_dense()
        self._build_runner()
        self._attached = True
        self._prepared = False

    def _select_fields(self) -> tuple:
        """Choose the optional rebin payload columns this run needs.

        A column rides the rebin sort only if some attached op reads it or
        the initial state carries non-default values (nothing in the engine
        mutates mass/charge/diameter/orientation mid-run, so the host-side
        check at attach is sound). Dropped columns are reconstructed from
        defaults at undensify.
        """
        state = self._synced_state()
        fields = []
        mass = np.asarray(state.mass)
        if np.any(mass != 1.0):
            fields.append("mass")
        quat = np.asarray(state.orientation)
        need_quat = any(getattr(f, "_needs_quat_j", False) for f in self._forces())
        if need_quat or np.any(quat != np.array([1.0, 0, 0, 0], np.float32)):
            fields.append("quat")
        integ = self.operations.integrator
        rot = bool(integ is not None and integ.integrate_rotational_dof)
        if (
            rot
            or np.any(np.asarray(state.angmom) != 0.0)
            or np.any(np.asarray(state.moment_inertia) != 0.0)
        ):
            fields.append("rotation")
            if "quat" not in fields:
                fields.insert(fields.index("rotation"), "quat")
        if np.any(np.asarray(state.charge) != 0.0):
            fields.append("charge")
        need_diam = any(getattr(f, "_needs_diameter", False) for f in self._forces())
        if need_diam or np.any(np.asarray(state.diameter) != 1.0):
            fields.append("diameter")
        return tuple(fields)

    def _ctx(self) -> SimContext:
        integ = self.operations.integrator
        dt = integ.dt if integ is not None else 0.0
        return SimContext(dt=dt, seed=self.seed)

    def _build_runner(self):
        # diagnostic: each build retraces (and usually recompiles) the
        # chunk runner — bench.py reports this count per config so compile
        # churn shows up in the benchmark output
        self._runner_builds = getattr(self, "_runner_builds", 0) + 1
        integ = self.operations.integrator
        methods = integ.methods if integ is not None else []
        forces = self._forces()
        updaters = list(self.operations.updaters)
        # updaters whose _update is a pure device fn of (state, t, seed)
        # and whose trigger is a built-in (pure traced-bool) schedule ride
        # INSIDE the jitted step loop; the rest fire at host chunk
        # boundaries (run() splits chunks at their firings — each split is
        # a device dispatch + blocking scalar sync)
        from .md.trigger import After, Before, On, Periodic

        # Expensive _update bodies (e.g. the evaporator's counter RNG +
        # full-N top_k) are evaluated EVERY step when inlined, firing or
        # not — for long trigger periods that costs more than the host
        # split it replaces, so they inline only while
        # period <= AZTPU_INLINE_MAX_PERIOD (default 128; the break-even
        # against a host dispatch + sync is not yet measured on the H100)
        max_period = int(os.environ.get("AZTPU_INLINE_MAX_PERIOD", "128"))
        inline_updaters = []
        coupling = None
        for u in updaters:
            if type(u.trigger) is Periodic:
                period = u.trigger.period
            elif type(u.trigger) in (After, Before):
                period = 1  # fires every step while active
            elif type(u.trigger) is On:
                period = max_period + 1  # one firing: the host split is cheap
            else:
                period = None
            u._inlined = bool(
                getattr(u, "_inline_ok", False)
                and period is not None
                and not getattr(u, "_updates_mpcd", False)
                and (getattr(u, "_inline_cheap", True) or period <= max_period)
            )
            if u._inlined:
                inline_updaters.append(u)
            if getattr(u, "_updates_mpcd", False):
                if coupling is not None:
                    raise ValueError(
                        "only one MPCD coupling updater is supported"
                    )
                coupling = u

        # MPCD collisional coupling rides INSIDE the jitted chunk: the
        # step loop is windowed at the collision period and the joint
        # (solvent + solute) collision applies unconditionally at each
        # window boundary — no masked per-step collision cost and no
        # host chunk split per firing (a dispatch + blocking scalar
        # sync). Falls back to host-boundary firing when the
        # user replaced the default trigger (arbitrary schedules cannot
        # be windowed).
        ingraph = (
            coupling is not None
            and self._mpcd is not None
            and type(coupling.trigger) is Periodic
            and coupling.trigger.period == coupling.srd.period
            and coupling.trigger.phase == coupling.srd.period - 1
        )
        if coupling is not None:
            coupling._ingraph = ingraph
        self._coupling_ingraph = coupling if ingraph else None
        joint_collide = None
        if ingraph:
            srd = coupling.srd
            coupling._attach(self)
            box0 = self._synced_state().box
            srd._validate(box0)
            L_arr = jnp.asarray(
                [float(box0.L[k]) for k in range(3)], jnp.float32
            )
            mass_s = float(self._mpcd["mass"])
            cseed = self.seed

            def joint_collide(d, solv, c_abs):
                """Joint SRD collision at absolute MD clock c_abs.

                The solvent streams from its anchor (always one fused
                jump — f32 chunking invariance, see mpcd.SRD._advance)
                and both streams' velocities rotate about the
                mass-weighted cell COM; empty MD slots are trash-binned
                with zero mass and come back untouched.
                """
                pos_a, vel_a, t_a = solv
                pos_s, vel_s = srd._stream(pos_a, vel_a, c_abs - t_a, L_arr)
                N_s = pos_s.shape[0]
                inval = d.tag < 0
                pos = jnp.concatenate([pos_s, d.position], axis=0)
                vel = jnp.concatenate([vel_s, d.velocity], axis=0)
                mass = jnp.concatenate([
                    jnp.full((N_s,), mass_s, jnp.float32),
                    jnp.where(inval, 0.0, d.mass),
                ])
                invalid = jnp.concatenate([jnp.zeros((N_s,), bool), inval])
                vnew = srd._collide(
                    pos, vel, c_abs, L_arr, cseed, mass=mass,
                    invalid=invalid, n_fill=N_s, mass_fill=mass_s,
                )
                d = d.replace(velocity=vnew[N_s:])
                return d, (pos_s, vnew[:N_s], c_abs)
        spec = self._grid_spec
        dt = integ.dt if integ is not None else 0.0
        seed = self.seed
        ctx = self._ctx()
        need_vel = any(getattr(f, "_needs_velocity_j", False) for f in forces)
        need_tag = any(getattr(f, "_needs_tag_j", False) for f in forces)
        need_quat = any(getattr(f, "_needs_quat_j", False) for f in forces)
        any_pair = any(getattr(f, "_needs_nlist", False) for f in forces)
        N_tags = self._state.N
        fields = self._fields
        # the tag->slot map is consumed only by bond forces; skip its
        # scatter in every rebuild when the system has no bonds
        need_slot_of = self._state.n_bonds > 0

        # Orthorhombic boxes take the maskless sentinel fast path: empty
        # slots are excluded from every pair purely by their far sentinel
        # coordinates (ops/dense._sentinel_x), so the hot loop carries no
        # validity masks and (for one particle type) no typeid roll.
        # Tilted boxes cannot bound the empty-empty distances after the
        # periodic roll shifts, so they keep explicit masks.
        tilted = bool(np.any(np.asarray(self._state.box.tilt) != 0.0))
        # the sentinel argument needs >= 3 cells per axis (preshifted rolls)
        # and an orthorhombic box (bounded roll shifts)
        masked = tilted or (spec is not None and not spec.newton_ok)
        need_typeid = masked or len(self._particle_types) > 1

        # Newton half-stencil: valid on grids with >= 3 cells per axis.
        # Every dense driver scatters both Newton sides (pair/DPD/aniso;
        # DPD noise is i<->j symmetric via sorted tags, aniso j-side gets
        # its own evaluator torque), so half is universal when newton_ok.
        use_half = spec is not None and spec.newton_ok

        def compute_all(dense, slot_of, t, tbls, want="all"):
            jb = (
                D.make_jblocks(
                    dense, spec, need_vel, need_tag, need_quat,
                    half=use_half, need_typeid=need_typeid,
                )
                if (spec is not None and any_pair)
                else None
            )
            results = []
            for f, tbl in zip(forces, tbls):
                results.append(
                    f._compute_dense(
                        dense, jb, spec, slot_of, t, ctx, tbl, want=want, masked=masked
                    )
                )
            return results

        # rotational integration needs the net torque carried alongside the
        # net force (VV step1 kicks angmom with last step's torques)
        need_torque = bool(
            integ is not None
            and integ.integrate_rotational_dof
            and any(getattr(f, "_produces_torque", False) for f in forces)
        )

        def compute_net(dense, slot_of, t, tbls):
            net = jnp.zeros((dense.position.shape[0], 3), jnp.float32)
            ntq = jnp.zeros_like(net) if need_torque else None
            for r in compute_all(dense, slot_of, t, tbls, want="force"):
                net = net + r.force
                if need_torque and r.torque is not None:
                    ntq = ntq + r.torque
            return net, ntq

        def _set_net(dense, net, ntq):
            if ntq is not None:
                return dense.replace(net_force=net, net_torque=ntq)
            return dense.replace(net_force=net)

        def apply_inline_updaters(d, t):
            # masked selects, not lax.cond: the compiled graph stays
            # conditional-free (see the rebin rationale below), and only
            # leaves the updater actually replaced pay a where — _update
            # returns state.replace(...), so untouched leaves keep object
            # identity
            for u in inline_updaters:
                fire = u.trigger(t)
                upd = u._update(d, t, seed)
                d = jax.tree_util.tree_map(
                    lambda new, old: old if new is old
                    else jnp.where(fire, new, old),
                    upd, d,
                )
            return d

        # The chunk is segmented: every segment REBINS UNCONDITIONALLY and
        # then runs up to `seg_len` steps that only *check* the Verlet
        # drift, OR-ing a violation flag into the carry. The host halves
        # seg_len and replays the chunk transactionally when the flag
        # fires (Simulation.run), exactly like capacity overflow.
        #
        # Rationale: the original design used
        # lax.cond(needs_rebin, rebin, identity) inside the step — the
        # semantically ideal form — but the accelerator compiler the
        # engine was first built for miscompiled data movement downstream
        # of such large-branch conditionals in while loops. With
        # unconditional segment rebins the compiled graph contains no
        # conditionals at all. Whether the gated per-step rebuild is
        # correct and faster on the GPU is an open item (ROADMAP 3.2).
        #
        # Rebuilds sit on the ABSOLUTE schedule t % seg_len == 0 (not
        # chunk-relative): the host aligns chunk boundaries to the
        # schedule (run()), so trajectories stay bitwise independent of
        # how run() calls are chunked. ``rebin_first`` is a static flag:
        # True for schedule-aligned chunks (every segment starts with a
        # rebuild), False for the partial continuation chunk right after
        # an unaligned stop (its rebuild already happened in the
        # previous chunk).
        mesh = self._spatial_mesh
        if mesh is not None and spec is not None:
            from .parallel.spatial import spatial_rebin as _spatial_rebin

            n_blocks = mesh.shape["d"]
            if (spec.dims[0] * spec.dims[1]) % n_blocks != 0:
                raise ValueError(
                    f"spatial decomposition needs Dx*Dy "
                    f"({spec.dims[0]}*{spec.dims[1]}) divisible by the "
                    f"mesh size ({n_blocks})"
                )
            mig = self._spatial_migrate_cap

            def do_rebin(d, mt):
                return _spatial_rebin(
                    d, mt, spec, N_tags, fields, need_slot_of,
                    mesh=mesh, migrate_cap=mig,
                )
        else:
            def do_rebin(d, mt):
                return D.rebin(d, mt, spec, N_tags, fields, need_slot_of)

        def run_chunk(dense, meta, t0, n_steps, seg_len, tbls,
                      rebin_first=True, solv=None):
            def step_body(j, carry):
                """One MD step at chunk-relative index j (t = t0 + j)."""
                d, mt, viol = carry
                t = t0 + j
                with jax.named_scope("integrate_step1"):
                    for m in methods:
                        d = m.step1(d, dt, t, seed)
                if spec is not None:
                    # the drift check against the rebuild-reference
                    # positions; the first step after a fresh rebuild
                    # cannot violate unless a particle crosses half the
                    # margin in one step
                    with jax.named_scope("verlet_drift_check"):
                        viol = viol | D.needs_rebin(d, mt, spec)
                with jax.named_scope("forces"):
                    net, ntq = compute_net(
                        d, mt.slot_of if spec is not None else None, t, tbls
                    )
                d = _set_net(d, net, ntq)
                with jax.named_scope("integrate_step2"):
                    for m in methods:
                        d = m.step2(d, dt, t, seed)
                with jax.named_scope("updaters"):
                    d = apply_inline_updaters(d, t)
                return d, mt, viol

            with_rebin = spec is not None and rebin_first

            def steps_span(carry, a, b):
                """Run chunk-relative steps [a, b).

                With rebuilds, ``a`` is always on the absolute rebuild
                schedule (the host aligns chunk starts and, in coupled
                mode, snaps the interval to divide the collision period
                so window boundaries stay schedule points).
                """
                if not with_rebin:
                    return jax.lax.fori_loop(a, b, step_body, carry)

                def seg_body(s, c):
                    d, mt, viol = c
                    start = a + s * seg_len
                    with jax.named_scope("rebin"):
                        d, mt = do_rebin(d, mt)
                    return jax.lax.fori_loop(
                        start, jnp.minimum(start + seg_len, b), step_body,
                        (d, mt, viol),
                    )

                n_segs = (b - a + seg_len - 1) // seg_len
                return jax.lax.fori_loop(0, n_segs, seg_body, carry)

            carry = (dense, meta, jnp.asarray(False))
            if joint_collide is None:
                dense, meta, viol = steps_span(carry, jnp.int32(0), n_steps)
                return dense, meta, viol

            # Coupled MPCD: window the chunk at the collision period.
            # Collisions land at absolute MD clocks divisible by P; the
            # k-th window runs steps up to its collision clock, then the
            # joint collision applies UNCONDITIONALLY (one evaluation per
            # period, not a masked evaluation per step). Any chunk
            # alignment works: the first window may be partial and the
            # tail (past the last collision) runs collision-free.
            P = jnp.int32(coupling.srd.period)
            first_c = (t0 // P + 1) * P  # first collision clock > t0
            n_col = jnp.maximum((t0 + n_steps - first_c) // P + 1, 0)

            def col_body(k, cc):
                d, mt, viol, solv = cc
                b = first_c - t0 + k * P  # chunk-relative collision point
                a = jnp.maximum(b - P, 0)
                d, mt, viol = steps_span((d, mt, viol), a, b)
                with jax.named_scope("mpcd_joint_collision"):
                    d, solv = joint_collide(d, solv, t0 + b)
                return d, mt, viol, solv

            dense, meta, viol, solv = jax.lax.fori_loop(
                0, n_col, col_body, (*carry, solv)
            )
            tail_a = jnp.clip(
                first_c - t0 + (n_col - 1) * P, 0, n_steps
            )
            dense, meta, viol = steps_span(
                (dense, meta, viol), tail_a, n_steps
            )
            return dense, meta, viol, solv

        self._run_chunk_impl = run_chunk
        self._compute_net = compute_net
        self._compute_net_jit = jax.jit(compute_net)
        self._compute_all = compute_all
        self._run_chunk_bound = None
        self._bound_fp = None
        self._single_force_jit = {}
        self._updater_jit = {}

    @staticmethod
    def _tables_fingerprint(tbls):
        return tuple(
            np.asarray(leaf).tobytes() for leaf in jax.tree_util.tree_leaves(tbls)
        )

    def _bind_tables(self, tbls):
        """Bake force parameter tables into the compiled chunk as constants.

        Passing the (tiny) per-type tables as traced jit arguments costs
        ~2x on the whole step at 64k particles (measured 14.3 -> 6.4
        ms/step): dynamic scalars block XLA's constant folding inside the
        stencil fusion. Tables change rarely (parameter updates between
        ``run()`` calls), so we recompile on change instead.
        """
        impl = self._run_chunk_impl
        const_tbls = jax.tree_util.tree_map(jnp.asarray, tbls)
        self._run_chunk_bound = jax.jit(
            lambda dense, meta, t0, n_steps, seg_len, rebin_first, solv: impl(
                dense, meta, t0, n_steps, seg_len, const_tbls,
                rebin_first=rebin_first, solv=solv,
            ),
            static_argnums=(5,),
        )
        self._bound_fp = self._tables_fingerprint(tbls)

    def _run_chunk(self, dense, meta, t0, n_steps, seg_len, tbls,
                   rebin_first=True, solv=None):
        fp = self._tables_fingerprint(tbls)
        if self._run_chunk_bound is None or fp != self._bound_fp:
            self._bind_tables(tbls)
        return self._run_chunk_bound(
            dense, meta, t0, n_steps, seg_len, rebin_first, solv
        )

    # -- dense layout management ---------------------------------------------
    def _identity_meta(self, state: State) -> D.GridMeta:
        n = state.N
        return D.GridMeta(
            ref_position=state.position,
            slot_of=jnp.arange(n, dtype=jnp.int32),
            overflow=jnp.asarray(False),
            n_builds=jnp.int32(0),
            max_occ=jnp.int32(0),
        )

    def _ensure_dense(self):
        if self._dense is not None:
            return
        state = self._synced_state()
        if self._grid_spec is None:
            self._dense = state
            self._meta = self._identity_meta(state)
            return
        self._dense, self._meta = _densify_jit(
            state, spec=self._grid_spec, fields=self._fields,
            need_slot_of=state.n_bonds > 0,
        )
        if bool(self._meta.overflow):
            self._grow_and_rebuild(int(self._meta.max_occ))
        self._place_spatial()

    def _place_spatial(self):
        """Shard the dense slot arrays into x-slabs over the spatial mesh."""
        if self._spatial_mesh is None or self._dense is None:
            return
        from .parallel.mesh import shard_state

        self._dense = shard_state(self._dense, self._spatial_mesh)
        from jax.sharding import NamedSharding, PartitionSpec as P

        m = self._spatial_mesh
        self._meta = self._meta.replace(
            ref_position=jax.device_put(
                self._meta.ref_position, NamedSharding(m, P("d"))
            ),
            slot_of=jax.device_put(
                self._meta.slot_of, NamedSharding(m, P())
            ),
        )
        # MPCD solvent: shard the particle axis over the same mesh (the
        # solvent is usually ~10x the solutes, so a replicated stream
        # would dominate per-device memory at scale). SRD's dataflow is
        # mesh-agnostic — streaming is elementwise, cell reductions are
        # one scatter-add that GSPMD partitions into local partial
        # scatters + an all-reduce across devices, and the per-particle gather
        # reads the (replicated) cell table locally. The cross-device
        # regrouping of the f32 cell sums is the ONLY divergence from the
        # single-device stream (DEVIATIONS.md) — within one collision it
        # is a ~1e-7 relative effect.
        if self._mpcd is not None:
            sh = NamedSharding(m, P("d"))
            N_s = self._mpcd["position"].shape[0]
            if N_s % m.devices.size == 0:
                for k in ("position", "velocity"):
                    self._mpcd[k] = jax.device_put(self._mpcd[k], sh)
                anchor = self._mpcd.get("_srd_anchor")
                if anchor is not None:
                    self._mpcd["_srd_anchor"] = (
                        jax.device_put(anchor[0], sh),
                        jax.device_put(anchor[1], sh),
                        anchor[2],
                    )

    def enable_spatial_decomposition(self, mesh, migrate_cap: int | None = None):
        """Distribute the simulation over ``mesh`` as spatial domains.

        The cell-major slot axis shards into contiguous blocks of whole
        z cell columns (SURVEY §2.12): whole x planes — classic slabs —
        when Dx divides the mesh size, sub-plane (x, y) strips otherwise
        (so more devices than x planes still decompose). Segment
        rebuilds run the block-local ppermute-migration rebin
        (parallel/spatial.py) instead of the global sort, and the force
        stencil's halo pads lower to collective permutes across block
        boundaries. Trajectories are bitwise identical to the
        single-device run (the spatial rebin reproduces the global slot
        layout exactly). The grid's (Dx, Dy) is snapped down to a
        mesh-commensurate product at creation (GridSpec.create
        strip_devices); an incommensurate existing grid is rebuilt at
        the next run.
        """
        self._spatial_mesh = mesh
        self._spatial_migrate_cap = migrate_cap
        if self._attached:
            n = int(mesh.shape["d"])
            if (
                self._grid_spec is not None
                and (self._grid_spec.dims[0] * self._grid_spec.dims[1]) % n
                != 0
            ):
                # regrid with the slab-aligned Dx at the next attach;
                # pull the current positions out of the dense arrays FIRST
                # (_drop_dense clears the stale flag, so dropping an
                # unsynced dense state would silently roll the trajectory
                # back to the last sync)
                self._synced_state()
                self._invalidate()
                self._drop_dense()
                return
            self._build_runner()
            self._place_spatial()

    @staticmethod
    def _max_occupancy_cap(state: State, spec: D.GridSpec, slack: int = 8) -> int:
        """Host-side exact max cell occupancy of a configuration -> cap."""
        pos = np.asarray(state.position)
        L = np.asarray(state.box.L)
        frac = pos / L + 0.5
        frac -= np.floor(frac)
        idx = [
            np.clip((frac[:, k] * spec.dims[k]).astype(np.int64), 0, spec.dims[k] - 1)
            for k in range(3)
        ]
        cid = (idx[0] * spec.dims[1] + idx[1]) * spec.dims[2] + idx[2]
        max_occ = int(np.bincount(cid, minlength=spec.n_cells).max())
        return int(math.ceil((max_occ + slack) / 8.0) * 8)

    def _interval_from_vmax(self, velocity, safety: float = 1.0) -> int | None:
        """Rebuild-interval estimate from the fastest particle.

        The Verlet margin is consumed at <= vmax*dt per step and the
        drift criterion is pairwise (max1 + max2 > buffer,
        ops/dense.needs_rebin), so the conservative per-particle margin
        is half the buffer. vmax is the full velocity norm — a component
        max would underestimate by sqrt(3). Returns None when no estimate
        exists (dt == 0 or a velocity-free state).
        """
        if self._grid_spec is None:
            return None
        vmax = float(jnp.sqrt(jnp.sum(velocity * velocity, axis=-1).max()))
        dt = self.dt_ref()
        if vmax <= 0 or dt <= 0:
            return None
        margin = 0.5 * self._grid_spec.buffer
        return max(1, min(50, int(margin / (vmax * dt * safety))))

    def tune_cell_capacity(self, slack: int = 0, safety: float = 1.0):
        """Right-size the cell capacity and rebuild interval.

        Pair work scales with cap^2, and transient overflow growth (e.g. a
        commensurate starting lattice concentrating particles in a few
        cells) can leave cap oversized after equilibration; likewise the
        melt transient can leave the rebuild interval halved far below
        what the equilibrated velocities require. Call after warmup, like
        HOOMD's neighbor-list tuning. Costs one recompile. (An explicit
        tune changes the rebuild schedule, so trajectories are
        chunking-reproducible between tunes, not across them.)

        ``slack`` defaults to 0 (cap = the 8-multiple above the measured
        max occupancy), which keeps the cap^2 pair work smallest; the
        choice of slack is not yet measured on the H100. The
        overflow risk a fluctuation carries is bounded by the post-tune
        gentle-regrow policy: the first grow after a tune adds one 8-slot
        quantum (back to the old slack-8 sizing at worst), not
        the 1.25x melt-time growth factor. One fluctuation therefore
        costs one recompile and lands exactly where the conservative
        default used to sit.
        """
        self._auto_tuned = True  # a manual tune supersedes the scheduled one
        if self._grid_spec is None or self._state is None:
            return
        state = self._synced_state()
        spec = self._grid_spec
        est = self._interval_from_vmax(state.velocity, safety)
        if est is not None:
            self._seg_len = est
            # the vmax-derived interval is also the best guess for the
            # adaptive ceiling: regrowth past it would just trigger a
            # violation replay
            self._seg_ceiling = est
            self._clean_quanta = 0
        cap = self._max_occupancy_cap(state, spec, slack)
        if cap != spec.cap:
            self._grid_spec = spec.replace(cap=cap)
            self._build_runner()
            self._drop_dense()
            self._prepared = False

    def profile(self, logdir: str):
        """``with sim.profile("/tmp/trace"): sim.run(n)`` — captures a
        ``jax.profiler`` trace (view with TensorBoard/XProf). Step phases
        appear as named scopes: rebin, integrate_step1,
        verlet_drift_check, forces, integrate_step2, updaters and
        mpcd_joint_collision (the analog of the reference's HOOMD
        Profiler push/pop phases,
        /root/reference/src/TwoStepLangevinFlow.h:110-111)."""
        import jax.profiler

        return jax.profiler.trace(str(logdir))

    def dt_ref(self) -> float:
        integ = self.operations.integrator
        return float(integ.dt) if integ is not None else 0.0

    def _grow_and_rebuild(self, needed: int = 0):
        """Grow slot capacity until the current configuration fits.

        ``needed`` is the failed chunk's recorded max cell occupancy
        (GridMeta.max_occ — exact, observed at every rebin of the chunk
        that overflowed). Before the post-warmup tune the new cap jumps
        STRAIGHT there (+ melt headroom): walking up geometrically costs
        one chunk recompile per 1.25x rung (a DPD melt once walked cap
        16->24->32->40). One sized jump replaces the walk.
        After a tune the cap sits one 8-slot quantum above the measured
        equilibrated max occupancy (slack 0), so an occupancy fluctuation
        needs exactly one more sublane: grow gently (+8), landing where
        the old conservative slack-8 default used to — not 1.25x past it.
        """
        state = self._synced_state()
        if not self._auto_tuned and needed > self._grid_spec.cap:
            # melt headroom: occupancy is still rising when the overflow
            # fires, so land one 8-slot quantum above the observed need
            cap = int(math.ceil((needed + 8) / 8.0) * 8)
            self._grid_spec = self._grid_spec.replace(cap=cap)
            self._build_runner()
            self._dense, self._meta = _densify_jit(
                state, spec=self._grid_spec, fields=self._fields,
                need_slot_of=state.n_bonds > 0,
            )
            if not bool(self._meta.overflow):
                self._place_spatial()
                return
        for _ in range(8):
            self._grid_spec = self._grid_spec.grow(gentle=self._auto_tuned)
            self._build_runner()
            self._dense, self._meta = _densify_jit(
                state, spec=self._grid_spec, fields=self._fields,
                need_slot_of=state.n_bonds > 0,
            )
            if not bool(self._meta.overflow):
                self._place_spatial()
                return
        raise RuntimeError("cell capacity growth did not converge")

    def _force_tables(self):
        for f in self._forces():
            f._refresh_tables(self)
        return tuple(f._device_tables() for f in self._forces())

    def _prepare(self):
        """Compute initial forces/accelerations (HOOMD's pre-run prep)."""
        self._ensure_dense()
        t = jnp.int32(self._timestep)
        slot_of = self._meta.slot_of if self._grid_spec is not None else None
        net, ntq = self._compute_net_jit(self._dense, slot_of, t, self._force_tables())
        accel = net / self._dense.mass[:, None]
        self._dense = self._dense.replace(net_force=net, acceleration=accel)
        if ntq is not None:
            self._dense = self._dense.replace(net_torque=ntq)
        self._state_stale = True
        self._prepared = True

    # -- running -------------------------------------------------------------
    def _updater_next_fire(self, t: int) -> int | None:
        from .write import _next_fire

        pts = []
        for u in self.operations.updaters:
            if getattr(u, "_inlined", False) or getattr(u, "_ingraph", False):
                continue  # applied inside the jitted step loop
            p = _next_fire(u.trigger, t)
            if p is None:
                # custom trigger callables are probed over a bounded window
                # (write._next_fire); an exhausted window means the updater
                # would silently never run — surface it instead
                import warnings

                warnings.warn(
                    f"updater {type(u).__name__}: trigger never fires within "
                    f"the {100_000}-step probe window starting at step {t}; "
                    "it will not be applied in this window. Provide a "
                    "next_fire(t) method on the trigger for exact host-side "
                    "scheduling.",
                    stacklevel=3,
                )
                continue
            pts.append(p)
        return min(pts) if pts else None

    def _fire_updaters(self, t: int):
        """Apply updaters whose trigger fires at step index ``t`` (host
        boundary: chunks are split so the step loop itself contains no
        trigger conditionals — see run_chunk)."""
        from .write import _next_fire

        for i, u in enumerate(self.operations.updaters):
            if getattr(u, "_inlined", False) or getattr(u, "_ingraph", False):
                continue  # applied inside the jitted step loop
            if _next_fire(u.trigger, t) != t:
                continue
            if getattr(u, "_updates_mpcd", False):
                # joint MD+solvent operation (mpcd.CollisionCoupling):
                # owns its own jit and writes both streams
                u._fire_mpcd(self, t)
                self._state_stale = True
                continue
            fn = self._updater_jit.get(i)
            if fn is None:
                fn = self._updater_jit[i] = jax.jit(
                    lambda dense, tt, u=u: u._update(dense, tt, self.seed)
                )
            self._dense = fn(self._dense, jnp.int32(t))
            self._state_stale = True

    def _ops_fingerprint(self):
        """Structural identity of the operation set bound into the runner.

        The compiled chunk closes over the integrator, its methods, and
        the force/updater lists; the tables fingerprint (_run_chunk)
        catches parameter-VALUE changes but not structural ones. HOOMD
        scripts reassign these routinely (equilibrate with Langevin,
        then production NVE), and a stale closure would silently keep
        integrating with the old scheme. Scalars are compared by value,
        nested objects (variants, filters, triggers) by identity —
        replace the object to change it.

        Returns ``(fp, refs)``: ``refs`` strongly references every object
        whose id() appears in ``fp``. The caller must keep ``refs`` alive
        for as long as it compares against ``fp`` — otherwise a freed
        object's address can be reused by a replacement and the stale
        closure survives the very check built to catch it.
        """
        refs = []

        def obj_fp(o):
            refs.append(o)
            items = []
            for k, v in sorted(vars(o).items()):
                if k.startswith("_") or k == "forces":
                    continue
                if isinstance(v, (int, float, bool, str, type(None))):
                    items.append((k, v))
                else:
                    refs.append(v)
                    items.append((k, type(v).__name__, id(v)))
            return (type(o).__name__, id(o), tuple(items))

        integ = self.operations.integrator
        if integ is None:
            return ("none",), ()
        refs.extend(integ.forces)
        refs.extend(self.operations.updaters)
        fp = (
            self.seed,  # baked into the step closure's RNG streams
            obj_fp(integ),
            tuple(obj_fp(m) for m in integ.methods),
            tuple((type(f).__name__, id(f)) for f in integ.forces),
            tuple((type(u).__name__, id(u)) for u in self.operations.updaters),
        )
        return fp, tuple(refs)

    def run(self, n_steps: int):
        from .write import _fire_writers, _writer_next_fire

        n_steps = int(n_steps)
        fp, fp_refs = self._ops_fingerprint()
        if getattr(self, "_ops_fp", None) != fp:
            # integrator/methods/forces/updaters changed since the last
            # bind: rebuild the runner against the new operation set
            self._ops_fp = fp
            self._ops_fp_refs = fp_refs  # pin ids in fp against reuse
            self._invalidate()
        if not self._attached:
            self._attach()
        if not self._prepared:
            self._prepare()
        writers = list(self.operations.writers)
        for w in writers:
            w._attach(self)
        # computes are pull-path observables (no step-loop state), so a
        # compute appended after the first run() attaches here instead of
        # forcing a fingerprint rebuild
        for c in self.operations.computes:
            c._attach(self)
        remaining = n_steps
        tbls = self._force_tables()
        while remaining > 0:
            # scheduled post-warmup retune (see auto_tune_after): fires the
            # first time the ABSOLUTE timestep reaches the threshold, so the
            # tune point — and therefore the rebuild schedule and slot
            # layout after it — is a pure function of the trajectory,
            # independent of how run() calls are chunked
            auto_pending = (
                not self._auto_tuned and self.auto_tune_after is not None
            )
            if auto_pending and self._timestep >= self.auto_tune_after:
                self.tune_cell_capacity()
                if not self._prepared:
                    self._prepare()
                auto_pending = False
            chunk = min(remaining, self.max_chunk)
            if auto_pending:
                # split the chunk at the tune point
                chunk = min(chunk, self.auto_tune_after - self._timestep)
            if writers:
                # split the jitted chunk at the next writer trigger so the
                # host syncs exactly once per fire
                nw = _writer_next_fire(writers, self._timestep + 1)
                if nw is not None and nw - self._timestep < chunk:
                    chunk = nw - self._timestep
            # split at the next updater trigger: updaters apply between
            # chunks (step loop carries no conditionals)
            nu = self._updater_next_fire(self._timestep)
            if nu is not None and nu - self._timestep + 1 < chunk:
                chunk = nu - self._timestep + 1
            # while the rebuild interval is still adapting, split chunks at
            # absolute quantum boundaries so interval changes land at the
            # same timestep regardless of run() chunking (bitwise
            # chunking-invariance contract, tests/test_pair_dpd.py); once
            # converged (seg == ceiling == max) chunks run unsplit
            if self._seg_adapt and (
                self._seg_len < self._seg_ceiling or self._seg_ceiling < 50
            ):
                chunk = min(
                    chunk,
                    _GROW_QUANTUM - self._timestep % _GROW_QUANTUM,
                )
            # align to the absolute rebuild schedule (t % seg_len == 0) so
            # rebuild times are independent of run() chunking: an
            # unaligned start runs a no-rebuild continuation chunk up to
            # the next schedule point
            coup = getattr(self, "_coupling_ingraph", None)
            seg_base = self._seg_len
            if coup is not None:
                # in-graph collision windows are schedule points: snap
                # the rebuild interval down to a divisor of the collision
                # period so every window boundary stays rebuild-aligned
                # (a deterministic function of the adaptive state, so the
                # chunking-invariance contract holds)
                P = coup.srd.period
                while P % seg_base != 0:
                    seg_base -= 1
                if seg_base * 2 <= self._seg_len and not getattr(
                    self, "_warned_divisor_collapse", False
                ):
                    # a period with no divisor near the adapted interval
                    # (e.g. a prime period) silently snaps to a tiny
                    # divisor — per-step or near-per-step rebuilds, a
                    # large invisible performance cliff. Surface it once.
                    import warnings

                    self._warned_divisor_collapse = True
                    warnings.warn(
                        f"in-graph MPCD coupling: collision period {P} has "
                        f"no divisor near the adapted rebuild interval "
                        f"{self._seg_len}, so rebuilds snap to every "
                        f"{seg_base} step(s). Choose a collision period "
                        "with divisors near the natural rebuild interval "
                        "(or a composite period) to avoid the extra "
                        "rebuild cost.",
                        stacklevel=2,
                    )
            off = self._timestep % seg_base
            rebin_first = off == 0
            if off:
                chunk = min(chunk, seg_base - off)
            seg_arg = seg_base
            if off and self._realign:
                # post-violation realignment prefix: rebuild every step
                # until the timestep reaches the halved schedule
                seg_arg = 1
                rebin_first = True
            elif not off:
                self._realign = False
            solv = None
            if coup is not None:
                anchor = self._mpcd.get("_srd_anchor")
                if anchor is None:
                    anchor = (
                        self._mpcd["position"], self._mpcd["velocity"],
                        jnp.int32(self._timestep),
                    )
                solv = (anchor[0], anchor[1], jnp.int32(anchor[2]))
            backup_dense, backup_meta = self._dense, self._meta
            t0 = jnp.int32(self._timestep)
            out = self._run_chunk(
                backup_dense, backup_meta, t0, jnp.int32(chunk),
                jnp.int32(seg_arg), tbls, rebin_first, solv
            )
            if coup is not None:
                dense, meta, violated, solv_out = out
            else:
                dense, meta, violated = out
            if self._grid_spec is not None and bool(meta.overflow):
                # transactional replay with grown capacity, sized by the
                # failed chunk's recorded max occupancy
                needed = int(meta.max_occ)
                if not bool(jnp.isfinite(dense.position).all()):
                    # Diverged trajectories (overlapping initial contacts,
                    # too-large dt) produce non-finite positions; the rebin
                    # then piles every particle into one cell and the
                    # "needed" capacity explodes toward N, which can only
                    # end in an unintelligible compiler OOM. Fail loudly at
                    # the first overflow instead (the failure-detection
                    # analog of HOOMD's particle-out-of-bounds error).
                    raise RuntimeError(
                        "simulation diverged: non-finite particle positions "
                        f"at timestep ~{self._timestep} (cell overflow "
                        f"requested capacity {needed}). Typical causes: "
                        "overlapping initial coordinates, dt too large, or "
                        "a potential evaluated inside its divergence."
                    )
                self._dense, self._meta = backup_dense, backup_meta
                self._state_stale = True
                self._synced_state()
                self._grow_and_rebuild(needed)
                tbls = self._force_tables()
                continue
            if bool(violated):
                if seg_arg > 1:
                    # a particle out-drifted the Verlet margin inside a
                    # segment: re-derive the interval from the CURRENT
                    # peak speed (the same estimator the post-warmup tune
                    # uses) and replay. The old policy (halve + pin the
                    # ceiling at seg_len - 1 with 10-quanta relaxation)
                    # let one transient violation trap DPD's interval
                    # well below its optimum for thousands of steps.
                    # The estimate reads the restored
                    # trajectory state at an absolute schedule point, so
                    # bitwise chunking-invariance holds. seg_len == 1
                    # rebuilds every step and is always valid.
                    #
                    # The violation path uses safety 1.5: a violation is
                    # direct evidence the instantaneous-vmax estimate was
                    # optimistic HERE (evolving systems — a compressing
                    # droplet, a relaxing melt — accelerate between the
                    # measurement and the drift). With safety 1.0 the
                    # replay lands at est ~ seg_len and shrinks by 1 per
                    # violation: a slow -1 walk paying a full chunk
                    # replay per rung, which once doubled the
                    # droplet/polymer step cost. The optimistic est still sets
                    # the regrowth ceiling, so steady-state systems (DPD)
                    # climb back to their true optimum within quanta.
                    est = self._interval_from_vmax(
                        backup_dense.velocity, safety=1.5
                    )
                    est_opt = self._interval_from_vmax(backup_dense.velocity)
                    if est is None:
                        est = max(self._seg_len // 2, 1)
                        est_opt = est
                    new_seg = max(1, min(self._seg_len - 1, est))
                    self._seg_ceiling = max(new_seg, min(est_opt, 50))
                    self._clean_quanta = 0
                    self._dense, self._meta = backup_dense, backup_meta
                    self._seg_len = new_seg
                    self._realign = True
                    self._viol_replays = getattr(self, "_viol_replays", 0) + 1
                    continue
                # seg_len == 1: a particle crossed more than the full
                # buffer in ONE step; forces this chunk may have used a
                # one-step-stale list. Accept but warn (HOOMD's
                # "dangerous build" condition).
                import warnings

                self._dangerous_builds = getattr(self, "_dangerous_builds", 0) + 1
                warnings.warn(
                    "dangerous neighbor rebuild: a particle moved more than "
                    "the Verlet buffer in a single step; increase the nlist "
                    "buffer or reduce dt",
                    stacklevel=2,
                )
            self._dense, self._meta = dense, meta
            self._state_stale = True
            self._timestep += chunk
            remaining -= chunk
            if coup is not None:
                # the joint collisions ran in-graph: adopt the returned
                # solvent anchor (replays recompute from the untouched
                # _mpcd, so rollback is automatic); _advance below only
                # streams the observable state (coupled SRD skips
                # collisions)
                pos_a, vel_a, t_a = solv_out
                self._mpcd = {
                    **self._mpcd,
                    "position": pos_a,
                    "velocity": vel_a,
                    "_srd_anchor": (pos_a, vel_a, t_a),
                }
            if self._mpcd is not None and self.mpcd_dynamics is not None:
                # advance the solvent stream over the ACCEPTED chunk only
                # (replays must not double-advance; collisions key on the
                # absolute timestep, so this is chunking-invariant)
                self._mpcd = self.mpcd_dynamics._advance(
                    self._mpcd, self._state.box,
                    self._timestep - chunk, self._timestep, self.seed,
                )
            # adaptive regrowth at absolute quantum boundaries (so the
            # schedule is a pure function of timestep, not chunking): each
            # clean quantum earns +1 on the rebuild interval (seg_len is a
            # traced argument — no recompile); after 10 clean quanta at the
            # ceiling, the ceiling itself relaxes by 1
            if self._seg_adapt and self._timestep % _GROW_QUANTUM == 0:
                self._clean_quanta += 1
                if self._seg_len < self._seg_ceiling:
                    self._seg_len += 1
                elif (
                    self._seg_ceiling < 50
                    and self._clean_quanta % 10 == 0
                ):
                    self._seg_ceiling += 1
                    self._seg_len = min(self._seg_len + 1, self._seg_ceiling)
            self._fire_updaters(self._timestep - 1)
            if writers:
                _fire_writers(self, writers, self._timestep)
        jax.block_until_ready(self._dense.position)

    # -- observables -----------------------------------------------------------
    def _compute_single_force(self, force) -> ForceResult:
        if not self._attached:
            self._attach()
        if not self._prepared:
            self._prepare()
        forces = self._forces()
        i = forces.index(force)
        tbls = self._force_tables()
        slot_of = self._meta.slot_of if self._grid_spec is not None else None
        N = self._state.N
        tag_order = self._grid_spec is None

        def calc(dense, slot_of, t, tbls):
            r = self._compute_all(dense, slot_of, t, tbls)[i]
            if tag_order:
                return r
            # map slot-order result back to tag order
            dest = jnp.where(dense.tag >= 0, dense.tag, N)

            def back(x):
                if x is None:
                    return None
                if x.ndim == 1:
                    return jnp.zeros((N + 1,), x.dtype).at[dest].set(x, mode="drop")[:N]
                return jnp.zeros((N + 1, x.shape[1]), x.dtype).at[dest].set(
                    x, mode="drop"
                )[:N]

            return ForceResult(
                force=back(r.force),
                energy=back(r.energy),
                virial=back(r.virial),
                torque=back(r.torque),
            )

        fn = self._single_force_jit.get(i)
        if fn is None:
            fn = self._single_force_jit[i] = jax.jit(calc)
        return fn(self._dense, slot_of, jnp.int32(self._timestep), tbls)
