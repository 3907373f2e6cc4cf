"""MPCD-SRD solvent dynamics: ballistic streaming + stochastic rotation.

The reference plugin only READS an MPCD particle stream — HOOMD's mpcd
package generates it (DEVIATIONS.md §7-MPCD,
/root/reference/src/VelocityFieldCompute.h:331-352). A user switching
engines needs the generator too, so this module implements the standard
multi-particle collision dynamics solvent (Malevanets & Kapral 1999):

* **Streaming** is ballistic between collision events, so the solvent
  advances in one fused jump per interval (x += v dt; with a body force,
  the exact piecewise-quadratic update). No per-step loop.
* **Collisions** (stochastic rotation dynamics) happen at absolute
  timesteps divisible by ``period`` — a pure function of the timestep,
  so trajectories are independent of run() chunking and bitwise
  reproducible across checkpoint restarts (counter-based RNG keyed on
  the collision timestep).
* **Cell binning** is one fused scatter-add of every per-cell sum
  (count, mass, momentum, m v^2) keyed on the shifted cell id.
* **Galilean invariance** via the standard random grid shift per
  collision (Ihle & Kroll 2001).
* Optional cell-level velocity-rescale thermostat to ``kT`` (the
  sampling-free analog of HOOMD's MBS thermostat; without it SRD
  conserves energy exactly and heats only through the body force).

By default the solvent does not couple to MD solutes (the reference's
read-only boundary); observables (VelocityCompute / VelocityFieldCompute
with ``include_mpcd_particles=True``) read the advanced stream. Opt-in
momentum exchange with MD particles is provided by
:class:`CollisionCoupling`.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["SRD", "CollisionCoupling"]


def _rotate(v, axis, cos_a, sin_a):
    """Rodrigues rotation of rows of v around unit rows of axis."""
    dot = jnp.sum(v * axis, axis=1, keepdims=True)
    cross = jnp.cross(axis, v)
    return v * cos_a + cross * sin_a + axis * dot * (1.0 - cos_a)


class SRD:
    """Stochastic rotation dynamics for the MPCD solvent stream.

    Parameters
    ----------
    dt : float
        MD timestep (streaming time per MD step); collisions occur every
        ``period`` MD steps, i.e. the MPCD collision time is period*dt.
    period : int
        MD steps between collision events (HOOMD mpcd convention).
    angle : float
        Rotation angle in degrees (130 is the common choice).
    cell_size : float
        Collision cell edge; every box edge must be an (approximate)
        integer multiple.
    kT : float or None
        Cell-level velocity-rescale thermostat target; None = micro-
        canonical SRD (energy conserved exactly). Required with
        ``plates``: the no-slip virtual-particle fill samples phantom
        wall momenta at kT, which makes the walls a thermal boundary.
    body_force : 3-sequence or None
        Constant acceleration (force per unit mass) applied during
        streaming — e.g. a pressure-gradient driving field.
    shift : bool
        Random collision-grid shift (Galilean invariance). On by default.
    """

    def __init__(self, dt, period=1, angle=130.0, cell_size=1.0, kT=None,
                 body_force=None, shift=True, plates=None):
        self.dt = float(dt)
        self.period = int(period)
        self.angle = float(angle)
        self.cell_size = float(cell_size)
        self.kT = None if kT is None else float(kT)
        self.body_force = (
            None if body_force is None else tuple(float(f) for f in body_force)
        )
        self.shift = bool(shift)
        self._coupled = False  # set by CollisionCoupling
        # plates=(axis, H): no-slip bounce-back walls at +-H/2 along the
        # axis ('x'|'y'|'z') — the parallel-plate (slit) geometry of
        # HOOMD's mpcd streaming. Streaming then substeps at dt with one
        # bounce per substep (thermal |v|*dt << H).
        if plates is not None:
            axis, H = plates
            axis = {"x": 0, "y": 1, "z": 2}.get(axis, axis)
            self.plates = (int(axis), float(H))
            if self.body_force is not None and self.body_force[int(axis)]:
                raise ValueError(
                    "body force must be tangential to the plates"
                )
            if self.kT is None:
                raise ValueError(
                    "plates require kT: the no-slip virtual-particle "
                    "fill samples phantom wall momenta at kT (the walls "
                    "are a thermal boundary, not microcanonical)"
                )
        else:
            self.plates = None
        self._advance_jit = None
        self._dims = None
        self._built_key = None  # (L, seed) the advance closure was built for

    # -- wiring ------------------------------------------------------------
    def _validate(self, box):
        tilt = [float(t) for t in box.tilt]
        if any(abs(t) > 1e-12 for t in tilt):
            raise ValueError("MPCD-SRD supports orthorhombic boxes only")
        dims = []
        for L in (float(box.L[0]), float(box.L[1]), float(box.L[2])):
            n = L / self.cell_size
            if abs(n - round(n)) > 1e-4:
                raise ValueError(
                    f"box edge {L} is not a multiple of cell_size "
                    f"{self.cell_size}"
                )
            dims.append(max(1, int(round(n))))
        self._dims = tuple(dims)

    def _grid_dims(self):
        """Collision-grid cell counts, per axis.

        The wall axis (plates) is NOT periodic: with a grid shift the
        topmost layer must bin into an extra boundary cell, never wrap
        across the seam into the bottom layer — a wrapped seam cell
        would rotate momentum THROUGH the plates. The shifted grid
        along that axis has D+1 cells spanning [-L/2 - s, L/2 + a - s).
        """
        dims_l = list(self._dims)
        if self.plates is not None:
            dims_l[self.plates[0]] += 1
        return dims_l

    def _cell_ids(self, pos, shift):
        """Bin positions into collision cells under a grid shift.

        Periodic axes wrap; the plates axis (if any) bins unwrapped
        into the extended grid (see _grid_dims).
        """
        Dx, Dy, Dz = self._grid_dims()
        a = jnp.float32(self.cell_size)
        # cell units from the box corner; wrap the periodic axes only
        dims0 = jnp.asarray(self._dims, jnp.float32)
        su = pos / a + shift / a + dims0 * 0.5
        su_wrapped = su - jnp.floor(su / dims0) * dims0
        if self.plates is not None:
            wall_ax = self.plates[0]
            su_wrapped = su_wrapped.at[:, wall_ax].set(su[:, wall_ax])
        dims = jnp.asarray([Dx, Dy, Dz], jnp.int32)
        idx = jnp.clip(jnp.floor(su_wrapped).astype(jnp.int32), 0, dims - 1)
        return (idx[:, 0] * Dy + idx[:, 1]) * Dz + idx[:, 2]

    # -- physics -----------------------------------------------------------
    def _stream(self, pos, vel, n_steps, L):
        """Ballistic jump over n_steps MD steps (exact under constant f).

        With plates, substeps at dt with single-bounce no-slip
        reflection per substep (full velocity reversal at the wall).
        """
        if self.plates is None:
            t = n_steps.astype(jnp.float32) * jnp.float32(self.dt)
            if self.body_force is not None:
                f = jnp.asarray(self.body_force, jnp.float32)
                pos = pos + vel * t[..., None] + 0.5 * f * t[..., None] ** 2
                vel = vel + f * t[..., None]
            else:
                pos = pos + vel * t[..., None]
            pos = pos - jnp.round(pos / L) * L  # wrap (orthorhombic)
            return pos, vel

        ax, H = self.plates
        dt = jnp.float32(self.dt)
        half = jnp.float32(H / 2.0)
        f = jnp.asarray(
            self.body_force or (0.0, 0.0, 0.0), jnp.float32
        )  # f[ax] == 0 (validated)
        wrap_mask = jnp.asarray(
            [1.0 if k != ax else 0.0 for k in range(3)], jnp.float32
        )

        def substep(_, carry):
            pos, vel = carry
            new = pos + vel * dt + 0.5 * f * dt * dt
            w = new[:, ax]
            crossed = jnp.abs(w) > half
            zw = jnp.sign(w) * half
            vz = vel[:, ax]
            # wall-normal motion is force-free: exact hit time
            t_hit = jnp.where(
                jnp.abs(vz) > 1e-12, (zw - pos[:, ax]) / jnp.where(
                    jnp.abs(vz) > 1e-12, vz, 1.0
                ), 0.0,
            )
            t_hit = jnp.clip(t_hit, 0.0, dt)
            tau = dt - t_hit
            v_hit = vel + f * t_hit[:, None]  # velocity at the wall
            x_hit = pos + vel * t_hit[:, None] + 0.5 * f * t_hit[:, None] ** 2
            # no-slip bounce-back: full reversal, then stream the rest
            v_b = -v_hit
            x_b = x_hit + v_b * tau[:, None] + 0.5 * f * tau[:, None] ** 2
            v_b = v_b + f * tau[:, None]
            v_free = vel + f * dt
            pos = jnp.where(crossed[:, None], x_b, new)
            vel = jnp.where(crossed[:, None], v_b, v_free)
            # wrap the periodic (in-plane) axes only
            pos = pos - jnp.round(pos / L) * L * wrap_mask
            return pos, vel

        return jax.lax.fori_loop(0, n_steps, substep, (pos, vel))

    def _collide(self, pos, vel, t_col, L, seed, mass=None, invalid=None,
                 n_fill=None, mass_fill=1.0):
        """One SRD collision at absolute timestep t_col.

        ``mass``/``invalid`` generalize to mixed streams (collisional
        coupling of MD solutes, Malevanets & Kapral 1999): cell averages
        are mass-weighted and ``invalid`` rows (empty MD slots) are
        binned to a trash cell and returned unchanged. ``n_fill`` /
        ``mass_fill`` set the virtual-fill density from the SOLVENT
        count when the arrays also carry solutes.
        """
        N = pos.shape[0]
        dims_l = self._grid_dims()
        Dx, Dy, Dz = dims_l
        C = Dx * Dy * Dz
        a = jnp.float32(self.cell_size)
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.key(seed), jnp.uint32(0x6D70)),
            t_col.astype(jnp.uint32),
        )
        kshift, kaxis, kvirt = jax.random.split(key, 3)

        shift = (
            jax.random.uniform(kshift, (3,), jnp.float32) * a
            if self.shift
            else jnp.zeros((3,), jnp.float32)
        )
        cid = self._cell_ids(pos, shift)
        if invalid is not None:
            cid = jnp.where(invalid, C, cid)  # trash cell, excluded below
        m = (
            jnp.ones((N,), jnp.float32)
            if mass is None
            else mass.astype(jnp.float32)
        )

        # one fused scatter-add produces every per-cell reduction at once:
        # (count, mass, momentum xyz, m v^2). On the CPU XLA lowers it
        # deterministically; on the GPU duplicate indices lower to
        # atomics, so the f32 cell sums (and the collision) are
        # reproducible run to run only to rounding (DEVIATIONS.md §14).
        mv = vel * m[:, None]
        mv2 = jnp.sum(vel * mv, axis=1)
        pay = jnp.concatenate(
            [jnp.ones((N, 1), jnp.float32), m[:, None], mv, mv2[:, None]],
            axis=1,
        )
        sums = jnp.zeros((C + 1, 6), jnp.float32).at[cid].add(pay)
        cnt = sums[:C, 0]  # [C] real count
        msum = sums[:C, 1]
        vsum = sums[:C, 2:5]
        sum_mv2 = sums[:C, 5]
        vsum_real = vsum

        # virtual-particle fill of wall-clipped cells (no-slip): the part
        # of a collision cell beyond the plates is filled with phantom
        # solvent at rest (Lamura et al. 2001) — its sampled momentum
        # ~ Normal(0, Nv kT) joins the cell average, dragging u toward
        # zero at the wall. Bulk cells get Nv = 0 exactly.
        n_virt = jnp.zeros((C,), jnp.float32)
        if self.plates is not None:
            pax, H = self.plates
            a_f = jnp.float32(self.cell_size)
            D_ax = dims_l[pax]  # extended: D+1 shifted cells on the wall axis
            Lax = L[pax]
            iax = jnp.arange(D_ax, dtype=jnp.float32)
            lo = iax * a_f - Lax / 2.0 - shift[pax]
            hi = lo + a_f
            inside = jnp.clip(
                jnp.minimum(hi, jnp.float32(H / 2.0))
                - jnp.maximum(lo, jnp.float32(-H / 2.0)),
                0.0, a_f,
            )
            # mean fill of a FULL cell at the confined SOLVENT density
            rho_cell = jnp.float32(n_fill if n_fill is not None else N) * (
                a_f**3
            ) / (jnp.prod(L) * jnp.float32(H) / Lax)
            nv_ax = rho_cell * (1.0 - inside / a_f)  # [D_ax]
            allc = jnp.arange(C, dtype=jnp.int32)
            if pax == 2:
                idx_ax = allc % Dz
            elif pax == 1:
                idx_ax = (allc // Dz) % Dy
            else:
                idx_ax = allc // (Dy * Dz)
            n_virt = jnp.take(nv_ax, idx_ax)
            kT_v = jnp.float32(self.kT)  # required with plates (__init__)
            mf = jnp.float32(mass_fill)
            pv = jax.random.normal(kvirt, (C, 3), jnp.float32) * jnp.sqrt(
                jnp.maximum(n_virt, 0.0) * kT_v * mf
            )[:, None]
            vsum = vsum + pv
            n_virt = n_virt * mf  # below, n_virt joins the MASS sum

        u = vsum / jnp.maximum(msum + n_virt, 1e-12)[:, None]  # [C, 3] COM

        # per-cell random unit axis; same key regardless of occupancy
        axis = jax.random.normal(kaxis, (C, 3), jnp.float32)
        axis = axis / jnp.maximum(
            jnp.linalg.norm(axis, axis=1, keepdims=True), 1e-12
        )

        cols = [u, axis]
        if self.kT is not None:
            # cell-level rescale to the relative-DOF equipartition value:
            # <K_rel> = 3/2 (n_c - 1) kT (COM motion carries no thermal
            # DOF). Relative KE of the REAL particles about u — the
            # general form (with virtual fill or mixed masses, u is not
            # their momentum mean):
            # sum m|v-u|^2 = sum m v^2 - 2 (sum m v).u + (sum m) |u|^2
            k_rel = 0.5 * (
                sum_mv2
                - 2.0 * jnp.sum(vsum_real * u, axis=1)
                + msum * jnp.sum(u * u, axis=1)
            )
            target = 1.5 * jnp.maximum(cnt - 1.0, 0.0) * jnp.float32(self.kT)
            scale = jnp.sqrt(
                jnp.where(k_rel > 1e-12, target / jnp.maximum(k_rel, 1e-12), 1.0)
            )
            scale = jnp.where(cnt > 1.5, scale, 1.0)
            cols.append(scale[:, None])

        # ONE fused per-particle gather of every per-cell quantity: gather
        # cost scales with rows, not columns. The
        # appended row C is the trash cell: invalid rows gather zeros and
        # are overwritten below.
        table = jnp.concatenate(cols, axis=1)
        table = jnp.concatenate(
            [table, jnp.zeros((1, table.shape[1]), jnp.float32)], axis=0
        )
        g = jnp.take(table, cid, axis=0)
        u_i, ax_i = g[:, 0:3], g[:, 3:6]
        vrel = vel - u_i
        cos_a = jnp.float32(math.cos(math.radians(self.angle)))
        sin_a = jnp.float32(math.sin(math.radians(self.angle)))
        vrel = _rotate(vrel, ax_i, cos_a, sin_a)
        if self.kT is not None:
            vrel = vrel * g[:, 6:7]

        vnew = u_i + vrel
        if invalid is not None:
            # trash-binned rows (empty MD slots) come back untouched
            vnew = jnp.where(invalid[:, None], vel, vnew)
        return vnew

    @staticmethod
    def _box_key(box, seed):
        return (float(box.L[0]), float(box.L[1]), float(box.L[2]), int(seed))

    def _build(self, box, seed):
        self._validate(box)
        self._built_key = self._box_key(box, seed)
        L = jnp.asarray(
            [float(box.L[0]), float(box.L[1]), float(box.L[2])], jnp.float32
        )
        period = self.period

        coupled = self._coupled

        def advance(pos_a, vel_a, t_a, t1):
            """Advance the anchored stream to absolute MD timestep t1.

            The state is ANCHORED at the last collision (or the stream
            start): positions between collisions are always evaluated in
            ONE jump from the anchor, never in chunk-sized pieces — f32
            addition is not associative, and per-chunk partial streaming
            would make trajectories depend on how run() was chunked.
            """
            # collision events at t % period == 0 within (t_a, t1]; in
            # coupled mode the CollisionCoupling updater owns every
            # collision (jointly with the MD solutes), and this hook only
            # streams + evaluates the observable state
            first = (t_a // period + 1) * period
            n_events = (
                jnp.int32(0)
                if coupled
                else jnp.maximum((t1 - first) // period + 1, 0)
            )

            def body(_, carry):
                pos_a, vel_a, t_a = carry
                t_next = (t_a // period + 1) * period
                pos, vel = self._stream(pos_a, vel_a, t_next - t_a, L)
                vel = self._collide(pos, vel, t_next, L, seed)
                return pos, vel, t_next

            pos_a, vel_a, t_a = jax.lax.fori_loop(
                0, n_events, body, (pos_a, vel_a, t_a)
            )
            # evaluate the observable state at t1 WITHOUT moving the anchor
            pos, vel = self._stream(pos_a, vel_a, t1 - t_a, L)
            return pos, vel, pos_a, vel_a, t_a

        self._advance_jit = jax.jit(advance)

    def _advance(self, mpcd: dict, box, t0: int, t1: int, seed: int) -> dict:
        if t1 <= t0 or mpcd is None:
            return mpcd
        if self._advance_jit is None or self._built_key != self._box_key(
            box, seed
        ):
            # rebuild on box/seed change (e.g. set_snapshot with a new
            # box): the closure bakes L and the cell dims in
            self._build(box, seed)
        anchor = mpcd.get("_srd_anchor")
        if anchor is None:
            # fresh stream (or checkpoint restart): anchor here. A restart
            # at a non-collision-aligned timestep re-anchors and differs
            # from the continuous run only by f32 addition order.
            anchor = (mpcd["position"], mpcd["velocity"], jnp.int32(t0))
        pos, vel, pos_a, vel_a, t_a = self._advance_jit(
            anchor[0], anchor[1], anchor[2], jnp.int32(t1)
        )
        out = dict(mpcd)
        out["position"] = pos
        out["velocity"] = vel
        out["_srd_anchor"] = (pos_a, vel_a, t_a)
        return out


class CollisionCoupling:
    """Embed the MD solutes in the SRD collisions (collisional coupling,
    Malevanets & Kapral 1999) — momentum exchanges between solvent and
    solutes, giving the solutes hydrodynamic drag, advection, and a
    thermal bath, without any explicit solvent-solute pair potential.

    Registers as an updater. With the default trigger the joint collision
    runs INSIDE the jitted step loop: Simulation windows the chunk at the
    collision period and applies the collision unconditionally at each
    window boundary — one collision evaluation per period, no host chunk
    splits (no per-firing dispatch + blocking sync, as for the other
    device-pure updaters). Replacing the trigger with a
    custom schedule falls back to host-boundary firing between chunks.

        srd = az.mpcd.SRD(dt=dt, period=20, cell_size=1.0, kT=1.0)
        sim.mpcd_dynamics = srd
        sim.operations.updaters.append(az.mpcd.CollisionCoupling(srd))

    Cell averages become mass-weighted over solvent + real MD particles;
    both streams' relative velocities rotate. This EXCEEDS the reference
    plugin's boundary (it only reads the solvent), matching what HOOMD's
    own mpcd module provides for embedded particles.
    """

    _updates_mpcd = True

    def __init__(self, srd: SRD):
        from .md.trigger import Periodic

        self.srd = srd
        # a trigger at step t fires AFTER step t completes (MD clock
        # t+1), so phase period-1 lands the joint collision at MD clock
        # multiples of the period — solvent and solutes collide at the
        # SAME time
        self.trigger = Periodic(srd.period, phase=srd.period - 1)
        srd._coupled = True
        srd._advance_jit = None  # the advance closure reads the flag
        self._fire_jit = None
        self._fire_key = None
        self._attached = False

    def _attach(self, sim):
        if sim._mpcd is None:
            raise ValueError(
                "CollisionCoupling needs an MPCD stream in the snapshot "
                "(Snapshot(mpcd_N=...))"
            )
        if sim.mpcd_dynamics is not self.srd:
            raise ValueError(
                "set sim.mpcd_dynamics to the same SRD object the "
                "CollisionCoupling wraps"
            )
        self._attached = True

    def _fire_mpcd(self, sim, t: int):
        """Joint collision after step ``t`` completes (host boundary).

        The run loop hands updaters the completed step index t; the MD
        dense state is at clock t+1, so the solvent streams to t+1 and
        the joint collision keys on t+1 — both streams at the same time.
        """
        srd = self.srd
        box = sim._state.box
        tc = t + 1  # MD clock of the dense state at this host boundary
        if srd._advance_jit is None or srd._built_key != srd._box_key(
            box, sim.seed
        ):
            srd._build(box, sim.seed)
        mpcd = sim._mpcd
        anchor = mpcd.get("_srd_anchor") or (
            mpcd["position"], mpcd["velocity"], jnp.int32(tc),
        )
        fire_key = (srd._box_key(box, sim.seed), float(mpcd["mass"]))
        if self._fire_jit is None or self._fire_key != fire_key:
            self._fire_key = fire_key
            L = jnp.asarray(
                [float(box.L[0]), float(box.L[1]), float(box.L[2])],
                jnp.float32,
            )
            mass_s = float(mpcd["mass"])
            seed = sim.seed

            @jax.jit
            def fire(pos_a, vel_a, t_a, t, dpos, dvel, dmass, dtag):
                pos_s, vel_s = srd._stream(pos_a, vel_a, t - t_a, L)
                N_s = pos_s.shape[0]
                inval_m = dtag < 0
                pos = jnp.concatenate([pos_s, dpos], axis=0)
                vel = jnp.concatenate([vel_s, dvel], axis=0)
                mass = jnp.concatenate(
                    [jnp.full((N_s,), mass_s, jnp.float32),
                     jnp.where(inval_m, 0.0, dmass)]
                )
                invalid = jnp.concatenate(
                    [jnp.zeros((N_s,), bool), inval_m]
                )
                vnew = srd._collide(
                    pos, vel, t, L, seed, mass=mass, invalid=invalid,
                    n_fill=N_s, mass_fill=mass_s,
                )
                return pos_s, vnew[:N_s], vnew[N_s:]

            self._fire_jit = fire

        pos_s, vel_s, vel_m = self._fire_jit(
            anchor[0], anchor[1], jnp.int32(anchor[2]), jnp.int32(tc),
            sim._dense.position, sim._dense.velocity, sim._dense.mass,
            sim._dense.tag,
        )
        sim._dense = sim._dense.replace(velocity=vel_m)
        sim._mpcd = {
            **mpcd,
            "position": pos_s,
            "velocity": vel_s,
            "_srd_anchor": (pos_s, vel_s, jnp.int32(tc)),
        }
