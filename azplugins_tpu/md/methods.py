"""Integration methods: NVE, Langevin(+flow), Brownian(+flow).

Rebuild of the integrator layer. ConstantVolume is standard velocity
Verlet; LangevinFlow/BrownianFlow re-derive the reference's legacy flow
integrators (/root/reference/src/TwoStepLangevinFlow.h:100-249,
/root/reference/src/TwoStepBrownianFlow.h:103-182): drag is taken relative
to the flow velocity u(r), and the random force is uniform with
coefficient sqrt(6 gamma kT / dt) (matching second moments). Plain
Langevin/Brownian are the flow variants with u = 0.

Protocol (driven by md.integrate.Integrator inside one jitted step):
    step1(state, dt, timestep, seed): drift half of the update
    step2(state, dt, timestep, seed): kick half; state.net_force holds
        forces at the *new* positions when step2 runs.

Each method integrates only the particles selected by its filter (a static
mask), so several methods can coexist like HOOMD's method list.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import rng as _rng
from ..core.typeparam import TypeParameter
from ..core.variant import as_variant
from ..flow import FlowField
from .filter import All, ParticleFilter

__all__ = ["Method", "ConstantVolume", "Langevin", "LangevinFlow", "Brownian", "BrownianFlow"]


class Method:
    # True when the method conserves total momentum (plain NVE): consumed
    # by ThermodynamicQuantities' DOF accounting (3N-3 vs 3N)
    _conserves_momentum = False

    def __init__(self, filter: ParticleFilter | None = None):
        self.filter = filter if filter is not None else All()
        self._select = None  # traced selector, bound at attach
        self._rotational = False  # set at attach from the integrator flag

    def _attach(self, sim):
        self._select = self.filter.bind(sim._particle_types)
        integ = sim.operations.integrator
        self._rotational = bool(
            integ is not None and integ.integrate_rotational_dof
        )

    def _where(self, state, new, old):
        # empty slots (tag < 0, dense layout) must never move: the pair
        # kernels rely on their far sentinel positions staying put
        m = self._select(state) & (state.tag >= 0)
        if new.ndim > m.ndim:
            m = m[(...,) + (None,) * (new.ndim - m.ndim)]
        return jnp.where(m, new, old)

    # default: velocity Verlet pieces -----------------------------------
    # step1 drifts with the *stored* acceleration (which for Langevin
    # includes last step's thermostat forces, matching the reference's
    # h_accel usage at TwoStepLangevinFlow.h:142-149).
    # Positions are NOT wrapped here (HOOMD wraps every step): they drift
    # unwrapped until the next neighbor rebuild, which wraps and updates
    # images (ops/dense._bin_to_slots). This keeps the hot loop free of
    # periodic math; forces are exact because stencil coordinates are
    # pre-shifted.
    def step1(self, state, dt, timestep, seed):
        vel_half = state.velocity + (0.5 * dt) * state.acceleration
        pos = state.position + dt * vel_half
        state = state.replace(
            position=self._where(state, pos, state.position),
            velocity=self._where(state, vel_half, state.velocity),
        )
        if self._rotational:
            state = self._rot_step1(state, dt)
        return state

    def step2(self, state, dt, timestep, seed):
        accel = state.net_force / state.mass[:, None]
        vel = state.velocity + (0.5 * dt) * accel
        state = state.replace(
            velocity=self._where(state, vel, state.velocity),
            acceleration=self._where(state, accel, state.acceleration),
        )
        if self._rotational:
            state = self._rot_step2(state, dt, timestep, seed)
        return state

    # rotational velocity-Verlet (NO_SQUISH; md/rotation.py). step1 kicks
    # the angular momentum by dt/2 with the STORED torques (computed at the
    # previous step's positions, like the stored acceleration) then rotates
    # freely for dt; step2 kicks with the fresh torques in state.net_torque.
    def _rot_step1(self, state, dt):
        from . import rotation as R

        q, p = state.orientation, state.angmom
        inertia = state.moment_inertia
        p = R.angmom_kick(q, p, state.net_torque, inertia, dt)
        q, p = R.free_rotation(q, p, inertia, dt)
        return state.replace(
            orientation=self._where(state, q, state.orientation),
            angmom=self._where(state, p, state.angmom),
        )

    def _rot_step2(self, state, dt, timestep, seed):
        from . import rotation as R

        p = R.angmom_kick(
            state.orientation, state.angmom, state.net_torque,
            state.moment_inertia, dt,
        )
        return state.replace(angmom=self._where(state, p, state.angmom))


class ConstantVolume(Method):
    """NVE velocity Verlet (dummy-integrator role in the parity tests)."""

    _conserves_momentum = True


class _GammaMixin:
    def _init_gamma(self, default_gamma):
        self.gamma = TypeParameter("gamma", 1, None, float, default=float(default_gamma))
        self.gamma_r = TypeParameter("gamma_r", 1, None, float, default=1.0)

    def _attach_gamma(self, sim):
        self._gamma_table = jnp.asarray(
            self.gamma.to_scalar_table(sim._particle_types), dtype=jnp.float32
        )
        self._gamma_r_table = jnp.asarray(
            self.gamma_r.to_scalar_table(sim._particle_types), dtype=jnp.float32
        )

    def _gamma_of(self, state):
        # typeid may be permuted (and -1 on empty slots) in the dense layout
        return jnp.take(self._gamma_table, jnp.maximum(state.typeid, 0))

    def _gamma_r_of(self, state):
        return jnp.take(self._gamma_r_table, jnp.maximum(state.typeid, 0))


class LangevinFlow(Method, _GammaMixin):
    """Velocity-Verlet Langevin with drag relative to a flow field.

    step2 adds F_BD = F_random - gamma (v - u(r)) to the net force before
    the second half kick (reference: TwoStepLangevinFlow.h:159-249).
    """

    _rng_stream = _rng.Stream.LANGEVIN_FLOW

    def __init__(self, kT, flow_field: FlowField | None = None, filter=None,
                 default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(filter)
        self.kT = as_variant(kT)
        self.flow_field = flow_field
        self.noiseless = bool(noiseless)
        self._init_gamma(default_gamma)

    def _attach(self, sim):
        super()._attach(sim)
        self._attach_gamma(sim)

    def _flow_velocity(self, state):
        if self.flow_field is None:
            return jnp.zeros_like(state.position)
        # flow fields are defined on in-box coordinates; positions drift
        # unwrapped between neighbor rebuilds, so wrap locally (O(N))
        pos, _ = state.box.wrap(state.position)
        return self.flow_field(pos)

    def step2(self, state, dt, timestep, seed):
        gp = self._gamma_of(state)
        gamma = gp[:, None]
        kT = self.kT(timestep)
        if self.noiseless or dt <= 0:
            coeff = jnp.zeros((state.N, 1), jnp.float32)
        else:
            coeff = jnp.sqrt(6.0 * gp * kT / dt)[:, None]
        u = _rng.particle_uniform3(self._rng_stream, seed, timestep, state.tag)
        random_force = coeff * u
        flow_vel = self._flow_velocity(state)
        bd_force = random_force - gamma * (state.velocity - flow_vel)
        accel = (state.net_force + bd_force) / state.mass[:, None]
        vel = state.velocity + (0.5 * dt) * accel
        state = state.replace(
            velocity=self._where(state, vel, state.velocity),
            acceleration=self._where(state, accel, state.acceleration),
        )
        if self._rotational:
            state = self._rot_step2_langevin(state, dt, timestep, seed, kT)
        return state

    def _rot_step2_langevin(self, state, dt, timestep, seed, kT):
        """Second rotational half-kick with body-frame friction + noise.

        bd torque (body frame) = sqrt(6 gamma_r kT / dt) * U(-1,1) per axis
        minus gamma_r * omega_body, rotated to lab and added to the
        conservative torques for the dt/2 kick (HOOMD TwoStepLangevin's
        rotational update re-derived for the uniform-noise convention).
        """
        from . import rotation as R

        q, p = state.orientation, state.angmom
        inertia = state.moment_inertia
        active = inertia > 1e-12
        L_body = R.body_angular_momentum(q, p)
        omega = jnp.where(active, L_body / jnp.maximum(inertia, 1e-12), 0.0)
        gr = self._gamma_r_of(state)[:, None]
        if self.noiseless or dt <= 0:
            rand = jnp.zeros_like(omega)
        else:
            u = _rng.particle_uniform3(
                _rng.Stream.LANGEVIN_ANGULAR, seed, timestep, state.tag
            )
            rand = jnp.sqrt(6.0 * gr * kT / dt) * u
        bd_body = jnp.where(active, rand - gr * omega, 0.0)
        torque = state.net_torque + R.rotate(q, bd_body)
        p = R.angmom_kick(q, p, torque, inertia, dt)
        # store the EFFECTIVE torque (conservative + BD) so the next step1
        # half-kick reuses it — the rotational analog of the stored
        # acceleration carrying F_BD (reference TwoStepLangevinFlow.h:142-149);
        # without this the thermostat noise acts over dt/2 and equilibrates
        # at kT/2
        return state.replace(
            angmom=self._where(state, p, state.angmom),
            net_torque=self._where(state, torque, state.net_torque),
        )


class Langevin(LangevinFlow):
    """Standard Langevin thermostat (flow field = 0)."""

    _rng_stream = _rng.Stream.LANGEVIN

    def __init__(self, kT, filter=None, default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(kT, flow_field=None, filter=filter,
                         default_gamma=default_gamma, noiseless=noiseless)


class BrownianFlow(Method, _GammaMixin):
    """Overdamped (Brownian) dynamics advected by a flow field.

    Single-step update r += (u(r) + (F + F_rand)/gamma) dt
    (reference: TwoStepBrownianFlow.h:103-182). step2 is empty.
    """

    _rng_stream = _rng.Stream.BROWNIAN_FLOW

    def __init__(self, kT, flow_field: FlowField | None = None, filter=None,
                 default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(filter)
        self.kT = as_variant(kT)
        self.flow_field = flow_field
        self.noiseless = bool(noiseless)
        self._init_gamma(default_gamma)

    def _attach(self, sim):
        super()._attach(sim)
        self._attach_gamma(sim)

    def step1(self, state, dt, timestep, seed):
        gp = self._gamma_of(state)
        gamma = gp[:, None]
        kT = self.kT(timestep)
        if self.noiseless or dt <= 0:
            coeff = jnp.zeros((state.N, 1), jnp.float32)
        else:
            coeff = jnp.sqrt(6.0 * gp * kT / dt)[:, None]
        u = _rng.particle_uniform3(self._rng_stream, seed, timestep, state.tag)
        random_force = coeff * u
        if self.flow_field is None:
            flow_vel = jnp.zeros_like(state.position)
        else:
            wrapped, _ = state.box.wrap(state.position)
            flow_vel = self.flow_field(wrapped)
        pos = state.position + (flow_vel + (state.net_force + random_force) / gamma) * dt
        return state.replace(
            position=self._where(state, pos, state.position),
        )

    def step2(self, state, dt, timestep, seed):
        # bookkeeping only: acceleration mirrors net_force/m so the rebin
        # payload (which carries acceleration, not net force) reconstructs
        # net_force exactly for the next step1 (ops/dense._state_from_payload)
        accel = state.net_force / state.mass[:, None]
        return state.replace(
            acceleration=self._where(state, accel, state.acceleration)
        )


class Brownian(BrownianFlow):
    """Standard Brownian dynamics (flow field = 0)."""

    _rng_stream = _rng.Stream.BROWNIAN

    def __init__(self, kT, filter=None, default_gamma: float = 1.0, noiseless: bool = False):
        super().__init__(kT, flow_field=None, filter=filter,
                         default_gamma=default_gamma, noiseless=noiseless)
