"""Updaters: TypeUpdater and ParticleEvaporator.

Rebuild of the reference's legacy updaters (SURVEY §2.8, required by the
north star):

  * ``TypeUpdater`` flips particle types by z-slab membership
    (/root/reference/src/TypeUpdater.cc:93-127): particles of
    ``inside_type``/``outside_type`` become ``inside_type`` when their
    wrapped z is in [lo, hi), else ``outside_type``.
  * ``ParticleEvaporator`` retypes up to ``N_evap_max`` "solvent" particles
    found in the slab to an inert type per trigger firing
    (/root/reference/src/ParticleEvaporator.cc:64-174). The reference picks
    a uniform random subset via a Fisher-Yates shuffle with replicated RNG;
    here the pick is a deterministic top-k over per-candidate counter-based
    random priorities (also a uniform subset without replacement, and
    bitwise identical on any device count — same contract, static
    shapes instead of stream compaction).

Both run inside the jitted step on their trigger schedule; retyping is a
masked scatter, never a resize (the reference also retypes because HOOMD
cannot delete particles, src/ParticleEvaporator.h:22-43).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .core import rng as _rng
from .md.trigger import as_trigger

__all__ = ["Updater", "TypeUpdater", "ParticleEvaporator"]


class Updater:
    # True when _update is a pure device function of (state, timestep,
    # seed): the runner then applies it INSIDE the jitted step loop as a
    # masked select on its trigger schedule, so the run() chunk does not
    # split (and pay a host dispatch round-trip) at every firing
    _inline_ok = False
    # False when _update does non-trivial per-step work (the masked-select
    # inlining evaluates it EVERY step and discards non-firing results):
    # the runner then inlines only for short trigger periods, where the
    # per-step cost beats the host chunk split it replaces, and falls
    # back to host-boundary firing for long ones (simulation.py)
    _inline_cheap = True

    def __init__(self, trigger):
        self.trigger = as_trigger(trigger)
        self._attached = False

    def _attach(self, sim):
        self._attached = True

    def _update(self, state, timestep, seed):  # pragma: no cover - interface
        raise NotImplementedError


class TypeUpdater(Updater):
    _inline_ok = True

    def __init__(self, trigger, inside_type: str, outside_type: str, lo: float, hi: float):
        super().__init__(trigger)
        self.inside_type = inside_type
        self.outside_type = outside_type
        self.lo = float(lo)
        self.hi = float(hi)
        if self.lo >= self.hi:
            raise ValueError("region lo must be below hi")

    def _attach(self, sim):
        types = sim._particle_types
        if self.inside_type not in types or self.outside_type not in types:
            raise ValueError("inside/outside types must exist")
        if self.inside_type == self.outside_type:
            raise ValueError("inside and outside types must differ")
        self._inside_id = types.index(self.inside_type)
        self._outside_id = types.index(self.outside_type)
        box_lo = float(np.asarray(sim._synced_state().box.lo)[2])
        box_hi = float(np.asarray(sim._synced_state().box.hi)[2])
        if self.lo < box_lo or self.hi > box_hi:
            raise ValueError("region must lie inside the global box")
        super()._attach(sim)

    def _update(self, state, timestep, seed):
        pos, _ = state.box.wrap(state.position, state.image)
        z = pos[:, 2]
        in_region = (z >= self.lo) & (z < self.hi)
        affected = (state.typeid == self._inside_id) | (state.typeid == self._outside_id)
        new_typeid = jnp.where(
            affected,
            jnp.where(in_region, self._inside_id, self._outside_id),
            state.typeid,
        ).astype(jnp.int32)
        return state.replace(typeid=new_typeid)


class ParticleEvaporator(Updater):
    """Evaporate (retype) solvent particles out of a z-slab region."""

    _inline_ok = True
    _inline_cheap = False  # counter RNG + full-N top_k per step when inlined

    def __init__(
        self,
        trigger,
        solvent_type: str,
        evaporated_type: str,
        lo: float,
        hi: float,
        N_evap_max: int = 0xFFFFFFF,
        seed: int | None = None,
    ):
        super().__init__(trigger)
        self.solvent_type = solvent_type
        self.evaporated_type = evaporated_type
        self.lo = float(lo)
        self.hi = float(hi)
        self.N_evap_max = int(N_evap_max)
        self.seed = seed  # falls back to simulation seed
        if self.lo >= self.hi:
            raise ValueError("region lo must be below hi")

    def _attach(self, sim):
        types = sim._particle_types
        if self.solvent_type not in types or self.evaporated_type not in types:
            raise ValueError("solvent/evaporated types must exist")
        if self.solvent_type == self.evaporated_type:
            raise ValueError("solvent and evaporated types must differ")
        self._solvent_id = types.index(self.solvent_type)
        self._evaporated_id = types.index(self.evaporated_type)
        box_lo = float(np.asarray(sim._synced_state().box.lo)[2])
        box_hi = float(np.asarray(sim._synced_state().box.hi)[2])
        if self.lo < box_lo or self.hi > box_hi:
            raise ValueError("region must lie inside the global box")
        self._k = min(self.N_evap_max, int(sim._state.N))
        super()._attach(sim)

    def _update(self, state, timestep, seed):
        if self.seed is not None:
            seed = self.seed
        pos, _ = state.box.wrap(state.position, state.image)
        z = pos[:, 2]
        candidate = (
            (state.typeid == self._solvent_id) & (z >= self.lo) & (z < self.hi)
        )
        n_marked = jnp.sum(candidate.astype(jnp.int32))

        if self._k >= state.N:
            flip = candidate
        else:
            # deterministic uniform pick without replacement: per-candidate
            # random priority, keep the N_evap_max smallest. Selection stays
            # in EXACT integer space: an f32 cast would collide mantissas
            # above 2^24 candidates and make the pick slightly non-uniform
            # (reference keeps integer Fisher-Yates picks,
            # /root/reference/src/ParticleEvaporator.cc:229-259).
            import jax.lax

            (bits,) = _rng.particle_bits(
                _rng.Stream.PARTICLE_EVAPORATOR, seed, timestep, state.tag, n_words=1
            )
            priority = jnp.where(candidate, bits, jnp.uint32(0xFFFFFFFF))
            # k smallest priorities == top_k of the uint32 complement,
            # order-preservingly bitcast to int32 (flip the sign bit)
            inv = jnp.uint32(0xFFFFFFFF) - priority
            key = (inv ^ jnp.uint32(0x80000000)).view(jnp.int32)
            _, pick_idx = jax.lax.top_k(key, self._k)
            pick_mask = jnp.zeros((state.N,), dtype=bool).at[pick_idx].set(True)
            flip = jnp.where(n_marked <= self._k, candidate, pick_mask & candidate)
        new_typeid = jnp.where(flip, self._evaporated_id, state.typeid).astype(jnp.int32)
        return state.replace(typeid=new_typeid)
