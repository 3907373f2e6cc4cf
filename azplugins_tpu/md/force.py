"""Force base classes and attach machinery.

Mirrors the reference's lazy ``_attach_hook`` pattern
(/root/reference/src/pair.py:413-426): users configure params by type name;
at attach the params are validated, precomputed, and packed into dense
device tables; the jitted step calls the pure ``_compute``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.typeparam import TypeParameter
from ..logging import log
from ..ops.pair_force import ForceResult

__all__ = ["Force", "SimContext"]


class SimContext:
    """Static per-run context handed to force computes."""

    def __init__(self, dt: float, seed: int):
        self.dt = float(dt)
        self.seed = int(seed)


class Force:
    """Base class for all force computes."""

    _needs_nlist = False
    _produces_torque = False

    def __init__(self):
        self._attached = False
        self._sim = None

    # -- attach lifecycle ----------------------------------------------------
    def _attach(self, sim):
        self._sim = sim
        self._build_tables(sim)
        self._attached = True

    def _refresh_tables(self, sim):
        """Rebuild device tables from the (possibly user-mutated) params.

        Called at the start of every run so parameter edits after attach
        take effect without recompiling (tables are jit *arguments*).
        """
        self._build_tables(sim)

    def _device_tables(self):
        """The pytree of device arrays passed into the jitted step."""
        return self._tbl

    def _detach(self):
        self._attached = False
        self._sim = None

    def _build_tables(self, sim):  # pragma: no cover - interface
        raise NotImplementedError

    def _compute(self, state, nbr_idx, timestep, ctx: SimContext, tbl) -> ForceResult:
        """Pure force kernel; ``tbl`` is this force's _device_tables pytree."""
        raise NotImplementedError  # pragma: no cover

    # dense-engine hooks ---------------------------------------------------
    _needs_velocity_j = False
    _needs_tag_j = False
    _needs_quat_j = False

    def _compute_dense(self, dense, jb, spec, slot_of, timestep, ctx, tbl, want="all", masked=True) -> ForceResult:
        """Force kernel in the dense (slot) layout.

        Default: per-particle forces (barriers/walls) are layout-agnostic;
        reuse ``_compute`` with no neighbor structure. Pair/bond forces
        override.
        """
        return self._compute(dense, None, timestep, ctx, tbl)

    def _max_r_cut(self) -> float:
        return 0.0

    # -- observables (lazy, computed on access like the reference's pull path)
    def _result(self) -> ForceResult:
        if not self._attached:
            raise RuntimeError(
                f"{type(self).__name__} is not attached to a simulation; run sim.run(0) first"
            )
        return self._sim._compute_single_force(self)

    @log(category="particle", requires_run=True)
    def forces(self) -> np.ndarray:
        """Per-particle forces (tag order)."""
        return np.asarray(self._result().force)

    @log(category="particle", requires_run=True)
    def energies(self) -> np.ndarray:
        """Per-particle potential energies (tag order)."""
        return np.asarray(self._result().energy)

    @log(requires_run=True)
    def energy(self) -> float:
        """Total potential energy of this force."""
        return float(jnp.sum(self._result().energy))

    @log(category="particle", requires_run=True, default=False)
    def virials(self) -> np.ndarray:
        """Per-particle virial tensor components (tag order)."""
        return np.asarray(self._result().virial)

    @log(category="particle", requires_run=True, default=False)
    def torques(self) -> np.ndarray:
        """Per-particle torques (zero for isotropic forces)."""
        r = self._result()
        if r.torque is None:
            return np.zeros((r.force.shape[0], 3), dtype=np.float32)
        return np.asarray(r.torque)


def tables_to_device(host_tables: dict) -> dict:
    """Normalize parameter tables to f32 — kept HOST-side (numpy).

    Tables stay numpy on purpose: Simulation fingerprints them every
    ``run()`` to decide whether to rebind the compiled chunk, and host
    bytes are free to read while reading a device array blocks on a
    device-to-host copy. They are baked into the jitted
    chunk as constants at bind time (Simulation._bind_tables), so nothing
    on the device path ever sees the numpy copies.
    """
    return {k: np.asarray(v, dtype=np.float32) for k, v in host_tables.items()}


def build_pair_tables(def_, params: TypeParameter, types: list[str]) -> dict:
    """Validate + precompute per-type-pair parameter tables -> device f32."""
    host = params.to_dict_tables(types)
    pre = def_.precompute(host)
    return tables_to_device(pre)
