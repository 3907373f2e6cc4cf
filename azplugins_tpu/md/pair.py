"""Pair potentials (user API).

Mirrors ``hoomd.azplugins.pair`` (/root/reference/src/pair.py): Colloid,
DPDGeneralWeight, ExpandedYukawa, Hertz, PerturbedLennardJones, TwoPatchMorse.
Parameters are set per unordered type pair::

    lj = PerturbedLennardJones(nlist=Cell(buffer=0.4), default_r_cut=3.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)

Shift modes follow HOOMD semantics (``none``/``shift``/``xplor``,
/root/reference/src/pair.py:108).
"""

from __future__ import annotations

import numpy as np

from ..core.typeparam import TypeParameter
from ..core.variant import as_variant
from ..ops.aniso_force import aniso_pair_force
from ..ops.evaluators import ANISO_PAIR_POTENTIALS, PAIR_POTENTIALS
from ..ops.dense import dense_aniso_force, dense_dpd_force, dense_pair_force
from ..ops.pair_force import dpd_pair_force, pair_force
from .force import Force, SimContext, build_pair_tables
from .nlist import Cell

__all__ = [
    "Pair",
    "Colloid",
    "DPDGeneralWeight",
    "ExpandedYukawa",
    "Gaussian",
    "Hertz",
    "LJ",
    "Morse",
    "PerturbedLennardJones",
    "TwoPatchMorse",
    "Yukawa",
]


class Pair(Force):
    """Base for isotropic pair potentials riding a shared neighbor list."""

    _needs_nlist = True
    _evaluator_name: str = ""
    _accepted_modes = ("none", "shift", "xplor")

    def __init__(self, nlist: Cell, default_r_cut=None, default_r_on=0.0, mode="none"):
        super().__init__()
        if mode not in self._accepted_modes:
            raise ValueError(f"mode must be one of {self._accepted_modes}")
        if not isinstance(nlist, Cell):
            raise TypeError("nlist must be an azplugins_tpu.md.nlist.Cell")
        self.nlist = nlist
        self.mode = mode
        self._def = PAIR_POTENTIALS[self._evaluator_name]
        self.params = TypeParameter("params", 2, self._def.spec)
        self.r_cut = TypeParameter(
            "r_cut", 2, None, float, default=None if default_r_cut is None else float(default_r_cut)
        )
        self.r_on = TypeParameter("r_on", 2, None, float, default=float(default_r_on))

    def _build_tables(self, sim):
        import jax.numpy as jnp

        types = sim._particle_types
        self._tbl = {
            "params": build_pair_tables(self._def, self.params, types),
            "r_cut": np.asarray(self.r_cut.to_scalar_table(types), dtype=np.float32),
            "r_on": np.asarray(self.r_on.to_scalar_table(types), dtype=np.float32),
        }

    def _max_r_cut(self) -> float:
        if not hasattr(self, "_tbl"):
            raise RuntimeError("not attached")
        return float(np.asarray(self._tbl["r_cut"]).max())

    def _compute(self, state, nbr_idx, timestep, ctx: SimContext, tbl):
        # TEST-ORACLE ONLY: the padded-neighbor-list driver
        # (ops/neighbor.py + ops/pair_force.py) survives as the
        # independent reference path for parity tests. Simulation never
        # dispatches it — the production path is _compute_dense (the
        # dense cell-grid stencil). Do not benchmark this path.
        return pair_force(
            self._def.energy_force,
            state.position,
            state.typeid,
            state.box,
            nbr_idx,
            tbl["params"],
            tbl["r_cut"],
            tbl["r_on"],
            self.mode,
        )

    def _compute_dense(self, dense, jb, spec, slot_of, timestep, ctx, tbl, want="all", masked=True):
        return dense_pair_force(
            self._def.energy_force,
            dense,
            jb,
            spec,
            tbl["params"],
            tbl["r_cut"],
            tbl["r_on"],
            self.mode,
            want,
            masked,
        )


class Colloid(Pair):
    """Integrated Lennard-Jones (Hamaker/Everaers-Ejtehadi) colloid potential.

    Parity: /root/reference/src/pair.py:14-118 and
    /root/reference/src/PairEvaluatorColloid.h:101-269. Params per pair:
    ``A`` (Hamaker energy), ``a_1``/``a_2`` (radii; 0 selects the
    solvent-solvent / colloid-solvent branches), ``sigma``.
    """

    _evaluator_name = "Colloid"


class ExpandedYukawa(Pair):
    """U = eps exp(-kappa (r - delta)) / (r - delta).

    Parity: /root/reference/src/pair.py:242-298,
    /root/reference/src/PairEvaluatorExpandedYukawa.h:92-115.
    """

    _evaluator_name = "ExpandedYukawa"


class Hertz(Pair):
    """U = eps (1 - r/r_cut)^{5/2}.

    Parity: /root/reference/src/pair.py:300-352,
    /root/reference/src/PairEvaluatorHertz.h:93-110.
    """

    _evaluator_name = "Hertz"


class PerturbedLennardJones(Pair):
    """WCA core + attraction_scale_factor-scaled LJ tail.

    Parity: /root/reference/src/pair.py:354-427,
    /root/reference/src/PairEvaluatorPerturbedLennardJones.h:117-155.
    """

    _evaluator_name = "PerturbedLennardJones"


class LJ(Pair):
    """Standard 12-6 Lennard-Jones (HOOMD-core substrate, SURVEY §2.13).

    azplugins scripts mix plugin potentials with HOOMD's own md.pair
    classes; this is the textbook U = 4 eps ((sigma/r)^12 - (sigma/r)^6)
    so those scripts port without rewriting the solvent model.
    """

    _evaluator_name = "LJ"


class Morse(Pair):
    """Isotropic Morse potential (HOOMD-core substrate, SURVEY §2.13).

    U = D0 (exp(-2 alpha (r - r0)) - 2 exp(-alpha (r - r0))).
    """

    _evaluator_name = "Morse"


class Gaussian(Pair):
    """Gaussian-core potential (HOOMD-core substrate, SURVEY §2.13).

    U = eps exp(-r^2 / (2 sigma^2)).
    """

    _evaluator_name = "Gaussian"


class Yukawa(Pair):
    """Screened Coulomb U = eps exp(-kappa r) / r (HOOMD-core substrate,
    SURVEY §2.13). The plugin's ExpandedYukawa with delta = 0; kept as
    its own class so hoomd.md.pair.Yukawa scripts port verbatim.
    """

    _evaluator_name = "Yukawa"


class DPDGeneralWeight(Pair):
    """DPD with generalized weight function w_D = (1-r/rcut)^s.

    Parity: /root/reference/src/pair.py:121-240,
    /root/reference/src/DPDPairEvaluatorGeneralWeight.h:198-255. The
    dissipative/random forces use pair-symmetric counter RNG so
    trajectories are bitwise independent of sharding.
    """

    _evaluator_name = "DPDGeneralWeight"
    _accepted_modes = ("none",)
    _needs_velocity_j = True
    _needs_tag_j = True

    def __init__(self, nlist: Cell, kT, default_r_cut=None, mode="none"):
        super().__init__(nlist, default_r_cut=default_r_cut, mode=mode)
        self.kT = as_variant(kT)

    def _compute(self, state, nbr_idx, timestep, ctx: SimContext, tbl):
        kT = self.kT(timestep)
        return dpd_pair_force(
            state.position,
            state.velocity,
            state.tag,
            state.typeid,
            state.box,
            nbr_idx,
            tbl["params"],
            tbl["r_cut"],
            kT,
            ctx.dt,
            ctx.seed,
            timestep,
        )

    def _compute_dense(self, dense, jb, spec, slot_of, timestep, ctx, tbl, want="all", masked=True):
        kT = self.kT(timestep)
        return dense_dpd_force(
            dense, jb, spec, tbl["params"], tbl["r_cut"],
            kT, ctx.dt, ctx.seed, timestep, want, masked,
        )


class TwoPatchMorse(Force):
    """Anisotropic two-patch Morse potential (forces + torques).

    Parity: /root/reference/src/pair.py:429-525,
    /root/reference/src/AnisoPairEvaluatorTwoPatchMorse.h:127-216.
    """

    _needs_nlist = True
    _produces_torque = True
    _accepted_modes = ("none", "shift")
    _needs_quat_j = True

    def __init__(self, nlist: Cell, default_r_cut=None, mode="none"):
        super().__init__()
        if mode not in self._accepted_modes:
            raise ValueError(f"mode must be one of {self._accepted_modes}")
        self.nlist = nlist
        self.mode = mode
        self._def = ANISO_PAIR_POTENTIALS["TwoPatchMorse"]
        self.params = TypeParameter("params", 2, self._def.spec)
        self.r_cut = TypeParameter(
            "r_cut", 2, None, float, default=None if default_r_cut is None else float(default_r_cut)
        )

    def _build_tables(self, sim):
        import jax.numpy as jnp

        types = sim._particle_types
        self._tbl = {
            "params": build_pair_tables(self._def, self.params, types),
            "r_cut": np.asarray(self.r_cut.to_scalar_table(types), dtype=np.float32),
        }

    def _max_r_cut(self) -> float:
        return float(np.asarray(self._tbl["r_cut"]).max())

    def _compute(self, state, nbr_idx, timestep, ctx: SimContext, tbl):
        return aniso_pair_force(
            self._def.energy_force_torque,
            state.position,
            state.orientation,
            state.typeid,
            state.box,
            nbr_idx,
            tbl["params"],
            tbl["r_cut"],
            self.mode,
        )

    def _compute_dense(self, dense, jb, spec, slot_of, timestep, ctx, tbl, want="all", masked=True):
        return dense_aniso_force(
            self._def.energy_force_torque,
            dense, jb, spec, tbl["params"], tbl["r_cut"], self.mode, want, masked,
        )
