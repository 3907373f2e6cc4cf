"""Cell list + Verlet neighbor list (static shapes, no atomics).

TEST-ORACLE ONLY: Simulation never dispatches this path — the production
hot path is the dense cell-grid engine (ops/dense.py). This module and
ops/pair_force.py survive as the independent reference implementation the
parity tests compare against. Do not benchmark it.

Replaces the HOOMD cell-list/NeighborList substrate the reference rides on
(consumed via ``nlist.Cell(buffer)`` at /root/reference/src/pair.py:18 and
tests src/pytest/test_pair.py:337). Design:

  * Binning is sort-based: argsort particles by cell id, rank-in-cell from a
    searchsorted prefix, scatter ids into a fixed-capacity ``[n_cells *
    capacity]`` table. No atomics — overflow is detected and
    surfaced as a flag the host reacts to by growing capacity.
  * Candidates are gathered from the 27-cell stencil (per-axis collapsed for
    small boxes) and compacted into a padded ``[N, n_max]`` index array with
    a cumsum prefix + one big scatter — O(N * C) streaming memory traffic,
    no per-row sort.
  * A Verlet buffer makes the list reusable: ``needs_rebuild`` checks the
    max displacement against buffer/2 and the jitted step rebuilds through
    ``lax.cond``.

Everything is shape-static so the whole pipeline jits; capacities are chosen
on the host from density estimates with safety margin and grown on overflow.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.box import Box
from ..utils import pytree_dataclass, static_field

__all__ = ["NeighborSpec", "NeighborListData", "build_neighbor_list", "needs_rebuild"]


@pytree_dataclass
class NeighborSpec:
    """Static geometry/capacity parameters for the neighbor pipeline.

    All fields are static (hashable) so a spec change retraces the step.
    """

    r_cut: float = static_field()
    buffer: float = static_field()
    dims: tuple = static_field()  # (Dx, Dy, Dz) cells per axis
    cell_capacity: int = static_field()
    n_max: int = static_field()  # max neighbors within r_cut + buffer

    @property
    def r_list(self) -> float:
        return self.r_cut + self.buffer

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def stencil(self) -> np.ndarray:
        """Cell-offset stencil, collapsed along axes with < 3 cells."""
        offs = []
        for D in self.dims:
            if D >= 3:
                offs.append((-1, 0, 1))
            elif D == 2:
                offs.append((0, 1))
            else:
                offs.append((0,))
        out = [(ox, oy, oz) for ox in offs[0] for oy in offs[1] for oz in offs[2]]
        return np.asarray(out, dtype=np.int32)

    @classmethod
    def create(
        cls,
        box: Box,
        N: int,
        r_cut: float,
        buffer: float,
        cell_capacity: int | None = None,
        n_max: int | None = None,
        safety: float = 1.3,
    ) -> "NeighborSpec":
        """Host-side capacity planning from the particle density."""
        L = np.asarray(box.L)
        r_list = r_cut + buffer
        dims = tuple(int(max(1, math.floor(l / r_list))) for l in L)
        n_cells = dims[0] * dims[1] * dims[2]
        density = N / float(np.prod(L))
        if cell_capacity is None:
            # mean + Poisson tail headroom: occupancy fluctuates ~sqrt(mean)
            mean_occ = N / n_cells
            want = mean_occ * safety + 3.0 * math.sqrt(mean_occ) + 2.0
            cell_capacity = int(math.ceil(want / 4.0) * 4)
            cell_capacity = min(cell_capacity, N)
        if n_max is None:
            mean_nbr = density * 4.0 / 3.0 * math.pi * r_list**3
            want = mean_nbr * safety + 3.0 * math.sqrt(max(mean_nbr, 1.0)) + 2.0
            n_max = int(math.ceil(want / 8.0) * 8)
            n_max = min(n_max, N)
        return cls(
            r_cut=float(r_cut),
            buffer=float(buffer),
            dims=dims,
            cell_capacity=int(cell_capacity),
            n_max=int(n_max),
        )

    def grow(self, cell_overflow: bool, nlist_overflow: bool) -> "NeighborSpec":
        """Return a spec with grown capacities after an overflow event."""
        return NeighborSpec(
            r_cut=self.r_cut,
            buffer=self.buffer,
            dims=self.dims,
            cell_capacity=int(self.cell_capacity * 2) if cell_overflow else self.cell_capacity,
            n_max=min(int(self.n_max * 2), 4096) if nlist_overflow else self.n_max,
        )


@pytree_dataclass
class NeighborListData:
    """Padded neighbor indices (sentinel = N) plus rebuild bookkeeping."""

    idx: jnp.ndarray  # [N, n_max] int32, sentinel N
    ref_position: jnp.ndarray  # [N, 3] positions at build time
    cell_overflow: jnp.ndarray  # bool scalar
    nlist_overflow: jnp.ndarray  # bool scalar
    n_builds: jnp.ndarray  # int32 scalar

    @property
    def overflow(self):
        return jnp.logical_or(self.cell_overflow, self.nlist_overflow)


def _cell_index(position: jnp.ndarray, box: Box, dims) -> jnp.ndarray:
    """Map positions to flattened cell ids."""
    f = box.fraction(position) + 0.5  # [0, 1)
    f = f - jnp.floor(f)  # robust fold for positions exactly at the edge
    d = jnp.asarray(dims, dtype=jnp.float32)
    c = jnp.clip(jnp.floor(f * d).astype(jnp.int32), 0, jnp.asarray(dims, jnp.int32) - 1)
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2], c


@partial(jax.jit, static_argnames=("spec",))
def build_neighbor_list(position: jnp.ndarray, box: Box, spec: NeighborSpec) -> NeighborListData:
    """Build the padded neighbor list from scratch. Fully jitted."""
    N = position.shape[0]
    cap = spec.cell_capacity
    n_max = spec.n_max
    sentinel = jnp.int32(N)

    cid, coords = _cell_index(position, box, spec.dims)

    # ---- sort-based binning ------------------------------------------------
    order = jnp.argsort(cid).astype(jnp.int32)  # particle ids sorted by cell
    sorted_cid = cid[order]
    first = jnp.searchsorted(sorted_cid, sorted_cid, side="left").astype(jnp.int32)
    rank = jnp.arange(N, dtype=jnp.int32) - first
    cell_overflow = jnp.any(rank >= cap)
    slot = sorted_cid * cap + jnp.minimum(rank, cap - 1)
    table = jnp.full((spec.n_cells * cap,), sentinel, dtype=jnp.int32)
    table = table.at[slot].set(order, mode="drop")

    # ---- stencil gather ----------------------------------------------------
    stencil = jnp.asarray(spec.stencil())  # [S, 3]
    dims_arr = jnp.asarray(spec.dims, dtype=jnp.int32)
    ncoords = (coords[:, None, :] + stencil[None, :, :]) % dims_arr  # [N, S, 3]
    ncid = (ncoords[..., 0] * spec.dims[1] + ncoords[..., 1]) * spec.dims[2] + ncoords[..., 2]
    # occupants of all stencil cells: [N, S*cap]
    cand = table[(ncid[..., None] * cap + jnp.arange(cap, dtype=jnp.int32)).reshape(N, -1)]

    # ---- distance filter (componentwise: no [.., 3] minor axis) -----------
    j = jnp.minimum(cand, N - 1)
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    dx = px[:, None] - px[j]
    dy = py[:, None] - py[j]
    dz = pz[:, None] - pz[j]
    dx, dy, dz = box.min_image_components(dx, dy, dz)
    rsq = dx * dx + dy * dy + dz * dz
    i_ids = jnp.arange(N, dtype=jnp.int32)[:, None]
    r_list_sq = jnp.float32(spec.r_list * spec.r_list)
    keep = (cand != sentinel) & (cand != i_ids) & (rsq < r_list_sq)

    # ---- cumsum + scatter compaction ----------------------------------------
    pos_in_row = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1  # position among kept
    count = pos_in_row[:, -1] + 1
    nlist_overflow = jnp.any(count > n_max)
    dest = jnp.where(keep & (pos_in_row < n_max), pos_in_row, n_max)  # n_max = dump slot
    flat_dest = i_ids * (n_max + 1) + dest
    nbr = jnp.full((N * (n_max + 1),), sentinel, dtype=jnp.int32)
    nbr = nbr.at[flat_dest.reshape(-1)].set(cand.reshape(-1), mode="drop")
    idx = nbr.reshape(N, n_max + 1)[:, :n_max]

    return NeighborListData(
        idx=idx,
        ref_position=position,
        cell_overflow=cell_overflow,
        nlist_overflow=nlist_overflow,
        n_builds=jnp.int32(1),
    )


def needs_rebuild(nlist: NeighborListData, position: jnp.ndarray, box: Box, buffer: float):
    """True if any particle moved more than buffer/2 since the last build."""
    d = position - nlist.ref_position
    dx, dy, dz = box.min_image_components(d[:, 0], d[:, 1], d[:, 2])
    dispsq = dx * dx + dy * dy + dz * dz
    return jnp.max(dispsq) > jnp.float32(0.25 * buffer * buffer)
