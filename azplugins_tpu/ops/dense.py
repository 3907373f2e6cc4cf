"""Dense cell-grid engine: the production force and rebuild path.

Particles are binned into a regular cell grid and every pair force is
evaluated as dense, masked per-cell-pair blocks, so the hot loop is
regular elementwise math plus row reductions that XLA fuses:

  * Particles live in a cell-dense slot layout: ``S = n_cells * cap``
    slots, cell-major. Empty slots carry ``tag = -1``.
  * Neighbor access wrap-pads the ``[Dx, Dy, Dz, cap]`` grid with a
    one-cell periodic halo (lattice shifts folded into the halo faces)
    and takes one *static slice* per stencil offset: contiguous copies,
    no per-pair gathers.
  * Pair forces evaluate dense ``[n_cells, cap, cap]`` blocks per stencil
    offset with masking, trading redundant pair evaluations (pairs
    between the cutoff and the cell corners) for perfectly regular work
    (the trade GROMACS makes with cluster pair lists, arXiv:1804.06231).
    Whether this beats a padded Verlet list on the GPU is an open
    measurement (ROADMAP 1.2).
  * Rebinning (the Verlet-buffer rebuild) is one fused-key ``lax.sort``
    plus row gathers of a packed payload.

The slot layout is also the distribution layout: sharding the cell-major
slot axis over a device mesh is a spatial domain decomposition, and XLA
lowers the halo pads across shard boundaries to collective permutes
(the halo exchange of SURVEY §2.12).

State in slot order is an ordinary ``State`` pytree with S rows; the tag
array maps slots back to user order. RNG is keyed on tags, so the random
streams do not depend on the layout.
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng as _rng
from ..core.box import Box
from ..core.state import State
from ..utils import pytree_dataclass, static_field

__all__ = [
    "GridSpec",
    "GridMeta",
    "JBlocks",
    "densify",
    "undensify",
    "rebin",
    "needs_rebin",
    "make_jblocks",
    "dense_pair_force",
    "dense_dpd_force",
    "dense_aniso_force",
    "dense_bond_force",
]


# ---------------------------------------------------------------------------
# Grid specification
# ---------------------------------------------------------------------------
@pytree_dataclass
class GridSpec:
    """Static geometry of the cell grid (hashable; changes retrace)."""

    dims: tuple = static_field()  # (Dx, Dy, Dz)
    cap: int = static_field()  # slots per cell
    r_cut: float = static_field()
    buffer: float = static_field()

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def S(self) -> int:
        return self.n_cells * self.cap

    @property
    def r_list(self) -> float:
        return self.r_cut + self.buffer

    def stencil(self) -> np.ndarray:
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

    @property
    def newton_ok(self) -> bool:
        """Half-stencil (Newton's third law) is valid only when every axis
        has >= 3 cells: with 1 or 2 cells an offset and its negative alias
        to the same cell pairing, which would double-count pairs."""
        return all(D >= 3 for D in self.dims)

    def half_stencil(self) -> np.ndarray:
        """The 13 lexicographically-positive offsets (self cell excluded).

        Each unordered neighbor-cell pair appears exactly once: pairs are
        evaluated once and scattered to both members (Newton's third law),
        halving pair evaluations vs the full 27-cell stencil.
        """
        full = self.stencil()
        keep = [o for o in full if tuple(o) > (0, 0, 0)]
        return np.asarray(keep, dtype=np.int32)

    @classmethod
    def create(cls, box: Box, N: int, r_cut: float, buffer: float,
               safety: float = 1.18, dx_multiple: int = 1,
               strip_devices: int = 1):
        """Size the grid. Pair work scales with cap^2, so the capacity is
        chosen tight: in a dense liquid, repulsion anti-correlates occupancy
        (measured max 45 at mean 37 for 64k LJ at rho=0.85), far below the
        Poisson tail. Transient overflow is handled by the transactional
        grow-and-replay in Simulation.run, so a rare miss costs one
        recompile, not correctness.

        ``dx_multiple``: force Dx to a multiple of this (spatial slab
        decomposition needs one or more whole x cell planes per device).
        Rounding DOWN stays correct — fewer, wider cells still cover
        every pair within r_list — at some extra pair-slot cost.

        ``strip_devices``: force Dx*Dy divisible by this (spatial strip
        decomposition needs whole z cell columns per device — weaker
        than dx_multiple, so it keeps working when devices outnumber x
        planes). Snaps (Dx, Dy) down to the largest commensurate product.
        """
        npd = np.asarray(box.nearest_plane_distance())
        r_list = r_cut + buffer
        dims = tuple(int(max(1, math.floor(l / r_list))) for l in npd)
        if dx_multiple > 1 and dims[0] % dx_multiple != 0:
            dx = (dims[0] // dx_multiple) * dx_multiple
            if dx < dx_multiple:
                raise ValueError(
                    f"cannot give each of {dx_multiple} spatial slabs a "
                    f"whole x cell plane: the box fits only {dims[0]} "
                    f"cells of width >= r_cut + buffer = {r_list:.3g} "
                    "along x (use fewer devices or a larger box)"
                )
            dims = (dx,) + dims[1:]
        if strip_devices > 1 and (dims[0] * dims[1]) % strip_devices != 0:
            n = strip_devices
            best = None
            for dx in range(dims[0], 0, -1):
                for dy in range(dims[1], 0, -1):
                    if (dx * dy) % n == 0:
                        # largest dy for this dx; smaller dy only shrinks
                        if best is None or dx * dy > best[0] * best[1]:
                            best = (dx, dy)
                        break
            if best is None:
                raise ValueError(
                    f"cannot give each of {n} spatial strips a whole z "
                    f"cell column: the box fits only {dims[0]}x{dims[1]} "
                    f"columns of width >= r_cut + buffer (use fewer "
                    "devices or a larger box)"
                )
            dims = (best[0], best[1], dims[2])
        # cells are at least r_list wide, usually wider (floor); claim the
        # whole cell width as Verlet margin so rebuilds trigger as late as
        # the stencil actually allows: pairs stay covered while
        # 2*max_disp < min_edge - r_cut. Axes with <= 2 cells impose no
        # constraint (the stencil sees the whole axis there).
        edges = [npd[k] / dims[k] for k in range(3) if dims[k] >= 3]
        min_edge = float(min(edges)) if edges else float("inf")
        eff_buffer = max(float(buffer), min(min_edge - float(r_cut), 1e6))
        n_cells = dims[0] * dims[1] * dims[2]
        mean_occ = N / n_cells
        want = mean_occ * safety + 4.0
        cap = int(math.ceil(want / 8.0) * 8)
        cap = min(cap, N) if N > 0 else 8
        return cls(dims=dims, cap=max(cap, 1), r_cut=float(r_cut), buffer=eff_buffer)

    def grow(self, gentle: bool = False) -> "GridSpec":
        # 1.25x (rounded up to 8) balances recompile count against the
        # cap^2 cost of oversized cells; ``gentle`` adds one 8-slot
        # quantum instead (post-tune fluctuations need exactly one — see
        # Simulation._grow_and_rebuild). The 8-multiple rounding is not
        # yet measured on the H100.
        new_cap = (
            self.cap + 8
            if gentle
            else max(int(math.ceil(self.cap * 1.25 / 8.0) * 8), self.cap + 8)
        )
        return GridSpec(
            dims=self.dims,
            cap=new_cap,
            r_cut=self.r_cut,
            buffer=self.buffer,
        )


@pytree_dataclass
class GridMeta:
    """Per-layout bookkeeping carried through the step loop."""

    ref_position: jnp.ndarray  # [S, 3] positions at last rebin
    slot_of: jnp.ndarray  # [N] slot index of each tag
    overflow: jnp.ndarray  # bool
    n_builds: jnp.ndarray  # int32
    max_occ: jnp.ndarray  # int32 — max cell occupancy seen since densify
    # (0 = unknown; lets overflow growth size the new cap in one jump)


# ---------------------------------------------------------------------------
# Binning: sort + one row scatter
# ---------------------------------------------------------------------------
def _cell_id(x, y, z, box: Box, dims):
    h = box  # fractional coords from components
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    fz = z / Lz
    fy = (y - yz * Lz * fz) / Ly
    fx = (x - xy * Ly * fy - xz * Lz * fz) / Lx
    del h

    def idx(f, D):
        f = f + 0.5
        f = f - jnp.floor(f)
        return jnp.clip(jnp.floor(f * D).astype(jnp.int32), 0, D - 1)

    cx, cy, cz = idx(fx, dims[0]), idx(fy, dims[1]), idx(fz, dims[2])
    return (cx * dims[1] + cy) * dims[2] + cz


# The rebin payload is a list of (name, width) BLOCKS, each a contiguous
# State array ([n, w] with w in 1..4). Packing the payload is then one
# concatenation of whole arrays and unpacking is static column slices —
# no per-column stacking and no [S, K] <-> [K, S] transposes (the payload
# once moved as 14+ separate [S] columns, and those transposes dominated
# the rebuild).
#
# Optional blocks ("mass", "quat", ...) are included only when the
# simulation uses them (host-side check at attach); dropped columns are
# reconstructed from defaults at undensify. net_force is never carried:
# integrators maintain acceleration = net_force / mass, so it is rebuilt
# exactly. "rotation" carries the angular momentum quaternion, body-frame
# moments of inertia, and the stored net torque (the rotational analog of
# acceleration: step1's angmom kick uses last step's torques).
ALL_FIELDS = ("mass", "quat", "charge", "diameter", "rotation")

# per-field block layout: (state attribute, width, default fill value)
_OPT_BLOCKS = {
    "mass": (("mass", 1, 1.0),),
    "quat": (("orientation", 4, (1.0, 0.0, 0.0, 0.0)),),
    "charge": (("charge", 1, 0.0),),
    "diameter": (("diameter", 1, 1.0),),
    "rotation": (
        ("angmom", 4, 0.0),
        ("moment_inertia", 3, 0.0),
        ("net_torque", 3, 0.0),
    ),
}
_CORE_BLOCKS = (
    ("position", 3, 0.0),
    ("velocity", 3, 0.0),
    ("acceleration", 3, 0.0),
    ("typeid", 1, -1),
    ("tag", 1, -1),
    ("image", 3, 0),
)
_INT_BLOCKS = frozenset({"typeid", "tag", "image"})


def _payload_layout(fields: tuple) -> tuple:
    blocks = list(_CORE_BLOCKS)
    for f in fields:
        blocks.extend(_OPT_BLOCKS[f])
    return tuple(blocks)


# Payload blocks travel through the rebin sort/gather/scatter as int32,
# with FLOATS bitcast to int32 — never the other way around. An int32
# bitcast to f32 can be a NaN bit pattern (tag/typeid -1 = 0xFFFFFFFF is
# a quiet NaN), and XLA backends may canonicalize such NaNs to 0x7FC00000
# inside fused data movement — which silently turned empty slots into
# "real" particles with tag 2143289344 and wrapped their far sentinels
# into the box at the next rebuild. Int32 movement is bit-exact on every
# backend.
def _pack_payload(state: State, layout: tuple):
    """State -> [n, K] int32 via one lane concatenation of whole blocks."""
    parts = []
    for name, w, _ in layout:
        a = getattr(state, name)
        if a.ndim == 1:
            a = a[:, None]
        if name not in _INT_BLOCKS:
            a = a.view(jnp.int32)
        parts.append(a)
    return jnp.concatenate(parts, axis=1)


def _payload_default_row(layout: tuple):
    """[1, K] int32 default row for empty slots (x sentinel spliced later)."""
    vals = []
    for name, w, fill in layout:
        fills = fill if isinstance(fill, tuple) else (fill,) * w
        for v in fills:
            if name in _INT_BLOCKS:
                vals.append(np.int32(v))
            else:
                vals.append(np.float32(v).view(np.int32))
    return jnp.asarray(np.asarray(vals, dtype=np.int32)[None, :])


def _sentinel_x(S, box: Box, spec: "GridSpec"):
    """Far-away x coordinates for empty slots.

    Placed at ``Lx + (slot+1) * (Lx + 2 r_list)`` so that (a) every
    empty-real distance exceeds r_list (given >= 3 cells per axis) and
    (b) every empty-empty distance — even after the periodic roll shift
    of +-Lx — is at least 2 r_list. Empty slots therefore fall outside
    every cutoff with no validity mask, and accumulate exactly zero
    force (no NaN/Inf leakage into real slots).
    """
    Lx = box.L[0]
    stride = Lx + jnp.float32(2.0 * spec.r_list)
    return Lx + (jnp.arange(S, dtype=jnp.float32) + 1.0) * stride


def _state_from_payload(out, layout: tuple, template: State, box: Box) -> State:
    """[S, K] int32 payload -> State via static lane slices (no restacking)."""
    S = out.shape[0]
    arrs = {}
    off = 0
    for name, w, _ in layout:
        a = out[:, off : off + w]
        if name not in _INT_BLOCKS:
            a = a.view(jnp.float32)
        arrs[name] = a[:, 0] if w == 1 else a
        off += w
    mass = arrs.get("mass", None)
    if mass is None:
        mass = jnp.ones((S,), jnp.float32)
    accel = arrs["acceleration"]
    return State(
        position=arrs["position"],
        tag=arrs["tag"],
        velocity=arrs["velocity"],
        typeid=arrs["typeid"],
        image=arrs["image"],
        orientation=arrs.get(
            "orientation",
            jnp.tile(jnp.array([1.0, 0, 0, 0], jnp.float32), (S, 1)),
        ),
        mass=mass,
        diameter=arrs.get("diameter", jnp.ones((S,), jnp.float32)),
        charge=arrs.get("charge", jnp.zeros((S,), jnp.float32)),
        net_force=accel * mass[:, None],
        acceleration=accel,
        angmom=arrs.get("angmom", jnp.zeros((S, 4), jnp.float32)),
        moment_inertia=arrs.get("moment_inertia", jnp.zeros((S, 3), jnp.float32)),
        net_torque=arrs.get("net_torque", jnp.zeros((S, 3), jnp.float32)),
        bond_typeid=template.bond_typeid,
        bond_group=template.bond_group,
        box=box,
    )


def _global_assembly(packed_in, cid, n, spec: "GridSpec", layout: tuple,
                     n_valid: int | None = None):
    """Full fused-key sort of all n rows -> ([S, K] payload, valid, overflow).

    Sort a narrow key, then one contiguous row-gather of the packed
    payload: sort compile time grows quickly with the operand count,
    while a row-major gather of [n, K] compiles fast and runs at copy
    speed. When the combined (cid, idx) key fits int32 a single fused key
    replaces the two-operand sort.

    ``n_valid`` is a static upper bound on the number of VALID rows
    (rows with cid < C). Invalid rows carry cid == C and sort to the
    tail, so the sorted-payload gather only needs the first ``n_valid``
    rows — at rebin time (n == S, valid count == N particles) this cuts
    the first [*, K] row gather from S to N rows (~42% fewer rows at the
    64k bench shapes). If the bound is ever violated the overflow flag trips (the
    caller grows and replays), so truncation can never silently corrupt.
    """
    C = spec.n_cells
    cap = spec.cap
    S = spec.S
    idx = jnp.arange(n, dtype=jnp.int32)
    # bit-packed fused key: cid in the high bits, row index low. Shift/mask
    # recovery is exact integer math, with no integer division that a
    # backend could lower through f32 (which can round off by one near
    # exact multiples, scattering particles into the wrong cell).
    idx_bits = max(1, (n - 1).bit_length())
    use_fused = os.environ.get("AZTPU_FUSED_KEY", "1") != "0"
    if use_fused and (C + 1) << idx_bits < 2**31:
        key = (cid << jnp.int32(idx_bits)) | idx
        key_s = jax.lax.sort(key)
        cid_s = key_s >> jnp.int32(idx_bits)
        perm = key_s & jnp.int32((1 << idx_bits) - 1)
    else:
        cid_s, perm = jax.lax.sort([cid, idx], num_keys=1, is_stable=True)

    head = n if n_valid is None else min(n, n_valid)

    # per-cell start offsets in the sorted order (default scan method;
    # the choice against method="sort" is not yet measured on the H100,
    # ROADMAP 1.3)
    start = jnp.searchsorted(cid_s, jnp.arange(C + 1, dtype=jnp.int32))
    start = start.astype(jnp.int32)
    counts = start[1:] - start[:-1]  # [C]
    # start[C] = total valid rows; > head would truncate real particles
    overflow = jnp.any(counts > cap) | (start[C] > head)
    # exact max occupancy: on overflow the caller can size the grown cap
    # in ONE jump instead of walking 1.25x rungs (one chunk recompile per
    # rung — Simulation._grow_and_rebuild)
    max_occ = jnp.max(counts)

    # slot-side source rows: slot (c, r) <- sorted row start[c] + r
    rank_b = jax.lax.broadcasted_iota(jnp.int32, (C, cap), 1)
    src = start[:C, None] + rank_b
    valid_slot = rank_b < jnp.minimum(counts, cap)[:, None]
    src = jnp.where(valid_slot, src, head).reshape(S)  # head = default row

    default_row = _payload_default_row(layout)
    if os.environ.get("AZTPU_REBIN_COMPOSED", "0") == "1":
        # composed-index form: one narrow [S] gather composes the sort
        # permutation with the slot map, so the payload moves through ONE
        # [S, K] row gather instead of two (perm then src). Off by
        # default; kept as a tested ablation until measured on the H100
        # (ROADMAP 3.3).
        perm_pad = jnp.concatenate([perm[:head], jnp.full((1,), n, jnp.int32)])
        src_in = jnp.take(perm_pad, src)  # [S] narrow index gather
        packed_pad = jnp.concatenate([packed_in, default_row], axis=0)
        out = jnp.take(packed_pad, src_in, axis=0)
        return out, valid_slot.reshape(S), overflow, max_occ
    packed_sorted = jnp.take(packed_in, perm[:head], axis=0)
    packed_pad = jnp.concatenate([packed_sorted, default_row], axis=0)
    out = jnp.take(packed_pad, src, axis=0)  # [S, K] row gather
    return out, valid_slot.reshape(S), overflow, max_occ


def _incremental_ok(spec: "GridSpec") -> bool:
    """Static eligibility of the incremental rebin for this grid shape."""
    if os.environ.get("AZTPU_INCREMENTAL_REBIN", "0") != "1":
        return False
    S = spec.S
    C = spec.n_cells
    sbits = max(1, (S - 1).bit_length())
    # the migrant key (cid << sbits) | prev_slot and the per-cell key
    # (prev_slot) must stay below the 2^30 invalid-marker band
    return S < 2**30 and (C << sbits) < 2**30


def _incremental_assembly(packed, cid, valid, spec: "GridSpec", layout: tuple,
                          n_valid: int | None = None):
    """Migrant-local rebin: per-cell lane sort + migrant-only global sort.

    Between rebuilds most particles stay in their cell, and the slot
    layout the global rebin produces orders each cell's members by INPUT
    SLOT INDEX (the fused key's low bits). Stays already sit in that
    order, so only the boundary-crossers ("migrants", typically ~10% at
    production drift) need a global sort; each cell then merges its stays
    with its arrivals by one sort along the lane axis of [C, cap + Mc]
    with the key prev_slot*128 + src_ptr — a ~3-8x smaller sort volume
    than the S-row global sort. The result is BITWISE identical to
    ``_global_assembly``: same membership, same order, same overflow
    truncation (both keep the cap smallest input rows per cell).

    Falls back to the global sort via ``lax.cond`` when the migrant
    buffer (S // 4) or any per-cell arrival run (Mc) would overflow —
    correctness never depends on the capacity heuristics.
    """
    S = spec.S
    C = spec.n_cells
    cap = spec.cap
    Mc = min(int(os.environ.get("AZTPU_REBIN_MC", "16")), cap)
    Mbuf = max(1024, S // 4)
    sbits = max(1, (S - 1).bit_length())
    BIG = jnp.int32(1 << 30)

    cell_of = jax.lax.broadcasted_iota(jnp.int32, (C, cap), 0).reshape(S)
    stay = valid & (cid == cell_of)
    mig = valid & ~stay  # valid rows always have cid < C

    # pack migrants by global rank (gather-only: the j-th migrant's row is
    # found by binary search on the inclusive cumsum — no row scatter)
    cum = jnp.cumsum(mig.astype(jnp.int32))
    n_mig = cum[S - 1]
    j = jnp.arange(Mbuf, dtype=jnp.int32)
    srcj = jnp.searchsorted(cum, j + 1, side="left").astype(jnp.int32)
    jvalid = j < n_mig
    srcj = jnp.where(jvalid, srcj, S)
    cid_pad = jnp.concatenate([cid, jnp.full((1,), C, jnp.int32)])
    cidj = jnp.take(cid_pad, srcj)
    keyj = jnp.where(jvalid, (cidj << sbits) | srcj, BIG + j)
    keys_sorted = jax.lax.sort(keyj)  # by (dest cell, input slot)
    prevj = keys_sorted & jnp.int32((1 << sbits) - 1)
    start_m = jnp.searchsorted(
        keys_sorted, jnp.arange(C + 1, dtype=jnp.int32) << sbits
    ).astype(jnp.int32)
    cnt_m = start_m[1:] - start_m[:-1]  # arrivals per destination cell
    ok = (n_mig <= Mbuf) & (jnp.max(cnt_m) <= Mc)

    default_row = _payload_default_row(layout)
    packed_pad = jnp.concatenate([packed, default_row], axis=0)

    def incr(_):
        # deliver each cell's arrival run into [C, Mc] lanes (row gather)
        jj = jax.lax.broadcasted_iota(jnp.int32, (C, Mc), 1)
        didx = start_m[:C, None] + jj
        dvalid = jj < jnp.minimum(cnt_m, Mc)[:, None]
        prev_pad = jnp.concatenate([prevj, jnp.zeros((1,), jnp.int32)])
        dprev = jnp.take(prev_pad, jnp.where(dvalid, didx, Mbuf))

        # one lane-axis sort per cell over stays + arrivals, keyed on the
        # input slot index (the global fused key restricted to the cell).
        # The key IS the source row: a stay's own slot and an arrival's
        # previous slot are unique across the row (an arrival's previous
        # slot lies in a different cell's slot range)
        lane = jax.lax.broadcasted_iota(jnp.int32, (C, cap), 1)
        slotidx = jnp.arange(S, dtype=jnp.int32).reshape(C, cap)
        stay2 = stay.reshape(C, cap)
        korig = jnp.where(stay2, slotidx, BIG + lane)
        kdel = jnp.where(dvalid, dprev, BIG + cap + jj)
        rows = jnp.concatenate([korig, kdel], axis=1)  # [C, cap + Mc]
        rows_s = jax.lax.sort(rows, dimension=1)
        head = rows_s[:, :cap]
        isreal = head < BIG
        src = jnp.where(isreal, head, S).reshape(S)
        out = jnp.take(packed_pad, src, axis=0)
        # a real member pushed past cap = the cell overflowed (same
        # truncation the global path applies: cap smallest input rows win)
        ovf = jnp.any(rows_s[:, cap:] < BIG)
        # exact per-cell need: stays + arrivals (cnt_m <= Mc inside incr)
        max_occ = jnp.max(jnp.sum(stay2.astype(jnp.int32), axis=1) + cnt_m)
        return out, isreal.reshape(S), ovf, max_occ

    def glob(_):
        return _global_assembly(packed, cid, S, spec, layout, n_valid)

    return jax.lax.cond(ok, incr, glob, None)


def _bin_to_slots(
    state: State, spec: GridSpec, N_tags: int, fields: tuple,
    need_slot_of: bool = True, incremental: bool = False,
):
    """Core binning: any-order state (n rows) -> slot-order state (S rows).

    Positions are wrapped into the box here (and only here): between
    rebuilds the integrators leave positions unwrapped so that the
    pre-shifted stencil coordinates (make_jblocks) subtract exactly.

    Gather-only dataflow: after the key sort, slot contents are produced
    by a ROW GATHER from the sorted payload (for slot (c, r): row
    ``start[c] + r``, valid while ``r < count[c]``). The gather side
    needs no rank-in-cell at all because the slot grid enumerates ranks
    implicitly, and it writes every slot exactly once (no scatter).
    """
    n = state.N
    S = spec.S
    C = spec.n_cells
    cap = spec.cap
    valid = state.tag >= 0
    pos_w, image_w = state.box.wrap(state.position, state.image)
    state = state.replace(position=pos_w, image=image_w)
    cid = _cell_id(
        state.position[:, 0], state.position[:, 1], state.position[:, 2],
        state.box, spec.dims,
    )
    cid = jnp.where(valid, cid, C)

    layout = _payload_layout(fields)
    packed_in = _pack_payload(state, layout)  # [n, K] int32 (floats bitcast)
    if incremental and n == S and _incremental_ok(spec):
        # slot-ordered input (rebin): migrant-local path, bitwise-equal
        out, valid_slot, overflow, max_occ = _incremental_assembly(
            packed_in, cid, valid, spec, layout, N_tags
        )
    else:
        out, valid_slot, overflow, max_occ = _global_assembly(
            packed_in, cid, n, spec, layout, N_tags
        )

    # empty-slot x sentinels are per-slot values (the single default row
    # cannot carry them); splice them into the x column (payload column 0)
    x = jnp.where(
        valid_slot,
        out[:, 0].view(jnp.float32),
        _sentinel_x(S, state.box, spec),
    )
    out = jnp.concatenate([x.view(jnp.int32)[:, None], out[:, 1:]], axis=1)

    dense = _state_from_payload(out, layout, state, state.box)
    if need_slot_of:
        # tag -> slot map (scatter; empty tags dropped via clipped index);
        # only bond forces consume this — skipped entirely otherwise
        tags = dense.tag
        slot_of = jnp.full((N_tags,), 0, jnp.int32)
        slot_of = slot_of.at[jnp.where(tags >= 0, tags, N_tags)].set(
            jnp.arange(S, dtype=jnp.int32), mode="drop"
        )
    else:
        slot_of = jnp.zeros((0,), jnp.int32)
    meta = GridMeta(
        ref_position=dense.position,
        slot_of=slot_of,
        overflow=overflow,
        n_builds=jnp.int32(1),
        max_occ=max_occ,
    )
    return dense, meta


def densify(state: State, spec: GridSpec, fields: tuple = ALL_FIELDS,
            need_slot_of: bool = True):
    """User (tag) order -> slot order. state must have N == number of tags."""
    return _bin_to_slots(state, spec, state.N, fields, need_slot_of)


def rebin(dense: State, meta: GridMeta, spec: GridSpec, N_tags: int,
          fields: tuple = ALL_FIELDS, need_slot_of: bool = True):
    new_dense, new_meta = _bin_to_slots(
        dense, spec, N_tags, fields, need_slot_of, incremental=True
    )
    new_meta = new_meta.replace(
        overflow=new_meta.overflow | meta.overflow,
        n_builds=meta.n_builds + 1,
        max_occ=jnp.maximum(new_meta.max_occ, meta.max_occ),
    )
    return new_dense, new_meta


def undensify(dense: State, N: int, fields: tuple = ALL_FIELDS) -> State:
    """Slot order -> user (tag) order via one packed row scatter.

    Positions come back wrapped into the box (the slot-order state may
    carry up to half a Verlet margin of unwrapped drift).
    """
    pos_w, image_w = dense.box.wrap(dense.position, dense.image)
    dense = dense.replace(position=pos_w, image=image_w)
    layout = _payload_layout(fields)
    packed = _pack_payload(dense, layout)  # [S, K] int32
    dest = jnp.where(dense.tag >= 0, dense.tag, N)
    out = jnp.zeros((N + 1, packed.shape[1]), jnp.int32).at[dest].set(
        packed, mode="drop"
    )[:N]
    return _state_from_payload(out, layout, dense, dense.box)


def needs_rebin(dense: State, meta: GridMeta, spec: GridSpec):
    """Exact pair-drift rebuild criterion.

    A pair binned within the stencil stays covered while
    ``drift_i + drift_j <= buffer`` (the claimed Verlet margin). The
    worst pair is the two largest single-particle drifts, so the check
    is ``max1 + max2 > buffer`` — roughly twice the usable margin of the
    conservative ``2 * max1`` form when the drift distribution has a
    lone fast tail. Positions drift unwrapped between rebuilds, so the
    displacement is a direct difference (no minimum-image math).
    """
    d = dense.position - meta.ref_position
    dispsq = jnp.sum(d * d, axis=-1)
    dispsq = jnp.where(dense.tag >= 0, dispsq, 0.0)
    m1 = jnp.max(dispsq)
    tied = jnp.sum((dispsq == m1).astype(jnp.int32)) > 1
    m2 = jnp.where(
        tied, m1, jnp.max(jnp.where(dispsq == m1, -jnp.inf, dispsq))
    )
    m2 = jnp.maximum(m2, 0.0)
    return jnp.sqrt(m1) + jnp.sqrt(m2) > jnp.float32(spec.buffer)


# ---------------------------------------------------------------------------
# Stencil J-blocks (rolled neighbor data, shared across pair potentials)
# ---------------------------------------------------------------------------
@pytree_dataclass
class JBlocks:
    """Rolled stencil data: per-component [n_stencil, n_cells, cap] arrays.

    Stacked (not concatenated) so the force pass can ``lax.scan`` over the
    stencil axis: one traced offset body instead of 27 unrolled copies,
    keeping fusions at [n_cells, cap, cap] and compile times flat in N.

    Coordinates are **pre-shifted**: rolls that wrap around the periodic
    box carry the lattice-vector shift folded in per cell, so ``xi - jx``
    is the true separation with no per-pair minimum-image math in the
    pair hot loop. Empty slots sit at far sentinel x
    (see _sentinel_x), outside every cutoff.
    """

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    typeid: jnp.ndarray | None = None  # int32 (-1 empty); built when needed
    tag: jnp.ndarray | None = None  # int32 (DPD RNG)
    vx: jnp.ndarray | None = None
    vy: jnp.ndarray | None = None
    vz: jnp.ndarray | None = None
    qw: jnp.ndarray | None = None
    qx: jnp.ndarray | None = None
    qy: jnp.ndarray | None = None
    qz: jnp.ndarray | None = None
    half: bool = static_field(default=False)  # built from half_stencil()
    # True when every axis has >= 3 cells so each (cell, offset) pair maps
    # to exactly one periodic image and the roll shift is folded into the
    # coordinates. With < 3 cells an offset aliases both images and the
    # kernels must keep per-pair minimum-image math.
    preshifted: bool = static_field(default=True)


def _halo_pad(g, axis, shift_hi):
    """Wrap-pad one cell-grid axis with its periodic images.

    Prepends the last cell (shifted by ``-shift_hi``) and appends the
    first cell (shifted by ``+shift_hi``) so that every +-1 stencil
    offset becomes a *static slice* of the padded grid. ``shift_hi`` is
    the lattice-vector component added when crossing the axis upward
    (0 for non-coordinate payloads). Sequential padding of the three
    axes composes corner shifts exactly (n1*a1 + n2*a2 + n3*a3).

    One pad serves every offset: pad+slice lowers to a concatenate plus
    static slices, with less copying than one ``jnp.roll`` per offset.
    """
    D = g.shape[axis]
    lo = jax.lax.slice_in_dim(g, D - 1, D, axis=axis)
    hi = jax.lax.slice_in_dim(g, 0, 1, axis=axis)
    if shift_hi is not None:
        lo = lo - shift_hi
        hi = hi + shift_hi
    return jnp.concatenate([lo, g, hi], axis=axis)


def _roll_concat(arr, spec: GridSpec, offsets: np.ndarray, axis_shifts=None):
    """[S] -> [n_stencil, n_cells, cap]: occupants of every stencil cell.

    ``axis_shifts``: optional per-axis scalar lattice shifts for this
    coordinate component (see _halo_pad); None for non-coordinate data.
    """
    Dx, Dy, Dz = spec.dims
    g = arr.reshape(Dx, Dy, Dz, spec.cap)
    for ax in range(3):
        s = axis_shifts[ax] if axis_shifts is not None else None
        g = _halo_pad(g, ax, s)
    blocks = []
    for o in offsets:
        o0, o1, o2 = int(o[0]) + 1, int(o[1]) + 1, int(o[2]) + 1
        blocks.append(
            jax.lax.slice(
                g,
                (o0, o1, o2, 0),
                (o0 + Dx, o1 + Dy, o2 + Dz, spec.cap),
            )
        )
    return jnp.stack(blocks, axis=0).reshape(len(blocks), spec.n_cells, spec.cap)


def _axis_shift_tables(box: Box):
    """Per-component, per-axis lattice shift scalars for the halo pad.

    Lattice vectors follow the HOOMD triclinic convention: a1=(Lx,0,0),
    a2=(xy*Ly, Ly, 0), a3=(xz*Lz, yz*Lz, Lz). Crossing grid axis a in
    the + direction adds a_{a+1}; the halo pad applies the sign.
    """
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    sx = (Lx, xy * Ly, xz * Lz)
    sy = (None, Ly, yz * Lz)
    sz = (None, None, Lz)
    return sx, sy, sz


def _roll_cells(a, spec: GridSpec, shift):
    """``jnp.roll(a, +shift, axes=(0,1,2))`` via wrap-pad + static slice.

    Used to un-roll Newton j-side accumulators back to their true cells.
    ``a``: [Dx, Dy, Dz, ...]; shift: length-3 ints in {-1, 0, 1}.
    """
    Dx, Dy, Dz = spec.dims
    g = a
    for ax in range(3):
        g = _halo_pad(g, ax, None)
    s = tuple(1 - int(shift[k]) for k in range(3))
    starts = s + (0,) * (a.ndim - 3)
    limits = (s[0] + Dx, s[1] + Dy, s[2] + Dz) + a.shape[3:]
    return jax.lax.slice(g, starts, limits)


def make_jblocks(
    dense: State,
    spec: GridSpec,
    need_velocity: bool = False,
    need_tag: bool = False,
    need_quat: bool = False,
    half: bool = False,
    need_typeid: bool = True,
) -> JBlocks:
    offsets = spec.half_stencil() if half else spec.stencil()
    preshifted = spec.newton_ok  # every axis >= 3 cells
    if preshifted:
        sx, sy, sz = _axis_shift_tables(dense.box)
    else:
        sx = sy = sz = None
    kw = dict(
        x=_roll_concat(dense.position[:, 0], spec, offsets, sx),
        y=_roll_concat(dense.position[:, 1], spec, offsets, sy),
        z=_roll_concat(dense.position[:, 2], spec, offsets, sz),
        half=half,
        preshifted=preshifted,
    )
    if need_typeid:
        kw["typeid"] = _roll_concat(dense.typeid, spec, offsets)
    if need_tag:
        kw["tag"] = _roll_concat(dense.tag, spec, offsets)
    if need_velocity:
        kw["vx"] = _roll_concat(dense.velocity[:, 0], spec, offsets)
        kw["vy"] = _roll_concat(dense.velocity[:, 1], spec, offsets)
        kw["vz"] = _roll_concat(dense.velocity[:, 2], spec, offsets)
    if need_quat:
        kw["qw"] = _roll_concat(dense.orientation[:, 0], spec, offsets)
        kw["qx"] = _roll_concat(dense.orientation[:, 1], spec, offsets)
        kw["qy"] = _roll_concat(dense.orientation[:, 2], spec, offsets)
        kw["qz"] = _roll_concat(dense.orientation[:, 3], spec, offsets)
    return JBlocks(**kw)


# ---------------------------------------------------------------------------
# Per-pair parameters without gathers
# ---------------------------------------------------------------------------
def _pair_params(tables: dict, t_i, t_j, T: int):
    """Per-pair parameter values via one-hot contraction (T is small).

    t_i: [n_cells, cap, 1] int32 (may be -1); t_j: [n_cells, 1, J] int32.
    For T == 1 the parameters are scalars (zero per-pair cost).
    """
    if T == 1:
        return {k: v.reshape(()) for k, v in tables.items()}
    out = {}
    # one-hot planes; -1 (empty) matches nothing -> param 0, masked anyway
    oi = [(t_i == a).astype(jnp.float32) for a in range(T)]
    oj = [(t_j == b).astype(jnp.float32) for b in range(T)]
    for key, tab in tables.items():
        acc = 0.0
        for a in range(T):
            row = 0.0
            for b in range(T):
                row = row + tab[a, b] * oj[b]
            acc = acc + oi[a] * row
        out[key] = acc
    return out


def _i_views(dense: State, spec: GridSpec):
    """Per-slot i-side data reshaped to [n_cells, cap, 1]."""
    C, cap = spec.n_cells, spec.cap

    def v(a):
        return a.reshape(C, cap, 1)

    return v


def _offset_geometry(dense, spec, xi, yi, zi, valid_i, js, masked, preshifted=True):
    """Geometry + base mask for one (full-stencil) offset. All [C,cap,cap].

    j coordinates are pre-shifted (make_jblocks), so the difference is the
    true separation — no minimum-image. Self pairs (the (0,0,0) offset)
    are excluded by rsq > 0. With ``masked=False`` (orthorhombic boxes)
    empty slots are excluded purely by their far sentinel positions; with
    ``masked=True`` (tilted boxes) explicit validity masks are kept.
    """
    jx, jy, jz = js["x"], js["y"], js["z"]
    dx = xi - jx[:, None, :]
    dy = yi - jy[:, None, :]
    dz = zi - jz[:, None, :]
    if not preshifted:
        dx, dy, dz = dense.box.min_image_components(dx, dy, dz)
    rsq = dx * dx + dy * dy + dz * dz
    mask = rsq > 0
    if masked:
        mask = mask & valid_i & (js["typeid"] >= 0)[:, None, :]
    return dx, dy, dz, rsq, mask


def _scan_stencil(body, jb: JBlocks, spec: GridSpec, n_out: int, extra_keys=()):
    """lax.scan ``body`` over the stencil axis of the J blocks.

    ``body(carry, js)`` receives one offset's j-data dict ([C, cap] arrays)
    and returns the updated carry: a tuple of ``n_out`` [C, cap] f32
    accumulators. Scanning (instead of unrolling 27 offsets) keeps the
    compiled program size and XLA compile time independent of the stencil.
    """
    C, cap = spec.n_cells, spec.cap
    js_all = {"x": jb.x, "y": jb.y, "z": jb.z}
    if jb.typeid is not None:
        js_all["typeid"] = jb.typeid
    for k in extra_keys:
        js_all[k] = getattr(jb, k)
    carry0 = tuple(jnp.zeros((C, cap), jnp.float32) for _ in range(n_out))
    carry, _ = jax.lax.scan(lambda c, js: (body(c, js), None), carry0, js_all)
    return carry


def _n_acc(want: str) -> int:
    """Number of i-side accumulators: force 3, +energy 1, +virial 6.

    The hot loop requests ``want="force"``: energy/virial reductions over
    the [C, cap, cap] pair tensors are ~2/3 of the reduction work and the
    integrator never reads them (they are recomputed on demand by the
    observable path). XLA cannot DCE them once they pass through the scan's
    stacked outputs, so selection must happen at trace time.
    """
    return {"force": 3, "all": 10}[want]


def _pair_accumulate(carry, dx, dy, dz, e, f_divr, mask, want="all"):
    """Add one offset's masked contributions to (fx, fy, fz[, en, v0..v5])."""
    f_divr = jnp.where(mask, f_divr, 0.0)
    out = [
        carry[0] + jnp.sum(f_divr * dx, axis=-1),
        carry[1] + jnp.sum(f_divr * dy, axis=-1),
        carry[2] + jnp.sum(f_divr * dz, axis=-1),
    ]
    if want == "all":
        e = jnp.where(mask, e, 0.0)
        w = 0.5 * f_divr
        out += [
            carry[3] + 0.5 * jnp.sum(e, axis=-1),
            carry[4] + jnp.sum(w * dx * dx, axis=-1),
            carry[5] + jnp.sum(w * dx * dy, axis=-1),
            carry[6] + jnp.sum(w * dx * dz, axis=-1),
            carry[7] + jnp.sum(w * dy * dy, axis=-1),
            carry[8] + jnp.sum(w * dy * dz, axis=-1),
            carry[9] + jnp.sum(w * dz * dz, axis=-1),
        ]
    return tuple(out)


def _finish_pair(carry, S):
    from .pair_force import ForceResult

    parts = tuple(a.reshape(S) for a in carry)
    force = jnp.stack(parts[:3], axis=-1)
    if len(parts) == 3:
        return ForceResult(force=force, energy=None, virial=None)
    return ForceResult(
        force=force,
        energy=parts[3],
        virial=jnp.stack(parts[4:10], axis=-1),
    )


def _eval_pair_mode(
    energy_force_fn, rsq, rcut, rcutsq, p, mode, r_on=None
):
    """Evaluate one pair batch with HOOMD shift-mode semantics.

    Evaluators must be finite for any rsq > 0 beyond their cutoff (NaN is
    tolerated only under lanes the caller masks out — jnp.where selects,
    so masked NaN never propagates)."""
    from .pair_force import _xplor_smooth

    e, f = energy_force_fn(rsq, rcutsq, p)
    if mode == "shift":
        e_cut, _ = energy_force_fn(rcutsq, rcutsq, p)
        e = e - e_cut
    elif mode == "xplor":
        r_onsq = r_on * r_on
        smooth = r_on < rcut
        e_s, f_s = _xplor_smooth(e, f, rsq, rcutsq, r_onsq)
        e_cut, _ = energy_force_fn(rcutsq, rcutsq, p)
        e = jnp.where(smooth, e_s, e - e_cut)
        f = jnp.where(smooth, f_s, f)
    elif mode != "none":
        raise ValueError(f"unknown shift mode {mode!r}")
    return e, f


def dense_pair_force(
    energy_force_fn,
    dense: State,
    jb: JBlocks,
    spec: GridSpec,
    tables: dict,
    r_cut_table,
    r_on_table=None,
    mode: str = "none",
    want: str = "all",
    masked: bool = True,
):
    """Isotropic pair potential over the dense stencil. Returns ForceResult.

    ``masked=False`` is the orthorhombic fast path: empty slots are
    excluded by sentinel positions alone (see _sentinel_x), saving the
    validity compares and the typeid roll in the hot loop.
    """
    T = r_cut_table.shape[0]
    v = _i_views(dense, spec)
    xi, yi, zi = v(dense.position[:, 0]), v(dense.position[:, 1]), v(dense.position[:, 2])
    need_t = masked or T > 1
    t_i = v(dense.typeid) if need_t else None
    valid_i = v(dense.tag >= 0) if masked else None

    def eval_batch(rsq, mask, t_j):
        p = _pair_params(tables, t_i, t_j, T)
        rcut = _pair_params({"r": r_cut_table}, t_i, t_j, T)["r"]
        rcutsq = rcut * rcut
        mask = mask & (rsq < rcutsq)
        r_on = (
            _pair_params({"r": r_on_table}, t_i, t_j, T)["r"]
            if mode == "xplor"
            else None
        )
        e, f = _eval_pair_mode(energy_force_fn, rsq, rcut, rcutsq, p, mode, r_on)
        return e, f, mask

    def t_of(js):
        return js["typeid"][:, None, :] if need_t else None

    if not jb.half:
        def body(carry, js):
            dx, dy, dz, rsq, mask = _offset_geometry(
                dense, spec, xi, yi, zi, valid_i, js, masked, jb.preshifted
            )
            e, f, mask = eval_batch(rsq, mask, t_of(js))
            return _pair_accumulate(carry, dx, dy, dz, e, f, mask, want)

        carry = _scan_stencil(body, jb, spec, n_out=_n_acc(want))
        return _finish_pair(carry, spec.S)

    # Newton half-stencil: each unordered pair is evaluated once and the
    # force/energy/virial are scattered to both members (the j side in the
    # rolled frame, un-rolled with the positive offset after the scan).
    C, cap = spec.n_cells, spec.cap
    Dx, Dy, Dz = spec.dims
    offsets = spec.half_stencil()

    def jside(e, f, mask, dx, dy, dz):
        fm = jnp.where(mask, f, 0.0)
        cols = [
            -jnp.sum(fm * dx, axis=1),
            -jnp.sum(fm * dy, axis=1),
            -jnp.sum(fm * dz, axis=1),
        ]
        if want == "all":
            em = jnp.where(mask, e, 0.0)
            w = 0.5 * fm
            cols += [
                0.5 * jnp.sum(em, axis=1),
                jnp.sum(w * dx * dx, axis=1),
                jnp.sum(w * dx * dy, axis=1),
                jnp.sum(w * dx * dz, axis=1),
                jnp.sum(w * dy * dy, axis=1),
                jnp.sum(w * dy * dz, axis=1),
                jnp.sum(w * dz * dz, axis=1),
            ]
        return jnp.stack(cols, axis=-1)  # [C, cap, n_acc]

    def body(carry, js):
        jx, jy, jz = js["x"], js["y"], js["z"]
        dx = xi - jx[:, None, :]
        dy = yi - jy[:, None, :]
        dz = zi - jz[:, None, :]
        rsq = dx * dx + dy * dy + dz * dz
        if masked:
            mask = valid_i & (js["typeid"] >= 0)[:, None, :]
        else:
            mask = True
        e, f, mask = eval_batch(rsq, mask, t_of(js))
        carry = _pair_accumulate(carry, dx, dy, dz, e, f, mask, want)
        return carry, jside(e, f, mask, dx, dy, dz)

    n_acc = _n_acc(want)
    js_all = {"x": jb.x, "y": jb.y, "z": jb.z}
    if jb.typeid is not None:
        js_all["typeid"] = jb.typeid
    carry0 = tuple(jnp.zeros((C, cap), jnp.float32) for _ in range(n_acc))
    carry, ys = jax.lax.scan(body, carry0, js_all)

    # self-cell, strict upper triangle (i < j within the cell)
    xj0 = dense.position[:, 0].reshape(C, 1, cap)
    yj0 = dense.position[:, 1].reshape(C, 1, cap)
    zj0 = dense.position[:, 2].reshape(C, 1, cap)
    tri = (
        jnp.arange(cap, dtype=jnp.int32)[None, None, :]
        > jnp.arange(cap, dtype=jnp.int32)[None, :, None]
    )
    dx = xi - xj0
    dy = yi - yj0
    dz = zi - zj0
    rsq = dx * dx + dy * dy + dz * dz
    if masked:
        validj0 = (dense.tag >= 0).reshape(C, 1, cap)
        mask0 = valid_i & validj0 & tri
    else:
        mask0 = tri
    tj0 = dense.typeid.reshape(C, 1, cap) if need_t else None
    e, f, mask0 = eval_batch(rsq, mask0, tj0)
    carry = _pair_accumulate(carry, dx, dy, dz, e, f, mask0, want)
    jacc = jside(e, f, mask0, dx, dy, dz)  # same-cell: no roll-back needed

    # un-roll the per-offset j-side sums back to their true cells
    g = ys.reshape(len(offsets), Dx, Dy, Dz, cap, n_acc)
    for k, o in enumerate(offsets):
        jacc = jacc + _roll_cells(g[k], spec, o).reshape(C, cap, n_acc)

    total = tuple(carry[i] + jacc[..., i] for i in range(n_acc))
    return _finish_pair(total, spec.S)


def dense_dpd_force(
    dense: State,
    jb: JBlocks,
    spec: GridSpec,
    tables: dict,
    r_cut_table,
    kT,
    dt,
    seed: int,
    timestep,
    want: str = "all",
    masked: bool = True,
):
    """DPD general-weight thermostat over the dense stencil.

    Physics identical to ops/pair_force.dpd_pair_force (reference
    DPDPairEvaluatorGeneralWeight.h:198-255); noise keyed on sorted true
    tags so it is bitwise identical to the neighbor-list driver and
    independent of the stencil form. With ``jb.half`` each unordered pair
    is evaluated ONCE and scattered to both members — Newton's third law
    holds exactly for the full DPD triple (rdotv, w_R and the sorted-tag
    noise are all i<->j symmetric), halving the dominant per-pair
    Threefry cost (SURVEY §7 hard part #3). Virial is conservative-only
    per the reference (:239).
    """
    from .pair_force import ForceResult

    T = r_cut_table.shape[0]
    v = _i_views(dense, spec)
    xi, yi, zi = v(dense.position[:, 0]), v(dense.position[:, 1]), v(dense.position[:, 2])
    vxi, vyi, vzi = v(dense.velocity[:, 0]), v(dense.velocity[:, 1]), v(dense.velocity[:, 2])
    need_t = masked or T > 1
    t_i = v(dense.typeid) if need_t else None
    tag_i = v(dense.tag)
    valid_i = v(dense.tag >= 0) if masked else None
    kT = jnp.float32(kT)
    dt_arr = jnp.float32(dt)
    n_acc = 3 if want == "force" else 10

    def eval_dpd(dx, dy, dz, rsq, mask, t_j, tag_j, dvx, dvy, dvz):
        """(e, f_total/r, f_cons/r, mask) for one pair batch."""
        p = _pair_params(tables, t_i, t_j, T)
        rcut = _pair_params({"r": r_cut_table}, t_i, t_j, T)["r"]
        rcutsq = rcut * rcut
        mask = mask & (rsq < rcutsq)
        rsq_safe = jnp.where(mask, rsq, 1.0)
        rcut_safe = jnp.where(rcut > 0, rcut, 2.0)

        rinv = 1.0 / jnp.sqrt(rsq_safe)
        r = rsq_safe * rinv
        rcutinv = 1.0 / rcut_safe
        f_cons = p["A"] * (rinv - rcutinv)
        e = p["A"] * (rcut_safe - r) - 0.5 * p["A"] * rcutinv * (rcutsq - rsq_safe)

        rdotv = dx * dvx + dy * dvy + dz * dvz
        w_R = jnp.maximum(1.0 - r * rcutinv, 0.0) ** (0.5 * p["s"]) * rinv
        f_drag = -p["gamma"] * w_R * w_R * rdotv

        alpha = _rng.pair_uniform(
            _rng.Stream.DPD_GENERAL_WEIGHT, seed, timestep, tag_i, tag_j,
            rounds=_rng.FAST_ROUNDS,
        )
        sigma_coeff = jnp.where(
            dt_arr > 0, jnp.sqrt(6.0 * p["gamma"] * kT / jnp.maximum(dt_arr, 1e-20)), 0.0
        )
        f_rand = sigma_coeff * w_R * alpha
        return e, f_cons + f_drag + f_rand, f_cons, mask

    def iacc(carry, e, f_tot, f_cons, mask, dx, dy, dz):
        fm = jnp.where(mask, f_tot, 0.0)
        out = [
            carry[0] + jnp.sum(fm * dx, axis=-1),
            carry[1] + jnp.sum(fm * dy, axis=-1),
            carry[2] + jnp.sum(fm * dz, axis=-1),
        ]
        if want != "force":
            em = jnp.where(mask, e, 0.0)
            w = 0.5 * jnp.where(mask, f_cons, 0.0)
            out += [
                carry[3] + 0.5 * jnp.sum(em, axis=-1),
                carry[4] + jnp.sum(w * dx * dx, axis=-1),
                carry[5] + jnp.sum(w * dx * dy, axis=-1),
                carry[6] + jnp.sum(w * dx * dz, axis=-1),
                carry[7] + jnp.sum(w * dy * dy, axis=-1),
                carry[8] + jnp.sum(w * dy * dz, axis=-1),
                carry[9] + jnp.sum(w * dz * dz, axis=-1),
            ]
        return tuple(out)

    def finish(carry):
        parts = tuple(a.reshape(spec.S) for a in carry)
        force = jnp.stack(parts[:3], axis=-1)
        if want == "force":
            return ForceResult(force=force, energy=None, virial=None)
        return ForceResult(
            force=force, energy=parts[3], virial=jnp.stack(parts[4:10], axis=-1)
        )

    if not jb.half:
        def body(carry, js):
            dx, dy, dz, rsq, mask = _offset_geometry(
                dense, spec, xi, yi, zi, valid_i, js, masked, jb.preshifted
            )
            t_j = js["typeid"][:, None, :] if need_t else None
            e, f_tot, f_cons, mask = eval_dpd(
                dx, dy, dz, rsq, mask, t_j, js["tag"][:, None, :],
                vxi - js["vx"][:, None, :],
                vyi - js["vy"][:, None, :],
                vzi - js["vz"][:, None, :],
            )
            return iacc(carry, e, f_tot, f_cons, mask, dx, dy, dz)

        carry = _scan_stencil(
            body, jb, spec, n_out=n_acc, extra_keys=("vx", "vy", "vz", "tag")
        )
        return finish(carry)

    # Newton half-stencil: evaluate each unordered pair once, scatter the
    # force to both members (j side in the rolled frame, un-rolled after)
    C, cap = spec.n_cells, spec.cap
    Dx, Dy, Dz = spec.dims
    offsets = spec.half_stencil()

    def jside(e, f_tot, f_cons, mask, dx, dy, dz):
        fm = jnp.where(mask, f_tot, 0.0)
        cols = [
            -jnp.sum(fm * dx, axis=1),
            -jnp.sum(fm * dy, axis=1),
            -jnp.sum(fm * dz, axis=1),
        ]
        if want != "force":
            em = jnp.where(mask, e, 0.0)
            w = 0.5 * jnp.where(mask, f_cons, 0.0)
            cols += [
                0.5 * jnp.sum(em, axis=1),
                jnp.sum(w * dx * dx, axis=1),
                jnp.sum(w * dx * dy, axis=1),
                jnp.sum(w * dx * dz, axis=1),
                jnp.sum(w * dy * dy, axis=1),
                jnp.sum(w * dy * dz, axis=1),
                jnp.sum(w * dz * dz, axis=1),
            ]
        return jnp.stack(cols, axis=-1)  # [C, cap, n_acc]

    def body(carry, js):
        dx = xi - js["x"][:, None, :]
        dy = yi - js["y"][:, None, :]
        dz = zi - js["z"][:, None, :]
        rsq = dx * dx + dy * dy + dz * dz
        mask = rsq > 0
        if masked:
            mask = mask & valid_i & (js["typeid"] >= 0)[:, None, :]
        t_j = js["typeid"][:, None, :] if need_t else None
        e, f_tot, f_cons, mask = eval_dpd(
            dx, dy, dz, rsq, mask, t_j, js["tag"][:, None, :],
            vxi - js["vx"][:, None, :],
            vyi - js["vy"][:, None, :],
            vzi - js["vz"][:, None, :],
        )
        carry = iacc(carry, e, f_tot, f_cons, mask, dx, dy, dz)
        return carry, jside(e, f_tot, f_cons, mask, dx, dy, dz)

    js_all = {
        "x": jb.x, "y": jb.y, "z": jb.z,
        "vx": jb.vx, "vy": jb.vy, "vz": jb.vz, "tag": jb.tag,
    }
    if jb.typeid is not None:
        js_all["typeid"] = jb.typeid
    carry0 = tuple(jnp.zeros((C, cap), jnp.float32) for _ in range(n_acc))
    carry, ys = jax.lax.scan(body, carry0, js_all)

    # self-cell, strict upper triangle (i < j within the cell)
    def self_view(a):
        return a.reshape(C, 1, cap)

    dx = xi - self_view(dense.position[:, 0])
    dy = yi - self_view(dense.position[:, 1])
    dz = zi - self_view(dense.position[:, 2])
    rsq = dx * dx + dy * dy + dz * dz
    tri = (
        jnp.arange(cap, dtype=jnp.int32)[None, None, :]
        > jnp.arange(cap, dtype=jnp.int32)[None, :, None]
    )
    mask0 = tri & (rsq > 0)
    if masked:
        mask0 = mask0 & valid_i & (self_view(dense.tag >= 0))
    t_j0 = self_view(dense.typeid) if need_t else None
    e, f_tot, f_cons, mask0 = eval_dpd(
        dx, dy, dz, rsq, mask0, t_j0, self_view(dense.tag),
        vxi - self_view(dense.velocity[:, 0]),
        vyi - self_view(dense.velocity[:, 1]),
        vzi - self_view(dense.velocity[:, 2]),
    )
    carry = iacc(carry, e, f_tot, f_cons, mask0, dx, dy, dz)
    jacc = jside(e, f_tot, f_cons, mask0, dx, dy, dz)

    g = ys.reshape(len(offsets), Dx, Dy, Dz, cap, n_acc)
    for k, o in enumerate(offsets):
        jacc = jacc + _roll_cells(g[k], spec, o).reshape(C, cap, n_acc)
    total = tuple(carry[i] + jacc[..., i] for i in range(n_acc))
    return finish(total)


def dense_aniso_force(
    energy_force_torque_fn,
    dense: State,
    jb: JBlocks,
    spec: GridSpec,
    tables: dict,
    r_cut_table,
    mode: str = "none",
    want: str = "all",
    masked: bool = True,
):
    """Anisotropic pair potential (force + torque) over the dense stencil.

    ``want="force"`` keeps force AND torque (integrators with rotational
    state read both) but drops energy/virial reductions. With ``jb.half``
    each unordered pair is evaluated once: the j member receives ``-f``
    (Newton) and its OWN torque ``tj`` from the evaluator (torques are
    not antisymmetric; the evaluator computes both, reference
    AnisoPairEvaluatorTwoPatchMorse.h:179-192); the virial contribution
    ``0.5 dx f`` is identical for both members (dx and f both flip).
    """
    from .pair_force import ForceResult

    T = r_cut_table.shape[0]
    v = _i_views(dense, spec)
    xi, yi, zi = v(dense.position[:, 0]), v(dense.position[:, 1]), v(dense.position[:, 2])
    need_t = masked or T > 1
    t_i = v(dense.typeid) if need_t else None
    valid_i = v(dense.tag >= 0) if masked else None
    quat_i = tuple(v(dense.orientation[:, k]) for k in range(4))
    n_acc = 6 if want == "force" else 13

    def eval_aniso(dx, dy, dz, rsq, mask, t_j, quat_j):
        """(e, f, ti, tj, mask) for one pair batch; f/ti/tj are 3-tuples."""
        p = _pair_params(tables, t_i, t_j, T)
        rcut = _pair_params({"r": r_cut_table}, t_i, t_j, T)["r"]
        rcutsq = rcut * rcut
        mask = mask & (rsq < rcutsq)
        dx_s = jnp.where(mask, dx, 1.0)
        dy_s = jnp.where(mask, dy, 0.0)
        dz_s = jnp.where(mask, dz, 0.0)
        e, f, ti, tj = energy_force_torque_fn(
            (dx_s, dy_s, dz_s), quat_i, quat_j,
            jnp.where(rcut > 0, rcutsq, 4.0), p, mode == "shift",
        )
        return e, f, ti, tj, mask

    def iacc(carry, e, f, ti, mask, dx, dy, dz):
        def msum(val):
            return jnp.sum(jnp.where(mask, val, 0.0), axis=-1)

        out = [
            carry[0] + msum(f[0]),
            carry[1] + msum(f[1]),
            carry[2] + msum(f[2]),
            carry[3] + msum(ti[0]),
            carry[4] + msum(ti[1]),
            carry[5] + msum(ti[2]),
        ]
        if want == "all":
            out += [
                carry[6] + 0.5 * msum(e),
                carry[7] + 0.5 * msum(dx * f[0]),
                carry[8] + 0.5 * msum(dx * f[1]),
                carry[9] + 0.5 * msum(dx * f[2]),
                carry[10] + 0.5 * msum(dy * f[1]),
                carry[11] + 0.5 * msum(dy * f[2]),
                carry[12] + 0.5 * msum(dz * f[2]),
            ]
        return tuple(out)

    def finish(carry):
        S = spec.S
        parts = tuple(a.reshape(S) for a in carry)
        force = jnp.stack(parts[:3], axis=-1)
        torque = jnp.stack(parts[3:6], axis=-1)
        if want == "force":
            return ForceResult(force=force, energy=None, virial=None, torque=torque)
        return ForceResult(
            force=force,
            energy=parts[6],
            virial=jnp.stack(parts[7:13], axis=-1),
            torque=torque,
        )

    if not jb.half:
        def body(carry, js):
            dx, dy, dz, rsq, mask = _offset_geometry(
                dense, spec, xi, yi, zi, valid_i, js, masked, jb.preshifted
            )
            t_j = js["typeid"][:, None, :] if need_t else None
            quat_j = tuple(js[k][:, None, :] for k in ("qw", "qx", "qy", "qz"))
            e, f, ti, _tj, mask = eval_aniso(dx, dy, dz, rsq, mask, t_j, quat_j)
            return iacc(carry, e, f, ti, mask, dx, dy, dz)

        carry = _scan_stencil(
            body, jb, spec, n_out=n_acc, extra_keys=("qw", "qx", "qy", "qz")
        )
        return finish(carry)

    # Newton half-stencil
    C, cap = spec.n_cells, spec.cap
    Dx, Dy, Dz = spec.dims
    offsets = spec.half_stencil()

    def jside(e, f, tj, mask, dx, dy, dz):
        def msum(val):
            return jnp.sum(jnp.where(mask, val, 0.0), axis=1)

        cols = [
            -msum(f[0]), -msum(f[1]), -msum(f[2]),
            msum(tj[0]), msum(tj[1]), msum(tj[2]),
        ]
        if want == "all":
            cols += [
                0.5 * msum(e),
                0.5 * msum(dx * f[0]),
                0.5 * msum(dx * f[1]),
                0.5 * msum(dx * f[2]),
                0.5 * msum(dy * f[1]),
                0.5 * msum(dy * f[2]),
                0.5 * msum(dz * f[2]),
            ]
        return jnp.stack(cols, axis=-1)  # [C, cap, n_acc]

    def body(carry, js):
        dx = xi - js["x"][:, None, :]
        dy = yi - js["y"][:, None, :]
        dz = zi - js["z"][:, None, :]
        rsq = dx * dx + dy * dy + dz * dz
        mask = rsq > 0
        if masked:
            mask = mask & valid_i & (js["typeid"] >= 0)[:, None, :]
        t_j = js["typeid"][:, None, :] if need_t else None
        quat_j = tuple(js[k][:, None, :] for k in ("qw", "qx", "qy", "qz"))
        e, f, ti, tj, mask = eval_aniso(dx, dy, dz, rsq, mask, t_j, quat_j)
        carry = iacc(carry, e, f, ti, mask, dx, dy, dz)
        return carry, jside(e, f, tj, mask, dx, dy, dz)

    js_all = {
        "x": jb.x, "y": jb.y, "z": jb.z,
        "qw": jb.qw, "qx": jb.qx, "qy": jb.qy, "qz": jb.qz,
    }
    if jb.typeid is not None:
        js_all["typeid"] = jb.typeid
    carry0 = tuple(jnp.zeros((C, cap), jnp.float32) for _ in range(n_acc))
    carry, ys = jax.lax.scan(body, carry0, js_all)

    # self-cell, strict upper triangle
    def self_view(a):
        return a.reshape(C, 1, cap)

    dx = xi - self_view(dense.position[:, 0])
    dy = yi - self_view(dense.position[:, 1])
    dz = zi - self_view(dense.position[:, 2])
    rsq = dx * dx + dy * dy + dz * dz
    tri = (
        jnp.arange(cap, dtype=jnp.int32)[None, None, :]
        > jnp.arange(cap, dtype=jnp.int32)[None, :, None]
    )
    mask0 = tri & (rsq > 0)
    if masked:
        mask0 = mask0 & valid_i & self_view(dense.tag >= 0)
    t_j0 = self_view(dense.typeid) if need_t else None
    quat_j0 = tuple(self_view(dense.orientation[:, k]) for k in range(4))
    e, f, ti, tj, mask0 = eval_aniso(dx, dy, dz, rsq, mask0, t_j0, quat_j0)
    carry = iacc(carry, e, f, ti, mask0, dx, dy, dz)
    jacc = jside(e, f, tj, mask0, dx, dy, dz)

    g = ys.reshape(len(offsets), Dx, Dy, Dz, cap, n_acc)
    for k, o in enumerate(offsets):
        jacc = jacc + _roll_cells(g[k], spec, o).reshape(C, cap, n_acc)
    total = tuple(carry[i] + jacc[..., i] for i in range(n_acc))
    return finish(total)


def dense_bond_force(
    energy_force_fn,
    dense: State,
    slot_of,
    bond_group,
    bond_typeid,
    tables: dict,
    want: str = "all",
):
    """Bond force in slot space: endpoints resolved via the tag->slot map.

    Bonds are O(N) gathers/scatters — the one place gathers remain; bond
    counts are typically << pair counts so this stays off the critical path.
    With ``want="force"`` (the hot step loop) the energy and virial
    scatter-adds — 7 of the 10 scattered words — are skipped entirely.
    """
    from .pair_force import ForceResult

    S = dense.N
    a = slot_of[bond_group[:, 0]]
    b = slot_of[bond_group[:, 1]]
    pa = jnp.take(dense.position, a, axis=0)
    pb = jnp.take(dense.position, b, axis=0)
    d = pa - pb
    ddx, ddy, ddz = dense.box.min_image_components(d[:, 0], d[:, 1], d[:, 2])
    rsq = ddx * ddx + ddy * ddy + ddz * ddz
    p = {k: jnp.take(v, bond_typeid) for k, v in tables.items()}
    rsq_safe = jnp.where(rsq > 0, rsq, 1.0)
    e, f_divr = energy_force_fn(rsq_safe, p)

    fx, fy, fz = f_divr * ddx, f_divr * ddy, f_divr * ddz
    fvec = jnp.stack([fx, fy, fz], axis=-1)
    force = jnp.zeros((S, 3), jnp.float32).at[a].add(fvec).at[b].add(-fvec)
    if want == "force":
        return ForceResult(force=force, energy=None, virial=None)
    energy = jnp.zeros((S,), jnp.float32).at[a].add(0.5 * e).at[b].add(0.5 * e)
    w = 0.5 * f_divr
    vir = jnp.stack(
        [w * ddx * ddx, w * ddx * ddy, w * ddx * ddz,
         w * ddy * ddy, w * ddy * ddz, w * ddz * ddz],
        axis=-1,
    )
    virial = jnp.zeros((S, 6), jnp.float32).at[a].add(vir).at[b].add(vir)
    return ForceResult(force=force, energy=energy, virial=virial)
