"""Spatial domain decomposition: strip sharding + ppermute halo migration.

Phase-2 distribution (SURVEY §2.12). The dense slot
layout is cell-major, so sharding the slot axis of a 1-D device mesh into
contiguous blocks IS a spatial decomposition (slot =
((cx*Dy + cy)*Dz + cz)*cap + r): each device owns a contiguous run of
whole z cell columns in the (cx, cy)-lexicographic order. When each block
is one or more whole x planes (Dx % n == 0) the domains are the classic
**x-slabs**; when a plane splits across devices the domains are
**(x, y)-strips** — a 2-D decomposition that keeps working past
n > Dx, where slabs would run out of planes. The force stencil already
crosses block boundaries through XLA's partitioner (halo pads lower to
collective permutes). What this module adds is a **local rebin**: instead
of the global ``lax.sort`` over all S slots (an all-to-all at scale),
each device re-bins only its own block and exchanges boundary-crossing
particles with its ring neighbors via ``lax.ppermute`` — the
analog of HOOMD's MPI particle migration.

Correctness invariant: between rebuilds particles drift at most the
Verlet margin (< one cell width), so a particle's destination cell is at
most one cell away per axis. In block units that bounds the ring-hop
distance by a small integer H (exactly 1 for whole-plane slabs; computed
exactly per grid by ``_hop_bound``); migrants ride one of 2*H ppermute
buffers, and anything farther raises the overflow flag (transactional
replay upstream). The local sort keys on (cell, GLOBAL input row), which
is exactly the global fused-key order restricted to the block — the
resulting slot layout is **bitwise identical** to ``ops.dense.rebin``
(tested), so trajectories do not depend on which rebin path ran.

Reference parity: HOOMD's domain decomposition + ghost migration is the
substrate the plugin assumes (SURVEY §2.13); plugin-level collectives
(`MPI_Allreduce`/`MPI_Exscan`, /root/reference/src/ParticleEvaporator.cc:96-107)
map to psum/cumsum which GSPMD inserts automatically for the sharded
arrays.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.state import State
from ..ops import dense as D

__all__ = ["spatial_rebin", "slab_migrate_capacity"]


def slab_migrate_capacity(spec: D.GridSpec, n_devices: int) -> int:
    """Default per-direction migrant buffer: one face layer of cells at
    half capacity (capped at the block size), rounded up to 8. Particles
    cross a block face only by drifting less than the Verlet margin, so
    a face layer is generous."""
    Dy, Dz = spec.dims[1], spec.dims[2]
    c_loc = spec.n_cells // max(1, n_devices)
    m = max(8, (min(Dy * Dz, c_loc) * spec.cap) // 2)
    return int((m + 7) // 8 * 8)


def _hop_bound(dims, n: int) -> int:
    """Exact max ring-hop distance a one-cell-per-axis drift can produce.

    Blocks are contiguous runs of cols_loc = Dx*Dy/n whole z columns in
    (cx, cy)-lexicographic order; a drift of at most one cell per axis
    (incl. periodic wraps) moves a particle's column, hence its block, a
    bounded ring distance. Enumerated exactly on the host (vectorized
    over all columns x 9 moves): whole-plane slabs give 1, sub-plane
    strips give ceil-like bounds (e.g. y-wrap hops most of a plane).
    """
    Dx, Dy, _ = dims
    cols = Dx * Dy
    cols_loc = cols // n
    q = np.arange(cols)
    cx, cy = q // Dy, q % Dy
    b = q // cols_loc
    h = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            q2 = ((cx + dx) % Dx) * Dy + ((cy + dy) % Dy)
            off = (q2 // cols_loc - b) % n
            h = max(h, int(np.minimum(off, n - off).max()))
    return h


def spatial_rebin(
    dense: State,
    meta: D.GridMeta,
    spec: D.GridSpec,
    N_tags: int,
    fields: tuple = D.ALL_FIELDS,
    need_slot_of: bool = True,
    *,
    mesh: Mesh,
    axis: str = "d",
    migrate_cap: int | None = None,
):
    """Block-local rebin with neighbor migration. Drop-in for ops.dense.rebin.

    Requires ``(Dx * Dy) % n_devices == 0`` (blocks aligned to whole z
    cell columns; whole x planes when Dx % n == 0 — the slab case).
    Returns (dense, meta) with the identical slot layout the global rebin
    would produce.
    """
    n = int(mesh.shape[axis])
    Dx, Dy, Dz = spec.dims
    if (Dx * Dy) % n != 0:
        raise ValueError(
            f"Dx*Dy={Dx * Dy} must be divisible by the mesh size {n} "
            "(blocks align to whole z cell columns)"
        )
    C = spec.n_cells
    S = spec.S
    cap = spec.cap
    C_loc = C // n
    S_loc = C_loc * cap
    H = _hop_bound(spec.dims, n)  # static max ring-hop per rebuild
    M = migrate_cap if migrate_cap is not None else slab_migrate_capacity(spec, n)
    layout = D._payload_layout(fields)
    K = sum(w for _, w, _ in layout)

    # fused local sort key: (cell-within-slab) high bits, GLOBAL input row
    # low bits — the exact order of the global rebin's fused key restricted
    # to one slab. Falls back to a two-operand sort when it cannot fit.
    gbits = max(1, (S - 1).bit_length())
    fused_ok = (C_loc + 1) << gbits < 2**31

    # ---- global-array prolog (elementwise; stays sharded under GSPMD) ----
    valid = dense.tag >= 0
    pos_w, image_w = dense.box.wrap(dense.position, dense.image)
    wrapped = dense.replace(position=pos_w, image=image_w)
    cid = D._cell_id(pos_w[:, 0], pos_w[:, 1], pos_w[:, 2], dense.box, spec.dims)
    cid = jnp.where(valid, cid, C)
    packed = D._pack_payload(wrapped, layout)  # [S, K] int32

    default_row = D._payload_default_row(layout)  # [1, K]
    Lx_g = dense.box.L[0]
    stride_g = Lx_g + jnp.float32(2.0 * spec.r_list)

    def shard_body(packed_l, cid_l, Lx, stride):
        d = jax.lax.axis_index(axis)
        c0 = d * C_loc
        gidx = d * S_loc + jnp.arange(S_loc, dtype=jnp.int32)
        is_real = cid_l < C
        dest = jnp.where(is_real, cid_l // C_loc, d)
        stay = is_real & (dest == d)
        # ring-hop routing: a migrant rides exactly ONE buffer (or it
        # would arrive twice). Hop distances are measured both ways
        # around the device ring; ties (dest exactly opposite — incl.
        # the n == 2 degeneracy where both neighbors are the same
        # device) resolve to the left buffer. With n == 1, off == 0
        # everywhere: stay covers everything and no buffer fills.
        off = (dest - d) % n
        hop_r = off
        hop_l = jnp.where(off == 0, n, n - off)
        mig = is_real & ~stay
        use_l = mig & (hop_l <= H) & (hop_l <= hop_r)
        use_r = mig & (hop_r <= H) & (hop_r < hop_l)
        lost = mig & ~(use_l | use_r)

        # migrant buffers: payload + cid + gidx, cid=C marks empty rows
        mig_data = jnp.concatenate(
            [packed_l, cid_l[:, None], gidx[:, None]], axis=1
        )  # [S_loc, K+2]
        empty_row = jnp.concatenate(
            [default_row[0], jnp.asarray([C, 0], jnp.int32)]
        )

        def pack_migrants(mask):
            rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
            slot = jnp.where(mask & (rank < M), rank, M)
            buf = jnp.tile(empty_row[None, :], (M + 1, 1))
            buf = buf.at[slot].set(
                jnp.where(mask[:, None], mig_data, empty_row[None, :]),
                mode="drop",
            )
            # row M collects both rejects and every unmasked write; wipe it
            buf = buf.at[M].set(empty_row)
            return buf[:M], jnp.sum(mask.astype(jnp.int32)) > M

        # one buffer pair per hop distance; the local sort below keys on
        # the global input row, so candidate order cannot affect the
        # output layout
        recvs = []
        ov_mig = jnp.asarray(False)
        for h in range(1, H + 1):
            lbuf, ovl = pack_migrants(use_l & (hop_l == h))
            rbuf, ovr = pack_migrants(use_r & (hop_r == h))
            ov_mig = ov_mig | ovl | ovr
            perm_left = [(i, (i - h) % n) for i in range(n)]
            perm_right = [(i, (i + h) % n) for i in range(n)]
            recvs.append(jax.lax.ppermute(lbuf, axis, perm_left))
            recvs.append(jax.lax.ppermute(rbuf, axis, perm_right))

        # candidate set: local stays + received migrants
        cid_stay = jnp.where(stay, cid_l, C)
        cand = jnp.concatenate(
            [jnp.concatenate([packed_l, cid_stay[:, None], gidx[:, None]], 1)]
            + recvs,
            axis=0,
        )  # [n_cand, K+2]
        n_cand = cand.shape[0]
        cand_cid = cand[:, K]
        cand_gidx = cand[:, K + 1]
        crel = jnp.where(cand_cid < C, cand_cid - c0, C_loc)
        crel = jnp.clip(crel, 0, C_loc)  # received rows are ours by construction

        if fused_ok:
            key = (crel << jnp.int32(gbits)) | cand_gidx
            row = jnp.arange(n_cand, dtype=jnp.int32)
            _, perm = jax.lax.sort([key, row], num_keys=1, is_stable=True)
            crel_s = crel[perm]
        else:
            crel_s, _, perm = jax.lax.sort(
                [crel, cand_gidx, jnp.arange(n_cand, dtype=jnp.int32)],
                num_keys=2,
                is_stable=True,
            )
        cand_sorted = jnp.take(cand[:, :K], perm, axis=0)

        start = jnp.searchsorted(crel_s, jnp.arange(C_loc + 1, dtype=jnp.int32))
        start = start.astype(jnp.int32)
        counts = start[1:] - start[:-1]
        overflow = jnp.any(counts > cap) | ov_mig | jnp.any(lost)
        # exact need is unknowable when migrants were dropped (lost) or a
        # hop buffer overflowed; report what this shard saw — the caller
        # treats it as a lower bound
        max_occ = jnp.max(counts)

        rank_b = jax.lax.broadcasted_iota(jnp.int32, (C_loc, cap), 1)
        src = start[:C_loc, None] + rank_b
        valid_slot = rank_b < jnp.minimum(counts, cap)[:, None]
        src = jnp.where(valid_slot, src, n_cand).reshape(S_loc)
        packed_pad = jnp.concatenate([cand_sorted, default_row], axis=0)
        out = jnp.take(packed_pad, src, axis=0)  # [S_loc, K]

        # empty-slot x sentinels keyed on the GLOBAL slot index: exact
        # parity with the single-device layout (ops.dense._sentinel_x)
        gslot = d * S_loc + jnp.arange(S_loc, dtype=jnp.int32)
        sent_x = Lx + (gslot.astype(jnp.float32) + 1.0) * stride
        x = jnp.where(
            valid_slot.reshape(S_loc), out[:, 0].view(jnp.float32), sent_x
        )
        out = jnp.concatenate([x.view(jnp.int32)[:, None], out[:, 1:]], axis=1)
        return out, overflow[None], max_occ[None]

    from jax import shard_map

    out, ovf, mocc = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )(packed, cid, Lx_g, stride_g)

    new_dense = D._state_from_payload(out, layout, dense, dense.box)
    if need_slot_of:
        tags = new_dense.tag
        slot_of = jnp.full((N_tags,), 0, jnp.int32)
        slot_of = slot_of.at[jnp.where(tags >= 0, tags, N_tags)].set(
            jnp.arange(S, dtype=jnp.int32), mode="drop"
        )
    else:
        slot_of = jnp.zeros((0,), jnp.int32)
    new_meta = D.GridMeta(
        ref_position=new_dense.position,
        slot_of=slot_of,
        overflow=jnp.any(ovf) | meta.overflow,
        n_builds=meta.n_builds + 1,
        max_occ=jnp.maximum(jnp.max(mocc), meta.max_occ),
    )
    return new_dense, new_meta
