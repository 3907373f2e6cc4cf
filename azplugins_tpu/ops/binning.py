"""Binning operations for velocity field computes.

Rebuild of SURVEY §2.6's binning layer
(/root/reference/src/VelocityFieldComputeGPU.cuh:65-70): particles map to a
flat bin id and mass/momentum are accumulated with one scatter-add per
grid (atomics on the GPU: reproducible to f32 rounding run to run,
DEVIATIONS.md §14).

  * Cartesian (/root/reference/src/CartesianBinningOperation.h:22-54):
    bins (x, y, z); velocity passes through.
  * Cylindrical (/root/reference/src/CylindricalBinningOperation.h:22-80):
    bins (r, theta, z) with theta wrapped to [0, 2pi); velocity rotated to
    (v_r, v_theta, v_z).

Axes with num_bins == 0 are ignored for binning (size-1 in the flat grid)
and collapsed in the user-facing compact shape.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["cartesian_coords", "cylindrical_coords", "bin_particles"]


def cartesian_coords(position, velocity):
    return position, velocity


def cylindrical_coords(position, velocity):
    x, y, z = position[..., 0], position[..., 1], position[..., 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(y, x)
    theta = jnp.where(theta < 0, theta + 2.0 * jnp.pi, theta)
    coords = jnp.stack([r, theta, z], axis=-1)
    # rotate velocity into (v_r, v_theta, v_z); at r = 0 use the x basis
    r_safe = jnp.where(r > 0, r, 1.0)
    c = jnp.where(r > 0, x / r_safe, 1.0)
    s = jnp.where(r > 0, y / r_safe, 0.0)
    vx, vy, vz = velocity[..., 0], velocity[..., 1], velocity[..., 2]
    v_r = c * vx + s * vy
    v_t = -s * vx + c * vy
    vel = jnp.stack([v_r, v_t, vz], axis=-1)
    return coords, vel


def bin_particles(coords, velocity, mass, select, num_bins, lower, upper):
    """Histogram mass and momentum over the (flattened) bin grid.

    Args:
        coords: ``[N, 3]`` binning coordinates.
        velocity: ``[N, 3]`` velocity in the output basis.
        mass: ``[N]``.
        select: ``[N]`` bool, particles to include.
        num_bins: static 3-tuple; 0 disables an axis (treated as size 1).
        lower/upper: static 3-tuples of bounds (ignored for disabled axes).

    Returns:
        (mass_grid [B], momentum_grid [B, 3]) with B = prod(max(bins, 1)).
    """
    sizes = tuple(max(int(b), 1) for b in num_bins)
    total = sizes[0] * sizes[1] * sizes[2]
    idx = jnp.zeros(coords.shape[0], dtype=jnp.int32)
    ok = select
    for ax in range(3):
        nb = int(num_bins[ax])
        idx = idx * sizes[ax]
        if nb == 0:
            continue
        lo = jnp.float32(lower[ax])
        hi = jnp.float32(upper[ax])
        x = coords[:, ax]
        b = jnp.floor((x - lo) / (hi - lo) * nb).astype(jnp.int32)
        ok = ok & (x >= lo) & (b >= 0) & (b < nb)
        idx = idx + jnp.clip(b, 0, nb - 1)

    idx = jnp.where(ok, idx, total)  # dump slot
    m = jnp.where(ok, mass, 0.0)
    mom = jnp.where(ok[:, None], velocity * mass[:, None], 0.0)
    mass_grid = jnp.zeros((total + 1,), jnp.float32).at[idx].add(m)[:total]
    mom_grid = jnp.zeros((total + 1, 3), jnp.float32).at[idx].add(mom)[:total]
    return mass_grid, mom_grid
