"""Triclinic periodic simulation box.

Replacement for the HOOMD ``BoxDim`` substrate the reference
plugin rides on (wrap used at /root/reference/src/HarmonicBarrier.h:169-171,
minimum image implied by the pair force drivers). The box is an immutable
pytree so it can live inside jitted step functions; all geometry ops are
branch-free elementwise math.

Conventions (HOOMD-compatible):
  * box is centered on the origin: lo = -L/2, hi = +L/2
  * cell matrix h = [[Lx, xy*Ly, xz*Lz], [0, Ly, yz*Lz], [0, 0, Lz]]
  * ``wrap`` folds positions into the box updating image flags
  * ``min_image`` returns the minimum-image displacement vector
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree_dataclass

__all__ = ["Box"]


@pytree_dataclass
class Box:
    """Periodic triclinic box.

    Attributes:
        L: box edge lengths ``[Lx, Ly, Lz]``.
        tilt: tilt factors ``[xy, xz, yz]`` (dimensionless, HOOMD convention).
    """

    L: jnp.ndarray
    tilt: jnp.ndarray

    # -- constructors ------------------------------------------------------
    @classmethod
    def cube(cls, L: float) -> "Box":
        return cls.from_lengths(L, L, L)

    @classmethod
    def from_lengths(
        cls, Lx: float, Ly: float, Lz: float, xy: float = 0.0, xz: float = 0.0, yz: float = 0.0
    ) -> "Box":
        return cls(
            L=jnp.asarray([Lx, Ly, Lz], dtype=jnp.float32),
            tilt=jnp.asarray([xy, xz, yz], dtype=jnp.float32),
        )

    # -- derived geometry --------------------------------------------------
    @property
    def Lx(self):
        return self.L[0]

    @property
    def Ly(self):
        return self.L[1]

    @property
    def Lz(self):
        return self.L[2]

    @property
    def xy(self):
        return self.tilt[0]

    @property
    def xz(self):
        return self.tilt[1]

    @property
    def yz(self):
        return self.tilt[2]

    @property
    def lo(self) -> jnp.ndarray:
        return -0.5 * self.L

    @property
    def hi(self) -> jnp.ndarray:
        return 0.5 * self.L

    def matrix(self) -> jnp.ndarray:
        """Upper-triangular cell matrix h (columns are lattice vectors)."""
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        zero = jnp.zeros_like(Lx)
        return jnp.stack(
            [
                jnp.stack([Lx, xy * Ly, xz * Lz]),
                jnp.stack([zero, Ly, yz * Lz]),
                jnp.stack([zero, zero, Lz]),
            ]
        )

    def volume(self) -> jnp.ndarray:
        return self.L[0] * self.L[1] * self.L[2]

    def fraction(self, r: jnp.ndarray) -> jnp.ndarray:
        """Map cartesian positions to fractional coordinates in [-0.5, 0.5)."""
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        fz = r[..., 2] / Lz
        fy = (r[..., 1] - yz * Lz * fz) / Ly
        fx = (r[..., 0] - xy * Ly * fy - xz * Lz * fz) / Lx
        return jnp.stack([fx, fy, fz], axis=-1)

    def _lattice_shift(self, s: jnp.ndarray) -> jnp.ndarray:
        """``s @ h.T`` written componentwise.

        NEVER use a matmul here: on the GPU, default-precision f32
        matmuls may run in TF32 (~10 mantissa bits), so box lengths that
        are not exactly TF32-representable (e.g. the 64k bench's
        L=42.1727) would shift every boundary-crossing particle by up to
        ~1e-3 of L, pumping energy into trajectories and creating
        overlapping phantom pairs. Componentwise f32 multiplies are
        exactly rounded.
        """
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
        return jnp.stack(
            [
                sx * Lx + sy * (xy * Ly) + sz * (xz * Lz),
                sy * Ly + sz * (yz * Lz),
                sz * Lz,
            ],
            axis=-1,
        )

    def make_coordinates(self, f: jnp.ndarray) -> jnp.ndarray:
        """Inverse of :meth:`fraction` shifted so f in [0,1] spans the box."""
        return self._lattice_shift(f - 0.5)

    # -- periodic operations ------------------------------------------------
    def wrap(self, r: jnp.ndarray, image: jnp.ndarray | None = None):
        """Fold positions into the primary box.

        Args:
            r: positions ``[..., 3]``.
            image: optional int32 image flags ``[..., 3]``.

        Returns:
            ``(wrapped, image)`` tuple; image is updated if given, else the
            shift count is returned as a fresh image array.
        """
        f = self.fraction(r)
        shift = jnp.floor(f + 0.5).astype(jnp.int32)
        wrapped = r - self._lattice_shift(shift.astype(r.dtype))
        if image is None:
            image = shift
        else:
            image = image + shift
        return wrapped, image

    def min_image(self, dr: jnp.ndarray) -> jnp.ndarray:
        """Minimum-image displacement for ``dr = r_i - r_j`` (orthorhombic+tilt)."""
        f = self.fraction(dr)
        shift = jnp.round(f)
        return dr - self._lattice_shift(shift.astype(dr.dtype))

    def min_image_components(self, dx, dy, dz):
        """Minimum image on separate x/y/z component arrays.

        Large pairwise intermediates stay [N, M] per component, never
        [..., 3], so each component array is contiguous. Handles
        triclinic tilt.
        """
        Lx, Ly, Lz = self.L[0], self.L[1], self.L[2]
        xy, xz, yz = self.tilt[0], self.tilt[1], self.tilt[2]
        fz = dz / Lz
        fy = (dy - yz * Lz * fz) / Ly
        fx = (dx - xy * Ly * fy - xz * Lz * fz) / Lx
        sx = jnp.round(fx)
        sy = jnp.round(fy)
        sz = jnp.round(fz)
        dx = dx - (sx * Lx + sy * xy * Ly + sz * xz * Lz)
        dy = dy - (sy * Ly + sz * yz * Lz)
        dz = dz - sz * Lz
        return dx, dy, dz

    def nearest_plane_distance(self) -> jnp.ndarray:
        """Distance between nearest periodic image planes along each axis."""
        h = self.matrix()
        a, b, c = h[:, 0], h[:, 1], h[:, 2]

        def dist(u, v, w):
            n = jnp.cross(v, w)
            # elementwise dot: no matmul precision loss (see _lattice_shift)
            return jnp.abs(jnp.sum(u * n)) / jnp.linalg.norm(n)

        return jnp.stack([dist(a, b, c), dist(b, c, a), dist(c, a, b)])
