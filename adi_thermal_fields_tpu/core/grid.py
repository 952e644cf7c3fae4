"""Grid descriptors for the Cartesian voxel and cylindrical (r, phi, z) domains.

Design notes
------------
Grids are *static* metadata: plain frozen dataclasses holding shapes and
spacings only.  Unlike the reference (``adi3d_numba_coeff.py:14-19`` keeps the
boolean solid ``mask`` inside ``Grid3D``), the mask here is a *device array
passed separately* so that element-birth events mutate data, never static
compile-time state — a mask update must not retrigger XLA compilation.

The cylindrical grid supports an annular radial offset ``r_inner`` as a
first-class option.  The reference's ``GridCyl`` (adi3d_cyl_phi_v3.py:34) has
no such parameter even though its spiral driver calls ``GridCyl(..., R_in=...)``
(quick_spiral_deposition_gif_v5.py:80) — a latent API mismatch.  Here
``r_i = r_inner + (i + 0.5) * dr``, which reduces to the reference's full-disk
radii when ``r_inner == 0``.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["CartesianGrid", "CylindricalGrid"]


@dataclasses.dataclass(frozen=True)
class CartesianGrid:
    """3-D voxel grid (matches reference ``Grid3D`` semantics,
    adi3d_numba_coeff.py:14-19, minus the embedded mask), extended with
    optional ANISOTROPIC spacing — WAAM layers are typically thinner than
    the lateral resolution (the reference supports cubic voxels only).

    Attributes
    ----------
    nx, ny, nz : int
        Cell counts along x, y, z.
    dx : float
        Cell size along x [m]; also the default for dy/dz (cubic voxels).
    dy, dz : float, optional
        Cell sizes along y and z [m]; default ``dx``.
    """

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float | None = None
    dz: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "nx", int(self.nx))
        object.__setattr__(self, "ny", int(self.ny))
        object.__setattr__(self, "nz", int(self.nz))
        object.__setattr__(self, "dx", float(self.dx))
        object.__setattr__(self, "dy",
                           float(self.dx if self.dy is None else self.dy))
        object.__setattr__(self, "dz",
                           float(self.dx if self.dz is None else self.dz))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def spacing(self) -> tuple[float, float, float]:
        """Per-axis cell sizes (dx, dy, dz) [m]."""
        return (self.dx, self.dy, self.dz)

    @property
    def is_uniform(self) -> bool:
        return self.dx == self.dy == self.dz

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def cell_volume(self) -> float:
        return self.dx * self.dy * self.dz

    @property
    def face_area(self) -> float:
        """Face area for cubic voxels; per-axis use ``face_area_axis``."""
        return self.dx ** 2

    def face_area_axis(self, axis: int) -> float:
        """Area of the cell face NORMAL to ``axis`` [m^2]."""
        d = self.spacing
        a, b = (d[i] for i in range(3) if i != axis)
        return a * b


@dataclasses.dataclass(frozen=True)
class CylindricalGrid:
    """Cylindrical (r, phi, z) grid, optionally annular.

    Cell-center radii are ``r_i = r_inner + (i + 0.5) dr``; the inner physical
    boundary sits at the inner face of cell 0 (``r_inner``; the symmetry axis
    when ``r_inner == 0``) and the outer boundary at the outer face of the last
    cell.  Mirrors reference ``GridCyl`` (adi3d_cyl_phi_v3.py:33-43) with the
    annular extension required by its own spiral test
    (tests/test_spiral_vs_analytic.py:129-147).

    ``dphi`` is fixed to ``2*pi/nphi`` (full periodic azimuth), which is how
    every reference driver constructs it (quick_spiral_deposition_gif_v5.py:79).
    """

    nr: int
    nphi: int
    nz: int
    dr: float
    dz: float
    r_inner: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "nr", int(self.nr))
        object.__setattr__(self, "nphi", int(self.nphi))
        object.__setattr__(self, "nz", int(self.nz))
        object.__setattr__(self, "dr", float(self.dr))
        object.__setattr__(self, "dz", float(self.dz))
        object.__setattr__(self, "r_inner", float(self.r_inner))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nr, self.nphi, self.nz)

    @property
    def dphi(self) -> float:
        return 2.0 * np.pi / max(1, self.nphi)

    @property
    def is_annular(self) -> bool:
        return self.r_inner > 0.0

    @cached_property
    def r(self) -> np.ndarray:
        """Cell-center radii, shape (nr,)."""
        return self.r_inner + (np.arange(self.nr, dtype=np.float64) + 0.5) * self.dr

    @cached_property
    def r_imh(self) -> np.ndarray:
        """Inner-face radii r_{i-1/2}, shape (nr,)."""
        return self.r - 0.5 * self.dr

    @cached_property
    def r_iph(self) -> np.ndarray:
        """Outer-face radii r_{i+1/2}, shape (nr,)."""
        return self.r + 0.5 * self.dr

    @property
    def r_outer_face(self) -> float:
        """Outer physical boundary radius (outer face of the last cell)."""
        return float(self.r_inner + self.nr * self.dr)

    @property
    def height(self) -> float:
        return self.nz * self.dz
