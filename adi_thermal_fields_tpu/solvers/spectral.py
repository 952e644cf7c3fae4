"""Spectral solve of the periodic-phi implicit operator via real FFT.

Solves ``(I - theta*dt*alpha*L_phi) X = Tin`` where ``L_phi`` is the standard
periodic second difference divided by ``r_i^2 dphi^2``.  Because L_phi is
circulant along phi, its eigenvalues under the DFT are
``lam_k = 1 + 2*fac_i*(1 - cos(2 pi k / nphi))`` with
``fac_i = theta*alpha*dt / (r_i^2 dphi^2)``.

Mirrors reference ``phi_solve_spectral`` (adi3d_cyl_phi_v3.py:302-329),
including the axis-regularity convention ``fac = 0`` for the innermost radial
row *when the grid touches the axis* (full disk).  For annular grids
(``r_inner > 0``) every row has a genuine radius, so no identity row is used.
Uses XLA's FFT (jnp.fft.rfft/irfft; cuFFT on NVIDIA GPUs) in place of
numpy.fft.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import CylindricalGrid
from ..core.material import Material

__all__ = ["phi_solve_spectral", "phi_eigenvalue_factors"]


def phi_eigenvalue_factors(grid: CylindricalGrid, dtype=jnp.float64) -> jax.Array:
    """Per-radius coefficient ``1/(r_i^2 dphi^2)`` with the axis row zeroed for
    full-disk grids (regularity at r=0, adi3d_cyl_phi_v3.py:314-317)."""
    r = np.asarray(grid.r, dtype=np.float64)
    inv = 1.0 / (r * r * grid.dphi * grid.dphi)
    if not grid.is_annular:
        inv = inv.copy()
        inv[0] = 0.0
    return jnp.asarray(inv, dtype=dtype)


def phi_solve_spectral(Tin: jax.Array, grid: CylindricalGrid, mat: Material,
                       theta, dt) -> jax.Array:
    """Apply ``(I - theta*dt*alpha*L_phi)^{-1}`` along axis 1 of (nr,nphi,nz)."""
    nphi = grid.nphi
    if nphi == 1:
        return Tin
    inv_r2dphi2 = phi_eigenvalue_factors(grid, dtype=Tin.dtype)
    fac = theta * mat.alpha * dt * inv_r2dphi2  # (nr,)
    k = jnp.arange(nphi // 2 + 1, dtype=Tin.dtype)
    cosk = jnp.cos(2.0 * jnp.pi * k / nphi)
    lam = 1.0 + 2.0 * fac[:, None] * (1.0 - cosk[None, :])  # (nr, K)

    F = jnp.fft.rfft(Tin, axis=1)
    F = F / lam[:, :, None]
    return jnp.fft.irfft(F, n=nphi, axis=1).astype(Tin.dtype)
