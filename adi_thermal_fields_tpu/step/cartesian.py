"""Cartesian masked theta-scheme ADI time step.

One step advances ``T^{n+1} = W(V(U(R0)))`` where
``R0 = T^n + dt*kappa*(1-theta)*(Lx+Ly+Lz) T^n`` (mask-aware Laplacians) and
U/V/W are chained per-axis implicit sweeps, each solving, per pencil,

    (1 + theta*gam*nnb + dt*C_ax) u_i - theta*gam*(u_{i-1} + u_{i+1})
        = rhs_i + dt*q_ax + dt*C_ax*T_inf

with couplings only between mask-adjacent neighbors, Dirichlet rows pinned to
their value, and void rows as identity rows carrying the rhs through.
``gam = kappa*dt/dx^2``.  This reproduces the reference scheme exactly:
explicit part adi3d_numba_coeff.py:290-302, sweep rows :132-237.  Note the
reference's convention (kept here for parity): the *explicit* (1-theta)
fraction of the Robin flux is NOT included in R0 — Robin enters only through
the per-axis implicit sink ``dt*C_ax`` terms (comment at
adi3d_numba_coeff.py:297-298, "явный робин уже в R0").

Batched formulation: instead of the CPU reference's ragged per-pencil
compaction, every pencil is a full-length fixed-shape system with couplings
zeroed across mask boundaries and identity rows in void — the formulation the
reference's own GPU backend uses (adi3d_gpu_coeff.py:154-211), proven
numerically equivalent by its quick_compare_neumann_robin_backend driver.
Each sweep is one batched solve (solvers/thomas.py): the Triton kernel on a
GPU, the scan on the CPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..bc.faces import shift_in
from ..bc.packs import CoeffPacks
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..solvers.thomas import thomas

__all__ = ["adi_step", "masked_laplacian_1d", "build_sweep_system",
           "implicit_sweep", "apply_surface_impulse"]


def masked_laplacian_1d(T: jax.Array, mask: jax.Array, axis: int, inv_dx2) -> jax.Array:
    """Second difference along ``axis`` counting only in-mask neighbors
    (reflective at mask boundaries); zero on void cells.
    Matches reference lap1D_x/y/z (adi3d_numba_coeff.py:239-288)."""
    nbr_lo = shift_in(mask, axis, -1, fill=False)
    nbr_hi = shift_in(mask, axis, +1, fill=False)
    T_lo = shift_in(T, axis, -1, fill=0.0)
    T_hi = shift_in(T, axis, +1, fill=0.0)
    s = jnp.where(nbr_lo, T_lo, 0.0) + jnp.where(nbr_hi, T_hi, 0.0)
    cnt = nbr_lo.astype(T.dtype) + nbr_hi.astype(T.dtype)
    return jnp.where(mask, (s - cnt * T) * inv_dx2, 0.0)


def build_sweep_system(rhs, mask, coeff_ax, dir_mask, dir_val, qflux_ax,
                       theta_gam, dt, t_inf, axis: int):
    """The per-axis tridiagonal system (a, b, c, d) of one implicit sweep,
    in the natural field layout (reference sweep_axis0/1/2 row structure,
    adi3d_numba_coeff.py:132-237)."""
    # Neighbor couplings exist only between two in-mask cells.
    low = mask & shift_in(mask, axis, -1, fill=False)
    high = mask & shift_in(mask, axis, +1, fill=False)

    dtype = rhs.dtype
    a = jnp.where(low, -theta_gam, 0.0).astype(dtype)
    c = jnp.where(high, -theta_gam, 0.0).astype(dtype)
    nnb = low.astype(dtype) + high.astype(dtype)
    b = 1.0 + theta_gam * nnb + dt * coeff_ax
    d = rhs + dt * qflux_ax + dt * coeff_ax * t_inf

    # Void rows: identity carrying rhs through (reference keeps R0 in void —
    # out = R0.copy() at adi3d_numba_coeff.py:134, never overwritten there).
    b = jnp.where(mask, b, 1.0)
    d = jnp.where(mask, d, rhs)

    # Dirichlet rows: pinned (adi3d_numba_coeff.py:157-158).
    pin = dir_mask & mask
    a = jnp.where(pin, 0.0, a)
    c = jnp.where(pin, 0.0, c)
    b = jnp.where(pin, 1.0, b)
    d = jnp.where(pin, dir_val, d)
    return a, b, c, d


def implicit_sweep(rhs, mask, coeff_ax, dir_mask, dir_val, qflux_ax,
                   theta_gam, dt, t_inf, axis: int, *,
                   implementation: str = "auto",
                   interpret: bool = False) -> jax.Array:
    """One per-axis implicit sweep (reference sweep_axis0/1/2,
    adi3d_numba_coeff.py:132-237) in full-shape batched form."""
    a, b, c, d = build_sweep_system(rhs, mask, coeff_ax, dir_mask, dir_val,
                                    qflux_ax, theta_gam, dt, t_inf, axis)
    kw = dict(implementation=implementation, interpret=interpret)
    if axis == 0:
        return thomas(a, b, c, d, **kw)
    mv = partial(jnp.moveaxis, source=axis, destination=0)
    x = thomas(mv(a), mv(b), mv(c), mv(d), **kw)
    return jnp.moveaxis(x, 0, axis)


def adi_step(T: jax.Array, mask: jax.Array, packs: CoeffPacks,
             grid: CartesianGrid, mat: Material, *, dt, theta: float = 0.5,
             t_inf=0.0, source: jax.Array | None = None,
             implementation: str = "auto",
             interpret: bool = False) -> jax.Array:
    """Advance one ADI step (reference adi_step_numba_coeff,
    adi3d_numba_coeff.py:290-302).  Pure function; jit over (T, mask, packs,
    dt, t_inf) with grid/mat static.

    ``implementation``/``interpret``: the tridiagonal solver tier
    (solvers/thomas.py; "auto" = the Triton kernel on a GPU, the scan on
    the CPU).

    ``source``: optional volumetric heat rate [W/m^3] added explicitly to R0
    as ``dt*S/(rho cp)`` on in-mask cells (the Cartesian analogue of the
    cylindrical core's S, adi3d_cyl_phi_v3.py:339; enables moving heat
    sources such as birth/heat_source.py's Goldak ellipsoid)."""
    mask = mask.astype(bool)
    kappa = mat.alpha
    # per-axis 1/d^2 and theta*gam (anisotropic voxels; identical values —
    # and bitwise-identical results — for cubic ones)
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    tg = [theta * (kappa * dt * iv) for iv in inv_d2]  # rounding order kept

    lap = (masked_laplacian_1d(T, mask, 0, inv_d2[0])
           + masked_laplacian_1d(T, mask, 1, inv_d2[1])
           + masked_laplacian_1d(T, mask, 2, inv_d2[2]))
    R0 = T + dt * kappa * (1.0 - theta) * lap
    if source is not None:
        R0 = R0 + jnp.where(mask, dt * source / (mat.rho * mat.cp), 0.0)

    kw = dict(implementation=implementation, interpret=interpret)
    U = implicit_sweep(R0, mask, packs.coeff[0], packs.dir_mask, packs.dir_val,
                       packs.qflux[0], tg[0], dt, t_inf, axis=0, **kw)
    V = implicit_sweep(U, mask, packs.coeff[1], packs.dir_mask, packs.dir_val,
                       packs.qflux[1], tg[1], dt, t_inf, axis=1, **kw)
    W = implicit_sweep(V, mask, packs.coeff[2], packs.dir_mask, packs.dir_val,
                       packs.qflux[2], tg[2], dt, t_inf, axis=2, **kw)
    return W


def apply_surface_impulse(T: jax.Array, mask: jax.Array, grid: CartesianGrid,
                          mat: Material, Q, face: str = "z-") -> jax.Array:
    """Add a surface heat impulse ``dT = Q/(rho cp dx)`` on the exposed cells
    of the outermost slab of ``face`` (reference apply_surface_impulse_Q,
    adi3d_numba_coeff.py:304-320).  Functional: returns the updated field."""
    from ..bc.faces import exposed_face

    axis = {"x": 0, "y": 1, "z": 2}[face[0]]
    # dT = Q * A_face / (rho cp V) = Q / (rho cp d_normal)
    dT = Q / (mat.rho * mat.cp * grid.spacing[axis])
    exp = exposed_face(mask.astype(bool), face)
    idx = 0 if face[1] == "-" else T.shape[axis] - 1
    slab = jnp.zeros_like(mask, dtype=bool)
    slab_idx = [slice(None)] * 3
    slab_idx[axis] = idx
    slab = slab.at[tuple(slab_idx)].set(True)
    return jnp.where(exp & slab, T + dT, T)
