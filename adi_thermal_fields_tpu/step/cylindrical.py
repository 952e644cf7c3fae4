"""Cylindrical (r, phi, z) ADI time step with periodic phi.

Reproduces the reference cylindrical core (adi3d_cyl_phi_v3.py): finite-volume
radial operator with Robin at the outer face by ghost-cell elimination,
spectral (FFT) periodic phi solve, and z sweep with Neumann-0 / Dirichlet /
Robin ends.  Default scheme is backward Euler ("be"), sequentially chained
r -> phi -> z exactly as adi3d_cyl_phi_v3.py:338-350.

Extensions over the reference (documented deviations):

* **Annular grids** (``grid.r_inner > 0``) are first-class, with an optional
  Robin condition on the *inner* face mirroring the outer one.  The
  reference's own spiral test requires an annular grid
  (tests/test_spiral_vs_analytic.py:129-147) but its ``GridCyl`` cannot build
  one (the ``R_in=`` kwarg bug at quick_spiral_deposition_gif_v5.py:80 vs
  adi3d_cyl_phi_v3.py:34); the test's analytic oracle applies Robin h on both
  the inner and outer radii (spiral_analytic_solution.py:90-102), which is the
  semantics implemented here.
* The optional Douglas–Gunn scheme is implemented in its textbook
  dimensionally-consistent form (the reference's "douglas" branch at
  adi3d_cyl_phi_v3.py:352-373 drops the diffusivity alpha from the explicit
  operators — a recorded defect we do not replicate).

Batched tridiagonal systems: the r sweep solves (nphi*nz) systems of length
nr and the z sweep (nr*nphi) systems of length nz, all simultaneously via the
batched Thomas solve (solvers/thomas.py) with 1-D coefficient vectors
broadcast across the batch — no (M, n) materialization as in the NumPy
reference.
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..solvers.spectral import phi_solve_spectral
from ..solvers.thomas import thomas

__all__ = ["RobinBC", "ZFaceBC", "adi_step", "adi_step_masked",
           "apply_Lr", "apply_Lphi", "apply_Lz"]


@dataclasses.dataclass(frozen=True)
class RobinBC:
    """Convective (Robin) boundary: -k dT/dn = h (T - T_inf).
    Mirrors reference ``RobinR`` (adi3d_cyl_phi_v3.py:56-58)."""

    h: float
    T_inf: float


@dataclasses.dataclass(frozen=True)
class ZFaceBC:
    """Axial end-face BCs; kinds in {"neumann0", "dirichlet", "robin"}.
    Mirrors reference ``ZBC`` (adi3d_cyl_phi_v3.py:60-68)."""

    kind_bot: str = "neumann0"
    kind_top: str = "robin"
    h_bot: float = 0.0
    h_top: float = 0.0
    T_inf_bot: float = 20.0
    T_inf_top: float = 20.0
    T_bot: float = 20.0
    T_top: float = 20.0


# --------------------------------------------------------------------------
# Explicit operators (used by the Douglas scheme; reference
# adi3d_cyl_phi_v3.py:126-152, with alpha applied by the caller).
# --------------------------------------------------------------------------

def _r_vectors(grid: CylindricalGrid, dtype):
    r = jnp.asarray(grid.r, dtype)[:, None, None]
    r_imh = jnp.asarray(np.maximum(grid.r_imh, 1e-15), dtype)[:, None, None]
    r_iph = jnp.asarray(grid.r_iph, dtype)[:, None, None]
    return r, r_imh, r_iph


def apply_Lr(T: jax.Array, grid: CylindricalGrid) -> jax.Array:
    """Finite-volume radial Laplacian with zero-flux faces at both radial ends."""
    dr = grid.dr
    r, r_imh, r_iph = _r_vectors(grid, T.dtype)
    Trp = jnp.concatenate([T[1:], T[-1:]], axis=0)
    Trm = jnp.concatenate([T[:1], T[:-1]], axis=0)
    flux_p = r_iph * (Trp - T) / dr
    flux_m = r_imh * (T - Trm) / dr
    return (flux_p - flux_m) / (r * dr)


def apply_Lphi(T: jax.Array, grid: CylindricalGrid) -> jax.Array:
    """Periodic second difference in phi over r^2 dphi^2; axis row zeroed on
    full-disk grids for regularity."""
    if grid.nphi == 1:
        return jnp.zeros_like(T)
    r, _, _ = _r_vectors(grid, T.dtype)
    Tph = jnp.roll(T, -1, axis=1)
    Tmh = jnp.roll(T, +1, axis=1)
    out = (Tph - 2.0 * T + Tmh) / (r * r * grid.dphi * grid.dphi)
    if not grid.is_annular:
        out = out.at[0].set(0.0)
    return out


def apply_Lz(T: jax.Array, grid: CylindricalGrid) -> jax.Array:
    """Axial second difference with Neumann-0 ghost cells at both ends."""
    dz = grid.dz
    Tzp = jnp.concatenate([T[:, :, 1:], T[:, :, -1:]], axis=2)
    Tzm = jnp.concatenate([T[:, :, :1], T[:, :, :-1]], axis=2)
    return (Tzp - 2.0 * T + Tzm) / (dz * dz)


# --------------------------------------------------------------------------
# Implicit sweeps
# --------------------------------------------------------------------------


def _r_geometry(grid: CylindricalGrid, mat: Material,
                robin_outer: RobinBC | None, robin_inner: RobinBC | None):
    """Unit-fac radial geometry: off-diagonal couplings, Robin diagonal
    additions, and Robin T_inf source (shared by the implicit solve and the
    affine explicit operator)."""
    nr, dr = grid.nr, grid.dr
    r = np.maximum(np.asarray(grid.r, np.float64), 1e-15)
    r_imh = np.maximum(np.asarray(grid.r_imh, np.float64), 1e-15)
    r_iph = np.asarray(grid.r_iph, np.float64)
    ge_a = r_imh / (r * dr * dr)
    ge_c = r_iph / (r * dr * dr)
    ge_a[0] = 0.0
    ge_c[nr - 1] = 0.0
    ge_rob = np.zeros(nr)
    rob_rhs = np.zeros(nr)
    if grid.is_annular and robin_inner is not None and robin_inner.h != 0.0:
        g_in = (r_imh[0] * (robin_inner.h / mat.k)) / (r[0] * dr)
        ge_rob[0] += g_in
        rob_rhs[0] += g_in * robin_inner.T_inf
    if robin_outer is not None and robin_outer.h != 0.0:
        g_out = (r_iph[nr - 1] * (robin_outer.h / mat.k)) / (r[nr - 1] * dr)
        ge_rob[nr - 1] += g_out
        rob_rhs[nr - 1] += g_out * robin_outer.T_inf
    return ge_a, ge_c, ge_rob, rob_rhs


def _z_geometry(grid: CylindricalGrid, mat: Material, zbc: ZFaceBC):
    """Unit-fac axial geometry (per 1/dz^2) including end-BC rows; Dirichlet
    rows come out all-zero (their solve rows are identities pinned to the
    value by _z_sweep)."""
    nz, dz = grid.nz, grid.dz
    ge_a = np.ones(nz)
    ge_c = np.ones(nz)
    ge_b = np.full(nz, 2.0)
    rob_rhs = np.zeros(nz)
    ge_a[0] = 0.0
    ge_c[nz - 1] = 0.0
    dir_rows = []

    def end_row(idx, kind, h, t_inf, t_dir):
        if kind == "neumann0":
            ge_b[idx] = 1.0
        elif kind == "dirichlet":
            ge_a[idx] = 0.0
            ge_c[idx] = 0.0
            ge_b[idx] = 0.0
            dir_rows.append((idx, float(t_dir)))
        elif kind == "robin":
            beta = h / mat.k
            ge_b[idx] = 1.0 + beta * dz
            rob_rhs[idx] = beta * dz * t_inf
        else:
            raise ValueError(f"unknown z-face BC kind: {kind!r}")

    end_row(0, zbc.kind_bot, zbc.h_bot, zbc.T_inf_bot, zbc.T_bot)
    end_row(nz - 1, zbc.kind_top, zbc.h_top, zbc.T_inf_top, zbc.T_top)
    return ge_a, ge_c, ge_b, rob_rhs, dir_rows


def r_operator(T: jax.Array, grid: CylindricalGrid, mat: Material,
               robin_outer: RobinBC | None,
               robin_inner: RobinBC | None = None) -> jax.Array:
    """Affine explicit radial operator ``alpha*(L_r T + s)`` [K/s] — the EXACT
    discrete operator whose implicit solve is _r_sweep (Robin rows included),
    as Douglas-Gunn consistency requires.  Replaces the reference's
    ``apply_Lr`` whose BC-free edges are inconsistent with its own implicit
    matrices (part of why its "douglas" branch is defective, SURVEY.md §2 #16)."""
    dtype = T.dtype
    ge_a, ge_c, ge_rob, rob_rhs = _r_geometry(grid, mat, robin_outer, robin_inner)
    al = mat.alpha
    col = lambda v: jnp.asarray(al * v, dtype)[:, None, None]
    Tdn = jnp.concatenate([jnp.zeros_like(T[:1]), T[:-1]], axis=0)
    Tup = jnp.concatenate([T[1:], jnp.zeros_like(T[:1])], axis=0)
    return (col(ge_a) * Tdn + col(ge_c) * Tup
            - col(ge_a + ge_c + ge_rob) * T + col(rob_rhs))


def z_operator(T: jax.Array, grid: CylindricalGrid, mat: Material,
               zbc: ZFaceBC) -> jax.Array:
    """Affine explicit axial operator ``alpha*(L_z T + s)`` [K/s] consistent
    with _z_sweep's matrices (Dirichlet rows contribute zero rate)."""
    dtype = T.dtype
    ge_a, ge_c, ge_b, rob_rhs, _ = _z_geometry(grid, mat, zbc)
    al = mat.alpha / (grid.dz * grid.dz)
    row = lambda v: jnp.asarray(al * v, dtype)[None, None, :]
    Tdn = jnp.concatenate([jnp.zeros_like(T[:, :, :1]), T[:, :, :-1]], axis=2)
    Tup = jnp.concatenate([T[:, :, 1:], jnp.zeros_like(T[:, :, :1])], axis=2)
    return row(ge_a) * Tdn + row(ge_c) * Tup - row(ge_b) * T + row(rob_rhs)


def _r_sweep(rhs: jax.Array, grid: CylindricalGrid, mat: Material, theta_dt,
             robin_outer: RobinBC, robin_inner: RobinBC | None,
             implementation: str = "auto",
             interpret: bool = False) -> jax.Array:
    """Solve (I - theta*dt*alpha*L_r) x = rhs along axis 0.

    Interior/axis/outer-Robin coefficients match reference ``build_coeff_r``
    (adi3d_cyl_phi_v3.py:155-202); the inner-Robin row is the mirror-image
    ghost elimination on annular grids.
    """
    dtype = rhs.dtype
    # Static (numpy) geometric factors; the traced fac = theta*dt*alpha scales
    # them at trace time so a traced dt never recompiles or mutates arrays.
    ge_a, ge_c, ge_rob, rob_rhs = _r_geometry(grid, mat, robin_outer,
                                              robin_inner)
    fac = jnp.asarray(theta_dt * mat.alpha, dtype)
    a_vec = -fac * jnp.asarray(ge_a, dtype)
    c_vec = -fac * jnp.asarray(ge_c, dtype)
    b_vec = 1.0 + fac * jnp.asarray(ge_a + ge_c + ge_rob, dtype)
    radd = fac * jnp.asarray(rob_rhs, dtype)
    return thomas(a_vec[:, None, None], b_vec[:, None, None],
                  c_vec[:, None, None], rhs + radd[:, None, None],
                  implementation=implementation, interpret=interpret)


def _z_sweep(rhs: jax.Array, grid: CylindricalGrid, mat: Material, theta_dt,
             zbc: ZFaceBC, implementation: str = "auto",
             interpret: bool = False) -> jax.Array:
    """Solve (I - theta*dt*alpha*L_z) x = rhs along axis 2 with end BCs.
    Coefficients match reference ``build_coeff_z`` (adi3d_cyl_phi_v3.py:255-298)."""
    dtype = rhs.dtype
    # Static (numpy) unit-fac geometry; traced fac scales it at trace time.
    ge_a, ge_c, ge_b, rob_rhs, dir_rows = _z_geometry(grid, mat, zbc)
    fac = jnp.asarray(theta_dt * mat.alpha / (grid.dz * grid.dz), dtype)
    a_vec = -fac * jnp.asarray(ge_a, dtype)
    c_vec = -fac * jnp.asarray(ge_c, dtype)
    b_vec = 1.0 + fac * jnp.asarray(ge_b, dtype)
    radd = fac * jnp.asarray(rob_rhs, dtype)
    d = jnp.moveaxis(rhs, 2, 0)  # (nz, nr, nphi)
    for idx, t_dir in dir_rows:
        d = d.at[idx].set(jnp.asarray(t_dir, dtype))

    x = thomas(a_vec[:, None, None], b_vec[:, None, None],
               c_vec[:, None, None], d + radd[:, None, None],
               implementation=implementation, interpret=interpret)
    return jnp.moveaxis(x, 0, 2)


def _phi_solve(X, grid: CylindricalGrid, mat: Material, theta, dt):
    """Periodic phi implicit solve: spectral (FFT), matching the reference's
    phi_solve_spectral (numpy FFT on the CPU, cuFFT on the GPU)."""
    return phi_solve_spectral(X, grid, mat, theta, dt)


# --------------------------------------------------------------------------
# Time steps
# --------------------------------------------------------------------------

def adi_step(T: jax.Array, grid: CylindricalGrid, mat: Material, *, dt,
             robin_outer: RobinBC, zbc: ZFaceBC,
             robin_inner: RobinBC | None = None,
             source: jax.Array | None = None,
             scheme: str = "be", theta: float = 0.5,
             implementation: str = "auto",
             interpret: bool = False) -> jax.Array:
    """One cylindrical ADI step (reference ``adi_step``,
    adi3d_cyl_phi_v3.py:332-373).

    scheme="be": backward Euler, sequentially chained r -> phi -> z implicit
    solves with the volumetric source added up front (:338-350).
    scheme="douglas": textbook Douglas–Gunn with stabilizing correction (the
    reference's variant is dimensionally inconsistent; see module docstring).

    implementation / interpret: the r and z sweeps' tridiagonal solver tier
    (solvers/thomas.py); the phi solve is spectral on every tier.
    """
    kw = dict(implementation=implementation, interpret=interpret)
    if scheme == "be":
        R0 = T if source is None else T + dt * source / (mat.rho * mat.cp)
        X = _r_sweep(R0, grid, mat, dt, robin_outer, robin_inner, **kw)
        X = _phi_solve(X, grid, mat, 1.0, dt)
        return _z_sweep(X, grid, mat, dt, zbc, **kw)

    if scheme != "douglas":
        raise ValueError(f"unknown scheme: {scheme!r}")

    th = theta if 0.0 < theta <= 1.0 else 0.5
    # BC-consistent affine operators [K/s]: the SAME discrete operators as
    # the implicit solves (Robin ghost rows included) — required for the
    # Douglas-Gunn corrections to cancel (steady states are fixed points).
    Lr = r_operator(T, grid, mat, robin_outer, robin_inner)
    Lp = mat.alpha * apply_Lphi(T, grid)
    Lz = z_operator(T, grid, mat, zbc)
    Y0 = T + dt * (Lr + Lp + Lz)
    if source is not None:
        Y0 = Y0 + dt * source / (mat.rho * mat.cp)
    Y1 = _r_sweep(Y0 - th * dt * Lr, grid, mat, th * dt,
                  robin_outer, robin_inner, **kw)
    Y2 = _phi_solve(Y1 - th * dt * Lp, grid, mat, th, dt)
    Y3 = _z_sweep(Y2 - th * dt * Lz, grid, mat, th * dt, zbc, **kw)
    return Y3


def adi_step_masked(T: jax.Array, grid: CylindricalGrid, mat: Material, *, dt,
                    robin_outer: RobinBC, zbc: ZFaceBC, active: jax.Array,
                    robin_inner: RobinBC | None = None,
                    robin_void: RobinBC | None = None,
                    source: jax.Array | None = None,
                    scheme: str = "be", theta: float = 0.5,
                    implementation: str = "auto",
                    interpret: bool = False) -> jax.Array:
    """Element-birth wrapper: clamp void cells to ambient before and after the
    unmasked step; inactive innermost-radius cells track the inner ambient.
    Matches reference ``adi_step_masked``
    (quick_spiral_deposition_gif_v5.py:31-70)."""
    rin = robin_inner if robin_inner is not None else robin_outer
    rvd = robin_void if robin_void is not None else robin_outer
    ambient_void = rvd.T_inf
    ambient_inner = rin.T_inf

    active = active.astype(bool)
    T_work = jnp.where(active, T, ambient_void)
    T1 = adi_step(T_work, grid, mat, dt=dt, robin_outer=robin_outer, zbc=zbc,
                  robin_inner=robin_inner, source=source, scheme=scheme,
                  theta=theta, implementation=implementation,
                  interpret=interpret)
    T1 = jnp.where(active, T1, ambient_void)
    # Innermost radial ring: inactive cells tied to the inner ambient
    # (quick_spiral_deposition_gif_v5.py:66-69).
    T1 = T1.at[0].set(jnp.where(active[0], T1[0], ambient_inner))
    return T1
