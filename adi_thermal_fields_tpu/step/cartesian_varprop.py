"""Cartesian ADI step with temperature-dependent material properties.

Beyond-reference capability (the reference is constant-coefficient
throughout, adi3d_numba_coeff.py:21-23): conductivity k(T) and volumetric
heat capacity rho*cp(T) given as lookup tables, evaluated at T^n (Picard
linearization — standard for ADI heat solvers; the step remains linear and
unconditionally stable in theta >= 1/2 for frozen coefficients).

Discretization (finite-volume, flux form):

    rho cp_i dT_i/dt = sum_faces k_face (T_nbr - T_i) / dx^2 + BC terms

with the HARMONIC face conductivity ``k_face = 2 k_i k_j / (k_i + k_j)``
(continuity of flux across the face; exact for a two-slab steady state).
Couplings exist only between in-mask neighbors, as in the constant-k core.
Latent heat enters through an apparent heat capacity over the mushy
interval (``apparent_cp``), the standard fixed-grid enthalpy treatment.

The per-axis implicit sweeps solve, per pencil,

    (1 + theta*(g_lo + g_hi) + dt*C_ax) u_i
        - theta*g_lo u_{i-1} - theta*g_hi u_{i+1}
        = rhs_i + dt*q_ax + dt*C_ax*T_inf,
    g_lo/hi = dt * k_face_lo/hi / (rho cp_i dx^2)

which reduces bitwise to the constant-coefficient sweep when k, cp are
constant.  BC packs are built against a REFERENCE material (their
``h A/(rho cp V)`` uses cp_ref); the step rescales them by cp_ref/cp(T).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..bc.faces import shift_in
from ..bc.packs import CoeffPacks
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..solvers.thomas import thomas

__all__ = ["PropertyTable", "apparent_cp", "melt_pool_enhanced_k",
           "adi_step_varprop"]


@dataclasses.dataclass(frozen=True)
class PropertyTable:
    """Piecewise-linear property vs temperature, clamped at the table ends.
    ``points``/``values`` are 1-D and strictly increasing in ``points``.

    Evaluated as the CLAMP-SUM form ``v0 + sum_i s_i * clip(T - p_i, 0,
    dp_i)`` (slopes ``s_i`` precomputed in f64 on the host) — exactly the
    same piecewise-linear function as ``jnp.interp``, but a pure
    elementwise FMA+clip chain that fuses into its consumers, instead of
    interp's searchsorted-compare chain + two gathers over the full
    field."""

    points: tuple
    values: tuple

    def __call__(self, T: jax.Array) -> jax.Array:
        import numpy as np

        # evaluate at >= f32: table slopes deserve full precision even for
        # bf16 states
        cdt = jnp.promote_types(T.dtype, jnp.float32)
        Tc = T.astype(cdt)
        pts = np.asarray(self.points, np.float64)
        vals = np.asarray(self.values, np.float64)
        acc = jnp.full_like(Tc, float(vals[0]))
        for i in range(len(pts) - 1):
            dp = float(pts[i + 1] - pts[i])
            dv = float(vals[i + 1] - vals[i])
            if dv == 0.0:
                continue
            if dp > 0.0:
                acc = acc + (dv / dp) * jnp.clip(Tc - float(pts[i]), 0.0, dp)
            else:  # duplicate abscissae: a value step at p_i
                acc = acc + dv * (Tc > float(pts[i])).astype(cdt)
        return acc.astype(T.dtype)


def apparent_cp(cp_solid: float, cp_liquid: float, latent_heat: float,
                T_solidus: float, T_liquidus: float,
                n_mushy: int = 8) -> PropertyTable:
    """Apparent-heat-capacity table for phase change on a fixed grid:
    cp(T) carries a plateau ``L / (T_liq - T_sol)`` over the mushy interval
    so that the enthalpy integral includes the latent heat L [J/kg]."""
    dTm = T_liquidus - T_solidus
    if dTm <= 0:
        raise ValueError("T_liquidus must exceed T_solidus")
    cp_mushy = 0.5 * (cp_solid + cp_liquid) + latent_heat / dTm
    eps = 1e-9 * max(1.0, dTm)
    pts = [T_solidus - eps, T_solidus]
    vals = [cp_solid, cp_mushy]
    for i in range(1, n_mushy):
        pts.append(T_solidus + dTm * i / n_mushy)
        vals.append(cp_mushy)
    pts += [T_liquidus, T_liquidus + eps]
    vals += [cp_mushy, cp_liquid]
    return PropertyTable(tuple(pts), tuple(vals))


def melt_pool_enhanced_k(k_solid: float, T_solidus: float, T_liquidus: float,
                         enhancement: float = 4.0,
                         k_liquid: float | None = None) -> PropertyTable:
    """Melt-pool convection proxy: an effective-conductivity k(T) table that
    ramps from ``k_solid`` (or ``k_liquid`` at the liquidus, if given) to
    ``enhancement * k`` above the liquidus.

    Fixed-grid thermal models cannot resolve Marangoni/buoyancy convection
    inside the pool; the standard proxy multiplies the liquid conductivity
    by a factor (typically 2-10x for steel/Ti arc and laser AM) so the pool
    isothermalizes at the rate the real convective mixing would produce.
    Use with ``adi_step_varprop(k_table=...)``; pair with ``apparent_cp``
    for the latent heat of the same interval.  ``enhancement=1`` reduces to
    plain melting (k_solid -> k_liquid across the mushy zone)."""
    if T_liquidus <= T_solidus:
        raise ValueError("T_liquidus must exceed T_solidus")
    kl = k_solid if k_liquid is None else k_liquid
    return PropertyTable(
        (T_solidus, T_liquidus),
        (k_solid, kl * enhancement))


def _face_g(kf, axis, direction, mask):
    """Harmonic face conductivity toward the (axis, direction) neighbor;
    zero across mask boundaries and domain edges."""
    kn = shift_in(kf, axis, direction, fill=0.0)
    mn = shift_in(mask, axis, direction, fill=False)
    denom = kf + kn
    kface = jnp.where(denom > 0, 2.0 * kf * kn / jnp.where(denom > 0, denom, 1.0), 0.0)
    return jnp.where(mask & mn, kface, 0.0)


def adi_step_varprop(T: jax.Array, mask: jax.Array, packs: CoeffPacks,
                     grid: CartesianGrid, mat_ref: Material, *,
                     k_table: PropertyTable | None = None,
                     cp_table: PropertyTable | None = None,
                     dt, theta: float = 0.5, t_inf=0.0,
                     source: jax.Array | None = None,
                     implementation: str = "auto",
                     interpret: bool = False,
                     constrain=None) -> jax.Array:
    """One theta-scheme ADI step with T-dependent k and/or cp.

    mat_ref: the reference material whose rho (constant) and cp were used to
    build ``packs``; constant tables reproduce adi_step_cartesian.
    k_table: a single PropertyTable (isotropic) or a 3-tuple of per-axis
    tables/constants (anisotropic — e.g. WAAM beads conduct better along
    the deposit direction than across layer interfaces).
    implementation / interpret: the tridiagonal solver tier
    (solvers/thomas.py; "auto" = the Triton kernel on a GPU, the scan on
    the CPU).
    constrain: optional ``(x, axis) -> x`` hook applied to each sweep's
    a, b, c, d; the multi-device engine passes sharding constraints that
    keep the solve axis device-local (dist/cartesian.py's layouts).
    """
    mask = mask.astype(bool)
    dtype = T.dtype
    dt = jnp.asarray(dt, jnp.promote_types(dtype, jnp.float32))
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]   # per-axis (anisotropic)

    def k_of(tab):
        if tab is None:
            return jnp.full(T.shape, mat_ref.k, dtype)
        if callable(tab):
            return tab(T)
        return jnp.full(T.shape, float(tab), dtype)

    if isinstance(k_table, (tuple, list)):
        kfs = tuple(k_of(tab) for tab in k_table)
    else:
        kfs = (k_of(k_table),) * 3
    cpf = (cp_table(T) if cp_table is not None
           else jnp.full(T.shape, mat_ref.cp, dtype))
    inv_rc = 1.0 / (mat_ref.rho * cpf)
    # packs carry h*A/(rho*cp_ref*V); rescale to the local cp(T)
    bc_scale = mat_ref.cp / cpf

    # per-face implicit coupling factors g = dt*k_face/(rho cp_i dx^2)
    g = {}
    for ax in range(3):
        g[(ax, -1)] = dt * _face_g(kfs[ax], ax, -1, mask) * inv_rc * inv_d2[ax]
        g[(ax, +1)] = dt * _face_g(kfs[ax], ax, +1, mask) * inv_rc * inv_d2[ax]

    # explicit pass: R0 = T + dt*(1-theta)*sum_faces g*(T_nbr - T)/dt ...
    # (g already includes dt, so the explicit term is (1-theta)*sum g*dT)
    lap = jnp.zeros_like(T)
    for ax in range(3):
        for d in (-1, +1):
            lap = lap + g[(ax, d)] * (shift_in(T, ax, d, fill=0.0) - T)
    R0 = T + (1.0 - theta) * jnp.where(mask, lap, 0.0)
    if source is not None:
        R0 = R0 + jnp.where(mask, dt * source * inv_rc, 0.0)

    def sweep(rhs, axis):
        g_lo = g[(axis, -1)]
        g_hi = g[(axis, +1)]
        coeff_ax = packs.coeff[axis] * bc_scale
        qflux_ax = packs.qflux[axis] * bc_scale
        a = (-theta * g_lo).astype(dtype)
        c = (-theta * g_hi).astype(dtype)
        b = 1.0 + theta * (g_lo + g_hi) + dt * coeff_ax
        d = rhs + dt * qflux_ax + dt * coeff_ax * t_inf
        b = jnp.where(mask, b, 1.0)
        d = jnp.where(mask, d, rhs)
        pin = packs.dir_mask & mask
        a = jnp.where(pin, 0.0, a)
        c = jnp.where(pin, 0.0, c)
        b = jnp.where(pin, 1.0, b)
        d = jnp.where(pin, packs.dir_val, d)
        if constrain is not None:
            a, b, c, d = (constrain(v, axis) for v in (a, b, c, d))
        mv = lambda t: jnp.moveaxis(t, axis, 0)
        x = thomas(mv(a), mv(b), mv(c), mv(d),
                   implementation=implementation, interpret=interpret)
        return jnp.moveaxis(x, 0, axis)

    U = sweep(R0, 0)
    V = sweep(U, 1)
    return sweep(V, 2)
