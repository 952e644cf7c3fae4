"""Mask-aware cylindrical ADI step with Robin at material/void interfaces.

The reference has no mask-aware cylindrical solver: its ``adi_step_masked``
(quick_spiral_deposition_gif_v5.py:31-70) clamps void cells to ambient and
runs the unmasked core, so every material/void interface cools with an
effective film coefficient k/dx (thousands of W/m^2/K) instead of the
physical convective h — inconsistent with its own analytic spiral oracle,
which applies Robin h at the growth front (spiral_analytic_solution.py:193-204).

This module is the physically consistent masked solver, built the same way as
the Cartesian core (adi3d_numba_coeff.py:57-118 semantics): couplings are
severed across active/void boundaries and every *exposed face* of an active
cell — interior interface or domain end alike — contributes a Robin sink
``theta*dt*alpha*(h/k)*(A_face/V_cell)`` to the diagonal (and ``*T_inf`` to
the RHS).  In the cylindrical metric the face/volume ratios are

    r-faces:   A/V = r_{i+-1/2} / (r_i dr)
    phi-faces: A/V = 1 / (r_i dphi)
    z-faces:   A/V = 1 / dz

which makes the domain-boundary rows *identical* to the unmasked core's
ghost-cell elimination (adi3d_cyl_phi_v3.py:189-202, :276-294) — interface
and boundary Robin unify into one formulation.

Backward-Euler chaining r -> phi -> z, matching the unmasked BE step.  The
phi sweep solves mask-broken *cyclic* tridiagonal systems (Sherman–Morrison;
the FFT path requires circulant operators and only applies to the unmasked
core).  Void rows are identity rows pinned to the void ambient.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..solvers.thomas import cyclic_thomas, thomas
from .cylindrical import RobinBC, ZFaceBC

__all__ = ["MaskedRobinPlan", "build_masked_robin_plan",
           "masked_robin_solve", "adi_step_masked_robin"]


class MaskedRobinPlan(NamedTuple):
    """Per-sweep inputs of the masked-Robin step, precomputed from the
    activation mask (rebuild on birth events only).  Each sweep tuple is
    ``(cup_lo, cup_hi, geo_lo, geo_hi, sink, sink_rhs)`` — bool coupling
    masks (void/pin folded in), BROADCAST geometry factors (columns/scalars,
    not materialized fields: storing folded f32 coupling fields measured
    slower than recomputing from 1-byte masks), and the Robin
    sink fields, all per unit ``fac = dt*alpha``."""

    active: jax.Array
    pin: jax.Array
    pin_val: jax.Array
    ambient: jax.Array
    r: tuple
    phi: tuple | None
    z: tuple


def _shift(m: jax.Array, axis: int, direction: int, fill=False) -> jax.Array:
    pad = [(0, 0)] * m.ndim
    sl = [slice(None)] * m.ndim
    if direction == +1:
        pad[axis] = (0, 1)
        sl[axis] = slice(1, None)
    else:
        pad[axis] = (1, 0)
        sl[axis] = slice(0, -1)
    return jnp.pad(m, pad, constant_values=fill)[tuple(sl)]


def adi_step_masked_robin(T: jax.Array, grid: CylindricalGrid, mat: Material, *,
                          dt, active: jax.Array,
                          robin_outer: RobinBC, zbc: ZFaceBC,
                          robin_inner: RobinBC | None = None,
                          h_void: float = 0.0, T_inf_void: float = 20.0,
                          h_front: float | None = None,
                          source: jax.Array | None = None,
                          constrain=None,
                          implementation: str = "auto",
                          interpret: bool = False) -> jax.Array:
    """One BE step of the masked cylindrical problem.

    Parameters
    ----------
    active : (nr, nphi, nz) bool — solid material mask (element birth state).
    robin_outer / robin_inner : Robin data for the *domain* radial faces
        (outer always; inner only on annular grids — a full disk's axis is a
        zero-flux face by metric, r_{-1/2} = 0).
    zbc : domain z-end BCs; kinds "neumann0" | "dirichlet" | "robin".
    h_void, T_inf_void : Robin data applied on interior material/void
        interface faces (all directions).
    h_front : optional override for z+ interface faces (the growth front);
        defaults to ``h_void``.  Lets the front match an end-face film
        coefficient distinct from lateral interfaces.
    constrain : optional ``(x, stage) -> x`` hook called on each sweep's RHS
        with stage in {"r", "phi", "z"} — the multi-chip layer
        (dist/cylindrical.py) passes sharding constraints here so every
        sweep's solve axis stays chip-local.
    implementation / interpret : the tridiagonal solver tier
        (solvers/thomas.py).
    """
    plan = build_masked_robin_plan(grid, mat, active, robin_outer=robin_outer,
                                   zbc=zbc, robin_inner=robin_inner,
                                   h_void=h_void, T_inf_void=T_inf_void,
                                   h_front=h_front, dtype=T.dtype)
    return masked_robin_solve(T, plan, grid, mat, dt=dt, source=source,
                              constrain=constrain,
                              implementation=implementation,
                              interpret=interpret)


def build_masked_robin_plan(grid: CylindricalGrid, mat: Material,
                            active: jax.Array, *, robin_outer: RobinBC,
                            zbc: ZFaceBC, robin_inner: RobinBC | None = None,
                            h_void: float = 0.0, T_inf_void: float = 20.0,
                            h_front: float | None = None,
                            dtype=None) -> MaskedRobinPlan:
    """Precompute the per-sweep coefficient fields (jitted; depends only on
    the activation mask — rebuild on birth events, not per sub-step)."""
    dtype = dtype or jnp.result_type(float)
    active = active.astype(bool)
    nr, nphi, nz = active.shape
    dr, dz, dphi = grid.dr, grid.dz, grid.dphi
    if h_front is None:
        h_front = h_void

    r = np.maximum(np.asarray(grid.r, np.float64), 1e-15)
    r_imh = np.maximum(np.asarray(grid.r_imh, np.float64), 0.0)
    r_iph = np.asarray(grid.r_iph, np.float64)
    inv_k = 1.0 / mat.k

    # Coupling presence per face (both cells active; domain edges absent).
    def coupled(axis, direction):
        return active & _shift(active, axis, direction)

    # Exposed faces: active cell whose neighbor across the face is void or
    # the domain edge.
    def exposed(axis, direction):
        return active & ~_shift(active, axis, direction)

    # ---- per-face Robin sink fields: (h/k) * (A_face / V_cell) ------------
    col = lambda v: jnp.asarray(v, dtype)[:, None, None]

    g_r_minus = col(r_imh / (r * dr))           # A/V for r- faces
    g_r_plus = col(r_iph / (r * dr))            # A/V for r+ faces
    g_phi = col(1.0 / (r * dphi))               # A/V for phi faces
    g_z = 1.0 / dz                              # A/V for z faces

    h_in = robin_inner.h if (grid.is_annular and robin_inner is not None) else 0.0
    t_in = robin_inner.T_inf if robin_inner is not None else T_inf_void
    h_out, t_out = robin_outer.h, robin_outer.T_inf

    idx_r0 = jnp.arange(nr)[:, None, None]
    is_r_first = idx_r0 == 0
    is_r_last = idx_r0 == grid.nr - 1
    idx_z = jnp.arange(nz)[None, None, :]
    is_z_first = idx_z == 0
    is_z_last = idx_z == grid.nz - 1

    def hT(face_exposed, geom, is_domain_slab, h_domain, t_domain, h_ifc, t_ifc):
        """(sink, sink*T_inf) fields for one face direction: Robin sink
        ``(h/k) * A_face/V_cell`` on exposed faces, choosing domain vs
        interface Robin data per cell."""
        h = jnp.where(is_domain_slab, h_domain, h_ifc)
        t_ = jnp.where(is_domain_slab, t_domain, t_ifc)
        s = jnp.where(face_exposed, h * inv_k * geom, 0.0).astype(dtype)
        return s, (s * t_).astype(dtype)

    # z-end BC data: robin -> (h, T_inf); neumann0 -> h=0; dirichlet handled
    # below by pinning rows.
    hz_bot = zbc.h_bot if zbc.kind_bot == "robin" else 0.0
    tz_bot = zbc.T_inf_bot
    hz_top = zbc.h_top if zbc.kind_top == "robin" else 0.0
    tz_top = zbc.T_inf_top

    sink_rm, rhs_rm = hT(exposed(0, -1), g_r_minus, is_r_first, h_in, t_in,
                         h_void, T_inf_void)
    sink_rp, rhs_rp = hT(exposed(0, +1), g_r_plus, is_r_last, h_out, t_out,
                         h_void, T_inf_void)
    # phi faces are PERIODIC: exposure wraps around, no domain edge
    exp_pm = active & ~jnp.roll(active, +1, 1)
    exp_pp = active & ~jnp.roll(active, -1, 1)
    s1, r1 = hT(exp_pm, g_phi, False, 0.0, 0.0, h_void, T_inf_void)
    s2, r2 = hT(exp_pp, g_phi, False, 0.0, 0.0, h_void, T_inf_void)
    sink_pm, rhs_pm = s1 + s2, r1 + r2
    sink_zm, rhs_zm = hT(exposed(2, -1), g_z, is_z_first, hz_bot, tz_bot,
                         h_void, T_inf_void)
    sink_zp, rhs_zp = hT(exposed(2, +1), g_z, is_z_last, hz_top, tz_top,
                         h_front, T_inf_void)

    # Dirichlet z-end rows: active cells in the end slab pinned to the value.
    pin = jnp.zeros(active.shape, bool)
    pin_val = jnp.zeros(active.shape, dtype)
    if zbc.kind_bot == "dirichlet":
        pb = active & is_z_first
        pin = pin | pb
        pin_val = jnp.where(pb, zbc.T_bot, pin_val)
    if zbc.kind_top == "dirichlet":
        pt = active & is_z_last
        pin = pin | pt
        pin_val = jnp.where(pt, zbc.T_top, pin_val)

    live = active & ~pin   # rows with couplings/sinks

    def pack(cup_lo, cup_hi, geom_lo, geom_hi, sink, sink_rhs):
        """Fold void/pin into the bool coupling masks and sink fields; keep
        the geometry as broadcasts (cheap to re-expand per step)."""
        return (cup_lo & live, cup_hi & live,
                jnp.asarray(geom_lo, dtype), jnp.asarray(geom_hi, dtype),
                jnp.where(live, sink, 0.0), jnp.where(live, sink_rhs, 0.0))

    geo_r_lo = col(r_imh / (r * dr * dr))
    geo_r_hi = col(r_iph / (r * dr * dr))
    r_sw = pack(coupled(0, -1), coupled(0, +1), geo_r_lo, geo_r_hi,
                sink_rm + sink_rp, rhs_rm + rhs_rp)

    phi_sw = None
    if nphi > 1:
        geo_phi = col(1.0 / (r * r * dphi * dphi))
        if not grid.is_annular:
            # axis-row regularity on full disks (adi3d_cyl_phi_v3.py:314-317)
            geo_phi = geo_phi.at[0].set(0.0)
        phi_sw = pack(jnp.roll(active, 1, 1) & active,
                      jnp.roll(active, -1, 1) & active, geo_phi, geo_phi,
                      sink_pm, rhs_pm)

    geo_z = jnp.full((), 1.0 / (dz * dz), dtype)
    z_sw = pack(coupled(2, -1), coupled(2, +1), geo_z, geo_z,
                sink_zm + sink_zp, rhs_zm + rhs_zp)

    return MaskedRobinPlan(active, pin, pin_val,
                           jnp.asarray(T_inf_void, dtype), r_sw, phi_sw, z_sw)


def masked_robin_solve(T: jax.Array, plan: MaskedRobinPlan,
                       grid: CylindricalGrid, mat: Material, *, dt,
                       source: jax.Array | None = None, constrain=None,
                       implementation: str = "auto",
                       interpret: bool = False) -> jax.Array:
    """One BE step from a prebuilt plan (per-step work: scale the plan's
    per-unit-fac fields by ``fac = dt*alpha`` and solve the three sweeps)."""
    kw = dict(implementation=implementation, interpret=interpret)
    if constrain is None:
        constrain = lambda x, stage: x
    dtype = T.dtype
    active = plan.active
    pin = plan.pin
    ambient = plan.ambient
    fac = jnp.asarray(dt * mat.alpha, dtype)  # BE: theta = 1

    def sweep(rhs, axis, sw, periodic=False):
        cup_lo, cup_hi, geo_lo, geo_hi, sink, sink_rhs = sw
        mv = lambda t: jnp.moveaxis(t, axis, 0)
        d = rhs + fac * sink_rhs
        d = jnp.where(active, d, ambient)
        d = jnp.where(pin, plan.pin_val, d)

        a = jnp.where(cup_lo, -fac * geo_lo, 0.0).astype(dtype)
        c = jnp.where(cup_hi, -fac * geo_hi, 0.0).astype(dtype)
        b = 1.0 - (a + c) + fac * sink     # void/pinned rows: exactly 1
        solve = cyclic_thomas if periodic else thomas
        x = solve(mv(a), mv(b), mv(c), mv(d), **kw)
        return jnp.moveaxis(x, 0, axis)

    R0 = T if source is None else T + dt * source / (mat.rho * mat.cp)
    R0 = jnp.where(active, R0, ambient)

    X = sweep(constrain(R0, "r"), 0, plan.r)
    if plan.phi is not None:
        X = sweep(constrain(X, "phi"), 1, plan.phi, periodic=True)
    X = sweep(constrain(X, "z"), 2, plan.z)
    return jnp.where(active, X, ambient)
