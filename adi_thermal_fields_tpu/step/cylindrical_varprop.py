"""Variable-property cylindrical (r, phi, z) ADI step — beyond-reference.

The reference's cylindrical core (adi3d_cyl_phi_v3.py) is constant-property;
at WAAM temperatures the spiral/tube deposition problems it models are
dominated by the same physics the Cartesian varprop path supplies
(step/cartesian_varprop.py): temperature-dependent conductivity k(T), heat
capacity cp(T), and latent heat via the apparent-cp construction.  This
module brings that capability to the cylindrical family.

Discretization (finite volume, backward Euler, Picard-frozen properties):

    rho cp(T^n) (T^{n+1} - T^n)/dt = div( k(T^n) grad T^{n+1} ) + S

with face conductivities the harmonic mean of the adjacent cells' k(T^n)
(the exact interface-flux-continuity choice, as in the Cartesian path), and
per-cell w = 1/(rho cp(T^n)).  Sweeps are chained r -> phi -> z exactly like
the constant-property BE step (step/cylindrical.adi_step; reference
adi3d_cyl_phi_v3.py:338-350), each solving per-cell tridiagonal FIELDS:

    r :  a_i = -dt w_i kf_i r_{i-1/2}/(r_i dr^2),  c_i from kf_{i+1},
         Robin at the outer (and annular-inner) face by ghost elimination —
         note h/k(T) * (dt k(T) w) = dt h w: the boundary conductivity
         cancels, so Robin rows need no k(T) at all (same cancellation as
         the Cartesian Robin sink h/(rho cp dx)).
    phi: periodic couplings -dt w kf / (r^2 dphi^2) (cyclic Thomas with the
         wrap carried by a[0]/c[n-1]); the axis row of full-disk grids is
         decoupled for regularity (reference phi_solve_spectral:314-322).
    z :  interior couplings -dt w kf / dz^2; end rows neumann0 (face 0),
         robin (dt w h/dz diagonal + source), dirichlet (pinned identity).

``active`` (optional) pre-masks every face to zero across void cells —
void rows become identities that hold their value (adiabatic internal
boundaries), and Robin edge rows are gated to active cells.  The
reference-semantics clamp wrapper (quick_spiral_deposition_gif_v5.py:31-70)
is ``adi_step_cyl_varprop_masked``.

Each sweep's a/b/c/d are built by XLA and solved by the batched Thomas
(cyclic for phi, solvers/thomas.py); ``implementation`` picks the solver
tier ("auto": the Triton kernel on a GPU, the scan on the CPU).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..solvers.thomas import cyclic_thomas, thomas
from .cartesian import shift_in
from .cartesian_varprop import _face_g
from .cylindrical import RobinBC, ZFaceBC

__all__ = ["adi_step_cyl_varprop", "adi_step_cyl_varprop_masked"]


def _ev(tab, const, T, dtype):
    """Evaluate a property table (None/scalar/callable) at T in dtype."""
    if tab is None:
        return jnp.full(T.shape, const, dtype)
    if callable(tab):
        return tab(T).astype(dtype)
    return jnp.full(T.shape, float(tab), dtype)


def _props(T, mat_ref: Material, k_table, cp_table):
    """Per-axis (k_r, k_phi, k_z)(T^n) and w = 1/(rho cp(T^n)) in T.dtype.

    k_table: None/scalar/callable (isotropic — one evaluation shared by all
    three axes) or a 3-tuple of those (anisotropic conductivity, e.g. WAAM
    beads conducting better along the deposition direction than across
    layer interfaces — mirroring step/cartesian_varprop.adi_step_varprop's
    per-axis tables)."""
    dtype = T.dtype
    ev = lambda tab, const: _ev(tab, const, T, dtype)
    if isinstance(k_table, (tuple, list)):
        if len(k_table) != 3:
            raise ValueError("anisotropic k_table must be a 3-tuple "
                             "(k_r, k_phi, k_z)")
        ks = tuple(ev(t, mat_ref.k) for t in k_table)
    else:
        kf = ev(k_table, mat_ref.k)
        ks = (kf, kf, kf)
    cpf = ev(cp_table, mat_ref.cp)
    w = (1.0 / (mat_ref.rho * cpf)).astype(dtype)
    return ks, w


def _face_phi(kf, active):
    """Periodic lo-face harmonic conductivity along axis 1:
    ``f[:, j] = harm(k[:, j-1], k[:, j])`` (j-1 wrapping), zero across
    void when ``active`` is given."""
    km = jnp.roll(kf, 1, axis=1)
    denom = km + kf
    f = jnp.where(denom > 0,
                  2.0 * km * kf / jnp.where(denom > 0, denom, 1.0), 0.0)
    if active is not None:
        f = jnp.where(active & jnp.roll(active, 1, axis=1), f, 0.0)
    return f


def adi_step_cyl_varprop(T: jax.Array, grid: CylindricalGrid,
                         mat_ref: Material, *, dt,
                         robin_outer: RobinBC, zbc: ZFaceBC,
                         k_table=None, cp_table=None,
                         robin_inner: RobinBC | None = None,
                         active: jax.Array | None = None,
                         h_void: float = 0.0, T_inf_void: float = 20.0,
                         h_front: float | None = None,
                         source: jax.Array | None = None,
                         emissivity: float = 0.0,
                         scheme: str = "be", theta: float = 0.5,
                         implementation: str = "auto",
                         interpret: bool = False,
                         constrain=None, z_solver=None) -> jax.Array:
    """One variable-property cylindrical step (see module docstring).

    scheme: "be" (backward Euler, default — robust near the latent-heat
    cp spike) or "douglas" (Douglas–Gunn stabilizing correction, second
    order in time at theta=0.5; the affine operators are built from the
    same coupling/sink streams as the implicit solves, so the corrections
    cancel and steady states are fixed points — the varprop analogue of
    step/cylindrical.adi_step scheme="douglas").

    k_table / cp_table: None (constant), a scalar, or a traceable
    ``T -> field`` callable (e.g. PropertyTable, apparent_cp for latent
    heat, melt_pool_enhanced_k — step/cartesian_varprop.py).  k_table may
    also be a 3-tuple (k_r, k_phi, k_z) of those for ANISOTROPIC
    conductivity (mirroring the Cartesian per-axis tables).
    With both None and no mask this reduces exactly to the constant
    backward-Euler step (tested to f64 tolerance vs cylindrical.adi_step).

    h_void / T_inf_void / h_front: with ``active``, Robin data applied on
    interior material/void interface faces per sweep axis (``h_front``
    overrides z+ interface faces — the growth front), mirroring the
    constant-property masked solver (step/cylindrical_masked.
    adi_step_masked_robin); with the per-face geometric areas
    r_{i∓1/2}/(r dr), 1/(r dphi), 1/dz.  The cell conductivity cancels by
    the same ghost-elimination identity as the domain Robin rows, so the
    sinks are pure ``dt w h (A/V)`` terms.

    emissivity: > 0 adds the Picard-linearized radiative film
    ``h_rad(T^n) = eps sigma (Tk + Tk_inf)(Tk^2 + Tk_inf^2)`` (bc/radiation.
    radiative_h, exact Robin factorization of Stefan-Boltzmann) to EVERY
    exposed film, each against its own ambient: the outer (and annular
    inner) Robin ring, the z-face Robin end, and the material/void
    interface sinks (h_void / h_front) — the same composition the Cartesian
    engine applies (apps/engine.py emissivity=).  Cavity self-irradiation
    on the inner ring and across void gaps is neglected (view factor 1 to
    ambient), as in the Cartesian path.

    constrain: optional ``(x, stage) -> x`` hook called on each sweep's RHS
    with stage in {"r", "phi", "z"}; the multi-chip layer
    (dist/cylindrical.sharded_cyl_varprop_step) passes sharding constraints
    here so every solve axis is chip-local (and asks for the scan: a
    Pallas call has no partitioning rule for sharded operands).

    z_solver: optional ``(a, b, c, d) -> x`` tridiagonal solver in the
    z-LEADING (nz, nr, nphi) layout replacing the default z solve — the
    long-axis decomposition (dist/cylindrical.sharded_cyl_varprop_longz)
    passes the substructured distributed Thomas here so a z-sharded field
    never reshards.
    """
    if jnp.dtype(T.dtype).itemsize < 4:
        # sub-f32 states (bf16): solve at f32 and downcast once
        out = adi_step_cyl_varprop(
            T.astype(jnp.float32), grid, mat_ref, dt=dt,
            robin_outer=robin_outer, zbc=zbc, k_table=k_table,
            cp_table=cp_table, robin_inner=robin_inner, active=active,
            h_void=h_void, T_inf_void=T_inf_void, h_front=h_front,
            source=source, emissivity=emissivity, scheme=scheme,
            theta=theta, implementation=implementation,
            interpret=interpret, constrain=constrain, z_solver=z_solver)
        return out.astype(T.dtype)
    kw = dict(implementation=implementation, interpret=interpret)
    if constrain is None:
        constrain = lambda x, stage: x
    dtype = T.dtype
    nr, nphi, nz = grid.nr, grid.nphi, grid.nz
    dt = jnp.asarray(dt, dtype)
    act = None if active is None else active.astype(bool)

    (kf_r, kf_p, kf_z), w = _props(T, mat_ref, k_table, cp_table)
    dw = dt * w

    # --- geometry columns (static numpy, as step/cylindrical._r_geometry) --
    r = np.maximum(np.asarray(grid.r, np.float64), 1e-15)
    r_imh = np.maximum(np.asarray(grid.r_imh, np.float64), 1e-15)
    r_iph = np.asarray(grid.r_iph, np.float64)
    dr = grid.dr
    col = lambda v: jnp.asarray(v, dtype)[:, None, None]
    ga_r = col(r_imh / (r * dr * dr))       # lo-face geometric factor
    gc_r = col(r_iph / (r * dr * dr))       # hi-face geometric factor

    gate = (lambda x: x) if act is None else (
        lambda x: jnp.where(act, x, jnp.zeros((), dtype)))

    # Picard-linearized radiative films (docstring): per-cell h_rad(T^n)
    # against each surface's own ambient; zero-cost when emissivity == 0
    if emissivity > 0.0:
        from ..bc.radiation import radiative_h
        hr = lambda t, t_inf: radiative_h(t, emissivity, t_inf).astype(dtype)
    else:
        hr = lambda t, t_inf: jnp.zeros((), dtype)
    hr_void = hr(T, T_inf_void)   # scalar zero or full field

    # interior material/void interface Robin sinks (active mode only)
    h_f = h_void if h_front is None else h_front
    sink_on = act is not None and (h_void != 0.0 or h_f != 0.0
                                   or emissivity > 0.0)
    zero = jnp.zeros((), dtype)

    def exposed(ax, d):
        """Active cells whose (ax, d) neighbor exists and is void."""
        return act & ~shift_in(act, ax, d, fill=True)

    # --- per-axis streams --------------------------------------------------
    # per-sweep Robin STREAMS (geometry included, dw NOT): sink = sum of
    # h*(A/V) films, srhs = sum of h*(A/V)*T_inf — each surface against its
    # own ambient.  The solve consumes b = 1 + dw*(couplings + sink) and
    # d = rhs + dw*srhs, identically on every implementation tier; the
    # Douglas scheme builds its BC-consistent affine operators
    # L_i(T) = w*(couplings(T) - (couplings + sink)*T + srhs) from the SAME
    # streams, so the corrections cancel exactly (steady states are fixed
    # points, as in step/cylindrical.r_operator/z_operator).
    fr = _face_g(kf_r, 0, -1, act if act is not None else
                 jnp.ones(T.shape, bool)).astype(dtype)
    fr_hi = jnp.concatenate([fr[1:], jnp.zeros_like(fr[:1])], axis=0)
    sink_r = jnp.zeros(T.shape, dtype)
    srhs_r = jnp.zeros(T.shape, dtype)
    # Robin edge rows: h/k ghost elimination — the cell conductivity
    # cancels against the face flux (docstring), leaving dt w h geometry
    if robin_outer is not None and (robin_outer.h != 0.0
                                    or emissivity > 0.0):
        g_out = float(r_iph[nr - 1] / (r[nr - 1] * dr))
        s = g_out * (robin_outer.h + hr(T[nr - 1], robin_outer.T_inf))
        if act is not None:
            s = jnp.where(act[nr - 1], s, 0.0)
        sink_r = sink_r.at[nr - 1].add(s)
        srhs_r = srhs_r.at[nr - 1].add(s * robin_outer.T_inf)
    if (grid.is_annular and robin_inner is not None
            and (robin_inner.h != 0.0 or emissivity > 0.0)):
        g_in = float(r_imh[0] / (r[0] * dr))
        s = g_in * (robin_inner.h + hr(T[0], robin_inner.T_inf))
        if act is not None:
            s = jnp.where(act[0], s, 0.0)
        sink_r = sink_r.at[0].add(s)
        srhs_r = srhs_r.at[0].add(s * robin_inner.T_inf)
    if sink_on:
        s = (h_void + hr_void) * (
            jnp.where(exposed(0, -1), col(r_imh / (r * dr)), zero)
            + jnp.where(exposed(0, +1), col(r_iph / (r * dr)), zero))
        sink_r = sink_r + s
        srhs_r = srhs_r + s * T_inf_void
    def solve_r(rhs, dwx):
        d = constrain(rhs, "r")
        a = -dwx * ga_r * fr
        c = -dwx * gc_r * fr_hi
        b = 1.0 + dwx * (ga_r * fr + gc_r * fr_hi + sink_r)
        return thomas(a, b, c, d + dwx * srhs_r, **kw)

    # --- phi streams (axis 1, periodic) -----------------------------------
    if nphi > 1:
        gphi = col(1.0 / (r * r * grid.dphi * grid.dphi))
        fp = _face_phi(kf_p, act).astype(dtype)
        if not grid.is_annular:
            fp = fp.at[0].set(0.0)      # axis-row regularity (full disk)
        fp_hi = jnp.roll(fp, -1, axis=1)
        sink_p = jnp.zeros(T.shape, dtype)
        srhs_p = jnp.zeros(T.shape, dtype)
        if sink_on:
            e_lo = act & ~jnp.roll(act, 1, axis=1)
            e_hi = act & ~jnp.roll(act, -1, axis=1)
            gph = col(1.0 / (np.maximum(r, 1e-15) * grid.dphi))
            s = (h_void + hr_void) * gph * (e_lo.astype(dtype)
                                            + e_hi.astype(dtype))
            if not grid.is_annular:
                s = s.at[0].set(0.0)        # axis-row regularity
            sink_p = sink_p + s
            srhs_p = srhs_p + s * T_inf_void
        def solve_phi(rhs, dwx):
            d_phi = constrain(rhs, "phi")
            ap = -dwx * gphi * fp
            cp = -dwx * gphi * fp_hi
            bp = 1.0 + dwx * (gphi * (fp + fp_hi) + sink_p)
            t1 = lambda x: jnp.moveaxis(x, 1, 0)   # (nphi, nr, nz)
            return jnp.moveaxis(
                cyclic_thomas(t1(ap), t1(bp), t1(cp),
                              t1(d_phi + dwx * srhs_p), **kw), 0, 1)
    else:
        solve_phi = None

    # --- z streams (axis 2) -------------------------------------------------
    # end faces: Robin rows fold into the sink/srhs streams; Dirichlet rows
    # zero their STATIC geometry entries and pin the rhs per solve (the
    # shared face conductivity stays live, so the neighbor keeps its
    # coupling into the pinned value — identical linear system to explicit
    # row surgery)
    ivz2 = 1.0 / (grid.dz * grid.dz)
    geoz = np.full(nz, ivz2)
    z_pins = []   # (idx, pin value) applied to every z-solve rhs
    t2 = lambda x: jnp.moveaxis(x, 2, 0)   # (nz, nr, nphi)

    fz = _face_g(kf_z, 2, -1, act if act is not None else
                 jnp.ones(T.shape, bool)).astype(dtype)
    fz_hi = jnp.concatenate([fz[:, :, 1:], jnp.zeros_like(fz[:, :, :1])],
                            axis=2)
    sink_z = jnp.zeros(T.shape, dtype)
    srhs_z = jnp.zeros(T.shape, dtype)
    if sink_on:
        # material/void interface films: h_void on the lo face, h_front on
        # the hi face
        e_lo = act & ~shift_in(act, 2, -1, fill=True)
        e_hi = act & ~shift_in(act, 2, +1, fill=True)
        s = ((h_void + hr_void) * e_lo.astype(dtype)
             + (h_f + hr_void) * e_hi.astype(dtype)) / grid.dz
        sink_z = sink_z + s
        srhs_z = srhs_z + s * T_inf_void
    for idx, kind, h, t_inf, t_dir in (
            (0, zbc.kind_bot, zbc.h_bot, zbc.T_inf_bot, zbc.T_bot),
            (nz - 1, zbc.kind_top, zbc.h_top, zbc.T_inf_top, zbc.T_top)):
        if kind == "neumann0":
            continue                       # face conductivity already 0
        if kind == "robin":
            s = (float(h) + hr(T[:, :, idx], float(t_inf))) / grid.dz
            if act is not None:
                s = jnp.where(act[:, :, idx], s, 0.0)
            sink_z = sink_z.at[:, :, idx].add(s)
            srhs_z = srhs_z.at[:, :, idx].add(s * float(t_inf))
        elif kind == "dirichlet":
            geoz[idx] = 0.0
            z_pins.append((idx, float(t_dir)))
            sink_z = sink_z.at[:, :, idx].set(0.0)
            srhs_z = srhs_z.at[:, :, idx].set(0.0)
        else:
            raise ValueError(f"unknown z-face BC kind: {kind!r}")

    def solve_z(rhs, dwx):
        dz_rhs = constrain(rhs, "z")
        for idx, t_dir in z_pins:
            pin = jnp.asarray(t_dir, dtype)
            if act is not None:  # void end cells hold their value
                pin = jnp.where(act[:, :, idx], pin, dz_rhs[:, :, idx])
            dz_rhs = dz_rhs.at[:, :, idx].set(pin)
        colz = lambda v: jnp.asarray(v, dtype)[None, None, :]
        az = -dwx * colz(geoz) * fz
        cz = -dwx * colz(geoz) * fz_hi
        bz = 1.0 + dwx * (colz(geoz) * (fz + fz_hi) + sink_z)
        solve = z_solver or (lambda *abcd: thomas(*abcd, **kw))
        return jnp.moveaxis(
            solve(t2(az), t2(bz), t2(cz), t2(dz_rhs + dwx * srhs_z)), 0, 2)

    # --- scheme dispatch ---------------------------------------------------
    if scheme == "be":
        R0 = T
        if source is not None:
            R0 = T + gate(dw * source)
        X = solve_r(R0, dw)
        if solve_phi is not None:
            X = solve_phi(X, dw)
        return solve_z(X, dw)

    if scheme != "douglas":
        raise ValueError(f"unknown scheme: {scheme!r}")

    # Douglas–Gunn with stabilizing correction, second-order in time for
    # theta = 0.5 (step/cylindrical.adi_step scheme="douglas" structure),
    # with the affine operators built from the SAME streams the solves
    # consume — so (I - th*dt*L_i')Y = X - th*dt*L_i(T) + th*dt*w*srhs_i
    # cancels exactly and steady states are fixed points.
    th = theta if 0.0 < theta <= 1.0 else 0.5

    def shift_ax(x, axis, d):
        return shift_in(x, axis, d, fill=0.0)

    colz = lambda v: jnp.asarray(v, dtype)[None, None, :]
    Lr = w * (ga_r * fr * shift_ax(T, 0, -1) + gc_r * fr_hi
              * shift_ax(T, 0, +1)
              - (ga_r * fr + gc_r * fr_hi + sink_r) * T + srhs_r)
    if solve_phi is not None:
        Lp = w * (gphi * fp * jnp.roll(T, 1, axis=1)
                  + gphi * fp_hi * jnp.roll(T, -1, axis=1)
                  - (gphi * (fp + fp_hi) + sink_p) * T + srhs_p)
    else:
        Lp = jnp.zeros((), dtype)
    Lz = w * (colz(geoz) * fz * shift_ax(T, 2, -1)
              + colz(geoz) * fz_hi * shift_ax(T, 2, +1)
              - (colz(geoz) * (fz + fz_hi) + sink_z) * T + srhs_z)
    Y0 = T + dt * (Lr + Lp + Lz)
    if source is not None:
        Y0 = Y0 + gate(dw * source)
    thdw = th * dw
    thdt = jnp.asarray(th, dtype) * dt
    X = solve_r(Y0 - thdt * Lr, thdw)
    if solve_phi is not None:
        X = solve_phi(X - thdt * Lp, thdw)
    return solve_z(X - thdt * Lz, thdw)


def adi_step_cyl_varprop_masked(T: jax.Array, grid: CylindricalGrid,
                                mat_ref: Material, *, dt,
                                robin_outer: RobinBC, zbc: ZFaceBC,
                                active: jax.Array,
                                k_table=None, cp_table=None,
                                robin_inner: RobinBC | None = None,
                                robin_void: RobinBC | None = None,
                                source: jax.Array | None = None,
                                emissivity: float = 0.0,
                                scheme: str = "be", theta: float = 0.5,
                                implementation: str = "auto",
                                interpret: bool = False,
                                constrain=None) -> jax.Array:
    """Element-birth clamp wrapper — reference ``adi_step_masked`` semantics
    (quick_spiral_deposition_gif_v5.py:31-70) on the varprop step: void
    cells clamped to ambient before and after, inactive innermost-ring
    cells tied to the inner ambient.  For the face-decoupled (adiabatic)
    treatment pass ``active=`` to ``adi_step_cyl_varprop`` directly."""
    rin = robin_inner if robin_inner is not None else robin_outer
    rvd = robin_void if robin_void is not None else robin_outer
    active = active.astype(bool)
    T_work = jnp.where(active, T, rvd.T_inf)
    T1 = adi_step_cyl_varprop(T_work, grid, mat_ref, dt=dt,
                              robin_outer=robin_outer, zbc=zbc,
                              k_table=k_table, cp_table=cp_table,
                              robin_inner=robin_inner, source=source,
                              emissivity=emissivity, scheme=scheme,
                              theta=theta,
                              implementation=implementation,
                              interpret=interpret, constrain=constrain)
    T1 = jnp.where(active, T1, rvd.T_inf)
    T1 = T1.at[0].set(jnp.where(active[0], T1[0], rin.T_inf))
    return T1
