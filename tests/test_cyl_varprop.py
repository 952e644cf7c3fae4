"""Variable-property cylindrical step (step/cylindrical_varprop.py).

Beyond-reference capability (the reference's cylindrical core,
adi3d_cyl_phi_v3.py, is constant-property): k(T)/cp(T)/latent heat for the
spiral/tube deposition family.  Gates:

  * constant tables reduce EXACTLY (f64 tolerance) to the constant-property
    backward-Euler step (step/cylindrical.adi_step), annular Robin-Robin
    and full-disk (axis-row regularity) alike;
  * each variable-coefficient sweep matches an independent dense-matrix
    numpy oracle built straight from the FV physics;
  * the Triton-kernel solver tier (interpret) is bit-comparable to the
    scan tier;
  * latent heat (apparent_cp) conserves the monotone-cooling property and
    slows cooling through the mushy interval;
  * the clamp-masked wrapper matches reference adi_step_masked semantics.
"""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CylindricalGrid, Material, RobinBC, ZFaceBC
from adi_thermal_fields_tpu.step.cylindrical import adi_step
from adi_thermal_fields_tpu.step.cylindrical_varprop import (
    adi_step_cyl_varprop, adi_step_cyl_varprop_masked)


def _smooth_field(grid, seed=0, lo=20.0, hi=900.0):
    rng = np.random.default_rng(seed)
    T = lo + (hi - lo) * rng.random(grid.shape)
    for _ in range(6):
        for ax in range(3):
            T = 0.5 * T + 0.25 * (np.roll(T, 1, ax) + np.roll(T, -1, ax))
    return jnp.asarray(T)


def test_constant_tables_reduce_to_constant_step():
    """k_table/cp_table = None (or matching constants) must reproduce the
    constant-property BE step to f64 round-off, on an annular grid with
    inner+outer Robin and mixed z BCs, AND on a full disk (axis row)."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    rin = RobinBC(120.0, 25.0)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=140.0,
                  kind_top="robin", h_top=400.0, T_inf_top=20.0)
    for grid, inner in (
            (CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02), rin),
            (CylindricalGrid(9, 12, 10, 6e-4, 1.2e-3), None)):
        T0 = _smooth_field(grid)
        src = jnp.asarray(np.random.default_rng(3).random(grid.shape) * 1e6)
        want = adi_step(T0, grid, mat, dt=0.05, robin_outer=rob, zbc=zbc,
                        robin_inner=inner, source=src, scheme="be")
        for kt, ct in ((None, None), (54.0, 490.0),
                       (lambda T: jnp.full_like(T, 54.0), None)):
            got = adi_step_cyl_varprop(
                T0, grid, mat, dt=0.05, robin_outer=rob, zbc=zbc,
                robin_inner=inner, source=src, k_table=kt, cp_table=ct,
                implementation="xla")
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-12, atol=1e-10)


def test_variable_sweeps_match_dense_oracle():
    """The full varprop step on a tiny annular grid must equal chained
    dense solves built INDEPENDENTLY from the FV physics: harmonic-face
    conductivities, per-cell 1/(rho cp), Robin ghost elimination with the
    k-cancellation, periodic phi wrap, mixed z ends."""
    grid = CylindricalGrid(5, 6, 4, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    rin = RobinBC(120.0, 25.0)
    zbc = ZFaceBC(kind_bot="robin", h_bot=150.0, T_inf_bot=30.0,
                  kind_top="dirichlet", T_top=180.0)
    rng = np.random.default_rng(1)
    T0 = jnp.asarray(rng.random(grid.shape) * 900 + 20)
    kt = lambda T: 30.0 + 0.02 * T
    ct = lambda T: 400.0 + 0.2 * T
    dt = 0.05

    got = adi_step_cyl_varprop(T0, grid, mat, dt=dt, robin_outer=rob,
                               zbc=zbc, robin_inner=rin, k_table=kt,
                               cp_table=ct, implementation="xla")

    # ---- independent numpy oracle -------------------------------------
    T = np.asarray(T0, np.float64)
    k = 30.0 + 0.02 * T
    w = 1.0 / (mat.rho * (400.0 + 0.2 * T))
    harm = lambda a, b: 2.0 * a * b / (a + b)
    nr, nph, nz = grid.shape
    r = np.asarray(grid.r)
    r_imh, r_iph = np.asarray(grid.r_imh), np.asarray(grid.r_iph)
    dr, dphi, dz = grid.dr, grid.dphi, grid.dz

    # r solve per (j, l)
    X = np.empty_like(T)
    for j in range(nph):
        for l in range(nz):
            A = np.zeros((nr, nr))
            rhs = T[:, j, l].copy()
            for i in range(nr):
                A[i, i] = 1.0
                if i > 0:
                    g = harm(k[i - 1, j, l], k[i, j, l]) \
                        * r_imh[i] / (r[i] * dr * dr)
                    A[i, i - 1] -= dt * w[i, j, l] * g
                    A[i, i] += dt * w[i, j, l] * g
                if i < nr - 1:
                    g = harm(k[i, j, l], k[i + 1, j, l]) \
                        * r_iph[i] / (r[i] * dr * dr)
                    A[i, i + 1] -= dt * w[i, j, l] * g
                    A[i, i] += dt * w[i, j, l] * g
            s_out = dt * w[nr - 1, j, l] * rob.h \
                * r_iph[nr - 1] / (r[nr - 1] * dr)
            A[nr - 1, nr - 1] += s_out
            rhs[nr - 1] += s_out * rob.T_inf
            s_in = dt * w[0, j, l] * rin.h * r_imh[0] / (r[0] * dr)
            A[0, 0] += s_in
            rhs[0] += s_in * rin.T_inf
            X[:, j, l] = np.linalg.solve(A, rhs)

    # phi solve per (i, l), periodic
    Y = np.empty_like(X)
    for i in range(nr):
        for l in range(nz):
            A = np.eye(nph)
            g0 = 1.0 / (r[i] * r[i] * dphi * dphi)
            for j in range(nph):
                jm = (j - 1) % nph
                g = harm(k[i, jm, l], k[i, j, l]) * g0
                A[j, jm] -= dt * w[i, j, l] * g
                A[j, j] += dt * w[i, j, l] * g
                jp = (j + 1) % nph
                g = harm(k[i, j, l], k[i, jp, l]) * g0
                A[j, jp] -= dt * w[i, j, l] * g
                A[j, j] += dt * w[i, j, l] * g
            Y[i, :, l] = np.linalg.solve(A, X[i, :, l])

    # z solve per (i, j): robin bottom, dirichlet top
    Z = np.empty_like(Y)
    for i in range(nr):
        for j in range(nph):
            A = np.eye(nz)
            rhs = Y[i, j, :].copy()
            for l in range(nz):
                if l > 0:
                    g = harm(k[i, j, l - 1], k[i, j, l]) / (dz * dz)
                    A[l, l - 1] -= dt * w[i, j, l] * g
                    A[l, l] += dt * w[i, j, l] * g
                if l < nz - 1:
                    g = harm(k[i, j, l], k[i, j, l + 1]) / (dz * dz)
                    A[l, l + 1] -= dt * w[i, j, l] * g
                    A[l, l] += dt * w[i, j, l] * g
            s_bot = dt * w[i, j, 0] * zbc.h_bot / dz
            A[0, 0] += s_bot
            rhs[0] += s_bot * zbc.T_inf_bot
            A[nz - 1, :] = 0.0
            A[nz - 1, nz - 1] = 1.0
            rhs[nz - 1] = zbc.T_top
            Z[i, j, :] = np.linalg.solve(A, rhs)

    np.testing.assert_allclose(np.asarray(got), Z, rtol=1e-11, atol=1e-9)


def test_pallas_field_path_matches_xla():
    """implementation='pallas' (Triton kernel, interpret mode) must agree
    with the XLA scan path to solver round-off on annular AND full-disk
    grids, with variable k and cp."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    kt = lambda T: 30.0 + 0.02 * T
    ct = lambda T: 400.0 + 0.2 * T
    for grid in (CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02),
                 CylindricalGrid(9, 12, 10, 6e-4, 1.2e-3)):
        T0 = _smooth_field(grid, seed=2)
        a = adi_step_cyl_varprop(T0, grid, mat, dt=0.05, robin_outer=rob,
                                 zbc=zbc, k_table=kt, cp_table=ct,
                                 implementation="xla")
        b = adi_step_cyl_varprop(T0, grid, mat, dt=0.05, robin_outer=rob,
                                 zbc=zbc, k_table=kt, cp_table=ct,
                                 implementation="pallas", interpret=True)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-12, atol=1e-9)


def test_latent_heat_slows_cooling_and_stays_monotone():
    """apparent_cp (latent heat in the mushy interval) must slow cooling
    through solidification while keeping the cooldown monotone and bounded
    below by ambient."""
    from adi_thermal_fields_tpu.step.cartesian_varprop import apparent_cp

    grid = CylindricalGrid(8, 12, 10, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 600.0, 30.0)
    rob = RobinBC(2000.0, 20.0)
    zbc = ZFaceBC()
    ct = apparent_cp(600.0, 600.0, 2.7e5, 1400.0, 1500.0)
    T_lat = jnp.full(grid.shape, 1550.0)
    T_ref = jnp.full(grid.shape, 1550.0)
    prev_lat = prev_ref = 1550.0
    for _ in range(25):
        T_lat = adi_step_cyl_varprop(T_lat, grid, mat, dt=0.2,
                                     robin_outer=rob, zbc=zbc, cp_table=ct,
                                     implementation="xla")
        T_ref = adi_step_cyl_varprop(T_ref, grid, mat, dt=0.2,
                                     robin_outer=rob, zbc=zbc,
                                     implementation="xla")
        m_lat, m_ref = float(T_lat.mean()), float(T_ref.mean())
        assert 20.0 < m_lat < prev_lat
        assert 20.0 < m_ref < prev_ref
        prev_lat, prev_ref = m_lat, m_ref
    # the latent run must lag the no-latent run once inside the mushy zone
    assert prev_lat > prev_ref + 30.0, (prev_lat, prev_ref)


def test_masked_clamp_wrapper_semantics():
    """Void cells clamp to the void ambient; inactive innermost-ring cells
    track the inner ambient; active cells evolve by the varprop step on the
    clamped work field (reference adi_step_masked semantics)."""
    grid = CylindricalGrid(6, 10, 8, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    rin = RobinBC(100.0, 25.0)
    zbc = ZFaceBC()
    rng = np.random.default_rng(5)
    active = jnp.asarray(rng.random(grid.shape) < 0.6)
    T0 = _smooth_field(grid, seed=6)
    kt = lambda T: 30.0 + 0.02 * T

    got = adi_step_cyl_varprop_masked(
        T0, grid, mat, dt=0.05, robin_outer=rob, zbc=zbc, active=active,
        robin_inner=rin, k_table=kt, implementation="xla")

    T_work = jnp.where(active, T0, rob.T_inf)
    inner = adi_step_cyl_varprop(T_work, grid, mat, dt=0.05,
                                 robin_outer=rob, zbc=zbc, robin_inner=rin,
                                 k_table=kt, implementation="xla")
    want = jnp.where(active, inner, rob.T_inf)
    want = want.at[0].set(jnp.where(active[0], want[0], rin.T_inf))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_active_face_decoupling():
    """active= pre-masks faces: a fully-isolated void region must hold its
    value exactly (identity rows), and active cells must not read heat
    across the void boundary (adiabatic internal faces)."""
    grid = CylindricalGrid(8, 12, 10, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC()
    active = jnp.ones(grid.shape, bool).at[:, :, 6:].set(False)
    T0 = jnp.full(grid.shape, 900.0).at[:, :, 6:].set(-555.0)
    kt = lambda T: 30.0 + 0.02 * T
    out = adi_step_cyl_varprop(T0, grid, mat, dt=0.05, robin_outer=rob,
                               zbc=zbc, k_table=kt, active=active,
                               implementation="xla")
    out = np.asarray(out)
    # void cells: untouched
    np.testing.assert_array_equal(out[:, :, 6:], -555.0)
    # active cells: cooled from the Robin shell, never below ambient,
    # and never contaminated by the void's -555
    assert out[:, :, :6].min() > 20.0
    assert out[:, :, :6].max() < 900.0


def test_masked_robin_sinks_match_constant_masked_solver():
    """With constant tables, the active-mode varprop step with interior
    void-face Robin sinks (h_void / h_front) must reproduce the
    constant-property masked solver (step/cylindrical_masked.
    adi_step_masked_robin) on ACTIVE cells to f64 round-off — the same
    decoupled-faces + per-face-area sink formulation, built from streamed
    properties instead of a precomputed plan."""
    from adi_thermal_fields_tpu.step.cylindrical_masked import (
        adi_step_masked_robin)

    grid = CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    rin = RobinBC(120.0, 25.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    rng = np.random.default_rng(8)
    active = jnp.asarray(rng.random(grid.shape) < 0.7)
    T0 = _smooth_field(grid, seed=9)
    src = jnp.asarray(rng.random(grid.shape) * 1e6)

    want = adi_step_masked_robin(
        T0, grid, mat, dt=0.05, active=active, robin_outer=rob, zbc=zbc,
        robin_inner=rin, h_void=250.0, T_inf_void=22.0, h_front=150.0,
        source=src, implementation="xla")
    got = adi_step_cyl_varprop(
        T0, grid, mat, dt=0.05, robin_outer=rob, zbc=zbc, robin_inner=rin,
        active=active, h_void=250.0, T_inf_void=22.0, h_front=150.0,
        source=src, implementation="xla")
    a = np.asarray(active)
    np.testing.assert_allclose(np.asarray(got)[a], np.asarray(want)[a],
                               rtol=1e-12, atol=1e-9)


def test_radiation_uniform_field_equals_scalar_film_oracle():
    """emissivity>0 adds the Picard film h_rad(T^n) per surface.  From a
    UNIFORM initial field h_rad is a constant per ambient, so one step must
    EXACTLY (f64 round-off) equal the emissivity=0 step with every scalar
    film pre-augmented by radiative_h(T0, eps, that surface's ambient) —
    an independent closed-form oracle for the radiative coupling."""
    from adi_thermal_fields_tpu.bc.radiation import radiative_h

    mat = Material(7800.0, 490.0, 54.0)
    grid = CylindricalGrid(5, 12, 10, 6e-4, 8e-4, r_inner=0.015)
    eps = 0.6
    T0v = 1400.0
    T0 = jnp.full(grid.shape, T0v)
    rng = np.random.default_rng(7)
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    kt = lambda T: 30.0 + 0.01 * T

    def hrad(t_inf):
        return float(radiative_h(jnp.asarray(T0v, jnp.float64), eps, t_inf))

    rob, rin = RobinBC(250.0, 20.0), RobinBC(60.0, 30.0)
    zbc = ZFaceBC(kind_bot="robin", h_bot=90.0, T_inf_bot=40.0,
                  kind_top="robin", h_top=350.0, T_inf_top=25.0)
    kw = dict(dt=0.05, active=act, k_table=kt, T_inf_void=20.0)

    out_rad = adi_step_cyl_varprop(
        T0, grid, mat, robin_outer=rob, robin_inner=rin, zbc=zbc,
        h_void=45.0, h_front=110.0, emissivity=eps, **kw)

    out_oracle = adi_step_cyl_varprop(
        T0, grid, mat,
        robin_outer=RobinBC(rob.h + hrad(rob.T_inf), rob.T_inf),
        robin_inner=RobinBC(rin.h + hrad(rin.T_inf), rin.T_inf),
        zbc=ZFaceBC(kind_bot="robin", h_bot=zbc.h_bot + hrad(zbc.T_inf_bot),
                    T_inf_bot=zbc.T_inf_bot, kind_top="robin",
                    h_top=zbc.h_top + hrad(zbc.T_inf_top),
                    T_inf_top=zbc.T_inf_top),
        h_void=45.0 + hrad(20.0), h_front=110.0 + hrad(20.0), **kw)

    np.testing.assert_allclose(np.asarray(out_rad), np.asarray(out_oracle),
                               rtol=5e-13, atol=5e-11)
    # and radiation cools faster than convection alone
    out_conv = adi_step_cyl_varprop(
        T0, grid, mat, robin_outer=rob, robin_inner=rin, zbc=zbc,
        h_void=45.0, h_front=110.0, **kw)
    m_rad = float(jnp.where(act, out_rad, jnp.inf).min())
    m_conv = float(jnp.where(act, out_conv, jnp.inf).min())
    assert m_rad < m_conv


def test_compressed_tier_matches_materialized_and_xla():
    """The two solver tiers — 'pallas' (the Triton kernel, interpret mode)
    and 'xla' (scan) — must agree to solver round-off on the RICHEST
    configuration: element-birth mask, mixed-ambient interface sinks,
    growth-front film, radiation, annular inner Robin, and a Dirichlet z
    end (a zeroed-geometry pin row)."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    rin = RobinBC(80.0, 30.0)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                  h_top=400.0, T_inf_top=25.0)
    kt = lambda T: 30.0 + 0.02 * T
    ct = lambda T: 400.0 + 0.2 * T
    for grid, annular in ((CylindricalGrid(8, 16, 12, 5e-4, 1e-3,
                                           r_inner=0.02), True),
                          (CylindricalGrid(9, 12, 10, 6e-4, 1.2e-3), False)):
        rng = np.random.default_rng(11)
        T0 = _smooth_field(grid, seed=4, lo=100.0, hi=1500.0)
        act = jnp.asarray(rng.random(grid.shape) > 0.3)
        kw = dict(dt=0.04, robin_outer=rob, zbc=zbc, k_table=kt,
                  cp_table=ct, robin_inner=rin if annular else None,
                  active=act, h_void=60.0, T_inf_void=20.0, h_front=150.0,
                  emissivity=0.55)
        a = adi_step_cyl_varprop(T0, grid, mat, implementation="xla", **kw)
        b = adi_step_cyl_varprop(T0, grid, mat, implementation="pallas",
                                 interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-12, atol=1e-9)


def test_douglas_constant_tables_reduce_to_constant_douglas():
    """scheme='douglas' with constant tables must reproduce the constant-
    property Douglas–Gunn step (step/cylindrical.adi_step scheme='douglas')
    to f64 round-off — the affine operators and solves are the same
    discretization, built from streams instead of closed-form operators."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    rin = RobinBC(120.0, 25.0)
    zbc = ZFaceBC(kind_bot="robin", h_bot=90.0, T_inf_bot=40.0,
                  kind_top="robin", h_top=500.0, T_inf_top=25.0)
    grid = CylindricalGrid(6, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    T0 = _smooth_field(grid, seed=3)
    ref = adi_step(T0, grid, mat, dt=0.05, robin_outer=rob, robin_inner=rin,
                   zbc=zbc, scheme="douglas", theta=0.5)
    out = adi_step_cyl_varprop(T0, grid, mat, dt=0.05, robin_outer=rob,
                               robin_inner=rin, zbc=zbc, scheme="douglas",
                               theta=0.5, implementation="xla")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-11, atol=1e-8)


def test_douglas_second_order_in_time():
    """Douglas at theta=0.5 converges ~O(dt^2) toward a tiny-dt reference
    while BE converges ~O(dt): halving dt must shrink the Douglas error by
    ~4x (>=3 demanded) and the BE error by ~2x, with variable k(T)
    (the Picard property freeze is evaluated per sub-step in the reference
    too, so it is not the limiting term at these rates)."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(600.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=700.0,
                  T_inf_top=20.0)
    grid = CylindricalGrid(6, 12, 10, 5e-4, 1e-3, r_inner=0.02)
    kt = lambda T: 30.0 + 0.01 * T
    T0 = _smooth_field(grid, seed=5, lo=100.0, hi=900.0)
    t_end = 0.4

    import functools

    @functools.lru_cache(maxsize=None)
    def stepper(scheme):
        return jax.jit(lambda T, dt: adi_step_cyl_varprop(
            T, grid, mat, dt=dt, robin_outer=rob, zbc=zbc, k_table=kt,
            scheme=scheme, implementation="xla"))

    def march(scheme, n):
        T = T0
        f = stepper(scheme)
        dt = jnp.asarray(t_end / n, T0.dtype)
        for _ in range(n):
            T = f(T, dt)
        return np.asarray(T)

    ref = march("douglas", 128)
    e_dg = [np.abs(march("douglas", n) - ref).max() for n in (8, 16)]
    e_be = [np.abs(march("be", n) - ref).max() for n in (8, 16)]
    r_dg = e_dg[0] / e_dg[1]
    r_be = e_be[0] / e_be[1]
    assert r_dg > 3.0, (e_dg, r_dg)          # ~4 = second order
    assert 1.5 < r_be < 3.0, (e_be, r_be)    # ~2 = first order
    assert e_dg[0] < e_be[0]                 # and Douglas is just better


def test_anisotropic_k_tuple():
    """k_table as a 3-tuple (k_r, k_phi, k_z): identical entries reproduce
    the isotropic run exactly, and killing one axis' conductivity leaves
    that direction's gradients standing (direction sensitivity)."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(0.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="neumann0")
    grid = CylindricalGrid(5, 12, 10, 6e-4, 8e-4, r_inner=0.015)
    kt = lambda T: 30.0 + 0.01 * T
    T0 = _smooth_field(grid, seed=6, lo=100.0, hi=900.0)
    kw = dict(dt=0.2, robin_outer=rob, zbc=zbc, implementation="xla")

    iso = adi_step_cyl_varprop(T0, grid, mat, k_table=kt, **kw)
    tup = adi_step_cyl_varprop(T0, grid, mat, k_table=(kt, kt, kt), **kw)
    np.testing.assert_array_equal(np.asarray(tup), np.asarray(iso))

    no_z = adi_step_cyl_varprop(T0, grid, mat, k_table=(kt, kt, 1e-9), **kw)
    zvar = lambda X: float(jnp.var(jnp.diff(X, axis=2)))
    assert zvar(no_z) > 3.0 * zvar(iso)      # z gradients survive
    # the phi cell pitch (r dphi) is ~10x coarser than dz here, so compare
    # a killed k_phi against a strongly ENHANCED one instead of isotropic
    no_p = adi_step_cyl_varprop(T0, grid, mat, k_table=(kt, 1e-9, kt), **kw)
    hi_p = adi_step_cyl_varprop(
        T0, grid, mat, k_table=(kt, lambda T: 100.0 * kt(T), kt), **kw)
    pvar = lambda X: float(jnp.var(X - jnp.roll(X, 1, axis=1)))
    assert pvar(no_p) > 3.0 * pvar(hi_p)     # phi gradients survive


def test_xla_tier_is_differentiable():
    """jax.grad flows through the varprop step's scan tier: gradients of a
    final-field loss wrt the base conductivity and wrt the initial field
    match central finite differences."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    grid = CylindricalGrid(4, 8, 6, 6e-4, 8e-4, r_inner=0.015)
    T0 = _smooth_field(grid, seed=8, lo=100.0, hi=900.0)

    def loss(k0, T0):
        kt = lambda T: k0 + 0.02 * T
        T = T0
        for _ in range(2):
            T = adi_step_cyl_varprop(T, grid, mat, dt=0.05, robin_outer=rob,
                                     zbc=zbc, k_table=kt,
                                     implementation="xla")
        return jnp.mean(T * T)

    g_k, g_T = jax.grad(loss, argnums=(0, 1))(30.0, T0)
    eps = 1e-4
    fd_k = (loss(30.0 + eps, T0) - loss(30.0 - eps, T0)) / (2 * eps)
    np.testing.assert_allclose(float(g_k), float(fd_k), rtol=1e-6)
    v = _smooth_field(grid, seed=9, lo=-1.0, hi=1.0)
    fd_T = (loss(30.0, T0 + eps * v) - loss(30.0, T0 - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g_T, v)), float(fd_T),
                               rtol=1e-6)


def test_radiation_lumped_ode_oracle():
    """Small-Biot validation of the radiative cooling physics: a thin
    uniform annulus with identical films on every exposed surface follows
    the lumped-capacitance ODE
        rho cp V dT/dt = -(h + h_rad(T)) A (T - T_inf)
    with A the TOTAL exposed area (inner + outer + both ends).  The BE
    step's Picard linearization evaluates h_rad at T^n — integrate the ODE
    with the SAME per-step freeze and demand agreement to the spatial
    nonuniformity level (Bi_z ~ 0.01 here -> <0.4%), then sanity-check
    against a fine-step fully-nonlinear RK4 (<1%)."""
    from adi_thermal_fields_tpu.bc.radiation import radiative_h

    mat = Material(7800.0, 490.0, 54.0)
    eps, h, T_inf = 0.7, 40.0, 20.0
    grid = CylindricalGrid(3, 16, 8, 4e-4, 8e-4, r_inner=0.05)
    rob = RobinBC(h, T_inf)
    zbc = ZFaceBC(kind_bot="robin", h_bot=h, T_inf_bot=T_inf,
                  kind_top="robin", h_top=h, T_inf_top=T_inf)
    r_in, r_out = grid.r_imh[0], grid.r_iph[-1]
    height = grid.nz * grid.dz
    A = 2 * np.pi * height * (r_in + r_out) \
        + 2 * np.pi * (r_out ** 2 - r_in ** 2)
    V = np.pi * (r_out ** 2 - r_in ** 2) * height
    aov = A / V

    dt, nsteps = 0.5, 30
    T0 = 1200.0
    T = jnp.full(grid.shape, T0)
    for _ in range(nsteps):
        T = adi_step_cyl_varprop(T, grid, mat, dt=dt, robin_outer=rob,
                                 robin_inner=RobinBC(h, T_inf), zbc=zbc,
                                 emissivity=eps, implementation="xla")
    got = float(T.mean())

    def hrad(t):
        return float(radiative_h(jnp.asarray(t, jnp.float64), eps, T_inf))

    # lumped ODE with the SAME per-step Picard freeze + implicit update:
    # (T1 - T0)/dt = -w (h + hrad(T0)) aov (T1 - Tinf)
    Tl = T0
    for _ in range(nsteps):
        s = dt * (h + hrad(Tl)) * aov / (mat.rho * mat.cp)
        Tl = (Tl + s * T_inf) / (1.0 + s)
    np.testing.assert_allclose(got, Tl, rtol=4e-3)

    # fully nonlinear fine-step RK4 of the exact ODE
    Tr, nfine = T0, 3000
    dtf = dt * nsteps / nfine
    f = lambda t: -(h + hrad(t)) * aov * (t - T_inf) / (mat.rho * mat.cp)
    for _ in range(nfine):
        k1 = f(Tr); k2 = f(Tr + 0.5 * dtf * k1)
        k3 = f(Tr + 0.5 * dtf * k2); k4 = f(Tr + dtf * k3)
        Tr += dtf / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    np.testing.assert_allclose(got, Tr, rtol=1e-2)


def test_pallas_tier_gradients_match_xla():
    """jax.grad through the Triton-kernel tier (its custom VJP,
    solvers/thomas_triton.py) matches the scan tier's gradients on the full masked+sinks+Dirichlet
    configuration — both wrt the initial field and a conductivity
    parameter (which flows into every stream: faces, dw, sinks)."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                  h_top=400.0, T_inf_top=25.0)
    grid = CylindricalGrid(5, 12, 10, 6e-4, 8e-4, r_inner=0.015)
    rng = np.random.default_rng(12)
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = _smooth_field(grid, seed=10, lo=100.0, hi=900.0)

    def loss(k0, T0, impl):
        kt = lambda T: k0 + 0.01 * T
        ct = lambda T: 430.0 + 0.1 * T
        T = adi_step_cyl_varprop(T0, grid, mat, dt=0.05, robin_outer=rob,
                                 zbc=zbc, k_table=kt, cp_table=ct,
                                 active=act, h_void=50.0, T_inf_void=20.0,
                                 h_front=120.0, implementation=impl,
                                 interpret=True)
        return jnp.mean(T * T)

    gk_x, gT_x = jax.grad(lambda k, T: loss(k, T, "xla"),
                          argnums=(0, 1))(30.0, T0)
    gk_p, gT_p = jax.grad(lambda k, T: loss(k, T, "pallas"),
                          argnums=(0, 1))(30.0, T0)
    np.testing.assert_allclose(float(gk_p), float(gk_x), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(gT_p), np.asarray(gT_x),
                               rtol=1e-9, atol=1e-12)


def test_bf16_state_upcast_solve():
    """bfloat16 states solve at f32 and downcast once: the result tracks the f64 scan run within
    the bf16 quantum over a short cooldown, on both tiers."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    grid = CylindricalGrid(6, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    kt = lambda T: 30.0 + 0.02 * T
    ref = jnp.full(grid.shape, 900.0, jnp.float64)
    for impl in ("xla", "pallas"):
        got = jnp.full(grid.shape, 900.0, jnp.bfloat16)
        r = ref
        for _ in range(5):
            r = adi_step_cyl_varprop(r, grid, mat, dt=0.05, robin_outer=rob,
                                     zbc=zbc, k_table=kt,
                                     implementation="xla")
            got = adi_step_cyl_varprop(got, grid, mat, dt=0.05,
                                       robin_outer=rob, zbc=zbc, k_table=kt,
                                       implementation=impl, interpret=True)
        assert got.dtype == jnp.bfloat16
        d = np.abs(np.asarray(got, np.float64) - np.asarray(r))
        assert d.max() < 8.0, d.max()   # ~bf16 quantum at 900 C is 4


def test_bimetal_substrate_deposit():
    """MULTI-MATERIAL support falls out of the callable-table design: a
    table may close over a static material-id field, so substrate and
    deposit can be different alloys (the reference is single-material).
    Gates: (a) a bimetal with IDENTICAL alloys reduces exactly to the
    uniform run; (b) heat soaks into a high-diffusivity substrate
    (k x10, same rho cp) strictly faster than into the matched one —
    interface flux continuity via the harmonic face mean."""
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(0.0, 20.0)
    zbc = ZFaceBC()
    grid = CylindricalGrid(5, 12, 16, 6e-4, 8e-4, r_inner=0.015)
    substrate = jnp.arange(grid.nz)[None, None, :] < 8   # lower half
    hot_top = jnp.where(jnp.arange(grid.nz)[None, None, :] >= 8,
                        900.0, 20.0) * jnp.ones(grid.shape)

    def kt_bimetal(k_sub):
        return lambda T: jnp.where(substrate, k_sub, 54.0 + 0.0 * T)

    kw = dict(dt=0.1, robin_outer=rob, zbc=zbc, implementation="xla")
    uni = adi_step_cyl_varprop(hot_top, grid, mat, k_table=54.0, **kw)
    same = adi_step_cyl_varprop(hot_top, grid, mat,
                                k_table=kt_bimetal(54.0), **kw)
    np.testing.assert_array_equal(np.asarray(same), np.asarray(uni))

    fast = adi_step_cyl_varprop(hot_top, grid, mat,
                                k_table=kt_bimetal(540.0), **kw)
    # more energy crossed into the high-k substrate (the interface flux
    # is harmonic-mean limited: harm(54, 540) ~ 98, so expect ~1.5x)
    e_sub = lambda X: float(jnp.sum(jnp.where(substrate, X - 20.0, 0.0)))
    assert e_sub(fast) > 1.3 * e_sub(same)
    # and the kernel tier agrees on the bimetal configuration
    fast_p = adi_step_cyl_varprop(hot_top, grid, mat,
                                  k_table=kt_bimetal(540.0),
                                  implementation="pallas", interpret=True,
                                  dt=0.1, robin_outer=rob, zbc=zbc)
    np.testing.assert_allclose(np.asarray(fast_p), np.asarray(fast),
                               rtol=1e-12, atol=1e-9)
