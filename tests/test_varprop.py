"""Temperature-dependent material properties (beyond-reference capability):
constant-table degeneracy, Kirchhoff steady state for k(T), and latent-heat
energy accounting via apparent heat capacity."""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import (CartesianGrid, Material,
                                    adi_step_cartesian, build_coeff_packs)
from adi_thermal_fields_tpu.step.cartesian_varprop import (PropertyTable,
                                                           adi_step_varprop,
                                                           apparent_cp)


def test_constant_tables_match_constant_core():
    grid = CartesianGrid(10, 9, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(0)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat, robin_h=250.0,
                              neumann={"z+": 1e5})
    kt = PropertyTable((0.0, 2000.0), (54.0, 54.0))
    ct = PropertyTable((0.0, 2000.0), (490.0, 490.0))

    ref = T0
    got = T0
    for _ in range(3):
        ref = adi_step_cartesian(ref, mask, packs, grid, mat, dt=0.05,
                                 theta=0.5, t_inf=20.0)
        got = adi_step_varprop(got, mask, packs, grid, mat, k_table=kt,
                               cp_table=ct, dt=0.05, theta=0.5, t_inf=20.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10,
                               atol=1e-9)


def test_kirchhoff_steady_state_linear_k():
    """1-D rod, Dirichlet ends, k(T) = k0 + k1*T: the steady profile obeys
    the Kirchhoff transform  K(T(x)) = K(T0) + (K(T1) - K(T0)) x / L  with
    K(T) = k0*T + k1*T^2/2 (exact; the harmonic-mean face conductivity is
    2nd-order accurate for smooth k)."""
    n = 48
    grid = CartesianGrid(n, 1, 1, 1e-3)
    mat = Material(7800.0, 490.0, 10.0)
    mask = jnp.ones(grid.shape, bool)
    T0v, T1v = 100.0, 900.0
    dirm = np.zeros(grid.shape, bool)
    dirm[0] = dirm[-1] = True
    dval = np.zeros(grid.shape)
    dval[0], dval[-1] = T0v, T1v
    packs = build_coeff_packs(mask, grid, mat,
                              dirichlet_mask=jnp.asarray(dirm),
                              dirichlet_value=jnp.asarray(dval))
    k0, k1 = 10.0, 0.04  # k: 14 -> 46 W/m/K over the range
    Tpts = np.linspace(0.0, 1200.0, 25)
    kt = PropertyTable(tuple(Tpts), tuple(k0 + k1 * Tpts))

    step = jax.jit(lambda T: adi_step_varprop(T, mask, packs, grid, mat,
                                              k_table=kt, dt=2.0, theta=1.0))
    T = jnp.full(grid.shape, 500.0)
    for _ in range(600):
        T = step(T)
    prof = np.asarray(T)[:, 0, 0]

    # Dirichlet is imposed on the first/last CELL CENTERS -> rod length is
    # (n-1) cells between the pinned centers
    x = np.arange(n) / (n - 1)
    K = lambda T: k0 * T + 0.5 * k1 * T * T
    K_exact = K(T0v) + (K(T1v) - K(T0v)) * x
    # invert K (monotone quadratic)
    T_exact = (-k0 + np.sqrt(k0 * k0 + 2.0 * k1 * K_exact)) / k1
    err = np.abs(prof - T_exact).max()
    assert err < 1.5, err   # 2nd-order face conductivity on a 48-cell rod

    # sanity: profile must be visibly non-linear (low-k cold side steeper)
    lin = T0v + (T1v - T0v) * x
    assert np.abs(prof - lin).max() > 20.0


def test_latent_heat_energy_accounting():
    """Adiabatic block heated by a volumetric source across the mushy zone:
    the temperature rise must follow the enthalpy curve including L."""
    grid = CartesianGrid(6, 6, 6, 1e-3)
    rho, cp_s, cp_l, L = 7800.0, 500.0, 600.0, 2.5e5
    T_sol, T_liq = 1400.0, 1500.0
    mat = Material(rho, cp_s, 30.0)
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat)  # adiabatic: no BCs
    ct = apparent_cp(cp_s, cp_l, L, T_sol, T_liq)

    S = 5e8  # W/m^3
    dt = 0.05
    T = jnp.full(grid.shape, 1300.0)
    Sfield = jnp.full(grid.shape, S)
    nsteps = 160
    step = jax.jit(lambda T: adi_step_varprop(T, mask, packs, grid, mat,
                                              cp_table=ct, dt=dt, theta=1.0,
                                              source=Sfield))
    for _ in range(nsteps):
        T = step(T)
    T_end = float(jnp.mean(T))
    assert T_end > T_liq, "must have crossed the mushy zone"

    # enthalpy per kg from 1300 C to T_end
    dH = (cp_s * (T_sol - 1300.0) + (0.5 * (cp_s + cp_l)) * (T_liq - T_sol)
          + L + cp_l * (T_end - T_liq))
    dH_in = S * dt * nsteps / rho
    np.testing.assert_allclose(dH, dH_in, rtol=0.03)

    # without latent heat the same energy overshoots far beyond T_end
    T2 = jnp.full(grid.shape, 1300.0)
    ct2 = PropertyTable((0.0, 2000.0), (cp_s, cp_s))
    step2 = jax.jit(lambda T: adi_step_varprop(T, mask, packs, grid, mat,
                                               cp_table=ct2, dt=dt, theta=1.0,
                                               source=Sfield))
    for _ in range(nsteps):
        T2 = step2(T2)
    assert float(jnp.mean(T2)) > T_end + 0.5 * L / cp_s


def test_anisotropic_conductivity_separates_axes():
    """Per-axis k (anisotropic deposits): a perturbation varying only along
    axis A must evolve exactly as the ISOTROPIC solver with k = k_A — the
    other axes' conductivities cannot leak into it."""
    grid = CartesianGrid(24, 24, 4, 1e-3)
    mat = Material(7800.0, 490.0, 40.0)
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat)   # adiabatic
    kx, ky, kz = 40.0, 10.0, 4.0

    x = (np.arange(grid.nx) + 0.5) / grid.nx
    Tx = jnp.asarray(np.broadcast_to(
        100.0 + 50.0 * np.cos(np.pi * x)[:, None, None], grid.shape))
    y = (np.arange(grid.ny) + 0.5) / grid.ny
    Ty = jnp.asarray(np.broadcast_to(
        100.0 + 50.0 * np.cos(np.pi * y)[None, :, None], grid.shape))

    def run(T0, k):
        step = jax.jit(lambda T: adi_step_varprop(
            T, mask, packs, grid, mat, k_table=k, dt=0.2, theta=1.0))
        T = T0
        for _ in range(5):
            T = step(T)
        return np.asarray(T)

    aniso = (kx, ky, kz)
    np.testing.assert_allclose(run(Tx, aniso), run(Tx, kx), rtol=1e-12)
    np.testing.assert_allclose(run(Ty, aniso), run(Ty, ky), rtol=1e-12)
    # and the two axes genuinely decay at different rates
    ax_amp = run(Tx, aniso).max() - run(Tx, aniso).min()
    ay_amp = run(Ty, aniso).max() - run(Ty, aniso).min()
    assert ax_amp < ay_amp  # kx > ky -> faster decay along x


def test_melt_pool_enhanced_k_convection_proxy():
    """Melt-pool convection proxy (melt_pool_enhanced_k): (1) above the
    liquidus the table must act exactly like a constant k*enhancement
    material; (2) in a pool-in-solid configuration the boosted pool must
    export heat measurably faster while the far solid is untouched;
    (3) enhancement=1 degrades to plain constant k below the solidus."""
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        melt_pool_enhanced_k)

    grid = CartesianGrid(32, 16, 8, 1e-3)
    mat = Material(7800.0, 600.0, 30.0)
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat)   # adiabatic
    T_sol, T_liq = 1400.0, 1500.0
    boosted = melt_pool_enhanced_k(30.0, T_sol, T_liq, enhancement=8.0)
    plain = melt_pool_enhanced_k(30.0, T_sol, T_liq, enhancement=1.0)

    # (1) fully molten domain: boosted table == constant k*8 exactly
    rng = np.random.default_rng(3)
    T_hot = jnp.asarray(1600.0 + 80.0 * rng.random(grid.shape))
    kt8 = PropertyTable((0.0, 2000.0), (240.0, 240.0))
    a = adi_step_varprop(T_hot, mask, packs, grid, mat, k_table=boosted,
                         dt=0.01, theta=1.0)
    b = adi_step_varprop(T_hot, mask, packs, grid, mat, k_table=kt8,
                         dt=0.01, theta=1.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)

    # (2) hot pool inside cold solid: the boosted pool exports heat faster
    T0_np = np.full(grid.shape, 300.0)
    xg = np.arange(8)[:, None, None]
    T0_np[12:20, 4:12, 2:6] = 1700.0 + 40.0 * np.broadcast_to(
        np.cos(np.pi * xg / 7.0), (8, 8, 4))
    T0 = jnp.asarray(T0_np)
    core = np.zeros(grid.shape, bool)
    core[14:18, 6:10, 3:5] = True      # pool interior, away from its edge

    def run(k_table, steps=3):
        step = jax.jit(lambda T: adi_step_varprop(
            T, mask, packs, grid, mat, k_table=k_table, dt=0.01, theta=1.0))
        T = T0
        for _ in range(steps):
            T = step(T)
        return np.asarray(T)

    T_plain = run(plain)
    T_boost = run(boosted)
    assert T_boost[core].min() > T_liq          # core still molten
    assert T_boost[core].mean() < T_plain[core].mean() - 100.0
    far = np.zeros(grid.shape, bool)
    far[:4] = True                              # untouched far solid
    np.testing.assert_allclose(T_boost[far], T_plain[far], atol=1e-5)

    # (3) enhancement=1 == plain constant k below the solidus
    cold = jnp.asarray(300.0 + 50.0 * rng.random(grid.shape))
    a = adi_step_varprop(cold, mask, packs, grid, mat, k_table=plain,
                         dt=0.05, theta=1.0)
    b = adi_step_varprop(cold, mask, packs, grid, mat,
                         k_table=PropertyTable((0.0, 2000.0), (30.0, 30.0)),
                         dt=0.05, theta=1.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def test_engine_varprop_constant_tables_match_plain_engine():
    """make_cartesian_engine(k_table=, cp_table=) with constant tables must
    reproduce the plain constant-coefficient engine (varprop
    wired into the flagship engine)."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(10, 9, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(1)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    kt = PropertyTable((0.0, 2000.0), (54.0, 54.0))
    ct = PropertyTable((0.0, 2000.0), (490.0, 490.0))

    p0, a0 = make_cartesian_engine(grid, mat, robin_h=250.0,
                                   implementation="xla")
    pv, av = make_cartesian_engine(grid, mat, robin_h=250.0,
                                   implementation="xla",
                                   k_table=kt, cp_table=ct)
    ref = a0(T0, p0(mask), 0.05, jnp.int32(4), 0.0)
    got = av(T0, pv(mask), 0.05, jnp.int32(4), 0.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10,
                               atol=1e-9)


def test_engine_radiation_matches_advance_robin_h_fn():
    """Engine emissivity= (per-sub-step Picard) vs the round-2 library path
    make_cartesian_advance(robin_h_fn=radiative_h): identical for n_sub=1
    segments (same refresh point)."""
    from adi_thermal_fields_tpu.apps.engine import (make_cartesian_advance,
                                                    make_cartesian_engine)
    from adi_thermal_fields_tpu.bc.radiation import radiative_h

    grid = CartesianGrid(10, 9, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    T0 = jnp.full(grid.shape, 1200.0, jnp.float64)

    pe, ae = make_cartesian_engine(grid, mat, t_inf=20.0, robin_h=15.0,
                                   implementation="xla", emissivity=0.6)
    adv = make_cartesian_advance(
        grid, mat, t_inf=20.0, implementation="xla",
        robin_h_fn=lambda T: radiative_h(T, 0.6, 20.0, h_conv=15.0))
    Ta = T0
    Tb = T0
    prep = pe(mask)
    for i in range(3):
        Ta = ae(Ta, prep, 0.05, jnp.int32(1), 0.0)
        Tb = adv(Tb, mask, 0.05, jnp.int32(1), 0.0)
    np.testing.assert_allclose(np.asarray(Ta), np.asarray(Tb), rtol=1e-12)
    # physics: 1200 C body radiates strongly; must cool faster than
    # convection-only
    pc, ac = make_cartesian_engine(grid, mat, t_inf=20.0, robin_h=15.0,
                                   implementation="xla")
    Tc = ac(T0, pc(mask), 0.05, jnp.int32(3), 0.0)
    assert float(Ta.mean()) < float(Tc.mean()) - 1.0


def test_engine_varprop_sharded_matches_single_device():
    """Varprop (latent heat + melt-pool k + radiation) through the engine on
    an 8-device mesh vs single device (GSPMD-sharded Picard coefficients)."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.dist.cartesian import make_mesh, shard_field
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        melt_pool_enhanced_k)

    grid = CartesianGrid(12, 8, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(2)
    mask_np = rng.random(grid.shape) > 0.2
    mask = jnp.asarray(mask_np)
    T0 = jnp.asarray(np.where(mask_np, 20 + 1600 * rng.random(grid.shape),
                              20.0))
    kt = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)

    p1, a1 = make_cartesian_engine(grid, mat, robin_h=15.0, emissivity=0.5,
                                   k_table=kt, cp_table=ct,
                                   implementation="xla")
    ref = a1(T0, p1(mask), 0.02, jnp.int32(3), 0.0)

    mesh = make_mesh()
    pm, am = make_cartesian_engine(grid, mat, robin_h=15.0, emissivity=0.5,
                                   k_table=kt, cp_table=ct, mesh=mesh,
                                   implementation="xla")
    Ts = shard_field(T0, mesh, 0)
    ms = shard_field(mask, mesh, 0)
    got = am(Ts, pm(ms), 0.02, jnp.int32(3), 0.0)
    assert len(got.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_engine_varprop_with_history():
    """Varprop composes with fused thermal-history tracking."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(8, 8, 6, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    T0 = jnp.full(grid.shape, 900.0, jnp.float64)
    kt = PropertyTable((0.0, 2000.0), (40.0, 60.0))
    pv, av = make_cartesian_engine(grid, mat, robin_h=200.0, k_table=kt,
                                   implementation="xla",
                                   history_t_crit=(800.0, 500.0))
    hist0 = (T0, jnp.zeros((2,) + grid.shape, jnp.float64))
    T, (pk, ta) = av(T0, pv(mask), 0.05, jnp.int32(5), 0.0, hist0)
    assert ta.shape == (2,) + grid.shape
    assert float(pk.min()) >= float(T.min())
    assert float(ta[1].max()) >= float(ta[0].max())  # longer above 500 C


def _varprop_sweep_system(rng, shape, grid, mat, hmode):
    """An x-sweep system of the varprop step (materialized coefficients)."""
    from adi_thermal_fields_tpu.bc.packs import build_coeff_packs
    from adi_thermal_fields_tpu.step.cartesian_varprop import _face_g

    mask = jnp.asarray(rng.random(shape) < 0.8)
    T = jnp.asarray(rng.random(shape) * 900 + 20)
    kf = jnp.asarray(rng.random(shape) * 40 + 10)
    cpf = jnp.asarray(rng.random(shape) * 200 + 400)
    w = 1.0 / (mat.rho * cpf)
    dt, theta, t_inf = 0.02, 0.5, 20.0
    dx = grid.dx
    bc_scale = mat.cp / cpf
    g_lo = dt * _face_g(kf, 0, -1, mask) * w / dx**2
    g_hi = dt * _face_g(kf, 0, +1, mask) * w / dx**2
    h = 15.0 if hmode == "scalar" else jnp.asarray(rng.random(shape) * 40 + 5)
    packs = build_coeff_packs(mask, grid, mat, robin_h=h)
    a = -theta * g_lo
    c = -theta * g_hi
    b = jnp.where(mask, 1.0 + theta * (g_lo + g_hi)
                  + dt * packs.coeff[0] * bc_scale, 1.0)
    d = jnp.where(mask, T + dt * packs.coeff[0] * bc_scale * t_inf, T)
    return a, b, c, d


def test_varprop_sweep_kernel_matches_scan_oracle():
    """The varprop x-sweep system (harmonic faces, Robin sink rescaled to
    cp(T)) solved by the Triton kernel (interpret mode) vs the scan, in
    f64 — scalar-h AND per-cell h-field (radiation) modes."""
    from adi_thermal_fields_tpu.solvers.thomas import thomas

    rng = np.random.default_rng(0)
    shape = (40, 16, 24)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    for hmode in ("scalar", "field"):
        a, b, c, d = _varprop_sweep_system(rng, shape, grid, mat, hmode)
        want = thomas(a, b, c, d, implementation="xla")
        got = thomas(a, b, c, d, implementation="pallas", interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-11)


def test_fused_varprop_step_matches_xla_path():
    """adi_step_varprop on the Triton kernel (interpret mode) == on the
    scan for the flagship Robin-only BC set: scalar h, radiative h-field,
    and anisotropic per-axis k tables, on anisotropic voxels with a
    source."""
    from adi_thermal_fields_tpu.bc.packs import build_coeff_packs
    from adi_thermal_fields_tpu.bc.radiation import radiative_h
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        melt_pool_enhanced_k)

    rng = np.random.default_rng(1)
    shape = (24, 20, 16)
    grid = CartesianGrid(*shape, 1e-3, dy=1.3e-3, dz=0.8e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.asarray(rng.random(shape) < 0.85)
    T = jnp.where(mask, jnp.asarray(rng.random(shape) * 1400 + 100), 20.0)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    src = jnp.asarray(rng.random(shape) * 1e6)
    dt, h = 0.01, 35.0
    packs = build_coeff_packs(mask, grid, mat, robin_h=h)
    packs_h = build_coeff_packs(
        mask, grid, mat, robin_h=radiative_h(T, 0.5, 20.0, h_conv=15.0))
    kts = (kt, melt_pool_enhanced_k(mat.k * 0.7, 1420.0, 1470.0,
                                    enhancement=3.0), 40.0)
    for pk, ktab, source in ((packs, kt, src), (packs_h, kt, None),
                             (packs, kts, None)):
        kw = dict(k_table=ktab, cp_table=ct, dt=dt, theta=0.5, t_inf=20.0,
                  source=source)
        want = adi_step_varprop(T, mask, pk, grid, mat,
                                implementation="xla", **kw)
        got = adi_step_varprop(T, mask, pk, grid, mat,
                               implementation="pallas", interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-10)


def test_engine_fused_varprop_matches_xla_branch():
    """The engine's varprop branch on the Triton kernel (interpret mode)
    must match it on the scan, including radiation and a moving source."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        apparent_cp, melt_pool_enhanced_k)

    grid = CartesianGrid(12, 10, 8, 1e-3, dz=0.7e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(7)
    mask = jnp.asarray(rng.random(grid.shape) > 0.25)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              100 + 1300 * rng.random(grid.shape), 20.0))
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)

    def src_fn(t):
        return jnp.zeros(grid.shape).at[6, 5, 7].set(1e8 * (1.0 + 0 * t))

    kw = dict(robin_h=40.0, t_inf=20.0, emissivity=0.45, k_table=kt,
              cp_table=ct, source_fn=src_fn)
    p0, a0 = make_cartesian_engine(grid, mat, implementation="xla", **kw)
    pv, av = make_cartesian_engine(grid, mat, implementation="pallas",
                                   interpret=True, **kw)
    ref = a0(T0, p0(mask), 0.05, jnp.int32(4), 0.0)
    got = av(T0, pv(mask), 0.05, jnp.int32(4), 0.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10,
                               atol=1e-9)


def test_engine_fused_varprop_sharded_matches_single_device():
    """The engine's mesh varprop branch (scan solves) vs the single-device
    branch on the Triton kernel (interpret mode) — the multi-device
    configuration for latent-heat / melt-pool / radiation physics."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.dist.cartesian import make_mesh, shard_field
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        melt_pool_enhanced_k)

    grid = CartesianGrid(12, 8, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(2)
    mask_np = rng.random(grid.shape) > 0.2
    mask = jnp.asarray(mask_np)
    T0 = jnp.asarray(np.where(mask_np, 20 + 1600 * rng.random(grid.shape),
                              20.0))
    kt = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)

    p1, a1 = make_cartesian_engine(grid, mat, robin_h=15.0, emissivity=0.5,
                                   k_table=kt, cp_table=ct,
                                   implementation="pallas", interpret=True)
    ref = a1(T0, p1(mask), 0.02, jnp.int32(3), 0.0)

    mesh = make_mesh()
    pm, am = make_cartesian_engine(grid, mat, robin_h=15.0, emissivity=0.5,
                                   k_table=kt, cp_table=ct, mesh=mesh)
    Ts = shard_field(T0, mesh, 0)
    ms = shard_field(mask, mesh, 0)
    got = am(Ts, pm(ms), 0.02, jnp.int32(3), 0.0)
    assert len(got.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_varprop_sweep_axis1_kernel_bitwise_vs_axis0():
    """A y-sweep varprop system solved along axis 1 (moved to the front)
    equals the axis-0 solve of the transposed arrays bit for bit on the
    kernel, on a ragged batch."""
    from adi_thermal_fields_tpu.solvers.thomas import (thomas,
                                                       thomas_along_axis)

    rng = np.random.default_rng(4)
    shape = (40, 16, 24)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    t1 = lambda x: jnp.transpose(x, (1, 0, 2))
    for hmode in ("scalar", "field"):
        abcd = _varprop_sweep_system(rng, shape, grid, mat, hmode)
        want = t1(thomas(*abcd, implementation="pallas", interpret=True))
        got = thomas_along_axis(*(t1(v) for v in abcd), axis=1,
                                implementation="pallas", interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_engine_fused_varprop_with_history_matches_xla():
    """The varprop branch on the Triton kernel composes with thermal-
    history tracking and matches the scan branch's history outputs."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(8, 8, 6, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    T0 = jnp.full(grid.shape, 900.0, jnp.float64)
    kt = PropertyTable((0.0, 2000.0), (40.0, 60.0))
    hist0 = (T0, jnp.zeros((2,) + grid.shape, jnp.float64))

    px, ax_ = make_cartesian_engine(grid, mat, robin_h=200.0, k_table=kt,
                                    implementation="xla",
                                    history_t_crit=(800.0, 500.0))
    Tx, (pkx, tax) = ax_(T0, px(mask), 0.05, jnp.int32(5), 0.0, hist0)

    pf, af = make_cartesian_engine(grid, mat, robin_h=200.0, k_table=kt,
                                   implementation="pallas", interpret=True,
                                   history_t_crit=(800.0, 500.0))
    Tf, (pkf, taf) = af(T0, pf(mask), 0.05, jnp.int32(5), 0.0, hist0)
    np.testing.assert_allclose(np.asarray(Tf), np.asarray(Tx), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(pkf), np.asarray(pkx), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(taf), np.asarray(tax), rtol=1e-10,
                               atol=1e-8)


def test_varprop_kernel_bf16_mixed_mode():
    """bf16 systems on the kernel solve in f32 and store bf16: within the
    bf16 quantization of the f32 solve, along axis 0 and axis 1."""
    from adi_thermal_fields_tpu.solvers.thomas import thomas_along_axis

    rng = np.random.default_rng(5)
    shape = (32, 16, 128)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    abcd = [v.astype(jnp.float32)
            for v in _varprop_sweep_system(rng, shape, grid, mat, "scalar")]
    for axis in (0, 1):
        mv = lambda x: jnp.moveaxis(x, 0, axis)
        want = thomas_along_axis(*(mv(v) for v in abcd), axis=axis,
                                 implementation="pallas", interpret=True)
        got = thomas_along_axis(*(mv(v).astype(jnp.bfloat16) for v in abcd),
                                axis=axis, implementation="pallas",
                                interpret=True)
        assert got.dtype == jnp.bfloat16
        # bf16 inputs quantize at ~0.4% of the field scale
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want), rtol=0.02, atol=3.0)


def test_varprop_kernel_matches_scan_h_and_source():
    """Varprop steps with scalar h, an h field, a source, and both, on a
    grid whose every batch is ragged for the kernel block: the kernel
    (interpret mode) vs the scan in f64."""
    from adi_thermal_fields_tpu.bc.packs import build_coeff_packs

    rng = np.random.default_rng(11)
    shape = (24, 40, 28)
    grid = CartesianGrid(*shape, 1e-3, dy=2e-3, dz=3e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.asarray(rng.random(shape) < 0.8)
    T = jnp.asarray(rng.random(shape) * 900 + 20)
    hf = jnp.asarray(rng.random(shape) * 40 + 5)
    srcf = jnp.asarray(rng.random(shape) * 1e6)
    kt = lambda T: 40.0 + 0.01 * T
    for h, src in ((15.0, None), (hf, None), (15.0, srcf), (hf, srcf)):
        packs = build_coeff_packs(mask, grid, mat, robin_h=h)
        kw = dict(k_table=kt, dt=0.02, theta=0.5, t_inf=20.0, source=src)
        want = adi_step_varprop(T, mask, packs, grid, mat,
                                implementation="xla", **kw)
        got = adi_step_varprop(T, mask, packs, grid, mat,
                               implementation="pallas", interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-13, atol=0.0)


def test_varprop_step_kernel_matches_scan_callable_tables():
    """Callable k(T)/cp(T) tables through the full step (all three sweeps)
    on an anisotropic grid with a long z axis: kernel (interpret mode) vs
    scan in f64, with and without an h field and a source."""
    from adi_thermal_fields_tpu.bc.packs import build_coeff_packs

    rng = np.random.default_rng(12)
    grid = CartesianGrid(20, 24, 136, 1e-3, 2e-3, 1.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.asarray(rng.random(grid.shape) < 0.85)
    T = jnp.asarray(rng.random(grid.shape) * 900 + 20)
    hf = jnp.asarray(rng.random(grid.shape) * 40 + 5)
    srcf = jnp.asarray(rng.random(grid.shape) * 1e6)
    kt = lambda T: 40.0 + 0.01 * T
    ct = lambda T: 450.0 + 0.1 * T
    for h, src in ((15.0, None), (hf, None), (15.0, srcf)):
        packs = build_coeff_packs(mask, grid, mat, robin_h=h)
        kw = dict(k_table=kt, cp_table=ct, dt=0.02, theta=0.5, t_inf=20.0,
                  source=src)
        want = adi_step_varprop(T, mask, packs, grid, mat,
                                implementation="xla", **kw)
        got = adi_step_varprop(T, mask, packs, grid, mat,
                               implementation="pallas", interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-13, atol=0.0)


def test_bimetal_substrate_deposit_cartesian():
    """Multi-material via closure tables on the Cartesian family (mirrors
    tests/test_cyl_varprop.py::test_bimetal_substrate_deposit): identical
    alloys reduce exactly to the uniform run; a high-k substrate absorbs
    heat faster through the harmonic-mean interface."""
    grid = CartesianGrid(8, 8, 16, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat)     # adiabatic domain
    substrate = jnp.arange(grid.nz)[None, None, :] < 8
    T0 = jnp.where(jnp.arange(grid.nz)[None, None, :] >= 8, 900.0, 20.0) \
        * jnp.ones(grid.shape)

    def kt(k_sub):
        return lambda T: jnp.where(substrate, k_sub, 54.0 + 0.0 * T)

    step = lambda ktab: adi_step_varprop(T0, mask, packs, grid, mat,
                                         k_table=ktab, dt=0.2, theta=1.0,
                                         implementation="xla")
    uni = step(None)
    same = step(kt(54.0))
    np.testing.assert_allclose(np.asarray(same), np.asarray(uni),
                               rtol=1e-13, atol=1e-13)
    fast = step(kt(540.0))
    e_sub = lambda X: float(jnp.sum(jnp.where(substrate, X - 20.0, 0.0)))
    assert e_sub(fast) > 1.3 * e_sub(same)


def test_property_table_clamp_sum_matches_interp():
    """PropertyTable's clamp-sum evaluation is the same piecewise-linear
    function as jnp.interp with end clamping: exact at f64, few-ulp at
    f32, including the apparent-cp table's eps-width jump segments."""
    rng = np.random.default_rng(7)
    tabs = [apparent_cp(490.0, 620.0, 2.5e5, 1420.0, 1510.0),
            PropertyTable((0.0, 2000.0), (54.0, 54.0)),
            PropertyTable(tuple(np.linspace(0, 2000, 17)),
                          tuple(rng.random(17) * 100 + 10))]
    for tab in tabs:
        T64 = jnp.asarray(rng.random(20000) * 2200 - 100, jnp.float64)
        ref = jnp.interp(T64, jnp.asarray(tab.points, jnp.float64),
                         jnp.asarray(tab.values, jnp.float64))
        assert float(jnp.max(jnp.abs(tab(T64) - ref))) < 1e-10
        mine32 = tab(T64.astype(jnp.float32)).astype(jnp.float64)
        rel = float(jnp.max(jnp.abs(mine32 - ref))) / float(jnp.max(ref))
        assert rel < 1e-5, rel


def test_thomas_along_z_kernel_bf16_matches_transposed():
    """bf16 systems solved along the contiguous z axis (thomas_along_axis
    moves it to the front) equal the axis-0 solve of the transposed
    arrays exactly: the same f32 solve, the same round-to-nearest store."""
    from adi_thermal_fields_tpu.solvers.thomas import (thomas,
                                                       thomas_along_axis)

    rng = np.random.default_rng(9)
    shape = (136, 16, 24)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    for hmode in ("scalar", "field"):
        abcd = [v.astype(jnp.bfloat16) for v in
                _varprop_sweep_system(rng, shape, grid, mat, hmode)]
        want = thomas(*abcd, implementation="pallas", interpret=True)
        t2 = lambda x: jnp.transpose(x, (1, 2, 0))
        got = thomas_along_axis(*(t2(v) for v in abcd), axis=2,
                                implementation="pallas", interpret=True)
        assert got.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(jnp.transpose(got, (2, 0, 1)), np.float32),
            np.asarray(want, np.float32))


def test_varprop_step_bf16_kernel_matches_scan():
    """Step level: a bf16 state through the engine's varprop branch (f32
    solve, one round-to-nearest store per sub-step) on the kernel and on
    the scan gives the same result."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        melt_pool_enhanced_k)

    shape = (24, 16, 40)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    m = np.zeros(shape, bool)
    m[:, :, :24] = True
    mask = jnp.asarray(m)
    T = jnp.where(mask, 1400.0, 20.0).astype(jnp.bfloat16)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    out = {}
    for impl in ("pallas", "xla"):
        prep, adv = make_cartesian_engine(
            grid, mat, k_table=kt, cp_table=ct, t_inf=20.0, robin_h=15.0,
            emissivity=0.5, dtype=jnp.bfloat16, implementation=impl,
            interpret=impl == "pallas")
        out[impl] = adv(T, prep(mask), jnp.bfloat16(0.02), jnp.int32(2),
                        0.0)
    assert out["pallas"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["pallas"], np.float32),
                                  np.asarray(out["xla"], np.float32))
