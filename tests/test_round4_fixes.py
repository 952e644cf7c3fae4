"""Round-4 fixes: radiation composing with corrected-BC / field-h films
(the reference's contract is that corrected Robin
output is simply another h field flowing through the unified machinery,
voxel_bc_correction.py:207-225; the radiative film must see the same
per-face area correction)."""
import numpy as np
import pytest

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid, Material
from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

FACES = ("x-", "x+", "y-", "y+", "z-", "z+")


def _grid_mat():
    return CartesianGrid(6, 6, 6, 1e-3), Material(7800.0, 490.0, 54.0)


def test_radiation_scale_requires_emissivity():
    grid, mat = _grid_mat()
    with pytest.raises(ValueError, match="radiation_scale"):
        make_cartesian_engine(grid, mat, robin_h=30.0,
                              radiation_scale={f: 1.0 for f in FACES})


def test_radiation_with_field_h_matches_scalar_path():
    """emissivity + per-face FIELD h (unit area scale) must agree with the
    scalar-h radiative path — same physics through the previously-refused
    field-coefficient composition."""
    grid, mat = _grid_mat()
    mask = jnp.ones(grid.shape, bool)
    h0, eps, t_inf = 25.0, 0.7, 20.0

    prep_s, adv_s = make_cartesian_engine(
        grid, mat, robin_h=h0, emissivity=eps, t_inf=t_inf,
        implementation="xla")
    hf = {f: jnp.full(grid.shape, h0) for f in FACES}
    prep_f, adv_f = make_cartesian_engine(
        grid, mat, robin_h=hf, emissivity=eps, t_inf=t_inf,
        radiation_scale={f: jnp.ones(grid.shape) for f in FACES},
        implementation="xla")

    T0 = jnp.full(grid.shape, 1200.0)
    dt, n = jnp.asarray(0.05), jnp.int32(8)
    Ts = adv_s(T0, prep_s(mask), dt, n, 0.0)
    Tf = adv_f(T0, prep_f(mask), dt, n, 0.0)
    np.testing.assert_allclose(np.asarray(Tf), np.asarray(Ts),
                               rtol=1e-12, atol=1e-12)


def test_radiation_area_scale_matches_lumped_ode():
    """A hot block radiating through HALF-area faces (radiation_scale=0.5,
    zero convective film) must follow the lumped Stefan-Boltzmann ODE with
    the halved surface area — verifies the scale actually multiplies the
    radiative film rather than being dropped."""
    from adi_thermal_fields_tpu.bc.radiation import STEFAN_BOLTZMANN

    grid = CartesianGrid(4, 4, 4, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)   # Bi ~ 0.004: lumped regime
    mask = jnp.ones(grid.shape, bool)
    eps, t_inf, scl = 0.8, 20.0, 0.5

    prepare, advance = make_cartesian_engine(
        grid, mat, t_inf=t_inf, emissivity=eps,
        robin_h={f: jnp.zeros(grid.shape) for f in FACES},
        radiation_scale={f: jnp.full(grid.shape, scl) for f in FACES},
        implementation="xla")
    prep = prepare(mask)
    T = jnp.full(grid.shape, 1200.0)
    dt, n_sub, n_seg = 0.05, 5, 24
    for _ in range(n_seg):
        T = advance(T, prep, jnp.asarray(dt), jnp.int32(n_sub), 0.0)
    T_num = float(jnp.mean(T))

    A = scl * 6 * 16 * grid.dx ** 2
    V = grid.ncells * grid.cell_volume
    coef = eps * STEFAN_BOLTZMANN * A / (mat.rho * mat.cp * V)

    def f(T):
        return -coef * ((T + 273.15) ** 4 - (t_inf + 273.15) ** 4)

    Tl, h = 1200.0, 1e-3
    for _ in range(int(round(dt * n_sub * n_seg / h))):
        k1 = f(Tl); k2 = f(Tl + 0.5 * h * k1)
        k3 = f(Tl + 0.5 * h * k2); k4 = f(Tl + h * k3)
        Tl += h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    assert Tl < 1150.0                      # cooled substantially
    np.testing.assert_allclose(T_num, Tl, rtol=0.01)


def _write_box_stl(tmp_path):
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


def test_waam_corrected_bc_with_emissivity(tmp_path):
    """The flagship accepts --corrected_bc --emissivity (a
    production WAAM part at 1500 C with a corrected STL surface previously
    had to choose between geometric fidelity and the dominant heat-loss
    physics)."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run

    stl = _write_box_stl(tmp_path)
    out = run(build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2",
        "--outdir", str(tmp_path / "out"), "--precision", "float64",
        "--bead_height_mm", "2", "--corrected_bc", "1",
        "--emissivity", "0.5"]))
    Tmax = float(np.asarray(out["T"])[np.asarray(out["active"])].max())
    assert np.isfinite(Tmax) and 20.0 <= Tmax <= 1500.0


def test_waam_corrected_emissivity_cools_faster_than_uncorrected_zero():
    """Sanity on the composition order: with corrected_bc fields present,
    adding emissivity must strictly increase heat loss (colder field) vs
    the same corrected run without radiation."""
    import jax

    grid, mat = _grid_mat()
    mask = jnp.ones(grid.shape, bool)
    hf = {f: jnp.full(grid.shape, 10.0) for f in FACES}
    sc = {f: jnp.full(grid.shape, 0.9) for f in FACES}

    prep_c, adv_c = make_cartesian_engine(
        grid, mat, robin_h=hf, t_inf=20.0, implementation="xla")
    prep_r, adv_r = make_cartesian_engine(
        grid, mat, robin_h=hf, t_inf=20.0, emissivity=0.6,
        radiation_scale=sc, implementation="xla")
    T0 = jnp.full(grid.shape, 1000.0)
    dt, n = jnp.asarray(0.1), jnp.int32(10)
    Tc = adv_c(T0, prep_c(mask), dt, n, 0.0)
    Tr = adv_r(T0, prep_r(mask), dt, n, 0.0)
    assert float(jnp.max(Tr)) < float(jnp.min(Tc))


def test_varprop_kernel_matches_scan_radiative_anisotropic():
    """Cartesian varprop step with latent heat, melt-pool k and a radiative
    film on an anisotropic masked grid: the Triton-kernel tier (interpret
    mode) against the scan tier."""
    from adi_thermal_fields_tpu.bc.packs import build_coeff_packs
    from adi_thermal_fields_tpu.bc.radiation import radiative_h
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        adi_step_varprop, apparent_cp, melt_pool_enhanced_k)

    rng = np.random.default_rng(7)
    shape = (20, 16, 24)
    grid = CartesianGrid(*shape, 1e-3, dy=1.2e-3, dz=0.7e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.asarray(rng.random(shape) < 0.85)
    T = jnp.where(mask, jnp.asarray(rng.random(shape) * 1400 + 100), 20.0)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    eps, t_inf, hc, dt = 0.6, 20.0, 12.0, 0.01
    packs = build_coeff_packs(mask, grid, mat,
                              robin_h=radiative_h(T, eps, t_inf, h_conv=hc))
    out = {impl: adi_step_varprop(
        T, mask, packs, grid, mat, k_table=kt, cp_table=ct, dt=dt,
        theta=0.5, t_inf=t_inf, implementation=impl,
        interpret=impl == "pallas") for impl in ("pallas", "xla")}
    np.testing.assert_allclose(np.asarray(out["pallas"]),
                               np.asarray(out["xla"]), rtol=0, atol=1e-10)


def test_bf16_engine_kernel_matches_scan():
    """A bf16 state (f32 solve, one bf16 rounding per sub-step) through the
    engine on the Triton kernel (interpret mode) vs on the scan: identical
    f32 solve, same rounding."""
    rng = np.random.default_rng(41)
    shape = (24, 16, 40)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    m = np.zeros(shape, bool)
    m[:, :, :30] = True
    m[:10, :8, 30:36] = True
    mask = jnp.asarray(m)
    T = jnp.asarray(np.where(m, 900.0, 20.0)
                    + 25.0 * rng.random(shape)).astype(jnp.bfloat16)
    out = {}
    for impl in ("pallas", "xla"):
        prepare, advance = make_cartesian_engine(
            grid, mat, robin_h=200.0, t_inf=20.0, dtype=jnp.bfloat16,
            implementation=impl, interpret=impl == "pallas")
        out[impl] = np.asarray(advance(T, prepare(mask), jnp.bfloat16(0.05),
                                       jnp.int32(2), 0.0), np.float32)
    np.testing.assert_array_equal(out["pallas"], out["xla"])
