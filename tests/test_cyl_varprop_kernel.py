"""The variable-property cylindrical step (and the Cartesian varprop step)
on the Triton Thomas-kernel tier against the scan tier, one configuration
per case.

The kernel runs in Pallas interpret mode on CPU; every case solves the same
per-cell tridiagonal systems on both tiers (open r/z sweeps, cyclic phi by
Sherman-Morrison), so the two agree to solver round-off."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CylindricalGrid, Material, RobinBC, ZFaceBC
from adi_thermal_fields_tpu.step.cartesian_varprop import (
    apparent_cp, melt_pool_enhanced_k)
from adi_thermal_fields_tpu.step.cylindrical_varprop import (
    adi_step_cyl_varprop)

KERNEL = dict(implementation="pallas", interpret=True)
SCAN = dict(implementation="xla")
MAT = Material(7800.0, 490.0, 54.0)
K_TAB = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, enhancement=4.0)
CP_TAB = apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)
ROB = RobinBC(300.0, 20.0)
ZBC = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=25.0)


def _field(shape, seed=3, lo=20.0, hi=1620.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(lo + (hi - lo) * rng.random(shape))


def _both(T, grid, rtol=1e-12, atol=1e-9, **kw):
    """Run the step on both tiers and assert agreement; returns the scan's."""
    kw.setdefault("robin_outer", ROB)
    kw.setdefault("zbc", ZBC)
    kw.setdefault("dt", 0.02)
    a = adi_step_cyl_varprop(T, grid, MAT, **SCAN, **kw)
    b = adi_step_cyl_varprop(T, grid, MAT, **KERNEL, **kw)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)
    return a


@pytest.mark.parametrize("shape", [(32, 16, 128), (136, 24, 20)])
@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_step_kernel_matches_scan_shapes(shape, eps):
    """Latent heat + melt-pool k (+ radiation) on long-r and long-z grids,
    element birth with interface films."""
    grid = CylindricalGrid(*shape, 5e-4, 8e-4, r_inner=0.02)
    rng = np.random.default_rng(4)
    act = jnp.asarray(rng.random(shape) < 0.8)
    _both(_field(shape), grid, k_table=K_TAB, cp_table=CP_TAB, active=act,
          h_void=80.0, h_front=200.0, robin_inner=RobinBC(50.0, 20.0),
          emissivity=eps)


def test_step_constant_props_reduce_to_constant_step():
    """Constant properties on the kernel tier reproduce the constant-
    coefficient BE step on the kernel tier."""
    from adi_thermal_fields_tpu.step.cylindrical import adi_step

    grid = CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    T = _field(grid.shape)
    got = adi_step_cyl_varprop(T, grid, MAT, dt=0.05, robin_outer=ROB,
                               zbc=ZBC, robin_inner=ROB, **KERNEL)
    want = adi_step(T, grid, MAT, dt=0.05, robin_outer=ROB, zbc=ZBC,
                    robin_inner=ROB, **KERNEL)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-9)


def test_step_dirichlet_bottom_pins():
    """A Dirichlet z end (zeroed geometry, pinned rhs) on both tiers."""
    grid = CylindricalGrid(8, 12, 20, 5e-4, 1e-3, r_inner=0.02)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                  h_top=400.0, T_inf_top=25.0)
    out = _both(_field(grid.shape), grid, zbc=zbc, k_table=K_TAB,
                cp_table=CP_TAB)
    np.testing.assert_allclose(np.asarray(out)[:, :, 0], 140.0)


@pytest.mark.parametrize("nphi", [128, 20, 136])
@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_cyclic_phi_kernel_matches_scan(nphi, eps):
    """The periodic phi solve (Sherman-Morrison over the kernel) at ring
    lengths with and without a power of two, with radiation on/off."""
    grid = CylindricalGrid(6, nphi, 8, 5e-4, 1e-3, r_inner=0.02)
    _both(_field(grid.shape, seed=nphi), grid, k_table=K_TAB,
          cp_table=CP_TAB, emissivity=eps)


def test_full_disk_regularity_rows():
    """Full-disk grid: the r = 0 phi lines are identity rows on both
    tiers."""
    grid = CylindricalGrid(9, 12, 10, 6e-4, 1.2e-3)
    _both(_field(grid.shape), grid, k_table=K_TAB, cp_table=CP_TAB,
          emissivity=0.3)


def test_masked_void_cells_hold_their_value():
    """Void cells are identity rows (adiabatic interfaces, no films): they
    keep their temperature on both tiers."""
    grid = CylindricalGrid(6, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    rng = np.random.default_rng(8)
    act = rng.random(grid.shape) < 0.6
    T = _field(grid.shape)
    out = _both(T, grid, k_table=K_TAB, active=jnp.asarray(act))
    np.testing.assert_array_equal(np.asarray(out)[~act], np.asarray(T)[~act])


@pytest.mark.parametrize("annular", [True, False])
def test_step_masked_sinks_match_scan(annular):
    """Element birth with interface Robin films, a growth-front film and
    radiation, annular and full-disk."""
    grid = (CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02) if annular
            else CylindricalGrid(9, 12, 10, 6e-4, 1.2e-3))
    rng = np.random.default_rng(11)
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    _both(_field(grid.shape, lo=100.0, hi=1500.0), grid, k_table=K_TAB,
          cp_table=CP_TAB, active=act, h_void=60.0, T_inf_void=20.0,
          h_front=150.0, emissivity=0.55,
          robin_inner=RobinBC(80.0, 30.0) if annular else None)


def test_step_source_and_dirichlet():
    """A volumetric source with a Dirichlet z end, unmasked."""
    grid = CylindricalGrid(6, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    rng = np.random.default_rng(5)
    src = jnp.asarray(rng.random(grid.shape) * 1e8)
    zbc = ZFaceBC(kind_bot="robin", h_bot=200.0, T_inf_bot=20.0,
                  kind_top="dirichlet", T_top=300.0)
    _both(_field(grid.shape), grid, zbc=zbc, source=src, k_table=K_TAB,
          cp_table=CP_TAB)


def _loss(k0, T0, grid, act, tier):
    kt = lambda T: k0 + 0.01 * T
    ct = lambda T: 430.0 + 0.1 * T
    T = adi_step_cyl_varprop(
        T0, grid, MAT, dt=0.05, robin_outer=ROB,
        zbc=ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                    h_top=400.0, T_inf_top=25.0),
        k_table=kt, cp_table=ct, active=act, h_void=50.0, T_inf_void=20.0,
        h_front=120.0, **tier)
    return jnp.mean(T * T)


def test_step_gradients_match_scan():
    """jax.grad through the kernel tier (its custom VJP) matches the scan
    tier's autodiff, w.r.t. the initial field and a conductivity
    parameter."""
    grid = CylindricalGrid(5, 12, 10, 6e-4, 8e-4, r_inner=0.015)
    rng = np.random.default_rng(12)
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = _field(grid.shape, lo=100.0, hi=900.0)
    g = {name: jax.grad(_loss, argnums=(0, 1))(30.0, T0, grid, act, tier)
         for name, tier in (("scan", SCAN), ("kernel", KERNEL))}
    np.testing.assert_allclose(float(g["kernel"][0]), float(g["scan"][0]),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(g["kernel"][1]),
                               np.asarray(g["scan"][1]), rtol=1e-9,
                               atol=1e-12)


def test_step_grad_f32_kernel_within_budget_of_f64_scan():
    """The float32 kernel-tier gradient stays within 1e-3 (relative) of the
    float64 scan-tier gradient."""
    grid = CylindricalGrid(5, 12, 10, 6e-4, 8e-4, r_inner=0.015)
    rng = np.random.default_rng(13)
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = _field(grid.shape, lo=100.0, hi=900.0)
    g64 = jax.grad(_loss, argnums=(0, 1))(30.0, T0, grid, act, SCAN)
    g32 = jax.grad(_loss, argnums=(0, 1))(
        jnp.float32(30.0), T0.astype(jnp.float32), grid, act, KERNEL)
    np.testing.assert_allclose(float(g32[0]), float(g64[0]), rtol=1e-3)
    scale = float(jnp.max(jnp.abs(g64[1])))
    err = float(jnp.max(jnp.abs(g32[1].astype(jnp.float64) - g64[1])))
    assert err < 1e-3 * scale, (err, scale)


def _cart_varprop_both(k_table, rad):
    from adi_thermal_fields_tpu import CartesianGrid
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(12, 14, 20, 1e-3, dy=1.2e-3, dz=0.6e-3)
    rng = np.random.default_rng(21)
    mask = jnp.asarray(rng.random(grid.shape) < 0.85)
    T0 = jnp.where(mask, _field(grid.shape, lo=200.0, hi=1600.0), 20.0)
    out = {}
    for name, tier in (("scan", SCAN), ("kernel", KERNEL)):
        prep, adv = make_cartesian_engine(
            grid, MAT, robin_h=15.0, t_inf=20.0, k_table=k_table,
            cp_table=CP_TAB, emissivity=0.5 if rad else None, **tier)
        out[name] = np.asarray(adv(T0, prep(mask), 0.02, jnp.int32(2), 0.0))
    np.testing.assert_allclose(out["kernel"], out["scan"], rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("rad", [False, True])
def test_cartesian_varprop_kernel_matches_scan(rad):
    """Cartesian varprop engine (latent heat + melt-pool k, radiation
    on/off) on anisotropic voxels: kernel vs scan."""
    _cart_varprop_both(K_TAB, rad)


@pytest.mark.parametrize("rad", [False, True])
def test_cartesian_varprop_anisotropic_k_kernel_matches_scan(rad):
    """Per-axis conductivity tables (faster along the bead than across
    layers) through the Cartesian varprop engine: kernel vs scan."""
    _cart_varprop_both((K_TAB, 40.0, lambda T: 30.0 + 0.01 * T), rad)


def test_step_nphi1_no_inner():
    """Axisymmetric r-z grid (nphi = 1: no phi solve) without an inner
    film."""
    grid = CylindricalGrid(8, 1, 24, 5e-4, 1e-3, r_inner=0.02)
    _both(_field(grid.shape), grid, k_table=K_TAB, cp_table=CP_TAB,
          emissivity=0.4)


def test_step_douglas_kernel_matches_scan():
    """The Douglas-Gunn scheme (affine operators from the same streams) on
    both tiers."""
    grid = CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    _both(_field(grid.shape, lo=100.0, hi=900.0), grid, k_table=K_TAB,
          cp_table=CP_TAB, scheme="douglas", theta=0.5, emissivity=0.3)


def test_step_bf16_state_kernel_matches_scan():
    """A bfloat16 state solves at f32 and rounds once on both tiers: the
    same f32 solve, the same rounding."""
    grid = CylindricalGrid(6, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    T = _field(grid.shape).astype(jnp.bfloat16)
    kw = dict(dt=jnp.float32(0.05), robin_outer=ROB, zbc=ZBC,
              k_table=K_TAB, cp_table=CP_TAB)
    a = adi_step_cyl_varprop(T, grid, MAT, **SCAN, **kw)
    b = adi_step_cyl_varprop(T, grid, MAT, **KERNEL, **kw)
    assert b.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  np.asarray(b, np.float32))
