"""Cylindrical scheme properties: Douglas-Gunn accuracy, kernel parity."""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CylindricalGrid, Material, RobinBC, ZFaceBC
from adi_thermal_fields_tpu.step.cylindrical import adi_step


def _problem():
    grid = CylindricalGrid(8, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(0)
    # smooth initial condition (random + heavy smoothing)
    T = 20.0 + 800.0 * rng.random(grid.shape)
    for _ in range(8):
        for ax in range(3):
            T = 0.5 * T + 0.25 * (np.roll(T, 1, ax) + np.roll(T, -1, ax))
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    return grid, mat, jnp.asarray(T), rob, zbc


def _advance(grid, mat, T, rob, zbc, scheme, dt, n, theta=0.5):
    step = jax.jit(lambda T: adi_step(T, grid, mat, dt=dt, robin_outer=rob,
                                      zbc=zbc, robin_inner=rob, scheme=scheme,
                                      theta=theta))
    for _ in range(n):
        T = step(T)
    return np.asarray(T)


def test_douglas_is_higher_order_than_be():
    """The corrected Douglas-Gunn scheme (theta=0.5) must converge faster in
    dt than backward Euler: with a fine-BE reference, halving dt should cut
    Douglas error ~4x and BE error ~2x (the reference's 'douglas' drops alpha
    from the explicit operators and cannot pass this)."""
    grid, mat, T0, rob, zbc = _problem()
    t_total = 0.8
    ref = _advance(grid, mat, T0, rob, zbc, "be", t_total / 512, 512)

    errs = {}
    for scheme in ("be", "douglas"):
        e = []
        for n in (8, 16):
            out = _advance(grid, mat, T0, rob, zbc, scheme, t_total / n, n)
            e.append(float(np.abs(out - ref).max()))
        errs[scheme] = e
    rate_be = errs["be"][0] / errs["be"][1]
    rate_dg = errs["douglas"][0] / errs["douglas"][1]
    assert 1.5 < rate_be < 2.6, (errs, rate_be)    # first order
    assert rate_dg > 3.0, (errs, rate_dg)           # ~second order
    assert errs["douglas"][1] < errs["be"][1]       # and more accurate


def test_cylindrical_pallas_const_interpret_parity():
    """The broadcast-coefficient (column) path of the Triton kernel
    (interpret mode on CPU) matches the lax.scan path for the BE step."""
    grid, mat, T0, rob, zbc = _problem()
    a = _advance(grid, mat, T0, rob, zbc, "be", 0.05, 3)
    step_p = jax.jit(lambda T: adi_step(T, grid, mat, dt=0.05, robin_outer=rob,
                                        zbc=zbc, robin_inner=rob, scheme="be",
                                        implementation="pallas",
                                        interpret=True))
    T = T0
    for _ in range(3):
        T = step_p(T)
    np.testing.assert_allclose(np.asarray(T), a, rtol=1e-12, atol=1e-12)


def test_nphi_equals_one_degenerates_to_rz():
    """nphi == 1 (axisymmetric r-z problems) must work end to end — the
    reference supports it via identity phi rows (adi3d_cyl_phi_v3.py:233-235,
    :308-309)."""
    grid = CylindricalGrid(8, 1, 12, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    T = jnp.full(grid.shape, 900.0)
    for _ in range(5):
        T = adi_step(T, grid, mat, dt=0.1, robin_outer=rob, zbc=zbc,
                     robin_inner=rob, scheme="be")
    assert np.isfinite(np.asarray(T)).all()
    assert 20.0 < float(T.min()) <= float(T.max()) < 900.0


def test_cylindrical_kernel_bitwise_annular_dirichlet_source():
    """The BE step on the Triton kernel (interpret mode) vs the scan, f32:
    annular grid with inner+outer Robin, a z Dirichlet/Robin pair and a
    source, on batch sizes that are no multiple of the kernel block."""
    grid = CylindricalGrid(10, 24, 40, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob, robi = RobinBC(300.0, 20.0), RobinBC(150.0, 25.0)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=100.0,
                  kind_top="robin", h_top=400.0, T_inf_top=20.0)
    rng = np.random.default_rng(4)
    T = jnp.asarray((300 + 600 * rng.random(grid.shape)).astype(np.float32))
    src = jnp.asarray((rng.random(grid.shape) * 1e6).astype(np.float32))
    kw = dict(dt=0.02, robin_outer=rob, zbc=zbc, robin_inner=robi, source=src)
    o0 = adi_step(T, grid, mat, implementation="xla", **kw)
    o1 = adi_step(T, grid, mat, implementation="pallas", interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o0))
