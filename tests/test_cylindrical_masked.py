"""Physics invariants of the masked cylindrical solvers."""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CylindricalGrid, Material, RobinBC, ZFaceBC
from adi_thermal_fields_tpu.step.cylindrical import adi_step, adi_step_masked
from adi_thermal_fields_tpu.step.cylindrical_masked import adi_step_masked_robin


def _setup(r_inner=0.02):
    grid = CylindricalGrid(6, 12, 10, 5e-4, 1e-3, r_inner=r_inner)
    mat = Material(7800.0, 490.0, 54.0)
    return grid, mat


def test_masked_robin_adiabatic_conserves_energy():
    """With every film coefficient zero and only interior couplings, the
    masked solver must conserve the metric-weighted total energy
    sum(T * r_i) over active cells — a sharp check of the cylindrical
    finite-volume coupling factors."""
    grid, mat = _setup()
    rng = np.random.default_rng(0)
    active = jnp.asarray(rng.random(grid.shape) > 0.3)
    T = jnp.asarray(np.where(np.asarray(active),
                             100.0 + 800.0 * rng.random(grid.shape), 0.0))
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="neumann0")
    rob0 = RobinBC(0.0, 0.0)
    w = jnp.asarray(grid.r)[:, None, None]  # cell volume ~ r dr dphi dz

    e0 = float(jnp.sum(jnp.where(active, T * w, 0.0)))
    for _ in range(5):
        T = adi_step_masked_robin(T, grid, mat, dt=0.05, active=active,
                                  robin_outer=rob0, zbc=zbc, robin_inner=rob0,
                                  h_void=0.0, T_inf_void=0.0)
    e1 = float(jnp.sum(jnp.where(active, T * w, 0.0)))
    assert abs(e1 - e0) / abs(e0) < 1e-10


def test_masked_robin_full_active_matches_unmasked():
    """With every cell active, the masked solver must agree with the unmasked
    BE core away from the phi solver difference (cyclic Thomas vs FFT are
    algebraically identical systems)."""
    grid, mat = _setup()
    rng = np.random.default_rng(1)
    T0 = jnp.asarray(20.0 + 800.0 * rng.random(grid.shape))
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    active = jnp.ones(grid.shape, bool)
    a = adi_step(T0, grid, mat, dt=0.05, robin_outer=rob, zbc=zbc,
                 robin_inner=rob, scheme="be")
    b = adi_step_masked_robin(T0, grid, mat, dt=0.05, active=active,
                              robin_outer=rob, zbc=zbc, robin_inner=rob,
                              h_void=123.0, T_inf_void=20.0)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-10)


def test_masked_robin_cools_toward_ambient_never_below():
    grid, mat = _setup()
    active = jnp.zeros(grid.shape, bool).at[:, :6, :5].set(True)
    T = jnp.where(active, 900.0, 20.0)
    rob = RobinBC(400.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=400.0,
                  T_inf_top=20.0)
    prev = 900.0
    for _ in range(30):
        T = adi_step_masked_robin(T, grid, mat, dt=0.2, active=active,
                                  robin_outer=rob, zbc=zbc, robin_inner=rob,
                                  h_void=400.0, T_inf_void=20.0)
        cur = float(jnp.where(active, T, -jnp.inf).max())
        assert cur < prev + 1e-9
        assert float(jnp.where(active, T, jnp.inf).min()) > 20.0 - 1e-6
        prev = cur


def test_clamp_mode_keeps_void_at_ambient():
    """Reference-parity clamp wrapper (quick_spiral_deposition_gif_v5.py:31-70)."""
    grid, mat = _setup(r_inner=0.0)
    active = jnp.zeros(grid.shape, bool).at[:, :, :5].set(True)
    T = jnp.where(active, 700.0, 55.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=300.0, T_inf_top=20.0)
    T1 = adi_step_masked(T, grid, mat, dt=0.05, robin_outer=rob, zbc=zbc,
                         active=active, robin_void=RobinBC(300.0, 20.0))
    np.testing.assert_allclose(np.asarray(jnp.where(~active, T1, 20.0)), 20.0)


def test_masked_kernel_bitwise_with_source_and_pins():
    """The Triton-kernel tier (interpret mode) vs the scan on the masked-
    Robin step with interface Robin + z Dirichlet/Robin + source, f32, on
    a grid whose batch sizes are no multiple of the kernel block."""
    grid = CylindricalGrid(10, 24, 40, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob, robi = RobinBC(300.0, 20.0), RobinBC(150.0, 25.0)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=100.0,
                  kind_top="robin", h_top=400.0, T_inf_top=20.0)
    rng = np.random.default_rng(5)
    act = jnp.asarray(rng.random(grid.shape) > 0.35)
    T = jnp.where(act, 900.0, 20.0).astype(jnp.float32)
    src = jnp.asarray((rng.random(grid.shape) * 1e6).astype(np.float32))
    kw = dict(dt=0.02, robin_outer=rob, zbc=zbc, robin_inner=robi,
              h_void=80.0, T_inf_void=20.0, source=src, active=act)
    o0 = adi_step_masked_robin(T, grid, mat, implementation="xla", **kw)
    o1 = adi_step_masked_robin(T, grid, mat, implementation="pallas",
                               interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o0))


def test_masked_pallas_compressed_matches_xla_bitwise():
    """The Triton-kernel tier (interpret mode; cyclic phi by Sherman-
    Morrison over the kernel) vs the scan path, including Dirichlet z-end
    pins, annular and full-disk geometry, in f64."""
    for r_inner, kind_bot in ((0.02, "dirichlet"), (0.0, "neumann0")):
        grid, mat = _setup(r_inner=r_inner)
        rng = np.random.default_rng(7)
        active = jnp.asarray(rng.random(grid.shape) > 0.35)
        T = jnp.asarray(np.where(np.asarray(active),
                                 50.0 + 850.0 * rng.random(grid.shape), 20.0))
        rob = RobinBC(300.0, 20.0)
        zbc = ZFaceBC(kind_bot=kind_bot, T_bot=140.0, kind_top="robin",
                      h_top=400.0, T_inf_top=20.0)
        kw = dict(dt=0.05, active=active, robin_outer=rob, zbc=zbc,
                  robin_inner=rob if r_inner else None, h_void=80.0,
                  T_inf_void=20.0)
        a = adi_step_masked_robin(T, grid, mat, implementation="xla", **kw)
        b = adi_step_masked_robin(T, grid, mat, implementation="pallas",
                                  interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-12, atol=1e-9)


def test_masked_cyclic_kernel_vs_cyclic_scan():
    """Direct solver check: mask-broken periodic systems along axis 1 (the
    masked phi sweep's layout), cyclic Thomas over the Triton kernel vs
    over the scan."""
    from adi_thermal_fields_tpu.solvers.thomas import cyclic_thomas

    rng = np.random.default_rng(3)
    b1, n, b2 = 5, 24, 7
    active = rng.random((b1, n, b2)) > 0.3
    pin = (rng.random((b1, n, b2)) > 0.9) & active
    live = active & ~pin
    lowm = live & np.roll(live, 1, 1)
    highm = live & np.roll(live, -1, 1)
    geo = 0.5 + rng.random((b1, b2))
    sink = np.where(live, rng.random((b1, n, b2)), 0.0)
    srhs_live = np.where(live, sink * 20.0, 0.0)
    pinval = np.where(pin, 77.0, 0.0)
    srhs = np.where(pin, pinval, srhs_live)
    rhs = rng.random((b1, n, b2)) * 900.0
    fac, ambient = 0.37, 20.0

    # reference: build the cyclic systems explicitly, solve along axis 1
    g3 = geo[:, None, :]
    a = np.where(lowm, -fac * g3, 0.0)
    c = np.where(highm, -fac * g3, 0.0)
    b = 1.0 - (a + c) + fac * sink         # void/pin rows: exactly 1
    d = np.where(pin, srhs, np.where(active, rhs + fac * srhs, ambient))
    mv = lambda t: jnp.moveaxis(jnp.asarray(t), 1, 0)
    ref = jnp.moveaxis(cyclic_thomas(mv(a), mv(b), mv(c), mv(d),
                                     implementation="xla"), 0, 1)
    got = jnp.moveaxis(cyclic_thomas(mv(a), mv(b), mv(c), mv(d),
                                     implementation="pallas",
                                     interpret=True), 0, 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)
