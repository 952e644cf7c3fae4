"""Equivalence of the Triton Thomas-kernel tier with the scan reference.

Runs the kernel (solvers/thomas_triton.py) in Pallas interpret mode on CPU;
``chip_smoke.py`` runs the compiled kernel against the scan on the GPU."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import (CartesianGrid, Material, adi_step_cartesian,
                                    build_coeff_packs)
from adi_thermal_fields_tpu.solvers.thomas import (cyclic_thomas, thomas,
                                                   thomas_along_axis)
from adi_thermal_fields_tpu.step.cartesian import (build_sweep_system,
                                                   implicit_sweep)

KERNEL = dict(implementation="pallas", interpret=True)
SCAN = dict(implementation="xla")


def _sweep_fields(rng, shape):
    mask = jnp.asarray(rng.random(shape) > 0.3)
    dirm = jnp.asarray(rng.random(shape) > 0.85)
    rhs = jnp.asarray(rng.normal(size=shape) * 100)
    coeff = jnp.asarray(np.abs(rng.normal(size=shape)))
    dval = jnp.asarray(rng.normal(size=shape) * 500)
    q = jnp.asarray(rng.normal(size=shape))
    return mask, dirm, rhs, coeff, dval, q


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_sweep_matches_reference(axis):
    """One masked implicit sweep (void rows, Dirichlet pins, Robin sink,
    Neumann source) along each axis: kernel vs scan."""
    rng = np.random.default_rng(axis)
    shape = (9, 11, 13)
    mask = jnp.asarray(rng.random(shape) > 0.25)
    dirm = jnp.asarray(rng.random(shape) > 0.9)
    rhs = jnp.asarray(rng.random(shape) * 100)
    coeff = jnp.asarray(np.where(rng.random(shape) > 0.5, 0.3, 0.0)
                        * np.asarray(mask))
    q = jnp.asarray(rng.random(shape) * np.asarray(mask))
    dval = jnp.asarray(rng.random(shape) * 500)
    args = (rhs, mask, coeff, dirm, dval, q, 0.37, 0.05, 20.0)
    ref = implicit_sweep(*args, axis=axis, **SCAN)
    got = implicit_sweep(*args, axis=axis, **KERNEL)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("with_bcs", [False, True])
def test_pallas_step_grad_matches_scan_path(with_bcs):
    """The kernel's custom VJP (transposed tridiagonal solve): jax.grad
    through the kernel-tier step matches the scan path, w.r.t. both the
    field and dt."""
    grid = CartesianGrid(8, 7, 10, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(11)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    w = jnp.asarray(rng.random(grid.shape))  # loss weights
    if with_bcs:
        dirm = np.zeros(grid.shape, bool)
        dirm[:, :, 0] = np.asarray(mask)[:, :, 0]
        kw = dict(robin_h=250.0, neumann={"z+": 2e5},
                  dirichlet_mask=jnp.asarray(dirm), dirichlet_value=77.0)
    else:
        kw = dict(robin_h=250.0)
    packs = build_coeff_packs(mask, grid, mat, **kw)

    def loss(T, dt, tier):
        for _ in range(2):
            T = adi_step_cartesian(T, mask, packs, grid, mat, dt=dt,
                                   theta=0.5, t_inf=20.0, **tier)
        return jnp.sum(w * T)

    gT_ref, gdt_ref = jax.grad(loss, argnums=(0, 1))(T0, 0.02, SCAN)
    gT, gdt = jax.grad(loss, argnums=(0, 1))(T0, 0.02, KERNEL)
    np.testing.assert_allclose(np.asarray(gT), np.asarray(gT_ref),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(gdt), float(gdt_ref), rtol=1e-8)


@pytest.mark.parametrize("n", [8, 24, 64, 129])
def test_twisted_sweep_matches_one_sided(n):
    """Solve lengths with and without a power of two (the kernel loops over
    the solve axis; no BlockSpec on it) on a ragged 9 x 130 batch, with
    pins and Neumann sources: kernel vs scan."""
    rng = np.random.default_rng(n)
    shape = (n, 9, 130)
    mask, dirm, rhs, coeff, dval, q = _sweep_fields(rng, shape)
    abcd = build_sweep_system(rhs, mask, coeff, dirm, dval, q, 0.37, 0.05,
                              20.0, axis=0)
    one = thomas(*abcd, **SCAN)
    two = thomas(*abcd, **KERNEL)
    np.testing.assert_allclose(np.asarray(two), np.asarray(one), rtol=1e-11,
                               atol=1e-11)


def test_plan_lite_step_matches_field_plan():
    """A scalar Robin h and the same h as a per-face dict build the same
    packs; the kernel-tier step gives the same field either way, equal to
    the scan step, and its gradient matches the scan's, on a WAAM-like
    geometry (solid bulk, deposited step, void above)."""
    shape = (32, 24, 40)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(7)
    m = np.ones(shape, bool)
    zs = 3 * shape[2] // 4
    m[:, :, zs:] = False
    m[8:24, 6:18, zs:zs + 2] = True
    mask = jnp.asarray(m)
    T = jnp.asarray(np.where(m, 20 + 880 * rng.random(shape), 20.0))
    h = 250.0
    packs = build_coeff_packs(mask, grid, mat, robin_h=h)
    packs_f = build_coeff_packs(
        mask, grid, mat,
        robin_h={f: h for f in ("x-", "x+", "y-", "y+", "z-", "z+")})
    step = lambda T, pk, tier: adi_step_cartesian(
        T, mask, pk, grid, mat, dt=0.05, theta=0.5, t_inf=20.0, **tier)
    a = step(T, packs_f, KERNEL)
    b = step(T, packs, KERNEL)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r = step(T, packs, SCAN)
    np.testing.assert_allclose(np.asarray(b), np.asarray(r), rtol=1e-12,
                               atol=1e-9)
    gl = jax.grad(lambda T: jnp.sum(step(T, packs, KERNEL)))(T)
    gs = jax.grad(lambda T: jnp.sum(step(T, packs, SCAN)))(T)
    np.testing.assert_allclose(np.asarray(gl), np.asarray(gs), rtol=1e-10,
                               atol=1e-10)


def test_twisted_sweep_bf16_mixed():
    """bf16 systems solve in f32 inside the kernel and store bf16: within a
    bf16 quantum of the f32 scan solve of the same (rounded) inputs."""
    rng = np.random.default_rng(3)
    shape = (48, 8, 128)
    mask = jnp.asarray(rng.random(shape) > 0.3)
    rhs = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    coeff = jnp.asarray(np.abs(rng.normal(size=shape)), jnp.bfloat16)
    zero = jnp.zeros(shape, jnp.bfloat16)
    abcd = build_sweep_system(rhs, mask, coeff, jnp.zeros(shape, bool), zero,
                              zero, 0.4, 0.05, 20.0, axis=0)
    two = thomas(*abcd, **KERNEL)
    one = thomas(*(v.astype(jnp.float32) for v in abcd), **SCAN)
    assert two.dtype == jnp.bfloat16
    diff = jnp.abs(one - two.astype(jnp.float32))
    assert float(diff.max()) < 0.05


@pytest.mark.parametrize("n", [8, 24, 64, 129])
def test_twisted_axis1_matches_one_sided(n):
    """The y sweep (solve axis 1, moved to the front) on the kernel vs the
    scan, across solve lengths, with pins and Neumann sources."""
    rng = np.random.default_rng(n)
    shape = (9, n, 130)
    mask, dirm, rhs, coeff, dval, q = _sweep_fields(rng, shape)
    args = (rhs, mask, coeff, dirm, dval, q, 0.37, 0.05, 20.0)
    one = implicit_sweep(*args, axis=1, **SCAN)
    two = implicit_sweep(*args, axis=1, **KERNEL)
    np.testing.assert_allclose(np.asarray(two), np.asarray(one), rtol=1e-11,
                               atol=1e-11)


def test_twisted_axis1_bf16_mixed_and_lite():
    """The y sweep with bf16 systems on the kernel (f32 solve, bf16 store)
    is within a bf16 quantum of the f32 scan, with a field Robin sink and
    with a constant (scalar) one."""
    rng = np.random.default_rng(3)
    shape = (8, 48, 128)
    mask = jnp.asarray(rng.random(shape) > 0.3)
    rhs = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    coeff_f = jnp.asarray(np.abs(rng.normal(size=shape)), jnp.bfloat16)
    coeff_c = jnp.where(mask, 0.02, 0.0).astype(jnp.bfloat16)
    zero = jnp.zeros(shape, jnp.bfloat16)
    for coeff in (coeff_f, coeff_c):
        abcd = build_sweep_system(rhs, mask, coeff, jnp.zeros(shape, bool),
                                  zero, zero, 0.4, 0.05, 20.0, axis=1)
        two = thomas_along_axis(*abcd, axis=1, **KERNEL)
        one = thomas_along_axis(*(v.astype(jnp.float32) for v in abcd),
                                axis=1, **SCAN)
        assert two.dtype == jnp.bfloat16
        diff = jnp.abs(one - two.astype(jnp.float32))
        assert float(diff.max()) < 0.05


def test_bfloat16_state_adequacy():
    """bf16 state through the kernel-tier engine (f32 solve, stochastically
    rounded bf16 store): over a 30-step masked Robin cooling run from a
    900 C random field the bf16 trajectory stays within the analytic-oracle
    tolerances (60 C mean / 120 C max) of the f64 scan run."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(16, 14, 12, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(5)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    packs64 = build_coeff_packs(mask, grid, mat, robin_h=300.0)
    T64 = T0
    for _ in range(30):
        T64 = adi_step_cartesian(T64, mask, packs64, grid, mat, dt=0.05,
                                 theta=0.5, t_inf=20.0, **SCAN)
    prep, adv = make_cartesian_engine(
        grid, mat, theta=0.5, t_inf=20.0, robin_h=300.0, dtype=jnp.bfloat16,
        stochastic_rounding=True, **KERNEL)
    T16 = adv(T0.astype(jnp.bfloat16), prep(mask), jnp.bfloat16(0.05),
              jnp.int32(30), 0.0)
    assert T16.dtype == jnp.bfloat16
    diff = jnp.abs(T16.astype(jnp.float64) - T64)
    err_max = float(diff.max())
    err_mean = float(jnp.where(mask, diff, 0.0).sum() / mask.sum())
    assert err_max < 40.0, err_max   # < the 60/120 C oracle tolerances
    assert err_mean < 10.0, err_mean


@pytest.mark.parametrize("shape", [(16, 16, 16), (9, 11, 40), (1, 5, 7)])
def test_theta_rhs_stencil_matches_laplacians(shape):
    """The explicit theta pass's mask-aware Laplacian (plain JAX) against a
    loop over every cell and its in-mask neighbours."""
    from adi_thermal_fields_tpu.step.cartesian import masked_laplacian_1d

    rng = np.random.default_rng(sum(shape))
    T = rng.normal(300.0, 50.0, shape)
    mask = rng.random(shape) > 0.3
    inv_dx2 = 1e6
    got = np.asarray(sum(masked_laplacian_1d(jnp.asarray(T),
                                             jnp.asarray(mask), ax, inv_dx2)
                         for ax in range(3)))
    ref = np.zeros(shape)
    for idx in np.ndindex(*shape):
        if not mask[idx]:
            continue
        for ax in range(3):
            for d in (-1, 1):
                nb = list(idx)
                nb[ax] += d
                if 0 <= nb[ax] < shape[ax] and mask[tuple(nb)]:
                    ref[idx] += (T[tuple(nb)] - T[idx]) * inv_dx2
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-6)


@pytest.mark.parametrize("with_bcs", [False, True])
def test_pallas_step_matches_xla_step(with_bcs):
    rng = np.random.default_rng(7)
    grid = CartesianGrid(10, 9, 12, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    if with_bcs:
        dirm = np.zeros(grid.shape, bool)
        dirm[:, :, 0] = np.asarray(mask)[:, :, 0]
        kw = dict(robin_h=250.0, neumann={"z+": 2e5},
                  dirichlet_mask=jnp.asarray(dirm), dirichlet_value=77.0)
    else:
        kw = dict(robin_h=250.0)
    packs = build_coeff_packs(mask, grid, mat, **kw)
    out = {}
    for name, tier in (("ref", SCAN), ("got", KERNEL)):
        T = T0
        for _ in range(2):
            T = adi_step_cartesian(T, mask, packs, grid, mat, dt=0.02,
                                   theta=0.5, t_inf=20.0, **tier)
        out[name] = np.asarray(T)
    np.testing.assert_allclose(out["got"], out["ref"], rtol=1e-12,
                               atol=1e-10)


def test_field_kernels_match_scan_solvers():
    """General per-cell coefficient fields, open and cyclic solves, on
    solve lengths and batches with and without powers of two: kernel vs
    scan."""
    rng = np.random.default_rng(3)
    for shape in [(16, 5, 7), (40, 8, 130), (33, 3, 20)]:
        a = jnp.asarray(rng.normal(0, 0.3, shape))
        c = jnp.asarray(rng.normal(0, 0.3, shape))
        b = jnp.asarray(2.5 + rng.random(shape))
        d = jnp.asarray(rng.normal(0, 100, shape))
        np.testing.assert_allclose(
            np.asarray(thomas(a, b, c, d, **KERNEL)),
            np.asarray(thomas(a, b, c, d, **SCAN)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(cyclic_thomas(a, b, c, d, **KERNEL)),
            np.asarray(cyclic_thomas(a, b, c, d, **SCAN)),
            rtol=1e-11, atol=1e-11)


def test_masked_cylindrical_pallas_matches_xla():
    """The masked-Robin cylindrical step on the kernel (mask-broken cyclic
    phi included) vs the scan path."""
    from adi_thermal_fields_tpu import CylindricalGrid, RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.step.cylindrical_masked import (
        adi_step_masked_robin)

    grid = CylindricalGrid(5, 24, 10, 4e-4, 1e-3, r_inner=0.03)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    rng = np.random.default_rng(8)
    act = np.zeros(grid.shape, bool)
    act[:, :, :6] = True
    act[:, :15, 6:8] = True
    active = jnp.asarray(act)
    T0 = jnp.asarray(np.where(act, 20 + 1480 * rng.random(grid.shape), 20.0))
    kw = dict(dt=0.05, active=active, robin_outer=rob, zbc=zbc,
              robin_inner=rob, h_void=80.0, T_inf_void=20.0)
    ref = adi_step_masked_robin(T0, grid, mat, **SCAN, **kw)
    got = adi_step_masked_robin(T0, grid, mat, **KERNEL, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-11,
                               atol=1e-9)


def test_varprop_pallas_matches_xla():
    """The T-dependent-property step on the kernel vs the scan."""
    from adi_thermal_fields_tpu.step.cartesian_varprop import (PropertyTable,
                                                               adi_step_varprop)

    grid = CartesianGrid(10, 9, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(0)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat, robin_h=250.0)
    Tp = np.linspace(0.0, 1200.0, 13)
    kt = PropertyTable(tuple(Tp), tuple(30.0 + 0.02 * Tp))
    kw = dict(k_table=kt, dt=0.05, theta=0.5, t_inf=20.0)
    ref = adi_step_varprop(T0, mask, packs, grid, mat, **SCAN, **kw)
    got = adi_step_varprop(T0, mask, packs, grid, mat, **KERNEL, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-11,
                               atol=1e-9)
