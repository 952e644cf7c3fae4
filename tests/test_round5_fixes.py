"""Round-5 fixes: per-face/field Robin h through the varprop engine on the
Triton-kernel solver tier (the flagship `--corrected_bc --emissivity`
configuration).  Reference contract: voxel_bc_correction.py:207-225 —
corrected Robin output is just another h field through the unified
machinery."""
import numpy as np
import pytest

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid, Material
from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
from adi_thermal_fields_tpu.step.cartesian_varprop import (PropertyTable,
                                                           apparent_cp)

FACES = ("x-", "x+", "y-", "y+", "z-", "z+")


def _setup(n=8):
    grid = CartesianGrid(n, n, n, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    m = np.zeros(grid.shape, bool)
    m[:, :, : n // 2] = True
    m[: n // 2, : n // 2, n // 2 : n // 2 + 2] = True   # step feature
    mask = jnp.asarray(m)
    T0 = jnp.where(mask, 1400.0, 20.0)
    rng = np.random.default_rng(7)
    hf = {f: jnp.asarray(20.0 + 15.0 * rng.random(grid.shape))
          for f in FACES}
    sc = {f: jnp.asarray(0.6 + 0.8 * rng.random(grid.shape))
          for f in FACES}
    kt = PropertyTable(jnp.asarray([0.0, 800.0, 1600.0]),
                       jnp.asarray([40.0, 50.0, 58.0]))
    ct = apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)
    return grid, mat, mask, T0, hf, sc, kt, ct


def _run(impl, grid, mat, mask, T0, n_steps=6, **kw):
    prepare, advance = make_cartesian_engine(
        grid, mat, t_inf=20.0, implementation=impl, **kw)
    prep = prepare(mask)
    return advance(T0, prep, jnp.asarray(0.02), jnp.int32(n_steps), 0.0)


def test_fused_field_h_radiative_matches_materialized():
    """Per-face corrected-style h FIELDS + emissivity + per-face radiative
    area scales: the kernel lane (interpret mode) must reproduce the scan
    lane."""
    grid, mat, mask, T0, hf, sc, kt, ct = _setup()
    kw = dict(robin_h=hf, emissivity=0.65, radiation_scale=sc,
              k_table=kt, cp_table=ct)
    Tf = _run("pallas", grid, mat, mask, T0, interpret=True, **kw)
    Tx = _run("xla", grid, mat, mask, T0, **kw)
    np.testing.assert_allclose(np.asarray(Tf), np.asarray(Tx),
                               rtol=1e-9, atol=1e-9)


def test_fused_field_h_convective_matches_materialized():
    """A single 3-D convective h field (no radiation) through the kernel
    lane vs the scan lane."""
    grid, mat, mask, T0, hf, _, kt, ct = _setup()
    h3d = hf["x-"]
    kw = dict(robin_h=h3d, k_table=kt, cp_table=ct)
    Tf = _run("pallas", grid, mat, mask, T0, interpret=True, **kw)
    Tx = _run("xla", grid, mat, mask, T0, **kw)
    np.testing.assert_allclose(np.asarray(Tf), np.asarray(Tx),
                               rtol=1e-9, atol=1e-9)


def test_fused_field_h_constant_fields_match_scalar_lane():
    """Per-face fields all equal to one constant must agree with the
    scalar-h lane (both on the kernel tier)."""
    grid, mat, mask, T0, _, _, kt, ct = _setup()
    h0 = 27.5
    hconst = {f: jnp.full(grid.shape, h0) for f in FACES}
    Tf = _run("pallas", grid, mat, mask, T0, interpret=True,
              robin_h=hconst, k_table=kt, cp_table=ct)
    Ts = _run("pallas", grid, mat, mask, T0, interpret=True,
              robin_h=h0, k_table=kt, cp_table=ct)
    np.testing.assert_allclose(np.asarray(Tf), np.asarray(Ts),
                               rtol=1e-11, atol=1e-11)


def test_fused_field_h_radiative_scalar_scale_equiv():
    """emissivity + unit radiation scales through the field lane ==
    scalar-conv radiative lane when the per-face fields equal the scalar
    film."""
    grid, mat, mask, T0, _, _, kt, ct = _setup()
    h0 = 18.0
    hconst = {f: jnp.full(grid.shape, h0) for f in FACES}
    ones = {f: jnp.ones(grid.shape) for f in FACES}
    Tf = _run("pallas", grid, mat, mask, T0, interpret=True,
              robin_h=hconst, emissivity=0.5, radiation_scale=ones,
              k_table=kt, cp_table=ct)
    Ts = _run("pallas", grid, mat, mask, T0, interpret=True,
              robin_h=h0, emissivity=0.5, k_table=kt, cp_table=ct)
    np.testing.assert_allclose(np.asarray(Tf), np.asarray(Ts),
                               rtol=1e-9, atol=1e-9)


def test_fused_field_h_birth_rebuild():
    """Packs are rebuilt on birth events (prepare is mask-dependent):
    activating a slab and stepping through the kernel lane matches the
    scan lane after the rebuild."""
    grid, mat, mask, T0, hf, sc, kt, ct = _setup()
    kw = dict(robin_h=hf, emissivity=0.65, radiation_scale=sc,
              k_table=kt, cp_table=ct)
    m2 = np.asarray(mask).copy()
    m2[:, :, grid.shape[2] // 2 : grid.shape[2] // 2 + 2] = True
    mask2 = jnp.asarray(m2)

    def both(impl, interp):
        prepare, advance = make_cartesian_engine(
            grid, mat, t_inf=20.0, implementation=impl,
            interpret=interp, **kw)
        T = advance(T0, prepare(mask), jnp.asarray(0.02), jnp.int32(3),
                    0.0)
        T = jnp.where(mask2 & ~mask, 1500.0, T)
        return advance(T, prepare(mask2), jnp.asarray(0.02),
                       jnp.int32(3), 0.0)

    np.testing.assert_allclose(np.asarray(both("pallas", True)),
                               np.asarray(both("xla", False)),
                               rtol=1e-9, atol=1e-9)


def test_cyl_varprop_rejects_unknown_implementation():
    """Solver tiers go through the one resolver (core/backend.py): an
    unknown tier name, or the kernel on the CPU without interpret, must
    refuse loudly instead of silently running something else."""
    import jax.numpy as jnp

    from adi_thermal_fields_tpu import (CylindricalGrid, RobinBC, ZFaceBC)
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop)

    grid = CylindricalGrid(4, 8, 8, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    T = jnp.full(grid.shape, 100.0, jnp.float32)
    kw = dict(robin_outer=RobinBC(100.0, 20.0),
              zbc=ZFaceBC(kind_top="robin", h_top=50.0, T_inf_top=20.0),
              dt=jnp.float32(0.01))
    with pytest.raises(ValueError, match="unknown implementation"):
        adi_step_cyl_varprop(T, grid, mat, implementation="pallas_fields",
                             **kw)
    with pytest.raises(ValueError, match="interpret"):
        adi_step_cyl_varprop(T, grid, mat, implementation="pallas", **kw)


def test_radiative_h_matches_stefan_boltzmann_flux():
    """The Picard radiative film factors the Stefan-Boltzmann flux exactly:
    h_rad(T) * (T - T_inf) = eps sigma (T_K^4 - T_inf,K^4)."""
    from adi_thermal_fields_tpu.bc.radiation import (STEFAN_BOLTZMANN,
                                                     radiative_h)

    rng = np.random.default_rng(3)
    T = jnp.asarray(rng.uniform(20.0, 1600.0, (16, 16, 24)))
    eps, t_inf = 0.45, 20.0
    h = radiative_h(T, eps, t_inf)
    Tk, Ik = np.asarray(T) + 273.15, t_inf + 273.15
    want = eps * STEFAN_BOLTZMANN * (Tk ** 4 - Ik ** 4)
    np.testing.assert_allclose(np.asarray(h) * (np.asarray(T) - t_inf),
                               want, rtol=1e-10)
    # a convective film adds linearly
    np.testing.assert_allclose(
        np.asarray(radiative_h(T, eps, t_inf, h_conv=12.0)),
        np.asarray(h) + 12.0, rtol=1e-12)


def test_bench_refuses_cpu():
    """bench.py measures the GPU only: on a CPU backend it stops before
    timing anything, instead of recording a CPU number."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import bench

    with pytest.raises(SystemExit, match="GPU"):
        bench.main(["--case", "cartesian"])
