"""Bitwise-level parity against the reference implementation.

These tests import the reference package from /root/reference (read-only,
pure-Python fallback when Numba is absent) and compare our batched formulation on
tiny grids.  They are skipped automatically when the reference checkout is not
present, so the shipped test suite remains self-contained.

No reference code is copied — it is executed as an oracle.
"""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

REF = "/root/reference"
pytestmark = pytest.mark.skipif(not os.path.isdir(REF), reason="reference checkout not present")

if os.path.isdir(REF) and REF not in sys.path:
    sys.path.insert(0, REF)


def _random_setup(seed, nx=7, ny=6, nz=5, dx=1e-3):
    from adi_thermal_fields_tpu import CartesianGrid, Material

    rng = np.random.default_rng(seed)
    mask = rng.random((nx, ny, nz)) > 0.25
    mask[nx // 2, ny // 2, nz // 2] = True  # keep at least one solid cell
    T0 = np.where(mask, 20.0 + 880.0 * rng.random((nx, ny, nz)), 20.0)
    grid = CartesianGrid(nx, ny, nz, dx)
    mat = Material(7800.0, 490.0, 54.0)
    return rng, grid, mat, mask, T0


@pytest.mark.parametrize("theta", [0.5, 1.0])
def test_cartesian_step_matches_reference(theta):
    import adi3d_numba_coeff as ref

    from adi_thermal_fields_tpu import build_coeff_packs, adi_step_cartesian

    rng, grid, mat, mask, T0 = _random_setup(seed=42)
    h_field = 300.0 * rng.random(grid.shape)
    q_zplus = 1e5 * rng.random(grid.shape)
    dir_mask = np.zeros(grid.shape, bool)
    dir_mask[:, :, 0] = mask[:, :, 0]
    dir_val = 100.0
    t_inf = 20.0
    dt = 0.01

    # --- reference run ---
    rgrid = ref.Grid3D(grid.nx, grid.ny, grid.nz, grid.dx, mask)
    rmat = ref.Material(mat.rho, mat.cp, mat.k)
    rprm = ref.Params(dt, theta)
    rpacks = ref.precompute_coeff_packs_unified(
        rgrid, rmat, dir_mask=dir_mask, dir_value=dir_val,
        neumann={"z+": q_zplus}, robin_h=h_field, robin_Tinf=t_inf)
    T_ref = T0.copy()
    for _ in range(3):
        T_ref = ref.adi_step_numba_coeff(T_ref, rgrid, rmat, rprm, rpacks, Tinf=t_inf)

    # --- our run ---
    packs = build_coeff_packs(jnp.asarray(mask), grid, mat,
                              robin_h=jnp.asarray(h_field),
                              neumann={"z+": jnp.asarray(q_zplus)},
                              dirichlet_mask=jnp.asarray(dir_mask),
                              dirichlet_value=dir_val)
    T = jnp.asarray(T0)
    for _ in range(3):
        T = adi_step_cartesian(T, jnp.asarray(mask), packs, grid, mat,
                               dt=dt, theta=theta, t_inf=t_inf)

    np.testing.assert_allclose(np.asarray(T), T_ref, rtol=1e-10, atol=1e-9)


def test_coeff_packs_match_reference():
    import adi3d_numba_coeff as ref

    from adi_thermal_fields_tpu import build_coeff_packs

    rng, grid, mat, mask, _ = _random_setup(seed=7)
    h = {"x-": 100.0, "x+": 50.0 * rng.random(grid.shape), "z+": 400.0}
    q = {"y-": 2e5, "z-": 1e4 * rng.random(grid.shape)}

    rgrid = ref.Grid3D(grid.nx, grid.ny, grid.nz, grid.dx, mask)
    rmat = ref.Material(mat.rho, mat.cp, mat.k)
    rx, ry, rz = ref.precompute_coeff_packs_unified(rgrid, rmat, neumann=q, robin_h=h)

    packs = build_coeff_packs(jnp.asarray(mask), grid, mat, robin_h=h, neumann=q)
    np.testing.assert_allclose(np.asarray(packs.coeff[0]), rx.coeff, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(packs.coeff[1]), ry.coeff, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(packs.coeff[2]), rz.coeff, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(packs.qflux[0]), rx.qflux, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(packs.qflux[1]), ry.qflux, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(packs.qflux[2]), rz.qflux, rtol=1e-12)


def test_exposed_mask_matches_reference():
    import adi3d_numba_coeff as ref

    from adi_thermal_fields_tpu import exposed_face

    rng = np.random.default_rng(3)
    mask = rng.random((6, 7, 8)) > 0.4
    for f in ("x-", "x+", "y-", "y+", "z-", "z+"):
        ours = np.asarray(exposed_face(jnp.asarray(mask), f))
        theirs = ref.exposed_mask(mask, f)
        np.testing.assert_array_equal(ours, theirs)


def test_cylindrical_be_step_matches_reference_full_disk():
    """Full-disk cylindrical BE step vs reference adi_step
    (adi3d_cyl_phi_v3.py:332-350), incl. outer Robin + mixed z BCs."""
    import adi3d_cyl_phi_v3 as refc

    from adi_thermal_fields_tpu import (CylindricalGrid, Material, RobinBC,
                                        ZFaceBC, adi_step_cylindrical)

    nr, nphi, nz = 6, 12, 5
    dr, dz = 1e-3, 2e-3
    rng = np.random.default_rng(11)
    T0 = 20.0 + 900.0 * rng.random((nr, nphi, nz))
    S = 1e6 * rng.random((nr, nphi, nz))
    dt = 0.05

    rgrid = refc.GridCyl(nr, nphi, nz, dr, 2 * np.pi / nphi, dz, R=nr * dr)
    rmat = refc.Material(7800.0, 490.0, 54.0)
    rprm = refc.Params(dt, 1.0, "be")
    rrob = refc.RobinR(350.0, 20.0)
    rzbc = refc.ZBC(kind_bot="dirichlet", kind_top="robin", h_top=500.0,
                    T_inf_top=25.0, T_bot=100.0)
    T_ref = refc.adi_step(T0.copy(), rgrid, rmat, rprm, rrob, rzbc, S=S)

    grid = CylindricalGrid(nr, nphi, nz, dr, dz, r_inner=0.0)
    mat = Material(7800.0, 490.0, 54.0)
    T = adi_step_cylindrical(jnp.asarray(T0), grid, mat, dt=dt,
                             robin_outer=RobinBC(350.0, 20.0),
                             zbc=ZFaceBC(kind_bot="dirichlet", kind_top="robin",
                                         h_top=500.0, T_inf_top=25.0, T_bot=100.0),
                             source=jnp.asarray(S), scheme="be")
    np.testing.assert_allclose(np.asarray(T), T_ref, rtol=1e-10, atol=1e-9)
