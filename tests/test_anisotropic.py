"""Anisotropic voxel spacing (dx, dy, dz) — beyond-reference capability.

The reference supports cubic voxels only (Grid3D.dx, adi3d_numba_coeff.py:14);
WAAM layers are typically thinner than the lateral resolution.  Checks:
axis-permutation equivalence (a 1-D problem along z with spacing dz must
evolve exactly like the same problem along x of a uniform dz-spaced grid),
lumped Robin cooling with per-axis face areas, and pallas/XLA agreement.
"""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import (CartesianGrid, Material,
                                    adi_step_cartesian, build_coeff_packs)


def test_grid_defaults_and_geometry():
    g = CartesianGrid(4, 5, 6, 1e-3)
    assert g.spacing == (1e-3, 1e-3, 1e-3) and g.is_uniform
    ga = CartesianGrid(4, 5, 6, 1e-3, dy=2e-3, dz=0.5e-3)
    assert ga.spacing == (1e-3, 2e-3, 0.5e-3) and not ga.is_uniform
    np.testing.assert_allclose(ga.cell_volume, 1e-9)
    np.testing.assert_allclose(ga.face_area_axis(0), 2e-3 * 0.5e-3)
    np.testing.assert_allclose(ga.face_area_axis(1), 1e-3 * 0.5e-3)
    np.testing.assert_allclose(ga.face_area_axis(2), 1e-3 * 2e-3)


def test_axis_permutation_equivalence():
    """A field varying only along z on a (dx, dy, dz)-grid must evolve
    exactly as the same profile along x of a uniform grid with spacing dz
    (adiabatic; constant-direction sweeps are exact passthroughs)."""
    n = 24
    mat = Material(7800.0, 490.0, 54.0)
    prof = 100.0 + 80.0 * np.cos(np.pi * (np.arange(n) + 0.5) / n)

    gz = CartesianGrid(4, 5, n, 1e-3, dy=1.5e-3, dz=2e-3)
    Tz = jnp.asarray(np.broadcast_to(prof[None, None, :], gz.shape))
    mz = jnp.ones(gz.shape, bool)
    pz = build_coeff_packs(mz, gz, mat)

    gx = CartesianGrid(n, 4, 5, 2e-3)
    Tx = jnp.asarray(np.broadcast_to(prof[:, None, None], gx.shape))
    mx = jnp.ones(gx.shape, bool)
    px = build_coeff_packs(mx, gx, mat)

    for _ in range(5):
        Tz = adi_step_cartesian(Tz, mz, pz, gz, mat, dt=0.1, theta=0.5)
        Tx = adi_step_cartesian(Tx, mx, px, gx, mat, dt=0.1, theta=0.5)
    np.testing.assert_allclose(np.asarray(Tz)[0, 0, :],
                               np.asarray(Tx)[:, 0, 0], rtol=1e-12)
    # and the anisotropic run is NOT what a dz=dx run would give
    gu = CartesianGrid(4, 5, n, 1e-3)
    Tu = jnp.asarray(np.broadcast_to(prof[None, None, :], gu.shape))
    pu = build_coeff_packs(jnp.ones(gu.shape, bool), gu, mat)
    for _ in range(5):
        Tu = adi_step_cartesian(Tu, mz, pu, gu, mat, dt=0.1, theta=0.5)
    assert np.abs(np.asarray(Tu) - np.asarray(Tz)).max() > 1.0


def test_lumped_robin_cooling_per_axis_areas():
    """Whole-block Robin cooling: the decay rate is h*A_total/(rho cp V)
    with the TRUE anisotropic surface area (per-axis A/V factors)."""
    mat = Material(7800.0, 490.0, 200.0)    # high k -> lumped (Bi << 1)
    nx, ny, nz = 6, 4, 3
    dx, dy, dz = 1e-3, 2e-3, 4e-3
    grid = CartesianGrid(nx, ny, nz, dx, dy=dy, dz=dz)
    mask = jnp.ones(grid.shape, bool)
    h, t_inf = 100.0, 20.0
    packs = build_coeff_packs(mask, grid, mat, robin_h=h)

    T = jnp.full(grid.shape, 520.0)
    dt, steps = 0.05, 60
    step = jax.jit(lambda T: adi_step_cartesian(T, mask, packs, grid, mat,
                                                dt=dt, theta=0.5,
                                                t_inf=t_inf))
    for _ in range(steps):
        T = step(T)
    # lumped ODE: T(t) = T_inf + (T0 - T_inf) * exp(-h A / (rho cp V) t)
    Lx, Ly, Lz = nx * dx, ny * dy, nz * dz
    A = 2 * (Lx * Ly + Ly * Lz + Lz * Lx)
    V = Lx * Ly * Lz
    rate = h * A / (mat.rho * mat.cp * V)
    T_ode = t_inf + (520.0 - t_inf) * np.exp(-rate * dt * steps)
    np.testing.assert_allclose(float(jnp.mean(T)), T_ode, rtol=0.01)


def test_pallas_matches_xla_anisotropic():
    """Triton-kernel step (interpret mode) == scan step on an anisotropic
    masked grid with Robin + Neumann + Dirichlet, and with Robin alone."""
    grid = CartesianGrid(12, 10, 14, 1e-3, dy=2e-3, dz=0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(8)
    mask = jnp.asarray(rng.random(grid.shape) > 0.25)
    T = jnp.where(mask, 900.0, 20.0).astype(jnp.float32)
    dm = jnp.zeros(grid.shape, bool).at[:, :, 0].set(True) & mask
    packs = build_coeff_packs(mask, grid, mat, robin_h=150.0,
                              neumann={"z+": 3e5}, dirichlet_mask=dm,
                              dirichlet_value=300.0, dtype=jnp.float32)
    packs2 = build_coeff_packs(mask, grid, mat, robin_h=150.0,
                               dtype=jnp.float32)
    for pk in (packs, packs2):
        ref = adi_step_cartesian(T, mask, pk, grid, mat, dt=0.05, theta=0.5,
                                 t_inf=20.0, implementation="xla")
        got = adi_step_cartesian(T, mask, pk, grid, mat, dt=0.05, theta=0.5,
                                 t_inf=20.0, implementation="pallas",
                                 interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-6, atol=1e-4)


def test_engine_anisotropic_lite():
    """The engine's plan-lite path derives per-axis Robin constants from the
    grid spacing; xla and pallas-interpret engines agree on an anisotropic
    grid."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(10, 8, 12, 1e-3, dy=1.5e-3, dz=0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    active = jnp.ones(grid.shape, bool).at[:, :, -3:].set(False)
    T = jnp.where(active, 800.0, 20.0).astype(jnp.float32)
    outs = {}
    for impl, kw in (("xla", {}), ("pallas", {"interpret": True})):
        prep, adv = make_cartesian_engine(grid, mat, theta=0.5, t_inf=20.0,
                                          robin_h=120.0, dtype=jnp.float32,
                                          implementation=impl, **kw)
        outs[impl] = np.asarray(adv(T, prep(active), jnp.float32(0.05),
                                    jnp.int32(5)))
    np.testing.assert_allclose(outs["pallas"], outs["xla"], rtol=1e-5)


def test_voxelize_anisotropic_native_matches_numpy():
    """Per-axis-pitch parity voxelization: the native C++ kernel and the
    numpy path are bit-identical, and the voxel volume estimate of a sphere
    is correct at anisotropic pitch."""
    from adi_thermal_fields_tpu.geometry.primitives import uv_sphere_mesh
    from adi_thermal_fields_tpu.geometry.voxelize import (grid_from_mesh,
                                                          voxelize_solid)

    m = uv_sphere_mesh(radius=0.01, n_theta=24, n_phi=48)
    d = (0.8e-3, 1.1e-3, 0.5e-3)
    origin, dims = grid_from_mesh(m, d)
    mn, _ = voxelize_solid(m, d, origin=origin, dims=dims, use_native=True)
    mp, _ = voxelize_solid(m, d, origin=origin, dims=dims, use_native=False)
    np.testing.assert_array_equal(mn, mp)
    vol = 4.0 / 3.0 * np.pi * 0.01 ** 3
    assert abs(float(mn.sum()) * np.prod(d) - vol) / vol < 0.05


def test_waam_app_anisotropic_dz(tmp_path):
    """--dz_mm: layer-resolved anisotropic WAAM run end-to-end — the grid
    gets dz-thin slabs (layers counted by dz), and all solid cells activate."""
    import os

    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    outdir = str(tmp_path / "out")
    args = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--dz_mm", "0.5", "--nframes", "2",
        "--save_vtk", "0", "--outdir", outdir, "--bead_height_mm", "2"])
    res = run(args)
    grid = res["grid"]
    assert grid.dz == 0.5e-3 and grid.dx == 1e-3
    # 8 mm of part at dz=0.5 -> ~16 solid slabs -> 4 layers of 4 slabs
    assert len(res["layers"]) == 4
    assert all(ke - ks + 1 == 4 for ks, ke in res["layers"])
    active = np.asarray(res["active"])
    # every solid voxel deposited by the end
    assert int(active.sum()) > 0
    T = np.asarray(res["T"])
    assert np.isfinite(T).all() and T.max() > 20.0


def test_surface_impulse_uses_face_normal_spacing():
    """apply_surface_impulse: dT = Q/(rho cp d_normal) — the energy added is
    Q * A_face per exposed cell regardless of which axis the face faces."""
    from adi_thermal_fields_tpu.step.cartesian import apply_surface_impulse

    mat = Material(7800.0, 490.0, 54.0)
    grid = CartesianGrid(6, 6, 6, 1e-3, dy=2e-3, dz=0.5e-3)
    mask = jnp.ones(grid.shape, bool)
    T0 = jnp.zeros(grid.shape)
    Q = 1e6    # J/m^2 on the face
    for face, axis in (("z-", 2), ("y+", 1), ("x-", 0)):
        T = apply_surface_impulse(T0, mask, grid, mat, Q, face=face)
        dT = float(jnp.max(T))
        expect = Q / (mat.rho * mat.cp * grid.spacing[axis])
        np.testing.assert_allclose(dT, expect, rtol=1e-12)
        # energy check: sum(rho cp dT V) == Q * total face area
        E = float(jnp.sum(T)) * mat.rho * mat.cp * grid.cell_volume
        n_faces = {0: 36, 1: 36, 2: 36}[axis]
        np.testing.assert_allclose(E, Q * n_faces * grid.face_area_axis(axis),
                                   rtol=1e-12)
