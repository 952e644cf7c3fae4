"""Kernel-level unit tests: Thomas, cyclic Thomas, spectral phi solve.

The reference has no kernel unit tests; SURVEY.md §4 calls for testing the
tridiagonal solvers against dense solves and the cyclic solver against its
dense periodic matrix.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.thomas import thomas, thomas_along_axis, cyclic_thomas
from adi_thermal_fields_tpu.solvers.spectral import phi_solve_spectral
from adi_thermal_fields_tpu.core.grid import CylindricalGrid
from adi_thermal_fields_tpu.core.material import Material


def _random_tridiag(rng, n, batch=(), diag_dom=True):
    a = rng.standard_normal((n, *batch))
    b = rng.standard_normal((n, *batch))
    c = rng.standard_normal((n, *batch))
    if diag_dom:
        b = b + 4.0 + np.abs(a) + np.abs(c)
    d = rng.standard_normal((n, *batch))
    a[0] = 0.0
    c[-1] = 0.0
    return a, b, c, d


def _dense_solve(a, b, c, d):
    n = len(b)
    A = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    return np.linalg.solve(A, d)


def test_thomas_matches_dense():
    rng = np.random.default_rng(0)
    a, b, c, d = _random_tridiag(rng, 17)
    x = np.asarray(thomas(*(jnp.asarray(v) for v in (a, b, c, d))))
    np.testing.assert_allclose(x, _dense_solve(a, b, c, d), rtol=1e-10)


def test_thomas_batched_matches_per_system_dense():
    rng = np.random.default_rng(1)
    a, b, c, d = _random_tridiag(rng, 11, batch=(3, 5))
    x = np.asarray(thomas(*(jnp.asarray(v) for v in (a, b, c, d))))
    for i in range(3):
        for j in range(5):
            ref = _dense_solve(a[:, i, j], b[:, i, j], c[:, i, j], d[:, i, j])
            np.testing.assert_allclose(x[:, i, j], ref, rtol=1e-9)


def test_thomas_broadcast_coefficients():
    """1-D coefficient vectors broadcast across the batch (the cylindrical
    sweeps rely on this)."""
    rng = np.random.default_rng(2)
    a, b, c, _ = _random_tridiag(rng, 9)
    d = rng.standard_normal((9, 4, 6))
    x = np.asarray(thomas(jnp.asarray(a)[:, None, None],
                          jnp.asarray(b)[:, None, None],
                          jnp.asarray(c)[:, None, None],
                          jnp.asarray(d)))
    for i in range(4):
        for j in range(6):
            np.testing.assert_allclose(x[:, i, j], _dense_solve(a, b, c, d[:, i, j]),
                                       rtol=1e-9)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_thomas_along_axis(axis):
    rng = np.random.default_rng(3)
    n = 13
    shape = [4, 5, 6]
    shape[axis] = n
    a = np.zeros(shape); b = np.zeros(shape); c = np.zeros(shape); d = np.zeros(shape)
    am, bm, cm, dm = (np.moveaxis(v, axis, 0) for v in (a, b, c, d))
    am[:], bm[:], cm[:], dm[:] = _random_tridiag(rng, n, batch=tuple(dm.shape[1:]))
    x = np.asarray(thomas_along_axis(*(jnp.asarray(v) for v in (a, b, c, d)), axis=axis))
    xm = np.moveaxis(x, axis, 0)
    ref = _dense_solve(am[:, 0, 0], bm[:, 0, 0], cm[:, 0, 0], dm[:, 0, 0])
    np.testing.assert_allclose(xm[:, 0, 0], ref, rtol=1e-9)


def test_cyclic_thomas_matches_dense_periodic():
    rng = np.random.default_rng(4)
    n, M = 12, 7
    a = rng.standard_normal((n, M))
    c = rng.standard_normal((n, M))
    b = rng.standard_normal((n, M)) + 5.0 + np.abs(a) + np.abs(c)
    d = rng.standard_normal((n, M))
    x = np.asarray(cyclic_thomas(*(jnp.asarray(v) for v in (a, b, c, d))))
    for m in range(M):
        A = (np.diag(b[:, m]) + np.diag(a[1:, m], -1) + np.diag(c[:-1, m], 1))
        A[0, n - 1] = a[0, m]
        A[n - 1, 0] = c[n - 1, m]
        ref = np.linalg.solve(A, d[:, m])
        np.testing.assert_allclose(x[:, m], ref, rtol=1e-8)


def test_spectral_phi_matches_cyclic_thomas():
    """The FFT phi solve and the Sherman–Morrison cyclic Thomas must agree:
    both invert (I - theta*dt*alpha*L_phi) on a periodic ring per radius."""
    grid = CylindricalGrid(nr=5, nphi=16, nz=3, dr=1e-3, dz=1e-3, r_inner=0.02)
    mat = Material(rho=7800.0, cp=490.0, k=54.0)
    theta, dt = 1.0, 0.05
    rng = np.random.default_rng(5)
    T = jnp.asarray(rng.standard_normal(grid.shape))

    X_fft = np.asarray(phi_solve_spectral(T, grid, mat, theta, dt))

    # Build the equivalent cyclic tridiagonal system per radius and solve.
    fac = theta * mat.alpha * dt / (np.asarray(grid.r) ** 2 * grid.dphi ** 2)
    X_ct = np.empty(grid.shape)
    for ir in range(grid.nr):
        f = fac[ir]
        n = grid.nphi
        a = np.full((n, grid.nz), -f)
        c = np.full((n, grid.nz), -f)
        b = np.full((n, grid.nz), 1.0 + 2.0 * f)
        d = np.asarray(T[ir]).reshape(n, grid.nz)
        x = np.asarray(cyclic_thomas(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c), jnp.asarray(d)))
        X_ct[ir] = x
    np.testing.assert_allclose(X_fft, X_ct, rtol=1e-9, atol=1e-12)


def test_spectral_phi_full_disk_axis_identity():
    """Full-disk grids keep the innermost radial row untouched (regularity at
    r=0, reference adi3d_cyl_phi_v3.py:314-317)."""
    grid = CylindricalGrid(nr=4, nphi=8, nz=2, dr=1e-3, dz=1e-3, r_inner=0.0)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(6)
    T = jnp.asarray(rng.standard_normal(grid.shape))
    X = np.asarray(phi_solve_spectral(T, grid, mat, 1.0, 0.1))
    np.testing.assert_allclose(X[0], np.asarray(T)[0], rtol=1e-12, atol=1e-12)
    assert not np.allclose(X[1], np.asarray(T)[1])


def test_cyclic_kernel_const_dense_oracle():
    """Constant-coefficient cyclic systems solved by Sherman-Morrison over
    the Triton kernel (interpret mode) vs dense periodic solves, including
    the fac=0 identity row (full-disk axis regularity) and both even and
    odd ring lengths."""
    rng = np.random.default_rng(9)
    for n in (3, 5, 16, 36):
        b1, b2 = 8, 8
        rhs = rng.standard_normal((n, b1, b2))
        fac = 0.1 + 12.0 * rng.random((b1, b2))
        fac[0, :] = 0.0  # identity rows
        f3 = np.broadcast_to(fac, (n, b1, b2))
        x = np.asarray(cyclic_thomas(
            jnp.asarray(-f3), jnp.asarray(1.0 + 2.0 * f3), jnp.asarray(-f3),
            jnp.asarray(rhs), implementation="pallas", interpret=True))
        for i in (0, 3, 7):
            for j in (0, 5):
                f = fac[i, j]
                A = ((1 + 2 * f) * np.eye(n) - f * np.eye(n, k=1)
                     - f * np.eye(n, k=-1))
                A[0, n - 1] -= f
                A[n - 1, 0] -= f
                ref = np.linalg.solve(A, rhs[:, i, j])
                np.testing.assert_allclose(x[:, i, j], ref, rtol=1e-9,
                                           atol=1e-11, err_msg=f"n={n}")


@pytest.mark.parametrize("nphi", [16, 40, 15])
def test_cyclic_kernel_layouts_agree(nphi):
    """The phi solve's layout (ring along axis 1, moved to the front) on
    the kernel equals the scan, for ring lengths with and without a power
    of two."""
    rng = np.random.default_rng(10)
    nr, nz = 6, 9
    fac = 0.1 + 5.0 * rng.random((nr, nz))
    X = jnp.asarray(rng.standard_normal((nr, nphi, nz)))
    f3 = jnp.asarray(np.broadcast_to(fac[None], (nphi, nr, nz)))
    args = (-f3, 1.0 + 2.0 * f3, -f3, jnp.moveaxis(X, 1, 0))
    a = cyclic_thomas(*args, implementation="pallas", interpret=True)
    b = cyclic_thomas(*args, implementation="xla")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cylindrical_step_kernel_matches_scan_f32():
    """Step level: the BE cylindrical step on the Triton kernel (r and z
    sweeps; spectral phi) gives the scan's result bit for bit in f32."""
    from adi_thermal_fields_tpu.step import cylindrical as cyl
    from adi_thermal_fields_tpu.step.cylindrical import RobinBC, ZFaceBC

    g = CylindricalGrid(12, 24, 16, 1e-3, 1e-3, r_inner=6e-3)
    mat = Material(7800.0, 490.0, 54.0)
    robin = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    rng = np.random.default_rng(3)
    T = jnp.asarray(rng.uniform(100, 900, g.shape).astype(np.float32))
    outs = {impl: np.asarray(cyl.adi_step(
        T, g, mat, dt=0.05, robin_outer=robin, zbc=zbc,
        implementation=impl, interpret=impl == "pallas"))
        for impl in ("xla", "pallas")}
    np.testing.assert_array_equal(outs["pallas"], outs["xla"])


@pytest.mark.parametrize("shape", [(16, 64, 128), (13, 25, 100),
                                   (8, 96, 256)])
def test_thomas_kernel_ragged_batches_match_scan(shape):
    """The kernel's masked last block: batch sizes that are and are not
    multiples of the block, odd solve lengths — exact agreement with the
    scan in f32 (same operation sequence)."""
    rng = np.random.default_rng(11)
    n = shape[0]
    a, b, c, d = (jnp.asarray(v.astype(np.float32)) for v in
                  _random_tridiag(rng, n, batch=shape[1:]))
    ref = thomas(a, b, c, d, implementation="xla")
    new = thomas(a, b, c, d, implementation="pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(new), np.asarray(ref),
                                  err_msg=f"{shape}")
