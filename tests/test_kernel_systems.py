"""Tridiagonal systems the steps hand to the Triton Thomas kernel: identity
(void / pinned) rows, cyclic couplings, layouts, block sizes and broadcast
coefficient columns.  The kernel runs in Pallas interpret mode on CPU and
is compared with the ``lax.scan`` solve."""
import numpy as np
import pytest

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import thomas_triton
from adi_thermal_fields_tpu.solvers.thomas import (cyclic_thomas, thomas,
                                                   thomas_along_axis)

KERNEL = dict(implementation="pallas", interpret=True)
SCAN = dict(implementation="xla")


def _system(rng, shape, identity_frac=0.0):
    a = rng.normal(0, 0.3, shape)
    c = rng.normal(0, 0.3, shape)
    b = 2.5 + rng.random(shape)
    d = rng.normal(0, 100, shape)
    ident = rng.random(shape) < identity_frac
    a[ident] = 0.0
    c[ident] = 0.0
    b[ident] = 1.0
    return tuple(jnp.asarray(v) for v in (a, b, c, d)), ident


def test_open_sweep_matches_thomas_with_voids_and_pins():
    """Void and Dirichlet rows are identity rows: the kernel returns their
    rhs there (a void carries its value, a pin holds its value) and agrees
    with the scan everywhere."""
    rng = np.random.default_rng(0)
    (a, b, c, d), ident = _system(rng, (40, 9, 33), identity_frac=0.3)
    got = thomas(a, b, c, d, **KERNEL)
    np.testing.assert_array_equal(np.asarray(got)[ident],
                                  np.asarray(d)[ident])
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(thomas(a, b, c, d, **SCAN)),
                               rtol=1e-12, atol=1e-12)


def test_cyclic_axis1_matches_cyclic_thomas():
    """Mask-broken periodic systems along axis 1 (the phi sweep's natural
    layout), moved to the front: kernel vs scan."""
    rng = np.random.default_rng(1)
    (a, b, c, d), _ = _system(rng, (5, 24, 7), identity_frac=0.2)
    mv = lambda t: jnp.moveaxis(t, 1, 0)
    got = cyclic_thomas(mv(a), mv(b), mv(c), mv(d), **KERNEL)
    want = cyclic_thomas(mv(a), mv(b), mv(c), mv(d), **SCAN)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_block_size_does_not_change_result(monkeypatch):
    """The pencils-per-program block only partitions the batch: a block of
    16 (many masked tails) gives bit-identical results to the default."""
    rng = np.random.default_rng(2)
    (a, b, c, d), _ = _system(rng, (30, 7, 45))
    want = thomas(a, b, c, d, **KERNEL)
    monkeypatch.setattr(thomas_triton, "BLOCK", 16)
    got = thomas(a, b, c, d, **KERNEL)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_cyclic_explicit_wrap_couplings_match_natural():
    """Explicit wrap couplings (alpha, beta) equal to the natural periodic
    couplings c[n-1], a[0] give the same cyclic solve on the kernel."""
    rng = np.random.default_rng(3)
    (a, b, c, d), _ = _system(rng, (24, 6, 10))
    natural = cyclic_thomas(a, b, c, d, **KERNEL)
    explicit = cyclic_thomas(a.at[0].set(0.0), b, c.at[-1].set(0.0), d,
                             alpha=c[-1], beta=a[0], **KERNEL)
    np.testing.assert_allclose(np.asarray(explicit), np.asarray(natural),
                               rtol=1e-12, atol=1e-12)


def test_z_axis_solve_matches_transposed_axis0():
    """A solve along the contiguous z axis (moved to the front by
    thomas_along_axis) equals the axis-0 solve of the transposed arrays,
    bit for bit."""
    rng = np.random.default_rng(4)
    (a, b, c, d), _ = _system(rng, (36, 8, 20), identity_frac=0.1)
    t2 = lambda x: jnp.transpose(x, (1, 2, 0))
    got = thomas_along_axis(t2(a), t2(b), t2(c), t2(d), axis=2, **KERNEL)
    want = t2(thomas(a, b, c, d, **KERNEL))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_column_coefficients_match_materialized():
    """Coefficient columns constant over the batch (the cylindrical r/z
    sweeps' 1-D vectors) are read as columns in the kernel; the result is
    bit-identical to materialized full coefficient arrays."""
    rng = np.random.default_rng(5)
    n = 28
    a = jnp.asarray(-rng.random(n))
    c = jnp.asarray(-rng.random(n))
    b = jnp.asarray(3.0 + rng.random(n))
    d = jnp.asarray(rng.normal(0, 100, (n, 6, 11)))
    col = lambda v: v[:, None, None]
    full = lambda v: jnp.broadcast_to(col(v), d.shape)
    got = thomas(col(a), col(b), col(c), d, **KERNEL)
    want = thomas(full(a), full(b), full(c), d, **KERNEL)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(thomas(col(a), col(b), col(c), d,
                                           **SCAN)), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 5), (2, 3), (7, 1)])
def test_degenerate_systems_match_scan(shape):
    """Degenerate systems: one row (b x = d), two rows, a single pencil."""
    rng = np.random.default_rng(6)
    (a, b, c, d), _ = _system(rng, shape)
    np.testing.assert_allclose(np.asarray(thomas(a, b, c, d, **KERNEL)),
                               np.asarray(thomas(a, b, c, d, **SCAN)),
                               rtol=1e-12, atol=1e-12)
