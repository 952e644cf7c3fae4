"""Discrete energy conservation (adiabatic invariants).

Every mask-aware operator in the framework has zero row AND column sums in
the absence of boundary sinks (reflective mask boundaries), so with no
Robin/Neumann/Dirichlet data both the explicit theta-pass and each implicit
sweep preserve the masked field sum EXACTLY (to rounding):
``sum(u) = sum(rhs) + theta*gam*sum(L u)`` and ``sum(L u) == 0``.
This pins the whole discretization — a sign error or an off-by-one in any
coupling mask breaks it immediately.
"""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import (CartesianGrid, CylindricalGrid, Material,
                                    adi_step_cartesian, build_coeff_packs)


def _mask_sum(T, mask):
    return float(jnp.sum(jnp.where(mask, T, 0.0)))


def test_cartesian_adiabatic_conserves_masked_sum():
    grid = CartesianGrid(14, 11, 9, 1e-3, dy=2e-3, dz=0.7e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(11)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T = jnp.asarray(np.where(np.asarray(mask),
                             300 + 900 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat)    # adiabatic
    e0 = _mask_sum(T, mask)
    for theta in (0.5, 1.0):
        Tn = T
        for _ in range(10):
            Tn = adi_step_cartesian(Tn, mask, packs, grid, mat, dt=0.2,
                                    theta=theta)
        np.testing.assert_allclose(_mask_sum(Tn, mask), e0, rtol=1e-12)


def test_pallas_adiabatic_conserves_masked_sum():
    """The Triton-kernel tier (interpret mode) conserves the masked sum."""
    grid = CartesianGrid(14, 11, 9, 1e-3, dy=2e-3, dz=0.7e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(12)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T = jnp.asarray(np.where(np.asarray(mask),
                             300 + 900 * rng.random(grid.shape),
                             20.0)).astype(jnp.float32)
    packs = build_coeff_packs(mask, grid, mat, dtype=jnp.float32)
    step = jax.jit(lambda T: adi_step_cartesian(
        T, mask, packs, grid, mat, dt=0.2, theta=0.5,
        implementation="pallas", interpret=True))
    e0 = _mask_sum(T, mask)
    Tn = T
    for _ in range(10):
        Tn = step(Tn)
    np.testing.assert_allclose(_mask_sum(Tn, mask), e0, rtol=2e-6)  # f32


def test_varprop_adiabatic_conserves_enthalpy():
    """Variable-k flux form: the harmonic face conductivities are symmetric
    per face, so the adiabatic enthalpy sum(cp(T) dT) is conserved; with
    constant cp that is again the field sum."""
    from adi_thermal_fields_tpu.step.cartesian_varprop import (PropertyTable,
                                                               adi_step_varprop)

    grid = CartesianGrid(12, 10, 8, 1e-3, dy=1.5e-3, dz=0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(13)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T = jnp.asarray(np.where(np.asarray(mask),
                             300 + 900 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat)
    kt = PropertyTable((0.0, 600.0, 1400.0), (20.0, 40.0, 80.0))
    e0 = _mask_sum(T, mask)
    Tn = T
    for _ in range(8):
        Tn = adi_step_varprop(Tn, mask, packs, grid, mat, k_table=kt, dt=0.2,
                              theta=1.0)
    np.testing.assert_allclose(_mask_sum(Tn, mask), e0, rtol=1e-11)


def test_cylindrical_adiabatic_conserves_volume_weighted_sum():
    """Cylindrical FV: with zero films and Neumann z ends, the
    volume-weighted sum (r_i T_i summed over all cells) is invariant."""
    from adi_thermal_fields_tpu import RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.step.cylindrical import adi_step

    grid = CylindricalGrid(10, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(14)
    T = jnp.asarray(300 + 900 * rng.random(grid.shape))
    w = jnp.asarray(grid.r)[:, None, None]
    rob0 = RobinBC(0.0, 20.0)
    zbc = ZFaceBC()    # neumann0 both ends
    e0 = float(jnp.sum(w * T))
    Tn = T
    for _ in range(8):
        Tn = adi_step(Tn, grid, mat, dt=0.05, robin_outer=rob0, zbc=zbc,
                      robin_inner=rob0)
    np.testing.assert_allclose(float(jnp.sum(w * Tn)), e0, rtol=1e-12)


def test_cyl_varprop_adiabatic_conserves_volume_weighted_sum():
    """Cylindrical VARPROP FV with element birth: variable harmonic face
    conductivities stay symmetric per face and the masked void faces carry
    zero flux, so with no films anywhere the volume-weighted sum over the
    ACTIVE cells (r_i T_i) is invariant — and void cells hold their value
    exactly (identity rows).  Pins the whole variable-coefficient
    discretization including the mask gating."""
    from adi_thermal_fields_tpu import RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop)

    grid = CylindricalGrid(10, 16, 12, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(15)
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    T = jnp.asarray(np.where(np.asarray(act),
                             300 + 900 * rng.random(grid.shape), 55.0))
    kt = lambda T: 30.0 + 0.02 * T
    w = jnp.asarray(grid.r)[:, None, None]
    e0 = float(jnp.sum(jnp.where(act, w * T, 0.0)))
    Tn = T
    for _ in range(6):
        Tn = adi_step_cyl_varprop(Tn, grid, mat, dt=0.1,
                                  robin_outer=RobinBC(0.0, 20.0),
                                  zbc=ZFaceBC(), k_table=kt, active=act,
                                  implementation="xla")
    np.testing.assert_allclose(
        float(jnp.sum(jnp.where(act, w * Tn, 0.0))), e0, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(Tn)[~np.asarray(act)], 55.0)
