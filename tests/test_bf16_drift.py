"""bf16 production-accuracy gates.

Stochastic rounding is plain JAX (``apps.engine.stochastic_round``, random
bits from ``jax.random``), so these run on every backend.

Pins the two bf16 hazards of a bf16 WAAM state:

1. ROUND-TO-NEAREST FREEZE: per-sub-step cooling updates smaller than the
   bf16 quantum (~4-8 K at 900-1500 C) round to zero, so a bf16 WAAM soak
   never cooled at all (Tmax frozen for 2100 s).  The test asserts the
   freeze IS detected (RTN cools far less than f32) so the hazard cannot
   silently vanish from the kernels' behavior unnoticed.
2. STOCHASTIC-ROUNDING DRIFT ENVELOPE: with per-step seeded stochastic
   stores the same run tracks f32 within the envelope (~14 C max over 30
   steps on a 900 C Robin-cooling field; asserted with margin).
"""
import numpy as np

import jax.numpy as jnp


def _cooling_run(dtype, stochastic, n_steps=30):
    from adi_thermal_fields_tpu import CartesianGrid, Material
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(64, 56, 48, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    # dt such that interior per-step updates sit well below the bf16
    # quantum at 900 C (~4 K): the regime where RTN freezes
    dt = 0.002
    prepare, advance = make_cartesian_engine(
        grid, mat, theta=0.5, t_inf=20.0, robin_h=200.0, dtype=dtype,
        stochastic_rounding=stochastic)
    mask = jnp.ones(grid.shape, bool)
    T = jnp.full(grid.shape, 900.0, dtype)
    out = advance(T, prepare(mask), jnp.asarray(dt, dtype),
                  jnp.int32(n_steps), 0.0)
    return np.asarray(out, np.float64)


def test_bf16_stochastic_drift_within_envelope():
    ref = _cooling_run(jnp.float32, False)
    sr = _cooling_run(jnp.bfloat16, True)
    drift = np.abs(sr - ref)
    # envelope: max ~14 C, mean ~1 C over 30 steps; asserted with ~50%
    # margin
    assert drift.max() < 21.0, drift.max()
    assert drift.mean() < 2.5, drift.mean()


def test_bf16_round_to_nearest_freeze_detected():
    """RTN must measurably freeze in this regime — if this assertion ever
    fails the sub-quantum-dropout hazard model itself changed and the
    stochastic-rounding default needs re-deriving."""
    ref = _cooling_run(jnp.float32, False)
    rtn = _cooling_run(jnp.bfloat16, False)
    cooled_ref = 900.0 - ref.mean()
    cooled_rtn = 900.0 - rtn.mean()
    # the f32 run does cool: lumped h*A/(rho cp V)*(T - T_inf) ~ 5 K/s over
    # 30 x 2 ms gives ~0.3 K of mean cooling
    assert cooled_ref > 0.2
    # RTN recovers less than half of the true cooling (measured: ~0)
    assert cooled_rtn < 0.5 * cooled_ref, (cooled_rtn, cooled_ref)


def test_bf16_stochastic_seed_decorrelates_substeps():
    """Distinct sub-steps must use distinct rounding seeds: two consecutive
    advances from identical states but different t0 (hence different step
    counters) produce different rounding realizations."""
    from adi_thermal_fields_tpu import CartesianGrid, Material
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(32, 32, 32, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    prepare, advance = make_cartesian_engine(
        grid, mat, robin_h=200.0, dtype=jnp.bfloat16,
        stochastic_rounding=True)
    mask = jnp.ones(grid.shape, bool)
    T = jnp.full(grid.shape, 900.0, jnp.bfloat16)
    prep = prepare(mask)
    dt = jnp.float32(0.002)
    a = advance(T, prep, dt, jnp.int32(1), 0.0)
    b = advance(T, prep, dt, jnp.int32(1), 1000.0 * 0.002)
    same = advance(T, prep, dt, jnp.int32(1), 0.0)
    np.testing.assert_array_equal(np.asarray(same, np.float32),
                                  np.asarray(a, np.float32))  # deterministic
    assert np.any(np.asarray(a, np.float32) != np.asarray(b, np.float32))
