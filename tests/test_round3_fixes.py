"""Round-3 correctness fixes: sub-step clock precision, stochastic-rounding
on every engine branch, interpass/source exclusion, checkpoint history
validation, and the plain-JAX stochastic bf16 rounding."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid, Material
from adi_thermal_fields_tpu.apps.engine import (EventLoop,
                                                make_cartesian_engine)


def _grid_mat():
    return CartesianGrid(8, 8, 6, 1e-3), Material(7800.0, 490.0, 54.0)


def _sr_advance_twice(**kw):
    """Two advances of one sub-step from the same bf16 state at different
    step counters; returns both results as f32 arrays."""
    grid, mat = _grid_mat()
    prepare, advance = make_cartesian_engine(
        grid, mat, robin_h=30.0, dtype=jnp.bfloat16,
        stochastic_rounding=True, **kw)
    T = jnp.full(grid.shape, 900.0, jnp.bfloat16)
    prep = prepare(jnp.ones(grid.shape, bool))
    dt = jnp.bfloat16(0.002)
    a = advance(T, prep, dt, jnp.int32(1), 0.0)
    b = advance(T, prep, dt, jnp.int32(1), 1000.0 * 0.002)
    assert a.dtype == jnp.bfloat16
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def test_engine_xla_rejects_stochastic():
    """The xla branch honours stochastic rounding (plain-JAX rounding of
    the f32 solve): a silently-ignored flag would reintroduce the bf16
    cooling-freeze hazard, so the two step counters must round
    differently; a non-bf16 sub-f32 state is refused."""
    a, b = _sr_advance_twice(implementation="xla")
    assert np.any(a != b)
    grid, mat = _grid_mat()
    with pytest.raises(ValueError, match="stochastic"):
        make_cartesian_engine(grid, mat, robin_h=30.0, dtype=jnp.float16,
                              implementation="xla", stochastic_rounding=True)


def test_engine_mesh_xla_rejects_stochastic():
    """The mesh branch honours stochastic rounding too."""
    from adi_thermal_fields_tpu.dist.cartesian import make_mesh

    a, b = _sr_advance_twice(implementation="xla", mesh=make_mesh())
    assert np.any(a != b)


def test_source_time_at_solve_precision():
    """The sub-step clock must NOT run in the state dtype: at bf16 the time
    (8-bit mantissa) quantizes to plateaus past step ~256, feeding source_fn
    coarse times and collapsing any t/dt-derived seed."""
    grid, mat = _grid_mat()
    seen = {}

    def src(t):
        seen["dtype"] = t.dtype
        return jnp.zeros(grid.shape, jnp.bfloat16)

    prepare, advance = make_cartesian_engine(
        grid, mat, robin_h=30.0, dtype=jnp.bfloat16,
        implementation="xla", source_fn=src)
    T = jnp.full(grid.shape, 900.0, jnp.bfloat16)
    mask = jnp.ones(grid.shape, bool)
    out = advance(T, prepare(mask), jnp.bfloat16(0.05), jnp.int32(2),
                  jnp.bfloat16(100.0))
    jax.block_until_ready(out)
    assert seen["dtype"] == jnp.float32
    assert out.dtype == jnp.bfloat16


def test_interpass_rejects_continuous_source():
    """Interpass dwell with a continuous source_fn silently keeps the torch
    burning at the frozen schedule time — must refuse, not footgun."""
    grid, mat = _grid_mat()
    prepare, advance = make_cartesian_engine(
        grid, mat, robin_h=30.0, implementation="xla",
        source_fn=lambda t: jnp.zeros(grid.shape))
    act = jnp.zeros(grid.shape)
    loop = EventLoop(advance=advance, activation_times=act, deposit_T=1500.0,
                     dt_cap=0.1, prepare=prepare, interpass_T=300.0)
    with pytest.raises(ValueError, match="interpass"):
        loop.run(jnp.full(grid.shape, 20.0), frame_times=[0.0, 1.0])


def test_engine_advance_exposes_config():
    grid, mat = _grid_mat()
    _, adv = make_cartesian_engine(grid, mat, robin_h=30.0,
                                   implementation="xla")
    assert adv.has_source is False and adv.history_thresholds is None
    _, adv2 = make_cartesian_engine(grid, mat, robin_h=30.0,
                                    implementation="xla",
                                    history_t_crit=(800.0, 500.0))
    assert adv2.history_thresholds == (800.0, 500.0)


def test_xla_stochastic_round_bf16():
    """The engine's bit-trick rounding (engine.stochastic_round): exact
    bf16 values unchanged; in-between values rounded UNBIASEDLY."""
    from adi_thermal_fields_tpu.apps.engine import stochastic_round

    def _stoch_round_bf16(x, seed):
        return stochastic_round(x, jnp.bfloat16,
                                jax.random.fold_in(jax.random.key(0), seed))

    exact = jnp.asarray(np.float32([1.0, -2.5, 0.0, 384.0, 2.0 ** -20]))
    out = _stoch_round_bf16(jnp.broadcast_to(exact, (100, 5)), jnp.int32(3))
    np.testing.assert_array_equal(
        np.float32(out),
        np.broadcast_to(np.float32(exact.astype(jnp.bfloat16)), (100, 5)))

    # x = 1 + 0.25 ulp_bf16: E[round(x)] = x  =>  P(up) = 0.25
    lo = np.float32(1.0)
    hi = np.float32(np.nextafter(np.float32(jnp.bfloat16(1.0)), 2.0,
                                 dtype=np.float32))
    ulp = np.float32(0.0078125)  # bf16 ulp at 1.0
    x = jnp.full((200, 512), 1.0 + 0.25 * ulp, jnp.float32)
    r = _stoch_round_bf16(x, jnp.int32(7)).astype(jnp.float32)
    frac_up = float(jnp.mean((r > 1.0).astype(jnp.float32)))
    assert abs(frac_up - 0.25) < 0.01, frac_up
    # and only the two neighboring bf16 values ever appear
    vals = np.unique(np.float32(r))
    assert set(vals) <= {lo, np.float32(1.0 + ulp)}, vals


def _write_box_stl(tmp_path):
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


def test_history_resume_threshold_mismatch(tmp_path):
    """Resuming with a different --history_t_crit list must fail with a
    clear error, not a shape crash deep inside the jitted advance."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run

    stl = _write_box_stl(tmp_path)
    ck = str(tmp_path / "ck.npz")
    outdir = str(tmp_path / "out")
    base = ["--stl", stl, "--dx_mm", "1", "--nframes", "2", "--outdir",
            outdir, "--precision", "float64", "--bead_height_mm", "2",
            "--checkpoint", ck]
    run(build_argparser().parse_args(base + ["--history_t_crit", "800,500"]))
    with pytest.raises(SystemExit, match="history"):
        run(build_argparser().parse_args(
            base + ["--history_t_crit", "800", "--resume", ck]))


def test_history_resume_keeps_f64(tmp_path):
    """t_above must restore at solve precision: a float64 run resumed from a
    checkpoint previously downgraded silently to float32."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.io.checkpoint import load_checkpoint

    stl = _write_box_stl(tmp_path)
    ck = str(tmp_path / "ck.npz")
    outdir = str(tmp_path / "out")
    base = ["--stl", stl, "--dx_mm", "1", "--nframes", "3", "--outdir",
            outdir, "--precision", "float64", "--bead_height_mm", "2",
            "--history_t_crit", "800,500"]
    run(build_argparser().parse_args(base + ["--checkpoint", ck]))
    st = load_checkpoint(ck)
    assert st.meta["history_above"].dtype == np.float64
    out = run(build_argparser().parse_args(base + ["--resume", ck]))
    assert out["T"].dtype == jnp.float64


def test_waam_corrected_bc_with_dz(tmp_path):
    """--corrected_bc must compose with --dz_mm (anisotropic voxels) now
    that the corrector normalizes per-face areas."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run

    stl = _write_box_stl(tmp_path)
    out = run(build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--dz_mm", "0.5", "--corrected_bc",
        "1", "--nframes", "2", "--outdir", str(tmp_path / "out"),
        "--precision", "float64", "--bead_height_mm", "2"]))
    assert out["t"] > 0 and np.isfinite(float(out["T"].max()))


def test_waam_varprop_radiation_flags(tmp_path):
    """Flagship CLI runs latent heat + melt-pool k + radiation + history
    end-to-end (the gap between 'feature exists' and
    'flagship can use it')."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run

    stl = _write_box_stl(tmp_path)
    out = run(build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2",
        "--outdir", str(tmp_path / "out"), "--precision", "float64",
        "--bead_height_mm", "2", "--latent_J_kg", "2.7e5",
        "--solidus_C", "1420", "--liquidus_C", "1470",
        "--melt_k_factor", "4", "--emissivity", "0.5",
        "--history_t_crit", "800,500"]))
    Tmax = float(np.asarray(out["T"])[np.asarray(out["active"])].max())
    assert np.isfinite(Tmax) and 20.0 <= Tmax <= 1500.0
