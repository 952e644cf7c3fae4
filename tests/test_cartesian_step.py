"""Cartesian ADI step: physics sanity + exposed-face truth tables.

The strongest correctness anchor is tests/test_reference_parity.py (bitwise
comparison against the reference implementation on tiny grids); these tests
are self-contained invariants that keep holding after the reference is gone.
"""
import numpy as np

import jax.numpy as jnp

from adi_thermal_fields_tpu import (CartesianGrid, Material, build_coeff_packs,
                                    adi_step_cartesian, exposed_face)


def _setup(nx=6, ny=5, nz=4, dx=1e-3):
    grid = CartesianGrid(nx, ny, nz, dx)
    mat = Material(rho=7800.0, cp=490.0, k=54.0)
    return grid, mat


def test_exposed_face_truth_table():
    mask = np.zeros((3, 3, 3), bool)
    mask[1, 1, 1] = True  # isolated voxel: exposed on all six faces
    mask[0, 1, 1] = True  # neighbor on x-: that face no longer exposed
    m = jnp.asarray(mask)
    assert not bool(exposed_face(m, "x-")[1, 1, 1])
    for f in ("x+", "y-", "y+", "z-", "z+"):
        assert bool(exposed_face(m, f)[1, 1, 1])
    # the cell at the domain edge is exposed on its boundary face
    assert bool(exposed_face(m, "x-")[0, 1, 1])


def test_uniform_field_insulated_stays_uniform():
    """No BCs => adiabatic solid: a uniform field is a fixed point."""
    grid, mat = _setup()
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat)
    T0 = jnp.full(grid.shape, 300.0)
    T1 = adi_step_cartesian(T0, mask, packs, grid, mat, dt=0.1, theta=0.5)
    np.testing.assert_allclose(np.asarray(T1), 300.0, rtol=1e-12)


def test_insulated_energy_conservation():
    """Adiabatic solid conserves total energy to solver precision."""
    grid, mat = _setup()
    rng = np.random.default_rng(0)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    packs = build_coeff_packs(mask, grid, mat)
    T = jnp.asarray(np.where(np.asarray(mask), 100.0 + 500.0 * rng.random(grid.shape), 0.0))
    e0 = float(jnp.sum(jnp.where(mask, T, 0.0)))
    for _ in range(5):
        T = adi_step_cartesian(T, mask, packs, grid, mat, dt=0.05, theta=0.5)
    e1 = float(jnp.sum(jnp.where(mask, T, 0.0)))
    assert abs(e1 - e0) / abs(e0) < 1e-10


def test_void_cells_carry_initial_value():
    """Void cells are untouched by the step (reference keeps R0 = Tn there)."""
    grid, mat = _setup()
    mask_np = np.ones(grid.shape, bool)
    mask_np[0, :, :] = False
    mask = jnp.asarray(mask_np)
    packs = build_coeff_packs(mask, grid, mat, robin_h=50.0)
    T0 = jnp.full(grid.shape, 500.0).at[0].set(-123.0)
    T1 = adi_step_cartesian(T0, mask, packs, grid, mat, dt=0.1, theta=0.5, t_inf=20.0)
    np.testing.assert_allclose(np.asarray(T1)[0], -123.0)


def test_dirichlet_pins_values():
    grid, mat = _setup()
    mask = jnp.ones(grid.shape, bool)
    dir_mask = np.zeros(grid.shape, bool)
    dir_mask[:, :, 0] = True
    packs = build_coeff_packs(mask, grid, mat,
                              dirichlet_mask=jnp.asarray(dir_mask),
                              dirichlet_value=250.0)
    T = jnp.full(grid.shape, 900.0)
    for _ in range(3):
        T = adi_step_cartesian(T, mask, packs, grid, mat, dt=0.05, theta=0.5)
    np.testing.assert_allclose(np.asarray(T)[:, :, 0], 250.0, rtol=1e-12)
    # heat flows toward the cold face
    assert float(T[:, :, -1].mean()) < 900.0
    assert float(T[:, :, 1].mean()) < float(T[:, :, -1].mean())


def test_robin_cools_toward_ambient():
    grid, mat = _setup()
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat, robin_h=200.0)
    T = jnp.full(grid.shape, 900.0)
    t_inf = 20.0
    prev = 900.0
    for _ in range(20):
        T = adi_step_cartesian(T, mask, packs, grid, mat, dt=0.5, theta=0.5,
                               t_inf=t_inf)
        cur = float(T.mean())
        assert cur < prev  # monotone cooling
        prev = cur
    assert cur > t_inf  # never undershoots ambient


def test_neumann_heating_rate():
    """Uniform flux on z+ of a fully-masked slab heats the surface cells at
    q''/(rho cp dx) K/s in the first step (explicit source term)."""
    grid, mat = _setup()
    mask = jnp.ones(grid.shape, bool)
    q = 1e6  # W/m^2 into the solid
    packs = build_coeff_packs(mask, grid, mat, neumann={"z+": q})
    T0 = jnp.full(grid.shape, 20.0)
    dt = 1e-3
    T1 = adi_step_cartesian(T0, mask, packs, grid, mat, dt=dt, theta=0.5)
    # surface slab got dt*q/(rho cp dx), then diffusion spreads a bit;
    # total energy added must equal exactly dt * q * A_total / (rho cp V)
    dT_sum = float(jnp.sum(T1 - T0))
    expected = dt * q / (mat.rho * mat.cp * grid.dx) * grid.nx * grid.ny
    np.testing.assert_allclose(dT_sum, expected, rtol=1e-7)
    assert float(T1[:, :, -1].min()) > 20.0


def test_per_face_robin_dict_and_field():
    """robin_h accepts a scalar, a per-face dict, and a full 3-D field
    (reference adi3d_numba_coeff.py:80-88)."""
    grid, mat = _setup()
    mask = jnp.ones(grid.shape, bool)
    h = 120.0
    p_scalar = build_coeff_packs(mask, grid, mat, robin_h=h)
    p_dict = build_coeff_packs(mask, grid, mat,
                               robin_h={f: h for f in ("x-", "x+", "y-", "y+", "z-", "z+")})
    p_field = build_coeff_packs(mask, grid, mat, robin_h=jnp.full(grid.shape, h))
    for a, b in ((p_scalar.coeff, p_dict.coeff), (p_scalar.coeff, p_field.coeff)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    # only z faces
    p_z = build_coeff_packs(mask, grid, mat, robin_h={"z-": h, "z+": h})
    np.testing.assert_allclose(np.asarray(p_z.coeff[0]), 0.0)
    np.testing.assert_allclose(np.asarray(p_z.coeff[1]), 0.0)
    assert float(p_z.coeff[2].max()) > 0.0


def test_goldak_source_integrates_to_power_and_heats():
    """Goldak double-ellipsoid deposits exactly its absorbed power into the
    half-space below the torch, and the ADI step converts it to the right
    energy rise (new capability: the reference has no volumetric source)."""
    from adi_thermal_fields_tpu.birth.heat_source import (GoldakSource,
                                                          goldak_source)

    grid = CartesianGrid(48, 48, 24, 5e-4)
    mat = Material(7800.0, 490.0, 54.0)
    g = GoldakSource(power=2000.0, a_f=2e-3, a_r=4e-3, b=2e-3, c=2e-3)
    # torch at the top surface, mid-plate
    center = (grid.nx * grid.dx / 2, grid.ny * grid.dx / 2,
              grid.nz * grid.dx)
    S = goldak_source(grid, g, center, dtype=jnp.float64)
    total_power = float(S.sum()) * grid.cell_volume
    np.testing.assert_allclose(total_power, g.power, rtol=0.02)

    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat)
    dt = 0.05
    T0 = jnp.full(grid.shape, 20.0, jnp.float64)
    T1 = adi_step_cartesian(T0, mask, packs, grid, mat, dt=dt, theta=0.5,
                            source=S)
    # adiabatic solid: energy rise == dt * P
    dE = float((T1 - T0).sum()) * grid.cell_volume * mat.rho * mat.cp
    np.testing.assert_allclose(dE, dt * g.power, rtol=0.02)
    # hottest cell under the torch
    i, j, k = np.unravel_index(int(jnp.argmax(T1)), grid.shape)
    assert abs(i - grid.nx // 2) <= 1 and abs(j - grid.ny // 2) <= 1
    assert k >= grid.nz - 3


def test_float32_adequacy_vs_float64():
    """SURVEY.md §7 "hard parts": the reference runs float64; the GPU
    path runs float32.  Over a 50-step masked Robin cooling run the f32 trajectory must
    track f64 to well below the analytic-oracle tolerances (degrees-scale)."""
    grid, mat = _setup(nx=16, ny=14, nz=12)
    rng = np.random.default_rng(5)
    mask = jnp.asarray(rng.random(grid.shape) > 0.3)
    T64 = jnp.asarray(np.where(np.asarray(mask),
                               20 + 880 * rng.random(grid.shape), 20.0))
    T32 = T64.astype(jnp.float32)
    packs64 = build_coeff_packs(mask, grid, mat, robin_h=300.0,
                                neumann={"z+": 1e5})
    packs32 = build_coeff_packs(mask, grid, mat, robin_h=300.0,
                                neumann={"z+": 1e5}, dtype=jnp.float32)
    import jax

    step64 = jax.jit(lambda T: adi_step_cartesian(
        T, mask, packs64, grid, mat, dt=0.05, theta=0.5, t_inf=20.0))
    step32 = jax.jit(lambda T: adi_step_cartesian(
        T, mask, packs32, grid, mat, dt=jnp.float32(0.05), theta=0.5,
        t_inf=jnp.float32(20.0)))
    for _ in range(50):
        T64 = step64(T64)
        T32 = step32(T32)
    err = float(jnp.abs(T32.astype(jnp.float64) - T64).max())
    assert err < 0.05, err  # well under the 60 C oracle tolerances


def test_apply_surface_impulse_semantics():
    """Reference apply_surface_impulse_Q (adi3d_numba_coeff.py:304-320, dead
    code there): dT = Q/(rho*cp*dx) added only on EXPOSED cells of the
    outermost slab of the chosen face."""
    from adi_thermal_fields_tpu import apply_surface_impulse

    grid, mat = _setup(nx=6, ny=5, nz=4)
    mask_np = np.ones(grid.shape, bool)
    mask_np[0, 2, :] = False            # a notch on the x- face slab
    mask = jnp.asarray(mask_np)
    T0 = jnp.full(grid.shape, 100.0)
    Q = 5e5
    T1 = apply_surface_impulse(T0, mask, grid, mat, Q, face="x-")
    dT = Q / (mat.rho * mat.cp * grid.dx)
    diff = np.asarray(T1 - T0)
    # heated: the x=0 slab's in-mask cells (all exposed on x-)
    expect = np.zeros(grid.shape)
    expect[0][mask_np[0]] = dT
    np.testing.assert_allclose(diff, expect, rtol=1e-12, atol=1e-12)
    # the notch cell (void) and interior cells are untouched
    assert diff[0, 2, 0] == 0.0
    assert np.all(diff[1:] == 0.0)


def test_radiative_cooling_matches_lumped_ode():
    """Radiation BC (bc/radiation.py): a small hot block cooling purely by
    radiation follows the lumped-capacitance Stefan-Boltzmann ODE (Biot
    ~0.007 here).  Exercises the T-dependent film hook (robin_h_fn), whose
    Picard linearization is exact given the segment-entry field."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_advance
    from adi_thermal_fields_tpu.bc.radiation import (STEFAN_BOLTZMANN,
                                                     radiative_h)

    grid = CartesianGrid(4, 4, 4, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    eps, t_inf = 0.8, 20.0
    adv = make_cartesian_advance(
        grid, mat, t_inf=t_inf,
        robin_h_fn=lambda T: radiative_h(T, eps, t_inf))

    T = jnp.full(grid.shape, 1200.0)
    dt, n_sub, n_seg = 0.05, 5, 24
    for _ in range(n_seg):  # h refreshed per segment (event-loop granularity)
        T = adv(T, mask, dt, n_sub)
    T_num = float(jnp.mean(T))

    # lumped ODE oracle, RK4 at fine steps
    A = 6 * 16 * grid.dx**2          # 96 surface faces
    V = grid.ncells * grid.cell_volume
    coef = eps * STEFAN_BOLTZMANN * A / (mat.rho * mat.cp * V)

    def f(T):
        return -coef * ((T + 273.15) ** 4 - (t_inf + 273.15) ** 4)

    Tl, h = 1200.0, 1e-3
    for _ in range(int(round(dt * n_sub * n_seg / h))):
        k1 = f(Tl); k2 = f(Tl + 0.5 * h * k1)
        k3 = f(Tl + 0.5 * h * k2); k4 = f(Tl + h * k3)
        Tl += h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    assert Tl < 1100.0                      # cooled substantially
    np.testing.assert_allclose(T_num, Tl, rtol=0.01)


def test_engine_pallas_pad_to_tile_matches_xla():
    """The Triton-kernel engine on a hostile (no power-of-two) grid: every
    batch block is ragged and masked.  Run a birth schedule through
    EventLoop and require agreement with the XLA engine (interpret-mode
    kernel on CPU)."""
    from adi_thermal_fields_tpu.apps.engine import (EventLoop,
                                                    make_cartesian_engine)

    grid = CartesianGrid(11, 13, 9, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    base = np.zeros(grid.shape, bool)
    base[:, :, :3] = True                        # substrate plate
    act = np.full(grid.shape, np.inf)
    act[3:9, 4:10, 3] = 0.4                      # two birth events
    act[3:9, 4:10, 4] = 0.9
    act[~(base | np.isfinite(act))] = np.inf
    act = np.where(base, -np.inf, act)
    act_d = jnp.asarray(act, jnp.float32)
    T0 = jnp.full(grid.shape, 20.0, jnp.float32)

    results = {}
    for impl, kw in (("pallas", {"interpret": True}), ("xla", {})):
        prepare, advance = make_cartesian_engine(
            grid, mat, theta=0.5, t_inf=20.0, robin_h=150.0,
            implementation=impl, dtype=jnp.float32, **kw)
        frames = []
        loop = EventLoop(advance=advance, activation_times=act_d,
                         deposit_T=900.0, dt_cap=0.05, prepare=prepare)
        T, active, t = loop.run(
            T0, frame_times=[0.0, 0.6, 1.2], t_end=1.2,
            on_frame=lambda t, T_d, a: frames.append(np.asarray(T_d)))
        results[impl] = (np.asarray(T), [f.copy() for f in frames])

    Tp, fp = results["pallas"]
    Tx, fx = results["xla"]
    assert len(fp) == len(fx) == 3
    for a, b in zip(fp, fx):
        np.testing.assert_allclose(a, b, atol=1e-3)   # few-ulp at 900 C scale
    np.testing.assert_allclose(Tp, Tx, atol=1e-3)


def test_engine_thermal_history_tracking():
    """history_t_crit: the engine's fused (T_peak, t_above) state must (a)
    dominate every frame snapshot, (b) record the deposit temperature as the
    peak of cells that only cool after birth, (c) integrate time-above-T_crit
    to the segment lengths for always-hot cells, and (d) agree between the
    XLA and pallas-interpret engines."""
    from adi_thermal_fields_tpu.apps.engine import (EventLoop,
                                                    make_cartesian_engine)

    grid = CartesianGrid(10, 12, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    act = np.full(grid.shape, np.inf)
    act[:, :, :3] = -np.inf                      # substrate
    act[2:8, 3:9, 3] = 0.5                       # one birth event
    act_d = jnp.asarray(act, jnp.float32)
    T0 = jnp.full(grid.shape, 600.0, jnp.float32)
    t_crit, dep = 550.0, 1450.0

    out = {}
    for impl, kw in (("xla", {}), ("pallas", {"interpret": True})):
        prepare, advance = make_cartesian_engine(
            grid, mat, theta=0.5, t_inf=20.0, robin_h=400.0,
            implementation=impl, dtype=jnp.float32, history_t_crit=t_crit,
            **kw)
        frames = []
        loop = EventLoop(advance=advance, activation_times=act_d,
                         deposit_T=dep, dt_cap=0.02, prepare=prepare,
                         history=True)
        T, active, t = loop.run(
            T0, frame_times=[0.0, 0.4, 1.0], t_end=1.0,
            on_frame=lambda t, T_d, a: frames.append(np.asarray(T_d)))
        pk, ta = (np.asarray(a) for a in loop.history_state)
        out[impl] = (np.asarray(T), pk, ta, frames)

    T, pk, ta, frames = out["xla"]
    for f in frames:                              # (a) peak dominates frames
        assert (pk >= f - 1e-4).all()
    assert (pk >= T - 1e-4).all()
    # (b) newborn cells cool monotonically after deposit -> peak == deposit_T
    born = np.zeros(grid.shape, bool)
    born[2:8, 3:9, 3] = True
    np.testing.assert_allclose(pk[born], dep, rtol=1e-6)
    # the substrate bottom warms through conduction from the deposit, so
    # its peak is somewhere between the initial 600 and the deposit temp
    far = np.zeros(grid.shape, bool)
    far[:, :, 0] = True
    assert (pk[far] >= 600.0 - 1e-3).all() and (pk[far] < dep).all()
    # (c) cells that never drop below t_crit: t_above == elapsed time (the
    # deposit keeps its neighborhood hot; check a substrate center cell
    # directly below the deposit stays above 550 for the whole 1.0 s)
    probe = (5, 6, 2)
    if all(f[probe] > t_crit for f in frames) and T[probe] > t_crit:
        np.testing.assert_allclose(ta[probe], 1.0, rtol=0.05)
    # birth RESETS history: although the placeholder temperature (600) sits
    # above t_crit for the 0.5 s before birth, newborn cells must count
    # time-above only from their deposit
    assert ta[born].max() <= 0.5 * 1.01
    assert (ta[born] > 0.0).all()
    # (d) engines agree
    Tp, pkp, tap, _ = out["pallas"]
    np.testing.assert_allclose(pkp, pk, rtol=1e-5)   # few-ulp f32
    np.testing.assert_allclose(tap, ta, atol=1e-6)


def test_engine_interpass_temperature_control():
    """Interpass control: the loop dwells before each birth until the part
    cools to interpass_T; dwells are logged, bounded by interpass_max_dwell,
    and produce a colder part than the uncontrolled run."""
    from adi_thermal_fields_tpu.apps.engine import (EventLoop,
                                                    make_cartesian_engine)

    grid = CartesianGrid(8, 8, 6, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    act = np.full(grid.shape, np.inf)
    act[:, :, :2] = -np.inf
    act[:, :, 2] = 1.0
    act[:, :, 3] = 2.0
    act_d = jnp.asarray(act, jnp.float32)
    T0 = jnp.full(grid.shape, 20.0, jnp.float32)
    prepare, advance = make_cartesian_engine(
        grid, mat, theta=0.5, t_inf=20.0, robin_h=40.0,
        implementation="xla", dtype=jnp.float32)

    def final_T(**kw):
        loop = EventLoop(advance=advance, activation_times=act_d,
                         deposit_T=1500.0, dt_cap=0.05, prepare=prepare, **kw)
        T, active, t = loop.run(T0, frame_times=[0.0, 2.5], t_end=2.5)
        return float(jnp.max(jnp.where(jnp.broadcast_to(active, T.shape),
                                       T, -jnp.inf))), loop

    t_free, loop_free = final_T()
    assert loop_free.dwell_log is None

    t_ctl, loop_ctl = final_T(interpass_T=400.0, interpass_dwell=2.0,
                              interpass_max_dwell=400.0)
    # the FIRST deposit lands on a cold plate (no dwell); the second must
    # wait for the hot layer-1 to cool below 400 C, and the controlled
    # part ends colder
    assert loop_ctl.dwell_log == [(2.0, loop_ctl.dwell_log[0][1])]
    assert loop_ctl.dwell_log[0][1] > 0
    assert t_ctl < t_free

    # the max-dwell cap binds when the threshold is unreachable
    t_cap, loop_cap = final_T(interpass_T=25.0, interpass_dwell=2.0,
                              interpass_max_dwell=6.0)
    assert all(abs(d - 6.0) < 1e-9 for _, d in loop_cap.dwell_log)


def test_engine_multi_threshold_history():
    """history_t_crit as a tuple: per-threshold t_above with a leading axis;
    each component equals the corresponding single-threshold run exactly,
    and lower thresholds accumulate at least as much time."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(8, 8, 6, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    T0 = (700.0 + 200.0 * jnp.sin(jnp.arange(8))[:, None, None]
          * jnp.ones(grid.shape)).astype(jnp.float32)
    kw = dict(theta=0.5, t_inf=20.0, robin_h=300.0, dtype=jnp.float32,
              implementation="xla")

    prep_m, adv_m = make_cartesian_engine(grid, mat,
                                          history_t_crit=(800.0, 500.0), **kw)
    prep = prep_m(mask)
    hist0 = (T0, jnp.zeros((2,) + grid.shape, jnp.float32))
    Tm, (pkm, tam) = adv_m(T0, prep, jnp.float32(0.05), jnp.int32(8), 0.0,
                           hist0)
    assert tam.shape == (2,) + grid.shape
    assert float(jnp.min(tam[1] - tam[0])) >= 0.0   # 500-time >= 800-time
    assert float(jnp.max(tam[1] - tam[0])) > 0.0    # some cells crossed

    for i, tc in enumerate((800.0, 500.0)):
        prep_s, adv_s = make_cartesian_engine(grid, mat, history_t_crit=tc,
                                              **kw)
        Ts, (pks, tas) = adv_s(T0, prep_s(mask), jnp.float32(0.05),
                               jnp.int32(8), 0.0,
                               (T0, jnp.zeros(grid.shape, jnp.float32)))
        np.testing.assert_array_equal(np.asarray(tam[i]), np.asarray(tas))
        np.testing.assert_array_equal(np.asarray(pkm), np.asarray(pks))
    np.testing.assert_array_equal(np.asarray(Tm), np.asarray(Ts))


def test_engine_stochastic_rounding_guard():
    """Stochastic rounding targets bfloat16 states; another sub-f32 state
    dtype must refuse with a clear error, and the interpret-mode kernel
    engine honours it for bfloat16."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(8, 8, 6, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    try:
        make_cartesian_engine(grid, mat, robin_h=30.0, dtype=jnp.float16,
                              implementation="pallas", interpret=True,
                              stochastic_rounding=True)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "stochastic" in str(e)
    prep, adv = make_cartesian_engine(
        grid, mat, robin_h=30.0, dtype=jnp.bfloat16,
        implementation="pallas", interpret=True, stochastic_rounding=True)
    out = adv(jnp.full(grid.shape, 900.0, jnp.bfloat16),
              prep(jnp.ones(grid.shape, bool)), jnp.bfloat16(0.05),
              jnp.int32(2), 0.0)
    assert out.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(out.astype(jnp.float32)).all())
