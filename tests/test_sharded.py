"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""
import numpy as np

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid, Material, build_coeff_packs
from adi_thermal_fields_tpu.dist.cartesian import (make_mesh, shard_field,
                                                   sharded_adi_step)
from adi_thermal_fields_tpu.step.cartesian import adi_step


def test_sharded_step_matches_single_device():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    grid = CartesianGrid(16, 16, 16, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(0)
    mask = jnp.asarray(rng.random(grid.shape) > 0.2)
    T0 = jnp.asarray(np.where(np.asarray(mask), 20.0 + 880.0 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat, robin_h=300.0,
                              neumann={"z+": 1e5})
    dt, t_inf = 0.02, 20.0

    ref = T0
    for _ in range(3):
        ref = adi_step(ref, mask, packs, grid, mat, dt=dt, theta=0.5, t_inf=t_inf)

    mesh = make_mesh()
    assert mesh.devices.size == 8
    step = sharded_adi_step(grid, mat, mesh, theta=0.5)
    T = shard_field(T0, mesh, 0)
    m = shard_field(mask, mesh, 0)
    for _ in range(3):
        T = step(T, m, packs, dt, t_inf)

    np.testing.assert_allclose(np.asarray(T), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_sharded_layout_is_distributed():
    """The compiled step actually shards: per-device output shards differ."""
    grid = CartesianGrid(8, 8, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mesh = make_mesh()
    mask = jnp.ones(grid.shape, bool)
    packs = build_coeff_packs(mask, grid, mat, robin_h=100.0)
    step = sharded_adi_step(grid, mat, mesh)
    T = shard_field(jnp.linspace(0, 900, grid.ncells).reshape(grid.shape), mesh, 0)
    out = step(T, shard_field(mask, mesh, 0), packs, 0.01, 20.0)
    assert len(out.sharding.device_set) == 8


def test_sharded_cylindrical_matches_single_device():
    from adi_thermal_fields_tpu import CylindricalGrid, RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.dist.cylindrical import sharded_cylindrical_step
    from adi_thermal_fields_tpu.step.cylindrical import adi_step

    grid = CylindricalGrid(6, 16, 16, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="dirichlet", kind_top="robin", h_top=500.0,
                  T_inf_top=25.0, T_bot=100.0)
    rng = np.random.default_rng(0)
    T0 = jnp.asarray(20.0 + 880.0 * rng.random(grid.shape))
    dt = 0.05

    ref = adi_step(T0, grid, mat, dt=dt, robin_outer=rob, zbc=zbc,
                   robin_inner=rob, scheme="be")

    mesh = make_mesh()
    step = sharded_cylindrical_step(grid, mat, mesh, robin_outer=rob,
                                    zbc=zbc, robin_inner=rob)
    T = jax.device_put(T0, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "a", "b")))
    out = step(T, dt)
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_sharded_engine_with_moving_source_matches_single_device():
    """Mesh-aware engine with a traced volumetric source (moving Goldak
    torch) matches the single-device advance."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.birth.heat_source import (GoldakSource,
                                                          goldak_source)

    grid = CartesianGrid(16, 16, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    g = GoldakSource(power=1500.0, a_f=2e-3, a_r=4e-3, b=2e-3, c=2e-3,
                     travel_axis=0)

    def src(t):
        return goldak_source(grid, g, (4e-3 + 8e-3 * t, 8e-3, 7.5e-3),
                             dtype=jnp.result_type(float))

    T0 = jnp.full(grid.shape, 20.0)
    kw = dict(theta=0.5, t_inf=20.0, robin_h=100.0, source_fn=src)
    prep1, adv1 = make_cartesian_engine(grid, mat, **kw)
    ref = adv1(T0, prep1(mask), 0.05, 4, 0.0)

    mesh = make_mesh()
    prep2, adv2 = make_cartesian_engine(grid, mat, mesh=mesh, **kw)
    T = shard_field(T0, mesh, 0)
    out = adv2(T, prep2(shard_field(mask, mesh, 0)), 0.05, 4, 0.0)
    assert len(out.sharding.device_set) == 8
    assert float(out.max()) > 25.0   # the torch heated the plate
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_orbax_checkpoint_preserves_sharding(tmp_path):
    """Sharded run state round-trips through the orbax checkpoint with its
    mesh sharding restored (multi-host resume path; the reference has no
    restart capability at all)."""
    import pytest

    ocp = pytest.importorskip("orbax.checkpoint")  # noqa: F841
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adi_thermal_fields_tpu.io.checkpoint import (RunState,
                                                      load_checkpoint_orbax,
                                                      save_checkpoint_orbax)

    mesh = make_mesh()
    sh = NamedSharding(mesh, P(None, "a", "b"))
    rng = np.random.default_rng(2)
    T = jax.device_put(jnp.asarray(rng.random((8, 8, 8))), sh)
    active = jax.device_put(jnp.asarray(rng.random((8, 8, 8)) > 0.5), sh)
    path = str(tmp_path / "ck_orbax")
    save_checkpoint_orbax(path, RunState(T=T, active=active, t=3.5))

    template = {"T": jax.ShapeDtypeStruct(T.shape, T.dtype, sharding=sh),
                "active": jax.ShapeDtypeStruct(active.shape, active.dtype,
                                               sharding=sh),
                "t": np.zeros((), np.float64)}
    st = load_checkpoint_orbax(path, template)
    assert st.t == 3.5
    assert len(st.T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(st.T), np.asarray(T))
    np.testing.assert_array_equal(np.asarray(st.active), np.asarray(active))


def test_substructured_thomas_matches_sequential():
    """Distributed tridiagonal by substructuring (interface reduction) vs
    the sequential scan Thomas, solve axis split 8 ways — including the
    minimal 2-rows-per-chip case."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from adi_thermal_fields_tpu.dist.substructured import substructured_thomas
    from adi_thermal_fields_tpu.solvers.thomas import thomas

    mesh = Mesh(np.asarray(jax.devices()), ("z",))
    rng = np.random.default_rng(9)
    for n, batch in [(16, (5, 7)), (64, (4,)), (40, ())]:
        shape = (n,) + batch
        # diagonally dominant random systems
        a = jnp.asarray(rng.normal(0, 0.3, shape))
        c = jnp.asarray(rng.normal(0, 0.3, shape))
        b = jnp.asarray(2.0 + rng.random(shape))
        d = jnp.asarray(rng.normal(0, 100.0, shape))
        ref = thomas(a, b, c, d)
        sh = NamedSharding(mesh, P("z"))
        got = substructured_thomas(*(jax.device_put(v, sh) for v in (a, b, c, d)),
                                   mesh, "z")
        assert len(got.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-9, atol=1e-9)


def test_sharded_longz_step_matches_single_device():
    """Long-axis decomposition: z itself split across the 8 chips; x/y
    sweeps chip-local, z sweep substructured.  Matches the single-device
    step on the masked WAAM configuration."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from adi_thermal_fields_tpu.dist.cartesian import sharded_adi_step_longz

    grid = CartesianGrid(12, 10, 32, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(4)
    mask = jnp.asarray(rng.random(grid.shape) > 0.25)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20.0 + 880.0 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat, robin_h=300.0,
                              neumann={"z+": 1e5})
    dt, t_inf = 0.02, 20.0

    ref = T0
    for _ in range(3):
        ref = adi_step(ref, mask, packs, grid, mat, dt=dt, theta=0.5,
                       t_inf=t_inf)

    mesh = Mesh(np.asarray(jax.devices()), ("z",))
    step = sharded_adi_step_longz(grid, mat, mesh, theta=0.5)
    sh = NamedSharding(mesh, P(None, None, "z"))
    T = jax.device_put(T0, sh)
    m = jax.device_put(mask, sh)
    for _ in range(3):
        T = step(T, m, packs, dt, t_inf)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref), rtol=1e-10,
                               atol=1e-9)


def test_sharded_masked_cylindrical_matches_single_device():
    """Element birth across chips: the masked-Robin step (mask-broken cyclic
    phi solve with phi chip-local) on the spiral test geometry, bitwise vs
    single device."""
    from adi_thermal_fields_tpu import CylindricalGrid, RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.dist.cylindrical import (
        sharded_cylindrical_masked_step)
    from adi_thermal_fields_tpu.step.cylindrical_masked import (
        adi_step_masked_robin)

    # annular wall, two part-deposited layers — the spiral test's geometry
    grid = CylindricalGrid(6, 32, 16, 4e-4, 1e-3, r_inner=0.03)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="robin", h_bot=200.0, T_inf_bot=20.0,
                  kind_top="neumann0")
    active_np = np.zeros(grid.shape, bool)
    active_np[:, :, :8] = True               # substrate rings
    active_np[:, :20, 8:10] = True           # partial spiral layer
    active = jnp.asarray(active_np)
    rng = np.random.default_rng(5)
    T0 = jnp.asarray(np.where(active_np, 20.0 + 1480.0 * rng.random(grid.shape),
                              20.0))
    dt = 0.05

    ref = T0
    for _ in range(2):
        ref = adi_step_masked_robin(ref, grid, mat, dt=dt, active=active,
                                    robin_outer=rob, zbc=zbc, robin_inner=rob,
                                    h_void=80.0, T_inf_void=20.0)

    mesh = make_mesh()
    step = sharded_cylindrical_masked_step(grid, mat, mesh, robin_outer=rob,
                                           zbc=zbc, robin_inner=rob,
                                           h_void=80.0, T_inf_void=20.0)
    spec = jax.sharding.NamedSharding(mesh,
                                      jax.sharding.PartitionSpec(None, "a", "b"))
    T = jax.device_put(T0, spec)
    act = jax.device_put(active, spec)
    for _ in range(2):
        T = step(T, act, dt)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_sharded_masked_clamp_cylindrical_matches_single_device():
    """The reference's clamp-parity element-birth scheme, sharded."""
    from adi_thermal_fields_tpu import CylindricalGrid, RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.dist.cylindrical import (
        sharded_cylindrical_masked_clamp_step)
    from adi_thermal_fields_tpu.step.cylindrical import adi_step_masked

    grid = CylindricalGrid(6, 16, 16, 4e-4, 1e-3, r_inner=0.03)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    active_np = np.zeros(grid.shape, bool)
    active_np[:, :, :8] = True
    active_np[:, :10, 8:10] = True
    active = jnp.asarray(active_np)
    rng = np.random.default_rng(6)
    T0 = jnp.asarray(np.where(active_np, 1500.0 * rng.random(grid.shape), 20.0))
    dt = 0.05

    ref = adi_step_masked(T0, grid, mat, dt=dt, robin_outer=rob, zbc=zbc,
                          robin_inner=rob, active=active)

    mesh = make_mesh()
    step = sharded_cylindrical_masked_clamp_step(grid, mat, mesh,
                                                 robin_outer=rob, zbc=zbc,
                                                 robin_inner=rob)
    spec = jax.sharding.NamedSharding(mesh,
                                      jax.sharding.PartitionSpec(None, "a", "b"))
    out = step(jax.device_put(T0, spec), jax.device_put(active, spec), dt)
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_sharded_pallas_step_matches_xla(monkeypatch):
    """The sharded step (scan solves on the virtual mesh) matches the
    single-device step on the Triton-kernel tier (interpret mode); an
    engine asked for the kernel on a mesh refuses (no sharded kernel
    tier)."""
    import pytest

    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(16, 16, 16, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(3)
    mask = jnp.asarray(rng.random(grid.shape) > 0.25)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              20 + 880 * rng.random(grid.shape), 20.0))
    packs = build_coeff_packs(mask, grid, mat, robin_h=250.0)
    dt, theta, t_inf = 0.02, 0.5, 20.0

    ref = T0
    for _ in range(2):
        ref = adi_step(ref, mask, packs, grid, mat, dt=dt, theta=theta,
                       t_inf=t_inf, implementation="pallas", interpret=True)

    mesh = make_mesh()
    step = sharded_adi_step(grid, mat, mesh, theta=theta)
    T = shard_field(T0, mesh, 0)
    for _ in range(2):
        T = step(T, shard_field(mask, mesh, 0), packs, dt, t_inf)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref), rtol=1e-11,
                               atol=1e-9)
    with pytest.raises(ValueError, match="sharded"):
        make_cartesian_engine(grid, mat, robin_h=250.0, mesh=mesh,
                              implementation="pallas", interpret=True)


def test_sharded_masked_cylindrical_pallas_matches_single_device():
    """Multi-chip element birth: the sharded masked-Robin step (scan
    solves on the virtual mesh) vs the single-device step on the
    Triton-kernel tier (interpret mode)."""
    from adi_thermal_fields_tpu import CylindricalGrid, RobinBC, ZFaceBC
    from adi_thermal_fields_tpu.dist.cylindrical import (
        sharded_cylindrical_masked_step)
    from adi_thermal_fields_tpu.step.cylindrical_masked import (
        adi_step_masked_robin)

    grid = CylindricalGrid(6, 32, 16, 4e-4, 1e-3, r_inner=0.03)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="robin", h_bot=200.0, T_inf_bot=20.0,
                  kind_top="neumann0")
    active_np = np.zeros(grid.shape, bool)
    active_np[:, :, :8] = True
    active_np[:, :20, 8:10] = True
    active = jnp.asarray(active_np)
    rng = np.random.default_rng(5)
    T0 = jnp.asarray(np.where(active_np, 20.0 + 1480.0 * rng.random(grid.shape),
                              20.0))
    dt = 0.05
    kw = dict(robin_outer=rob, zbc=zbc, robin_inner=rob, h_void=80.0,
              T_inf_void=20.0)

    ref = T0
    for _ in range(2):
        ref = adi_step_masked_robin(ref, grid, mat, dt=dt, active=active,
                                    implementation="pallas", interpret=True,
                                    **kw)

    mesh = make_mesh()
    step = sharded_cylindrical_masked_step(grid, mat, mesh, **kw)
    spec = jax.sharding.NamedSharding(mesh,
                                      jax.sharding.PartitionSpec(None, "a", "b"))
    T = jax.device_put(T0, spec)
    act = jax.device_put(active, spec)
    for _ in range(2):
        T = step(T, act, dt)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref), rtol=1e-9,
                               atol=1e-8)


def test_gather_to_host_sharded_and_plain():
    """dist.gather.gather_to_host: identical bytes back from a mesh-sharded
    field, an unsharded device field, and a plain numpy array (the VTK /
    checkpoint path for sharded WAAM runs; multi-process branch uses
    process_allgather, a passthrough single-process)."""
    from adi_thermal_fields_tpu.dist.gather import (gather_to_host,
                                                    is_output_process)

    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 8, 24)).astype(np.float32)
    mesh = make_mesh()
    sharded = shard_field(jnp.asarray(x), mesh, 0)
    assert len(sharded.sharding.device_set) == 8
    np.testing.assert_array_equal(gather_to_host(sharded), x)
    np.testing.assert_array_equal(gather_to_host(jnp.asarray(x)), x)
    assert gather_to_host(x) is x
    assert is_output_process()


def test_sharded_engine_thermal_history_matches_single_device():
    """history_t_crit through the mesh-aware engine: the sharded (T, peak,
    t_above) triple matches the single-device engine bitwise-closely."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    grid = CartesianGrid(16, 16, 8, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.ones(grid.shape, bool)
    T0 = (900.0 + 50.0 * jnp.sin(jnp.arange(16))[:, None, None]
          * jnp.ones(grid.shape))
    hist0 = (T0, jnp.zeros_like(T0))
    kw = dict(theta=0.5, t_inf=20.0, robin_h=250.0, history_t_crit=890.0)

    prep1, adv1 = make_cartesian_engine(grid, mat, **kw)
    ref, (rpk, rta) = adv1(T0, prep1(mask), 0.05, 6, 0.0, hist0)

    mesh = make_mesh()
    prep2, adv2 = make_cartesian_engine(grid, mat, mesh=mesh, **kw)
    Ts = shard_field(T0, mesh, 0)
    out, (pk, ta) = adv2(Ts, prep2(shard_field(mask, mesh, 0)), 0.05, 6, 0.0,
                         (Ts, jnp.zeros_like(Ts)))
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)
    np.testing.assert_allclose(np.asarray(pk), np.asarray(rpk), atol=1e-10)
    np.testing.assert_allclose(np.asarray(ta), np.asarray(rta), atol=0)
    # the sinusoidally-hot columns spent measurably longer above 890 C
    assert float(jnp.max(ta)) > float(jnp.min(ta))


def test_sharded_fused_varprop_matches_single_device():
    """The varprop engine on the mesh (scan solves, XLA-collective halos)
    == the single-device engine on the Triton-kernel tier (interpret mode),
    scalar-h and radiative film modes (the engine's multi-device
    configuration for latent-heat / melt-pool / radiation physics)."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        apparent_cp, melt_pool_enhanced_k)

    grid = CartesianGrid(16, 16, 16, 1e-3, dz=0.8e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(3)
    mask = jnp.asarray(rng.random(grid.shape) > 0.25)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              100.0 + 1300.0 * rng.random(grid.shape), 20.0))
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    mesh = make_mesh()
    for films in (dict(robin_h=40.0),
                  dict(robin_h=15.0, emissivity=0.5)):
        kw = dict(k_table=kt, cp_table=ct, theta=0.5, t_inf=20.0, **films)
        prep1, adv1 = make_cartesian_engine(
            grid, mat, implementation="pallas", interpret=True, **kw)
        ref = adv1(T0, prep1(mask), jnp.asarray(0.02), jnp.int32(3), 0.0)
        prep8, adv8 = make_cartesian_engine(grid, mat, mesh=mesh, **kw)
        T = adv8(shard_field(T0, mesh, 0), prep8(shard_field(mask, mesh, 0)),
                 jnp.asarray(0.02), jnp.int32(3), 0.0)
        assert len(T.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(T), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)


def test_sharded_fused_varprop_bf16_mixed():
    """The sharded varprop engine with a bf16 state (f32 solve, one
    stochastically rounded store per sub-step) stays within the bf16
    quantization envelope of the f32 sharded result."""
    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        apparent_cp, melt_pool_enhanced_k)

    grid = CartesianGrid(16, 16, 16, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    rng = np.random.default_rng(5)
    mask = jnp.asarray(rng.random(grid.shape) > 0.2)
    T0 = jnp.asarray(np.where(np.asarray(mask),
                              100.0 + 1300.0 * rng.random(grid.shape),
                              20.0), jnp.float32)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)

    mesh = make_mesh()
    m = shard_field(mask, mesh, 0)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        prep, adv = make_cartesian_engine(
            grid, mat, k_table=kt, cp_table=ct, theta=0.5, t_inf=20.0,
            robin_h=40.0, mesh=mesh, dtype=dtype,
            stochastic_rounding=dtype == jnp.bfloat16)
        out[dtype] = adv(shard_field(T0.astype(dtype), mesh, 0), prep(m),
                         jnp.asarray(0.02, dtype), jnp.int32(1), 0.0)
    got, ref = out[jnp.bfloat16], out[jnp.float32]
    assert got.dtype == jnp.bfloat16
    assert len(got.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref), rtol=0.02, atol=4.0)


def test_sharded_cyl_varprop_matches_single_device():
    """Sharded variable-property cylindrical step (k(T)+cp(T)+latent,
    element birth) == single-device adi_step_cyl_varprop to 1e-12 —
    beyond-reference: the reference's cylindrical core is constant-property
    and single-device (adi3d_cyl_phi_v3.py)."""
    from adi_thermal_fields_tpu import (CylindricalGrid, RobinBC, ZFaceBC,
                                        PropertyTable, apparent_cp)
    from adi_thermal_fields_tpu.dist.cylindrical import sharded_cyl_varprop_step
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop)

    grid = CylindricalGrid(6, 16, 16, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=500.0,
                  T_inf_top=25.0)
    kt = PropertyTable(jnp.array([0.0, 2000.0]), jnp.array([30.0, 70.0]))
    cpt = apparent_cp(490.0, 640.0, 2.7e5, 1420.0, 1510.0)
    rng = np.random.default_rng(3)
    T0 = jnp.asarray(20.0 + 1600.0 * rng.random(grid.shape))
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    dt = 0.05

    ref = T0
    for _ in range(2):
        ref = adi_step_cyl_varprop(ref, grid, mat, dt=dt, robin_outer=rob,
                                   zbc=zbc, robin_inner=rob, active=act,
                                   h_void=40.0, T_inf_void=20.0,
                                   h_front=120.0, k_table=kt, cp_table=cpt)

    mesh = make_mesh()
    step = sharded_cyl_varprop_step(grid, mat, mesh, robin_outer=rob,
                                    zbc=zbc, robin_inner=rob, h_void=40.0,
                                    T_inf_void=20.0, h_front=120.0,
                                    k_table=kt, cp_table=cpt)
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "a", "b"))
    T = jax.device_put(T0, sh)
    a = jax.device_put(act, sh)
    for _ in range(2):
        T = step(T, a, dt)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_sharded_cyl_varprop_masked_clamp_matches_single_device():
    from adi_thermal_fields_tpu import (CylindricalGrid, RobinBC, ZFaceBC,
                                        PropertyTable)
    from adi_thermal_fields_tpu.dist.cylindrical import sharded_cyl_varprop_step
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop_masked)

    grid = CylindricalGrid(6, 16, 16, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=500.0,
                  T_inf_top=25.0)
    kt = PropertyTable(jnp.array([0.0, 2000.0]), jnp.array([35.0, 60.0]))
    rng = np.random.default_rng(5)
    T0 = jnp.asarray(20.0 + 1200.0 * rng.random(grid.shape))
    act = jnp.asarray(rng.random(grid.shape) > 0.4)
    dt = 0.04

    ref = adi_step_cyl_varprop_masked(T0, grid, mat, dt=dt, robin_outer=rob,
                                      zbc=zbc, active=act, k_table=kt,
                                      robin_inner=rob)

    mesh = make_mesh()
    step = sharded_cyl_varprop_step(grid, mat, mesh, robin_outer=rob,
                                    zbc=zbc, robin_inner=rob, k_table=kt,
                                    masked_clamp=True)
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "a", "b"))
    out = step(jax.device_put(T0, sh), jax.device_put(act, sh), dt)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_sharded_cyl_varprop_longz_matches_single_device():
    """Tall-tube decomposition: z itself sharded over a 1-D 8-device mesh,
    r/phi solves chip-local, z solved by the substructured distributed
    Thomas — matches the single-device varprop step to substructuring
    round-off (~1e-9 at f64)."""
    from adi_thermal_fields_tpu import (CylindricalGrid, RobinBC, ZFaceBC,
                                        PropertyTable)
    from adi_thermal_fields_tpu.dist.cylindrical import (
        sharded_cyl_varprop_longz)
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    grid = CylindricalGrid(5, 12, 32, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=500.0,
                  T_inf_top=25.0)
    kt = PropertyTable(jnp.array([0.0, 2000.0]), jnp.array([30.0, 70.0]))
    rng = np.random.default_rng(9)
    T0 = jnp.asarray(20.0 + 1500.0 * rng.random(grid.shape))
    act = jnp.asarray(rng.random(grid.shape) > 0.25)
    dt = 0.05
    kw = dict(robin_outer=rob, zbc=zbc, robin_inner=rob, k_table=kt,
              h_void=40.0, T_inf_void=20.0, h_front=120.0, emissivity=0.4)

    ref = T0
    for _ in range(2):
        ref = adi_step_cyl_varprop(ref, grid, mat, dt=dt, active=act, **kw)

    mesh = Mesh(np.asarray(jax.devices()), ("z",))
    step = sharded_cyl_varprop_longz(grid, mat, mesh, **kw)
    sh = NamedSharding(mesh, P(None, None, "z"))
    T = jax.device_put(T0, sh)
    a = jax.device_put(act, sh)
    for _ in range(2):
        T = step(T, a, dt)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref),
                               rtol=1e-9, atol=1e-8)


def test_sharded_cyl_varprop_pallas_matches_single_device():
    """The sharded cylindrical varprop step (scan solves, per-stage layouts
    on the virtual mesh) must match the single-device Triton-kernel tier
    (interpret mode).  Radiative films + element birth + annular inner
    Robin exercised."""
    from adi_thermal_fields_tpu import (CylindricalGrid, PropertyTable,
                                        RobinBC, ZFaceBC, apparent_cp)
    from adi_thermal_fields_tpu.dist.cylindrical import (
        sharded_cyl_varprop_step)
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop)

    grid = CylindricalGrid(6, 16, 16, 5e-4, 1e-3, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(350.0, 20.0)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=500.0,
                  T_inf_top=25.0)
    kt = PropertyTable(jnp.array([0.0, 2000.0]), jnp.array([30.0, 70.0]))
    cpt = apparent_cp(490.0, 640.0, 2.7e5, 1420.0, 1510.0)
    rng = np.random.default_rng(11)
    T0 = jnp.asarray(20.0 + 1600.0 * rng.random(grid.shape))
    act = jnp.asarray(rng.random(grid.shape) > 0.3)
    dt = 0.05
    kw = dict(robin_outer=rob, zbc=zbc, robin_inner=rob, h_void=40.0,
              T_inf_void=20.0, h_front=120.0, k_table=kt, cp_table=cpt,
              emissivity=0.4)

    ref = T0
    for _ in range(2):
        ref = adi_step_cyl_varprop(ref, grid, mat, dt=dt, active=act,
                                   implementation="pallas", interpret=True,
                                   **kw)

    mesh = make_mesh()
    step = sharded_cyl_varprop_step(grid, mat, mesh, **kw)
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "a", "b"))
    T = jax.device_put(T0, sh)
    a = jax.device_put(act, sh)
    for _ in range(2):
        T = step(T, a, dt)
    assert len(T.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(T), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)
