"""Benchmark harness: ADI step throughput of each physics family on one GPU.

    python bench.py [--case NAME]

Prints one JSON line per case: cell-updates/s, ms/step, compile seconds,
the shape, and the device it ran on (platform, device_kind, count).  With
no ``--case`` every case in ``CASES`` runs, in order; ``--case capacity``
runs the 768^3 capacity case alone.  A run without a GPU fails: no number
here comes from the CPU.  Each case runs once at its one shape; a failing
case fails the run.

Timing: ``io.profiling.StepTimer`` (host clock around ``block_until_ready``)
over ``steps`` steps after one compiling step.  Rooflines and per-leg
metrics are not computed here yet.
"""
import functools
import json
import sys
import time

import numpy as np


def build_case(n, dtype):
    """A masked WAAM-like Cartesian domain: a solid plate (lower 3/4 of z)
    with a deposited block on top, 900 C in the solid."""
    import jax.numpy as jnp

    from adi_thermal_fields_tpu import CartesianGrid, Material

    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = CartesianGrid(nx, ny, nz, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    zsplit = (3 * nz) // 4
    mask_np = np.ones(grid.shape, bool)
    mask_np[:, :, zsplit:] = False
    mask_np[nx // 4: 3 * nx // 4, ny // 4: 3 * ny // 4,
            zsplit: zsplit + nz // 8] = True
    mask = jnp.asarray(mask_np)
    T = jnp.where(mask, 900.0, 20.0).astype(dtype)
    return grid, mat, T, mask


def _time(step, T, steps):
    """(seconds per step, compile+first-step seconds) of ``T = step(T)``."""
    import jax
    import jax.numpy as jnp

    from adi_thermal_fields_tpu.io.profiling import StepTimer

    t0 = time.perf_counter()
    T = jax.block_until_ready(step(T))
    first = time.perf_counter() - t0
    per_step, T = StepTimer().time_steps(step, T, n_steps=steps, warmup=0)
    if not bool(jnp.isfinite(T.astype(jnp.float32)).all()):
        raise FloatingPointError("non-finite field in bench run")
    return per_step, first


def case_cartesian(n=512, steps=20, dtype="float32"):
    """Masked Cartesian theta step, Robin h on every exposed face (the
    reference's WAAM BC set, waam_from_stl_v7_mm.py:446-455)."""
    import jax
    import jax.numpy as jnp

    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine

    dtype = jnp.dtype(dtype)
    grid, mat, T, mask = build_case(n, dtype)
    prepare, advance = make_cartesian_engine(
        grid, mat, robin_h=200.0, t_inf=20.0, dtype=dtype,
        stochastic_rounding=dtype == jnp.bfloat16)
    prep = prepare(mask)
    dt = jnp.asarray(0.05, dtype)
    return grid.shape, _time(
        lambda T: advance(T, prep, dt, jnp.int32(1), 0.0), T, steps)


def case_cylindrical(shape=(128, 512, 512), steps=40):
    """Cylindrical backward-Euler step: r and z Thomas sweeps, spectral
    phi."""
    import jax
    import jax.numpy as jnp

    from adi_thermal_fields_tpu import (CylindricalGrid, Material, RobinBC,
                                        ZFaceBC)
    from adi_thermal_fields_tpu.step.cylindrical import adi_step

    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    robin = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    dt = jnp.float32(0.02)
    step = jax.jit(lambda T: adi_step(T, grid, mat, dt=dt, robin_outer=robin,
                                      zbc=zbc), donate_argnums=0)
    return shape, _time(step, jnp.full(shape, 900.0, jnp.float32), steps)


def _part_deposited(shape):
    """Tube half built plus 3/5 of the next ring band (element birth)."""
    nr, nphi, nz = shape
    act = np.zeros(shape, bool)
    act[:, :, :nz // 2] = True
    act[:, :(3 * nphi) // 5, nz // 2:nz // 2 + nz // 8] = True
    return act


def case_masked(shape=(64, 512, 1024), steps=40):
    """Masked-Robin cylindrical step with a prebuilt plan (the plan is
    rebuilt only at birth events)."""
    import jax
    import jax.numpy as jnp

    from adi_thermal_fields_tpu import (CylindricalGrid, Material, RobinBC,
                                        ZFaceBC)
    from adi_thermal_fields_tpu.step.cylindrical_masked import (
        build_masked_robin_plan, masked_robin_solve)

    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    active = jnp.asarray(_part_deposited(shape))
    plan = jax.jit(functools.partial(
        build_masked_robin_plan, grid, mat, robin_outer=rob, zbc=zbc,
        robin_inner=rob, h_void=80.0, dtype=jnp.float32))(active)
    dt = jnp.float32(0.02)
    # the plan enters as an argument (a closed-over array would be embedded
    # in the program as a constant)
    step = jax.jit(lambda T, plan: masked_robin_solve(T, plan, grid, mat,
                                                      dt=dt),
                   donate_argnums=0)
    T = jnp.where(active, 900.0, 20.0).astype(jnp.float32)
    return shape, _time(lambda T: step(T, plan), T, steps)


def case_varprop(n=384, steps=30, corrected=False):
    """Variable-property engine step: apparent-cp latent heat, melt-pool
    k, radiative film.  ``corrected``: per-face h fields and radiative
    area scales (the ``waam_from_stl --corrected_bc`` path, synthetic
    fields)."""
    import jax
    import jax.numpy as jnp

    from adi_thermal_fields_tpu.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        apparent_cp, melt_pool_enhanced_k)

    grid, mat, T, mask = build_case(n, jnp.float32)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    films = dict(robin_h=15.0)
    if corrected:
        rng = np.random.default_rng(5)
        faces = ("x-", "x+", "y-", "y+", "z-", "z+")
        films = dict(
            robin_h={f: jnp.asarray(10.0 + 10.0 * rng.random(grid.shape),
                                    jnp.float32) for f in faces},
            radiation_scale={f: jnp.asarray(
                0.7 + 0.6 * rng.random(grid.shape), jnp.float32)
                for f in faces})
    prepare, advance = make_cartesian_engine(
        grid, mat, t_inf=20.0, dtype=jnp.float32, emissivity=0.5,
        k_table=kt, cp_table=ct, **films)
    prep = prepare(mask)
    dt = jnp.float32(0.02)
    return grid.shape, _time(
        lambda T: advance(T, prep, dt, jnp.int32(1), 0.0), T, steps)


def case_cyl_varprop(shape=(64, 512, 1024), steps=30):
    """Variable-property cylindrical step with element birth (the
    spiral_tube CLI's varprop configuration)."""
    import jax
    import jax.numpy as jnp

    from adi_thermal_fields_tpu import (CylindricalGrid, Material, RobinBC,
                                        ZFaceBC)
    from adi_thermal_fields_tpu.step.cartesian_varprop import (
        apparent_cp, melt_pool_enhanced_k)
    from adi_thermal_fields_tpu.step.cylindrical_varprop import (
        adi_step_cyl_varprop)

    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    active = jnp.asarray(_part_deposited(shape))
    dt = jnp.float32(0.02)
    f = jax.jit(lambda T, active: adi_step_cyl_varprop(
        T, grid, mat, dt=dt, robin_outer=RobinBC(300.0, 20.0),
        zbc=ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0),
        robin_inner=RobinBC(50.0, 20.0), active=active, h_void=80.0,
        T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
        emissivity=0.5), donate_argnums=0)
    T = jnp.where(active, 1600.0, 20.0).astype(jnp.float32)
    return shape, _time(lambda T: f(T, active), T, steps)


CASES = {
    "cartesian": case_cartesian,
    "bf16": functools.partial(case_cartesian, dtype="bfloat16"),
    "cylindrical": case_cylindrical,
    "masked": case_masked,
    "varprop": case_varprop,
    "corrected": functools.partial(case_varprop, corrected=True),
    # 576 is no power of two: the Triton kernel masks its last batch block
    "hostile": functools.partial(case_varprop, n=(96, 384, 576), steps=12),
    "cyl_varprop": case_cyl_varprop,
}
EXTRA = {"capacity": functools.partial(case_cartesian, n=768, steps=12)}


def main(argv):
    import jax

    from adi_thermal_fields_tpu.core.backend import (configure_compile_cache,
                                                     platform)

    names = list(CASES)
    if "--case" in argv:
        names = [argv[argv.index("--case") + 1]]
    if platform() != "gpu":
        raise SystemExit("bench.py measures the GPU; no GPU backend found")
    cache = configure_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"[bench] {device} cache={cache}", file=sys.stderr)
    for name in names:
        shape, (per_step, first) = {**CASES, **EXTRA}[name]()
        cells = int(np.prod(shape))
        print(json.dumps({
            "metric": f"{name}_cell_updates_per_s",
            "value": cells / per_step, "unit": "cell/s",
            "ms_per_step": per_step * 1e3,
            "first_step_s": first, "shape": list(shape),
            "device": device}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
