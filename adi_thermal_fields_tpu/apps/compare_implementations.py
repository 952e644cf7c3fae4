"""Implementation A/B driver: Triton Thomas kernel vs ``lax.scan`` (CLI app).

The analogue of the reference's CPU-vs-GPU backend comparison
(quick_compare_neumann_robin_backend.py:172-231): runs the identical
Neumann-heated / Robin-cooled cylinder on both solver tiers
(solvers/thomas.py), reports wall-clock per step and the RMS / max field
difference at the end.  On the CPU the kernel runs in the Pallas
interpreter.

    python -m adi_thermal_fields_tpu.apps.compare_implementations --n 128
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="scan vs Triton-kernel ADI step "
                                            "comparison")
    p.add_argument("--n", type=int, default=128, help="grid edge (n^3)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--case", choices=["cartesian", "cyl_varprop"],
                   default="cartesian",
                   help="cartesian: the masked theta step (the "
                        "reference backend A/B); cyl_varprop: the "
                        "variable-property cylindrical step")
    return p


def _time_paths(paths, T0, dt, steps, probe, ncells, log):
    """Run each jitted ``step(T, dt)`` ``steps`` times after a compile
    call; returns (final fields, seconds per step)."""
    results, timings = {}, {}
    for name, step in paths.items():
        T = step(T0, dt)
        float(probe(T))  # compile + sync
        t0 = time.perf_counter()
        for _ in range(steps):
            T = step(T, dt)
        float(probe(T))
        el = (time.perf_counter() - t0) / steps
        timings[name] = el
        results[name] = np.asarray(T)
        log(f"{name:7s}: {el * 1e3:8.2f} ms/step  "
            f"({ncells / el / 1e9:6.2f} Gcell/s)", tag="time")
    return results, timings


def run(args) -> dict:
    if getattr(args, "case", "cartesian") == "cyl_varprop":
        return run_cyl_varprop(args)
    import jax
    import jax.numpy as jnp

    from ..core.backend import platform
    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..bc.packs import build_coeff_packs
    from ..geometry.shapes import cylinder_mask
    from ..io.logging import log
    from ..step.cartesian import adi_step

    n = args.n
    dtype = jnp.float32 if args.precision == "float32" else jnp.float64
    grid = CartesianGrid(n, n, n, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = jnp.asarray(cylinder_mask(n, n, n, grid.dx, 0.45 * n * grid.dx))
    packs = build_coeff_packs(mask, grid, mat, robin_h=300.0,
                              neumann={"z-": 2e5}, dtype=dtype)
    T0 = jnp.full(grid.shape, 20.0, dtype)
    dt = jnp.asarray(args.dt, dtype)

    interpret = platform() == "cpu"
    # fields enter as arguments: closed-over arrays would be embedded in
    # the program as constants
    paths = {}
    for impl in ("xla", "pallas"):
        f = jax.jit(lambda T, dt, mask, packs, impl=impl: adi_step(
            T, mask, packs, grid, mat, dt=dt, theta=0.5, t_inf=20.0,
            implementation=impl, interpret=interpret))
        paths[impl] = lambda T, dt, f=f: f(T, dt, mask, packs)
    probe = jax.jit(lambda x: jnp.sum(x[:: max(1, n // 8)]))
    results, timings = _time_paths(paths, T0, dt, args.steps, probe,
                                   grid.ncells, log)

    diff = results["xla"] - results["pallas"]
    m = np.asarray(mask)
    rms = float(np.sqrt(np.mean(diff[m] ** 2)))
    mx = float(np.abs(diff[m]).max())
    log(f"xla vs pallas: RMS={rms:.3e}  max={mx:.3e}", tag="diff")
    return {"timings": timings, "rms": rms, "max": mx}


def run_cyl_varprop(args) -> dict:
    """A/B of the variable-property cylindrical step on a part-deposited
    annulus (latent heat + melt-pool k + radiation): 'xla' scan vs
    'pallas' (the Triton kernel)."""
    import jax
    import jax.numpy as jnp

    from ..core.backend import platform
    from ..core.grid import CylindricalGrid
    from ..core.material import Material
    from ..io.logging import log
    from ..step.cartesian_varprop import apparent_cp, melt_pool_enhanced_k
    from ..step.cylindrical import RobinBC, ZFaceBC
    from ..step.cylindrical_varprop import adi_step_cyl_varprop

    n = args.n
    dtype = jnp.float32 if args.precision == "float32" else jnp.float64
    nr, nphi, nz = max(8, n // 8), 4 * n, n
    grid = CylindricalGrid(nr, nphi, nz, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    act = np.zeros(grid.shape, bool)
    act[:, :, :nz // 2] = True
    act[:, :(3 * nphi) // 5, nz // 2:nz // 2 + max(1, nz // 8)] = True
    active = jnp.asarray(act)
    T0 = jnp.where(active, 1600.0, 20.0).astype(dtype)
    dt = jnp.asarray(args.dt, dtype)
    interpret = platform() == "cpu"
    kw = dict(robin_outer=RobinBC(300.0, 20.0),
              zbc=ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0),
              robin_inner=RobinBC(50.0, 20.0), k_table=kt, cp_table=ct,
              h_void=80.0, T_inf_void=20.0, h_front=200.0, emissivity=0.5)
    paths = {}
    for impl in ("xla", "pallas"):
        f = jax.jit(lambda T, dt, active, impl=impl: adi_step_cyl_varprop(
            T, grid, mat, dt=dt, active=active, implementation=impl,
            interpret=interpret, **kw))
        paths[impl] = lambda T, dt, f=f: f(T, dt, active)
    probe = jax.jit(lambda x: jnp.sum(x[::8, ::64, ::32]))
    results, timings = _time_paths(paths, T0, dt, args.steps, probe,
                                   grid.nr * grid.nphi * grid.nz, log)

    m = np.asarray(active)
    out = {"timings": timings}
    diff = (results["xla"] - results["pallas"])[m]
    rms = float(np.sqrt(np.mean(diff ** 2)))
    mx = float(np.abs(diff).max())
    log(f"xla vs pallas: RMS={rms:.3e}  max={mx:.3e}", tag="diff")
    out["max_pallas"] = mx
    return out


def main(argv=None):
    from ..core.backend import configure_compile_cache

    configure_compile_cache()
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
