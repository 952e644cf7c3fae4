"""Multi-chip domain decomposition for the cylindrical BE step.

Sharding strategy per stage (field (nr, nphi, nz); nr is typically small —
a wall a few dozen cells thick — so the radial axis always stays local):

    r-sweep:   shard (phi over 'a', z over 'b'), r local
    phi-FFT:   phi local, z sharded over the whole mesh: P(None, None, ('a','b'))
    z-sweep:   shard (phi over ('a','b')), z local

XLA lowers the stage transitions to all-to-alls, exactly like the Cartesian
layer (dist/cartesian.py).  The sweeps solve with the scan: a Pallas call
has no partitioning rule for sharded operands.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..step.cylindrical import RobinBC, ZFaceBC, _r_sweep, _z_sweep
from ..solvers.spectral import phi_solve_spectral

__all__ = ["sharded_cylindrical_step", "sharded_cylindrical_masked_step",
           "sharded_cylindrical_masked_clamp_step",
           "sharded_cyl_varprop_step", "sharded_cyl_varprop_longz"]


def sharded_cylindrical_step(grid: CylindricalGrid, mat: Material, mesh: Mesh,
                             *, robin_outer: RobinBC, zbc: ZFaceBC,
                             robin_inner: RobinBC | None = None):
    """Jitted multi-chip cylindrical BE step ``step(T, dt)``; semantics of
    step/cylindrical.adi_step(scheme="be")."""
    a, b = mesh.axis_names

    def constrain(x, spec):
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

    @jax.jit
    def step(T, dt):
        # r-sweep: r local, batch (phi, z) sharded
        X = _r_sweep(constrain(T, P(None, a, b)), grid, mat, dt,
                     robin_outer, robin_inner, implementation="xla")
        # phi solve: phi local, z sharded over the full mesh
        X = phi_solve_spectral(constrain(X, P(None, None, (a, b))),
                               grid, mat, 1.0, dt)
        # z-sweep: z local, phi sharded over the full mesh
        X = _z_sweep(constrain(X, P(None, (a, b), None)), grid, mat, dt, zbc,
                     implementation="xla")
        return constrain(X, P(None, a, b))

    return step


def _stage_specs(mesh: Mesh):
    """Per-sweep layouts: the solve axis chip-local, batch axes sharded.
    nr is small (a wall a few dozen cells thick) and always stays local."""
    a, b = mesh.axis_names
    return {"r": P(None, a, b),
            "phi": P(None, None, (a, b)),
            "z": P(None, (a, b), None)}


def sharded_cylindrical_masked_step(grid: CylindricalGrid, mat: Material,
                                    mesh: Mesh, *, robin_outer: RobinBC,
                                    zbc: ZFaceBC,
                                    robin_inner: RobinBC | None = None,
                                    h_void: float = 0.0,
                                    T_inf_void: float = 20.0,
                                    h_front: float | None = None):
    """Jitted multi-chip masked-Robin step ``step(T, active, dt)`` — element
    birth across chips; semantics of
    step/cylindrical_masked.adi_step_masked_robin.

    Each sweep's RHS is pinned to the layout keeping its solve axis local
    (the masked phi solve is mask-broken *cyclic* Thomas, so phi must be
    chip-local); XLA lowers the transitions to all-to-alls and the
    mask-shift halo reads to collective-permutes."""
    from ..step.cylindrical_masked import adi_step_masked_robin

    specs = _stage_specs(mesh)

    def cz(x, stage):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, specs[stage]))

    @jax.jit
    def step(T, active, dt):
        out = adi_step_masked_robin(
            T, grid, mat, dt=dt, active=active, robin_outer=robin_outer,
            zbc=zbc, robin_inner=robin_inner, h_void=h_void,
            T_inf_void=T_inf_void, h_front=h_front, constrain=cz,
            implementation="xla")
        return cz(out, "r")

    return step


def sharded_cylindrical_masked_clamp_step(grid: CylindricalGrid, mat: Material,
                                          mesh: Mesh, *, robin_outer: RobinBC,
                                          zbc: ZFaceBC,
                                          robin_inner: RobinBC | None = None,
                                          robin_void: RobinBC | None = None):
    """Jitted multi-chip clamp-parity masked step ``step(T, active, dt)`` —
    the reference's element-birth scheme (void cells clamped to ambient
    around the unmasked core, quick_spiral_deposition_gif_v5.py:31-70) on
    the sharded unmasked BE step."""
    a, b = mesh.axis_names
    rin = robin_inner if robin_inner is not None else robin_outer
    rvd = robin_void if robin_void is not None else robin_outer
    inner = sharded_cylindrical_step(grid, mat, mesh, robin_outer=robin_outer,
                                     zbc=zbc, robin_inner=robin_inner)

    @jax.jit
    def step(T, active, dt):
        active_b = active.astype(bool)
        T_work = jnp.where(active_b, T, rvd.T_inf)
        T1 = inner(T_work, dt)
        T1 = jnp.where(active_b, T1, rvd.T_inf)
        T1 = T1.at[0].set(jnp.where(active_b[0], T1[0], rin.T_inf))
        return jax.lax.with_sharding_constraint(
            T1, NamedSharding(mesh, P(None, a, b)))

    return step


def sharded_cyl_varprop_step(grid: CylindricalGrid, mat_ref: Material,
                             mesh: Mesh, *, robin_outer: RobinBC,
                             zbc: ZFaceBC, k_table=None, cp_table=None,
                             robin_inner: RobinBC | None = None,
                             h_void: float = 0.0, T_inf_void: float = 20.0,
                             h_front: float | None = None,
                             emissivity: float = 0.0,
                             masked_clamp: bool = False,
                             robin_void: RobinBC | None = None):
    """Jitted multi-chip variable-property cylindrical BE step — k(T)/cp(T)/
    latent heat with element birth across chips.  (Backward Euler only;
    the Douglas scheme is single-device — spiral_tube guards the
    combination.)

    ``step(T, active, dt)``: semantics of step/cylindrical_varprop.
    adi_step_cyl_varprop (``masked_clamp=False``, adiabatic material/void
    interfaces + optional interface Robin sinks) or adi_step_cyl_varprop_
    masked (``masked_clamp=True``, the reference's clamp scheme,
    quick_spiral_deposition_gif_v5.py:31-70).

    Layouts follow _stage_specs: each sweep's solve axis chip-local, batch
    axes sharded; the property fields k(T^n), 1/(rho cp(T^n)) are elementwise
    in T so XLA re-shards them with the RHS (the harmonic face folds add one
    halo collective-permute per axis).  Solvers are the scans (see the
    constrain note in adi_step_cyl_varprop).
    """
    from ..step.cylindrical_varprop import (adi_step_cyl_varprop,
                                            adi_step_cyl_varprop_masked)

    specs = _stage_specs(mesh)

    def cz(x, stage):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, specs[stage]))

    if masked_clamp:
        @jax.jit
        def step(T, active, dt):
            out = adi_step_cyl_varprop_masked(
                cz(T, "r"), grid, mat_ref, dt=dt, robin_outer=robin_outer,
                zbc=zbc, active=active, k_table=k_table, cp_table=cp_table,
                robin_inner=robin_inner, robin_void=robin_void,
                emissivity=emissivity, implementation="xla", constrain=cz)
            return cz(out, "r")
    else:
        @jax.jit
        def step(T, active, dt):
            out = adi_step_cyl_varprop(
                cz(T, "r"), grid, mat_ref, dt=dt, robin_outer=robin_outer,
                zbc=zbc, k_table=k_table, cp_table=cp_table,
                robin_inner=robin_inner, active=active, h_void=h_void,
                T_inf_void=T_inf_void, h_front=h_front,
                emissivity=emissivity, implementation="xla", constrain=cz)
            return cz(out, "r")

    return step


def sharded_cyl_varprop_longz(grid: CylindricalGrid, mat_ref: Material,
                              mesh: Mesh, *, robin_outer: RobinBC,
                              zbc: ZFaceBC, k_table=None, cp_table=None,
                              robin_inner: RobinBC | None = None,
                              h_void: float = 0.0, T_inf_void: float = 20.0,
                              h_front: float | None = None,
                              emissivity: float = 0.0):
    """Long-axis decomposition for TALL TUBES: the z axis ITSELF is sharded
    over a 1-D mesh and the field NEVER reshards — the natural layout for
    the cylindrical family's dominant shape (nz >> nr, nphi).

    The r sweep and the cyclic phi solve are chip-local with z as a batch
    axis (the varprop property/face/sink streams are elementwise + one-cell
    z shifts, which lower to collective-permutes); the z sweep runs the
    substructured distributed tridiagonal solve (dist/substructured.py,
    one tiny interface all-gather) through adi_step_cyl_varprop's
    ``z_solver`` hook.  ``step(T, active, dt)``; substructuring rounds
    differ by ~ulps from the sequential Thomas."""
    from ..step.cylindrical_varprop import adi_step_cyl_varprop
    from .substructured import substructured_thomas

    if len(mesh.axis_names) != 1:
        raise ValueError("longz decomposition expects a 1-D mesh")
    ax = mesh.axis_names[0]
    spec = P(None, None, ax)

    def cz(x, stage):
        # every stage keeps the SAME z-sharded layout (no resharding)
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

    def zsolve(a, b, c, d):
        # z-leading (nz, nr, nphi): solve axis sharded over ax
        return substructured_thomas(a, b, c, d, mesh, ax)

    @jax.jit
    def step(T, active, dt):
        out = adi_step_cyl_varprop(
            cz(T, "r"), grid, mat_ref, dt=dt, robin_outer=robin_outer,
            zbc=zbc, k_table=k_table, cp_table=cp_table,
            robin_inner=robin_inner, active=active, h_void=h_void,
            T_inf_void=T_inf_void, h_front=h_front, emissivity=emissivity,
            implementation="xla", constrain=cz, z_solver=zsolve)
        return cz(out, "r")

    return step
