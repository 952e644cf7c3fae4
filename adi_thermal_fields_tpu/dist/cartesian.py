"""Multi-chip domain decomposition for the Cartesian ADI step.

Strategy (SURVEY.md §7, "transpose scheme"): each implicit sweep's tridiagonal
systems must be chip-local along the solve axis, so the field is resharded
between sweeps —

    x-sweep: T sharded ('a' over y, 'b' over z), x local
    y-sweep: T sharded ('a' over x, 'b' over z), y local
    z-sweep: T sharded ('a' over x, 'b' over y), z local

Sharding constraints are placed on the sweep inputs; XLA lowers the
transitions to all-to-alls (the ADI analogue of Ulysses-style
sequence-parallel transposes).  The explicit masked Laplacian runs under the
x-sweep layout; XLA inserts halo collectives for the shifted reads.  The
sweeps solve with the scan: a Pallas call has no partitioning rule for
sharded operands.

The reference has no distributed layer at all (SURVEY.md §2, "Parallelism
strategies"); this module is new design.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bc.packs import CoeffPacks
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..step.cartesian import (build_sweep_system, implicit_sweep,
                              masked_laplacian_1d)

__all__ = ["make_mesh", "sharded_adi_step", "sharded_adi_step_longz",
           "shard_field"]


def make_mesh(devices=None, shape: tuple[int, int] | None = None,
              axis_names: tuple[str, str] = ("a", "b")) -> Mesh:
    """Build a 2-D device mesh for batch-axis sharding of the sweeps.

    With n devices and no explicit shape, uses the most square (p, q)
    factorization with p <= q (e.g. 8 -> (2, 4))."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        p = int(np.floor(np.sqrt(n)))
        while n % p:
            p -= 1
        shape = (p, n // p)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def _spec_for_sweep(axis: int, a: str, b: str) -> P:
    """PartitionSpec keeping ``axis`` local and sharding the two batch axes."""
    specs = {
        0: P(None, a, b),
        1: P(a, None, b),
        2: P(a, b, None),
    }
    return specs[axis]


def shard_field(x: jax.Array, mesh: Mesh, sweep_axis: int = 0) -> jax.Array:
    """Place a field on the mesh in the layout of the given sweep."""
    a, b = mesh.axis_names
    return jax.device_put(x, NamedSharding(mesh, _spec_for_sweep(sweep_axis, a, b)))


def sharded_adi_step(grid: CartesianGrid, mat: Material, mesh: Mesh, *,
                     theta: float = 0.5):
    """Return a jitted multi-chip ADI step ``step(T, mask, packs, dt, t_inf)``.

    Semantics identical to step/cartesian.py:adi_step; layouts are constrained
    per sweep so every tridiagonal system stays chip-local and the
    inter-sweep resharding rides all-to-alls."""
    a, b = mesh.axis_names
    kappa = mat.alpha
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]   # per-axis (anisotropic)

    def constrain(x, axis):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, _spec_for_sweep(axis, a, b)))

    @partial(jax.jit, static_argnames=())
    def step(T, mask, packs: CoeffPacks, dt, t_inf, source=None):
        mask = mask.astype(bool)
        tg = [theta * (kappa * dt * iv) for iv in inv_d2]

        T = constrain(T, 0)
        mask0 = constrain(mask, 0)
        lap = (masked_laplacian_1d(T, mask0, 0, inv_d2[0])
               + masked_laplacian_1d(T, mask0, 1, inv_d2[1])
               + masked_laplacian_1d(T, mask0, 2, inv_d2[2]))
        R0 = T + dt * kappa * (1.0 - theta) * lap
        if source is not None:
            R0 = R0 + jnp.where(mask0, dt * source / (mat.rho * mat.cp), 0.0)

        x = implicit_sweep(constrain(R0, 0), mask0, packs.coeff[0],
                           packs.dir_mask, packs.dir_val, packs.qflux[0],
                           tg[0], dt, t_inf, axis=0, implementation="xla")
        x = implicit_sweep(constrain(x, 1), constrain(mask, 1), packs.coeff[1],
                           packs.dir_mask, packs.dir_val, packs.qflux[1],
                           tg[1], dt, t_inf, axis=1, implementation="xla")
        x = implicit_sweep(constrain(x, 2), constrain(mask, 2), packs.coeff[2],
                           packs.dir_mask, packs.dir_val, packs.qflux[2],
                           tg[2], dt, t_inf, axis=2, implementation="xla")
        return x

    return step


def sharded_adi_step_longz(grid: CartesianGrid, mat: Material, mesh: Mesh, *,
                           theta: float = 0.5):
    """Long-axis decomposition: the z axis ITSELF is sharded across chips
    (the field never reshards).  x/y sweeps are chip-local (z is one of
    their batch axes); the z sweep runs the substructured distributed
    tridiagonal solve (dist/substructured.py) — one tiny interface
    all-gather instead of two full-field all-to-alls.

    ``mesh`` must be 1-D; T/mask/packs sharded ``P(None, None, axis)``.
    Returns a jitted ``step(T, mask, packs, dt, t_inf)`` with the semantics
    of step/cartesian.adi_step (substructuring rounds differ by ~ulps from
    the sequential Thomas)."""
    from .substructured import substructured_thomas

    if len(mesh.axis_names) != 1:
        raise ValueError("longz decomposition expects a 1-D mesh")
    ax = mesh.axis_names[0]
    kappa = mat.alpha
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    spec = P(None, None, ax)

    def constrain(x):
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

    @jax.jit
    def step(T, mask, packs: CoeffPacks, dt, t_inf):
        mask = constrain(mask.astype(bool))
        tg = [theta * (kappa * dt * iv) for iv in inv_d2]

        T = constrain(T)
        lap = (masked_laplacian_1d(T, mask, 0, inv_d2[0])
               + masked_laplacian_1d(T, mask, 1, inv_d2[1])
               + masked_laplacian_1d(T, mask, 2, inv_d2[2]))
        R0 = constrain(T + dt * kappa * (1.0 - theta) * lap)

        x = implicit_sweep(R0, mask, packs.coeff[0], packs.dir_mask,
                           packs.dir_val, packs.qflux[0], tg[0], dt,
                           t_inf, axis=0, implementation="xla")
        x = implicit_sweep(constrain(x), mask, packs.coeff[1], packs.dir_mask,
                           packs.dir_val, packs.qflux[1], tg[1], dt,
                           t_inf, axis=1, implementation="xla")
        a, b, c, d = build_sweep_system(constrain(x), mask, packs.coeff[2],
                                        packs.dir_mask, packs.dir_val,
                                        packs.qflux[2], tg[2], dt, t_inf,
                                        axis=2)
        mv = lambda t: jnp.moveaxis(t, 2, 0)
        xz = substructured_thomas(mv(a), mv(b), mv(c), mv(d), mesh, ax)
        return constrain(jnp.moveaxis(xz, 0, 2))

    return step
