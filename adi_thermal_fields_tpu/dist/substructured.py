"""Distributed tridiagonal solve by substructuring (interface reduction).

The transpose scheme (dist/cartesian.py) keeps every sweep's solve axis
chip-local by resharding between sweeps — two all-to-alls per sweep.  When
ONE axis is long enough that it must itself be split across chips (the
reference's validation runs reach nz = 1600,
quick_compare_neumann_robin_backend.py:30-31; SURVEY.md §5 "long-context
analogue"), the alternative is to solve the tridiagonal systems in place:

  1. each chip owns a contiguous block of rows and expresses its interior
     unknowns as an affine function of its two interface unknowns,
         x_int = y + u * x_first + v * x_last,
     by one local Thomas solve with three right-hand sides (shared
     factorization; fully parallel across chips and batch);
  2. the first/last-row equations then close over interface unknowns only,
     giving a global tridiagonal system of size 2*P (P = chips along the
     axis), whose coefficients are all-gathered — 8 numbers per
     batch element per chip — and solved redundantly on every chip;
  3. interiors are recovered locally from the affine expression.

Communication: ONE all-gather of 8 B/batch-element/chip (vs two full-field
all-to-alls for the transpose scheme).  Extra compute: ~3x the local Thomas
flops.  Which wins depends on the batch size per device and the
interconnect's bandwidth; both strategies are provided.

Convention matches solvers/thomas.py: systems along axis 0, trailing axes
batch; a[0] and c[n-1] ignored (zero).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..solvers.thomas import thomas

__all__ = ["substructured_thomas", "local_reduce", "interface_solve"]


def local_reduce(a, b, c, d):
    """Per-block reduction: returns (y, u, v, interface equation rows).

    y/u/v: (m-2, ...) interior affine factors (empty when m == 2);
    eq_first/eq_last: each a tuple (A, B, C, D) of (...,)-shaped
    coefficients — the block's two closure equations over
    (neighbor, x_first, x_last) and (x_first, x_last, neighbor)."""
    m = a.shape[0]
    if m < 2:
        raise ValueError("substructuring needs >= 2 rows per chip")
    if m == 2:
        # no interior: the two rows couple directly
        y = u = v = jnp.zeros((0,) + a.shape[1:], a.dtype)
        eq_first = (a[0], b[0], c[0], d[0])
        eq_last = (a[1], b[1], c[1], d[1])
        return y, u, v, eq_first, eq_last

    ai, bi, ci, di = a[1:-1], b[1:-1], c[1:-1], d[1:-1]
    zeros = jnp.zeros_like(di)
    # three RHS through one factorization: y = T^-1 d,
    # u = T^-1 (-a_1 e_0), v = T^-1 (-c_{m-2} e_last)
    e0 = zeros.at[0].set(-ai[0])
    eL = zeros.at[-1].set(-ci[-1])
    # stack RHS on a new trailing axis so the scan factors once
    rhs = jnp.stack([di, e0, eL], axis=-1)
    sol = thomas(ai[..., None], bi[..., None], ci[..., None], rhs)
    y, u, v = sol[..., 0], sol[..., 1], sol[..., 2]

    eq_first = (a[0], b[0] + c[0] * u[0], c[0] * v[0], d[0] - c[0] * y[0])
    eq_last = (a[-1] * u[-1], b[-1] + a[-1] * v[-1], c[-1],
               d[-1] - a[-1] * y[-1])
    return y, u, v, eq_first, eq_last


def interface_solve(eqs_gathered):
    """Solve the gathered (2P, ...) interface tridiagonal; returns x_if."""
    A, B, C, D = eqs_gathered
    return thomas(A, B, C, D)


def substructured_thomas(a, b, c, d, mesh: Mesh, axis_name: str,
                         batch_spec: tuple = ()):
    """Solve tridiagonal systems whose SOLVE AXIS (axis 0) is sharded over
    ``axis_name`` of ``mesh``.  Trailing axes are batch; pass their mesh
    axis names (or None) in ``batch_spec`` if they are sharded too.

    Returns x with the same sharding as d.  Jit-compatible; the inner
    computation runs under shard_map with one all_gather over the axis."""
    from jax import shard_map

    nsh = mesh.shape[axis_name]

    def local_fn(a_l, b_l, c_l, d_l):
        idx = jax.lax.axis_index(axis_name)
        y, u, v, eq_f, eq_l = local_reduce(a_l, b_l, c_l, d_l)
        # own two interface equations, stacked (2, ...)
        eq = tuple(jnp.stack([f, l]) for f, l in zip(eq_f, eq_l))
        # gather every chip's pair -> (2P, ...) global interface system
        eqs = tuple(
            jnp.reshape(jax.lax.all_gather(e, axis_name, axis=0),
                        (2 * nsh,) + e.shape[1:])
            for e in eq)
        x_if = interface_solve(eqs)
        x_first = x_if[2 * idx]
        x_last = x_if[2 * idx + 1]
        x_int = y + u * x_first[None] + v * x_last[None]
        return jnp.concatenate([x_first[None], x_int, x_last[None]], axis=0)

    spec_in = P(axis_name, *batch_spec)
    return shard_map(local_fn, mesh=mesh,
                     in_specs=(spec_in, spec_in, spec_in, spec_in),
                     out_specs=spec_in, check_vma=False)(a, b, c, d)
