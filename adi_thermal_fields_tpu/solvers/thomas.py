"""Batched tridiagonal (Thomas) solvers: the one solve every step calls.

The reference solves tridiagonal systems three ways:
  * a scalar per-pencil Thomas under Numba (adi3d_numba_coeff.py:120-130),
  * a CuPy batch vectorized across pencils with a Python loop over the solve
    axis (adi3d_gpu_coeff.py:140-152),
  * a NumPy batch for cylindrical sweeps (adi3d_cyl_phi_v3.py:71-89).

Here every pencil perpendicular to the solve axis is a system, all solved
at once.  Two implementations share one contract:

* ``thomas_scan``: the recurrence as ``lax.scan`` over the *leading* axis,
  each scan step one fused elementwise op over the trailing batch dims.
  Runs anywhere, differentiates natively, and is the reference.
* ``solvers.thomas_triton.thomas_pallas``: one Pallas-Triton kernel with
  the recurrence in registers (NVIDIA GPUs; Pallas interpreter on CPU).

``thomas`` picks between them through ``core.backend.resolve_implementation``
("auto": the kernel on a GPU, the scan on the CPU).

Conventions: for systems ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]``,
``a[0]`` and ``c[n-1]`` are ignored (treated as zero).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.backend import resolve_implementation

__all__ = ["thomas", "thomas_scan", "thomas_along_axis", "cyclic_thomas"]


def thomas(a, b, c, d, *, implementation: str = "auto",
           interpret: bool = False) -> jax.Array:
    """Solve tridiagonal systems along axis 0; trailing axes are batch.

    ``implementation``: "auto", "pallas" or "xla" (core/backend.py);
    ``interpret`` runs the Pallas kernel in the interpreter (CPU tests)."""
    if resolve_implementation(implementation, interpret) == "pallas":
        from .thomas_triton import thomas_pallas

        return thomas_pallas(a, b, c, d, interpret=interpret)
    return thomas_scan(a, b, c, d)


def thomas_scan(a: jax.Array, b: jax.Array, c: jax.Array,
                d: jax.Array) -> jax.Array:
    """Solve tridiagonal systems along axis 0 with ``lax.scan``; trailing
    axes are batch.

    All inputs share one shape ``(n, *batch)``.  Returns ``x`` of that shape.
    Standard Thomas forward elimination + back substitution, batched:
    ``cp[i] = c[i]/(b[i]-a[i]*cp[i-1])``, ``dp[i] = (d[i]-a[i]*dp[i-1])/(...)``,
    then ``x[i] = dp[i] - cp[i]*x[i+1]``.
    """
    zero = jnp.zeros(d.shape[1:], d.dtype)

    def fwd(carry, abcd):
        cp_prev, dp_prev = carry
        a_i, b_i, c_i, d_i = abcd
        denom = b_i - a_i * cp_prev
        cp = c_i / denom
        dp = (d_i - a_i * dp_prev) / denom
        return (cp, dp), (cp, dp)

    _, (cp, dp) = lax.scan(fwd, (zero, zero), (a, b, c, d))

    def bwd(x_next, cpdp):
        cp_i, dp_i = cpdp
        x = dp_i - cp_i * x_next
        return x, x

    _, x = lax.scan(bwd, zero, (cp, dp), reverse=True)
    return x


def thomas_along_axis(a, b, c, d, axis: int, **kw) -> jax.Array:
    """Solve tridiagonal systems along an arbitrary axis of nd arrays
    (``kw``: ``implementation``/``interpret`` as for ``thomas``)."""
    if axis == 0:
        return thomas(a, b, c, d, **kw)
    mv = lambda t: jnp.moveaxis(t, axis, 0)
    x = thomas(mv(a), mv(b), mv(c), mv(d), **kw)
    return jnp.moveaxis(x, 0, axis)


def cyclic_thomas(a, b, c, d, alpha=None, beta=None, *,
                  implementation: str = "auto",
                  interpret: bool = False) -> jax.Array:
    """Solve batched *cyclic* (periodic) tridiagonal systems along axis 0.

    System: ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]`` with wrap-around
    couplings ``beta * x[n-1]`` in row 0 and ``alpha * x[0]`` in row n-1.
    ``alpha``/``beta`` broadcast against the batch shape; they default to the
    natural periodic couplings ``alpha = c[n-1]``, ``beta = a[0]``, in which
    case ``a[0]`` and ``c[n-1]`` are zeroed internally.

    Sherman–Morrison rank-1 correction, mirroring the reference's (dead-code)
    ``_cyclic_thomas_batch_np`` (adi3d_cyl_phi_v3.py:92-123) but with the
    textbook-correct perturbation vector: solve ``B y = d`` and ``B z = u``
    where ``B = A - u v^T``, ``u = (g, ..., alpha)``, ``v = (1, ..., beta/g)``
    with gauge ``g = -b[0]``, then ``x = y - z (v^T y)/(1 + v^T z)``.
    Both inner solves go through ``thomas`` (``implementation``/``interpret``
    as there).
    """
    n = d.shape[0]
    if beta is None:
        beta = a[0]
        a = a.at[0].set(0.0)
    if alpha is None:
        alpha = c[n - 1]
        c = c.at[n - 1].set(0.0)

    alpha = jnp.broadcast_to(alpha, d.shape[1:]).astype(d.dtype)
    beta = jnp.broadcast_to(beta, d.shape[1:]).astype(d.dtype)

    gamma = -b[0]
    b_mod = b.at[0].add(-gamma).at[n - 1].add(-alpha * beta / gamma)

    kw = dict(implementation=implementation, interpret=interpret)
    y = thomas(a, b_mod, c, d, **kw)

    u = jnp.zeros_like(d).at[0].set(gamma).at[n - 1].set(alpha)
    z = thomas(a, b_mod, c, u, **kw)

    fact = (y[0] + beta * y[n - 1] / gamma) / (1.0 + z[0] + beta * z[n - 1] / gamma)
    return y - fact[None, ...] * z
