"""Batched Thomas solve as one Pallas-Triton kernel (NVIDIA GPUs).

``lax.scan`` over the solve axis compiles on the GPU to a ``while`` loop of
small dependent kernels: one 512^3 ADI step is 3 sweeps x 2 passes x 512
iterations, each a handful of launches.  This kernel runs the whole
recurrence inside one launch:

* one pencil (system) per lane, ``BLOCK`` pencils per program; the grid
  covers the flattened batch, and a ragged last block is masked;
* the forward elimination and the back substitution are ``fori_loop`` s
  inside the kernel, the carried ``c'``/``d'`` (and ``x``) live in
  registers;
* row ``i`` of every coefficient is one contiguous load across the batch
  (the batch axes are the trailing, contiguous ones), so every load and
  store is coalesced;
* the solve axis has no BlockSpec: any length works (no power-of-two
  padding), the kernel loops over it.

Per step it reads a, b, c, d once, writes c' and d' once, reads them back
once and writes x: 9 passes of the field, against the scan's per-iteration
launches.  Coefficients whose batch extent is 1 (the cylindrical sweeps'
1-D coefficient vectors) are passed as columns and broadcast in the kernel,
never materialised.

``thomas_pallas`` carries a ``jax.custom_vjp``: the pullback of
``x = A^{-1} d`` solves the transposed system ``A^T y = g`` (sub/super
diagonals swapped: ``a_t[i] = c[i-1]``, ``c_t[i] = a[i+1]``) with the same
kernel and contracts ``y`` against ``x``: ``d_bar = y``,
``a_bar[i] = -y[i] x[i-1]``, ``b_bar = -y x``, ``c_bar[i] = -y[i] x[i+1]``.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["thomas_pallas", "BLOCK", "NUM_WARPS"]

# Pencils per program and warps per program: the fastest of the block/warp
# pairs swept at (512, 512*512) f32 on an H100 (PERF.md, Findings).
BLOCK = 256
NUM_WARPS = 4


def _kernel(a_ref, b_ref, c_ref, d_ref, x_ref, cp_ref, *, n, block, cols):
    j = pl.program_id(0) * block + jnp.arange(block)
    live = j < d_ref.shape[1]
    j0 = jnp.zeros_like(j)

    def load(ref, i, is_col, other):
        if is_col:      # (n, 1) coefficient column: every lane reads row i
            return plgpu.load(ref.at[i, j0])
        return plgpu.load(ref.at[i, j], mask=live, other=other)

    def fwd(i, carry):
        cp_prev, dp_prev = carry
        a = load(a_ref, i, cols[0], 0.0)
        b = load(b_ref, i, cols[1], 1.0)
        c = load(c_ref, i, cols[2], 0.0)
        d = plgpu.load(d_ref.at[i, j], mask=live, other=0.0)
        denom = b - a * cp_prev
        cp = c / denom
        dp = (d - a * dp_prev) / denom
        plgpu.store(cp_ref.at[i, j], cp, mask=live)
        plgpu.store(x_ref.at[i, j], dp, mask=live)
        return cp, dp

    zero = jnp.zeros((block,), x_ref.dtype)
    _, x_last = lax.fori_loop(0, n, fwd, (zero, zero))

    def bwd(k, x_next):
        i = n - 2 - k
        cp = plgpu.load(cp_ref.at[i, j], mask=live, other=0.0)
        dp = plgpu.load(x_ref.at[i, j], mask=live, other=0.0)
        x = dp - cp * x_next
        plgpu.store(x_ref.at[i, j], x, mask=live)
        return x

    lax.fori_loop(0, n - 1, bwd, x_last)


def _as_2d(v, shape, cdt):
    """``v`` as an (n, B) array, or as an (n, 1) column when it is constant
    over the batch.  Returns (array, is_column)."""
    v = jnp.asarray(v, cdt)
    n = shape[0]
    vs = (1,) * (len(shape) - v.ndim) + v.shape
    if all(s == 1 for s in vs[1:]):
        return jnp.broadcast_to(v.reshape(vs[0]), (n,)).reshape(n, 1), True
    return jnp.broadcast_to(v, shape).reshape(n, -1), False


def _solve(a, b, c, d, interpret: bool):
    n, batch = d.shape[0], d.shape[1:]
    nb = math.prod(batch)
    if n == 0 or nb == 0:
        return jnp.zeros(d.shape, d.dtype)
    cdt = jnp.promote_types(d.dtype, jnp.float32)
    (a2, ca), (b2, cb), (c2, cc) = (_as_2d(v, d.shape, cdt)
                                    for v in (a, b, c))
    d2 = jnp.asarray(d, cdt).reshape(n, nb)
    block = min(BLOCK, max(16, pl.next_power_of_2(nb)))
    kernel = functools.partial(_kernel, n=n, block=block, cols=(ca, cb, cc))
    x, _ = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n, nb), cdt)] * 2,
        grid=(pl.cdiv(nb, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="thomas_triton",
    )(a2, b2, c2, d2)
    return x.reshape(d.shape).astype(d.dtype)


def _shift_dn(x):
    """x[i-1] along axis 0, 0 at i=0."""
    return jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)


def _shift_up(x):
    """x[i+1] along axis 0, 0 at i=n-1."""
    return jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)


def _unbroadcast(bar, like):
    """Sum ``bar`` (full shape) down to the shape of the primal ``like``."""
    shape = jnp.shape(like)
    extra = bar.ndim - len(shape)
    if extra:
        bar = bar.sum(axis=tuple(range(extra)))
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and bar.shape[i] != 1)
    if axes:
        bar = bar.sum(axis=axes, keepdims=True)
    return bar.reshape(shape).astype(jnp.result_type(like))


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _thomas_diff(a, b, c, d, interpret):
    return _solve(a, b, c, d, interpret)


def _fwd(a, b, c, d, interpret):
    x = _solve(a, b, c, d, interpret)
    return x, (a, b, c, x)


def _bwd(interpret, res, g):
    a, b, c, x = res
    full = lambda v: jnp.broadcast_to(jnp.asarray(v, x.dtype), x.shape)
    af, cf = full(a), full(c)
    y = _solve(_shift_dn(cf), b, _shift_up(af), g, interpret)
    a_bar = -y * _shift_dn(x)
    b_bar = -y * x
    c_bar = -y * _shift_up(x)
    return (_unbroadcast(a_bar, a), _unbroadcast(b_bar, b),
            _unbroadcast(c_bar, c), y)


_thomas_diff.defvjp(_fwd, _bwd)


def thomas_pallas(a, b, c, d, *, interpret: bool = False) -> jax.Array:
    """Solve tridiagonal systems along axis 0 of ``d`` (trailing axes are
    the batch) with the Triton kernel.  ``a``, ``b``, ``c`` broadcast
    against ``d``; ``a[0]`` and ``c[n-1]`` are ignored.  Same contract and
    the same operation order as ``solvers.thomas.thomas_scan``; bfloat16
    systems are solved in float32.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU)."""
    return _thomas_diff(a, b, c, d, interpret)
