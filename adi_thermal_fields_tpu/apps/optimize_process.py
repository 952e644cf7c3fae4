"""Adjoint-based WAAM process-schedule optimization (CLI app).

Inverse process design: differentiate through the FULL transient ADI
simulation of a layer-by-layer wall build and gradient-descend per-layer
process parameters so every layer hits a target t8/5 cooling time (the
800 -> 500 C dwell that controls steel microstructure).  As a wall grows,
heat accumulates and later layers cool ever slower — a constant schedule
gives layer-dependent t8/5; the optimizer finds the per-layer deposit
superheat or inter-layer dwell that equalizes it.

This capability has no reference analogue (the reference's Numba/CuPy cores,
adi3d_numba_coeff.py / adi3d_gpu_coeff.py, are not differentiable); it exists
because the framework's step (`step/cartesian.adi_step`) is a pure
traceable function, so ``jax.grad`` of a scalar loss w.r.t. any schedule
parameter flows through every Thomas solve of every sub-step (reverse-mode
through ``lax.scan``, rematerialized per layer with ``jax.checkpoint`` to
bound memory).

Decision variables (``--var``):
  deposit_T : per-layer deposit temperature [C] (superheat / preheat control)
  dwell     : per-layer inter-layer dwell time [s] (interpass control),
              kept positive via a softplus reparameterization and charged
              a small total-time penalty so the optimizer prefers fast
              schedules among those hitting the target.

The per-layer t8/5 proxy integrates a smooth band indicator of the layer's
mean temperature, ``integral dt sigma((Tm-500)/w) sigma((800-Tm)/w)``,
with the clock stopped at the layer's FIRST drop below the band (default
``--t85_mode first_crossing``) so reheat excursions from later deposits do
not inflate it; differentiable everywhere (width ``w`` in K), and equal to
the true 800->500 crossing time in the narrow-width limit.

Example:
    python -m adi_thermal_fields_tpu.apps.optimize_process \
        --layers 8 --target_t85 6 --var deposit_T --iters 40
"""
from __future__ import annotations

import argparse
import json

import numpy as np

__all__ = ["build_wall_problem", "make_forward", "optimize", "run",
           "build_argparser"]


def build_wall_problem(*, nx: int, ny: int, nz_plate: int, n_layers: int,
                       layer_vox: int, wall_w_vox: int, dx: float,
                       mat, h: float, t_inf: float, dtype):
    """Static geometry for a thin wall grown on a plate.

    Returns (grid, masks, newborn, probe_w):
      masks   : (L, nx, ny, nz) bool — active cells after layer i deposited
      newborn : (L, nx, ny, nz) bool — cells born at layer i
      probe_w : (L, N) dtype — row i = normalized indicator of layer i's
                cells (probe weights for the layer-mean temperature)
    """
    import jax.numpy as jnp

    from ..core.grid import CartesianGrid

    nz = nz_plate + n_layers * layer_vox
    grid = CartesianGrid(nx, ny, nz, dx)

    plate = np.zeros(grid.shape, bool)
    plate[:, :, :nz_plate] = True

    x0 = nx // 2 - wall_w_vox // 2
    wall_cols = slice(x0, x0 + wall_w_vox)

    masks, newborn, probes = [], [], []
    cur = plate.copy()
    for i in range(n_layers):
        z0 = nz_plate + i * layer_vox
        born = np.zeros(grid.shape, bool)
        born[wall_cols, :, z0:z0 + layer_vox] = True
        cur = cur | born
        masks.append(cur.copy())
        newborn.append(born)
        w = born.astype(np.float64).ravel()
        probes.append(w / w.sum())

    return (grid,
            jnp.asarray(np.stack(masks)),
            jnp.asarray(np.stack(newborn)),
            jnp.asarray(np.stack(probes), dtype))


def make_forward(grid, masks, newborn, probe_w, mat, *, h: float,
                 t_inf: float, n_sub: int, target_t85: float,
                 band=(500.0, 800.0), band_w: float = 15.0,
                 time_penalty: float = 0.0, dtype=None,
                 k_table=None, cp_table=None,
                 interpass_limit=None, interpass_penalty: float = 1.0,
                 target_weight: float = 1.0,
                 t85_mode: str = "first_crossing"):
    """Build the differentiable ``forward(deposit_T, dwell_s) -> (loss, aux)``.

    Fully jittable; BE time stepping (theta=1) so traced dwell lengths of any
    size stay stable.  aux = dict(t85=(L,), T_final=...).

    ``k_table``/``cp_table``: optional T-dependent properties (e.g.
    ``apparent_cp`` with latent heat — solidification released in the very
    band t8/5 measures); routes through the differentiable varprop scan tier
    (`step/cartesian_varprop.adi_step_varprop(implementation="xla")`).

    ``interpass_limit``: optional interpass-temperature constraint [C]: the
    top layer's mean temperature at the END of each segment (just before
    the next deposit) is charged ``interpass_penalty * relu(T - limit)^2``.
    The LAST segment is exempt — no deposit follows it, so cooling the
    finished part would be a pointless terminal dwell.  With
    ``target_weight=0`` and a ``time_penalty`` this poses the production
    question directly: the fastest dwell schedule that respects the
    interpass limit.  aux gains ``interpass=(L,)`` (all L readings,
    including the unconstrained last one).

    ``t85_mode``: 'first_crossing' (default) stops a layer's t8/5 clock the
    first time its mean drops below the band, so reheat excursions from
    later deposits do not inflate it (the metallurgical 800->500 time;
    simplification: full re-austenitization by a later deposit would
    restart the clock in reality).  'occupancy' counts ALL time in the
    band (the raw band-occupancy integral).
    """
    import jax
    import jax.numpy as jnp

    from ..bc.packs import build_coeff_packs
    from ..step.cartesian import adi_step
    from ..step.cartesian_varprop import adi_step_varprop

    if dtype is None:
        dtype = jnp.result_type(float)
    L = int(masks.shape[0])
    t_lo, t_hi = band

    # per-layer coefficient packs (stacked pytree, scanned over)
    packs = [build_coeff_packs(masks[i], grid, mat, robin_h=h, dtype=dtype)
             for i in range(L)]
    packs = jax.tree.map(lambda *xs: jnp.stack(xs), *packs)

    def band_ind(tm):
        return (jax.nn.sigmoid((tm - t_lo) / band_w)
                * jax.nn.sigmoid((t_hi - tm) / band_w))

    if t85_mode not in ("first_crossing", "occupancy"):
        raise ValueError(f"unknown t85_mode {t85_mode!r} "
                         "(first_crossing | occupancy)")

    def layer_segment(T, t85, done, mask_i, pk_i, born_i, dep_i, dwell_i, i):
        T = jnp.where(born_i, dep_i.astype(dtype), T)
        dt = (dwell_i / n_sub).astype(dtype)
        deposited = (jnp.arange(L) <= i).astype(dtype)
        # a fresh deposit restarts nothing: done stays per first crossing

        def sub(carry, _):
            T, t85, done = carry
            if k_table is not None or cp_table is not None:
                T = adi_step_varprop(T, mask_i, pk_i, grid, mat, dt=dt,
                                     theta=1.0, t_inf=t_inf,
                                     k_table=k_table, cp_table=cp_table,
                                     implementation="xla")
            else:
                T = adi_step(T, mask_i, pk_i, grid, mat, dt=dt, theta=1.0,
                             t_inf=t_inf)
            tm = probe_w @ T.reshape(-1)           # (L,) layer-mean probes
            t85 = t85 + dt * deposited * (1.0 - done) * band_ind(tm)
            if t85_mode == "first_crossing":
                # clock stops at the first sub-band reading after deposit
                done = jnp.maximum(done, deposited * (tm < t_lo))
            return (T, t85, done), None

        (T, t85, done), _ = jax.lax.scan(sub, (T, t85, done), None,
                                         length=n_sub)
        # interpass reading: the just-deposited layer's mean T at segment
        # end (the temperature the NEXT layer is laid onto)
        tip = (probe_w @ T.reshape(-1))[i]
        return T, t85, done, tip

    # rematerialize per layer: reverse-mode keeps one layer's sub-steps
    # live at a time instead of the whole build history
    layer_segment = jax.checkpoint(layer_segment)

    def forward(deposit_T, dwell_s):
        T0 = jnp.full(grid.shape, t_inf, dtype)
        t85 = jnp.zeros((L,), dtype)
        done = jnp.zeros((L,), dtype)

        def body(carry, xs):
            T, t85, done = carry
            mask_i, pk_i, born_i, dep_i, dw_i, i = xs
            T, t85, done, tip = layer_segment(T, t85, done, mask_i, pk_i,
                                              born_i, dep_i, dw_i, i)
            return (T, t85, done), tip

        xs = (masks, packs, newborn, deposit_T.astype(dtype),
              dwell_s.astype(dtype), jnp.arange(L))
        (T, t85, done), interpass = jax.lax.scan(body, (T0, t85, done), xs)

        miss = t85 - target_t85
        loss = target_weight * jnp.mean(miss * miss)
        if time_penalty:
            loss = loss + time_penalty * jnp.sum(dwell_s)
        if interpass_limit is not None:
            over = jnp.maximum(interpass - interpass_limit, 0.0)
            # last segment exempt: nothing is deposited after it
            w_next = (jnp.arange(L) < L - 1).astype(dtype)
            loss = loss + interpass_penalty * (
                jnp.sum(w_next * over * over) / max(L - 1, 1))
        return loss, {"t85": t85, "T_final": T, "interpass": interpass}

    return forward


def optimize(forward, var: str, deposit_T0, dwell_s0, *, iters: int,
             lr: float, dwell_min: float = 0.5, log=print):
    """Adam on the selected variable; returns (deposit_T, dwell_s, history)."""
    import jax
    import jax.numpy as jnp
    import optax

    if var == "deposit_T":
        params = jnp.asarray(deposit_T0, jnp.result_type(float))

        def loss_fn(p):
            return forward(p, jnp.asarray(dwell_s0, p.dtype))
    elif var == "dwell":
        # dwell = dwell_min + softplus(p): positive by construction.
        # Stable inverse softplus: expm1 overflows above ~709, but
        # softplus(x) == x to f64 precision beyond ~30
        d0 = jnp.asarray(dwell_s0, jnp.result_type(float))
        x = jnp.maximum(d0 - dwell_min, 1e-3)
        params = jnp.where(x > 30.0, x,
                           jnp.log(jnp.expm1(jnp.minimum(x, 30.0))))

        def loss_fn(p):
            dw = dwell_min + jax.nn.softplus(p)
            return forward(jnp.asarray(deposit_T0, p.dtype), dw)
    else:
        raise ValueError(f"unknown --var {var!r} (deposit_T | dwell)")

    opt = optax.adam(lr)
    state = opt.init(params)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    history = []
    for it in range(iters):
        (loss, aux), g = vg(params)
        history.append(float(loss))
        if log is not None and (it % max(1, iters // 10) == 0
                                or it == iters - 1):
            t85 = np.asarray(aux["t85"])
            log(f"iter {it:4d} loss {float(loss):.6g} "
                f"t85 [{t85.min():.3g}, {t85.max():.3g}] s")
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)

    if var == "deposit_T":
        dep, dw = params, jnp.asarray(dwell_s0, params.dtype)
    else:
        import jax.nn
        dep = jnp.asarray(deposit_T0, params.dtype)
        dw = dwell_min + jax.nn.softplus(params)
    return dep, dw, history


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Adjoint optimization of a WAAM wall-build schedule")
    p.add_argument("--nx", type=int, default=24)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nz_plate", type=int, default=6)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--layer_vox", type=int, default=2)
    p.add_argument("--wall_w_vox", type=int, default=3)
    p.add_argument("--dx_mm", type=float, default=1.5)
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=30.0)
    p.add_argument("--h", type=float, default=80.0)
    p.add_argument("--T_inf", type=float, default=25.0)
    p.add_argument("--deposit_T", type=float, default=1550.0)
    p.add_argument("--dwell_s", type=float, default=8.0)
    p.add_argument("--n_sub", type=int, default=24,
                   help="ADI sub-steps per layer interval")
    p.add_argument("--target_t85", type=float, default=6.0,
                   help="target 800->500 C cooling time [s]")
    p.add_argument("--band_w", type=float, default=15.0,
                   help="smooth band indicator width [K]")
    p.add_argument("--t85_mode", choices=["first_crossing", "occupancy"],
                   default="first_crossing",
                   help="stop each layer's t8/5 clock at its first drop "
                        "below the band (metallurgical 800->500 time) or "
                        "count all in-band time incl. reheat excursions")
    p.add_argument("--var", choices=["deposit_T", "dwell"],
                   default="deposit_T")
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--lr", type=float, default=None,
                   help="Adam step (default: 20 for deposit_T, 0.2 for dwell)")
    p.add_argument("--time_penalty", type=float, default=0.0,
                   help="loss += penalty * total dwell [1/s] (dwell mode)")
    p.add_argument("--interpass_limit_C", type=float, default=None,
                   help="soft interpass-temperature constraint [C]: "
                        "penalize each layer's mean T at segment end above "
                        "this; combine with --var dwell --time_penalty "
                        "(and optionally --target_weight 0) to find the "
                        "fastest schedule that respects the limit")
    p.add_argument("--interpass_penalty", type=float, default=1.0)
    p.add_argument("--target_weight", type=float, default=1.0,
                   help="weight of the t8/5 target term (0 disables it)")
    p.add_argument("--latent_J_kg", type=float, default=0.0,
                   help="latent heat of fusion [J/kg]; releases inside the "
                        "solidus..liquidus band via apparent cp(T) — the "
                        "varprop (differentiable) forward.  NOTE: apparent "
                        "cp acts on steps whose starting T lies in the band; "
                        "pick n_sub so the cooling trajectory samples it "
                        "(a first deposit step can drop hundreds of K)")
    p.add_argument("--solidus_C", type=float, default=1420.0)
    p.add_argument("--liquidus_C", type=float, default=1470.0)
    p.add_argument("--out", type=str, default=None,
                   help="write the optimized schedule as JSON")
    return p


def run(args) -> dict:
    import jax.numpy as jnp

    from ..core.material import Material
    from ..io.logging import log

    mat = Material(args.rho, args.cp, args.k)
    dtype = jnp.result_type(float)
    grid, masks, newborn, probe_w = build_wall_problem(
        nx=args.nx, ny=args.ny, nz_plate=args.nz_plate,
        n_layers=args.layers, layer_vox=args.layer_vox,
        wall_w_vox=args.wall_w_vox, dx=args.dx_mm * 1e-3, mat=mat,
        h=args.h, t_inf=args.T_inf, dtype=dtype)
    cp_table = None
    if args.latent_J_kg > 0.0:
        from ..step.cartesian_varprop import apparent_cp
        cp_table = apparent_cp(args.cp, args.cp, args.latent_J_kg,
                               args.solidus_C, args.liquidus_C)
    forward = make_forward(grid, masks, newborn, probe_w, mat, h=args.h,
                           t_inf=args.T_inf, n_sub=args.n_sub,
                           target_t85=args.target_t85, band_w=args.band_w,
                           time_penalty=args.time_penalty, dtype=dtype,
                           cp_table=cp_table,
                           interpass_limit=args.interpass_limit_C,
                           interpass_penalty=args.interpass_penalty,
                           target_weight=args.target_weight,
                           t85_mode=args.t85_mode)

    L = args.layers
    dep0 = jnp.full((L,), args.deposit_T, dtype)
    dw0 = jnp.full((L,), args.dwell_s, dtype)

    loss0, aux0 = forward(dep0, dw0)
    t85_0 = np.asarray(aux0["t85"])
    log(f"initial loss {float(loss0):.6g}; "
        f"t85 spread [{t85_0.min():.3g}, {t85_0.max():.3g}] s "
        f"(target {args.target_t85})")

    lr = args.lr if args.lr is not None else (
        20.0 if args.var == "deposit_T" else 0.2)
    dep, dw, history = optimize(forward, args.var, dep0, dw0,
                                iters=args.iters, lr=lr,
                                log=lambda m: log(m, tag="opt"))
    loss1, aux1 = forward(dep, dw)
    t85_1 = np.asarray(aux1["t85"])
    log(f"final loss {float(loss1):.6g}; "
        f"t85 spread [{t85_1.min():.3g}, {t85_1.max():.3g}] s")

    result = {
        "var": args.var,
        "loss_initial": float(loss0),
        "loss_final": float(loss1),
        "t85_initial": t85_0.tolist(),
        "t85_final": t85_1.tolist(),
        "deposit_T": np.asarray(dep).tolist(),
        "dwell_s": np.asarray(dw).tolist(),
        "interpass_final": np.asarray(aux1["interpass"]).tolist(),
        "history": history,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        log(f"schedule written to {args.out}", tag="opt")
    return result


def main(argv=None):
    from ..core.backend import configure_compile_cache

    configure_compile_cache()
    args = build_argparser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
