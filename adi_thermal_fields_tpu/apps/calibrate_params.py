"""Thermal parameter identification from measured cooling curves (CLI app).

Calibration is the standard prerequisite of any WAAM thermal model: the
convection coefficient h, conductivity k, and heat capacity cp of a real
setup are never known to better than tens of percent, and are usually fitted
to thermocouple traces of a quench/cool-down experiment.  This app does the
fit by ADJOINT differentiation: the loss ``mean((T_sim(probes, t_s) -
T_meas)^2)`` is differentiated through the full transient ADI simulation
with ``jax.grad``, so the fit converges in tens of Adam iterations rather
than the hundreds of forward runs a derivative-free fit needs.

No reference analogue (the reference's Numba/CuPy cores are not
differentiable).  Differentiability w.r.t. the PHYSICS constants comes from
two framework properties: ``bc/packs.build_coeff_packs`` is traceable in
``robin_h``, and ``step/cartesian_varprop.adi_step_varprop`` accepts
callable k(T)/cp(T) tables that may close over traced parameters (here:
constant tables carrying the fit variables).

Scenario: a solid block at uniform T0 cooling by Robin convection on all
exposed faces, sampled at probe voxels (center / face-center / corner —
chosen so k and h are separately identifiable from the transient).
Measurements come from ``--measured @csv`` (columns: t, one per probe) or
are synthesized from ``--true_h/--true_k/--true_cp/--true_eps`` for
self-validation.  ``--fit eps`` calibrates emissivity (radiation is THE
dominant, least-known loss at WAAM temperatures) jointly with the
convective film; ``--uq`` adds Gauss-Newton 1-sigma error bars computed by
``jax.jacfwd`` of the residual vector through the whole simulation.

Example (synthetic round trip):
    python -m adi_thermal_fields_tpu.apps.calibrate_params \
        --fit h,k --true_h 45 --true_k 38 --iters 60
"""
from __future__ import annotations

import argparse
import json

import numpy as np

__all__ = ["default_probes", "make_measurement_forward", "fit",
           "build_argparser", "run"]


def default_probes(shape):
    """Probe voxels with complementary sensitivities: center (conduction-
    dominated), face center (film-dominated), edge midpoint."""
    nx, ny, nz = shape
    return [(nx // 2, ny // 2, nz // 2),
            (nx // 2, ny // 2, nz - 1),
            (nx // 2, 0, nz - 1)]


def make_measurement_forward(grid, mat_base, probes, *, t0: float,
                             t_inf: float, dt: float, n_steps: int,
                             sample_every: int, dtype):
    """Differentiable ``forward(params) -> (n_samples, n_probes)`` simulated
    probe traces.  params: dict with any of 'h', 'k', 'cp', 'eps' as
    scalars (traced or not); missing 'k'/'cp' take mat_base values,
    missing 'h' means no convective film, missing 'eps' means no
    radiation (with 'eps', 'h' is the additive convective film).  The
    caller passes non-fitted constants explicitly — see ``fit(fixed=)``."""
    import jax
    import jax.numpy as jnp

    from ..bc.packs import build_coeff_packs
    from ..step.cartesian_varprop import adi_step_varprop

    mask = jnp.ones(grid.shape, bool)
    pidx = tuple(jnp.asarray([p[i] for p in probes]) for i in range(3))
    # the Robin sink is LINEAR in h: hoist the static geometry (six
    # exposed-face erosions + 1/(rho cp_ref d) scaling) out of the
    # per-step rebuild as unit-h packs; a per-cell h field then enters
    # as a broadcast multiply (both faces of an axis share the cell's h,
    # so h * unit_coeff == a full rebuild, exactly)
    packs_unit = build_coeff_packs(mask, grid, mat_base, robin_h=1.0,
                                   dtype=dtype)

    def forward(params):
        h = params.get("h", jnp.asarray(0.0, dtype))
        k = params.get("k", jnp.asarray(mat_base.k, dtype))
        cp = params.get("cp", jnp.asarray(mat_base.cp, dtype))
        eps = params.get("eps", None)
        # rescale the Robin sink from the base cp to the fitted cp: packs
        # carry h*A/(rho cp_base V); the varprop step rescales by
        # cp_base/cp(T) internally, so fitted cp flows through cp_table
        k_tab = lambda T: jnp.full(T.shape, k, dtype)
        cp_tab = lambda T: jnp.full(T.shape, cp, dtype)
        if eps is None:
            packs = packs_unit._replace(
                coeff=packs_unit.coeff * jnp.asarray(h, dtype))

        def step(T, _):
            if eps is not None:
                # radiation: exact Robin-film factorization h(T) (linearized
                # per sub-step at T^n like the engine's Picard refresh),
                # traceable in eps; the fitted convective film adds on top
                from ..bc.radiation import radiative_h
                hf = radiative_h(T, eps, t_inf, h_conv=h).astype(dtype)
                pk = packs_unit._replace(
                    coeff=packs_unit.coeff * hf[None])
            else:
                pk = packs
            T = adi_step_varprop(T, mask, pk, grid, mat_base,
                                 k_table=k_tab, cp_table=cp_tab,
                                 dt=dt, theta=1.0, t_inf=t_inf,
                                 implementation="xla")
            return T, T[pidx]

        T0f = jnp.full(grid.shape, t0, dtype)
        _, traces = jax.lax.scan(step, T0f, None, length=n_steps)
        return traces[sample_every - 1::sample_every]

    return forward


def fit(forward, measured, fit_keys, init, *, iters: int, lr: float = 0.1,
        optimizer: str = "lbfgs", fixed=None, log=print):
    """Minimize the trace misfit in log-parameter space (positivity by
    construction); returns (fitted dict, loss history).

    fixed: dict of NON-fitted parameters held constant in the forward
    (e.g. a known h while fitting k).  Without it, parameters absent from
    ``fit_keys`` take the forward's own defaults (no film, mat_base
    properties) — fitting k alone with no film would see zero gradient.

    optimizer: 'lbfgs' (default — a 1-3 parameter smooth deterministic fit
    is exactly L-BFGS territory; converges in ~10-30 evaluations) or 'adam'
    (with exponential lr decay; for noisy measurements where the linesearch
    can stall on a rough surface).

    The last history entry is always the loss evaluated AT the returned
    parameters (one extra forward), so (fitted, history[-1]) is a
    consistent pair in both branches.
    """
    import jax
    import jax.numpy as jnp
    import optax

    dtype = measured.dtype
    fixed = dict(fixed or {})
    p0 = jnp.log(jnp.asarray([init[key] for key in fit_keys], dtype))

    def loss_fn(p):
        params = dict(fixed)
        params.update({key: jnp.exp(p[i])
                       for i, key in enumerate(fit_keys)})
        r = forward(params) - measured
        return jnp.mean(r * r)

    p = p0
    history = []

    def emit(it, loss, p_at_loss):
        history.append(float(loss))
        if log is not None and (it % max(1, iters // 10) == 0
                                or it == iters - 1):
            vals = {key: float(jnp.exp(p_at_loss[i]))
                    for i, key in enumerate(fit_keys)}
            log(f"iter {it:4d} rms {float(loss)**0.5:.4g} K  " +
                " ".join(f"{key}={v:.5g}" for key, v in vals.items()))

    loss_jit = jax.jit(loss_fn)
    if optimizer == "lbfgs":
        opt = optax.lbfgs()
        state = opt.init(p)
        vg = optax.value_and_grad_from_state(loss_fn)

        @jax.jit
        def lbfgs_step(p, state):
            loss, g = vg(p, state=state)
            upd, state = opt.update(g, state, p, value=loss, grad=g,
                                    value_fn=loss_fn)
            return optax.apply_updates(p, upd), state, loss

        for it in range(iters):
            p_prev = p
            p, state, loss = lbfgs_step(p, state)
            emit(it, loss, p_prev)     # loss is evaluated at p_prev
    elif optimizer == "adam":
        # decay the step near the optimum (raw Adam in log-space oscillates
        # around the minimum at fixed lr)
        sched = optax.exponential_decay(lr, max(1, iters // 4), 0.5)
        opt = optax.adam(sched)
        state = opt.init(p)
        vg = jax.jit(jax.value_and_grad(loss_fn))
        for it in range(iters):
            loss, g = vg(p)
            emit(it, loss, p)
            upd, state = opt.update(g, state)
            p = optax.apply_updates(p, upd)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r} (lbfgs | adam)")
    history.append(float(loss_jit(p)))
    return ({key: float(jnp.exp(p[i])) for i, key in enumerate(fit_keys)},
            history)


def uncertainty(forward, measured, fitted, fit_keys, *, fixed=None):
    """Gauss-Newton (Laplace) 1-sigma uncertainties of the fitted values.

    J = d residuals / d params at the optimum (jax.jacfwd through the whole
    transient simulation — p <= 4 forward-mode passes); Cov = s^2 (J^T J)^-1
    with the noise variance s^2 estimated from the residual sum of squares
    over N - p degrees of freedom.  Returns {key: sigma}."""
    import jax
    import jax.numpy as jnp

    theta = jnp.asarray([fitted[key] for key in fit_keys], measured.dtype)
    fixed = dict(fixed or {})

    def residuals(th):
        params = dict(fixed)
        params.update({key: th[i] for i, key in enumerate(fit_keys)})
        return (forward(params) - measured).ravel()

    r = residuals(theta)
    J = jax.jacfwd(residuals)(theta)
    n, p = J.shape
    s2 = float(r @ r) / max(n - p, 1)
    cov = s2 * jnp.linalg.inv(J.T @ J)
    return {key: float(jnp.sqrt(cov[i, i]))
            for i, key in enumerate(fit_keys)}


def load_measured(spec: str, n_probes: int):
    """'@file.csv' with columns t, T_probe0, T_probe1, ... (comma/space
    separated, '#' comments).  Returns (times, (n_samples, n_probes))."""
    if not spec.startswith("@"):
        raise SystemExit("--measured expects @file.csv")
    rows = []
    with open(spec[1:]) as f:
        for ln in f:
            ln = ln.split("#")[0].strip().replace(",", " ")
            if ln:
                rows.append([float(x) for x in ln.split()])
    arr = np.asarray(rows, np.float64)
    if arr.ndim != 2 or arr.shape[1] != n_probes + 1:
        raise SystemExit(f"--measured needs {n_probes + 1} columns "
                         f"(t + {n_probes} probes); got shape {arr.shape}")
    return arr[:, 0], arr[:, 1:]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fit h/k/cp/emissivity to measured cooling curves "
                    "by adjoint")
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nz", type=int, default=12)
    p.add_argument("--dx_mm", type=float, default=2.0)
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0, help="initial guess")
    p.add_argument("--k", type=float, default=54.0, help="initial guess")
    p.add_argument("--h", type=float, default=20.0, help="initial guess")
    p.add_argument("--T0", type=float, default=900.0)
    p.add_argument("--T_inf", type=float, default=25.0)
    p.add_argument("--dt", type=float, default=0.5)
    p.add_argument("--n_steps", type=int, default=120)
    p.add_argument("--sample_every", type=int, default=4)
    p.add_argument("--fit", type=str, default="h",
                   help="comma subset of h,k,cp,eps to fit (rho is "
                        "degenerate with cp — only the product rho*cp "
                        "enters); non-fitted ones are held at their flag "
                        "values, and 'eps' enables radiation")
    p.add_argument("--measured", type=str, default=None,
                   help="@file.csv with t + one column per probe; omit to "
                        "synthesize from --true_*")
    p.add_argument("--true_h", type=float, default=45.0)
    p.add_argument("--true_k", type=float, default=None)
    p.add_argument("--true_cp", type=float, default=None)
    p.add_argument("--eps", type=float, default=0.3,
                   help="initial emissivity guess (used when 'eps' in --fit)")
    p.add_argument("--true_eps", type=float, default=None)
    p.add_argument("--uq", type=int, default=0,
                   help="report Gauss-Newton 1-sigma uncertainties")
    p.add_argument("--noise_K", type=float, default=0.0,
                   help="synthetic measurement noise sigma [K]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--lr", type=float, default=0.08, help="adam only")
    p.add_argument("--optimizer", choices=["lbfgs", "adam"],
                   default="lbfgs")
    p.add_argument("--out", type=str, default=None)
    return p


def run(args) -> dict:
    import jax.numpy as jnp

    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..io.logging import log

    dtype = jnp.result_type(float)
    grid = CartesianGrid(args.nx, args.ny, args.nz, args.dx_mm * 1e-3)
    mat = Material(args.rho, args.cp, args.k)
    probes = default_probes(grid.shape)
    forward = make_measurement_forward(
        grid, mat, probes, t0=args.T0, t_inf=args.T_inf, dt=args.dt,
        n_steps=args.n_steps, sample_every=args.sample_every, dtype=dtype)

    fit_keys = [s.strip() for s in args.fit.split(",") if s.strip()]
    bad = [key for key in fit_keys if key not in ("h", "k", "cp", "eps")]
    if bad:
        raise SystemExit(f"--fit accepts h,k,cp,eps; got {bad}")

    # non-fitted parameters are HELD at their flag values (a known film
    # while fitting k, etc.); radiation is active only when eps is fitted
    # or --true_eps marks it as part of the physics
    radiation = "eps" in fit_keys or args.true_eps is not None
    fixed = {key: jnp.asarray(v, dtype) for key, v in
             (("h", args.h), ("k", args.k), ("cp", args.cp))
             if key not in fit_keys}
    if radiation and "eps" not in fit_keys:
        fixed["eps"] = jnp.asarray(args.eps, dtype)

    if args.measured:
        n_samples = args.n_steps // args.sample_every
        times, measured = load_measured(args.measured, len(probes))
        if measured.shape[0] != n_samples:
            raise SystemExit(f"--measured has {measured.shape[0]} samples "
                             f"but the schedule produces {n_samples} "
                             f"(n_steps/sample_every)")
        expect = (np.arange(n_samples) + 1) * args.sample_every * args.dt
        if not np.allclose(times, expect, rtol=1e-6, atol=1e-9):
            raise SystemExit(
                "--measured time column does not match the simulation "
                f"sample grid (dt*sample_every = {args.dt*args.sample_every}"
                f" s): file starts {times[:3]}, expected {expect[:3]} — "
                "adjust --dt/--sample_every/--n_steps to the data")
        measured = jnp.asarray(measured, dtype)
    else:
        truth = {"h": args.true_h,
                 "k": args.true_k if args.true_k is not None else args.k,
                 "cp": args.true_cp if args.true_cp is not None else args.cp}
        if args.true_eps is not None or "eps" in fit_keys:
            truth["eps"] = (args.true_eps if args.true_eps is not None
                            else args.eps)
        log("synthesizing measurements from " +
            " ".join(f"{key}={v:g}" for key, v in truth.items()), tag="cal")
        measured = forward({key: jnp.asarray(v, dtype)
                            for key, v in truth.items()})
        if args.noise_K > 0.0:
            rng = np.random.default_rng(args.seed)
            measured = measured + jnp.asarray(
                rng.normal(0.0, args.noise_K, measured.shape), dtype)

    init = {"h": args.h, "k": args.k, "cp": args.cp, "eps": args.eps}
    fitted, history = fit(forward, measured, fit_keys, init,
                          iters=args.iters, lr=args.lr,
                          optimizer=args.optimizer, fixed=fixed,
                          log=lambda m: log(m, tag="cal"))
    result = {"fitted": fitted, "fit": fit_keys,
              "rms_final_K": history[-1] ** 0.5,
              "rms_initial_K": history[0] ** 0.5, "history": history}
    if args.uq:
        sig = uncertainty(forward, jnp.asarray(measured, dtype), fitted,
                          fit_keys, fixed=fixed)
        result["sigma"] = sig
        log("1-sigma: " + " ".join(f"{key}={fitted[key]:.5g}+-{s_:.3g}"
                                   for key, s_ in sig.items()), tag="cal")
    if not args.measured:
        result["truth"] = {key: truth[key] for key in fit_keys}
        for key in fit_keys:
            err = abs(fitted[key] - truth[key]) / truth[key]
            log(f"{key}: fitted {fitted[key]:.5g} vs truth {truth[key]:g} "
                f"({100 * err:.2f}% off)", tag="cal")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    from ..core.backend import configure_compile_cache

    configure_compile_cache()
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
