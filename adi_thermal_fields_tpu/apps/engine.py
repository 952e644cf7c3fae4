"""Event-driven simulation engine shared by the CLI apps.

Host orchestrates the event list (births U frames) — exactly the structure of
the reference's WAAM loop (waam_from_stl_v7_mm.py:515-551) — while everything
between events runs on device: `make_cartesian_advance` folds the functional
pack rebuild AND the sub-step loop into one jitted program
(``lax.fori_loop`` with a traced trip count, so event-aligned dt and varying
sub-step counts never retrace).  Births are pure data updates against a
precomputed activation-time field (birth/*.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..bc.packs import build_coeff_packs
from ..core.backend import resolve_implementation
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..step.cartesian import adi_step

__all__ = ["make_cartesian_engine", "make_cartesian_advance", "EventLoop",
           "stochastic_round"]

# host-readout reductions under jit: the reduced scalar is fully addressable
# even for multi-process sharded fields (XLA inserts the collective), where
# an eager jnp.max/isfinite on a multi-host array raises
_masked_max = jax.jit(lambda T, m: jnp.max(jnp.where(m, T, -jnp.inf)))
_masked_finite = jax.jit(
    lambda T, m: jnp.isfinite(jnp.where(m, T, 0.0)).all())


def history_update(pk, ta, T, dt, tc, multi):
    """One sub-step of the per-voxel thermal-history state: running peak
    and dt-weighted time-above-threshold (leading threshold axis on ``ta``
    when ``multi``).  The SINGLE definition of the history semantics —
    shared by the engine's fused advance loop and the spiral_tube app."""
    import jax.numpy as jnp

    pk = jnp.maximum(pk, T)
    if multi:
        above = T[None] > tc[(slice(None),) + (None,) * T.ndim]
    else:
        above = T > tc[0]
    ta = ta + jnp.asarray(dt, ta.dtype) * above
    return pk, ta


def stochastic_round(x: jax.Array, dtype, key: jax.Array) -> jax.Array:
    """Round ``x`` to ``dtype`` (bfloat16) stochastically: add 16 random
    bits below the bfloat16 mantissa of the float32 bit pattern, then
    truncate, so ``E[round(x)] = x``.  Round-to-nearest drops every
    per-step update smaller than half a bfloat16 quantum (~4 K at 900 C),
    which freezes slow cooling; unbiased rounding keeps it.  ``key`` is a
    ``jax.random`` key (the engine folds in the integer step counter)."""
    if jnp.dtype(dtype) != jnp.bfloat16:
        raise ValueError(f"stochastic rounding targets bfloat16 states, "
                         f"not {jnp.dtype(dtype)}")
    bits = lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    noise = jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF)
    kept = (bits + noise) & jnp.uint32(0xFFFF0000)
    return lax.bitcast_convert_type(kept, jnp.float32).astype(jnp.bfloat16)


def make_cartesian_engine(grid: CartesianGrid, mat: Material, *,
                          theta: float = 0.5, t_inf: float = 20.0,
                          robin_h=None, neumann=None,
                          dirichlet_mask=None, dirichlet_value=None,
                          source_fn=None, implementation: str = "auto",
                          mesh=None, dtype=None, interpret: bool = False,
                          history_t_crit: float | None = None,
                          stochastic_rounding: bool = False,
                          k_table=None, cp_table=None, emissivity=None,
                          radiation_scale=None):
    """Split engine: ``prepare(active) -> prep`` (jitted pack rebuild,
    needed only when the mask changes — i.e. on birth events) and
    ``advance(T, prep, dt, n_sub[, t0]) -> T`` (jitted sub-step loop).

    The reference rebuilds BC packs inside every time segment (per *column*
    in single_track_on_plate.py:163); splitting keeps the rebuild off the
    steady-state critical path for large grids.

    source_fn: optional traceable ``t -> volumetric heat field [W/m^3]``.
    implementation: the tridiagonal solver tier (core/backend.py): "pallas"
    (the Triton kernel), "xla" (``lax.scan``), or "auto" (the kernel on a
    GPU, the scan on the CPU).  interpret: run the kernel in the Pallas
    interpreter (CPU tests of the "pallas" tier).
    mesh: optional ``jax.sharding.Mesh`` — prepare and advance then run
    multi-chip with per-sweep batch-axis layouts (dist/cartesian.py).  The
    sharded sweeps solve with the scan (a Pallas call has no partitioning
    rule), so ``implementation="pallas"`` with a mesh raises.
    dtype: state dtype the packs are built for (defaults to the default
    float dtype; pass explicitly for other precisions).  A sub-float32
    state (bfloat16) is a STORAGE format: every sub-step solves in float32
    and rounds the result back to the state dtype once.
    stochastic_rounding: for bfloat16 states, round that store
    stochastically (``stochastic_round``, random bits from ``jax.random``
    seeded per sub-step from the integer step counter).  ESSENTIAL for long
    bf16 runs: round-to-nearest silently drops per-step updates smaller
    than the bf16 quantum (~8 K at 1500 C), freezing slow cooling entirely.
    Not differentiable.
    history_t_crit: enable per-voxel THERMAL-HISTORY tracking — the advance
    signature becomes ``advance(T, prep, dt, n_sub, t0, hist) -> (T, hist)``
    with ``hist = (T_peak, t_above)`` updated every sub-step: running peak
    temperature and cumulative seconds above ``history_t_crit``.  A tuple of
    thresholds tracks each: ``t_above`` then has a leading threshold axis,
    e.g. ``(800.0, 500.0)`` yields the classic steel t8/5 cooling time as
    ``t_above[1] - t_above[0]`` for monotone cooling (the inputs
    to microstructure/HAZ estimates in WAAM).  Elementwise updates fused
    into the sub-step loop; EventLoop(history=True) threads the state and
    RESETS a cell's history at its birth (pre-birth placeholder values are
    meaningless).  NEVER-born cells still accumulate from their placeholder
    temperatures — consumers must mask by the final active state (the WAAM
    app writes them as 0 in waam_history.vtk).

    VARIABLE-PROPERTY PHYSICS (the regime that dominates real WAAM at
    1500 C; library: step/cartesian_varprop.py, bc/radiation.py):
    k_table / cp_table: T-dependent conductivity / heat capacity
    (PropertyTable, scalar, or a per-axis k 3-tuple).  Use
    ``apparent_cp(...)`` for latent heat and ``melt_pool_enhanced_k(...)``
    for the melt-pool convection proxy.
    emissivity: enable the radiative boundary film
    ``h_rad(T) = eps*sigma*(T+T_inf)(T^2+T_inf^2)`` in ADDITION to the
    convective ``robin_h`` (Picard-refreshed every SUB-STEP from the
    live field — tighter than the per-segment refresh of
    make_cartesian_advance(robin_h_fn=...)).  ``robin_h`` may be a scalar,
    a per-face dict or a 3-D field — e.g. the STL area-corrected fields
    (geometry/bc_correction.py) — and the total film is
    ``robin_h + h_rad(T) * radiation_scale``.
    radiation_scale: per-face dict (or field) of true/voxel area ratios
    applied to the RADIATIVE film — pass ``corrected_robin_fields``'s
    second output so radiation sees the same geometric-area correction as
    the corrected convective fields (the reference's contract is that
    corrected Robin output is simply another h field flowing through the
    unified machinery, voxel_bc_correction.py:207-225).  Requires
    ``emissivity``; defaults to 1 (uncorrected radiation).
    Any of these switches the engine onto the varprop step."""
    import jax.numpy as jnp

    if mesh is not None and implementation == "pallas":
        raise ValueError("implementation='pallas' has no sharded tier: "
                         "a mesh runs the scan solver")
    impl = ("xla" if mesh is not None
            else resolve_implementation(implementation, interpret))
    state_dtype = jnp.dtype(dtype or jnp.result_type(float))
    # sub-f32 states are a storage format: solve (and build packs) at f32
    pack_dtype = jnp.promote_types(state_dtype, jnp.float32)
    if stochastic_rounding and state_dtype.itemsize < 4 \
            and state_dtype != jnp.bfloat16:
        raise ValueError("stochastic_rounding supports bfloat16 states only")
    solver = dict(implementation=impl, interpret=interpret)

    # Field-valued BC data travel as jit ARGUMENTS inside ``prep``: arrays
    # closed over by a jitted function are embedded in its program as
    # constants (GBs at production size).  Scalars and None stay static.
    bc_leaves, bc_tree = jax.tree_util.tree_flatten(dict(
        robin_h=robin_h, neumann=neumann, dirichlet_mask=dirichlet_mask,
        dirichlet_value=dirichlet_value, radiation_scale=radiation_scale))
    bc_is_arr = [isinstance(v, (jax.Array, np.ndarray)) for v in bc_leaves]
    bc_arrays = [v for v, a in zip(bc_leaves, bc_is_arr) if a]

    def _bc(arrays):
        it = iter(arrays)
        return bc_tree.unflatten([next(it) if a else v
                                  for v, a in zip(bc_leaves, bc_is_arr)])

    def _packs(active, bc, h=None):
        return build_coeff_packs(
            active, grid, mat,
            robin_h=bc["robin_h"] if h is None else h,
            neumann=bc["neumann"], dirichlet_mask=bc["dirichlet_mask"],
            dirichlet_value=bc["dirichlet_value"], dtype=pack_dtype)

    varprop = (k_table is not None or cp_table is not None
               or emissivity is not None)
    if radiation_scale is not None and emissivity is None:
        raise ValueError("radiation_scale scales the RADIATIVE film and "
                         "therefore requires emissivity; for a corrected "
                         "convective film pass the corrected h fields as "
                         "robin_h")
    if mesh is not None:
        from jax.sharding import NamedSharding

        from ..dist.cartesian import _spec_for_sweep
        am, bm = mesh.axis_names

        def sweep_layout(x, axis):
            """Shard the two batch axes of ``axis``'s sweep (solve axis
            device-local)."""
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, _spec_for_sweep(axis, am, bm)))

        constrain = lambda x: sweep_layout(x, 0)
    else:
        sweep_layout = None
        constrain = (lambda x: x)

    if varprop:
        from ..bc.radiation import radiative_h
        from ..step.cartesian_varprop import adi_step_varprop

        scalar_conv = robin_h is None or isinstance(robin_h, (int, float))
        h_conv = (float(robin_h or 0.0)
                  if emissivity is not None and scalar_conv else None)

        def _compose_h(T, bc):
            """Total Robin film entering this sub-step's packs: convective
            (per-face dict or 3-D field, e.g. the STL area-corrected
            fields) plus the Picard radiative film, itself scaled by the
            per-face true/voxel area ratios when given — radiation sees
            the same geometric correction as convection."""
            h_rad = radiative_h(T, emissivity, t_inf,
                                h_conv=0.0 if h_conv is None else h_conv)
            rh, rs = bc["robin_h"], bc["radiation_scale"]
            if scalar_conv:
                return h_rad
            if isinstance(rh, dict):
                sc = rs or {}
                return {f: v + h_rad * sc.get(f, 1.0) for f, v in rh.items()}
            return rh + h_rad * (1.0 if rs is None else rs)

        @jax.jit
        def _prepare(active, arrays):
            active = active.astype(bool)
            # radiation rebuilds packs per sub-step from the live field;
            # otherwise they depend on the mask only
            packs = (None if emissivity is not None
                     else _packs(active, _bc(arrays)))
            return (active, packs, arrays)

        def step1(T, prep, dt, t, istep):
            active, packs, arrays = prep
            T = constrain(T)
            if emissivity is not None:
                bc = _bc(arrays)
                packs = _packs(active, bc, h=_compose_h(T, bc))
            src = None if source_fn is None else source_fn(t)
            return constrain(adi_step_varprop(
                T, active, packs, grid, mat, k_table=k_table,
                cp_table=cp_table, dt=dt, theta=theta, t_inf=t_inf,
                source=src, constrain=sweep_layout, **solver))

    elif mesh is not None:
        from ..dist.cartesian import sharded_adi_step

        inner = sharded_adi_step(grid, mat, mesh, theta=theta)

        @jax.jit
        def _prepare(active, arrays):
            active = active.astype(bool)
            return (active, _packs(active, _bc(arrays)))

        def step1(T, prep, dt, t, istep):
            active, packs = prep
            src = None if source_fn is None else source_fn(t)
            return inner(T, active, packs, dt, jnp.asarray(t_inf, T.dtype),
                         src)

    else:
        @jax.jit
        def _prepare(active, arrays):
            active = active.astype(bool)
            return (active, _packs(active, _bc(arrays)))

        def step1(T, prep, dt, t, istep):
            active, packs = prep
            src = None if source_fn is None else source_fn(t)
            return adi_step(T, active, packs, grid, mat, dt=dt,
                            theta=theta, t_inf=t_inf, source=src, **solver)

    def prepare(active):
        return _prepare(active, bc_arrays)

    if state_dtype.itemsize < 4:
        # storage-format state: one f32 solve per sub-step, one rounding
        step_f32 = step1
        key0 = jax.random.key(0)

        def step1(T, prep, dt, t, istep):
            x = step_f32(T.astype(pack_dtype), prep,
                         jnp.asarray(dt, pack_dtype), t, istep)
            if stochastic_rounding:
                return stochastic_round(x, T.dtype,
                                        jax.random.fold_in(key0, istep))
            return x.astype(T.dtype)

    # one advance builder for all branches: fori over step1, optional
    # thermal-history fusion
    def _clock(state_dtype, dt, t0):
        """Sub-step clock OUTSIDE the state dtype.  At bf16 (8-bit mantissa)
        t, dt and i quantize: past step ~256 whole plateaus of sub-steps saw
        the identical time — and the identical t/dt-derived rounding seed,
        re-correlating the stochastic rounding the mode depends on.  Returns
        ``i -> (t_i, istep_i)`` with t_i at >=f32 and istep_i an int32
        counter offset by the segment's global step index."""
        tdt = jnp.promote_types(state_dtype, jnp.float32)
        t0f = jnp.asarray(t0, tdt)
        dtf = jnp.asarray(dt, tdt)
        base = jnp.asarray(jnp.round(t0f / dtf), jnp.int32)
        return lambda i: (t0f + i * dtf, base + i)

    if history_t_crit is None:
        @jax.jit
        def advance(T, prep, dt, n_sub, t0=0.0):
            clock = _clock(T.dtype, dt, t0)

            def body(i, T):
                return step1(T, prep, dt, *clock(i))

            return lax.fori_loop(0, n_sub, body, T)
    else:
        multi = isinstance(history_t_crit, (tuple, list))
        t_crits = tuple(float(t) for t in (history_t_crit if multi
                                           else (history_t_crit,)))

        @jax.jit
        def advance(T, prep, dt, n_sub, t0=0.0, hist=None):
            # ta carries a leading threshold axis in multi mode
            tc = jnp.asarray(t_crits, jnp.promote_types(T.dtype, jnp.float32))
            clock = _clock(T.dtype, dt, t0)

            def body(i, carry):
                T, pk, ta = carry
                T = step1(T, prep, dt, *clock(i))
                pk, ta = history_update(pk, ta, T, dt, tc, multi)
                return (T, pk, ta)

            T, pk, ta = lax.fori_loop(0, n_sub, body, (T,) + tuple(hist))
            return T, (pk, ta)

    # plain-function wrapper so EventLoop can introspect the engine's
    # configuration (jitted callables reject attribute assignment)
    _advance = advance

    def advance(*a, **k):
        return _advance(*a, **k)

    # ahead-of-time lowering of the jitted loop (memory_analysis, cost)
    advance.lower = _advance.lower

    # EventLoop reads this to size the t_above state — avoids having to
    # specify the threshold tuple twice
    advance.history_thresholds = (t_crits if history_t_crit is not None
                                  and multi else None)
    # EventLoop(interpass_T=...) refuses engines with a continuous source:
    # the torch would keep burning at the frozen schedule time during dwell
    advance.has_source = source_fn is not None

    return prepare, advance


def make_cartesian_advance(grid: CartesianGrid, mat: Material, *,
                           theta: float = 0.5, t_inf: float = 20.0,
                           robin_h=None, neumann=None,
                           dirichlet_mask=None, dirichlet_value=None,
                           source_fn=None, implementation: str = "auto",
                           mesh=None, robin_h_fn=None):
    """Fused convenience form: ``advance(T, active, dt, n_sub[, t0]) -> T``
    rebuilds packs for the current activation mask on every call, then takes
    ``n_sub`` ADI steps.  Prefer make_cartesian_engine + EventLoop(prepare=…)
    for large grids — the rebuild then happens on birth events only.

    robin_h_fn: optional traceable ``T -> h`` (scalar | face dict | field)
    giving a temperature-dependent film — e.g. radiation via
    ``bc.radiation.radiative_h`` — evaluated at the field entering each
    advance call (Picard refresh per event segment).  Replaces ``robin_h``;
    fold any constant convective film in via its ``h_conv`` argument."""
    cache = {}

    def advance(T, active, dt, n_sub, t0=0.0):
        key = T.dtype                      # packs follow the field dtype
        if key not in cache:
            if robin_h_fn is None:
                prepare, advance2 = make_cartesian_engine(
                    grid, mat, theta=theta, t_inf=t_inf, robin_h=robin_h,
                    neumann=neumann, dirichlet_mask=dirichlet_mask,
                    dirichlet_value=dirichlet_value, source_fn=source_fn,
                    implementation=implementation, mesh=mesh, dtype=key)
                cache[key] = jax.jit(
                    lambda T, active, dt, n_sub, t0=0.0:
                    advance2(T, prepare(active), dt, n_sub, t0))
            else:
                # T-dependent film: rebuild the engine's prep WITH the field
                @jax.jit
                def fused(T, active, dt, n_sub, t0=0.0, *, _key=key):
                    prepare, advance2 = make_cartesian_engine(
                        grid, mat, theta=theta, t_inf=t_inf,
                        robin_h=robin_h_fn(T), neumann=neumann,
                        dirichlet_mask=dirichlet_mask,
                        dirichlet_value=dirichlet_value, source_fn=source_fn,
                        implementation=implementation, mesh=mesh, dtype=_key)
                    return advance2(T, prepare(active), dt, n_sub, t0)

                cache[key] = fused
        return cache[key](T, active, dt, n_sub, t0)

    return advance


@dataclasses.dataclass
class EventLoop:
    """Run an element-birth simulation through its event schedule.

    advance : jitted (T, active, dt, n_sub) -> T; with ``prepare`` set, the
        signature is (T, prep, dt, n_sub, t0) and ``prepare(active) -> prep``
        is called only when the mask changes (birth events) — the pack/plan
        rebuild then leaves the steady-state critical path entirely.
    activation_times : device array broadcastable to the field shape;
        cell born when ``activation_times < t`` (substrate = -inf).
    deposit_T : temperature assigned to newborn cells.
    dt_cap : max sub-step (event segments are split evenly to respect it,
        waam_from_stl_v7_mm.py:526-528).
    check_finite : raise on NaN/Inf with simulation context.  The check
        syncs device->host, so it runs at frame boundaries and the final
        event (not per event) — birth bookkeeping itself is sync-free.
    history : thread per-voxel thermal-history state (requires an advance
        built with ``make_cartesian_engine(history_t_crit=...)`` and
        ``prepare``); after ``run`` the (T_peak, t_above) arrays are in
        ``self.history_state``.  Newborn deposits register their deposit
        temperature in the peak.
    interpass_T : optional INTERPASS TEMPERATURE CONTROL [C] — before each
        birth event the loop holds deposition and keeps cooling the current
        part in ``interpass_dwell``-second increments until its maximum
        temperature drops to this threshold (or ``interpass_max_dwell``
        seconds of dwell accrue), the standard WAAM practice for
        controlling bead geometry and microstructure.  Dwell cooling is
        inserted ON TOP of the print schedule (the schedule clock and
        activation times are unchanged); per-layer dwells are recorded in
        ``self.dwell_log`` as (event_time, dwell_seconds).  One
        device->host sync per dwell check per layer.  Meant for
        deposition-driven heating only: ``run`` raises when the advance
        was built with a continuous ``source_fn`` (the torch would keep
        burning at the frozen schedule time during the dwell).
    """

    advance: Callable
    activation_times: Any
    deposit_T: float
    dt_cap: float
    check_finite: bool = True
    prepare: Callable | None = None
    history: bool = False
    history_state: Any = None
    history_thresholds: tuple | None = None   # set for multi-threshold mode
    interpass_T: float | None = None
    interpass_dwell: float = 5.0
    interpass_max_dwell: float = 600.0
    dwell_log: Any = None

    def run(self, T, *, frame_times, t_end: float | None = None,
            on_frame: Callable | None = None, extra_events=(),
            start_t: float = 0.0, history_state=None):
        """``history_state``: optional (T_peak, t_above) to resume
        thermal-history accumulation from (checkpoint restore); default
        seeds the peak from the entering field and zero time-above."""
        act = self.activation_times
        eps = 1e-12
        # NOTE inclusive comparisons against event times throughout: event
        # times come from act's own (often float32) values, and `act < te +
        # 1e-12` is FALSE for act == te in f32 (the epsilon vanishes in the
        # cast) — with strict compares every layer activated one event late
        # and the final layer never deposited at all.
        finite = jnp.isfinite(act) & (act >= start_t)
        births = jnp.unique(jnp.where(finite, act, jnp.inf))
        births = [float(b) for b in births if math.isfinite(float(b))]
        frame_times = [float(t) for t in frame_times]
        t_end = t_end if t_end is not None else (max(frame_times) if frame_times else 0.0)
        # tolerate float32 rounding of a birth time landing a hair above the
        # (float64) t_end — that layer must still deposit
        birth_set = set(b for b in births
                        if b <= t_end + 1e-6 * max(1.0, abs(t_end)))
        events = sorted(birth_set | set(frame_times) | set(extra_events)
                        | {t_end})
        frames = set(frame_times)
        final_event = events[-1] if events else None

        if self.interpass_T is not None and self.interpass_dwell <= 0:
            raise ValueError("interpass_dwell must be positive (a zero or "
                             "negative increment would dwell forever)")
        if self.interpass_T is not None and getattr(self.advance,
                                                    "has_source", False):
            raise ValueError(
                "interpass_T cannot be combined with a continuous source_fn: "
                "during the dwell the engine keeps evaluating the source at "
                "the frozen schedule time (the torch never switches off), so "
                "the part may never cool to the threshold.  Model deposition "
                "heating via birth deposits (deposit_T) when using interpass "
                "control")
        t = start_t
        active = act <= t
        # layers whose birth time coincides with the start are deposited now
        born_now = active & jnp.isfinite(act) & (act >= start_t)
        T = jnp.where(born_now, self.deposit_T, T)
        active_any = bool(jnp.any(active))     # one sync at start only
        prep = (self.prepare(jnp.broadcast_to(active, T.shape))
                if self.prepare is not None else None)
        if self.history:
            if prep is None:
                raise ValueError("EventLoop(history=True) requires prepare + "
                                 "an advance from make_cartesian_engine("
                                 "history_t_crit=...)")
            # t_above accumulates many small dt increments — keep it at
            # solve precision even for bf16 states (bf16's 8-bit mantissa
            # absorbs increments after ~256 steps).  With a tuple of
            # thresholds it carries a leading threshold axis.
            if history_state is not None:
                self.history_state = history_state
            else:
                ths = (self.history_thresholds
                       if self.history_thresholds is not None
                       else getattr(self.advance, "history_thresholds", None))
                nth = len(ths) if ths else None
                ta_shape = T.shape if nth is None else (nth,) + tuple(T.shape)
                self.history_state = (T, jnp.zeros(
                    ta_shape, jnp.promote_types(T.dtype, jnp.float32)))
        if t in frames and on_frame is not None:
            on_frame(t, T, jnp.broadcast_to(active, T.shape))

        def check(t):
            if not bool(_masked_finite(T, jnp.broadcast_to(active, T.shape))):
                raise FloatingPointError(
                    f"non-finite temperature detected at t={t:.6g} s "
                    f"(dt_cap={self.dt_cap:.3g}; check material/BC magnitudes)")

        for te in events:
            if te <= t + eps:
                continue
            seg = te - t
            if active_any:
                n_sub = max(1, int(math.ceil(seg / self.dt_cap)))
                dt = seg / n_sub
                if self.history:
                    T, self.history_state = self.advance(
                        T, prep, jnp.asarray(dt, T.dtype),
                        jnp.asarray(n_sub, jnp.int32),
                        jnp.asarray(t, T.dtype), self.history_state)
                elif prep is not None:
                    T = self.advance(T, prep, jnp.asarray(dt, T.dtype),
                                     jnp.asarray(n_sub, jnp.int32),
                                     jnp.asarray(t, T.dtype))
                else:
                    T = self.advance(T, jnp.broadcast_to(active, T.shape),
                                     jnp.asarray(dt, T.dtype),
                                     jnp.asarray(n_sub, jnp.int32),
                                     jnp.asarray(t, T.dtype))
            t = te
            if te in birth_set:
                if self.interpass_T is not None and active_any:
                    dwell = 0.0
                    n_dw = max(1, int(math.ceil(self.interpass_dwell
                                                / self.dt_cap)))
                    dt_dw = self.interpass_dwell / n_dw
                    act_b = jnp.broadcast_to(active, T.shape)
                    while dwell < self.interpass_max_dwell:
                        tmax = float(_masked_max(T, act_b))
                        if tmax <= self.interpass_T:
                            break
                        if self.history:
                            T, self.history_state = self.advance(
                                T, prep, jnp.asarray(dt_dw, T.dtype),
                                jnp.asarray(n_dw, jnp.int32),
                                jnp.asarray(t, T.dtype), self.history_state)
                        elif prep is not None:
                            T = self.advance(T, prep,
                                             jnp.asarray(dt_dw, T.dtype),
                                             jnp.asarray(n_dw, jnp.int32),
                                             jnp.asarray(t, T.dtype))
                        else:
                            T = self.advance(T, act_b,
                                             jnp.asarray(dt_dw, T.dtype),
                                             jnp.asarray(n_dw, jnp.int32),
                                             jnp.asarray(t, T.dtype))
                        dwell += self.interpass_dwell
                    if dwell > 0.0:
                        if self.dwell_log is None:
                            self.dwell_log = []
                        self.dwell_log.append((te, dwell))
                new_active = act <= t
                newborn = new_active & ~active
                T = jnp.where(newborn, self.deposit_T, T)
                if self.history:
                    # newborn history STARTS at deposit: void cells carry
                    # placeholder temperatures through the solver's identity
                    # rows, so anything accumulated pre-birth is bogus
                    pk, ta = self.history_state
                    pk = jnp.where(newborn, T, jnp.maximum(pk, T))
                    ta = jnp.where(newborn, 0.0, ta)  # broadcasts over axis 0
                    self.history_state = (pk, ta)
                active = new_active
                active_any = True          # a birth event implies new cells
                if self.prepare is not None:
                    prep = self.prepare(jnp.broadcast_to(active, T.shape))
            if self.check_finite and (te in frames or te == final_event):
                check(t)
            if te in frames and on_frame is not None:
                on_frame(t, T, jnp.broadcast_to(active, T.shape))
        return T, active, t
