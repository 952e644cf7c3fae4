"""WAAM deposition from an STL model (flagship CLI app).

Pipeline (mirrors reference waam_from_stl_v7_mm.py:375-622, rebuilt as
jitted JAX programs): STL (mm) -> native voxelization + solidify -> z-slab layer
extraction -> per-layer print-time estimate from slab area / bead width /
scan speed -> event-driven ADI loop with element birth (device-resident
sub-stepping; functional pack rebuild, no recompilation per birth) -> VTK
frame series + npz checkpoints + optional interactive viewer.

Extras over the reference: optional STL projected-area Robin correction
(--corrected_bc, geometry/bc_correction.py) and checkpoint/resume
(--checkpoint/--resume).  CLI units: mm; SI internally.

Example:
    python -m adi_thermal_fields_tpu.apps.waam_from_stl --stl part.stl \
        --dx_mm 1.0 --save_vtk 1 --outdir out/
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WAAM thermal simulation from STL")
    p.add_argument("--stl", type=str, required=True)
    p.add_argument("--dx_mm", type=float, default=1.0)
    p.add_argument("--dz_mm", type=float, default=None,
                   help="vertical (layer-direction) voxel size [mm]; "
                        "default dx_mm.  Anisotropic voxels resolve thin "
                        "layers without cubing the cell count")
    p.add_argument("--pad_mm", type=float, default=2.0)
    p.add_argument("--voxel_method", choices=["parity", "shell"], default="parity")
    p.add_argument("--auto_dx", type=int, default=1)
    p.add_argument("--max_voxels", type=int, default=12_000_000)
    p.add_argument("--solidify", choices=["auto", "fill", "close_flood", "none"],
                   default="auto")
    p.add_argument("--solid_close_iters", type=int, default=1)
    # material
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=54.0)
    # process
    p.add_argument("--bead_height_mm", type=float, default=2.0)
    p.add_argument("--bead_width_mm", type=float, default=6.0)
    p.add_argument("--scan_speed_mm_s", type=float, default=8.0)
    p.add_argument("--eta_fill", type=float, default=1.0)
    p.add_argument("--layer_times_s", type=str, default=None,
                   help="MEASURED per-layer print durations [s] instead of "
                        "the slab-area estimate: a comma list "
                        "('12.5,13.1,...') or '@file' with one duration per "
                        "line (e.g. from the slicer/G-code); the count must "
                        "match the extracted layer count")
    # BCs
    p.add_argument("--h_side", type=float, default=30.0)
    p.add_argument("--T_inf", type=float, default=20.0)
    p.add_argument("--Ts", type=float, default=1500.0)
    p.add_argument("--corrected_bc", type=int, default=0,
                   help="1: STL projected-area Robin correction")
    p.add_argument("--emissivity", type=float, default=0.0,
                   help="surface emissivity: adds the radiative film "
                        "h_rad(T) = eps*sigma*(T+T_inf)(T^2+T_inf^2) on top "
                        "of --h_side, Picard-refreshed every sub-step.  At "
                        "WAAM deposit temperatures radiation dominates "
                        "convection (0.3-0.8 for steel/Ti)")
    # variable-property physics (step/cartesian_varprop.py)
    p.add_argument("--latent_J_kg", type=float, default=0.0,
                   help="latent heat of fusion [J/kg] via the apparent-cp "
                        "enthalpy method over --solidus_C..--liquidus_C "
                        "(steel ~2.7e5)")
    p.add_argument("--solidus_C", type=float, default=1420.0)
    p.add_argument("--liquidus_C", type=float, default=1470.0)
    p.add_argument("--cp_liquid", type=float, default=None,
                   help="liquid-phase cp [J/kg/K]; default = --cp")
    p.add_argument("--melt_k_factor", type=float, default=1.0,
                   help="melt-pool convection proxy: conductivity "
                        "enhancement above the liquidus (2-10x typical; 1 "
                        "disables)")
    # numerics
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--cfl", type=float, default=2.0)
    p.add_argument("--precision", choices=["float32", "float64", "bfloat16"],
                   default="float32",
                   help="bfloat16 = storage mode (f32 solve, stochastic "
                        "rounding of every bf16 store)")
    # output
    p.add_argument("--nframes", type=int, default=12)
    p.add_argument("--save_vtk", type=int, default=0)
    p.add_argument("--vtk_format", choices=["auto", "ascii", "binary"],
                   default="auto",
                   help="auto = binary above 2M cells (6x smaller, 30x "
                        "faster), ascii below (reference parity)")
    p.add_argument("--outdir", type=str, default="waam_out")
    p.add_argument("--checkpoint", type=str, default="",
                   help="write a resume checkpoint at every frame")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a checkpoint file")
    p.add_argument("--t_hold_s", type=float, default=0.0,
                   help="extra cool-down time simulated after the last "
                        "layer finishes printing [s] (like single_track's "
                        "--t_tail)")
    p.add_argument("--interpass_T", type=float, default=None,
                   help="interpass temperature control [C]: dwell (keep "
                        "cooling) before each layer until the part's max "
                        "temperature drops below this, as on a real WAAM "
                        "cell; dwell increments/cap via --interpass_dwell_s "
                        "/ --interpass_max_dwell_s")
    p.add_argument("--interpass_dwell_s", type=float, default=5.0)
    p.add_argument("--interpass_max_dwell_s", type=float, default=600.0)
    p.add_argument("--history_t_crit", type=str, default=None,
                   help="track per-voxel thermal history: peak temperature "
                        "and seconds above the critical temperature(s) [C]; "
                        "comma-separated list tracks each (e.g. '800,500' "
                        "gives the steel t8/5 as t_above_500 - t_above_800); "
                        "written as T_peak / t_above fields in a final "
                        "history VTK (microstructure/HAZ inputs)")
    p.add_argument("--viewer", type=int, default=0)
    p.add_argument("--mesh", type=str, default="",
                   help="shard over a PxQ device mesh, e.g. '2x4' "
                        "(multi-chip; batch axes of every sweep sharded)")
    return p


def load_voxels(args):
    """STL -> solid voxel mask (+ origin, per-axis spacing in meters,
    mesh)."""
    from ..geometry.morphology import solidify_mask
    from ..geometry.stl import load_stl
    from ..geometry.voxelize import (auto_cell_size, grid_from_mesh,
                                     voxelize_shell, voxelize_solid)
    from ..io.logging import log

    mesh = load_stl(args.stl, units="auto")
    dx = args.dx_mm * 1e-3
    dz_fixed = args.dz_mm * 1e-3 if args.dz_mm is not None else None
    if args.auto_dx:
        dx2 = auto_cell_size(mesh, dx, args.max_voxels, dz=dz_fixed)
        if dx2 != dx:
            log(f"auto-dx: {dx * 1e3:.3g} -> {dx2 * 1e3:.3g} mm to fit "
                f"{args.max_voxels} voxel budget", tag="vox")
            dx = dx2
    dz = dz_fixed if dz_fixed is not None else dx
    d = (dx, dx, dz)
    # per-axis pad cell counts so --pad_mm means the same physical margin
    # on every axis (dz-thin slabs need proportionally more cells)
    pad = tuple(max(1, int(round(args.pad_mm * 1e-3 / dv))) for dv in d)
    origin, dims = grid_from_mesh(mesh, d, pad_cells=pad)
    if args.voxel_method == "parity":
        mask, _ = voxelize_solid(mesh, d, origin=origin, dims=dims)
    else:
        mask, _ = voxelize_shell(mesh, d, origin=origin, dims=dims)
    mask = solidify_mask(mask, mode=args.solidify,
                         closing_iters=args.solid_close_iters)
    log(f"grid {dims}, dx={dx * 1e3:.4g} mm"
        + (f", dz={dz * 1e3:.4g} mm" if dz != dx else "")
        + f", solid {int(mask.sum())} voxels "
        f"({mask.mean() * 100:.1f}%)", tag="vox")
    return mesh, mask, origin, d


def extract_layers(mask: np.ndarray, cells_per_layer: int):
    """Z-slab layers (ks, ke) covering the solid
    (waam_from_stl_v7_mm.py:437-456)."""
    k_idx = np.nonzero(mask.any(axis=(0, 1)))[0]
    if k_idx.size == 0:
        raise RuntimeError("voxelized model is empty")
    kmin, kmax = int(k_idx.min()), int(k_idx.max())
    layers = []
    ks = kmin
    while ks <= kmax:
        while ks <= kmax and not mask[:, :, ks].any():
            ks += 1
        if ks > kmax:
            break
        ke = min(kmax, ks + cells_per_layer - 1)
        while ke >= ks and not mask[:, :, ke].any():
            ke -= 1
        if ke < ks:
            ks += 1
            continue
        layers.append((ks, ke))
        ks = ke + 1
    return layers


def parse_layer_times(spec: str) -> list:
    """Per-layer print durations [s] from a comma list or '@file' (one
    duration per line; blank lines and '#' comments ignored)."""
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            items = [ln.split("#")[0].strip() for ln in f]
        items = [x for x in items if x]
    else:
        items = [x.strip() for x in spec.split(",") if x.strip()]
    durations = [float(x) for x in items]
    bad = [d for d in durations if not (d > 0.0)]
    if bad:
        raise SystemExit(f"--layer_times_s durations must be positive; "
                         f"got {bad[:3]}")
    return durations


def layer_birth_times(mask, layers, dx, bead_width_m, scan_speed_m_s,
                      eta_fill):
    """Cumulative print-time estimate per layer from mean slab area
    (waam_from_stl_v7_mm.py:459-476)."""
    times = []
    t = 0.0
    a_pix = dx * dx
    for ks, ke in layers:
        areas = [float(mask[:, :, k].sum()) * a_pix for k in range(ks, ke + 1)]
        A = float(np.mean(areas)) if areas else 0.0
        L_est = (A / max(bead_width_m, 1e-12)) * max(eta_fill, 1.0)
        t += L_est / max(scan_speed_m_s, 1e-12)
        times.append(t)
    return times


def run(args) -> dict:
    import jax.numpy as jnp

    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..io.logging import fmt_bytes, log
    from .engine import EventLoop, make_cartesian_engine

    os.makedirs(args.outdir, exist_ok=True)
    mesh, mask_full, origin, d = load_voxels(args)
    if getattr(args, "mesh", ""):
        # the fields are placed in the x-sweep layout (y over the mesh's
        # first axis, z over its second): extend the grid at its high ends
        # with void cells (identity rows, inert) until those axes divide
        p_, q_ = (int(v) for v in args.mesh.lower().split("x"))
        _, ny_, nz_ = mask_full.shape
        ext = [(0, 0), (0, -ny_ % p_), (0, -nz_ % q_)]
        if any(e for _, e in ext):
            mask_full = np.pad(mask_full, ext)
            log(f"grid padded with void to {mask_full.shape} for the "
                f"{args.mesh} mesh", tag="mesh")
    dx, _, dz = d
    nx, ny, nz = mask_full.shape
    grid = CartesianGrid(nx, ny, nz, dx, dz=dz)
    mat = Material(args.rho, args.cp, args.k)

    dtype = {"float32": jnp.float32, "float64": jnp.float64,
             "bfloat16": jnp.bfloat16}[args.precision]
    bytes_T = grid.ncells * jnp.dtype(dtype).itemsize
    log(f"field memory ~{fmt_bytes(bytes_T)} + mask {fmt_bytes(grid.ncells)}",
        tag="mem")

    n_per_layer = max(1, int(round(args.bead_height_mm * 1e-3 / dz)))
    layers = extract_layers(mask_full, n_per_layer)
    if getattr(args, "layer_times_s", None):
        durations = parse_layer_times(args.layer_times_s)
        if len(durations) != len(layers):
            raise SystemExit(
                f"--layer_times_s supplies {len(durations)} durations but "
                f"{len(layers)} layers were extracted (bead_height "
                f"{args.bead_height_mm} mm over {dz*1e3:g} mm voxels)")
        births = list(np.cumsum(durations))
    else:
        births = layer_birth_times(mask_full, layers, dx,
                                   args.bead_width_mm * 1e-3,
                                   args.scan_speed_mm_s * 1e-3,
                                   args.eta_fill)
    total_time = (births[-1] if births else 0.0) + args.t_hold_s
    log(f"{len(layers)} layers, n_per_layer={n_per_layer}, "
        f"total print time ~{births[-1] if births else 0.0:.2f} s"
        + (f" + {args.t_hold_s:g} s hold" if args.t_hold_s else ""),
        tag="layers")

    # per-cell activation times: layer j's in-mask cells born at its START
    # time (the reference births layer j at its cumulative time then prints
    # for the next interval; shift so layer 0 is born at t=0)
    act = np.full(grid.shape, np.inf)
    start_times = [0.0] + births[:-1]
    for (ks, ke), tb in zip(layers, start_times):
        sl = mask_full[:, :, ks:ke + 1]
        act[:, :, ks:ke + 1] = np.where(sl, tb, act[:, :, ks:ke + 1])
    act = jnp.asarray(act)

    robin_h = args.h_side
    rad_scale = None
    if args.corrected_bc:
        # per-axis spacing: the corrector normalizes by each direction's
        # true voxel-face area (dy*dz / dx*dz / dx*dy), so --dz_mm composes
        from ..geometry.bc_correction import corrected_robin_fields
        fields, scale = corrected_robin_fields(
            mesh, mask_full, origin, d,
            {f: args.h_side for f in ("x-", "x+", "y-", "y+", "z-", "z+")})
        robin_h = {f: jnp.asarray(v, dtype) for f, v in fields.items()}
        # the same true/voxel area ratios scale the radiative film when
        # --emissivity composes (reference contract: corrected Robin output
        # is just another h field, voxel_bc_correction.py:207-225)
        rad_scale = {f: jnp.asarray(s, dtype) for f, s in scale.items()}
        log("using STL projected-area corrected Robin fields", tag="bc")

    mesh_dev = None
    if getattr(args, "mesh", ""):
        import jax

        from ..dist.cartesian import make_mesh, shard_field
        p_, q_ = (int(v) for v in args.mesh.lower().split("x"))
        mesh_dev = make_mesh(jax.devices()[:p_ * q_], shape=(p_, q_))
        log(f"sharding over {p_}x{q_} device mesh", tag="mesh")

    hist_crits = None
    crits_np = None     # canonical threshold array (checkpoint meta/guard)
    if args.history_t_crit is not None:
        vals = tuple(float(v) for v in str(args.history_t_crit).split(","))
        hist_crits = vals if len(vals) > 1 else vals[0]
        crits_np = np.atleast_1d(np.asarray(vals))

    # bf16 with round-to-nearest freezes slow cooling (sub-quantum update
    # dropout); stochastic rounding is the documented fix
    use_sr = args.precision == "bfloat16"

    # variable-property physics: latent heat (apparent cp), melt-pool
    # convection proxy, radiation — the terms that dominate at 1500 C
    k_table = cp_table = None
    emissivity = args.emissivity if args.emissivity > 0 else None
    if args.latent_J_kg > 0:
        from ..step.cartesian_varprop import apparent_cp
        cp_table = apparent_cp(args.cp, args.cp_liquid or args.cp,
                               args.latent_J_kg, args.solidus_C,
                               args.liquidus_C)
        log(f"latent heat {args.latent_J_kg:.3g} J/kg over "
            f"{args.solidus_C:g}-{args.liquidus_C:g} C (apparent cp)",
            tag="phys")
    if args.melt_k_factor != 1.0:
        from ..step.cartesian_varprop import melt_pool_enhanced_k
        k_table = melt_pool_enhanced_k(args.k, args.solidus_C,
                                       args.liquidus_C,
                                       enhancement=args.melt_k_factor)
        log(f"melt-pool k proxy: {args.melt_k_factor:g}x above "
            f"{args.liquidus_C:g} C", tag="phys")
    if emissivity is not None:
        log(f"radiative film, emissivity {emissivity:g}"
            + (" (area-corrected)" if args.corrected_bc else ""), tag="phys")
    varprop = (k_table is not None or cp_table is not None
               or emissivity is not None)

    # split engine: the pack/plan rebuild runs on birth events only
    prepare, advance = make_cartesian_engine(
        grid, mat, theta=args.theta, t_inf=args.T_inf, robin_h=robin_h,
        mesh=mesh_dev, dtype=dtype, history_t_crit=hist_crits,
        stochastic_rounding=use_sr,
        k_table=k_table, cp_table=cp_table, emissivity=emissivity,
        radiation_scale=rad_scale if emissivity is not None else None)
    dmin = min(d)
    dt_cap = args.cfl * dmin * dmin / mat.alpha
    log(f"alpha={mat.alpha:.3e} m^2/s, dt_cap={dt_cap:.3e} s (cfl={args.cfl})",
        tag="num")

    T = jnp.full(grid.shape, args.T_inf, dtype)
    if mesh_dev is not None:
        T = shard_field(T, mesh_dev, 0)
        act = shard_field(act, mesh_dev, 0)
    start_t = 0.0
    resume_history = None
    if args.resume:
        from ..io.checkpoint import load_checkpoint
        st = load_checkpoint(args.resume)
        T = jnp.asarray(st.T, dtype)
        start_t = st.t
        if args.history_t_crit is not None and st.meta \
                and "history_peak" in st.meta:
            ha = st.meta["history_above"]
            # t_above's leading threshold axis must match the CURRENT
            # --history_t_crit — a silent mismatch would crash deep inside
            # the jitted advance with an opaque shape error
            nth = len(hist_crits) if isinstance(hist_crits, tuple) else None
            want = (grid.shape if nth is None
                    else (nth,) + tuple(grid.shape))
            if tuple(ha.shape) != tuple(want):
                raise SystemExit(
                    f"checkpoint thermal-history shape {tuple(ha.shape)} does "
                    f"not match --history_t_crit {args.history_t_crit} "
                    f"(expected {want}); resume with the same threshold list "
                    "the checkpoint was written with")
            ck_crits = st.meta.get("history_crits")
            if ck_crits is not None and not np.array_equal(
                    np.atleast_1d(ck_crits), crits_np):
                raise SystemExit(
                    f"checkpoint thermal-history thresholds "
                    f"{np.atleast_1d(ck_crits).tolist()} != "
                    f"--history_t_crit {crits_np.tolist()}; resuming "
                    "would mix accumulators measured against different "
                    "temperatures")
            # t_above accumulates at solve precision (>= f32) in-run; a f32
            # restore would silently downgrade float64 runs
            resume_history = (
                jnp.asarray(st.meta["history_peak"], dtype),
                jnp.asarray(ha, jnp.promote_types(dtype, jnp.float32)))
            log("resumed thermal-history state from checkpoint", tag="ckpt")
        log(f"resumed from {args.resume} at t={start_t:.3f} s", tag="ckpt")

    frame_times = (np.linspace(0.0, total_time, args.nframes).tolist()
                   if args.nframes > 1 and total_time > 0 else [0.0])
    frames_meta = []

    def on_frame(t, T_d, active):
        # multihost-safe: all-gathers process-external shards (collective on
        # a multi-host mesh; a plain copy otherwise)
        from ..dist.gather import gather_to_host, is_output_process
        T_np = gather_to_host(T_d)
        a_np = gather_to_host(active)
        if not is_output_process():
            return
        n_act = int(a_np.sum())
        tmax = float(np.nanmax(np.where(a_np, T_np, np.nan))) if n_act else 0.0
        if not np.isfinite(tmax) or abs(tmax) > 1e5:
            log(f"suspicious field values at t={t:.3f}: Tmax={tmax:.3g}",
                tag="warn")
        log(f"t={t:9.3f} s  active={n_act}  Tmax={tmax:8.1f}", tag="frame")
        frames_meta.append((t, n_act, tmax))
        if args.save_vtk:
            from ..io.vtk import write_vtk_structured_points
            fn = os.path.join(args.outdir, f"waam_{t:010.3f}.vtk")
            binary = (args.vtk_format == "binary"
                      or (args.vtk_format == "auto" and grid.ncells > 2_000_000))
            write_vtk_structured_points(
                fn, {"Temperature": T_np, "Mask": a_np.astype(np.float32)},
                spacing=tuple(v * 1e3 for v in d),
                origin=tuple(np.asarray(origin) * 1e3),
                binary=binary)
        if args.checkpoint:
            from ..io.checkpoint import RunState, save_checkpoint
            meta = None
            if args.history_t_crit is not None and loop.history_state is not None:
                from ..dist.gather import gather_to_host
                pk_c, ta_c = loop.history_state
                meta = {"history_peak": gather_to_host(pk_c),
                        "history_above": gather_to_host(ta_c),
                        "history_crits": crits_np}
            save_checkpoint(args.checkpoint,
                            RunState(T=T_np, active=a_np, t=t, meta=meta))

    loop = EventLoop(advance=advance, activation_times=act,
                     deposit_T=args.Ts, dt_cap=dt_cap, prepare=prepare,
                     history=args.history_t_crit is not None,
                     history_thresholds=(hist_crits if isinstance(
                         hist_crits, tuple) else None),
                     interpass_T=args.interpass_T,
                     interpass_dwell=args.interpass_dwell_s,
                     interpass_max_dwell=args.interpass_max_dwell_s)
    t_loop = time.perf_counter()
    T, active, t = loop.run(T, frame_times=frame_times, t_end=total_time,
                            on_frame=on_frame, start_t=start_t,
                            history_state=resume_history)
    # the loop's final finite-check synchronises with the device
    loop_s = time.perf_counter() - t_loop
    log(f"event loop {loop_s:.2f} s wall for {len(layers)} layers "
        "(compilation included)", tag="time")
    if loop.dwell_log:
        tot = sum(d for _, d in loop.dwell_log)
        log(f"interpass dwells: {len(loop.dwell_log)} layers, "
            f"{tot:.1f} s total cooling inserted", tag="interpass")
    log(f"done: {len(frames_meta)} frames, outdir={args.outdir}", tag="done")

    if args.history_t_crit is not None:
        from ..dist.gather import gather_to_host, is_output_process
        from ..io.vtk import write_vtk_structured_points
        pk, ta = loop.history_state
        pk_np, ta_np = gather_to_host(pk), gather_to_host(ta)
        a_np = gather_to_host(active)
        if is_output_process():
            fn = os.path.join(args.outdir, "waam_history.vtk")
            # never-born cells carry no meaningful history: mask them out
            pk_np = np.where(a_np, pk_np.astype(np.float32), 0.0)
            fields = {"T_peak": pk_np.astype(np.float32)}
            if isinstance(hist_crits, tuple):
                for tc, ta_i in zip(hist_crits, ta_np):
                    key = f"t_above_{tc:g}".replace(".", "p")
                    fields[key] = np.where(a_np, ta_i.astype(np.float32), 0.0)
            else:
                fields["t_above"] = np.where(a_np, ta_np.astype(np.float32),
                                             0.0)
            fields["Mask"] = a_np.astype(np.float32)
            binary = (args.vtk_format == "binary"
                      or (args.vtk_format == "auto"
                          and grid.ncells > 2_000_000))
            write_vtk_structured_points(
                fn, fields,
                spacing=tuple(v * 1e3 for v in d),
                origin=tuple(np.asarray(origin) * 1e3),
                binary=binary)
            log(f"thermal history (T_crit={args.history_t_crit}) -> {fn}",
                tag="history")

    if args.viewer and frames_meta:
        log("viewer: load the VTK series in ParaView, or use "
            "adi_thermal_fields_tpu.apps.viewer on saved checkpoints",
            tag="viewer")
    return {"T": T, "active": active, "t": t, "frames": frames_meta,
            "grid": grid, "layers": layers, "births": births,
            "loop_s": loop_s, "engine": (prepare, advance),
            "history": loop.history_state, "dt_cap": dt_cap}


def main(argv=None):
    from ..core.backend import configure_compile_cache

    configure_compile_cache()
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
