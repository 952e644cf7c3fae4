"""Spiral/ring WAAM tube deposition on a cylindrical grid (CLI app).

Layer-by-layer circumferential deposition of an annular wall: the nozzle
sweeps arcs at angular speed omega, activating (phi, z) columns on the
current layer, with a masked cylindrical ADI solve per fixed dt.  Mirrors the
reference driver (quick_spiral_deposition_gif_v5.py) with two upgrades:
annular grids actually work (r_inner is first-class — the reference's
``GridCyl(..., R_in=...)`` call crashes), and the masked step defaults to
physical Robin material/void interfaces (step/cylindrical_masked.py) with
the reference's ambient-clamp mode available via --void_mode clamp.
Beyond the reference driver: variable-property physics (--latent_J_kg,
--melt_k_factor, --emissivity, per-axis k via the library), --scheme
douglas (second-order time), a moving torch source (--torch_Q), per-voxel
thermal history (--history_t_crit, t8/5), multi-chip sharding (--mesh PxQ
or zN tall-tube decomposition), checkpoints (--checkpoint/--resume) and
true-geometry VTK output (--vtk).

Example:
    python -m adi_thermal_fields_tpu.apps.spiral_tube --R_out 32 \
        --wall_thickness 2 --height 8 --z_back 20 --pitch 4 --out spiral.gif
"""
from __future__ import annotations

import argparse
import math

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WAAM tube: spiral/ring deposition, masked cylindrical ADI")
    # geometry [mm]
    p.add_argument("--R_out", type=float, required=True)
    p.add_argument("--wall_thickness", type=float, required=True)
    p.add_argument("--height", type=float, required=True)
    p.add_argument("--z_back", type=float, required=True)
    p.add_argument("--nr", type=int, default=8)
    p.add_argument("--nphi", type=int, default=36)
    p.add_argument("--dz", type=float, default=None, help="override dz [mm] (default dr)")
    # material
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=54.0)
    # BCs
    p.add_argument("--h_side", type=float, default=300.0)
    p.add_argument("--h_end", type=float, default=150.0)
    p.add_argument("--h_void", type=float, default=None)
    p.add_argument("--T_inf", type=float, default=20.0)
    p.add_argument("--Ts", type=float, default=1000.0)
    p.add_argument("--void_mode", choices=["robin", "clamp"], default="robin")
    # time / kinematics
    p.add_argument("--t_tot", type=float, default=30.0)
    p.add_argument("--dt_fixed", type=float, default=0.05)
    p.add_argument("--pitch", type=float, required=True,
                   help="vertical distance per full turn [mm]")
    p.add_argument("--speed", type=float, default=None, help="tangential speed [mm/s]")
    p.add_argument("--auto_speed", action="store_true",
                   help="choose speed so all layers fit in t_tot")
    p.add_argument("--loops_per_layer", type=int, default=1)
    p.add_argument("--layer_cells_z", type=int, default=None,
                   help="layer thickness in z cells (default: derived from pitch)")
    # output
    p.add_argument("--nframes", type=int, default=30)
    p.add_argument("--out", type=str, default="spiral_tube.gif")
    p.add_argument("--iphi_slice", type=int, default=0)
    p.add_argument("--precision", choices=["float32", "float64"], default="float32")
    p.add_argument("--scheme", choices=["be", "douglas"], default="be",
                   help="time scheme: backward Euler (robust near the "
                        "latent-heat cp spike) or Douglas-Gunn (second "
                        "order in time; routes through the varprop step, "
                        "single-device)")
    # variable-property physics (step/cylindrical_varprop.py) — the
    # reference's cylindrical core is constant-property; these flags mirror
    # the WAAM CLI's (apps/waam_from_stl.py)
    p.add_argument("--latent_J_kg", type=float, default=0.0,
                   help="latent heat of fusion [J/kg] via the apparent-cp "
                        "enthalpy method over --solidus_C..--liquidus_C")
    p.add_argument("--solidus_C", type=float, default=1420.0)
    p.add_argument("--liquidus_C", type=float, default=1510.0)
    p.add_argument("--melt_k_factor", type=float, default=1.0,
                   help="melt-pool convection proxy: multiply k above the "
                        "liquidus by this factor (ramped over the mushy "
                        "interval)")
    p.add_argument("--emissivity", type=float, default=0.0,
                   help="surface emissivity: adds the Picard-linearized "
                        "radiative film h_rad(T) to every exposed surface "
                        "(dominates convection at WAAM temperatures); in "
                        "clamp void mode it applies on the domain faces "
                        "only")
    p.add_argument("--torch_Q", type=float, default=0.0,
                   help="moving torch power [W]: a Gaussian volumetric "
                        "source of width --torch_sigma centred on the "
                        "nozzle (position derived from the deposition "
                        "kinematics), normalized so the domain integral "
                        "is exactly Q — heat INPUT physics on top of the "
                        "hot-deposit births (single-device)")
    p.add_argument("--torch_sigma", type=float, default=3.0,
                   help="torch Gaussian sigma [mm]")
    p.add_argument("--history_t_crit", type=str, default=None,
                   help="track per-voxel thermal history: peak temperature "
                        "and seconds above each comma-separated threshold "
                        "[C] (e.g. '800,500' -> t8/5 = t_above[1] - "
                        "t_above[0]); same semantics as the WAAM app "
                        "(engine history: reset at birth, masked by the "
                        "final active state on output)")
    p.add_argument("--history_out", type=str, default="spiral_history.npz",
                   help="npz output path for the thermal-history arrays")
    p.add_argument("--mesh", type=str, default="",
                   help="shard over a PxQ device mesh, e.g. '2x4' "
                        "(dist/cylindrical.py: each sweep's solve axis "
                        "chip-local, batch axes sharded), or 'zN' (e.g. "
                        "'z8') for the TALL-TUBE long-axis decomposition — "
                        "z itself sharded over N chips, the field never "
                        "reshards, substructured z solve; identical "
                        "results to single-device")
    p.add_argument("--vtk", type=str, default="",
                   help="write the final state as a legacy VTK "
                        "STRUCTURED_GRID with TRUE tube geometry [mm] "
                        "(T, active, + thermal-history fields when "
                        "tracked); ParaView renders the actual annulus")
    p.add_argument("--checkpoint", type=str, default="",
                   help="write a resume checkpoint (npz) at every frame")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a checkpoint file; the deposition "
                        "schedule is recomputed from the (identical) CLI "
                        "args, so only T, t and the thermal history are "
                        "restored")
    return p


def run(args) -> dict:
    if args.out:     # fail before simulating, not after
        from ..io.gif import gif_modules

        gif_modules()
    import jax
    import jax.numpy as jnp

    from ..birth.spiral import (active_at, newborn_between,
                                spiral_activation_times)
    from ..core.grid import CylindricalGrid
    from ..core.material import Material
    from ..io.logging import log
    from ..step.cylindrical import RobinBC, ZFaceBC
    from ..step.cylindrical import adi_step_masked as step_clamp
    from ..step.cylindrical_masked import adi_step_masked_robin

    mm = 1e-3
    R_out = args.R_out * mm
    wall = args.wall_thickness * mm
    R_in = max(0.0, R_out - wall)
    dr = wall / args.nr
    dz = (args.dz * mm) if args.dz else dr
    nz = int(round((args.z_back * mm + args.height * mm) / dz))
    grid = CylindricalGrid(args.nr, args.nphi, nz, dr, dz, r_inner=R_in)
    mat = Material(args.rho, args.cp, args.k)
    iz_base = int(round(args.z_back * mm / dz))
    # layer thickness: explicit cells, else derived from pitch (vertical
    # distance per full turn; layer_height = pitch / loops_per_layer)
    if args.layer_cells_z is not None:
        layer_cells = max(1, args.layer_cells_z)
    else:
        layer_cells = max(1, int(round(args.pitch * mm
                                       / (dz * args.loops_per_layer))))
    layer_h = layer_cells * dz
    n_layers = max(1, int(round(args.height * mm / layer_h)))

    # kinematics: time per loop from tangential speed at the wall mid-radius
    r_mid = R_in + 0.5 * wall
    if args.auto_speed or args.speed is None:
        tau_loop = args.t_tot / (n_layers * args.loops_per_layer)
    else:
        tau_loop = 2 * math.pi * r_mid / (args.speed * mm)
    log(f"grid (nr,nphi,nz)=({grid.nr},{grid.nphi},{grid.nz}), "
        f"R_in={R_in*1e3:.3g} mm, {n_layers} layers, tau_loop={tau_loop:.3f} s",
        tag="spiral")

    act = jnp.asarray(spiral_activation_times(
        grid, iz_base=iz_base, layer_cells=layer_cells,
        n_layers=n_layers, tau_dep=tau_loop * args.loops_per_layer,
        loops_per_layer=args.loops_per_layer))

    h_void = args.h_void if args.h_void is not None else args.h_side
    rob_out = RobinBC(args.h_side, args.T_inf)
    rob_in = RobinBC(args.h_side, args.T_inf)
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=args.h_end,
                  T_inf_top=args.T_inf)

    # variable-property physics: latent heat (apparent cp) and the
    # melt-pool conductivity proxy switch the run onto the varprop step
    # (step/cylindrical_varprop.py), beyond-reference capability
    k_table = cp_table = None
    if args.latent_J_kg > 0:
        from ..step.cartesian_varprop import apparent_cp
        cp_table = apparent_cp(args.cp, args.cp, args.latent_J_kg,
                               args.solidus_C, args.liquidus_C)
        log(f"latent heat {args.latent_J_kg:.3g} J/kg over "
            f"{args.solidus_C:g}-{args.liquidus_C:g} C (apparent cp)",
            tag="varprop")
    if args.melt_k_factor != 1.0:
        from ..step.cartesian_varprop import melt_pool_enhanced_k
        k_table = melt_pool_enhanced_k(args.k, args.solidus_C,
                                       args.liquidus_C,
                                       enhancement=args.melt_k_factor)
        log(f"melt-pool k proxy: {args.melt_k_factor:g}x above "
            f"{args.liquidus_C:g} C", tag="varprop")
    if args.emissivity > 0.0:
        log(f"radiative film: eps={args.emissivity:g} on every exposed "
            "surface (Picard h_rad(T))", tag="varprop")
    varprop = (k_table is not None or cp_table is not None
               or args.emissivity > 0.0 or args.scheme != "be")
    if args.scheme != "be" and k_table is None and cp_table is None \
            and args.emissivity == 0.0:
        log("scheme=douglas routes through the varprop step with constant "
            "tables (identical physics, second-order time)", tag="scheme")
    if args.emissivity > 0.0 and args.void_mode != "robin":
        log("clamp void mode: radiation applies on the domain faces only "
            "(the clamp scheme has no material/void interface films)",
            tag="varprop")

    # multi-chip: the dist/cylindrical.py wrappers take step(T, active3d, dt)
    mesh_dev = None
    longz = False
    if getattr(args, "mesh", ""):
        spec = args.mesh.lower()
        if spec.startswith("z"):
            from jax.sharding import Mesh
            n_ = int(spec[1:])
            if len(jax.devices()) < n_:
                raise SystemExit(f"--mesh z{n_} needs {n_} devices, "
                                 f"have {len(jax.devices())}")
            mesh_dev = Mesh(np.asarray(jax.devices()[:n_]), ("z",))
            longz = True
            if args.void_mode != "robin":
                raise SystemExit("--mesh zN (long-axis decomposition) "
                                 "supports --void_mode robin only")
            log(f"tall-tube longz decomposition over {n_} devices "
                "(z sharded, field never reshards)", tag="mesh")
        else:
            from ..dist.cartesian import make_mesh
            p_, q_ = (int(v) for v in spec.split("x"))
            mesh_dev = make_mesh(jax.devices()[:p_ * q_], shape=(p_, q_))
            log(f"sharding over {p_}x{q_} device mesh", tag="mesh")

    if mesh_dev is not None and args.scheme != "be":
        raise SystemExit("--scheme douglas is single-device for now "
                         "(the sharded varprop wrapper chains BE sweeps)")
    if mesh_dev is not None and longz:
        # long-axis tall-tube path: the varprop step covers the constant
        # configuration exactly (constant tables reduce to it, tested)
        from ..dist.cylindrical import sharded_cyl_varprop_longz
        step3 = sharded_cyl_varprop_longz(
            grid, mat, mesh_dev, robin_outer=rob_out, zbc=zbc,
            robin_inner=rob_in, k_table=k_table, cp_table=cp_table,
            emissivity=args.emissivity, h_void=h_void,
            T_inf_void=args.T_inf, h_front=args.h_end)

        def step(T, active2d, dt):
            a3 = jnp.broadcast_to(active2d[None, :, :], grid.shape)
            return step3(T, a3, dt)
    elif mesh_dev is not None:
        from ..dist.cylindrical import (sharded_cyl_varprop_step,
                                        sharded_cylindrical_masked_clamp_step,
                                        sharded_cylindrical_masked_step)
        if varprop:
            step3 = sharded_cyl_varprop_step(
                grid, mat, mesh_dev, robin_outer=rob_out, zbc=zbc,
                robin_inner=rob_in, k_table=k_table, cp_table=cp_table,
                emissivity=args.emissivity,
                masked_clamp=args.void_mode != "robin",
                robin_void=RobinBC(h_void, args.T_inf),
                h_void=h_void, T_inf_void=args.T_inf, h_front=args.h_end)
        elif args.void_mode == "robin":
            step3 = sharded_cylindrical_masked_step(
                grid, mat, mesh_dev, robin_outer=rob_out, zbc=zbc,
                robin_inner=rob_in, h_void=h_void, T_inf_void=args.T_inf,
                h_front=args.h_end)
        else:
            step3 = sharded_cylindrical_masked_clamp_step(
                grid, mat, mesh_dev, robin_outer=rob_out, zbc=zbc,
                robin_inner=rob_in, robin_void=RobinBC(h_void, args.T_inf))

        def step(T, active2d, dt):
            a3 = jnp.broadcast_to(active2d[None, :, :], grid.shape)
            return step3(T, a3, dt)
    elif varprop:
        from ..step.cylindrical_varprop import (adi_step_cyl_varprop,
                                                adi_step_cyl_varprop_masked)

        if args.void_mode == "robin":
            @jax.jit
            def step(T, active2d, dt, src=None):
                a3 = jnp.broadcast_to(active2d[None, :, :], grid.shape)
                return adi_step_cyl_varprop(
                    T, grid, mat, dt=dt, robin_outer=rob_out, zbc=zbc,
                    robin_inner=rob_in, active=a3, h_void=h_void,
                    T_inf_void=args.T_inf, h_front=args.h_end,
                    k_table=k_table, cp_table=cp_table, source=src,
                    emissivity=args.emissivity, scheme=args.scheme)
        else:
            @jax.jit
            def step(T, active2d, dt, src=None):
                a3 = jnp.broadcast_to(active2d[None, :, :], grid.shape)
                return adi_step_cyl_varprop_masked(
                    T, grid, mat, dt=dt, robin_outer=rob_out, zbc=zbc,
                    active=a3, robin_inner=rob_in,
                    robin_void=RobinBC(h_void, args.T_inf),
                    k_table=k_table, cp_table=cp_table, source=src,
                    emissivity=args.emissivity, scheme=args.scheme)
    elif args.void_mode == "robin":
        @jax.jit
        def step(T, active2d, dt, src=None):
            a3 = jnp.broadcast_to(active2d[None, :, :], grid.shape)
            return adi_step_masked_robin(
                T, grid, mat, dt=dt, active=a3, robin_outer=rob_out, zbc=zbc,
                robin_inner=rob_in, h_void=h_void, T_inf_void=args.T_inf,
                h_front=args.h_end, source=src)
    else:
        @jax.jit
        def step(T, active2d, dt, src=None):
            a3 = jnp.broadcast_to(active2d[None, :, :], grid.shape)
            return step_clamp(T, grid, mat, dt=dt, robin_outer=rob_out,
                              zbc=zbc, active=a3, robin_inner=rob_in,
                              robin_void=RobinBC(h_void, args.T_inf),
                              source=src)

    dtype = jnp.float32 if args.precision == "float32" else jnp.float64
    T = jnp.full(grid.shape, args.T_inf, dtype)
    if mesh_dev is not None and longz:
        if grid.nz % mesh_dev.devices.size == 0:
            from jax.sharding import NamedSharding, PartitionSpec as P
            T = jax.device_put(T, NamedSharding(mesh_dev, P(None, None, "z")))
    elif mesh_dev is not None:
        # pre-place the state when the dims divide the mesh; otherwise the
        # step's in-jit sharding constraints handle the (uneven) layout
        p_, q_ = mesh_dev.devices.shape
        if grid.nphi % p_ == 0 and grid.nz % q_ == 0:
            from jax.sharding import NamedSharding, PartitionSpec as P
            T = jax.device_put(T, NamedSharding(
                mesh_dev, P(None, *mesh_dev.axis_names)))
    dt = args.dt_fixed
    n_steps = int(round(args.t_tot / dt))
    frame_every = max(1, n_steps // max(1, args.nframes))

    # per-voxel thermal history (engine semantics, apps/engine.py:371-406:
    # peak = max over sub-steps, t_above += dt * (T > crit) per threshold,
    # reset at birth to the deposit temperature)
    crits = None
    if args.history_t_crit is not None:
        crits = tuple(float(v) for v in str(args.history_t_crit).split(","))
        tc = jnp.asarray(crits, dtype)
        pk = jnp.full(grid.shape, args.T_inf, dtype)
        ta = jnp.zeros((len(crits),) + grid.shape, dtype)
        log(f"thermal history: peak + t_above{crits} C", tag="history")

        from .engine import history_update

        @jax.jit
        def hist_update(pk, ta, T, newborn2d, dt):
            # birth reset (EventLoop does this for the Cartesian engine),
            # then the SHARED engine history semantics (apps/engine.py)
            nb = jnp.broadcast_to(newborn2d[None, :, :], T.shape)
            pk = jnp.where(nb, jnp.asarray(args.Ts, T.dtype), pk)
            ta = jnp.where(nb[None], jnp.zeros((), ta.dtype), ta)
            return history_update(pk, ta, T, dt, tc, multi=True)

    # moving torch: Gaussian volumetric source [W/m^3] centred on the
    # nozzle; position derived from the SAME kinematics as the activation
    # times (birth/spiral.py: layer L, loop fraction t/tau_loop)
    torch_on = args.torch_Q > 0.0
    if torch_on:
        if mesh_dev is not None:
            raise SystemExit("--torch_Q is single-device for now (the "
                             "sharded step wrappers take no source field)")
        log(f"torch: Q={args.torch_Q:g} W, sigma={args.torch_sigma:g} mm",
            tag="torch")
        r_np = np.asarray(grid.r)
        vol = jnp.asarray((r_np * grid.dr * grid.dphi * grid.dz)
                          [:, None, None], dtype)      # cell volumes
        phis = jnp.asarray(grid.dphi * np.arange(grid.nphi), dtype)
        zs = jnp.asarray(grid.dz * (np.arange(grid.nz) + 0.5), dtype)
        sig = jnp.asarray(args.torch_sigma * mm, dtype)
        r_mid_t = jnp.asarray(r_mid, dtype)
        tau_layer = tau_loop * args.loops_per_layer

        @jax.jit
        def torch_source(t, active2d):
            frac = (t / tau_loop) % 1.0
            phi_n = 2.0 * jnp.pi * frac
            lay = jnp.clip(jnp.floor(t / tau_layer), 0, n_layers - 1)
            z_n = (iz_base + (lay + 1.0) * layer_cells - 0.5) * grid.dz
            dphi_w = jnp.abs(((phis - phi_n) + jnp.pi) % (2 * jnp.pi)
                             - jnp.pi)
            arc2 = (r_mid_t * dphi_w) ** 2                 # (nphi,)
            dz2 = (zs - z_n) ** 2                          # (nz,)
            G = jnp.exp(-(arc2[:, None] + dz2[None, :]) / (2.0 * sig * sig))
            G3 = jnp.broadcast_to(G[None], grid.shape) \
                * jnp.broadcast_to(active2d[None], grid.shape)
            norm = jnp.sum(G3 * vol) + jnp.asarray(1e-30, dtype)
            return (args.torch_Q / norm) * G3              # [W/m^3]

    # checkpoint/resume (io/checkpoint.py): resume is by simulation time —
    # the deposition schedule recomputes from the CLI args, so the state is
    # T, t and the thermal history only
    i0 = 0
    if args.resume:
        from ..io.checkpoint import load_checkpoint
        st = load_checkpoint(args.resume)
        T = jnp.asarray(st.T, dtype)
        i0 = int(round(st.t / dt))
        if abs(i0 * dt - st.t) > 1e-9 * max(1.0, st.t):
            raise SystemExit(f"checkpoint t={st.t} is not a multiple of "
                             f"--dt_fixed {dt}; resume needs the same dt")
        if crits is not None:
            if not (st.meta and "history_peak" in st.meta):
                raise SystemExit("--history_t_crit set but the checkpoint "
                                 "carries no thermal-history state")
            ha = st.meta["history_above"]
            if ha.shape[0] != len(crits):
                raise SystemExit(
                    f"checkpoint thermal-history has {ha.shape[0]} "
                    f"thresholds, --history_t_crit has {len(crits)}")
            ck_crits = tuple(float(v) for v in
                             np.atleast_1d(st.meta.get("history_crits",
                                                       np.asarray(crits))))
            if ck_crits != crits:
                raise SystemExit(
                    f"checkpoint thermal-history thresholds {ck_crits} != "
                    f"--history_t_crit {crits}; resuming would mix "
                    "accumulators measured against different temperatures")
            pk = jnp.asarray(st.meta["history_peak"], dtype)
            ta = jnp.asarray(ha, dtype)
        log(f"resumed t={st.t:.3f} s (step {i0}/{n_steps})", tag="resume")

    def _write_checkpoint(T_np, t, active):
        from ..dist.gather import gather_to_host
        from ..io.checkpoint import RunState, save_checkpoint
        meta = None
        if crits is not None:
            meta = {"history_peak": gather_to_host(pk),
                    "history_above": gather_to_host(ta),
                    "history_crits": np.asarray(crits)}
        save_checkpoint(args.checkpoint, RunState(
            T=T_np, active=np.asarray(active), t=t, meta=meta))

    frames = []
    t = i0 * dt
    for i in range(i0, n_steps):
        t_next = t + dt
        newborn = newborn_between(act, t, t_next)
        T = jnp.where(newborn[None, :, :], args.Ts, T)
        active = active_at(act, t_next)
        if torch_on:
            src = torch_source(jnp.asarray(t + 0.5 * dt, dtype), active)
            T = step(T, active, jnp.asarray(dt, dtype), src)
        else:
            T = step(T, active, jnp.asarray(dt, dtype))
        if crits is not None:
            pk, ta = hist_update(pk, ta, T, newborn, jnp.asarray(dt, dtype))
        t = t_next
        if (i + 1) % frame_every == 0 or i == n_steps - 1:
            from ..dist.gather import gather_to_host
            a_np = np.broadcast_to(np.asarray(active)[None], grid.shape)
            T_np = gather_to_host(T)   # multihost-safe (dist/gather.py)
            tmax = float(np.nanmax(np.where(a_np, T_np, np.nan)))
            log(f"t={t:8.3f} s  Tmax={tmax:8.1f}", tag="frame")
            frames.append((t, T_np, a_np.copy()))
            if args.checkpoint:
                _write_checkpoint(T_np, t, active)

    out = {"T": T, "frames": frames, "grid": grid}
    if crits is not None:
        # mask by the final active state — never-born cells carry
        # meaningless placeholder history (engine docstring)
        a_fin = np.broadcast_to(
            np.asarray(active_at(act, t))[None], grid.shape)
        from ..dist.gather import gather_to_host
        pk_np = np.where(a_fin, gather_to_host(pk), 0.0)
        ta_np = np.where(a_fin[None], gather_to_host(ta), 0.0)
        out["history"] = {"peak": pk_np, "t_above": ta_np, "crits": crits}
        if len(crits) == 2:
            t85 = ta_np[1] - ta_np[0]
            log(f"t{crits[0]:g}/{crits[1]:g}: max "
                f"{float(t85.max()):.3f} s, mean (deposited) "
                f"{float(t85[a_fin].mean()):.3f} s", tag="history")
        if args.history_out:
            np.savez_compressed(
                args.history_out, peak=pk_np, t_above=ta_np,
                crits=np.asarray(crits), r=np.asarray(grid.r),
                dphi=grid.dphi, dz=grid.dz,
                active=a_fin.astype(np.uint8))
            log(f"saved {args.history_out}", tag="history")

    if args.vtk:
        from ..io.vtk import write_vtk_cylindrical_grid
        a_fin = np.broadcast_to(
            np.asarray(active_at(act, t))[None], grid.shape)
        fields = {"T": np.where(a_fin, np.asarray(T), args.T_inf),
                  "active": a_fin.astype(np.float32)}
        if crits is not None:
            fields["T_peak"] = out["history"]["peak"]
            for kk, cc in enumerate(crits):
                fields[f"t_above_{cc:g}C"] = out["history"]["t_above"][kk]
        write_vtk_cylindrical_grid(
            args.vtk, fields, r=np.asarray(grid.r) * 1e3,
            dphi=grid.dphi, dz=grid.dz * 1e3, binary=True,
            comment="adi_thermal_fields_tpu spiral_tube [mm]")
        log(f"saved {args.vtk}", tag="vtk")

    if args.out and frames:
        _save_gif(args.out, frames, grid, args)
        log(f"saved {args.out}", tag="gif")
    elif args.out:
        log("no steps ran (resume at/past t_tot); gif skipped", tag="gif")
    return out


def _save_gif(path, frames, grid, args):
    from ..io.gif import gif_modules

    plt, imageio = gif_modules()

    images = []
    vmax = max(np.nanmax(np.where(a, T, np.nan)) for _, T, a in frames)
    ir = grid.nr - 1  # outer surface view
    for t, T, a in frames:
        fig, ax = plt.subplots(figsize=(6.4, 3.6))
        sl = np.where(a[ir], T[ir], np.nan)   # (nphi, nz)
        im = ax.imshow(sl.T, origin="lower", aspect="auto",
                       vmin=args.T_inf, vmax=vmax, cmap="inferno",
                       extent=[0, 360, 0, grid.nz * grid.dz * 1e3])
        ax.set_xlabel("phi, deg")
        ax.set_ylabel("z, mm")
        ax.set_title(f"outer surface T, t = {t:.2f} s")
        fig.colorbar(im, ax=ax, label="T, C")
        fig.tight_layout()
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
        plt.close(fig)
    imageio.mimsave(path, images, fps=8)


def main(argv=None):
    from ..core.backend import configure_compile_cache

    configure_compile_cache()
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
