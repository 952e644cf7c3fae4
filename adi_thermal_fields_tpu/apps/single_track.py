"""Single-track deposition on a plate (CLI app).

A 3x3-voxel bead is deposited column by column along y on top of a plate,
each column born at the deposit temperature as the torch passes (moving heat
source realized as element birth, exactly the reference's approach —
single_track_on_plate.py:61-189; its unused ``apply_surface_impulse_Q``
remains available as step/cartesian.apply_surface_impulse).  Robin convection
on every exposed face; PNG frames -> GIF.

CLI units: mm (converted to SI internally), matching the reference.

Example:
    python -m adi_thermal_fields_tpu.apps.single_track --out track.gif
"""
from __future__ import annotations

import argparse
import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Single-track deposition on a plate")
    p.add_argument("--plate_x_mm", type=float, default=30.0)
    p.add_argument("--plate_y_mm", type=float, default=60.0)
    p.add_argument("--plate_z_mm", type=float, default=6.0)
    p.add_argument("--dx_mm", type=float, default=1.0)
    p.add_argument("--track_len_mm", type=float, default=40.0)
    p.add_argument("--track_w_vox", type=int, default=3)
    p.add_argument("--track_h_vox", type=int, default=3)
    p.add_argument("--speed_mm_s", type=float, default=8.0)
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=54.0)
    p.add_argument("--h", type=float, default=30.0)
    p.add_argument("--T_inf", type=float, default=20.0)
    p.add_argument("--T_track", type=float, default=1500.0)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--cfl", type=float, default=2.0)
    p.add_argument("--t_tail", type=float, default=5.0, help="relaxation after track end [s]")
    p.add_argument("--nframes", type=int, default=24)
    p.add_argument("--out", type=str, default="single_track.gif")
    p.add_argument("--save_vtk", type=int, default=0)
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("--precision", choices=["float32", "float64"], default="float32")
    # moving-torch mode: in addition to the bead birth, deposit arc power as
    # a Goldak double-ellipsoid source following the torch (new capability;
    # the reference only injects heat via birth temperature)
    p.add_argument("--goldak_power", type=float, default=0.0,
                   help="absorbed torch power [W]; 0 disables the source")
    p.add_argument("--goldak_af_mm", type=float, default=2.0)
    p.add_argument("--goldak_ar_mm", type=float, default=4.0)
    p.add_argument("--goldak_b_mm", type=float, default=2.0)
    p.add_argument("--goldak_c_mm", type=float, default=2.0)
    return p


def run(args) -> dict:
    if args.out:     # fail before simulating, not after
        from ..io.gif import gif_modules

        gif_modules()
    import jax.numpy as jnp

    from ..birth.layers import track_activation_times
    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..io.logging import log
    from .engine import EventLoop, make_cartesian_advance

    dx = args.dx_mm * 1e-3
    nx = int(round(args.plate_x_mm / args.dx_mm))
    ny = int(round(args.plate_y_mm / args.dx_mm))
    plate_cells = int(round(args.plate_z_mm / args.dx_mm))
    nz = plate_cells + args.track_h_vox + 2
    grid = CartesianGrid(nx, ny, nz, dx)
    mat = Material(args.rho, args.cp, args.k)

    track_cols = int(round(args.track_len_mm / args.dx_mm))
    y0 = (ny - track_cols) // 2
    x0 = nx // 2 - args.track_w_vox // 2
    dt_col = dx / (args.speed_mm_s * 1e-3)
    act_y = track_activation_times(ny, y_start=y0, n_columns=track_cols,
                                   dt_per_column=dt_col, t_first=1e-9)

    # per-cell activation: plate always active; bead columns per act_y
    act = np.full(grid.shape, np.inf)
    act[:, :, :plate_cells] = -np.inf
    zs = slice(plate_cells, plate_cells + args.track_h_vox)
    act[x0:x0 + args.track_w_vox, :, zs] = act_y[None, :, None]
    act = jnp.asarray(act)

    dtype = jnp.float32 if args.precision == "float32" else jnp.float64
    T = jnp.full(grid.shape, args.T_inf, dtype)

    source_fn = None
    if args.goldak_power > 0.0:
        from ..birth.heat_source import GoldakSource, goldak_source

        gk = GoldakSource(power=args.goldak_power,
                          a_f=args.goldak_af_mm * 1e-3,
                          a_r=args.goldak_ar_mm * 1e-3,
                          b=args.goldak_b_mm * 1e-3,
                          c=args.goldak_c_mm * 1e-3, travel_axis=1)
        x_c = (x0 + args.track_w_vox / 2.0) * dx
        z_c = (plate_cells + args.track_h_vox) * dx
        speed = args.speed_mm_s * 1e-3

        def source_fn(t):
            y_c = (y0 + 0.5) * dx + speed * t
            active_torch = t < track_cols * dt_col
            S = goldak_source(grid, gk, (x_c, y_c, z_c))
            return jnp.where(active_torch, 1.0, 0.0) * S

    advance = make_cartesian_advance(grid, mat, theta=args.theta,
                                     t_inf=args.T_inf, robin_h=args.h,
                                     source_fn=source_fn)
    dt_cap = args.cfl * dx * dx / mat.alpha
    t_track = track_cols * dt_col
    t_end = t_track + args.t_tail
    frame_times = np.linspace(0.0, t_end, args.nframes)

    frames = []

    def on_frame(t, T_d, active):
        T_np = np.asarray(T_d)
        a_np = np.asarray(active)
        frames.append((t, T_np, a_np))
        tmax = float(np.nanmax(np.where(a_np, T_np, np.nan))) if a_np.any() else 0.0
        log(f"t={t:8.3f} s  Tmax={tmax:7.1f}",
            tag="frame")
        if args.save_vtk:
            from ..io.vtk import write_vtk_structured_points
            import os
            os.makedirs(args.outdir, exist_ok=True)
            write_vtk_structured_points(
                os.path.join(args.outdir, f"track_{t:09.3f}.vtk"),
                {"Temperature": T_np, "Mask": a_np.astype(np.float32)},
                spacing=args.dx_mm)

    loop = EventLoop(advance=advance, activation_times=act,
                     deposit_T=args.T_track, dt_cap=dt_cap)
    T, active, t = loop.run(T, frame_times=frame_times, t_end=t_end,
                            on_frame=on_frame)

    if args.out:
        _save_gif(args.out, frames, plate_cells, args)
        log(f"saved {args.out}", tag="gif")
    return {"frames": frames, "T": T, "active": active}


def _save_gif(path, frames, plate_cells, args):
    from ..io.gif import gif_modules

    plt, imageio = gif_modules()

    images = []
    vmax = max(np.nanmax(np.where(a, T, np.nan)) for _, T, a in frames if a.any())
    for t, T, a in frames:
        fig, ax = plt.subplots(figsize=(6, 3.2))
        # side view: x mid-plane (y-z)
        sl = np.where(a[T.shape[0] // 2], T[T.shape[0] // 2], np.nan)
        im = ax.imshow(sl.T, origin="lower", aspect="auto",
                       vmin=args.T_inf, vmax=vmax, cmap="inferno")
        ax.axhline(plate_cells - 0.5, color="w", lw=0.5)
        ax.set_title(f"t = {t:.2f} s")
        fig.colorbar(im, ax=ax, label="T, C")
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        images.append(buf.copy())
        plt.close(fig)
    imageio.mimsave(path, images, fps=6)


def main(argv=None):
    from ..core.backend import configure_compile_cache

    configure_compile_cache()
    args = build_argparser().parse_args(argv)
    run(args)


if __name__ == "__main__":
    main()
