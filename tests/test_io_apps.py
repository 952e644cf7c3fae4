"""I/O round trips and app smoke tests (tiny configs, CPU)."""
import os

import numpy as np

from adi_thermal_fields_tpu.io.checkpoint import (RunState, load_checkpoint,
                                                  save_checkpoint)
from adi_thermal_fields_tpu.io.vtk import write_vtk_structured_points


def test_vtk_roundtrip(tmp_path):
    from adi_thermal_fields_tpu.apps.viewer import read_vtk_structured_points

    rng = np.random.default_rng(0)
    T = rng.random((4, 5, 6)) * 100
    M = rng.random((4, 5, 6)) > 0.5
    for binary in (False, True):
        path = str(tmp_path / f"t_{binary}.vtk")
        write_vtk_structured_points(path, {"Temperature": T,
                                           "Mask": M.astype(np.float32)},
                                    spacing=1.0, origin=(1, 2, 3),
                                    binary=binary)
        back = read_vtk_structured_points(path)
        np.testing.assert_allclose(back["Temperature"], T, rtol=1e-4)
        np.testing.assert_array_equal(back["Mask"] > 0.5, M)


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    st = RunState(T=rng.random((3, 4, 5)), active=rng.random((3, 4, 5)) > 0.5,
                  t=12.5)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st)
    st2 = load_checkpoint(path)
    np.testing.assert_allclose(st2.T, st.T)
    np.testing.assert_array_equal(st2.active, st.active)
    assert st2.t == 12.5


def test_single_track_app_smoke(tmp_path):
    from adi_thermal_fields_tpu.apps.single_track import build_argparser, run

    out = str(tmp_path / "track.gif")
    args = build_argparser().parse_args([
        "--plate_x_mm", "10", "--plate_y_mm", "14", "--plate_z_mm", "3",
        "--dx_mm", "1", "--track_len_mm", "6", "--t_tail", "0.5",
        "--nframes", "3", "--out", out, "--precision", "float64"])
    res = run(args)
    assert os.path.exists(out)
    t, T, a = res["frames"][-1]
    Tact = np.where(a, T, np.nan)
    assert np.nanmax(Tact) > 20.0
    assert np.isfinite(Tact[a]).all()


def test_waam_app_smoke(tmp_path):
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    outdir = str(tmp_path / "out")
    ck = str(tmp_path / "ck.npz")
    args = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "3", "--save_vtk", "1",
        "--outdir", outdir, "--checkpoint", ck, "--precision", "float64",
        "--bead_height_mm", "2"])
    res = run(args)
    assert len(res["layers"]) == 4
    vtks = [f for f in os.listdir(outdir) if f.endswith(".vtk")]
    assert len(vtks) == 3
    assert os.path.exists(ck)
    # all solid cells active at the end
    assert int(np.asarray(res["active"]).sum()) > 0
    assert float(np.asarray(res["T"]).max()) > 20.0

    # resume from the checkpoint and run a little further
    args2 = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2", "--outdir", outdir,
        "--resume", ck, "--precision", "float64", "--bead_height_mm", "2"])
    res2 = run(args2)
    assert res2["t"] >= res["t"] - 1e-9


def test_waam_app_sharded_matches_single_device(tmp_path):
    """The flagship app end-to-end on the 8-device virtual mesh (sharded
    pack rebuild + births + sweeps) matches the single-device run."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    base = ["--stl", stl, "--dx_mm", "1", "--nframes", "2", "--outdir",
            str(tmp_path / "o1"), "--precision", "float64",
            "--bead_height_mm", "2"]
    res1 = run(build_argparser().parse_args(base))
    res2 = run(build_argparser().parse_args(base + ["--mesh", "2x4"]))
    assert res2["t"] == res1["t"]
    import jax
    assert len(jax.devices()) == 8
    np.testing.assert_allclose(np.asarray(res2["T"]), np.asarray(res1["T"]),
                               rtol=1e-12, atol=1e-12)


def test_waam_app_corrected_bc_smoke(tmp_path):
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import cylinder_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cyl_mm.stl")
    save_stl_binary(stl, cylinder_mesh(4.0, 8.0, center=(0, 0, 4), n_phi=32))
    args = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2", "--outdir",
        str(tmp_path / "o"), "--corrected_bc", "1", "--precision", "float64"])
    res = run(args)
    assert float(np.asarray(res["T"]).max()) > 20.0


def test_spiral_tube_app_smoke(tmp_path):
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    out = str(tmp_path / "sp.gif")
    args = build_argparser().parse_args([
        "--R_out", "32", "--wall_thickness", "2", "--height", "4",
        "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
        "--pitch", "2", "--auto_speed", "--t_tot", "2", "--dt_fixed", "0.2",
        "--nframes", "2", "--out", out, "--precision", "float64"])
    res = run(args)
    assert os.path.exists(out)
    t, T, a = res["frames"][-1]
    assert np.isfinite(T[a]).all()
    assert np.nanmax(np.where(a, T, np.nan)) > 20.0


def test_compare_implementations_app_smoke():
    """The A/B driver (XLA scan vs fused Pallas, interpret mode on CPU)
    agrees to round-off on a tiny grid — closes the one previously
    hardware-only app path."""
    from adi_thermal_fields_tpu.apps.compare_implementations import (
        build_argparser, run)

    args = build_argparser().parse_args(
        ["--n", "12", "--steps", "2", "--precision", "float64"])
    res = run(args)
    assert res["max"] < 1e-9
    assert set(res["timings"]) == {"xla", "pallas"}


def test_engine_detects_nonfinite():
    """Failure detection: the event loop raises with simulation context when
    the field goes non-finite (the reference only logs suspicious values,
    waam_from_stl_v7_mm.py:503-506)."""
    import jax.numpy as jnp
    import pytest

    from adi_thermal_fields_tpu import CartesianGrid, Material
    from adi_thermal_fields_tpu.apps.engine import EventLoop

    grid = CartesianGrid(4, 4, 4, 1e-3)

    def bad_advance(T, active, dt, n_sub, t0=0.0):
        return T * jnp.nan

    act = jnp.full((4, 4, 4), -jnp.inf)  # all substrate
    loop = EventLoop(advance=bad_advance, activation_times=act,
                     deposit_T=1000.0, dt_cap=0.1)
    T = jnp.full(grid.shape, 20.0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        loop.run(T, frame_times=[1.0], t_end=1.0)


def test_single_track_with_goldak_torch(tmp_path):
    """Moving Goldak torch adds arc power on top of bead birth (new
    capability); the torch trail must heat the plate ahead of pure-birth."""
    from adi_thermal_fields_tpu.apps.single_track import build_argparser, run

    base = ["--plate_x_mm", "10", "--plate_y_mm", "14", "--plate_z_mm", "3",
            "--dx_mm", "1", "--track_len_mm", "6", "--t_tail", "0.2",
            "--nframes", "2", "--precision", "float64", "--out", ""]
    res_cold = run(build_argparser().parse_args(base))
    res_hot = run(build_argparser().parse_args(
        base + ["--goldak_power", "1500"]))
    t, T0, a = res_cold["frames"][-1]
    _, T1, _ = res_hot["frames"][-1]
    assert np.nanmean(np.where(a, T1, np.nan)) > np.nanmean(np.where(a, T0, np.nan)) + 5.0
    assert np.isfinite(T1[a]).all()


def test_waam_app_thermal_history(tmp_path):
    """--history_t_crit: the run must emit a waam_history.vtk whose T_peak
    dominates the final field, records the deposit temperature on deposited
    cells, and whose t_above is positive exactly where the peak crossed the
    threshold.  Also asserts every solid cell ended active (the f32
    birth-time regression deposited the last layer never)."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary
    from adi_thermal_fields_tpu.io.vtk import read_vtk_structured_points

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    outdir = str(tmp_path / "out")
    args = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2", "--save_vtk", "0",
        "--outdir", outdir, "--bead_height_mm", "2",
        "--history_t_crit", "800"])
    res = run(args)
    # every solid cell must be active at the end (last layer deposited)
    total_active = int(np.asarray(res["active"]).sum())
    fields = read_vtk_structured_points(os.path.join(outdir,
                                                     "waam_history.vtk"))
    pk, ta, mask = fields["T_peak"], fields["t_above"], fields["Mask"]
    assert int((mask > 0).sum()) == total_active
    T_end = np.asarray(res["T"])
    assert (pk[mask > 0] >= T_end[mask > 0] - 1e-3).all()
    # deposited (non-substrate) cells peaked at the deposit temperature
    assert pk[mask > 0].max() >= 1500.0 - 1e-3
    assert (ta[pk < 800.0] == 0.0).all()
    assert (ta[(mask > 0) & (pk >= 1500.0 - 1e-3)] > 0.0).all()
    # never-born cells are masked to zero in the history VTK
    assert (pk[mask == 0] == 0.0).all() and (ta[mask == 0] == 0.0).all()

    # checkpoint+resume preserves accumulated history (the peak of early
    # layers must survive a restart after they have cooled)
    ck = str(tmp_path / "ck.npz")
    args = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "3", "--save_vtk", "0",
        "--outdir", outdir, "--bead_height_mm", "2",
        "--history_t_crit", "800", "--checkpoint", ck])
    run(args)
    args2 = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2", "--save_vtk", "0",
        "--outdir", outdir, "--bead_height_mm", "2",
        "--history_t_crit", "800", "--resume", ck])
    run(args2)
    f2 = read_vtk_structured_points(os.path.join(outdir, "waam_history.vtk"))
    pk2 = f2["T_peak"]
    # the resumed run re-runs nothing (resume at t_end) yet must still
    # report the full-run peaks from the checkpointed history
    assert pk2[f2["Mask"] > 0].max() >= 1500.0 - 1e-3
    np.testing.assert_allclose(pk2[f2["Mask"] > 0].max(),
                               pk[mask > 0].max(), rtol=1e-6)


def test_waam_app_multi_threshold_history(tmp_path):
    """--history_t_crit '800,500': per-threshold t_above fields; their
    difference is the t8/5 cooling time — positive on deposited cells and
    zero where the peak never reached 800."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary
    from adi_thermal_fields_tpu.io.vtk import read_vtk_structured_points

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    outdir = str(tmp_path / "out")
    args = build_argparser().parse_args([
        "--stl", stl, "--dx_mm", "1", "--nframes", "2", "--save_vtk", "0",
        "--outdir", outdir, "--bead_height_mm", "2", "--h_side", "200",
        "--t_hold_s", "120", "--history_t_crit", "800,500"])
    run(args)
    fields = read_vtk_structured_points(os.path.join(outdir,
                                                     "waam_history.vtk"))
    pk = fields["T_peak"]
    ta8, ta5 = fields["t_above_800"], fields["t_above_500"]
    mask = fields["Mask"] > 0
    t85 = ta5 - ta8
    assert (t85 >= -1e-9).all()                    # 500-time dominates
    hot = mask & (pk >= 1500.0 - 1e-3)             # deposited cells
    assert (t85[hot] > 0.0).all()                  # they cooled through 800->500
    assert (ta8[pk < 800.0] == 0.0).all()


def test_waam_app_sharded_history_matches_single_device(tmp_path):
    """Sharded WAAM (--mesh 2x4) with multi-threshold thermal history:
    field AND history VTK bitwise-identical to the single-device run."""
    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary
    from adi_thermal_fields_tpu.io.vtk import read_vtk_structured_points

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(8.0, 8.0, 8.0), center=(4, 4, 4)))
    outs = {}
    for tag, mesh_args in (("single", []), ("sharded", ["--mesh", "2x4"])):
        out = str(tmp_path / tag)
        args = build_argparser().parse_args([
            "--stl", stl, "--dx_mm", "1", "--nframes", "2", "--save_vtk",
            "0", "--outdir", out, "--bead_height_mm", "2", "--t_hold_s",
            "60", "--history_t_crit", "800,500"] + mesh_args)
        res = run(args)
        f = read_vtk_structured_points(os.path.join(out, "waam_history.vtk"))
        outs[tag] = (np.asarray(res["T"]), f)
    Ts, fs = outs["single"]
    Tm, fm = outs["sharded"]
    np.testing.assert_array_equal(Ts, Tm)
    for k in ("T_peak", "t_above_800", "t_above_500"):
        np.testing.assert_array_equal(fs[k], fm[k])


def test_step_timer_slope_counts_steps():
    """StepTimer.time_steps times ``n_steps`` steps after ``warmup``
    untimed ones (block_until_ready around the timed loop) and returns the
    state after warmup + n steps."""
    import jax.numpy as jnp

    from adi_thermal_fields_tpu.io.profiling import StepTimer

    timer = StepTimer()
    calls = []
    def step(x):
        calls.append(1)
        return x + 1.0
    per_step, out = timer.time_steps(step, jnp.zeros(()), n_steps=8,
                                     warmup=1)
    assert 0.0 <= per_step < 10.0
    assert len(calls) == 1 + 8
    assert float(out) == float(len(calls))


def test_spiral_tube_varprop_history_smoke(tmp_path):
    """spiral_tube with the full varprop physics (latent heat + melt-pool k
    + radiation) and thermal-history tracking: deposits register their
    birth temperature as peak, t_above thresholds nest, never-born cells
    are masked to zero, and the npz artifact round-trips."""
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    out = str(tmp_path / "sp.gif")
    hout = str(tmp_path / "hist.npz")
    args = build_argparser().parse_args([
        "--R_out", "32", "--wall_thickness", "2", "--height", "4",
        "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
        "--pitch", "2", "--auto_speed", "--t_tot", "2", "--dt_fixed", "0.2",
        "--nframes", "2", "--out", out, "--latent_J_kg", "250000",
        "--melt_k_factor", "2", "--emissivity", "0.4",
        "--history_t_crit", "800,500", "--history_out", hout])
    res = run(args)
    h = res["history"]
    assert h["peak"].max() >= args.Ts - 1.0       # birth temperature seen
    assert (h["t_above"][1] >= h["t_above"][0]).all()   # 500C ⊇ 800C time
    t, T, a = res["frames"][-1]
    assert (h["peak"][~np.broadcast_to(a, h["peak"].shape)] == 0.0).all() \
        or a.all()
    d = np.load(hout)
    np.testing.assert_allclose(d["peak"], h["peak"])
    assert d["t_above"].shape[0] == 2


def test_spiral_tube_app_sharded_matches_single_device(tmp_path):
    """spiral_tube --mesh 2x4 (sharded cylindrical steps across the virtual
    8-device mesh) must reproduce the single-device run to 1e-12 at f64,
    for both the varprop and the constant-property robin paths."""
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    base = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
            "--z_back", "8", "--nr", "4", "--nphi", "16", "--dz", "2",
            "--pitch", "2", "--auto_speed", "--t_tot", "2",
            "--dt_fixed", "0.2", "--nframes", "2",
            "--precision", "float64",
            "--history_t_crit", "800,500", "--history_out", ""]
    for extra in ([], ["--latent_J_kg", "250000", "--emissivity", "0.4"]):
        out1 = str(tmp_path / "a.gif")
        r1 = run(build_argparser().parse_args(
            base + extra + ["--out", out1]))
        out2 = str(tmp_path / "b.gif")
        r2 = run(build_argparser().parse_args(
            base + extra + ["--out", out2, "--mesh", "2x4"]))
        np.testing.assert_allclose(np.asarray(r2["T"]), np.asarray(r1["T"]),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r2["history"]["t_above"],
                                   r1["history"]["t_above"],
                                   rtol=1e-12, atol=1e-12)


def test_spiral_tube_app_checkpoint_resume(tmp_path):
    """Interrupt-and-resume reproduces the uninterrupted run exactly:
    run to t=1 with --checkpoint, resume to t=2, compare with a straight
    t=2 run (fixed --speed so the deposition schedule is t_tot-invariant);
    thermal history resumes too."""
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    base = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
            "--z_back", "8", "--nr", "4", "--nphi", "16", "--dz", "2",
            "--pitch", "2", "--speed", "40", "--dt_fixed", "0.2",
            "--nframes", "2", "--precision", "float64",
            "--latent_J_kg", "250000", "--history_t_crit", "800,500",
            "--history_out", ""]
    ck = str(tmp_path / "ck.npz")
    run(build_argparser().parse_args(
        base + ["--t_tot", "1", "--checkpoint", ck,
                "--out", str(tmp_path / "a.gif")]))
    r_resumed = run(build_argparser().parse_args(
        base + ["--t_tot", "2", "--resume", ck,
                "--out", str(tmp_path / "b.gif")]))
    r_straight = run(build_argparser().parse_args(
        base + ["--t_tot", "2", "--out", str(tmp_path / "c.gif")]))
    np.testing.assert_allclose(np.asarray(r_resumed["T"]),
                               np.asarray(r_straight["T"]),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(r_resumed["history"]["t_above"],
                               r_straight["history"]["t_above"],
                               rtol=1e-13, atol=1e-13)


def test_cylindrical_vtk_structured_grid(tmp_path):
    """The cylindrical STRUCTURED_GRID writer emits valid legacy VTK with
    true tube points: header geometry, closed phi seam (duplicated first
    plane), and big-endian f32 payload sizes that account for every point."""
    from adi_thermal_fields_tpu.io.vtk import write_vtk_cylindrical_grid

    nr, nphi, nz = 3, 8, 5
    rng = np.random.default_rng(0)
    T = rng.random((nr, nphi, nz)).astype(np.float32)
    r = 10.0 + np.arange(nr)
    path = str(tmp_path / "tube.vtk")
    write_vtk_cylindrical_grid(path, {"T": T}, r=r, dphi=2 * np.pi / nphi,
                               dz=0.5, binary=True)
    raw = open(path, "rb").read()
    head = raw.split(b"LOOKUP_TABLE default\n")[0].decode("ascii",
                                                          "ignore")
    npts = nr * (nphi + 1) * nz
    assert f"DIMENSIONS {nr} {nphi + 1} {nz}" in head
    assert f"POINTS {npts} float" in head
    assert f"POINT_DATA {npts}" in head
    # payload: points block + one scalar block, both f32 big-endian
    pts_start = raw.index(b"float\n") + len(b"float\n")
    pts = np.frombuffer(raw[pts_start:pts_start + npts * 12], ">f4")
    xyz = pts.reshape(-1, 3)
    # radii recovered from the points match the input cell radii
    rr = np.hypot(xyz[:, 0], xyz[:, 1])
    assert np.isclose(rr.min(), r.min()) and np.isclose(rr.max(), r.max())
    # the duplicated seam plane carries the phi=0 data
    data_start = raw.index(b"LOOKUP_TABLE default\n") \
        + len(b"LOOKUP_TABLE default\n")
    vals = np.frombuffer(raw[data_start:data_start + npts * 4], ">f4")
    grid_vals = vals.reshape(nz, nphi + 1, nr)
    np.testing.assert_allclose(grid_vals[:, -1, :], grid_vals[:, 0, :])
    np.testing.assert_allclose(grid_vals[0, 0, :], T[:, 0, 0])


def test_spiral_tube_vtk_output(tmp_path):
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    vtk = str(tmp_path / "tube.vtk")
    args = build_argparser().parse_args([
        "--R_out", "32", "--wall_thickness", "2", "--height", "4",
        "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
        "--pitch", "2", "--auto_speed", "--t_tot", "2", "--dt_fixed", "0.2",
        "--nframes", "2", "--out", str(tmp_path / "sp.gif"),
        "--history_t_crit", "800", "--history_out", "", "--vtk", vtk])
    run(args)
    raw = open(vtk, "rb").read()
    assert b"DATASET STRUCTURED_GRID" in raw
    assert b"SCALARS T_peak" in raw and b"SCALARS t_above_800C" in raw


def test_spiral_tube_torch_source(tmp_path):
    """--torch_Q injects normalized Gaussian power at the nozzle: the run
    is strictly hotter than the no-torch run, and the extra energy in the
    part is of order Q*t (loose bound — films bleed some off)."""
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    base = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
            "--z_back", "8", "--nr", "4", "--nphi", "16", "--dz", "2",
            "--pitch", "2", "--auto_speed", "--t_tot", "2",
            "--dt_fixed", "0.2", "--nframes", "2",
            "--precision", "float64", "--history_out", ""]
    r0 = run(build_argparser().parse_args(
        base + ["--out", str(tmp_path / "a.gif")]))
    rq = run(build_argparser().parse_args(
        base + ["--out", str(tmp_path / "b.gif"),
                "--torch_Q", "2000", "--torch_sigma", "4"]))
    t, T0f, a = r0["frames"][-1]
    _, TQf, _ = rq["frames"][-1]
    assert (TQf[a] >= T0f[a] - 1e-9).all()
    dE = float(((TQf - T0f) * a).sum())    # proportional to added energy
    assert dE > 0.0
    # rho*cp*sum(dT*V) <= Q*t (films only REMOVE energy)
    import numpy as np_
    grid = rq["grid"]
    vol = (np_.asarray(grid.r) * grid.dr * grid.dphi
           * grid.dz)[:, None, None]
    E = 7800.0 * 490.0 * float(((TQf - T0f) * a * vol).sum())
    assert 0.0 < E <= 2000.0 * t * 1.01, E


def test_spiral_tube_resume_at_end_and_crit_mismatch(tmp_path):
    """Resume edge cases: resuming AT t_tot runs zero steps without
    crashing (gif skipped, result returned), and resuming with different
    --history_t_crit VALUES of the same arity is rejected."""
    import pytest
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    base = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
            "--z_back", "8", "--nr", "4", "--nphi", "16", "--dz", "2",
            "--pitch", "2", "--speed", "40", "--dt_fixed", "0.2",
            "--nframes", "2", "--history_out", ""]
    ck = str(tmp_path / "ck.npz")
    run(build_argparser().parse_args(
        base + ["--t_tot", "1", "--history_t_crit", "800,500",
                "--checkpoint", ck, "--out", str(tmp_path / "a.gif")]))
    r = run(build_argparser().parse_args(
        base + ["--t_tot", "1", "--history_t_crit", "800,500",
                "--resume", ck, "--out", str(tmp_path / "b.gif")]))
    assert "history" in r and not (tmp_path / "b.gif").exists()
    with pytest.raises(SystemExit, match="thresholds"):
        run(build_argparser().parse_args(
            base + ["--t_tot", "2", "--history_t_crit", "900,400",
                    "--resume", ck, "--out", str(tmp_path / "c.gif")]))


def test_spiral_tube_douglas_routing(tmp_path):
    """--scheme douglas with no varprop flags routes through the varprop
    step with constant tables (previously silently ignored): the run
    completes and differs from the BE run (second-order correction)."""
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    base = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
            "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
            "--pitch", "2", "--auto_speed", "--t_tot", "2",
            "--dt_fixed", "0.2", "--nframes", "2",
            "--precision", "float64", "--history_out", ""]
    r_be = run(build_argparser().parse_args(
        base + ["--out", str(tmp_path / "a.gif")]))
    r_dg = run(build_argparser().parse_args(
        base + ["--scheme", "douglas", "--out", str(tmp_path / "b.gif")]))
    d = np.abs(np.asarray(r_dg["T"]) - np.asarray(r_be["T"]))
    assert np.isfinite(np.asarray(r_dg["T"])).all()
    assert d.max() > 1e-6          # the scheme actually changed the answer


def test_spiral_tube_app_longz_matches_single_device(tmp_path):
    """--mesh z8 (tall-tube long-axis decomposition) reproduces the
    single-device run to substructuring round-off at f64."""
    from adi_thermal_fields_tpu.apps.spiral_tube import build_argparser, run

    base = ["--R_out", "32", "--wall_thickness", "2", "--height", "24",
            "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
            "--pitch", "4", "--auto_speed", "--t_tot", "2",
            "--dt_fixed", "0.2", "--nframes", "2",
            "--precision", "float64", "--latent_J_kg", "250000",
            "--emissivity", "0.4", "--history_out", ""]
    r1 = run(build_argparser().parse_args(
        base + ["--out", str(tmp_path / "a.gif")]))
    r2 = run(build_argparser().parse_args(
        base + ["--out", str(tmp_path / "b.gif"), "--mesh", "z8"]))
    np.testing.assert_allclose(np.asarray(r2["T"]), np.asarray(r1["T"]),
                               rtol=1e-9, atol=1e-9)


def test_cylindrical_vtk_roundtrip(tmp_path):
    """write_vtk_cylindrical_grid -> read_vtk_structured_grid roundtrip:
    fields recover exactly (minus the seam duplicate) and the points
    reproduce the (r, phi, z) lattice, in both binary and ASCII forms."""
    from adi_thermal_fields_tpu.io.vtk import (read_vtk_structured_grid,
                                               write_vtk_cylindrical_grid)

    nr, nphi, nz = 3, 8, 5
    rng = np.random.default_rng(1)
    T = rng.random((nr, nphi, nz)).astype(np.float32)
    r = 10.0 + np.arange(nr)
    for binary in (True, False):
        path = str(tmp_path / f"t_{binary}.vtk")
        write_vtk_cylindrical_grid(path, {"T": T}, r=r,
                                   dphi=2 * np.pi / nphi, dz=0.5,
                                   binary=binary)
        pts, fields = read_vtk_structured_grid(path)
        got = fields["T"][:, :nphi, :]           # drop the seam plane
        # binary is exact f32; ASCII goes through %.6g formatting
        np.testing.assert_allclose(got, T, rtol=1e-6 if binary else 1e-5)
        rr = np.hypot(pts[:, 0], pts[:, 1]).reshape(nz, nphi + 1, nr)
        np.testing.assert_allclose(rr[0, 0], r, rtol=1e-6)
        zz = pts[:, 2].reshape(nz, nphi + 1, nr)
        np.testing.assert_allclose(zz[:, 0, 0], 0.5 * np.arange(nz),
                                   atol=1e-6)


def test_waam_app_measured_layer_times(tmp_path):
    """--layer_times_s: measured per-layer durations (comma list and @file)
    replace the slab-area estimate; the birth schedule must be their
    cumulative sum, and a count mismatch must fail with a clear error."""
    import pytest

    from adi_thermal_fields_tpu.apps.waam_from_stl import build_argparser, run
    from adi_thermal_fields_tpu.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu.geometry.stl import save_stl_binary

    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    outdir = str(tmp_path / "out")
    base = ["--stl", stl, "--dx_mm", "1", "--nframes", "2", "--outdir",
            outdir, "--precision", "float64", "--bead_height_mm", "2"]

    res = run(build_argparser().parse_args(
        base + ["--layer_times_s", "2.0,3.0,4.0,5.0"]))
    np.testing.assert_allclose(res["births"], [2.0, 5.0, 9.0, 14.0])

    tf = tmp_path / "times.txt"
    tf.write_text("2.0\n3.0  # layer 2\n\n4.0\n5.0\n")
    res2 = run(build_argparser().parse_args(
        base + ["--layer_times_s", f"@{tf}"]))
    np.testing.assert_allclose(res2["births"], [2.0, 5.0, 9.0, 14.0])

    with pytest.raises(SystemExit, match="3 durations but 4 layers"):
        run(build_argparser().parse_args(
            base + ["--layer_times_s", "2,3,4"]))
