"""Command-line interface: the reference's run contract.

Usage (mirrors README:1-147 / ARTES.f90:4232-4309):

    python -m artes.cli <atmosphere> <photons> -o <run> [-k key=value ...]
    python -m artes.cli build <atmosphere>         # atmosphere.py equivalent

Reads ``input/<atmosphere>/artes.in`` (+ atmosphere.fits), runs the configured
mode, and writes the full output tree ``output/<run>/{input,output,plot}`` with
input snapshotting (the reference copies inputs and appends -k overrides,
ARTES.f90:4283-4304).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np


def build_main(argv=None):
    p = argparse.ArgumentParser(prog="artes build")
    p.add_argument("atmosphere", help="name under input/")
    p.add_argument("--root", default=".")
    args = p.parse_args(argv)
    from artes.atmosphere import build_and_write

    directory = os.path.join(args.root, "input", args.atmosphere)
    atm = build_and_write(directory)
    print(f"atmosphere.fits written: nr={atm.nr} ntheta={atm.ntheta} "
          f"nphi={atm.nphi} n_wavelength={atm.n_wavelength}")
    return 0


def run_main(argv=None):
    p = argparse.ArgumentParser(
        prog="artes",
        description="Polarized Monte Carlo radiative transfer")
    p.add_argument("atmosphere", help="input directory name under input/")
    p.add_argument("photons", type=float, help="number of photon packages")
    p.add_argument("-o", "--output", default="run", help="output directory name")
    p.add_argument("-k", "--keyword", action="append", default=[],
                   metavar="key=value", help="override any artes.in key")
    p.add_argument("--root", default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=None,
                   help="regeneration-pool width cap per device "
                        "(default runner.POOL_WIDTH)")
    p.add_argument("--f64", action="store_true", help="run transport in float64")
    p.add_argument("--mesh", action="store_true",
                   help="shard photons over all local devices")
    p.add_argument("--resume", action="store_true",
                   help="skip wavelengths already present in spectrum.dat "
                        "(per-wavelength outputs are idempotent)")
    p.add_argument("--progress", action="store_true",
                   help="per-chunk progress ticker on stderr (always on when "
                        "stderr is a tty; the reference's 20..100%% lines)")
    p.add_argument("--debug-stokes", action="store_true",
                   help="in-kernel Stokes anomaly check I^2 >= Q^2+U^2+V^2 "
                        "(the reference's error 050, ARTES.f90:830-835); "
                        "anomalous photons are abandoned and tallied")
    args = p.parse_args(argv)

    if args.f64:
        # without this, jnp.float64 silently degrades to f32 while the
        # geometry tables still pick f64-sized epsilons — the worst of both
        import jax
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from artes.atmosphere import load_artifact
    from artes.config import detector_setup, load_config, snapshot
    from artes import output as out
    from artes import runner

    atm_dir = os.path.join(args.root, "input", args.atmosphere)
    cfg = load_config(os.path.join(atm_dir, "artes.in"), overrides=args.keyword)
    atm = load_artifact(os.path.join(atm_dir, "atmosphere.fits"))
    cfg.debug_stokes = args.debug_stokes
    packages = int(args.photons)

    # output tree + input snapshot: the FULL input tree, incl. opacity FITS
    # and the atmosphere artifact, so the snapshot alone reproduces the run
    # (the reference copies the whole input dir, ARTES.f90:4283-4293)
    dirs = out.OutputDirs(args.root, args.output)
    for name in sorted(os.listdir(atm_dir)):
        src = os.path.join(atm_dir, name)
        if os.path.isfile(src):
            shutil.copy(src, dirs.input)
        elif os.path.isdir(src):
            shutil.copytree(src, os.path.join(dirs.input, name),
                            dirs_exist_ok=True)
    with open(os.path.join(dirs.input, "artes.in.effective"), "w") as fh:
        fh.write(snapshot(cfg))

    dtype = jnp.float64 if args.f64 else jnp.float32
    mesh = None
    if args.mesh:
        from artes.parallel import make_mesh
        # the regeneration pool runs on every local device, each on its own
        # photon-id sub-range (parallel/mesh.py)
        mesh = make_mesh()

    kw = dict(seed=args.seed,
              batch_size=args.batch_size or runner.POOL_WIDTH, dtype=dtype,
              mesh=mesh,
              progress=sys.stderr.isatty() or args.progress)

    det = detector_setup(cfg, float(atm.rfront[-1]))
    report = out.RunReport(dirs, cfg.log_file)
    report.stage1(cfg, atm, det)
    out.write_plot_dat(dirs, cfg, atm, det)
    n_error = 0
    n_capped = 0
    n_anomaly = 0
    n_runs = 0
    error_codes = np.zeros(4, np.int64)
    error_records = []

    def _rec(res):
        nonlocal n_capped, n_anomaly, n_runs
        n_capped += res.n_alive_at_cap
        n_anomaly += getattr(res, "n_stokes_anomaly", 0)
        n_runs += 1
        if len(error_records) < 16 and getattr(res, "error_records", None) is not None:
            error_records.extend(list(res.error_records))

    if cfg.mode == "spectrum":
        done = set()
        if args.resume and os.path.isfile(dirs.path("spectrum.dat")):
            # per-wavelength rows are idempotent: completed wavelengths are
            # kept across restarts (SURVEY.md section 5 resume strategy)
            for line in open(dirs.path("spectrum.dat")):
                line = line.strip()
                if line and not line.startswith("#"):
                    done.add(round(float(line.split()[0]), 9))
        todo = [wl for wl in range(atm.n_wavelength)
                if round(atm.wavelengths[wl] * 1e6, 9) not in done]
        if args.resume and len(todo) < atm.n_wavelength:
            print(f"resume: skipping {atm.n_wavelength - len(todo)} completed "
                  f"wavelengths", file=sys.stderr)
        det, results = runner.run_spectrum(atm, cfg, packages, wl_subset=todo,
                                           **kw)
        res = None
        for wl, res in zip(todo, results):
            if wl == 0:
                report.stage2(cfg, atm, det, packages, 0, res.cell_depth)
            wl_m = atm.wavelengths[wl]
            out.write_spectrum_row(dirs, wl_m, res)
            out.write_optical_depth(dirs, atm, wl)
            out.write_cell_depth(dirs, wl_m, res.cell_depth)
            # flow files are (over)written per wavelength, like the
            # reference's per-run write_output (ARTES.f90:3713-3770) —
            # the files left behind are the last wavelength's
            if cfg.flow_global and res.flow_global is not None:
                out.write_flow_global(dirs, res.flow_global, res.cell_depth)
            if cfg.flow_theta and res.flow_theta is not None:
                out.write_flow_latitudinal(dirs, res.flow_theta,
                                           res.flux_exit, res.cell_depth)
            if cfg.photon_source == "star":
                out.write_normalization(dirs, cfg, atm, wl_m)
            else:
                out.write_luminosity(dirs, wl_m, res, packages)
            n_error += res.n_error
            error_codes += res.error_codes
            _rec(res)
            print(f"Wavelength: {wl_m * 1e6:7.3f} micron", file=sys.stderr)
        if res is not None:
            report.stage3(cfg, atm, res, atm.n_wavelength - 1)
        else:
            print("resume: nothing to do", file=sys.stderr)

    elif cfg.mode == "imaging_mono":
        det, res = runner.run_imaging_mono(atm, cfg, packages, **kw)
        report.stage2(cfg, atm, det, packages, 0, res.cell_depth)
        out.write_stokes_fits(dirs, det, res)
        out.write_photometry(dirs, atm.wavelengths[0], res)
        out.write_cell_depth(dirs, atm.wavelengths[0], res.cell_depth)
        if cfg.photon_source == "star":
            out.write_normalization(dirs, cfg, atm, atm.wavelengths[0])
        else:
            out.write_luminosity(dirs, atm.wavelengths[0], res, packages)
            if res.prep.cell_luminosity is not None:
                out.write_cell_luminosity(dirs, res.prep.cell_luminosity)
        if cfg.flow_global and res.flow_global is not None:
            out.write_flow_global(dirs, res.flow_global, res.cell_depth)
        if cfg.flow_theta and res.flow_theta is not None:
            out.write_flow_latitudinal(dirs, res.flow_theta, res.flux_exit,
                                       res.cell_depth)
        n_error += res.n_error
        error_codes += res.error_codes
        _rec(res)
        report.stage3(cfg, atm, res)

    elif cfg.mode == "imaging_broad":
        det, summed, tallies = runner.run_imaging_broad(atm, cfg, packages, **kw)
        report.stage2(cfg, atm, det, packages, 0, tallies[0].cell_depth)
        out.write_stokes_fits(dirs, det, summed)
        for wl, res in enumerate(tallies):
            out.write_optical_depth(dirs, atm, wl)
            n_error += res.n_error
            error_codes += res.error_codes
            _rec(res)
        report.stage3(cfg, atm, summed)

    elif cfg.mode == "phase":
        results = runner.run_phase_curve(atm, cfg, packages, **kw)
        report.stage2(cfg, atm, results[0][1], packages, 0, results[0][2].cell_depth)
        for ang, det_a, res in results:
            out.write_phase_row(dirs, ang, res)
            if cfg.photon_source == "star" and ang < 1.0:
                out.write_normalization(dirs, cfg, atm, atm.wavelengths[0])
            if cfg.flow_global and res.flow_global is not None:
                out.write_flow_global(dirs, res.flow_global, res.cell_depth)
            if cfg.flow_theta and res.flow_theta is not None:
                out.write_flow_latitudinal(dirs, res.flow_theta,
                                           res.flux_exit, res.cell_depth)
            n_error += res.n_error
            error_codes += res.error_codes
            _rec(res)
            print(f"\rPhase angle: {ang:6.1f} degrees", end="", file=sys.stderr)
        print(file=sys.stderr)

    if n_error or error_codes.any():
        # per-code tallies mirroring the reference's numbered error log
        # (ARTES.f90:3397-3416, :4218-4228)
        entries = [(code, int(cnt)) for code, cnt in zip(
            ("031/geometry no-candidate", "032/runaway traversal",
             "034/degenerate surface bounce", "05x/peel walk"), error_codes)
            if cnt]
        if n_anomaly:
            entries.append(("050/stokes anomaly", n_anomaly))
        out.write_error_log(dirs, entries, error_records[:16])
    # n_capped sums over every run (wavelength / phase angle), so the
    # denominator is the TOTAL emitted count, not one run's package count
    report.truncation(n_capped, packages * max(n_runs, 1), cfg.max_scatter)
    report.stage4(n_error)
    out.send_completion_email(cfg, args.output)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "build":
        return build_main(argv[1:])
    return run_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
