"""GPU smoke run of the photon-transport main path.

    python chip_smoke.py             # one card: phases a-d
    python chip_smoke.py --cards 4   # the --mesh path over four cards, only

One process drives the card(s); every input is generated from a seed.

Phases on one card, each timed through a user entry point and checked
against a float64 run of the same kernel on the host CPU (same seed, same
photon ids, ``CHECK_PHOTONS`` photons):

  a. flagship spectrum (BASELINE #1): Rayleigh tau=5 reflected light, full
     Stokes peel, 2^27 photons, f32, through ``cli.main`` build + run;
  b. 25x25 Stokes image (imaging_mono), 2^25 photons;
  c. 3-D patchy deck, 39 x 8 x 8 = 2,496 cells, 2^24 photons;
  d. nr=39 graded hydrostatic spectrum over 5 wavelengths, 2^24 photons per
     wavelength, compiled once for the whole spectrum.

f32 and f64 runs draw the same uniforms (transport/rng.py), so the two follow
the same photons and differ only where f32 rounding flips a decision.
Checks: detector I and Q/I within ``SIGMA_LIMIT`` MC standard errors (the
reference run's own photometry error), summed splat counts within
``COUNT_RTOL`` (f32 trajectory flips), mean scatters per photon within
``SCATTER_RTOL`` (a matmul run at reduced precision shifts it), and no
geometry errors on radial grids. A failed check exits non-zero. Image
moments on the card come from atomic scatter-adds in run-dependent order
(last-bit differences), far inside these limits; counts are exact.

``--cards 4`` runs the flagship with ``--mesh`` at 2^28 photons and compares
the mesh against one card: at f64 (2^18 photons) tallies within rtol 1e-10
and counts bit-equal; at f32 counts within ``COUNT_RTOL`` and I within
``SIGMA_LIMIT`` sigma. It prints the per-card rate.

The last stdout line is one JSON object naming the device JAX reports.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

CHECK_PHOTONS = 1 << 20
CPU_WIDTH = 1 << 12          # the CPU backend runs small pools fastest
SIGMA_LIMIT = 5.0
COUNT_RTOL = 5e-3
SCATTER_RTOL = 5e-3
MESH_F64_PHOTONS = 1 << 18
MESH_F64_RTOL = 1e-10

ARTES_IN = """\
* chip smoke: flagship
[photon]
photon:source=star
[star]
star:temperature=5800
[detector]
detector:type=spectrum
detector:theta=90
detector:phi=90
"""


def _fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


# ---------------------------------------------------------------------------
# compile-time bookkeeping: JAX reports the duration of every XLA backend
# compile (tracing and lowering events nest, so they are not summed); the
# main thread (the card) and the reference threads (CPU) are kept apart
# ---------------------------------------------------------------------------

COMPILE_EVENTS = ("/jax/core/compile/backend_compile_duration",)
_COMPILE_S: dict[int, float] = {}
_COMPILE_LOCK = threading.Lock()


def on_duration_event(event, duration, **_):
    """``jax.monitoring`` listener summing compile seconds per thread."""
    if event in COMPILE_EVENTS:
        tid = threading.get_ident()
        with _COMPILE_LOCK:
            _COMPILE_S[tid] = _COMPILE_S.get(tid, 0.0) + duration


def compile_seconds() -> float:
    """Compile seconds recorded so far on the calling thread."""
    return _COMPILE_S.get(threading.get_ident(), 0.0)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def flagship_input(root: str) -> str:
    """input/flagship/ for BASELINE #1: one 100 km Rayleigh shell of radial
    optical depth 5 at 0.7 micron, built through ``cli.main build``."""
    from artes import cli
    from artes.opacity import rayleigh
    from artes.opacity.base import write_opacity_fits

    d = os.path.join(root, "input", "flagship")
    os.makedirs(os.path.join(d, "opacity"), exist_ok=True)
    tab = rayleigh.generate([0.7])
    write_opacity_fits(os.path.join(d, "opacity", "rayleigh.fits"), tab)
    # tau = k * 100 km with k [1/m] = rho [kg m-3] * sigma / 10
    rho_cgs = float(5.0 / 100.0e3 / (tab.scattering[0] / 10.0) / 1.0e3)
    with open(os.path.join(d, "atmosphere.in"), "w") as fh:
        fh.write("[grid]\nradius: 1.\nradial: 100\ntheta:\nphi:\n\n"
                 "[composition]\ngas: off\nfits01: rayleigh.fits\n"
                 f"opacity01: 1, {rho_cgs!r}, 0, 1, 0, ntheta, 0, nphi\n")
    with open(os.path.join(d, "artes.in"), "w") as fh:
        fh.write(ARTES_IN)
    if cli.main(["build", "flagship", "--root", root]) != 0:
        _fail("cli build failed")
    return d


def spectrum_cfg(mode="spectrum", npix=1):
    from artes.config import ArtesConfig

    cfg = ArtesConfig()
    cfg.mode = mode
    cfg.npix = npix
    return cfg


# ---------------------------------------------------------------------------
# reference comparison
# ---------------------------------------------------------------------------

def kernel_run(atm, cfg, wl: int, seed: int, n: int, width: int, dtype,
               device=None):
    """One run_stream call on ``device``; returns host arrays and the
    platform of the device the outputs live on."""
    import jax

    from artes.config import detector_setup
    from artes.runner import _kernel_static
    from artes.transport.kernel import run_stream
    from artes.transport.tables import build_tables

    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, False)
    prep = build_tables(atm, cfg, det, wl, dtype=dtype)
    with (jax.default_device(device) if device is not None
          else contextlib.nullcontext()):
        out = jax.block_until_ready(
            run_stream(prep.tables, static, n, seed, width))
    platforms = {d.platform for d in out["detector"].devices()}
    host = {k: jax.device_get(v) for k, v in out.items()}
    host["platforms"] = platforms
    host["shape"] = (det.nx, det.ny)
    return host


def cpu_reference(atm, cfg, wl: int, seed: int, n: int = CHECK_PHOTONS):
    """The float64 run of the same kernel on the host CPU (thread-local x64
    and device context, so the card's f32 runs are untouched)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        return kernel_run(atm, cfg, wl, seed, n, CPU_WIDTH, jnp.float64,
                          device=jax.devices("cpu")[0])


def compare(gpu: dict, ref: dict, n: int, radial: bool) -> tuple[bool, str]:
    """Check a card run against the f64 reference run of the same photons."""
    import numpy as np

    from artes.runner import photometry_from_detector
    from artes.transport.kernel import scatter_total

    nx, ny = ref["shape"]
    dg = np.asarray(gpu["detector"], np.float64).reshape(nx, ny, 4, 3)
    dr = np.asarray(ref["detector"], np.float64).reshape(nx, ny, 4, 3)
    pg, pr = photometry_from_detector(dg), photometry_from_detector(dr)
    z_i = abs(pg[0] - pr[0]) / pr[1] if pr[1] > 0 else np.inf
    qi_g, qi_r = pg[2] / pg[0], pr[2] / pr[0]
    sig_qi = np.hypot(pr[3] / pr[0], qi_r * pr[1] / pr[0])
    z_q = abs(qi_g - qi_r) / sig_qi if sig_qi > 0 else np.inf
    cg, cr = dg[..., 0, 2].sum(), dr[..., 0, 2].sum()
    d_cnt = abs(cg - cr) / cr if cr > 0 else np.inf
    sg, sr = scatter_total(gpu["n_scatter"]) / n, scatter_total(ref["n_scatter"]) / n
    d_sc = abs(sg - sr) / sr if sr > 0 else np.inf
    n_err = int(gpu["n_error"])
    ok = (z_i <= SIGMA_LIMIT and z_q <= SIGMA_LIMIT and d_cnt <= COUNT_RTOL
          and d_sc <= SCATTER_RTOL and gpu["platforms"] == {"gpu"}
          and (n_err == 0 or not radial))
    text = (f"I {pg[0]:.9g} vs f64 {pr[0]:.9g} ({z_i:.3f} sigma, limit "
            f"{SIGMA_LIMIT:g}); Q/I {qi_g:.6g} vs {qi_r:.6g} ({z_q:.3f} sigma); "
            f"splat counts {cg:.0f} vs {cr:.0f} ({d_cnt:.3e}, limit "
            f"{COUNT_RTOL:g}); scatters/photon {sg:.6f} vs {sr:.6f} "
            f"({d_sc:.3e}, limit {SCATTER_RTOL:g}); n_error {n_err} vs "
            f"{int(ref['n_error'])}{' (must be 0)' if radial else ''}; "
            f"outputs on {sorted(gpu['platforms'])}")
    return ok, text


def report(phase: str, photons: int, wall: float, compile_s: float,
           extra: str = ""):
    rate = photons / wall
    steady = photons / max(wall - compile_s, 1e-9)
    print(f"[{phase}] photons={photons} wall_s={wall!r} photons_per_s={rate!r} "
          f"photons_per_s_excl_compile={steady!r} compile_s={compile_s!r}"
          f"{extra}", flush=True)


def pool_stats(photons: int, n_rounds: int, n_error: int) -> str:
    return (f" n_rounds={n_rounds} photons_per_round="
            f"{photons / max(n_rounds, 1)!r} n_error={n_error}")


def checked(phase: str, gpu: dict, ref: dict, n: int, radial: bool) -> bool:
    ok, text = compare(gpu, ref, n, radial)
    print(f"[{phase}] check at {n} photons vs CPU f64: {text} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

PHOTONS = {"a": 1 << 27, "b": 1 << 25, "c": 1 << 24, "d": 1 << 24}


def run_one_card(work: str, photons=PHOTONS,
                 check_photons=CHECK_PHOTONS) -> bool:
    """Phases a-d; returns True when every check passes."""
    from artes import presets
    from artes.atmosphere import load_artifact

    seeds = {"a": 11, "b": 23, "c": 29, "d": 31}
    d_in = flagship_input(work)
    flag_atm = load_artifact(os.path.join(d_in, "atmosphere.fits"))
    img_cfg = spectrum_cfg("imaging_mono", 25)
    deck = presets.patchy_deck()
    graded = presets.graded_column()
    cases = {"a": (flag_atm, spectrum_cfg(), True),
             "b": (flag_atm, img_cfg, True),
             "c": (deck, spectrum_cfg(), False),
             "d": (graded, spectrum_cfg(), True)}
    # the f64 references run on the host CPU while the card works
    with ThreadPoolExecutor(max_workers=len(cases)) as pool:
        refs = {k: pool.submit(cpu_reference, atm, cfg, 0, seeds[k],
                               check_photons)
                for k, (atm, cfg, _) in cases.items()}
        return _one_card_phases(work, photons, check_photons, seeds, cases,
                                flag_atm, refs)


def _one_card_phases(work, photons, check_photons, seeds, cases, flag_atm,
                     refs) -> bool:
    import jax.numpy as jnp
    import numpy as np

    from artes import cli, runner
    from artes.transport.kernel import run_stream

    f32 = jnp.float32
    all_ok = True

    def check(k):
        atm, cfg, radial = cases[k]
        gpu = kernel_run(atm, cfg, 0, seeds[k], check_photons,
                         runner.pool_width(photons[k]), f32)
        return checked(k, gpu, refs[k].result(), check_photons, radial)

    # a. flagship through the CLI
    c0, t0 = compile_seconds(), time.perf_counter()
    if cli.main(["flagship", str(photons["a"]), "-o", "run", "--root", work,
                 "--seed", str(seeds["a"])]) != 0:
        _fail("cli run failed")
    wall = time.perf_counter() - t0
    row = np.loadtxt(os.path.join(work, "output", "run", "output",
                                  "spectrum.dat"), ndmin=2)[0]
    if not (np.isfinite(row).all() and row[1] > 0):
        _fail(f"flagship spectrum row not finite/positive: {row}")
    gpu_a = kernel_run(flag_atm, spectrum_cfg(), 0, seeds["a"], check_photons,
                       runner.pool_width(photons["a"]), f32)
    report("a flagship cli", photons["a"], wall, compile_seconds() - c0,
           pool_stats(check_photons, int(gpu_a["n_rounds"]),
                      int(gpu_a["n_error"]))
           + f" (check run) spectrum_row={row.tolist()}")
    all_ok &= checked("a", gpu_a, refs["a"].result(), check_photons, True)

    # b. / c. single-wavelength runs through the runner
    for k, label in (("b", "b imaging 25x25"), ("c", "c patchy 39x8x8")):
        atm, cfg, radial = cases[k]
        c0, t0 = compile_seconds(), time.perf_counter()
        _, res = runner.run_imaging_mono(atm, cfg, photons[k], seed=seeds[k],
                                         dtype=f32)
        wall = time.perf_counter() - t0
        if not np.isfinite(res.detector).all() or res.photometry[0] <= 0:
            _fail(f"phase {k}: detector not finite/positive")
        report(label, photons[k], wall, compile_seconds() - c0,
               pool_stats(photons[k], res.n_rounds, res.n_error)
               + f" I={res.photometry[0]!r}")
        all_ok &= check(k)

    # d. multi-wavelength spectrum: one compile for the whole spectrum
    atm, cfg, _ = cases["d"]
    before = run_stream._cache_size()
    c0, t0 = compile_seconds(), time.perf_counter()
    _, results = runner.run_spectrum(atm, cfg, photons["d"], seed=seeds["d"],
                                     dtype=f32)
    wall = time.perf_counter() - t0
    n_compiles = run_stream._cache_size() - before
    total = photons["d"] * len(results)
    report("d graded nr=39 spectrum", total, wall, compile_seconds() - c0,
           pool_stats(total, sum(r.n_rounds for r in results),
                      sum(r.n_error for r in results))
           + f" wavelengths={len(results)} kernel_compiles={n_compiles} "
           f"I={[r.photometry[0] for r in results]!r}")
    if n_compiles != 1:
        print(f"[d] expected one compile for the spectrum, got {n_compiles}"
              " -> FAIL", flush=True)
        all_ok = False
    all_ok &= check("d")
    return all_ok


def run_four_cards(work: str, photons: int = 1 << 28,
                   f64_photons: int = MESH_F64_PHOTONS,
                   f32_photons: int = 1 << 28) -> bool:
    """The --mesh path over four cards, compared with one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from artes import cli
    from artes.atmosphere import load_artifact
    from artes.config import detector_setup
    from artes.parallel import make_mesh
    from artes.runner import pool_width, run_wavelength

    n_dev = len(jax.devices())
    d_in = flagship_input(work)
    atm = load_artifact(os.path.join(d_in, "atmosphere.fits"))
    cfg = spectrum_cfg()
    det = detector_setup(cfg, float(atm.rfront[-1]))
    mesh = make_mesh()
    seed = 11
    all_ok = True

    c0, t0 = compile_seconds(), time.perf_counter()
    if cli.main(["flagship", str(photons), "-o", "mesh", "--root", work,
                 "--mesh", "--seed", str(seed)]) != 0:
        _fail("cli --mesh run failed")
    wall = time.perf_counter() - t0
    row = np.loadtxt(os.path.join(work, "output", "mesh", "output",
                                  "spectrum.dat"), ndmin=2)[0]
    ok = bool(np.isfinite(row).all() and row[1] > 0)
    all_ok &= ok
    report(f"mesh cli --mesh x{n_dev}", photons, wall, compile_seconds() - c0,
           f" per_card_photons_per_s={photons / wall / n_dev!r} "
           f"spectrum_row={row.tolist()}{'' if ok else ' -> FAIL'}")

    def timed(m, n, dtype):
        # compile outside the timing: one pool's worth of photons per
        # device gives the timed run's pool width
        k = 1 if m is None else n_dev
        run_wavelength(atm, cfg, det, 0, k * pool_width(-(-n // k)),
                       seed=seed, dtype=dtype, mesh=m)
        t = time.perf_counter()
        res = run_wavelength(atm, cfg, det, 0, n, seed=seed, dtype=dtype,
                             mesh=m)
        return res, time.perf_counter() - t

    # f32: mesh vs one card, statistically
    r4, t4 = timed(mesh, f32_photons, jnp.float32)
    r1, t1 = timed(None, f32_photons, jnp.float32)
    z = abs(r4.photometry[0] - r1.photometry[0]) / r1.photometry[1]
    c4, c1 = r4.detector[..., 0, 2].sum(), r1.detector[..., 0, 2].sum()
    d_cnt = abs(c4 - c1) / c1
    ok = z <= SIGMA_LIMIT and d_cnt <= COUNT_RTOL
    all_ok &= ok
    print(f"[mesh f32] {f32_photons} photons: x{n_dev} {t4!r} s "
          f"({f32_photons / t4 / n_dev!r} photons/s per card), one card "
          f"{t1!r} s ({f32_photons / t1!r} photons/s), scaling efficiency "
          f"{t1 / (n_dev * t4)!r}; I {z:.3f} sigma (limit {SIGMA_LIMIT:g}), "
          f"counts {d_cnt:.3e} (limit {COUNT_RTOL:g}) -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)

    # f64: the same photons on four cards and on one, to summation order
    with jax.enable_x64(True):
        r4 = run_wavelength(atm, cfg, det, 0, f64_photons, seed=seed,
                            dtype=jnp.float64, mesh=mesh)
        r1 = run_wavelength(atm, cfg, det, 0, f64_photons, seed=seed,
                            dtype=jnp.float64)
    rel = np.max(np.abs(r4.detector - r1.detector)
                 / np.maximum(np.abs(r1.detector), 1e-300))
    same = np.array_equal(r4.detector[..., 2], r1.detector[..., 2])
    ok = rel <= MESH_F64_RTOL and same and r4.n_scatter == r1.n_scatter
    all_ok &= ok
    print(f"[mesh f64] {f64_photons} photons: max rel diff {rel:.3e} (limit "
          f"{MESH_F64_RTOL:g}), counts bit-equal {same}, scatters "
          f"{r4.n_scatter} vs {r1.n_scatter} -> {'PASS' if ok else 'FAIL'}",
          flush=True)
    return all_ok


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process that
    does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        _fail(f"nvidia-smi failed: {e}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    if not os.path.isfile(os.path.join(ROOT, "artes", "__init__.py")):
        _fail("the artes package is not beside this script", 2)
    sys.path.insert(0, ROOT)
    # the f64 references need the CPU backend beside the card's
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    if jax.default_backend() != "gpu":
        _fail(f"no GPU: JAX's default backend is {jax.default_backend()!r}", 2)
    devices = jax.devices()
    if len(devices) < args.cards:
        _fail(f"--cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(devices)}", 2)
    d0 = devices[0]
    print(f"jax {jax.__version__} devices: platform={d0.platform} "
          f"device_kind={d0.device_kind} count={len(devices)}", flush=True)
    print(f"nvidia-smi: {card_name_and_power()}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(on_duration_event)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.cards == 4:
            ok = run_four_cards(work)
        else:
            ok = run_one_card(work)
    print(f"total_s={time.perf_counter() - t0!r}", flush=True)
    if not ok:
        _fail("a check failed")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
