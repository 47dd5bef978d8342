"""Run orchestration: wavelength/mode loops, batching, detector finalisation.

Mirrors the reference's ``run`` dispatcher (ARTES.f90:121-267): spectrum mode
re-runs transport per wavelength and appends one row per run; imaging_broad
accumulates a single detector across wavelengths; phase mode sweeps 73
detector azimuths at 2.5-degree steps; imaging_mono is a single run. Photon
batches are dispatched to the jitted kernel and reduced host-side in float64.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from artes.config import ArtesConfig, DetectorSetup, detector_setup
from artes.constants import PI, planck_lambda
from artes.parallel.mesh import run_stream_mesh
from artes.transport.kernel import (ERR_RECORD_K, KernelStatic,
                                    order_error_records, run_stream,
                                    scatter_total)
from artes.transport.tables import PreparedWavelength, build_tables

# Pool width cap (``batch_size``): lanes of the regeneration pool per device.
# A round costs ~120 us of launches up to 2^16 lanes on the H100, so wider
# pools amortise it: the flagship ran 24/44/56/83/68M photons/s at
# 2^15..2^19 lanes, the 25x25 image 21/40/47/61/55M (PERF.md).
POOL_WIDTH = 1 << 18

PHASE_ANGLES_DEG = [1.0e-5] + [2.5 * i for i in range(1, 72)] + [180.0 - 1.0e-5]  # (:215-229)


def stellar_area_factor(cfg: ArtesConfig) -> float:
    """Beam cross-section of the oblate silhouette over the polar disk.

    The stellar beam illuminates the ellipsoid silhouette (area
    pi Rp^2 |S u| / (abc) with S = diag(1-ob, 1-ob, 1)); the reference's
    pi Rp^2 normalisation (ARTES.f90:2515-2531) assumes a sphere. 1.0 when
    not oblate.
    """
    a = b = 1.0 - cfg.oblateness
    c = 1.0
    if cfg.stellar_direction:
        st, ct = np.sin(cfg.theta_star), np.cos(cfg.theta_star)
        sp, cp = np.sin(cfg.phi_star), np.cos(cfg.phi_star)
        u = (-st * cp, -st * sp, -ct)
    else:
        u = (-1.0, 0.0, 0.0)
    return float(np.sqrt((a * u[0]) ** 2 + (b * u[1]) ** 2 + (c * u[2]) ** 2)
                 / (a * b * c))


def package_energy(cfg: ArtesConfig, atm, wl_index: int, packages: int,
                   emissivity_total: float, crescent: bool = False) -> float:
    """Photon package energy [W m-2 m-1 at the observer] (ARTES.f90:2509-2539)."""
    if cfg.photon_source == "star":
        flux = PI * planck_lambda(cfg.t_star, atm.wavelengths[wl_index])  # stellar surface flux
        r_p = atm.rfront[-1]
        e = PI * flux * r_p * r_p * cfg.r_star * cfg.r_star / (
            cfg.orbit * cfg.orbit * cfg.distance_planet * cfg.distance_planet * packages)
        e *= stellar_area_factor(cfg)
        if crescent:
            e *= 0.19  # crescent disk fraction (:2527-2531)
        return float(e)
    return emissivity_total / (cfg.distance_planet ** 2 * packages)


@dataclasses.dataclass
class WavelengthResult:
    detector: np.ndarray        # (nx, ny, 4, 3) energy-scaled moments
    photometry: np.ndarray      # (11,) (ARTES.f90:977-1004)
    flux_emitted: float         # unitless Stokes-I tallies (thermal)
    flux_exit: float
    n_error: int
    n_alive_at_cap: int
    cell_depth: int
    prep: PreparedWavelength
    # error-050 tally from the debug Stokes-anomaly check (KernelStatic
    # .debug_stokes; ARTES.f90:830-835)
    n_stokes_anomaly: int = 0
    # per-code tallies [031 geometry, 032 runaway, 034 degenerate bounce,
    # peel-walk] mirroring the reference's numbered error log
    error_codes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.int64))
    flow_global: np.ndarray | None = None   # (nr, ntheta, nphi, 3)
    flow_theta: np.ndarray | None = None    # (nr, ntheta, nphi, 4)
    # first-K error-event state dumps (kernel.ERR_RECORD_W columns each)
    error_records: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 16)))
    # regeneration-pool counters (0 on the explicit-dispatch path): device
    # loop rounds summed over chunks, and scattering events
    n_rounds: int = 0
    n_scatter: int = 0


def _kernel_static(cfg: ArtesConfig, det: DetectorSetup, atm, crescent: bool) -> KernelStatic:
    geom = 4 * (atm.nr + atm.ntheta + atm.nphi) + 16
    return KernelStatic(
        nx=det.nx, ny=det.ny,
        photon_source=1 if cfg.photon_source == "star" else 2,
        photon_emission=1 if cfg.photon_emission == "isotropic" else 2,
        photon_scattering=cfg.photon_scattering,
        stellar_direction=cfg.stellar_direction,
        crescent=crescent,
        thermal_weight=cfg.thermal_weight,
        max_scatter=cfg.max_scatter,
        max_crossings=geom,
        track_flow=cfg.flow_global or cfg.flow_theta,
        has_surface=cfg.surface_albedo > 0.0,
        debug_stokes=getattr(cfg, "debug_stokes", False),
    )


def pool_width(packages: int, batch_size: int = POOL_WIDTH) -> int:
    """Regeneration-pool width for a run of ``packages`` photons on one
    device: the next power of two, at least 1024 and at most
    ``batch_size``."""
    return max(1024, min(1 << int(np.ceil(np.log2(max(packages, 2)))),
                         batch_size))


def run_wavelength(atm, cfg: ArtesConfig, det: DetectorSetup, wl_index: int,
                   packages: int, seed: int = 0, batch_size: int = POOL_WIDTH,
                   dtype=jnp.float64, crescent: bool = False,
                   dispatch=None, mesh=None,
                   progress: bool = False) -> WavelengthResult:
    """Transport ``packages`` photons at one wavelength.

    The default path is the regeneration pool (:func:`run_stream`): a
    fixed-width lane pool with in-loop refill, one device dispatch per
    <=2^30-photon chunk (``batch_size`` caps the pool width). ``mesh`` (a
    1-D ``jax.sharding.Mesh``) runs that pool on every mesh device, each on
    its own contiguous photon-id sub-range, with psum-reduced tallies
    (:func:`artes.parallel.run_stream_mesh`). ``dispatch(tables, static,
    photon_ids, seed)`` instead runs explicit photon batches through
    ``run_batch``-compatible code (tests, the batch shard_map).
    """
    prep = build_tables(atm, cfg, det, wl_index, dtype=dtype)
    static = _kernel_static(cfg, det, atm, crescent)
    if mesh is not None and mesh.devices.size == 1:
        mesh = None

    npix = det.nx * det.ny
    detector = np.zeros((npix, 4, 3), np.float64)
    flow_g = np.zeros((atm.nr * atm.ntheta * atm.nphi, 3), np.float64)
    flow_t = np.zeros((atm.nr * atm.ntheta * atm.nphi, 4), np.float64)
    flux_emitted = 0.0
    flux_exit = 0.0
    n_error = 0
    n_alive = 0
    n_anom = 0
    n_rounds = 0
    n_scatter = 0
    error_codes = np.zeros(4, np.int64)
    error_records = []

    def _collect(out):
        nonlocal n_anom
        n_anom += int(out.get("n_stokes_anomaly", 0))
        if "error_records" in out and len(error_records) < 2 * ERR_RECORD_K:
            rec = np.asarray(out["error_records"])
            ks = np.atleast_1d(np.asarray(out["n_error_records"]))
            # one forensics ring per device under a mesh
            for r, k in zip(rec.reshape((-1,) + rec.shape[-2:]), ks):
                if k:
                    error_records.append(order_error_records(r, k))
    if dispatch is None:
        # The regeneration pool: dead lanes are refilled inside the device
        # loop (~100 % lane occupancy; run_batch's while-any-alive tail
        # wastes >80 % of round work instead). The photon count is traced,
        # so photon-count changes do not recompile.
        n_dev = 1 if mesh is None else int(mesh.devices.size)
        width = pool_width(-(-packages // n_dev), batch_size)
        if mesh is not None:
            kern = functools.partial(run_stream_mesh, mesh=mesh)
        else:
            kern = run_stream
        # chunks of 2^30 photons with a continuous 64-bit global id space:
        # photon id = chunk start + in-chunk index, so the (seed, id)->stream
        # mapping is independent of how the run is chunked (the reference's
        # integer(16) package counter, ARTES.f90:26, :4254). Chunk starts are
        # 2^30-aligned, so a chunk never straddles a 2^32 id boundary.
        # The chunking is semantics-free, so progress mode splits the run
        # into >=5 chunks for a host-side ticker (the reference's
        # 20/40/../100% lines, ARTES.f90:571-590)
        chunk = 1 << 30
        if progress:
            # never chunk below the pool width (an underfilled pool wastes
            # lanes); runs >= 5x width get >= 5 ticks
            chunk = min(chunk, max(width * n_dev, -(-packages // 5)))
        start = 0
        while start < packages:
            n = min(chunk, packages - start,
                    (1 << 32) - (start & 0xFFFFFFFF))
            out = kern(prep.tables, static, n, seed, width,
                       start >> 32, start & 0xFFFFFFFF)
            detector += np.asarray(out["detector"], np.float64)
            if static.track_flow:
                flow_g += np.asarray(out["flow_global"], np.float64)
                flow_t += np.asarray(out["flow_theta"], np.float64)
            flux_emitted += float(out["flux_emitted"])
            flux_exit += float(out["flux_exit"])
            n_error += int(out["n_error"])
            n_alive += int(out["n_alive_at_cap"])
            error_codes += np.asarray(out["error_codes"], np.int64)
            n_rounds += int(out["n_rounds"])
            n_scatter += scatter_total(out["n_scatter"])
            _collect(out)
            start += n
            if progress:
                import sys
                print(f"  [{100 * start // packages:3d}%] "
                      f"{start:,} / {packages:,} photons",
                      file=sys.stderr, flush=True)
    else:
        # explicit dispatch (batch shard_map, tests).
        # Photon ids are the low id word; the high word folds into the key,
        # and chunks are clipped at 2^32 boundaries so arange never wraps.
        fn = dispatch
        start = 0
        while start < packages:
            lo = start & 0xFFFFFFFF
            n = min(batch_size, packages - start, (1 << 32) - lo)
            ids = jnp.arange(lo, lo + n, dtype=jnp.uint32)
            out = fn(prep.tables, static, ids,
                     (seed + (start >> 32) * 0x9E3779B9) & 0xFFFFFFFF)
            detector += np.asarray(out["detector"], np.float64)
            if static.track_flow:
                flow_g += np.asarray(out["flow_global"], np.float64)
                flow_t += np.asarray(out["flow_theta"], np.float64)
            flux_emitted += float(out["flux_emitted"])
            flux_exit += float(out["flux_exit"])
            n_error += int(out["n_error"])
            n_alive += int(out["n_alive_at_cap"])
            error_codes += np.asarray(out["error_codes"], np.int64)
            _collect(out)
            start += n

    e_pack = package_energy(cfg, atm, wl_index, packages,
                            prep.emissivity_total, crescent)
    det_img = detector.reshape(det.nx, det.ny, 4, 3)
    scaled = np.empty_like(det_img)
    scaled[..., 0] = det_img[..., 0] * e_pack      # (ARTES.f90:959-975)
    scaled[..., 1] = det_img[..., 1] * e_pack * e_pack
    scaled[..., 2] = det_img[..., 2]
    shape3 = (atm.nr, atm.ntheta, atm.nphi)
    return WavelengthResult(
        detector=scaled,
        photometry=photometry_from_detector(scaled),
        flux_emitted=flux_emitted, flux_exit=flux_exit,
        n_error=n_error, n_alive_at_cap=n_alive,
        cell_depth=prep.cell_depth, prep=prep, error_codes=error_codes,
        n_stokes_anomaly=n_anom, n_rounds=n_rounds, n_scatter=n_scatter,
        flow_global=flow_g.reshape(shape3 + (3,)) if static.track_flow else None,
        flow_theta=flow_t.reshape(shape3 + (4,)) if static.track_flow else None,
        error_records=(np.concatenate(error_records)[:2 * ERR_RECORD_K]
                       if error_records else np.zeros((0, 16))),
    )


def photometry_from_detector(detector: np.ndarray) -> np.ndarray:
    """Integrated Stokes fluxes + MC errors (ARTES.f90:977-1004)."""
    p = np.zeros(11)
    sums = detector[..., 0].sum(axis=(0, 1))      # (4,)
    p[0], p[2], p[4], p[6] = sums
    p[8] = np.hypot(sums[1], sums[2])
    p[9] = p[8] / p[0] if p[0] != 0.0 else 0.0
    for k in range(4):
        n = detector[..., k, 2].sum()
        if n > 0:
            m1 = detector[..., k, 0].sum() / n
            m2 = detector[..., k, 1].sum() / n
            var = m2 - m1 * m1
            if var > 0:
                p[2 * k + 1] = np.sqrt(var) * np.sqrt(n)
    if p[2] ** 2 + p[4] ** 2 > 0:
        dpi = np.sqrt(((p[2] * p[3]) ** 2 + (p[4] * p[5]) ** 2) /
                      (2.0 * (p[2] ** 2 + p[4] ** 2)))
        if p[0] != 0 and p[8] != 0:
            p[10] = p[9] * np.sqrt((dpi / p[8]) ** 2 + (p[1] / p[0]) ** 2)
    return p


def detector_errors(detector: np.ndarray) -> np.ndarray:
    """Per-pixel standard errors incl. degree of polarization
    (ARTES.f90:3479-3519). Returns (nx, ny, 5)."""
    nx, ny = detector.shape[:2]
    err = np.zeros((nx, ny, 5))
    with np.errstate(invalid="ignore", divide="ignore"):
        n = detector[..., 2]
        m1 = np.where(n > 0, detector[..., 0] / np.maximum(n, 1), 0.0)
        m2 = np.where(n > 0, detector[..., 1] / np.maximum(n, 1), 0.0)
        var = m2 - m1 * m1
        err[..., :4] = np.where((n > 0) & (var > 0), np.sqrt(np.maximum(var, 0)) * np.sqrt(n), 0.0)
    q, u = detector[..., 1, 0], detector[..., 2, 0]
    i = detector[..., 0, 0]
    pol2 = q * q + u * u
    pol = np.sqrt(pol2)
    with np.errstate(invalid="ignore", divide="ignore"):
        dpol = np.where(pol2 > 0, np.sqrt(
            ((q * err[..., 1]) ** 2 + (u * err[..., 2]) ** 2) / np.maximum(2 * pol2, 1e-300)), 0.0)
        err[..., 4] = np.where(
            (i > 0) & (pol > 0),
            (pol / np.maximum(i, 1e-300)) * np.sqrt(
                (dpol / np.maximum(pol, 1e-300)) ** 2 + (err[..., 0] / np.maximum(i, 1e-300)) ** 2),
            0.0)
    return err


# ---------------------------------------------------------------------------
# Modes (ARTES.f90:121-267)
# ---------------------------------------------------------------------------

def run_spectrum(atm, cfg, packages, seed=0, wl_subset=None, **kw):
    """Per-wavelength Stokes spectrum (single-pixel detector).

    The wavelength grid is an embarrassingly parallel axis the reference
    runs serially (ARTES.f90:132-166); here too each wavelength is an
    independent kernel run (``wl_subset`` gives block-cyclic ownership for
    the multi-process sharding, parallel/multihost.py). An earlier opt-in that vmapped all wavelengths into
    one launch was removed: it measured 12x slower than the serial loop on
    the CPU backend even in its best case (vmapping the per-cell table
    gathers and the pool while_loop is what loses).
    """
    det = detector_setup(cfg, float(atm.rfront[-1]))
    wls = list(range(atm.n_wavelength)) if wl_subset is None else list(wl_subset)
    results = []
    for wl in wls:
        results.append(run_wavelength(atm, cfg, det, wl, packages, seed=seed + wl, **kw))
    return det, results


def run_imaging_mono(atm, cfg, packages, seed=0, wl_index=0, **kw):
    det = detector_setup(cfg, float(atm.rfront[-1]))
    return det, run_wavelength(atm, cfg, det, wl_index, packages, seed=seed, **kw)


def run_imaging_broad(atm, cfg, packages, seed=0, **kw):
    """Accumulate one detector across all wavelengths (ARTES.f90:168-204)."""
    det = detector_setup(cfg, float(atm.rfront[-1]))
    total = None
    tallies = []
    for wl in range(atm.n_wavelength):
        res = run_wavelength(atm, cfg, det, wl, packages, seed=seed + wl, **kw)
        total = res.detector if total is None else total + res.detector
        tallies.append(res)
    summed = dataclasses.replace(
        tallies[-1], detector=total, photometry=photometry_from_detector(total))
    return det, summed, tallies


def run_phase_curve(atm, cfg, packages, seed=0, wl_index=0, **kw):
    """73 phase angles at 2.5-degree steps (ARTES.f90:213-250)."""
    results = []
    for i, ang in enumerate(PHASE_ANGLES_DEG):
        phi = ang * PI / 180.0
        det = detector_setup(cfg, float(atm.rfront[-1]), det_phi=phi)
        crescent = ang >= 170.0  # (:1041)
        res = run_wavelength(atm, cfg, det, wl_index, packages, seed=seed + i,
                             crescent=crescent, **kw)
        results.append((ang, det, res))
    return results
