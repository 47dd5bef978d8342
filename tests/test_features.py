"""Feature-path tests: stellar direction, oblateness, ring, biased emission,
broadband imaging and the phase-curve mode."""

import numpy as np
import pytest

from artes import output as out
from artes import presets, runner
from artes.config import ArtesConfig, detector_setup
from artes.constants import PI, planck_lambda


def _norm(cfg, atm, wl=0):
    return (PI * planck_lambda(cfg.t_star, atm.wavelengths[wl])
            * atm.rfront[-1] ** 2 * cfg.r_star ** 2
            / (cfg.orbit ** 2 * cfg.distance_planet ** 2))


def test_stellar_direction_changes_phase():
    """star:direction=on moves the illumination: with the star rotated onto
    the detector axis the planet is seen at full phase (brighter) compared
    with the default quadrature geometry (ARTES.f90:1080-1111)."""
    atm = presets.rayleigh_single_layer(tau=2.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))  # detector at phi=90
    quad = runner.run_wavelength(atm, cfg, det, 0, packages=6000, seed=3,
                                 batch_size=6000)
    cfg2 = ArtesConfig()
    cfg2.mode = "spectrum"
    cfg2.stellar_direction = True
    cfg2.theta_star = PI / 2
    cfg2.phi_star = PI / 2  # star behind the observer -> full phase
    det2 = detector_setup(cfg2, float(atm.rfront[-1]))
    assert det2.phase_observer < 1.0
    full = runner.run_wavelength(atm, cfg2, det2, 0, packages=6000, seed=3,
                                 batch_size=6000)
    assert full.n_error == 0
    assert full.photometry[0] > 2.0 * quad.photometry[0]
    # full phase: symmetric disk -> polarization cancels
    assert abs(full.photometry[2] / full.photometry[0]) < 0.05


@pytest.mark.slow
def test_oblate_image_wider_than_tall():
    """Oblateness stretches the equator: seen at full phase, the detector
    image (pole axis on the image y axis) must be wider than tall.

    The stellar beam samples the *ellipsoid silhouette* (kernel._emit) — a
    re-design of the reference's sphere-of-polar-radius sampling
    (ARTES.f90:1054-1077), which misses the equatorial bulge and mis-assigns
    the entry cell for oblate grids. Works for thin shells too.
    """
    atm = presets.rayleigh_single_layer(tau=4.0)  # 100 km shell: the hard case
    cfg = ArtesConfig()
    cfg.mode = "imaging_mono"
    cfg.npix = 15
    cfg.oblateness = 0.3
    # star behind the observer -> full phase, the whole silhouette is lit
    cfg.stellar_direction = True
    cfg.theta_star = PI / 2
    cfg.phi_star = PI / 2
    det, res = runner.run_imaging_mono(atm, cfg, packages=30000, seed=4,
                                       batch_size=30000)
    img = res.detector[..., 0, 0]
    assert res.n_error == 0
    assert img.sum() > 0
    # spans above 2 % of peak: equatorial (image x) vs polar (image y)
    profx = img.sum(axis=1)
    profy = img.sum(axis=0)
    span = lambda p: np.ptp(np.nonzero(p > 0.02 * p.max())[0])
    assert span(profx) > span(profy)
    # quantitative: spans should scale like 1/(1-ob) = 1.43 (+/- 1 px each)
    ratio = (span(profx) + 1) / (span(profy) + 1)
    assert 1.2 < ratio < 1.7
    # flux scales with the collecting area: compare with the sphere at the
    # same geometry (area factor 1/(1-ob) for an equator-on beam)
    cfg_s = ArtesConfig()
    cfg_s.mode = "imaging_mono"
    cfg_s.npix = 15
    cfg_s.stellar_direction = True
    cfg_s.theta_star = PI / 2
    cfg_s.phi_star = PI / 2
    det_s, res_s = runner.run_imaging_mono(atm, cfg_s, packages=30000, seed=4,
                                           batch_size=30000)
    flux_ratio = img.sum() / res_s.detector[..., 0, 0].sum()
    assert flux_ratio == pytest.approx(1.0 / 0.7, rel=0.1)


@pytest.mark.slow
def test_thermal_biased_emission_unbiased_estimator():
    """Biased upward emission (Gordon 1987) must reproduce the isotropic
    detector flux: the bias weight cancels in expectation
    (ARTES.f90:1229-1254)."""
    atm = presets.thermal_shell(tau_abs=0.05, temperature=900.0)
    cfg = ArtesConfig()
    cfg.photon_source = "planet"
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    iso = runner.run_wavelength(atm, cfg, det, 0, packages=20000, seed=5,
                                batch_size=20000)
    cfg.photon_emission = "biased"
    cfg.photon_bias = 0.8
    biased = runner.run_wavelength(atm, cfg, det, 0, packages=20000, seed=6,
                                   batch_size=20000)
    assert biased.n_error == 0
    assert biased.photometry[0] == pytest.approx(iso.photometry[0], rel=0.08)


@pytest.mark.slow
def test_ring_system_build_and_run(tmp_path):
    """Builder ring layer (atmosphere.py:404-445): two extra radial cells;
    the run completes and the ring scatters light outside the planet disk."""
    from artes.atmosphere import build_atmosphere
    from artes.opacity import rayleigh
    from artes.opacity.base import write_opacity_fits

    d = tmp_path / "ringed"
    (d / "opacity").mkdir(parents=True)
    write_opacity_fits(d / "opacity" / "opac.fits", rayleigh.generate([0.7]))
    (d / "atmosphere.in").write_text("""\
[grid]
radius: 1.
radial: 500
theta: 89, 91
phi:

[composition]
gas: off
fits01: opac.fits
opacity01: 1, 1e-7, 0, nr, 0, ntheta, 0, nphi
ring: 1, 2e-7, 100., 30000, 60000, 1, 2
""")
    atm = build_atmosphere(d)
    assert atm.nr == 3  # 1 shell + 2 ring cells
    assert atm.k_sca[2, 1, 0, 0] > 0  # ring material in the equatorial band
    assert atm.k_sca[1, 1, 0, 0] == 0  # gap cell empty
    cfg = ArtesConfig()
    cfg.mode = "imaging_mono"
    cfg.npix = 21
    cfg.ring = True
    cfg.det_theta = np.deg2rad(60.0)
    det, res = runner.run_imaging_mono(atm, cfg, packages=20000, seed=8,
                                       batch_size=20000)
    img = res.detector[..., 0, 0]
    assert res.n_error < 50
    assert img.sum() > 0
    # flux outside the planet's projected radius (ring) exists
    c = cfg.npix // 2
    yy, xx = np.meshgrid(np.arange(cfg.npix), np.arange(cfg.npix), indexing="ij")
    r_pix = np.hypot(xx - c, yy - c)
    r_planet_pix = (atm.rfront[0] / det.x_max) * (cfg.npix / 2)
    outside = img[r_pix > r_planet_pix * 1.3].sum()
    assert outside > 0


def test_imaging_broad_accumulates(tmp_path):
    atm = presets.rayleigh_single_layer(tau=1.0, wavelengths=(0.6, 0.8))
    cfg = ArtesConfig()
    cfg.mode = "imaging_broad"
    cfg.npix = 5
    det, summed, tallies = runner.run_imaging_broad(atm, cfg, packages=3000,
                                                    seed=2, batch_size=3000)
    total = sum(t.detector[..., 0] for t in tallies)
    np.testing.assert_allclose(summed.detector[..., 0], total)
    assert len(tallies) == 2


@pytest.mark.slow
def test_phase_curve_mode(monkeypatch, tmp_path):
    """Phase mode plumbing on a trimmed angle list; flux falls from full
    phase toward crescent and the phase.dat rows are written."""
    monkeypatch.setattr(runner, "PHASE_ANGLES_DEG", [1.0e-5, 90.0, 170.0])
    atm = presets.rayleigh_single_layer(tau=2.0)
    cfg = ArtesConfig()
    cfg.mode = "phase"
    results = runner.run_phase_curve(atm, cfg, packages=4000, seed=4,
                                     batch_size=4000)
    assert len(results) == 3
    fluxes = [r.photometry[0] for (_, _, r) in results]
    assert fluxes[0] > fluxes[1] > fluxes[2] > 0
    # crescent branch ran for the 170-degree angle
    dirs = out.OutputDirs(tmp_path, "phz")
    for ang, _, res in results:
        out.write_phase_row(dirs, ang, res)
    lines = open(dirs.path("phase.dat")).read().strip().splitlines()
    assert len(lines) == 2 + 3  # header + blank + 3 rows
    assert float(lines[-3].split()[0]) == 0.0  # 1e-5 deg rounds to 0 (ARTES.f90:3543)
