"""End-to-end transport validation against analytic oracles.

Strategy (SURVEY.md section 4): optically-thin single-scattering limits have
closed-form expectations; thermal emission from a transparent shell must equal
L/(4 pi d^2); determinism must be exact and batch-size invariant.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from artes.atmosphere import build_atmosphere
from artes.config import ArtesConfig, detector_setup
from artes.constants import PI, planck_lambda
from artes.opacity import isotropic, rayleigh
from artes.opacity.base import write_opacity_fits
from artes.runner import run_wavelength


def make_input(tmp_path, name, tab, radius_rjup, radial_km, density_gcc,
               theta="", phi=""):
    d = tmp_path / name
    (d / "opacity").mkdir(parents=True)
    write_opacity_fits(d / "opacity" / "opac.fits", tab)
    (d / "atmosphere.in").write_text(f"""\
[grid]
radius: {radius_rjup}
radial: {radial_km}
theta: {theta}
phi: {phi}

[composition]
gas: off
fits01: opac.fits
opacity01: 1, {density_gcc}, 0, nr, 0, ntheta, 0, nphi
""")
    return build_atmosphere(d)


def stellar_norm(cfg, atm, wl=0):
    """Reference normalization constant (ARTES.f90:3984)."""
    return (PI * planck_lambda(cfg.t_star, atm.wavelengths[wl])
            * atm.rfront[-1] ** 2 * cfg.r_star ** 2
            / (cfg.orbit ** 2 * cfg.distance_planet ** 2))


def test_thin_shell_single_scattering_quadrature(tmp_path):
    """Optically thin hollow Rayleigh shell viewed at 90 deg phase.

    Single scattering + peel: detector I/N ~ <tau_chord> * P11(90 deg),
    and the light is almost fully polarized with Q < 0 in detector frame
    (-Q/I -> +1 with the reference's Q sign flip at the splat)."""
    # tiny planet core: radius 70 km, atmosphere out to 70000 km
    tab = rayleigh.generate([0.7])
    atm = make_input(tmp_path, "thin", tab, radius_rjup=0.001, radial_km=70000,
                     density_gcc=1e-9)
    k_scaled = atm.k_sca[0, 0, 0, 0] * atm.rfront[-1]
    assert k_scaled < 0.01  # genuinely thin

    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    n = 40000
    res = run_wavelength(atm, cfg, det, 0, packages=n, seed=3, batch_size=n)
    assert res.n_error == 0

    p = res.photometry
    norm = stellar_norm(cfg, atm)
    got = p[0] / norm / PI  # = <w> per photon

    # expectation: <(1 - e^-tau1) * P11(Theta_det) * e^-tau2> ~ <tau_chord>*P11(90)
    # mean chord through unit sphere (entry disk-uniform) = 4/3; inner core is
    # negligible (r=1e-3)
    p11_90 = 0.5 * (tab.scatter[89, 0, 0] + tab.scatter[90, 0, 0])
    expected = (4.0 / 3.0) * k_scaled * p11_90
    assert got == pytest.approx(expected, rel=0.05)
    # single Rayleigh scattering at 90 deg: fully linearly polarized; the
    # detector convention makes -Q/I -> +1 (cf. smoke run: 0.75 at tau=0.5)
    assert -p[2] / p[0] == pytest.approx(1.0, abs=0.05)


def test_thin_shell_thermal_luminosity(tmp_path):
    """Transparent isothermal shell: detector flux = L_total/(4 pi d^2)."""
    # hollow shell around a tiny core so nothing occults the emission and
    # tau_abs ~ 7e-3 (the L/(4 pi d^2) oracle is exact only without blocking)
    tab = isotropic.generate([10.0], absorption=1.0, scattering=0.0)
    atm = make_input(tmp_path, "thermal", tab, radius_rjup=0.001, radial_km=70000,
                     density_gcc=1e-12)
    atm.temperature[:] = 900.0
    cfg = ArtesConfig()
    cfg.photon_source = "planet"
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    n = 20000
    res = run_wavelength(atm, cfg, det, 0, packages=n, seed=5, batch_size=n)
    assert res.n_error == 0

    wl = atm.wavelengths[0]
    b = planck_lambda(900.0, wl)
    vol = atm.cell_volume().sum()
    kappa = atm.k_abs[0, 0, 0, 0]
    expected = vol * kappa * b / cfg.distance_planet ** 2
    assert res.photometry[0] == pytest.approx(expected, rel=0.02)
    # optically thin: flux_emitted tallies the weighted Stokes sums
    assert res.flux_emitted > 0


def test_determinism_and_batch_invariance(tmp_path):
    tab = rayleigh.generate([0.7])
    atm = make_input(tmp_path, "det", tab, radius_rjup=0.5, radial_km=5000,
                     density_gcc=2e-6)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    r1 = run_wavelength(atm, cfg, det, 0, packages=4000, seed=9, batch_size=4000)
    r2 = run_wavelength(atm, cfg, det, 0, packages=4000, seed=9, batch_size=4000)
    np.testing.assert_array_equal(r1.detector, r2.detector)
    # splitting the same photon ids across batches must give the same sums
    r3 = run_wavelength(atm, cfg, det, 0, packages=4000, seed=9, batch_size=1000)
    np.testing.assert_allclose(r1.detector[..., 0], r3.detector[..., 0], rtol=1e-12)
    # different seed -> different result
    r4 = run_wavelength(atm, cfg, det, 0, packages=4000, seed=10, batch_size=4000)
    assert not np.allclose(r1.detector[..., 0], r4.detector[..., 0], rtol=1e-9, atol=0.0)


def test_black_planet_no_atmosphere_signal(tmp_path):
    """Opacity ~ 0 everywhere: every photon passes through or hits the black
    surface; the detector must stay (almost) empty and no errors occur."""
    tab = rayleigh.generate([0.7])
    atm = make_input(tmp_path, "vac", tab, radius_rjup=1.0, radial_km=1000,
                     density_gcc=1e-22)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    res = run_wavelength(atm, cfg, det, 0, packages=2000, seed=1, batch_size=2000)
    assert res.n_error == 0
    norm = stellar_norm(cfg, atm)
    assert res.photometry[0] / norm < 1e-10


def test_lambert_surface_reflection(tmp_path):
    """Transparent atmosphere + perfect Lambertian surface at phase ~0:
    normalized I equals the Lambert-sphere geometric albedo 2/3."""
    tab = rayleigh.generate([0.7])
    atm = make_input(tmp_path, "lambert", tab, radius_rjup=1.0, radial_km=10,
                     density_gcc=1e-22)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.surface_albedo = 1.0
    cfg.det_phi = 1.0e-3  # phase angle ~ 0 (observer at the star)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    n = 40000
    res = run_wavelength(atm, cfg, det, 0, packages=n, seed=11, batch_size=n)
    assert res.n_error == 0
    norm = stellar_norm(cfg, atm)
    got = res.photometry[0] / norm
    assert got == pytest.approx(2.0 / 3.0, rel=0.03)
    # Lambertian surface fully depolarizes
    assert abs(res.photometry[2] / res.photometry[0]) < 0.01


def test_error_code_tallies_clean_run(tmp_path):
    """The per-code error tallies (031/032/034/peel) ride through the
    runner; a clean config reports zeros everywhere."""
    tab = rayleigh.generate([0.7])
    atm = make_input(tmp_path, "codes", tab, radius_rjup=1.0, radial_km=100,
                     density_gcc=2e-9)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    res = run_wavelength(atm, cfg, det, 0, packages=4000, seed=3, batch_size=4000)
    assert res.error_codes.shape == (4,)
    assert res.n_error == 0
    assert (res.error_codes == 0).all()
