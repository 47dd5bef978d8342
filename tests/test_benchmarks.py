"""Physics benchmark tests anchored to literature values (BASELINE configs).

The deep conservative Rayleigh atmosphere is THE classic validation for
polarized MC radiative transfer (geometric albedo 0.7977 for the
semi-infinite case, Prather 1974; used by Stolker et al. 2017 to validate
the reference). With the reference's own truncations — the tau>30 photon
floor backed by a black surface (ARTES.f90:2329-2357) and a finite scatter
cap — the recovered albedo sits a few percent below the semi-infinite value.
"""

import dataclasses

import numpy as np
import pytest

from artes import presets, runner
from artes.config import ArtesConfig, detector_setup
from artes.constants import PI, planck_lambda


def _norm(cfg, atm, wl=0):
    return (PI * planck_lambda(cfg.t_star, atm.wavelengths[wl])
            * atm.rfront[-1] ** 2 * cfg.r_star ** 2
            / (cfg.orbit ** 2 * cfg.distance_planet ** 2))


def _static_with(max_scatter):
    orig = runner._kernel_static

    def patched(cfg, det, atm, crescent):
        return dataclasses.replace(orig(cfg, det, atm, crescent),
                                   max_scatter=max_scatter)
    return patched


@pytest.mark.slow
def test_deep_rayleigh_geometric_albedo(monkeypatch):
    """tau=100 conservative Rayleigh at phase ~0: A_g within the truncated
    band below the semi-infinite literature value 0.7977."""
    atm = presets.rayleigh_single_layer(tau=100.0, nr=20)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.det_phi = 1.0e-3
    det = detector_setup(cfg, float(atm.rfront[-1]))
    monkeypatch.setattr(runner, "_kernel_static", _static_with(1024))
    res = runner.run_wavelength(atm, cfg, det, 0, packages=8000, seed=7,
                                batch_size=8000)
    a_g = res.photometry[0] / _norm(cfg, atm)
    assert res.n_error == 0
    assert res.n_alive_at_cap < 250
    assert 0.74 < a_g < 0.80, f"A_g={a_g}"
    # phase ~0: symmetric disk -> polarization cancels
    assert abs(res.photometry[2] / res.photometry[0]) < 0.02


def test_rayleigh_polarization_peak_at_quadrature():
    """tau=1 Rayleigh: -Q/I rises from ~0 at phase 0 to a strong peak near 90
    degrees (the canonical Rayleigh polarization phase curve)."""
    atm = presets.rayleigh_single_layer(tau=1.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    dop = {}
    for phase_deg in (1.0, 90.0, 150.0):
        cfg.det_phi = np.deg2rad(phase_deg)
        det = detector_setup(cfg, float(atm.rfront[-1]))
        res = runner.run_wavelength(atm, cfg, det, 0, packages=6000, seed=11,
                                    batch_size=6000)
        dop[phase_deg] = -res.photometry[2] / res.photometry[0]
    assert abs(dop[1.0]) < 0.05
    assert dop[90.0] > 0.5
    assert dop[90.0] > dop[150.0] > -0.05


@pytest.mark.slow
def test_hg_cloud_forward_scattering_phase_curve():
    """BASELINE config #2 shape: a g=0.8 HG cloud deck brightens strongly
    toward forward-scattering phase angles."""
    atm = presets.hg_cloud_deck(tau=10.0, g=0.8, p_linear=0.3, ssa=0.9)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    flux = {}
    for phase_deg in (30.0, 150.0):
        cfg.det_phi = np.deg2rad(phase_deg)
        det = detector_setup(cfg, float(atm.rfront[-1]))
        res = runner.run_wavelength(atm, cfg, det, 0, packages=6000, seed=13,
                                    batch_size=6000)
        flux[phase_deg] = res.photometry[0] / _norm(cfg, atm)
    # NB detector phi is the phase angle; 150 deg = crescent (forward
    # scattering through the limb), 30 deg = near-full disk
    assert flux[30.0] > 0.01
    assert flux[150.0] > 0.0
    # back-scattering-dominated geometry must exceed the crescent in
    # reflected flux for an optically thick deck
    assert flux[30.0] > flux[150.0]


@pytest.mark.slow
def test_patchy_3d_detector_asymmetry():
    """BASELINE config #4 shape: theta/phi cloud patches break symmetry in
    the detector image."""
    # thick clouds only in the northern theta band so the detector (theta=90)
    # sees a clear top/bottom image contrast
    base = presets.rayleigh_single_layer(
        tau=0.3, nr=2, theta_deg=(0.0, 60.0, 120.0, 180.0),
        phi_deg=(0.0, 90.0, 180.0, 270.0))
    k_sca = base.k_sca.copy()
    k_sca[:, 0, :, :] *= 30.0
    atm = presets.Atmosphere(
        rfront=base.rfront, thetafront=base.thetafront, phifront=base.phifront,
        wavelengths=base.wavelengths, density=base.density,
        temperature=base.temperature, k_sca=k_sca, k_abs=base.k_abs,
        scatter=base.scatter)
    cfg = ArtesConfig()
    cfg.mode = "imaging_mono"
    cfg.npix = 9
    det, res = runner.run_imaging_mono(atm, cfg, packages=20000, seed=5,
                                       batch_size=20000)
    img = res.detector[..., 0, 0]
    assert res.n_error <= 2  # rare cone-grazing losses are tolerated
    assert img.sum() > 0
    # patches make the upper/lower image halves unequal
    top, bottom = img[:, 5:].sum(), img[:, :4].sum()
    assert abs(top - bottom) / (top + bottom) > 0.03
