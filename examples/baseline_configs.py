"""Runnable demos of the five BASELINE benchmark configurations.

Each function builds its atmosphere programmatically (artes.presets) and
runs a reduced-photon version of the corresponding BASELINE.json config:

  1. Rayleigh 1-layer reflected-light Stokes I/Q spectrum
  2. Henyey-Greenstein cloud deck polarized phase curve
  3. Self-luminous thermal emission spectrum
  4. 3-D patchy-cloud detector images
  5. Full exoplanet (reflected + thermal) — run both sources

Usage: python examples/baseline_configs.py [1-5] [photons]
"""

import sys

import numpy as np

from artes import presets, runner
from artes.config import ArtesConfig, detector_setup
from artes.constants import PI, planck_lambda


def norm(cfg, atm, wl=0):
    return (PI * planck_lambda(cfg.t_star, atm.wavelengths[wl])
            * atm.rfront[-1] ** 2 * cfg.r_star ** 2
            / (cfg.orbit ** 2 * cfg.distance_planet ** 2))


def config1(photons):
    atm = presets.rayleigh_single_layer(
        tau=5.0, wavelengths=tuple(0.5 + 0.05 * i for i in range(6)))
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det, results = runner.run_spectrum(atm, cfg, photons)
    print("# wavelength[um]  I/I_star_norm  -Q/I")
    for wl, res in enumerate(results):
        p = res.photometry
        print(f"{atm.wavelengths[wl] * 1e6:8.3f}  {p[0] / norm(cfg, atm, wl):10.4e}"
              f"  {-p[2] / p[0]:8.4f}")


def config2(photons):
    atm = presets.hg_cloud_deck(tau=10.0, g=0.8, p_linear=0.5, ssa=0.95)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    print("# phase[deg]  I_norm  -Q/I")
    for phase in (5.0, 30.0, 60.0, 90.0, 120.0, 150.0):
        cfg.det_phi = np.deg2rad(phase)
        det = detector_setup(cfg, float(atm.rfront[-1]))
        res = runner.run_wavelength(atm, cfg, det, 0, photons)
        p = res.photometry
        print(f"{phase:8.1f}  {p[0] / norm(cfg, atm):10.4e}  {-p[2] / p[0]:8.4f}")


def config3(photons):
    atm = presets.thermal_shell(tau_abs=0.8, temperature=900.0,
                                wavelengths=(5.0, 8.0, 12.0, 16.0))
    cfg = ArtesConfig()
    cfg.photon_source = "planet"
    cfg.mode = "spectrum"
    det, results = runner.run_spectrum(atm, cfg, photons)
    print("# wavelength[um]  F[W m-2 um-1]")
    for wl, res in enumerate(results):
        print(f"{atm.wavelengths[wl] * 1e6:8.3f}  {res.photometry[0] * 1e-6:10.4e}")


def config4(photons):
    atm = presets.patchy_3d()
    cfg = ArtesConfig()
    cfg.mode = "imaging_mono"
    cfg.npix = 15
    det, res = runner.run_imaging_mono(atm, cfg, photons)
    img = res.detector[..., 0, 0]
    print("# Stokes-I image (relative)")
    for row in (img / max(img.max(), 1e-300) * 9).astype(int):
        print("".join(str(v) for v in row))


def config5(photons):
    atm = presets.rayleigh_single_layer(tau=3.0, wavelengths=(0.7,))
    atm.temperature[:] = 700.0
    atm.k_abs[:] = atm.k_sca * 0.1
    atm = presets.Atmosphere(
        rfront=atm.rfront, thetafront=atm.thetafront, phifront=atm.phifront,
        wavelengths=atm.wavelengths, density=atm.density,
        temperature=atm.temperature, k_sca=atm.k_sca, k_abs=atm.k_abs,
        scatter=atm.scatter)
    for source in ("star", "planet"):
        cfg = ArtesConfig()
        cfg.photon_source = source
        cfg.mode = "spectrum"
        det = detector_setup(cfg, float(atm.rfront[-1]))
        res = runner.run_wavelength(atm, cfg, det, 0, photons)
        p = res.photometry
        print(f"{source:7s}: I={p[0] * 1e-6:.4e} W m-2 um-1  Q={p[2] * 1e-6:+.4e}"
              f"  U={p[4] * 1e-6:+.4e}  V={p[6] * 1e-6:+.4e}")


if __name__ == "__main__":
    which = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    photons = int(float(sys.argv[2])) if len(sys.argv) > 2 else 20000
    [config1, config2, config3, config4, config5][which - 1](photons)
