"""Flow-diagnostics tests: energy-transport tallies (ARTES.f90:4992-5047)."""

import numpy as np
import pytest

from artes import presets
from artes.config import ArtesConfig, detector_setup
from artes.runner import run_wavelength


def test_flow_global_points_inward_then_outward(tmp_path):
    """Stellar photons in a multi-shell Rayleigh atmosphere: net radial flow
    in the outermost shell is inward (photons stream in from the star)."""
    atm = presets.rayleigh_single_layer(tau=3.0, nr=4)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.flow_global = True
    cfg.flow_theta = True
    det = detector_setup(cfg, float(atm.rfront[-1]))
    res = run_wavelength(atm, cfg, det, 0, packages=4000, seed=2, batch_size=4000)
    assert res.flow_global is not None
    assert res.flow_global.shape == (4, 1, 1, 3)
    # outer shell: dominated by inward-streaming stellar photons
    assert res.flow_global[-1, 0, 0, 0] < 0.0
    # radial flow magnitude dominates the diagnostics for a symmetric setup
    fg = res.flow_global[-1, 0, 0]
    assert abs(fg[0]) > abs(fg[1]) and abs(fg[0]) > abs(fg[2])
    # latitudinal tallies: up/down crossings recorded, no theta faces to cross
    assert res.flow_theta.shape == (4, 1, 1, 4)
    assert res.flow_theta[..., 0].sum() > 0  # upward crossings
    assert res.flow_theta[..., 1].sum() > 0  # downward crossings
    assert res.flow_theta[..., 2:].sum() == 0.0  # no theta faces in a 1-cell polar grid


def test_flow_off_returns_none():
    atm = presets.rayleigh_single_layer(tau=1.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    res = run_wavelength(atm, cfg, det, 0, packages=500, seed=2, batch_size=500)
    assert res.flow_global is None and res.flow_theta is None


def test_flow_outputs_written(tmp_path):
    from artes import output as out

    atm = presets.rayleigh_single_layer(tau=2.0, nr=2)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.flow_global = True
    cfg.flow_theta = True
    det = detector_setup(cfg, float(atm.rfront[-1]))
    res = run_wavelength(atm, cfg, det, 0, packages=2000, seed=1, batch_size=2000)
    dirs = out.OutputDirs(tmp_path, "flowrun")
    out.write_flow_global(dirs, res.flow_global)
    out.write_flow_latitudinal(dirs, res.flow_theta, max(res.flux_exit, 1.0))
    from artes.io.fitsio import read_fits
    fg = read_fits(dirs.path("flow_global.fits"))[0][1]
    assert fg.shape == (1, 1, 2, 3)  # (nphi, ntheta, nr, 3) numpy order
    norms = np.linalg.norm(fg, axis=-1)
    ok = norms > 0
    np.testing.assert_allclose(norms[ok], 1.0, rtol=1e-12)
