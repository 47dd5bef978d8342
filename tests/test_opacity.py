import numpy as np
import pytest

from artes.constants import PI
from artes.opacity import base, henyey_greenstein, isotropic, rayleigh
from artes.opacity.base import (
    N_ANGLE,
    expand_6_to_16,
    normalize_scatter,
    p11_norm,
    read_opacity_fits,
    write_opacity_fits,
)


def _solid_angle_integral(scatter):
    """2*pi*int P11 sin(theta) dtheta with midpoint-bin Riemann sum."""
    ang = base.bin_centers_rad()
    return 2 * PI * np.sum(scatter[:, 0, 0] * np.sin(ang)) * PI / 180.0


def test_rayleigh_normalised_and_shape():
    tab = rayleigh.generate([0.7])
    assert tab.scatter.shape == (N_ANGLE, 16, 1)
    assert _solid_angle_integral(tab.scatter) == pytest.approx(1.0, rel=1e-4)
    # pure scattering: extinction == scattering, absorption == 0
    np.testing.assert_allclose(tab.extinction, tab.scattering)
    np.testing.assert_allclose(tab.absorption, 0.0)


def test_rayleigh_cross_section_blue_sky():
    # lambda^-4 behaviour (plus mild refractive-index dispersion)
    s1 = rayleigh.rayleigh_cross_section(0.4)
    s2 = rayleigh.rayleigh_cross_section(0.8)
    assert s1 / s2 == pytest.approx(16.0, rel=0.15)


def test_rayleigh_matrix_structure():
    m = rayleigh.rayleigh_matrix16(0.0)  # 90 degrees
    # at 90 deg: P11 = delta, P12 = -delta -> 100% polarization
    assert m[1] / m[0] == pytest.approx(-1.0)
    assert m[5] == m[0]
    assert m[10] == pytest.approx(0.0)


def test_hg_normalised_and_forward_peak():
    # g=0.9 is sharply forward-peaked: the 1-degree bin-averaged table
    # deviates from the analytic quad normalisation at the ~0.5% level
    # (same behaviour as the reference generator).
    tab = henyey_greenstein.generate([0.7], g1=0.9, w1=1.0, p_linear=0.5)
    assert _solid_angle_integral(tab.scatter) == pytest.approx(1.0, rel=1e-2)
    p11 = tab.scatter[:, 0, 0]
    assert p11[0] > p11[-1] * 100  # strongly forward-peaked


def test_hg_mean_cosine():
    tab = henyey_greenstein.generate([0.7], g1=0.6)
    ang = base.bin_centers_rad()
    w = np.sin(ang) * PI / 180.0 * 2 * PI
    g = np.sum(tab.scatter[:, 0, 0] * np.cos(ang) * w)
    assert g == pytest.approx(0.6, rel=5e-3)


def test_isotropic():
    tab = isotropic.generate([1.2], absorption=0.5, scattering=1.5)
    assert tab.extinction[0] == 2.0
    assert _solid_angle_integral(tab.scatter) == pytest.approx(1.0, rel=1e-4)


def test_expand_6_to_16_signs():
    s6 = np.zeros((N_ANGLE, 6, 1))
    s6[:, 4, 0] = 3.0  # F34
    s16 = expand_6_to_16(s6)
    np.testing.assert_allclose(s16[:, 11, 0], 3.0)
    np.testing.assert_allclose(s16[:, 14, 0], -3.0)


def test_opacity_fits_roundtrip(tmp_path):
    tab = rayleigh.generate([0.5, 0.7])
    path = tmp_path / "rayleigh.fits"
    write_opacity_fits(path, tab)
    back = read_opacity_fits(path)
    np.testing.assert_allclose(back.scatter, tab.scatter)
    np.testing.assert_allclose(back.scattering, tab.scattering)
    np.testing.assert_allclose(back.wavelength, [0.5, 0.7])


def test_normalize_idempotent():
    tab = henyey_greenstein.generate([0.7])
    once = normalize_scatter(tab.scatter * 7.0)
    twice = normalize_scatter(once)
    np.testing.assert_allclose(once, twice, rtol=1e-12)
    assert p11_norm(once)[0] == pytest.approx(1.0, rel=1e-10)
