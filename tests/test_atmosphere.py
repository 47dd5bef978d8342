import numpy as np
import pytest

from artes.atmosphere import Atmosphere, build_atmosphere, build_and_write, load_artifact, write_artifact
from artes.constants import PI, R_JUP
from artes.opacity import rayleigh
from artes.opacity.base import write_opacity_fits


def make_rayleigh_input(tmp_path, radial="100", theta="", phi="", density="1e-3",
                        wavelengths=(0.7,)):
    """A 1-layer (or few-layer) Rayleigh atmosphere input directory."""
    d = tmp_path / "rayleigh"
    (d / "opacity").mkdir(parents=True)
    tab = rayleigh.generate(list(wavelengths))
    write_opacity_fits(d / "opacity" / "rayleigh.fits", tab)
    n_zones = len(radial.split(","))
    zone_lines = "\n".join(
        f"opacity{i+1:02d}: 1, {density}, {i}, {i+1}, 0, ntheta, 0, nphi"
        for i in range(n_zones)
    )
    (d / "atmosphere.in").write_text(f"""\
[grid]
radius: 1.
radial: {radial}
theta: {theta}
phi: {phi}

[composition]
gas: off
fits01: rayleigh.fits
{zone_lines}
""")
    return d


def test_build_basic_grid(tmp_path):
    d = make_rayleigh_input(tmp_path)
    atm = build_atmosphere(d)
    assert atm.nr == 1
    assert atm.ntheta == 1
    assert atm.nphi == 1
    np.testing.assert_allclose(atm.rfront, [R_JUP, R_JUP + 100e3])
    np.testing.assert_allclose(atm.thetafront, [0.0, PI])
    assert atm.k_abs.max() == 0.0
    assert atm.k_sca[0, 0, 0, 0] > 0.0
    # albedo = 1 for pure Rayleigh
    assert atm.albedo[0, 0, 0, 0] == pytest.approx(1.0)


def test_painted_opacity_value(tmp_path):
    d = make_rayleigh_input(tmp_path, density="2e-3")
    atm = build_atmosphere(d)
    tab = rayleigh.generate([0.7])
    # rho [kg m-3] = 2e-3 g/cm3 * 1e3; kappa [m2 kg-1] = cm2/g / 10
    expected = 2.0 * tab.scattering[0] / 10.0
    assert atm.k_sca[0, 0, 0, 0] == pytest.approx(expected)


def test_multi_zone_theta_phi(tmp_path):
    d = make_rayleigh_input(tmp_path, radial="100, 200", theta="60, 120", phi="180")
    atm = build_atmosphere(d)
    assert atm.nr == 2 and atm.ntheta == 3 and atm.nphi == 2
    assert atm.thetaplane.tolist() == [1, 1, 1, 1]  # no face at exactly 90 deg


def test_thetaplane_flag(tmp_path):
    d = make_rayleigh_input(tmp_path, theta="90")
    atm = build_atmosphere(d)
    assert atm.thetaplane.tolist() == [1, 2, 1]


def test_artifact_roundtrip(tmp_path):
    d = make_rayleigh_input(tmp_path, radial="100, 250", theta="45, 135", phi="90, 180, 270",
                            wavelengths=(0.5, 0.7))
    atm = build_atmosphere(d)
    path = tmp_path / "atmosphere.fits"
    write_artifact(path, atm)
    back = load_artifact(path)
    np.testing.assert_allclose(back.rfront, atm.rfront)
    np.testing.assert_allclose(back.thetafront, atm.thetafront)
    np.testing.assert_allclose(back.phifront, atm.phifront)
    np.testing.assert_allclose(back.wavelengths, atm.wavelengths)
    np.testing.assert_allclose(back.k_sca, atm.k_sca)
    np.testing.assert_allclose(back.k_abs, atm.k_abs)
    np.testing.assert_allclose(back.scatter, atm.scatter)
    np.testing.assert_allclose(back.p_int, atm.p_int)


def test_cell_volume_sums_to_shell(tmp_path):
    d = make_rayleigh_input(tmp_path, radial="100, 200", theta="60, 120", phi="180")
    atm = build_atmosphere(d)
    vol = atm.cell_volume()
    r0, r2 = atm.rfront[0], atm.rfront[-1]
    shell = 4.0 / 3.0 * PI * (r2**3 - r0**3)
    assert vol.sum() == pytest.approx(shell, rel=1e-12)


def test_p_int_rayleigh(tmp_path):
    d = make_rayleigh_input(tmp_path)
    atm = build_atmosphere(d)
    # P11 integral over [0,pi] with the bin-average table ~ 1/(2*pi)
    assert atm.p_int[0, 0, 0, 0, 0] * 2 * PI == pytest.approx(1.0, rel=1e-4)
    # P13, P14 integrals vanish for Rayleigh
    assert abs(atm.p_int[0, 0, 0, 0, 2]) < 1e-15
    assert abs(atm.p_int[0, 0, 0, 0, 3]) < 1e-15


def test_hydrostatic_grid(tmp_path):
    from artes.opacity import ptprofile

    d = tmp_path / "selflum"
    (d / "opacity").mkdir(parents=True)
    p, t = ptprofile.isothermal(t_iso=800.0, levels=10)
    ptprofile.write_profile(d / "pressureTemperature.dat", p, t)
    tab = rayleigh.generate([1.2])
    write_opacity_fits(d / "opacity" / "rayleigh.fits", tab)
    (d / "atmosphere.in").write_text("""\
[grid]
radius: 1.
radial:
theta:
phi:

[composition]
gas: off
molweight: 2.02
log_g: 3.4
fits01: rayleigh.fits
opacity01: 1, 1e-3, 0, nr, 0, ntheta, 0, nphi
""")
    atm = build_and_write(d)
    assert atm.nr == 9
    # radial faces strictly increasing, starting at the planet radius
    assert atm.rfront[0] == pytest.approx(R_JUP)
    assert np.all(np.diff(atm.rfront) > 0)
    # isothermal: all cell temperatures equal
    np.testing.assert_allclose(atm.temperature, 800.0)
    assert (d / "atmosphere.fits").exists()
    assert (d / "atmosphere.dat").exists()
