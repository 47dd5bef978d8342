"""Tests for the native Mie/DHS solver and the molecular-opacity tooling."""

import numpy as np
import pytest

from artes.opacity import mie, molecules
from artes.opacity.base import p11_norm


@pytest.fixture(scope="module")
def ri_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ri") / "const.dat"
    with open(path, "w") as fh:
        fh.write("# wavelength n k\n")
        for wl in (0.1, 1.0, 10.0, 1000.0):
            fh.write(f"{wl} 1.5 0.01\n")
    return path


def test_solver_builds():
    assert mie.solver_path()


def test_rayleigh_limit(ri_file):
    """x << 1: kappa_sca must follow the analytic Rayleigh cross-section."""
    a, wl = 0.01, 10.0
    opacity, scatter6 = mie.compute_particle(ri_file, [wl], nr=1, nf=1,
                                             amin=a, amax=a, apow=0.0, fmax=0.0)
    x = 2 * np.pi * a / wl
    m = 1.5 + 0.01j
    qsca = (8 / 3) * x**4 * abs((m * m - 1) / (m * m + 2)) ** 2
    csca = qsca * np.pi * a**2 * 1e-8
    mass = (4 / 3) * np.pi * (a * 1e-4) ** 3
    assert opacity[3, 0] == pytest.approx(csca / mass, rel=1e-3)
    # Rayleigh phase shape: F11(0)/F11(90) ~ 2
    f11 = scatter6[:, 0, 0]
    assert f11[0] / f11[90] == pytest.approx(2.0, rel=0.05)


def test_full_pipeline_generates_normalised_table(ri_file):
    tab = mie.generate(ri_file, [1.0, 2.0], nr=10, nf=3, amin=0.5, amax=2.0,
                       apow=3.5, fmax=0.3)
    assert tab.scatter.shape == (180, 16, 2)
    np.testing.assert_allclose(p11_norm(tab.scatter), 1.0, rtol=1e-10)
    assert (tab.extinction >= tab.scattering - 1e-12).all()
    assert (tab.absorption > 0).all()  # k=0.01 absorbs
    # polarization element present and bounded
    assert np.all(np.abs(tab.scatter[:, 1, :]) <= tab.scatter[:, 0, :] + 1e-12)


def make_molecule_dir(tmp_path):
    """Synthetic PT grid (2 pressures x 2 temperatures) with known opacity
    law kappa = P * T (so bilinear-in-log interpolation is exact)."""
    d = tmp_path / "molecules"
    d.mkdir()
    rows = []
    idx = 1
    wl = np.linspace(0.5, 2.0, 16)
    for t in (100.0, 200.0):
        for p in (0.1, 10.0):
            np.savetxt(d / f"opacity_aver_{idx:04d}.dat",
                       np.column_stack([wl, np.full_like(wl, p * t)]))
            rows.append((idx, p, t))
            idx += 1
    with open(d / "PTgrid.dat", "w") as fh:
        fh.write("# File - Pressure [bar] - Temperature [K]\n")
        for i, p, t in rows:
            fh.write(f"{i}\t{p}\t{t}\n")
    return d


def test_pt_interpolation_exact_loglog(tmp_path):
    d = make_molecule_dir(tmp_path)
    grid = molecules.PTGrid(d)
    wl, op = grid.interpolate(1.0, 141.4213562)  # log-midpoint of both axes
    assert op[0] == pytest.approx(np.sqrt(0.1 * 10.0) * np.sqrt(100.0 * 200.0), rel=1e-6)
    # corner point returns the tabulated value
    wl, op = grid.interpolate(10.0, 200.0)
    assert op[0] == pytest.approx(2000.0, rel=1e-9)


def test_generate_layers(tmp_path):
    d = make_molecule_dir(tmp_path)
    out = tmp_path / "opacity"
    pressure = np.array([0.2, 2.0, 8.0])
    temperature = np.array([110.0, 150.0, 190.0])
    paths = molecules.generate_layers(d, pressure, temperature, 0.5, 2.0, out)
    assert len(paths) == 3
    from artes.opacity.base import read_opacity_fits
    # deepest layer (highest P, last row) is gas_opacity_01
    tab1 = read_opacity_fits(out / "gas_opacity_01.fits")
    tab3 = read_opacity_fits(out / "gas_opacity_03.fits")
    assert tab1.absorption[0] > tab3.absorption[0]
    assert (tab1.scattering > 0).all()  # Rayleigh part attached
