"""End-to-end CLI integration: build -> run -> output tree -> resume.

Covers the full run contract (ARTES.f90:4232-4309 + write_output): output
tree layout, input snapshotting (incl. opacity FITS, :4283-4293), spectrum.dat
rows, --resume idempotence, -k overrides appearing in the effective snapshot,
imaging_mono stokes.fits, and the absence of error.log on a clean run.
"""

import os

import numpy as np
import pytest

from artes import cli
from artes.opacity import rayleigh
from artes.opacity.base import write_opacity_fits

ARTES_IN = """\
* demo run
[photon]
photon:source=star
photon:fstop=0.1
[star]
star:temperature=5800
[detector]
detector:type={mode}
detector:theta=90
detector:phi=90
detector:pixel={npix}
"""


@pytest.fixture
def demo_root(tmp_path):
    """input/<demo>/ with a 2-layer Rayleigh atmosphere at 2 wavelengths."""
    d = tmp_path / "input" / "demo"
    (d / "opacity").mkdir(parents=True)
    wavelengths = [0.6, 0.8]
    write_opacity_fits(d / "opacity" / "rayleigh.fits",
                       rayleigh.generate(wavelengths))
    (d / "atmosphere.in").write_text("""\
[grid]
radius: 1.
radial: 50, 100
theta:
phi:

[composition]
gas: off
fits01: rayleigh.fits
opacity01: 1, 2e-3, 0, 2, 0, ntheta, 0, nphi
""")
    (d / "artes.in").write_text(ARTES_IN.format(mode="spectrum", npix=1))
    rc = cli.main(["build", "demo", "--root", str(tmp_path)])
    assert rc == 0
    assert (d / "atmosphere.fits").is_file()
    return tmp_path


def test_spectrum_run_output_tree(demo_root):
    rc = cli.main(["demo", "2000", "-o", "myrun", "--root", str(demo_root),
                   "--f64"])
    assert rc == 0
    run = demo_root / "output" / "myrun"

    # input snapshot reproduces the run: full tree incl. opacity FITS
    for name in ("artes.in", "atmosphere.in", "atmosphere.fits",
                 "artes.in.effective", os.path.join("opacity", "rayleigh.fits")):
        assert (run / "input" / name).is_file(), name

    # spectrum.dat: one row per wavelength, positive Stokes I
    rows = [l.split() for l in open(run / "output" / "spectrum.dat")
            if l.strip() and not l.startswith("#")]
    assert len(rows) == 2
    wl = [float(r[0]) for r in rows]
    np.testing.assert_allclose(wl, [0.6, 0.8])
    assert all(float(r[1]) > 0 for r in rows)

    # clean run: no error.log; report present
    assert not (run / "output" / "error.log").exists()
    assert (run / "plot.dat").is_file()


def test_resume_skips_completed_wavelengths(demo_root, capsys):
    assert cli.main(["demo", "1000", "-o", "res", "--root", str(demo_root),
                     "--f64"]) == 0
    run = demo_root / "output" / "res"
    spec = run / "output" / "spectrum.dat"
    rows_before = spec.read_text()

    def is_row(line, wl=None):
        s = line.strip()
        if not s or s.startswith("#"):
            return False
        return wl is None or abs(float(s.split()[0]) - wl) < 1e-9

    # drop the second wavelength's row, then resume: only it is recomputed
    lines = [l for l in rows_before.splitlines(keepends=True)
             if not is_row(l, 0.8)]
    spec.write_text("".join(lines))
    assert cli.main(["demo", "1000", "-o", "res", "--root", str(demo_root),
                     "--f64", "--resume"]) == 0
    rows_after = [l for l in spec.read_text().splitlines() if is_row(l)]
    assert len(rows_after) == 2
    # the kept wavelength's row is bit-identical (not recomputed)
    kept = [l for l in rows_before.splitlines() if is_row(l, 0.6)]
    assert kept[0] in spec.read_text()

    # a full resume recomputes nothing and appends nothing
    assert cli.main(["demo", "1000", "-o", "res", "--root", str(demo_root),
                     "--f64", "--resume"]) == 0
    rows_final = [l for l in spec.read_text().splitlines()
                  if l.strip() and not l.startswith("#")]
    assert len(rows_final) == 2


def test_keyword_override_and_imaging(demo_root):
    rc = cli.main(["demo", "2000", "-o", "img", "--root", str(demo_root),
                   "--f64", "-k", "detector:type=imaging_mono",
                   "-k", "detector:pixel=5"])
    assert rc == 0
    run = demo_root / "output" / "img"
    eff = (run / "input" / "artes.in.effective").read_text()
    assert "detector:type=imaging_mono" in eff
    assert "detector:pixel=5" in eff

    from artes.io.fitsio import read_fits
    data = read_fits(run / "output" / "stokes.fits")[0][1]
    assert data.shape[-2:] == (5, 5)
    assert np.isfinite(data).all()
    assert data[0].sum() > 0  # Stokes I reaches the detector
    assert not (run / "output" / "error.log").exists()


def test_spectrum_flow_outputs_written(demo_root):
    """Flow files are written from spectrum mode too (the reference's
    write_output emits them for every mode, ARTES.f90:3713-3770; r5 fix —
    previously only imaging_mono wrote them)."""
    assert cli.main(["demo", "800", "-o", "flowspec", "--root",
                     str(demo_root), "--f64",
                     "-k", "output:flow_global=on",
                     "-k", "output:flow_latitudinal=on"]) == 0
    outdir = demo_root / "output" / "flowspec" / "output"
    assert (outdir / "flow_global.fits").is_file()
    assert (outdir / "flow_latitudinal.fits").is_file()
