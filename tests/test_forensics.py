"""Error forensics: first-K + last-K ring records, the debug Stokes-anomaly
check (reference error 050, ARTES.f90:830-835), and the end-to-end path from
an injected degenerate geometry to the error.log state dump
(ARTES.f90:3397-3416). VERDICT r3 item 8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from artes import presets
from artes.config import ArtesConfig, detector_setup
from artes.runner import _kernel_static
from artes.transport.kernel import (ERR_RECORD_K, order_error_records,
                                        run_stream)
from artes.transport.tables import build_tables


def test_order_error_records_ring():
    """Rows [0,K) = first K events, rows [K,2K) = ring of the latest; the
    ordered view is chronological with the middle dropped."""
    K = ERR_RECORD_K
    rec = np.zeros((2 * K, 16))
    n = 3 * K + 3          # 27 events for K=8
    for i in range(n):
        slot = i if i < K else K + i % K
        rec[slot, 1] = i   # pid column carries the event index
    out = order_error_records(rec, n)
    assert out.shape == (2 * K, 16)
    assert list(out[:K, 1]) == list(range(K))                  # first K
    assert list(out[K:, 1]) == list(range(n - K, n))           # last K
    # fewer events than K: plain prefix
    few = order_error_records(rec, 3)
    assert few.shape == (3, 16)


def _static_with(cfg, det, atm, **overrides):
    return dataclasses.replace(_kernel_static(cfg, det, atm, False),
                               **overrides)


def test_stokes_anomaly_detected():
    """An unphysical scattering matrix (|P12| > P11) drives Q above I after
    the Mueller update; the debug check catches and abandons those photons."""
    atm = presets.rayleigh_single_layer(tau=3.0)
    atm.scatter[..., 4] = 3.0 * atm.scatter[..., 0]   # m21 = 3*P11: Q_out > I
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float32)

    static = _static_with(cfg, det, atm, debug_stokes=True)
    out = run_stream(prep.tables, static, 300, 3, 256)
    n_anom = int(out["n_stokes_anomaly"])
    assert n_anom > 0
    assert int(out["n_error"]) >= n_anom
    # at least one forensics record carries code 050 / site 4
    k = int(out["n_error_records"])
    rows = order_error_records(out["error_records"], k)
    assert k > 0
    assert np.any((np.asarray(rows)[:, 0] == 50.0)
                  & (np.asarray(rows)[:, 15] == 4.0))

    static_off = _static_with(cfg, det, atm, debug_stokes=False)
    out_off = run_stream(prep.tables, static_off, 300, 3, 256)
    assert int(out_off["n_stokes_anomaly"]) == 0


def test_physical_matrix_no_anomaly():
    """The check stays silent on real physics (the disabled self-consistency
    assertions the reference left in, ARTES.f90:1922-1930)."""
    atm = presets.rayleigh_single_layer(tau=3.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float32)
    static = _static_with(cfg, det, atm, debug_stokes=True)
    out = run_stream(prep.tables, static, 400, 9, 256)
    assert int(out["n_stokes_anomaly"]) == 0
    assert int(out["n_error"]) == 0


def test_degenerate_geometry_ring_capture():
    """Injected degenerate traversal (max_crossings too small for the grid)
    floods error 032; the ring keeps capturing past the first K events.
    Uses a 3-D grid: radial-only grids run the closed-form transport
    (transport/radial.py) which has no crossing cap and no failure modes.
    The r5 jump-walk exit-precheck (transport/jumps.py) bounds marches by
    interaction depth — escape marches no longer hit the crossing cap — so
    the cap must sit below even an interacting march's crossing count to
    still force the error-032 capture path."""
    atm = presets.rayleigh_single_layer(tau=6.0, nr=8,
                                        theta_deg=(0.0, 90.0, 180.0))
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float32)
    static = _static_with(cfg, det, atm, max_crossings=2)
    out = run_stream(prep.tables, static, 600, 5, 256)
    assert int(out["n_error"]) > 0
    assert int(np.asarray(out["error_codes"]).sum()) > 0
    k = int(out["n_error_records"])
    assert k > ERR_RECORD_K       # ring engaged (> first-K captures)
    rows = order_error_records(out["error_records"], k)
    assert rows.shape[0] == 2 * ERR_RECORD_K


def test_error_log_state_dump(tmp_path, monkeypatch):
    """End-to-end: a degenerate run writes per-event state dumps to
    error.log (pos/dir/cell/face, mirroring ARTES.f90:3397-3416)."""
    import artes.runner as runner_mod
    from artes import cli
    from artes.opacity import rayleigh
    from artes.opacity.base import write_opacity_fits

    d = tmp_path / "input" / "demo"
    (d / "opacity").mkdir(parents=True)
    write_opacity_fits(d / "opacity" / "rayleigh.fits",
                       rayleigh.generate([0.6]))
    # theta faces force the marching path (the closed-form radial
    # transport cannot be driven into geometry errors)
    (d / "atmosphere.in").write_text(
        "[grid]\nradius: 1.\nradial: 20, 40, 60, 80, 100\ntheta: 90\nphi:\n\n"
        "[composition]\ngas: off\nfits01: rayleigh.fits\n"
        "opacity01: 1, 2e-3, 0, 5, 0, ntheta, 0, nphi\n")
    (d / "artes.in").write_text(
        "photon:source=star\ndetector:type=spectrum\n")
    assert cli.main(["build", "demo", "--root", str(tmp_path)]) == 0

    orig = runner_mod._kernel_static

    def degen(cfg, det, atm, crescent):
        return dataclasses.replace(orig(cfg, det, atm, crescent),
                                   max_crossings=3)

    monkeypatch.setattr(runner_mod, "_kernel_static", degen)
    assert cli.main(["demo", "400", "-o", "run", "--root", str(tmp_path)]) == 0
    log = tmp_path / "output" / "run" / "error.log"
    assert log.is_file()
    text = log.read_text()
    assert "031" in text
    assert "pos=(" in text and "cell=(" in text       # state dump present
