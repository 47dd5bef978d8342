"""The regeneration pool over a device mesh (parallel/mesh.py) on the
virtual 8-device CPU mesh: photon ids key the RNG, so the mesh run equals
the single-device run up to f64 summation order, with bit-equal counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from artes import presets
from artes.config import ArtesConfig, detector_setup
from artes.parallel import device_id_ranges, make_mesh, run_stream_mesh
from artes.runner import _kernel_static, pool_width, run_wavelength
from artes.transport.kernel import run_stream, scatter_total
from artes.transport.tables import build_tables


def _case(mode, npix, atm=None, source="star"):
    atm = atm or presets.rayleigh_single_layer(tau=2.0)
    cfg = ArtesConfig()
    cfg.mode = mode
    cfg.npix = npix
    cfg.photon_source = source
    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, False)
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float64)
    return atm, cfg, det, static, prep


@pytest.mark.parametrize("mode,npix", [("spectrum", 1), ("imaging_mono", 5)])
def test_mesh_pool_matches_single_device(mode, npix):
    _, _, _, static, prep = _case(mode, npix)
    n, seed, width = 700, 5, 128
    ref = run_stream(prep.tables, static, n, seed, width)
    out = run_stream_mesh(prep.tables, static, n, seed, width,
                          mesh=make_mesh())
    d_ref = np.asarray(ref["detector"])
    d_out = np.asarray(out["detector"])
    assert d_ref[..., 2].sum() > 0
    np.testing.assert_array_equal(d_out[..., 2], d_ref[..., 2])
    np.testing.assert_allclose(d_out, d_ref, rtol=1e-10, atol=1e-300)
    assert int(out["n_emitted"]) == n
    assert scatter_total(out["n_scatter"]) == scatter_total(ref["n_scatter"])
    assert int(out["n_error"]) == int(ref["n_error"])
    assert np.asarray(out["error_records"]).shape[0] == len(jax.devices())


def test_mesh_pool_thermal_tallies():
    """Thermal source: the emitted/exit flux tallies psum like the detector."""
    atm = presets.thermal_shell(tau_abs=0.8, nr=4)
    _, _, _, static, prep = _case("spectrum", 1, atm=atm, source="planet")
    ref = run_stream(prep.tables, static, 500, 2, 128)
    out = run_stream_mesh(prep.tables, static, 500, 2, 128,
                          mesh=make_mesh(jax.devices()[:3]))
    for k in ("flux_emitted", "flux_exit"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(out["detector"]),
                               np.asarray(ref["detector"]), rtol=1e-10,
                               atol=1e-300)


def test_runner_mesh_matches_single_device():
    atm, cfg, det, _, _ = _case("spectrum", 1)
    single = run_wavelength(atm, cfg, det, 0, packages=3000, seed=9)
    meshed = run_wavelength(atm, cfg, det, 0, packages=3000, seed=9,
                            mesh=make_mesh())
    np.testing.assert_array_equal(meshed.detector[..., 2],
                                  single.detector[..., 2])
    np.testing.assert_allclose(meshed.detector, single.detector, rtol=1e-10)
    assert meshed.n_scatter == single.n_scatter > 0
    assert meshed.n_error == single.n_error


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_device_id_ranges_cover_every_id_once(n_dev):
    for n, lo in ((0, 0), (1, 7), (1000, 0), (1001, 12345),
                  (2 ** 30, 2 ** 31)):
        r = device_id_ranges(n, lo, n_dev)
        assert r.shape == (n_dev, 2) and r.dtype == np.uint32
        ids = np.concatenate([np.arange(int(s), int(s) + int(c))
                              for c, s in r])
        np.testing.assert_array_equal(ids, np.arange(lo, lo + n))
        assert r[:, 0].max() - r[:, 0].min() <= 1


@pytest.mark.parametrize("packages,cap,expect", [
    (1, 1 << 17, 1024), (5000, 1 << 17, 8192), (1 << 17, 1 << 17, 1 << 17),
    (10 ** 9, 1 << 17, 1 << 17), (10 ** 9, 1 << 19, 1 << 19)])
def test_pool_width(packages, cap, expect):
    assert pool_width(packages, cap) == expect
