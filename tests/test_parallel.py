"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from artes import presets
from artes.config import ArtesConfig, detector_setup
from artes.parallel import make_mesh, sharded_dispatch
from artes.runner import run_wavelength


@pytest.fixture(scope="module")
def setup():
    atm = presets.rayleigh_single_layer(tau=2.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    return atm, cfg, det


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(setup):
    atm, cfg, det = setup
    n = 4096
    single = run_wavelength(atm, cfg, det, 0, packages=n, seed=17, batch_size=n)

    mesh = make_mesh()
    dispatch = sharded_dispatch(mesh)
    sharded = run_wavelength(atm, cfg, det, 0, packages=n, seed=17, batch_size=n,
                             dispatch=dispatch)
    # counter-based RNG keyed by photon id: device count cannot change physics
    np.testing.assert_allclose(sharded.detector[..., 0], single.detector[..., 0],
                               rtol=1e-12)
    np.testing.assert_allclose(sharded.detector[..., 2], single.detector[..., 2])


def test_sharded_subset_mesh(setup):
    atm, cfg, det = setup
    n = 4096
    mesh2 = make_mesh(jax.devices()[:2])
    mesh8 = make_mesh(jax.devices())
    r2 = run_wavelength(atm, cfg, det, 0, packages=n, seed=3, batch_size=n,
                        dispatch=sharded_dispatch(mesh2))
    r8 = run_wavelength(atm, cfg, det, 0, packages=n, seed=3, batch_size=n,
                        dispatch=sharded_dispatch(mesh8))
    np.testing.assert_allclose(r2.detector[..., 0], r8.detector[..., 0], rtol=1e-12)


def test_indivisible_batch_rejected(setup):
    atm, cfg, det = setup
    mesh = make_mesh()
    dispatch = sharded_dispatch(mesh)
    from artes.transport.tables import build_tables
    from artes.runner import _kernel_static
    prep = build_tables(atm, cfg, det, 0)
    static = _kernel_static(cfg, det, atm, False)
    with pytest.raises(ValueError):
        dispatch(prep.tables, static, jnp.arange(1001, dtype=jnp.uint32), 0)
