"""The table gather and the detector splat against plain NumPy references.

Each lane books (value, value^2, count) for the four Stokes components at
its pixel; masked and out-of-image lanes (pixel -1) book nothing. On the GPU
the splat's scatter-add runs on atomics, so moment sums there change order
from run to run (last-bit differences) while counts stay exact; here, on
the CPU, they are compared at rtol 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest

from artes.transport.geometry import gather_rows
from artes.transport.kernel import _splat


@pytest.mark.parametrize("shape", [(1,), (1, 4), (7,), (39, 6)])
def test_gather_rows_matches_indexing(shape):
    """One-row tables broadcast instead of gathering; the values must be
    those of ``table[idx]``."""
    rng = np.random.default_rng(len(shape) + shape[0])
    table = rng.normal(size=shape)
    idx = rng.integers(0, shape[0], 257).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(gather_rows(table, jnp.asarray(idx))),
                                  table[idx])


def _reference(npix, pix, stokes, mask, first_only):
    det = np.zeros((npix, 4, 3))
    ok = mask & (pix >= 0)
    comps = 1 if first_only else 4
    for k in range(comps):
        v = stokes[ok, k]
        np.add.at(det[:, k, 0], pix[ok], v)
        np.add.at(det[:, k, 1], pix[ok], v * v)
        np.add.at(det[:, k, 2], pix[ok], 1.0)
    return det


@pytest.mark.parametrize("npix", [1, 25, 625, 10201])
@pytest.mark.parametrize("first_only", [False, True])
def test_splat_matches_numpy(npix, first_only):
    rng = np.random.default_rng(npix + first_only)
    b = 3000
    pix = rng.integers(-1, npix, b).astype(np.int32)
    if npix == 1:
        pix = np.where(pix < 0, -1, 0).astype(np.int32)
    stokes = rng.normal(size=(b, 4))
    stokes[rng.random(b) < 0.01] = np.nan      # masked lanes may hold NaN
    mask = rng.random(b) < 0.8
    mask &= np.isfinite(stokes).all(axis=1)
    got = _splat(jnp.zeros((npix, 4, 3)), jnp.asarray(pix),
                 jnp.asarray(stokes), jnp.asarray(mask), first_only)
    want = _reference(npix, pix, stokes, mask, first_only)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)
