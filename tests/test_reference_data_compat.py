"""Format-compatibility tests against the reference's shipped data files.

These read the *data* tables mounted read-only at /root/reference/dat (public
measured tables, no code) to prove the tooling consumes the reference's file
formats unchanged. Skipped when the reference tree is absent.
"""

import os

import numpy as np
import pytest

REF = "/root/reference/dat"

pytestmark = pytest.mark.skipif(not os.path.isdir(REF),
                                reason="reference data not mounted")


def test_gas_absorption_table_methane():
    from artes.opacity import gas

    tab = gas.generate(os.path.join(REF, "absorption", "methane.dat"),
                       wl_min=0.4, wl_max=1.0, step=0.001,
                       vmr=1.8e-3, mmw_abs=16.04)
    assert len(tab.wavelength) > 100
    assert (tab.absorption >= 0).all()
    assert (tab.scattering > 0).all()
    # methane bands: absorption varies by orders of magnitude
    pos = tab.absorption[tab.absorption > 0]
    assert pos.max() / max(pos.min(), 1e-300) > 1e3


def test_mie_with_reference_refractive_index():
    from artes.opacity import mie

    tab = mie.generate(os.path.join(REF, "refractive_index", "ammonia_ice.dat"),
                       [1.0], nr=10, nf=1, amin=0.5, amax=2.0, apow=3.5,
                       fmax=0.0)
    assert tab.extinction[0] > 0
    assert 0.0 < tab.scattering[0] <= tab.extinction[0]
    from artes.opacity.base import p11_norm
    np.testing.assert_allclose(p11_norm(tab.scatter), 1.0, rtol=1e-9)


def test_molecules_ptgrid_parses():
    from artes.opacity.molecules import PTGrid

    mol = os.path.join(REF, "molecules")
    if not os.path.isfile(os.path.join(mol, "PTgrid.dat")):
        pytest.skip("PTgrid.dat absent")
    grid = PTGrid(mol)
    assert len(grid.index) > 100
    idx = grid.corner_indices(1.0, 500.0)
    assert len(idx) == 4
    # the four corners bracket the query point in (P, T)
    ps = grid.pressure[idx]
    ts = grid.temperature[idx]
    assert ts.min() <= 500.0 <= ts.max() or ts.min() == ts.max()
    assert ps.min() <= 1.0 <= ps.max() or ps.min() == ps.max()
    wl, op = grid.interpolate(1.0, 500.0)
    assert len(wl) > 10
    assert np.isfinite(op).all() and (op >= 0).all()
