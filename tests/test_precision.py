"""Every float contraction on the transport hot path states its precision.

On a GPU an f32 dot with default precision may run in TF32 (~10 mantissa
bits) and silently bias the physics; the pool kernel's jaxpr must carry no
float ``dot_general`` below HIGHEST."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from artes import presets
from artes.config import ArtesConfig, detector_setup
from artes.runner import _kernel_static
from artes.transport.kernel import run_stream
from artes.transport.tables import build_tables

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dot_generals(inner)


def _deck():
    return presets.patchy_3d(tau_clear=0.5, tau_cloud=4.0, nr=3)


@pytest.mark.parametrize("mode,npix,atm_fn,source", [
    ("spectrum", 1, lambda: presets.rayleigh_single_layer(tau=5.0), "star"),
    ("imaging_mono", 25, lambda: presets.rayleigh_single_layer(tau=5.0), "star"),
    ("spectrum", 1, _deck, "star"),
    ("imaging_mono", 5, lambda: presets.thermal_shell(tau_abs=0.8, nr=4),
     "planet"),
])
def test_run_stream_float_contractions_are_highest(mode, npix, atm_fn,
                                                    source):
    atm = atm_fn()
    cfg = ArtesConfig()
    cfg.mode = mode
    cfg.npix = npix
    cfg.photon_source = source
    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, False)
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float32)
    closed = jax.make_jaxpr(
        lambda t: run_stream(t, static, 1000, 1, 1024))(prep.tables)
    for eqn in _dot_generals(closed.jaxpr):
        if not any(jnp.issubdtype(v.aval.dtype, jnp.floating)
                   for v in eqn.invars):
            continue
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == HIGHEST for p in np.atleast_1d(prec)), (
            f"float dot_general without HIGHEST precision: {eqn}")
