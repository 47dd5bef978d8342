"""artes: polarized Monte Carlo radiative transfer for exoplanet atmospheres.

A from-scratch JAX/XLA re-design of the capabilities of the reference ARTES
code (Stolker et al. 2017): 3-D spherical-grid photon transport with full
4x4 Mueller-matrix polarization, stellar and thermal photon sources, peel-off
(next-event estimation) imaging/spectroscopy/phase-curve detectors, and the
offline atmosphere/opacity tooling that feeds it.

Reference parity anchors are cited throughout as ``ARTES.f90:<line>`` (the
Fortran core) and ``python/<tool>.py:<line>`` (the offline tooling).
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache. JAX itself honours
# JAX_COMPILATION_CACHE_DIR; only when it is unset does the package pick a
# fixed directory inside the checkout (the path is part of the cache key, so
# it must not move between runs).
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The persistent compile-cache directory for an environment."""
    environ = _os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def _configure_compile_cache() -> None:
    import jax

    cache = compile_cache_dir()
    if cache == CHECKOUT_CACHE_DIR:
        _os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_configure_compile_cache()

from artes import constants  # noqa: E402,F401
