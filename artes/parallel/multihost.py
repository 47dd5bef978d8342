"""Multi-host distribution: wavelength sharding over processes.

SURVEY.md section 2.4: the atmosphere is replicated, photons shard across the
local device mesh, and the wavelength grid — an embarrassingly parallel
outer loop the reference runs serially (ARTES.f90:130-204) — is the natural
second axis, sharded across *hosts* so no inter-host communication is needed
beyond the final gather of per-wavelength rows.

Per-wavelength outputs are idempotent (one spectrum.dat row per wavelength),
which doubles as the checkpoint/resume story: a crashed multi-host run keeps
every completed wavelength, exactly like the reference's append-per-iteration
files (ARTES.f90:3591-3619) but with explicit resume support
(artes.cli --resume).
"""

from __future__ import annotations

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bring up jax.distributed when running under a multi-host launcher.

    No-op when the environment provides no coordination info (single host).
    """
    if coordinator_address is None and num_processes is None:
        import os
        if "JAX_COORDINATOR_ADDRESS" not in os.environ and \
                "COORDINATOR_ADDRESS" not in os.environ:
            return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def my_wavelength_indices(n_wavelength: int):
    """The wavelength indices owned by this process (block-cyclic).

    Cyclic assignment balances the cost gradient across the spectrum (long
    wavelengths are usually optically thinner and cheaper).
    """
    p = jax.process_index()
    n = jax.process_count()
    return list(range(p, n_wavelength, n))


def is_coordinator() -> bool:
    return jax.process_index() == 0
