"""Device-mesh distribution of the transport kernel.

The reference's only parallelism is one OpenMP loop over photons with
per-thread detectors reduced serially (ARTES.f90:534-546, :959-975). Here the
photon population is the sharded axis of a 1-D ``jax.sharding.Mesh``: the
atmosphere tables are replicated per device, each device runs the
regeneration pool (:func:`~artes.transport.kernel.run_stream`) on its own
contiguous photon-id sub-range, and detector/flux tallies are ``psum``-reduced.
Because photon ids (not lanes or devices) key the RNG, the result is
independent of the device count. The cards of one host are joined all to
all, so the mesh follows the algorithm alone: one axis over photons.

Wavelengths are an embarrassingly parallel outer loop (``run`` dispatches one
transport per wavelength, ARTES.f90:130-204); multi-host runs shard the
wavelength loop over process index on top of the photon mesh axis.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from artes.transport.kernel import _stream_impl, run_batch

# run_stream outputs that are summed over devices; the rest are per device
_SUMMED = ("detector", "flow_global", "flow_theta", "flux_emitted",
           "flux_exit", "n_error", "error_codes", "n_alive_at_cap",
           "n_stokes_anomaly", "n_emitted")


def make_mesh(devices=None, axis_name: str = "photons") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def device_id_ranges(n_photons: int, id_lo: int, n_dev: int) -> np.ndarray:
    """(n_dev, 2) uint32 rows [count, first id]: contiguous sub-ranges that
    cover the ids [id_lo, id_lo + n_photons) exactly once, sizes differing
    by at most one. The chunk never straddles a 2^32 id boundary (runner
    chunking invariant), so every sub-range shares the high id word."""
    base, rem = divmod(int(n_photons), n_dev)
    counts = np.asarray([base + (d < rem) for d in range(n_dev)], np.int64)
    starts = int(id_lo) + np.concatenate([[0], np.cumsum(counts[:-1])])
    return np.stack([counts, starts], axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _mesh_stream_fn(static, width: int, mesh: Mesh, axis: str):
    """One jitted shard_map program: the pool on every device with its own
    id sub-range, tallies psum-reduced, forensics rings kept per device."""

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(), P()), out_specs=P(),
             check_vma=False)
    def step(tables, ranges, seed, id_hi):
        out = _stream_impl(tables, static, ranges[0, 0], seed, width,
                           id_hi, ranges[0, 1])
        res = {k: jax.lax.psum(out[k], axis) for k in _SUMMED}
        res["n_rounds"] = jax.lax.pmax(out["n_rounds"], axis)
        # (hi, lo) words cannot be psum-ed without losing the carry
        res["n_scatter"] = jax.lax.all_gather(out["n_scatter"], axis)
        res["error_records"] = jax.lax.all_gather(out["error_records"], axis)
        res["n_error_records"] = jax.lax.all_gather(out["n_error_records"],
                                                    axis)
        return res

    return step


def run_stream_mesh(tables, static, n_photons: int, seed, width: int,
                    id_hi=0, id_lo=0, *, mesh: Mesh,
                    axis_name: str = "photons"):
    """:func:`~artes.transport.kernel.run_stream` fanned out over a 1-D
    mesh: same arguments and tallies. ``error_records`` is
    (n_dev, 2K, W), ``n_error_records`` (n_dev,) and ``n_scatter``
    (n_dev, 2), one per device; ``n_rounds`` is the slowest device's."""
    n_dev = int(mesh.devices.size)
    ranges = device_id_ranges(n_photons, id_lo, n_dev)
    step = _mesh_stream_fn(static, width, mesh, axis_name)
    return step(tables, ranges, jnp.asarray(seed, jnp.uint32),
                jnp.asarray(id_hi, jnp.uint32))


def sharded_dispatch(mesh: Mesh, axis_name: str = "photons"):
    """Return a drop-in replacement for ``run_batch`` that shards photons
    across ``mesh`` and psum-reduces every output."""

    def dispatch(tables, static, photon_ids, seed):
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P(axis_name), P()),
                 out_specs=P(), check_vma=False)
        def inner(tables, ids, seed_arr):
            out = run_batch(tables, static, ids, seed_arr[0])
            return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), out)

        n_dev = mesh.devices.size
        n = photon_ids.shape[0]
        if n % n_dev:
            raise ValueError(f"batch of {n} photons not divisible by {n_dev} devices")
        return inner(tables, photon_ids, jnp.asarray([seed], jnp.uint32))

    return dispatch

