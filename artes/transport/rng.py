"""Counter-based RNG for photon transport (hand-rolled threefry2x32).

The reference uses a per-thread 4-word Marsaglia-Zaman stream seeded from the
wall clock (ARTES.f90:4175-4230) — results depend on thread count and are not
reproducible. Here every draw is a pure function ``value(seed, photon_id,
site)``: bitwise deterministic and independent of batch size, device count,
sharding and kernel variant (the design SURVEY.md section 7.5 calls for).

The generator is Threefry-2x32 with the standard 20-round schedule (Salmon et
al. 2011, the same cipher JAX's PRNG uses), implemented directly on uint32
vectors so that

* one hash yields TWO draws (draw ``site`` consumes word ``site & 1`` of the
  hash of counter ``site >> 1``) — half the hashes of the former
  ``fold_in + uniform`` pair per draw, which cost two full threefry
  applications each, and
* it is plain uint32 arithmetic (no ``jax.random`` internals, no vmap), so
  it fuses into the transport loop like any other elementwise code.

Draws convert the 32-bit word via the mantissa trick
(``(w >> 9) | 0x3F800000 -> [1,2) - 1``). float64 runs widen the same 24-bit
values, so both dtypes share one site->value mapping: a float64 run follows
the photons of the float32 run up to rounding, which makes it the
same-photon reference of the production float32 path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_U32 = np.uint32
_PARITY = _U32(0x1BD11BDA)  # threefry key-schedule parity constant
# golden-ratio Weyl constant: mixes the high id word into the key. Odd, so
# hi -> seed + hi*GOLDEN is injective mod 2^32 — within one run every 64-bit
# photon id gets a distinct (k0, k1) key pair.
GOLDEN = _U32(0x9E3779B9)


def photon_keys(seed, photon_ids, id_hi=0):
    """Per-photon key pair (k0, k1) from the run seed and global photon ids.

    Returns a (B, 2) uint32 array; ``photon_ids`` may be any integer dtype.

    The global photon index is 64-bit — the reference carries an integer(16)
    package counter (ARTES.f90:26, :4254) for >=1e10-photon runs — split as
    (``id_hi``, ``photon_ids``) uint32 words. ``id_hi == 0`` (ids < 2^32)
    reduces to k0 = seed bit-for-bit, so existing streams are unchanged.
    """
    pid = jnp.asarray(photon_ids, jnp.uint32)
    k0 = jnp.broadcast_to(key_hi(seed, id_hi), pid.shape)
    return jnp.stack([k0, pid], axis=-1)


def key_hi(seed, id_hi=0):
    """Effective k0 for photons whose 64-bit id has high word ``id_hi``."""
    return (jnp.asarray(seed).astype(jnp.uint32)
            + jnp.asarray(id_hi).astype(jnp.uint32) * GOLDEN)


def _rotl(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, c0, c1):
    """The 20-round Threefry-2x32 block cipher on uint32 arrays."""
    ks0, ks1 = k0, k1
    ks2 = k0 ^ k1 ^ _PARITY
    ks = (ks0, ks1, ks2)
    x0 = c0 + ks0
    x1 = c1 + ks1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _bits_to_f32(bits):
    mant = (bits >> _U32(9)) | _U32(0x3F800000)
    u = jax.lax.bitcast_convert_type(mant, jnp.float32) - jnp.float32(1.0)
    # strictly (0,1): 1-log draws etc. assume u < 1 (ARTES.f90:4218)
    return jnp.clip(u, jnp.finfo(jnp.float32).tiny,
                    1.0 - jnp.finfo(jnp.float32).epsneg)


def uniform(keys, site, dtype=jnp.float32):
    """One uniform (0,1) draw per photon at draw-site ``site``.

    ``keys``: (..., 2) uint32 from :func:`photon_keys`. ``site`` is a scalar
    or (...,) uint32 — may be traced (e.g. a per-lane event-history counter)
    so draws inside while-loops stay unique and reproducible.
    """
    k0, k1 = keys[..., 0], keys[..., 1]
    s = jnp.broadcast_to(jnp.asarray(site, jnp.uint32), k0.shape)
    w0, w1 = threefry2x32(k0, k1, s >> _U32(1), jnp.zeros_like(s))
    return _bits_to_f32(jnp.where((s & _U32(1)) == 0, w0, w1)).astype(dtype)


def uniform_n(keys, base_site, n: int, dtype=jnp.float32):
    """``n`` uniforms at consecutive sites ``base_site .. base_site+n-1``.

    Bitwise identical to ``[uniform(keys, base_site + i) for i in range(n)]``
    but shares hashes between site pairs (f32: n//2 + 1 hashes for n draws).
    """
    k0, k1 = keys[..., 0], keys[..., 1]
    s = jnp.broadcast_to(jnp.asarray(base_site, jnp.uint32), k0.shape)
    # Draw at site s+i uses word (s+i)&1 of the hash of counter (s+i)>>1.
    # Those counters span (s>>1) + 0 .. (s>>1) + n//2 whichever the (traced)
    # parity of s, so n//2+1 hashes cover all n draws; per draw, select the
    # hash at offset (i + (s&1)) >> 1.
    base_ctr = s >> _U32(1)
    zero = jnp.zeros_like(s)
    ws = [threefry2x32(k0, k1, base_ctr + _U32(j), zero)
          for j in range(n // 2 + 1)]
    odd = (s & _U32(1)) == _U32(1)
    res = []
    for i in range(n):
        off_even, off_odd = i >> 1, (i + 1) >> 1  # offset if s even / s odd
        if off_even == off_odd:
            w0, w1 = ws[off_even]
        else:
            w0 = jnp.where(odd, ws[off_odd][0], ws[off_even][0])
            w1 = jnp.where(odd, ws[off_odd][1], ws[off_even][1])
        word = jnp.where(((s + _U32(i)) & _U32(1)) == 0, w0, w1)
        res.append(_bits_to_f32(word).astype(dtype))
    return res
