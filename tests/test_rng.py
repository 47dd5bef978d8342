"""Pin the RNG: Random123 known-answer vectors, the draw-site schedule, and
the 64-bit photon-id scheme.

The transport physics everywhere consumes ``uniform(seed, photon_id, site)``
(rng.py); every parity test elsewhere compares the generator to itself, so
this file is the only thing that notices if the cipher (_ROTATIONS, key
schedule) or the site->value mapping changes. KAT vectors are the published
Threefry-2x32 test vectors (Salmon et al. 2011, Random123 kat_vectors.txt,
20-round variant).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from artes.transport import rng as R

u32 = jnp.uint32


@pytest.mark.parametrize("key,ctr,expect", [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answer(key, ctr, expect):
    x0, x1 = R.threefry2x32(u32(key[0]), u32(key[1]), u32(ctr[0]), u32(ctr[1]))
    assert (int(x0), int(x1)) == expect


# Golden draw-site schedule: seed 0, photon ids 0..2, sites 0..9, float32.
# Regenerate ONLY for a deliberate, documented stream break — every recorded
# physics result (bench detectors, golden spectra) depends on this mapping.
_F32_SCHEDULE = np.asarray([
    [0.418457031, 0.600499034, 0.314681649, 0.753391147, 0.393160224,
     0.984709024, 0.721370935, 0.020384431, 0.673549771, 0.654994130],
    [0.118150234, 0.431474686, 0.258603811, 0.242090106, 0.456112146,
     0.380045176, 0.984766364, 0.569609284, 0.885127902, 0.775443673],
    [0.424021602, 0.783299208, 0.859438539, 0.318089247, 0.352393866,
     0.675371647, 0.068853259, 0.631112576, 0.859509230, 0.902967691],
], np.float32)

# float64 draws widen the float32 values: seed 0, pid 0, sites 0..4
_F64_SCHEDULE = [float(v) for v in _F32_SCHEDULE[0, :5]]


def test_site_schedule_golden_f32():
    keys = R.photon_keys(0, jnp.arange(3, dtype=u32))
    got = np.asarray([
        np.asarray(R.uniform(keys, u32(s), jnp.float32)) for s in range(10)
    ]).T
    np.testing.assert_array_equal(got.astype(np.float32), _F32_SCHEDULE)


def test_site_schedule_golden_f64():
    keys = R.photon_keys(0, jnp.zeros(1, u32))
    got = [float(R.uniform(keys, u32(s), jnp.float64)[0]) for s in range(5)]
    np.testing.assert_array_equal(got, _F64_SCHEDULE)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("base", [0, 1, 7])
def test_uniform_n_matches_single_site_draws(dtype, base):
    keys = R.photon_keys(123, jnp.arange(64, dtype=u32))
    batch = R.uniform_n(keys, u32(base), 6, dtype)
    for i in range(6):
        single = R.uniform(keys, u32(base + i), dtype)
        np.testing.assert_array_equal(np.asarray(batch[i]), np.asarray(single))


def test_uniform_n_traced_site_parity():
    # per-lane (traced, mixed-parity) site counters hit the odd-base path
    keys = R.photon_keys(9, jnp.arange(8, dtype=u32))
    sites = jnp.asarray([0, 1, 2, 3, 4, 5, 6, 7], u32)
    batch = R.uniform_n(keys, sites, 3, jnp.float32)
    for i in range(3):
        single = R.uniform(keys, sites + u32(i), jnp.float32)
        np.testing.assert_array_equal(np.asarray(batch[i]), np.asarray(single))


# ---------------------------------------------------------------------------
# 64-bit photon ids (the reference's integer(16) package counter,
# ARTES.f90:26, :4254)
# ---------------------------------------------------------------------------

def test_id_hi_zero_is_backward_compatible():
    pid = jnp.arange(16, dtype=u32)
    np.testing.assert_array_equal(np.asarray(R.photon_keys(42, pid)),
                                  np.asarray(R.photon_keys(42, pid, id_hi=0)))


def test_id_hi_mixing_definition_and_distinctness():
    pid = jnp.arange(4, dtype=u32)
    # definition: hi word folds into k0 as seed + hi * GOLDEN
    k_hi1 = np.asarray(R.photon_keys(5, pid, id_hi=1))
    k_shift = np.asarray(R.photon_keys((5 + 0x9E3779B9) & 0xFFFFFFFF, pid))
    np.testing.assert_array_equal(k_hi1, k_shift)
    # distinct hi words give distinct streams
    a = np.asarray(R.uniform(R.photon_keys(5, pid, id_hi=1), u32(0)))
    b = np.asarray(R.uniform(R.photon_keys(5, pid, id_hi=2), u32(0)))
    assert not np.array_equal(a, b)
    # hi -> k0 injective over a window (GOLDEN is odd)
    k0s = {int(np.asarray(R.key_hi(5, h))) for h in range(1024)}
    assert len(k0s) == 1024


def test_stream_chunking_invariance():
    """Two chunkings of the same photon-id range give the same physics
    (VERDICT r2 item 6: one well-defined stream per (seed, 64-bit id))."""
    from artes import presets
    from artes.config import ArtesConfig, detector_setup
    from artes.runner import _kernel_static
    from artes.transport.kernel import run_stream
    from artes.transport.tables import build_tables

    atm = presets.rayleigh_single_layer(tau=2.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, False)
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float64)

    whole = run_stream(prep.tables, static, 300, 3, 128)
    part1 = run_stream(prep.tables, static, 100, 3, 128, 0, 0)
    part2 = run_stream(prep.tables, static, 200, 3, 128, 0, 100)
    d_whole = np.asarray(whole["detector"], np.float64)
    d_parts = (np.asarray(part1["detector"], np.float64)
               + np.asarray(part2["detector"], np.float64))
    np.testing.assert_array_equal(d_whole[..., 2], d_parts[..., 2])
    np.testing.assert_allclose(d_whole, d_parts, rtol=1e-12)
