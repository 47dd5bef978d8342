"""Sampling tests: CDF inversion vs histograms (SURVEY.md section 4 strategy)."""

import numpy as np
import pytest
import jax.numpy as jnp

from artes.atmosphere import SINBETA
from artes.opacity import henyey_greenstein, rayleigh
from artes.transport import sampling as S


def _tables(tab):
    """Per-cell tables from a 1-wavelength OpacityTable (single cell)."""
    scatter = tab.scatter[:, :, 0]                     # (180, 16)
    prefix = S.build_alpha_prefix(scatter[None])       # (1, 4, 181)
    w = SINBETA * np.pi / 180.0
    p_int = (scatter[:, :4] * w[:, None]).sum(axis=0)  # (4,)
    return scatter, prefix, p_int


def test_alpha_prefix_monotone_and_total():
    tab = rayleigh.generate([0.7])
    scatter, prefix, p_int = _tables(tab)
    assert prefix.shape == (1, 4, 181)
    # P11 prefix is monotone and ends at the P11 integral
    p11 = prefix[0, 0]
    assert (np.diff(p11) >= 0).all()
    assert p11[-1] == pytest.approx(p_int[0])


@pytest.mark.parametrize("generator,kwargs", [
    (rayleigh, {}),
    (henyey_greenstein, {"g1": 0.6}),
])
def test_alpha_distribution_unpolarized(generator, kwargs):
    """Sampled scattering cosines must histogram to P11 sin(theta)."""
    tab = generator.generate([0.7], **kwargs)
    scatter, prefix, p_int = _tables(tab)
    n = 200_000
    rng = np.random.default_rng(1)
    stokes = jnp.asarray(np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)))
    beta, c2b, s2b = S.sample_beta(
        jnp.asarray(np.tile(p_int, (n, 1))), stokes,
        jnp.asarray(rng.uniform(size=n)), jnp.asarray(rng.uniform(size=n)))
    alpha, alpha_deg = S.sample_alpha(
        jnp.asarray(prefix), jnp.zeros(n, jnp.int32), stokes,
        (c2b, s2b), jnp.asarray(rng.uniform(size=n)))
    np.testing.assert_allclose(np.asarray(alpha),
                               np.cos(np.deg2rad(np.asarray(alpha_deg))),
                               rtol=0, atol=1e-9)
    ang = np.degrees(np.arccos(np.asarray(alpha)))
    hist, _ = np.histogram(ang, bins=np.arange(181))
    expected = tab.scatter[:, 0, 0] * SINBETA
    expected = expected / expected.sum()
    got = hist / n
    # chi^2-ish comparison on bins with decent counts
    mask = expected > 1e-4
    np.testing.assert_allclose(got[mask], expected[mask], rtol=0.12, atol=3e-4)


def test_beta_uniform_for_unpolarized():
    tab = rayleigh.generate([0.7])
    _, _, p_int = _tables(tab)
    n = 100_000
    rng = np.random.default_rng(2)
    stokes = jnp.asarray(np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)))
    beta = np.asarray(S.sample_beta(
        jnp.asarray(np.tile(p_int, (n, 1))), stokes,
        jnp.asarray(rng.uniform(size=n)), jnp.asarray(rng.uniform(size=n)))[0])
    hist, _ = np.histogram(beta, bins=np.linspace(0, 2 * np.pi, 19))
    np.testing.assert_allclose(hist / n, 1 / 18, rtol=0.06)


def test_beta_modulated_for_polarized():
    """Fully Q-polarized light through Rayleigh: azimuth density follows
    a + b cos(2 beta) with b/a = (P12 int)/(P11 int) * Q/I."""
    tab = rayleigh.generate([0.7])
    _, _, p_int = _tables(tab)
    n = 400_000
    rng = np.random.default_rng(3)
    stokes = jnp.asarray(np.tile([1.0, 1.0, 0.0, 0.0], (n, 1)))
    beta = np.asarray(S.sample_beta(
        jnp.asarray(np.tile(p_int, (n, 1))), stokes,
        jnp.asarray(rng.uniform(size=n)), jnp.asarray(rng.uniform(size=n)))[0])
    # fit mean(cos 2 beta): E[cos2b] = b/(2a) for density propto a + b cos2b
    a, b = p_int[0], p_int[1]
    expected = b / (2 * a)
    got = np.mean(np.cos(2 * beta))
    assert got == pytest.approx(expected, abs=0.01)
    assert abs(expected) > 0.05  # the modulation is actually nontrivial


def test_beta_newton_inverts_cdf():
    """The sampled azimuth satisfies F(beta) = u1 * F(pi) for the continuous
    Stokes-weighted CDF (polarized input exercises the b, c terms)."""
    tab = rayleigh.generate([0.7])
    _, _, p_int = _tables(tab)
    n = 20_000
    rng = np.random.default_rng(7)
    stokes_np = np.tile([1.0, 0.6, -0.5, 0.1], (n, 1))
    u1 = rng.uniform(size=n)
    beta, c2b, s2b = S.sample_beta(
        jnp.asarray(np.tile(p_int, (n, 1))), jnp.asarray(stokes_np),
        jnp.asarray(u1), jnp.asarray(np.zeros(n)))  # u2 < 0.5: no mirror
    beta = np.asarray(beta)
    i, q, u, v = stokes_np.T
    a = p_int[0] * i + p_int[3] * v
    b = p_int[1] * q + p_int[2] * u
    c = p_int[1] * u - p_int[2] * q
    F = a * beta + 0.5 * b * np.sin(2 * beta) + 0.5 * c * (1 - np.cos(2 * beta))
    # the Newton converges on the small-angle-polynomial CDF (sincos_2beta:
    # series error < 3.3e-7 inside the pi/16 bracket), so the residual
    # against the EXACT CDF is bounded by the polynomial bias, not by the
    # iteration count — far below the f32 sampler resolution either way
    np.testing.assert_allclose(F, u1 * a * np.pi, rtol=0, atol=1e-7 * a.max())
    np.testing.assert_allclose(np.asarray(c2b), np.cos(2 * beta), atol=1e-9)
    np.testing.assert_allclose(np.asarray(s2b), np.sin(2 * beta), atol=1e-9)


def test_alpha_hierarchical_matches_full_scan():
    """The 15x12 hierarchical inversion picks the same bin as a flat scan of
    all 181 edges and interpolates identically."""
    tab = henyey_greenstein.generate([0.7], g1=0.7, p_linear=0.4)
    scatter, prefix, p_int = _tables(tab)
    n = 50_000
    rng = np.random.default_rng(8)
    stokes_np = np.tile([1.0, -0.4, 0.3, 0.0], (n, 1))
    u3 = rng.uniform(size=n)
    c2b = np.cos(2 * rng.uniform(0, np.pi, size=n))
    s2b = np.sqrt(1 - c2b**2) * np.sign(rng.uniform(-1, 1, size=n))
    alpha, alpha_deg = S.sample_alpha(
        jnp.asarray(prefix), jnp.zeros(n, jnp.int32), jnp.asarray(stokes_np),
        (jnp.asarray(c2b), jnp.asarray(s2b)), jnp.asarray(u3))
    # flat reference scan in float64
    i, q, u, v = stokes_np.T
    w = np.stack([i, c2b * q + s2b * u, -s2b * q + c2b * u, v], axis=-1)
    cum = w @ prefix[0]                      # (n, 181)
    target = u3 * cum[:, -1]
    k = 1 + np.sum(cum[:, 1:-1] < target[:, None], axis=1)
    lo = cum[np.arange(n), k - 1]
    hi = cum[np.arange(n), k]
    frac = np.where(hi > lo, (target - lo) / np.where(hi > lo, hi - lo, 1.0), 0.5)
    expect_deg = (k - 1) + frac
    np.testing.assert_allclose(np.asarray(alpha_deg), expect_deg, rtol=0, atol=5e-4)


def test_matrix_at_angle_interpolation():
    tab = rayleigh.generate([0.7])
    scatter = tab.scatter[:, :, 0]
    rows = jnp.asarray(scatter)  # single cell: (180,16)
    flat = rows.reshape(-1, 16)
    cell = jnp.zeros(5, jnp.int32)
    # exact bin centres return the rows themselves
    centres = jnp.asarray(np.deg2rad([0.5, 10.5, 90.5, 120.5, 179.5]))
    m = S.matrix_at_angle(flat, cell, centres)
    for k, row in enumerate([0, 10, 90, 120, 179]):
        np.testing.assert_allclose(np.asarray(m[k]).ravel(), scatter[row], rtol=1e-12)
    # midpoint between centres = average of adjacent rows
    mid = S.matrix_at_angle(flat, cell[:1], jnp.asarray([np.deg2rad(11.0)]))
    np.testing.assert_allclose(
        np.asarray(mid[0]).ravel(), 0.5 * (scatter[10] + scatter[11]), rtol=1e-12)
    # clamped at the edges (ARTES.f90:1462-1499)
    lo = S.matrix_at_angle(flat, cell[:1], jnp.asarray([np.deg2rad(0.1)]))
    np.testing.assert_allclose(np.asarray(lo[0]).ravel(), scatter[0], rtol=1e-12)
    hi = S.matrix_at_angle(flat, cell[:1], jnp.asarray([np.deg2rad(179.9)]))
    np.testing.assert_allclose(np.asarray(hi[0]).ravel(), scatter[179], rtol=1e-12)


def test_determinism():
    from artes.transport import rng as R

    keys = R.photon_keys(123, jnp.arange(64))
    u_a = R.uniform(keys, 7)
    u_b = R.uniform(keys, 7)
    np.testing.assert_array_equal(np.asarray(u_a), np.asarray(u_b))
    u_c = R.uniform(keys, 8)
    assert not np.allclose(u_a, u_c)
    # photon id determines the stream, not batch position
    keys2 = R.photon_keys(123, jnp.arange(32, 64))
    u_d = R.uniform(keys2, 7)
    np.testing.assert_array_equal(np.asarray(u_a)[32:], np.asarray(u_d))
