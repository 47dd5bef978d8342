import numpy as np
import pytest
import jax.numpy as jnp

from artes.opacity import rayleigh
from artes.transport import mueller as M


def test_mueller_rotate_invariants():
    rng = np.random.default_rng(0)
    stokes = jnp.asarray(rng.normal(size=(64, 4)))
    psi = jnp.asarray(rng.uniform(0, 2 * np.pi, 64))
    out = M.mueller_rotate(stokes, psi)
    # I and V unchanged, Q^2+U^2 preserved
    np.testing.assert_allclose(out[:, 0], stokes[:, 0])
    np.testing.assert_allclose(out[:, 3], stokes[:, 3], rtol=1e-12)
    np.testing.assert_allclose(
        out[:, 1] ** 2 + out[:, 2] ** 2,
        np.asarray(stokes[:, 1] ** 2 + stokes[:, 2] ** 2), rtol=1e-10)


def test_mueller_rotate_composition():
    rng = np.random.default_rng(1)
    stokes = jnp.asarray(rng.normal(size=(16, 4)))
    p1 = jnp.asarray(rng.uniform(0, np.pi, 16))
    p2 = jnp.asarray(rng.uniform(0, np.pi, 16))
    a = M.mueller_rotate(M.mueller_rotate(stokes, p1), p2)
    b = M.mueller_rotate(stokes, p1 + p2)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_direction_cosine_angle_preserved():
    rng = np.random.default_rng(2)
    n = 256
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alpha = jnp.asarray(rng.uniform(-0.99, 0.99, n))
    beta = jnp.asarray(rng.uniform(1e-6, 2 * np.pi - 1e-6, n))
    d_new = M.direction_cosine(alpha, beta, jnp.asarray(d))
    # unit norm
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d_new), axis=1), 1.0, rtol=1e-10)
    # scattering angle preserved: d . d_new == alpha
    dots = np.sum(np.asarray(d_new) * d, axis=1)
    np.testing.assert_allclose(dots, np.asarray(alpha), atol=1e-7)


def test_direction_cosine_beta_recovered():
    """The sampled azimuth must satisfy the reference's own cross-check
    (the disabled assertion at ARTES.f90:1677-1714)."""
    rng = np.random.default_rng(3)
    n = 256
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d[np.abs(d[:, 2]) < 0.95]
    n = len(d)
    alpha = rng.uniform(-0.95, 0.95, n)
    beta = rng.uniform(0.05, 2 * np.pi - 0.05, n)
    d_new = np.asarray(M.direction_cosine(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(d)))
    num = (d_new[:, 2] - d[:, 2] * alpha) / (np.sqrt(1 - alpha**2) * np.sqrt(1 - d[:, 2] ** 2))
    beta_check = np.arccos(np.clip(num, -1, 1))
    beta_check = np.where(beta >= np.pi, 2 * np.pi - beta_check, beta_check)
    np.testing.assert_allclose(beta_check, beta, atol=1e-5)


def test_rayleigh_90deg_full_polarization():
    """Unpolarized light Rayleigh-scattered by 90 deg -> ~100% linear polarization."""
    tab = rayleigh.generate([0.7])
    row = tab.scatter[90, :, 0].reshape(4, 4)  # ~90.5 deg bin
    stokes = jnp.asarray([[1.0, 0.0, 0.0, 0.0]])
    dirn = jnp.asarray([[1.0, 0.0, 0.0]])
    alpha = jnp.asarray([np.cos(np.deg2rad(90.5))])
    beta = jnp.asarray([1e-8])  # scattering plane ~ meridian plane
    d_new = M.direction_cosine(alpha, beta, dirn)
    out = np.asarray(M.polarization_rotation(
        alpha, beta, stokes, jnp.asarray(row)[None], dirn, d_new, peeling=False))[0]
    assert out[0] == pytest.approx(1.0)  # I conserved for propagation
    dop = np.hypot(out[1], out[2]) / out[0]
    assert dop == pytest.approx(1.0, abs=1e-3)


def test_polarization_rotation_conserves_I():
    rng = np.random.default_rng(4)
    tab = rayleigh.generate([0.7])
    n = 128
    rows = tab.scatter[rng.integers(0, 180, n), :, 0].reshape(n, 4, 4)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alpha = jnp.asarray(rng.uniform(-0.95, 0.95, n))
    beta = jnp.asarray(rng.uniform(0.05, 2 * np.pi - 0.05, n))
    q = rng.uniform(-0.5, 0.5, n)
    u = rng.uniform(-0.5, 0.5, n)
    stokes = jnp.asarray(np.stack([np.ones(n), q, u, np.zeros(n)], axis=1))
    d_new = M.direction_cosine(alpha, beta, jnp.asarray(d))
    out = np.asarray(M.polarization_rotation(
        alpha, beta, stokes, jnp.asarray(rows), jnp.asarray(d), d_new, peeling=False))
    np.testing.assert_allclose(out[:, 0], 1.0, rtol=1e-12)
    # physical: polarized fraction cannot exceed 1 (allow tiny numerics)
    dop = np.sqrt(out[:, 1] ** 2 + out[:, 2] ** 2 + out[:, 3] ** 2)
    assert (dop <= 1.0 + 1e-9).all()


def test_peeling_preserves_scatter_scale():
    """With peeling=True no I-renormalisation happens: scattering unpolarized
    light returns I = P11 at the scattering angle."""
    tab = rayleigh.generate([0.7])
    idx = 45
    row = tab.scatter[idx, :, 0].reshape(4, 4)
    stokes = jnp.asarray([[1.0, 0.0, 0.0, 0.0]])
    dirn = jnp.asarray([[1.0, 0.0, 0.0]])
    ang = np.deg2rad(idx + 0.5)
    alpha = jnp.asarray([np.cos(ang)])
    beta = jnp.asarray([0.3])
    d_new = M.direction_cosine(alpha, beta, dirn)
    out = np.asarray(M.polarization_rotation(
        alpha, beta, stokes, jnp.asarray(row)[None], dirn, d_new, peeling=True))[0]
    assert out[0] == pytest.approx(tab.scatter[idx, 0, 0], rel=1e-12)


def test_rotation_matrix():
    r = np.asarray(M.rotation_matrix(2, jnp.asarray(np.pi / 2)))
    np.testing.assert_allclose(r @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-12)
    r = np.asarray(M.rotation_matrix(1, jnp.asarray(np.pi / 2)))
    np.testing.assert_allclose(r @ np.array([1.0, 0, 0]), [0, 0, -1], atol=1e-12)
