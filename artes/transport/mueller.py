"""Stokes-vector algebra: rotations, scattering application, new directions.

Re-derivation of the reference's meridian-plane bookkeeping
(``polarization_rotation`` ARTES.f90:1663-1932, ``mueller_matrix_filler``
:1934-1960, ``direction_cosine`` :1962-2052) as branch-free batched math.
The two renormalisations — polarized-intensity conservation across each
rotation and total-intensity conservation across the scattering matrix (for
propagation, not peeling) — are kept exactly, since output parity is judged
on Stokes vectors.

The reference works in angles (arccos/arctan2 per event). Here every
rotation consumes (cos 2psi, sin 2psi) built algebraically: the spherical
cosine rule yields cos(beta2) directly, double-angle identities give the
Mueller-block entries, and the new propagation direction comes from a local
orthonormal basis instead of spherical angles — the only transcendentals per
scattering are one sincos(beta).
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def mueller_rotate_cs(stokes, c2p, s2p):
    """Rotate (Q,U) by the 2x2 Mueller block L(psi) given (cos 2psi, sin 2psi)
    and renormalise so the polarized intensity is unchanged
    (ARTES.f90:1762-1781, :1942-1953)."""
    i, q, u, v = stokes[..., 0], stokes[..., 1], stokes[..., 2], stokes[..., 3]
    q_new = c2p * q + s2p * u
    u_new = -s2p * q + c2p * u
    p_in = jnp.sqrt(q * q + u * u + v * v)
    p_out = jnp.sqrt(q_new * q_new + u_new * u_new + v * v)
    norm = jnp.where(p_out > 0.0, p_in / jnp.where(p_out == 0.0, 1.0, p_out), 1.0)
    return jnp.stack([i, q_new * norm, u_new * norm, v * norm], axis=-1)


def mueller_rotate(stokes, psi):
    """:func:`mueller_rotate_cs` for an angle psi."""
    return mueller_rotate_cs(stokes, jnp.cos(2.0 * psi), jnp.sin(2.0 * psi))


def apply_scatter(scatter, stokes):
    """(..., 4, 4) @ (..., 4), as an elementwise multiply-and-sum (exact f32
    products; no matmul unit, no TF32)."""
    return jnp.sum(scatter * stokes[..., None, :], axis=-1)


def _cos_to_double_angle(cpsi, sign_sin):
    """(cos 2psi, sin 2psi) from cos(psi) in [-1, 1] and the sign of
    sin(psi) (psi in [0, pi] has sin >= 0; ``sign_sin`` = -1 mirrors it)."""
    c2 = 2.0 * cpsi * cpsi - 1.0
    s2 = 2.0 * cpsi * jnp.sqrt(jnp.maximum(1.0 - cpsi * cpsi, 0.0)) * sign_sin
    return c2, s2


def polarization_rotation(alpha, beta, stokes, scatter, dirn, dirn_new,
                          peeling: bool, beta_trig=None, beta_sign=None):
    """Meridian -> scattering plane -> meridian Stokes update.

    ``alpha`` is cos of the scattering angle, ``beta`` the azimuthal scattering
    angle in [0, 2 pi); ``beta_trig`` optionally carries (cos 2beta, sin 2beta)
    from the sampler. ``scatter`` is the (..., 4, 4) matrix interpolated at
    the scattering angle. Assumes |alpha| < 1 (samplers clip); the reference's
    exact-forward/backward edge branches (:1856-1920) are unreachable then.
    """
    # cos(beta2) from the spherical cosine rule (ARTES.f90:1728-1751)
    dz = dirn[..., 2]
    dzn = dirn_new[..., 2]
    salpha = jnp.sqrt(jnp.maximum(1.0 - alpha * alpha, 0.0))
    szn = jnp.sqrt(jnp.maximum(1.0 - dzn * dzn, 0.0))
    denom = salpha * szn
    cbeta2 = jnp.clip((dz - dzn * alpha) / jnp.where(denom == 0.0, 1.0, denom),
                      -1.0, 1.0)
    cbeta2 = jnp.where(denom == 0.0, 1.0, cbeta2)

    if beta_trig is None:
        c2b, s2b = jnp.cos(2.0 * beta), jnp.sin(2.0 * beta)
    else:
        c2b, s2b = beta_trig
    # rotate meridian -> scattering plane by beta (:1753-1781)
    stokes_rot = mueller_rotate_cs(stokes, c2b, s2b)
    # apply the 4x4 scattering matrix (:1783-1795)
    stokes_sc = apply_scatter(scatter, stokes_rot)
    if not peeling:
        # conserve Stokes I across the scattering event (:1799-1814)
        i_sc = stokes_sc[..., 0]
        norm = jnp.where(i_sc > 0.0, stokes_rot[..., 0] / jnp.where(i_sc == 0.0, 1.0, i_sc), 0.0)
        stokes_sc = stokes_sc * norm[..., None]
    # rotate back into the meridian plane; for beta in [pi, 2 pi) the second
    # rotation angle flips sign (:1816-1826)
    if beta_sign is None:
        beta_sign = jnp.where(beta < jnp.pi, 1.0, -1.0)
    c2p2, s2p2 = _cos_to_double_angle(cbeta2, beta_sign)
    return mueller_rotate_cs(stokes_sc, c2p2, s2p2)


def direction_cosine(alpha, beta, dirn):
    """New propagation direction from (alpha, beta): rotate by the scattering
    angle around the meridian-frame basis (the angle-free re-derivation of
    ARTES.f90:1962-2052; beta is measured from the meridian plane, increasing
    azimuth for beta < pi, matching the reference's quadrant logic)."""
    dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    sto2 = jnp.maximum(1.0 - dz * dz, 0.0)
    sto = jnp.sqrt(sto2)
    degen = sto < 1.0e-12
    inv = 1.0 / jnp.where(degen, 1.0, sto)
    # meridian basis: e1 points along decreasing polar angle, e2 = e1 x d
    e1x = jnp.where(degen, 1.0, -dz * dx * inv)
    e1y = jnp.where(degen, 0.0, -dz * dy * inv)
    e1z = jnp.where(degen, 0.0, sto)
    e2x = jnp.where(degen, 0.0, -dy * inv)
    e2y = jnp.where(degen, -dz, dx * inv)
    e2z = jnp.zeros_like(dz)

    salpha = jnp.sqrt(jnp.maximum(1.0 - alpha * alpha, 0.0))
    cb = jnp.cos(beta)
    sb = jnp.sin(beta)
    wx = salpha * (cb * e1x + sb * e2x)
    wy = salpha * (cb * e1y + sb * e2y)
    wz = salpha * (cb * e1z + sb * e2z)
    nx = alpha * dx + wx
    ny = alpha * dy + wy
    nz = alpha * dz + wz
    # keep the direction unit-length against float drift (the reference flags
    # non-unit directions as error 054, ARTES.f90:1257-1264)
    inv_norm = 1.0 / jnp.sqrt(nx * nx + ny * ny + nz * nz)
    return jnp.stack([nx * inv_norm, ny * inv_norm, nz * inv_norm], axis=-1)


def rotation_matrix(axis: int, angle):
    """3x3 axis rotation (ARTES.f90:1270-1326); axis in {0: x, 1: y, 2: z}."""
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)
