"""Stokes-weighted scattering-angle sampling and matrix interpolation.

The reference builds a 180-bin CDF per scattering event with a serial loop and
inverts it by linear scan (``scattering_angle_sampling`` ARTES.f90:1534-1661).
The batched re-design replaces both scans:

* **Azimuth** (``sample_beta``): the reference's prefix sums of *bin-averaged*
  cos2beta/sin2beta telescope to the exact continuous integrals, so the
  discrete 181-edge CDF equals ``F(beta) = a*beta + b*sin(2 beta)/2 +
  c*(1-cos(2 beta))/2`` at every edge. F is inverted directly with a
  safeguarded (bracketed) Newton iteration — ~6 sincos evaluations per event
  instead of a materialized (B, 181) table. The sampled azimuth is the exact
  continuous inverse rather than the reference's within-bin linear
  interpolation (a strictly finer approximation of the same density).
* **Scattering angle** (``sample_alpha``): the tabulated 180-bin CDF is
  inverted hierarchically — 15 coarse blocks of 12 bins — so an event touches
  16 + 13 CDF edges instead of 181. The edge values are the same prefix-table
  dot products the flat scan would compare, so the selected bin is identical
  (up to float ties in zero-density bins).

Conventions follow the reference: 180 one-degree bins, inverse-CDF linear
interpolation inside the bin, the beta half-plane flip, and the
half-degree-centred matrix interpolation of ``scatter_photon``
(ARTES.f90:1448-1530).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from artes.transport.geometry import gather_rows

N_ANGLE = 180
N_COARSE = 15          # coarse blocks in the hierarchical alpha inversion
N_FINE = 12            # bins per coarse block (N_COARSE * N_FINE == N_ANGLE)
_DEG = np.pi / 180.0

_NEWTON_ITERS = 3
_N_BETA_COARSE = 16
# Continuous-CDF basis at the coarse azimuth edges j*pi/16: F(beta) =
# a*beta + b*sin(2 beta)/2 + c*(1 - cos(2 beta))/2 evaluated via constants.
_BETA_EDGES = np.linspace(0.0, np.pi, _N_BETA_COARSE + 1)
_BETA_BASIS = np.stack([_BETA_EDGES,
                        0.5 * np.sin(2.0 * _BETA_EDGES),
                        0.5 * (1.0 - np.cos(2.0 * _BETA_EDGES))])  # (3, 17)
# sin/cos of 2*edge at the 16 bracket-lo edges (cast to the table dtype)
BETA_EDGE_SIN2 = np.sin(2.0 * _BETA_EDGES[:_N_BETA_COARSE])
BETA_EDGE_COS2 = np.cos(2.0 * _BETA_EDGES[:_N_BETA_COARSE])


def sincos_2beta(delta, s2lo, c2lo):
    """sin/cos(2 beta) for beta = lo0 + delta, delta in [0, pi/16].

    Angle addition off the bracket's lower edge with small-angle
    polynomials for sin/cos(2 delta) (|2 delta| <= pi/8 + ulp: series error
    < 3e-7, below the f32 resolution of the transcendental it replaces and
    far inside MC noise). Replaces the two sin/cos calls per Newton
    iteration, the largest arithmetic block of the pool round."""
    x = 2.0 * delta
    x2 = x * x
    sx = x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0)))
    cx = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 - x2 * (1.0 / 720.0)))
    return s2lo * cx + c2lo * sx, c2lo * cx - s2lo * sx


def build_alpha_prefix(scatter_cell):
    """Per-cell prefix tables for the scattering-angle CDF.

    ``scatter_cell``: (..., 180, 16) normalised matrices. Returns
    (..., 4, 181): prefix sums over bins of P1k(i) * sinbeta(i) * pi/180
    (the weights of ARTES.f90:1610-1623).
    """
    from artes.atmosphere import SINBETA

    w = SINBETA * _DEG  # (180,)
    weighted = scatter_cell[..., :4] * w[..., :, None]      # (..., 180, 4)
    prefix = np.cumsum(weighted, axis=-2)                    # (..., 180, 4)
    zeros = np.zeros_like(prefix[..., :1, :])
    return np.concatenate([zeros, prefix], axis=-2).swapaxes(-1, -2)  # (...,4,181)


def alpha_tables(alpha_prefix_all):
    """Hierarchical views of the (ncell, 4, 181) prefix table.

    Returns ``(coarse, fine)``: coarse (ncell, 4, 16) holds the prefix at
    every 12th edge; fine (ncell, 15, 4, 13) holds the 13 edges of each
    coarse block (the last edge of block b is the first of block b+1). Pure
    slicing — XLA hoists it out of transport loops.
    """
    nc = alpha_prefix_all.shape[0]
    coarse = alpha_prefix_all[:, :, ::N_FINE]                     # (nc, 4, 16)
    body = alpha_prefix_all[:, :, :N_ANGLE].reshape(nc, 4, N_COARSE, N_FINE)
    last = alpha_prefix_all[:, :, N_FINE::N_FINE].reshape(nc, 4, N_COARSE, 1)
    fine = jnp.concatenate([body, last], axis=-1)                 # (nc,4,15,13)
    return coarse, jnp.swapaxes(fine, 1, 2)                       # (nc,15,4,13)


def sample_beta(p_int, stokes, u1, u2):
    """Azimuthal scattering angle from the continuous Stokes-weighted CDF
    (the exact integral of the reference's binned density, ARTES.f90:1545-1593).

    ``p_int``: (B, 4) gathered per-cell [P11,P12,P13,P14] angular integrals.
    Returns ``(beta, cos_2beta, sin_2beta)`` with beta in (0, 2 pi); the 2-beta
    trig (invariant under the half-plane mirror) is returned for reuse by the
    alpha weights.
    """
    dt = stokes.dtype
    i, q, u, v = stokes[..., 0], stokes[..., 1], stokes[..., 2], stokes[..., 3]
    p11, p12, p13, p14 = p_int[..., 0], p_int[..., 1], p_int[..., 2], p_int[..., 3]
    # density(beta) propto a + b*cos(2 beta) + c*sin(2 beta) on [0, pi)
    a = p11 * i + p14 * v
    b = p12 * q + p13 * u
    c = p12 * u - p13 * q

    pi_ = jnp.asarray(np.pi, dt)
    a_safe = jnp.where(a == 0.0, 1.0, a)
    target = u1 * a * pi_  # F(pi) = a*pi exactly
    # Stage 1: bracket the root between coarse edges j*pi/16 — F at all 17
    # edges against precomputed trig, as elementwise multiply-adds
    basis = jnp.asarray(_BETA_BASIS, dt)
    cum = (a[..., None] * basis[0] + b[..., None] * basis[1]
           + c[..., None] * basis[2])
    k = _edge_count(cum, target, 1, _N_BETA_COARSE)     # block in [0, 15]
    cum_lo, cum_hi = _pick_edges(cum, k + 1)
    width = pi_ / _N_BETA_COARSE
    lo = k.astype(dt) * width
    hi = lo + width
    # trig at the bracket's lower edge: every subsequent sin/cos(2 beta)
    # is angle addition off this pair (sincos_2beta), not a transcendental
    lo0 = lo
    s2lo = jnp.take(jnp.asarray(BETA_EDGE_SIN2, dt), k)
    c2lo = jnp.take(jnp.asarray(BETA_EDGE_COS2, dt), k)
    dcum = cum_hi - cum_lo
    # secant initial guess inside the bracket
    beta = lo + width * jnp.where(dcum > 0.0,
                                  (target - cum_lo) / jnp.where(dcum == 0.0, 1.0, dcum),
                                  0.5)
    # Stage 2: guarded Newton on g(beta) = F(beta) - target, g' = density
    # >= 0. A step landing outside the bracket (possible where the density
    # touches zero) falls back to bisection; zero-density plateaus carry zero
    # probability mass, so the residual bracket there is immaterial.
    gp_floor = jnp.asarray(1e-12, dt) * jnp.abs(a_safe)
    # f32 (production): angle-addition polynomial — no transcendentals in
    # the loop.
    # f64 (the strict equality contracts: run_batch==run_stream at 1e-12,
    # dryrun tier 1): exact sin/cos — libm calls are deterministic across
    # compilation contexts, while the polynomial's FMA contraction is not.
    use_poly = dt == jnp.float32
    for _ in range(_NEWTON_ITERS):
        if use_poly:
            s2b, c2b = sincos_2beta(beta - lo0, s2lo, c2lo)
        else:
            s2b = jnp.sin(2.0 * beta)
            c2b = jnp.cos(2.0 * beta)
        g = a * beta + 0.5 * b * s2b + 0.5 * c * (1.0 - c2b) - target
        gp = a + b * c2b + c * s2b
        lo = jnp.where(g < 0.0, beta, lo)
        hi = jnp.where(g < 0.0, hi, beta)
        step = g / jnp.maximum(gp, gp_floor)
        beta_n = beta - step
        # strict outside test: a converged step lands ON the bracket edge
        # (beta_n == hi after hi <- beta) and must be accepted, not bisected
        bad = (beta_n < lo) | (beta_n > hi) | ~jnp.isfinite(beta_n)
        beta = jnp.where(bad, 0.5 * (lo + hi), beta_n)
    # final trig EXACTLY (one transcendental pair): the in-loop polynomial's
    # FMA contraction differs between compilers, so the values entering the
    # physics must come from the converged beta, not the polynomial — the
    # root itself self-corrects to ~1 ulp across compilations
    c2b = jnp.cos(2.0 * beta)
    s2b = jnp.sin(2.0 * beta)
    # mirror to the other half-plane with probability 1/2 (:1589-1590);
    # cos/sin(2 beta) are invariant under beta -> beta + pi
    beta = jnp.where(u2 > 0.5, beta + pi_, beta)
    two_pi = 2.0 * jnp.pi
    beta = jnp.where(beta >= two_pi, two_pi - 1.0e-10, beta)
    beta = jnp.where(beta <= 0.0, 1.0e-10, beta)
    return beta, c2b, s2b


def alpha_weights(stokes, c2b, s2b):
    """Stokes/azimuth weights of the conditional alpha CDF: the coefficient
    of each matrix-row prefix (ARTES.f90:1612-1617). Returns (B, 4)."""
    i, q, u, v = stokes[..., 0], stokes[..., 1], stokes[..., 2], stokes[..., 3]
    return jnp.stack([i, c2b * q + s2b * u, -s2b * q + c2b * u, v], axis=-1)


def _edge_count(cum, target, lo, hi):
    """count of edges j in [lo, hi) with cum[..., j] < target (the
    vectorized form of the reference's linear scan, ARTES.f90:1565-1587)."""
    return jnp.sum((cum[..., lo:hi] < target[..., None]), axis=-1).astype(jnp.int32)


def _pick_edges(cum, k):
    """(cum[k-1], cum[k]) via one-hot row selects (no per-lane gathers)."""
    edges = jax.lax.broadcasted_iota(jnp.int32, cum.shape, cum.ndim - 1)
    sel_lo = edges == (k - 1)[..., None]
    sel_hi = edges == k[..., None]
    cum_lo = jnp.sum(jnp.where(sel_lo, cum, 0.0), axis=-1)
    cum_hi = jnp.sum(jnp.where(sel_hi, cum, 0.0), axis=-1)
    return cum_lo, cum_hi


def sample_alpha(alpha_prefix_all, cell_flat, stokes, beta_trig, u3):
    """Scattering-angle cosine from the conditional tabulated CDF
    (ARTES.f90:1597-1659), inverted hierarchically (15 coarse x 12 fine bins).

    ``beta_trig``: the ``(c2b, s2b)`` pair from :func:`sample_beta`.
    Returns ``(alpha, alpha_deg)``: the cosine (clipped to (-1, 1)) and the
    sampled angle in degrees — the latter feeds the matrix interpolation
    without an arccos.
    """
    c2b, s2b = beta_trig
    dt = stokes.dtype
    w = alpha_weights(stokes, c2b, s2b)                 # (B, 4)
    nc = alpha_prefix_all.shape[0]
    coarse, fine = alpha_tables(alpha_prefix_all)

    # per-lane row gathers (on the H100 they beat folding a cell one-hot
    # into the weights by 26 % on the flagship; PERF.md)
    rows_c = gather_rows(coarse, cell_flat)             # (B, 4, 16)
    cum_c = jnp.sum(w[..., :, None] * rows_c, axis=-2)
    target = u3 * cum_c[..., -1]
    k1 = _edge_count(cum_c, target, 1, N_COARSE)        # coarse block in [0,14]
    rows_f = fine.reshape(nc * N_COARSE, 4, N_FINE + 1)[cell_flat * N_COARSE + k1]
    cum_f = jnp.sum(w[..., :, None] * rows_f, axis=-2)  # (B, 13)

    k2 = 1 + _edge_count(cum_f, target, 1, N_FINE)      # fine edge in [1,12]
    cum_lo, cum_hi = _pick_edges(cum_f, k2)
    dcum = cum_hi - cum_lo
    frac = (target - cum_lo) / jnp.where(dcum == 0.0, 1.0, dcum)
    frac = jnp.where(dcum == 0.0, 0.5, frac)
    alpha_deg = (k1 * N_FINE + k2 - 1).astype(dt) + frac
    eps = 1.0e-10
    alpha = jnp.clip(jnp.cos(alpha_deg * _DEG), -1.0 + eps, 1.0 - eps)
    return alpha, alpha_deg


def matrix_at_angle_deg(scatter_rows, cell_flat, angle_deg):
    """Interpolate the 16-element matrix at a scattering angle given in
    degrees. Bins are centred at (i - 0.5) degrees (ARTES.f90:1506-1509):
    linear interpolation between adjacent rows, clamped at the first/last bin.

    ``scatter_rows``: (ncell * 180, 16) flattened per-cell matrices.
    """
    dt = angle_deg.dtype
    t = angle_deg - 0.5
    r0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, N_ANGLE - 2)
    frac = jnp.clip(t - r0.astype(dt), 0.0, 1.0)
    base = cell_flat * N_ANGLE
    row0 = scatter_rows[base + r0]          # (B, 16)
    row1 = scatter_rows[base + r0 + 1]
    m = row0 + (row1 - row0) * frac[..., None]
    return m.reshape(m.shape[:-1] + (4, 4))


def matrix_at_angle(scatter_rows, cell_flat, acos_alpha):
    """:func:`matrix_at_angle_deg` for an angle in radians."""
    return matrix_at_angle_deg(scatter_rows, cell_flat, acos_alpha / _DEG)
