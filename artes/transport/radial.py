"""Closed-form radial transport: loop-free shell-chord marching.

For 1-D spherical (optionally oblate) grids — the reference's dominant use
case (hydrostatic/molecular atmospheres, python/atmosphere.py:127-167) — the
optical depth along a straight ray is a SUM of per-shell chord lengths, and
the cell-by-cell march (cell_face + while_loop, ARTES.f90:687-778) reduces
to branch-free vector algebra:

  In transformed coordinates X = (a x, b y, c z) the squared radius along a
  ray is the quadratic r^2(s) = A s^2 + 2 B s + C, so face radius rf[j] is
  crossed at the two roots of A s^2 + 2 B s + (C - rf[j]^2) = 0. Forward
  from s=0 the radius falls to the perigee then rises, so inward crossings
  e[j] = max(lo_j, 0) happen in decreasing-j order and outward crossings
  h[j] = max(hi_j, 0) in increasing-j order; faces the ray never reaches
  collapse to the perigee parameter (zero-length segments). Per-shell path
  lengths are max(0, e[m] - e[m+1]) inbound and max(0, h[m+1] - h[m])
  outbound, truncated at the photon-floor entry (the "surface" face,
  ARTES.f90:755-774), and the march to a sampled optical depth is a
  prefix-sum walk over at most 2 nr TRACE-TIME-unrolled segments — no
  data-dependent loop at all.

This removes the three per-round ``lax.while_loop``s (transport march, peel
walk, prewalk) whose lockstep trip count scales with cell crossings — the
reason the mixture-dedup kernel still ran nr=39 grids at 7M photons/s while
nr=1 ran at 87M. It is also numerically cleaner than marching: no same-face
epsilons, no candidate selection, no no-candidate failures (the marching
kernels abandon ~0.7% of photons to error 031 on 2.5-km shells in f32; the
closed form abandons none).

Scope: radial-only grids withOUT a Lambert surface (multi-bounce surface
legs keep the marching path). Flow diagnostics ARE covered (r5): the
march's ``flow`` hook books every trace-time shell segment. The photon
floor itself is handled: rays entering the floor sphere stop there
(absorbed, or prewalk surface flag).

The transport kernel (kernel.py) calls these functions on (B,) lane
arrays; the per-face scalars are trace-time lists, so every walk unrolls
into straight-line vector code.

Draw-site note: the marching transport consumed 3 RNG sites per cell
crossing (lane-dependent); the closed-form march consumes NONE (the sites
existed only for the in-march Lambert surface draws, out of scope here).
The schedule differs from the marching path's (a deliberate, documented
stream break — MC expectations are unchanged).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = 1.0e30


def use_closed_form(grid, static) -> bool:
    """Closed-form path applies: radial-only, no surface. Flow diagnostics
    are booked per trace-time shell segment (see :func:`march`'s ``flow``
    hook), so they no longer force the marching path (r5)."""
    return (grid.ntheta == 1 and grid.nphi == 1
            and not static.has_surface)


def ray_chords(a2, b2, c2, rf, rf_floor, pos_eps, px, py, pz, dx, dy, dz):
    """Forward crossing parameters of every face sphere plus the floor.

    ``rf`` is a list of nr+1 per-face radius scalars (indexed constants);
    ``rf_floor`` the photon-floor radius
    rfront[cell_depth] (may be traced). Returns ``(e, h, surface_hit,
    s_surf)``: clamped inward/outward crossing parameters per face, whether
    the forward path enters the floor sphere, and where (BIG when it does
    not — used to truncate inbound segments).
    """
    nr = len(rf) - 1
    A = a2 * dx * dx + b2 * dy * dy + c2 * dz * dz
    Bq = a2 * px * dx + b2 * py * dy + c2 * pz * dz
    Cq = a2 * px * px + b2 * py * py + c2 * pz * pz
    inv_a = 1.0 / A
    mb = -Bq * inv_a                      # perigee parameter
    sgn_b = jnp.where(Bq >= 0.0, 1.0, -1.0)

    def roots(r_face):
        # stable q-form roots: the naive (-B ± sqrt)/A cancels
        # catastrophically for grazing chords on thin shells in f32;
        # q = -(B + sign(B) sqrt(disc)) gives roots q/A and C'/q with
        # full relative accuracy (|q| >= sqrt(disc) > 0 whenever ok)
        Cj = Cq - r_face * r_face
        disc = Bq * Bq - A * Cj
        ok = disc > 0.0
        q = -(Bq + sgn_b * jnp.sqrt(jnp.where(ok, disc, 0.0)))
        r1 = q * inv_a
        r2 = Cj / jnp.where(q == 0.0, 1.0, q)
        lo = jnp.where(ok, jnp.minimum(r1, r2), mb)
        hi = jnp.where(ok, jnp.maximum(r1, r2), mb)
        return lo, hi, ok

    e = [None] * (nr + 1)
    h = [None] * (nr + 1)
    for j in range(nr + 1):
        lo, hi, _ = roots(rf[j])
        e[j] = jnp.maximum(lo, 0.0)
        h[j] = jnp.maximum(hi, 0.0)
    lo_f, _, ok_f = roots(rf_floor)
    # the pos_eps guard keeps lanes starting ON the floor (moving outward,
    # lo ~ -0) from re-triggering a zero-distance surface hit
    surface_hit = ok_f & (lo_f > pos_eps)
    s_surf = jnp.where(surface_hit, lo_f, BIG)
    return e, h, surface_hit, s_surf


def tau_from_chords(e, h, surface_hit, s_surf, kx):
    """Optical-depth sum over precomputed chords (the inner loops of
    :func:`tau_walk`, reusable when the caller already has the crossing
    parameters — e.g. the 3-D jump walk's kbar baseline)."""
    nr = len(e) - 1
    tau = None
    for m in range(nr - 1, -1, -1):       # inbound, path order
        seg = jnp.maximum(jnp.minimum(e[m], s_surf)
                          - jnp.minimum(e[m + 1], s_surf), 0.0)
        contrib = kx[m] * seg
        tau = contrib if tau is None else tau + contrib
    for m in range(nr):                    # outbound (zero past the floor)
        seg = jnp.maximum(h[m + 1] - h[m], 0.0)
        tau = tau + jnp.where(surface_hit, 0.0, kx[m] * seg)
    return tau


def tau_walk(a2, b2, c2, rf, kx, rf_floor, pos_eps,
             px, py, pz, dx, dy, dz):
    """Total optical depth to the grid boundary or floor along a ray
    (the prewalk ARTES.f90:623-656 / peel walk :4542-4569, loop-free).

    ``kx`` is a list of nr per-cell opacity scalars. Returns a dict with
    ``tau``, ``exited``, ``surface``, ``err`` matching the marching
    tau-walk contract (``err`` is always False — no failure modes).
    """
    e, h, surface_hit, s_surf = ray_chords(a2, b2, c2, rf, rf_floor,
                                           pos_eps, px, py, pz, dx, dy, dz)
    tau = tau_from_chords(e, h, surface_hit, s_surf, kx)
    return dict(tau=tau, exited=~surface_hit, surface=surface_hit,
                err=jnp.zeros_like(surface_hit))


def march(a2, b2, c2, rf, kx, rf_floor, pos_eps,
          px, py, pz, dx, dy, dz, tau_budget, active, i32,
          energy=None, flow=None):
    """March to the sampled optical depth (ARTES.f90:687-778, loop-free).

    Returns ``s_stop`` (path length consumed; the surface-arrival distance
    for floor-hit lanes), ``cr`` (radial cell at an interaction),
    ``inter``, ``exited``, ``surface`` (arrived at the floor with budget to
    spare — absorbed, since this path excludes Lambert surfaces), and
    ``tau_surf`` (optical depth consumed up to the floor).

    ``flow`` (optional, with ``energy`` = per-lane Stokes I): an object
    with ``add_g(m, wr, wt, wp)`` / ``add_t(m, col, w)`` receiving per-lane
    MASKED contributions of each trace-time shell segment — the closed-form
    equivalent of the marching kernel's per-crossing flow booking
    (kernel._flow_global_update / _flow_theta_update; ARTES.f90:711-744):
    flow_global books energy*distance projected at the segment's END
    position for every step including the interaction/absorption partials;
    flow_theta books energy at full crossings (col 0 outward, 1 inward).
    """
    nr = len(rf) - 1
    e, h, surface_hit, s_surf = ray_chords(a2, b2, c2, rf, rf_floor,
                                           pos_eps, px, py, pz, dx, dy, dz)

    if flow is not None:
        # RAY-CONSTANT projection coefficients (r5): the segment-end
        # projections onto the local (r, theta, phi) unit vectors are
        # polynomials in the path parameter t over inv_r(t), inv_rho(t)
        # (r^2 and rho^2 are quadratics in t; the phi numerator
        # px dy - py dx is the conserved angular momentum), so each
        # segment costs a handful of FMAs + two rsqrts instead of
        # rebuilding positions and quotients — exact-math equal to the
        # trig form in kernel._flow_global_update (not bit-equal: rsqrt
        # rounds differently). (|d| = 1 is used for the radial numerator
        # pd + t.)
        pd = px * dx + py * dy + pz * dz
        p2 = px * px + py * py + pz * pz
        pdxy = px * dx + py * dy
        pq2 = px * px + py * py
        dq2 = dx * dx + dy * dy
        lz = px * dy - py * dx

    def book(m, mask_m, hit, start, seg, s_stop_m, outward):
        dist = jnp.where(hit, s_stop_m - start, seg)
        t = jnp.where(hit, s_stop_m, start + seg)
        r2 = t * (t + 2.0 * pd) + p2
        rho2 = (dq2 * t + 2.0 * pdxy) * t + pq2
        # guards must stay f32-representable: dead lanes sit at the origin
        # (r2 = rho2 = 0), and an underflowed-to-zero guard would turn
        # their masked w = 0 into rsqrt(0) * 0 = NaN
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, 1e-30))
        inv_rho = jax.lax.rsqrt(jnp.maximum(rho2, 1e-30))
        w = energy * dist * mask_m
        wr = (pd + t) * inv_r * w
        tnum = (pz + t * dz) * (pdxy + t * dq2) - rho2 * dz
        wt = tnum * (inv_rho * inv_r) * w
        wp = lz * inv_rho * w
        flow.add_g(m, wr, wt, wp)
        crossing = mask_m & ~hit
        flow.add_t(m, 0 if outward else 1, energy * crossing)

    cum = jnp.zeros_like(px)
    inter = jnp.zeros_like(surface_hit)
    s_stop = jnp.zeros_like(px)
    cr_stop = jnp.zeros(px.shape, i32)
    for m in range(nr - 1, -1, -1):       # inbound segments, path order
        start = jnp.minimum(e[m + 1], s_surf)
        seg = jnp.maximum(jnp.minimum(e[m], s_surf) - start, 0.0)
        c_new = cum + kx[m] * seg
        k_safe = jnp.where(kx[m] == 0.0, 1.0, kx[m])
        hit = active & ~inter & (c_new > tau_budget)
        s_stop_m = start + (tau_budget - cum) / k_safe
        if flow is not None:
            book(m, active & ~inter & (seg > 0.0), hit, start, seg,
                 s_stop_m, outward=False)
        s_stop = jnp.where(hit, s_stop_m, s_stop)
        cr_stop = jnp.where(hit, m, cr_stop)
        inter = inter | hit
        cum = c_new
    tau_surf = cum
    surface = active & surface_hit & ~inter
    s_stop = jnp.where(surface, s_surf, s_stop)
    for m in range(nr):                    # outbound segments
        seg = jnp.maximum(h[m + 1] - h[m], 0.0)
        c_new = cum + jnp.where(surface_hit, 0.0, kx[m] * seg)
        k_safe = jnp.where(kx[m] == 0.0, 1.0, kx[m])
        hit = active & ~inter & ~surface_hit & (c_new > tau_budget)
        s_stop_m = h[m] + (tau_budget - cum) / k_safe
        if flow is not None:
            book(m, active & ~inter & ~surface_hit & (seg > 0.0), hit,
                 h[m], seg, s_stop_m, outward=True)
        s_stop = jnp.where(hit, s_stop_m, s_stop)
        cr_stop = jnp.where(hit, m, cr_stop)
        inter = inter | hit
        cum = c_new
    exited = active & ~inter & ~surface
    return dict(s_stop=s_stop, cr=cr_stop, inter=inter,
                exited=exited, surface=surface, tau_surf=tau_surf)
