"""Batched spherical-grid traversal: the vectorised re-design of ``cell_face``.

The reference's geometric heart (ARTES.f90:2800-3470) walks one photon at a
time through nested if-chains over up to 9 candidate faces. Here the same
face-selection semantics are re-derived as fixed-shape vectorized math over a
photon batch:

* radial faces are concentric (oblate-scaled) ellipsoids -> one batched
  quadratic (ARTES.f90:2891-2907),
* theta faces are cones (quadratic with wrong-nappe rejection via the sign of
  z at the hit point, ARTES.f90:3030-3070), with the equatorial theta=90 face
  degenerating to the z=0 plane (``thetaplane==2``, ARTES.f90:3066-3070),
* phi faces are planes through the (scaled) z-axis (ARTES.f90:3292-3350),
* candidate selection keeps the reference's two-tier epsilon fallback
  (ARTES.f90:3356-3418) and its per-candidate validity thresholds, including
  the looser ``same-face`` threshold that allows a photon sitting on a face
  to re-cross it (ARTES.f90:2944, :3157).

Geometry runs in *scaled* coordinates: lengths are divided by the outer grid
radius so float32 has ~1e-7 relative resolution; epsilon tiers are
expressed in the same units (see :class:`GeomParams`).

Face encoding matches the reference: ``face[...,0]`` axis (0 = none,
1 = radial, 2 = theta, 3 = phi), ``face[...,1]`` face index on that axis.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = 1.0e30

def gather_rows(table, idx):
    """``table[idx]`` for (B,) integer ``idx``.

    A single-row table (every table of a one-cell grid) broadcasts its row
    instead of gathering: on the H100 the gathers of the nr=1 flagship round
    cost ~12 % of its throughput (PERF.md).
    """
    t = jnp.asarray(table)
    if t.shape[0] == 1:
        return jnp.broadcast_to(t[0], jnp.shape(idx) + t.shape[1:])
    return t[idx]


@partial(jax.tree_util.register_dataclass,
         data_fields=["rfront", "theta_tan", "theta_cos", "thetaplane_cone",
                      "theta_above", "phi_sin", "phi_cos", "r_pair",
                      "theta_combo", "phi_combo"],
         meta_fields=["nr", "ntheta", "nphi", "ob_ax", "ob_by", "ob_cz",
                      "pos_eps", "same_eps", "sel1", "sel2", "boundary_tol"])
@dataclasses.dataclass
class GridGeometry:
    """Device-resident grid tables (lengths scaled by the outer radius)."""

    rfront: jnp.ndarray          # (nr+1,)
    theta_tan: jnp.ndarray       # (ntheta+1,)
    theta_cos: jnp.ndarray       # (ntheta+1,)
    thetaplane_cone: jnp.ndarray  # (ntheta+1,) bool: True = cone, False = z=0 plane
    theta_above: jnp.ndarray     # (ntheta+1,) bool: theta < pi/2 (upper hemisphere cone)
    phi_sin: jnp.ndarray         # (nphi,)
    phi_cos: jnp.ndarray         # (nphi,)
    # combined per-cell lookup rows (one gather each in cell_face):
    r_pair: jnp.ndarray          # (nr, 2): rfront[i], rfront[i+1]
    theta_combo: jnp.ndarray     # (ntheta, 6): tan/cone/above for faces i, i+1
    phi_combo: jnp.ndarray       # (nphi, 4): sin/cos for faces i, (i+1) mod nphi
    # static metadata
    nr: int
    ntheta: int
    nphi: int
    ob_ax: float                 # 1/oblate_x etc. (ARTES.f90:2838-2840)
    ob_by: float
    ob_cz: float
    pos_eps: float               # root validity threshold (ref: 1e-15 m)
    same_eps: float              # same-face root threshold (ref: 1e-3 m)
    sel1: float                  # primary selection tier (ref: 1e-9 m)
    sel2: float                  # fallback selection tier (ref: 1e-12 m)
    boundary_tol: float          # no-candidate boundary-rescue tolerance


def make_grid_geometry(atm, oblateness=0.0, dtype=jnp.float64) -> tuple[GridGeometry, float]:
    """Build device tables from a host :class:`~artes.atmosphere.Atmosphere`.

    Returns ``(grid, r_scale)`` where ``r_scale`` is the outer radius in
    metres; all grid lengths are divided by it.
    """
    r_scale = float(atm.rfront[-1])
    # with jax_enable_x64 off, float64 arrays silently degrade to f32 — the
    # epsilon tiers must follow the dtype that will actually execute, or f32
    # math runs with f64-sized thresholds and geometry errors explode
    f64 = (dtype == jnp.float64
           and jnp.asarray(0.0, jnp.float64).dtype == jnp.float64)
    theta = np.asarray(atm.thetafront)
    rf = np.asarray(atm.rfront) / r_scale
    cone = (atm.thetaplane == 1).astype(float)
    above = (theta < np.pi / 2.0).astype(float)
    theta_combo = np.stack([
        atm.theta_tan[:-1], cone[:-1], above[:-1],
        atm.theta_tan[1:], cone[1:], above[1:],
    ], axis=1)
    nphi = atm.nphi
    nxt = (np.arange(nphi) + 1) % nphi
    phi_combo = np.stack([atm.phi_sin, atm.phi_cos,
                          atm.phi_sin[nxt], atm.phi_cos[nxt]], axis=1)
    # tables stay host-side (numpy): the jitted kernels upload them once per
    # dispatch
    npdtype = np.float64 if f64 else np.float32
    grid = GridGeometry(
        rfront=np.asarray(rf, dtype=npdtype),
        theta_tan=np.asarray(atm.theta_tan, dtype=npdtype),
        theta_cos=np.asarray(atm.theta_cos, dtype=npdtype),
        thetaplane_cone=np.asarray(atm.thetaplane == 1),
        theta_above=np.asarray(theta < np.pi / 2.0),
        phi_sin=np.asarray(atm.phi_sin, dtype=npdtype),
        phi_cos=np.asarray(atm.phi_cos, dtype=npdtype),
        r_pair=np.asarray(np.stack([rf[:-1], rf[1:]], axis=1), dtype=npdtype),
        theta_combo=np.asarray(theta_combo, dtype=npdtype),
        phi_combo=np.asarray(phi_combo, dtype=npdtype),
        nr=atm.nr, ntheta=atm.ntheta, nphi=atm.nphi,
        # a = 1/oblate_x with oblate_x = 1/(1-oblateness) (ARTES.f90:469-471,:2838)
        ob_ax=1.0 - oblateness,
        ob_by=1.0 - oblateness,
        ob_cz=1.0,
        # reference thresholds are absolute metres; scale them. For float32
        # the scaled f64 tiers fall below resolution, so floor them at values
        # matched to ~1e-7 relative precision.
        pos_eps=(1.0e-15 / r_scale) if f64 else 1.0e-12,
        same_eps=(1.0e-3 / r_scale) if f64 else max(1.0e-3 / r_scale, 3.0e-6),
        sel1=(1.0e-9 / r_scale) if f64 else max(1.0e-9 / r_scale, 1.0e-6),
        sel2=(1.0e-12 / r_scale) if f64 else max(1.0e-12 / r_scale, 1.0e-7),
        boundary_tol=1.0e-12 if f64 else 4.0e-7,
    )
    return grid, r_scale


def _quadratic(qa, qb, qc):
    """Numerically-stable quadratic roots, q-form (ARTES.f90:4154-4173).

    Returns (s1, s2); absent roots are 0 (matching the reference's sentinel).
    """
    disc = qb * qb - 4.0 * qa * qc
    ok = disc >= 0.0
    sqrt_disc = jnp.sqrt(jnp.where(ok, disc, 0.0))
    q = -0.5 * (qb + jnp.sign(qb) * sqrt_disc)
    q = jnp.where(qb == 0.0, -0.5 * sqrt_disc, q)  # sign(0)=0 guard
    s1 = jnp.where(ok & (jnp.abs(qa) > 1.0e-100), q / jnp.where(qa == 0, 1.0, qa), 0.0)
    s2 = jnp.where(ok & (jnp.abs(q) > 1.0e-100), qc / jnp.where(q == 0, 1.0, q), 0.0)
    return s1, s2


def _pick_root(s1, s2, eps):
    """Select the smallest root above ``eps`` (pattern at ARTES.f90:2897-2907)."""
    v1 = (s1 > eps) & (s1 < BIG)
    v2 = (s2 > eps) & (s2 < BIG)
    return jnp.where(
        v1 & v2, jnp.minimum(s1, s2),
        jnp.where(v1, s1, jnp.where(v2, s2, 0.0)),
    )


def _sphere_distance(g: GridGeometry, pos, dirn, r_face, eps):
    """Distance to the (oblate) sphere of scaled radius ``r_face``."""
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    nx, ny, nz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    qa = a * a * nx * nx + b * b * ny * ny + c * c * nz * nz
    qb = 2.0 * (a * a * x * nx + b * b * y * ny + c * c * z * nz)
    qc = a * a * x * x + b * b * y * y + c * c * z * z - r_face * r_face
    return _pick_root(*_quadratic(qa, qb, qc), eps)


def _cone_distance(g: GridGeometry, pos, dirn, tan_t, is_cone, above, eps):
    """Distance to a theta cone/plane face with wrong-nappe rejection.

    ``tan_t``/``is_cone``/``above`` are the pre-gathered per-lane face
    properties (tan theta_f; cone vs z=0 plane; theta_f < pi/2)."""
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    nx, ny, nz = dirn[..., 0], dirn[..., 1], dirn[..., 2]

    t2 = tan_t * tan_t
    qa = a * a * nx * nx + b * b * ny * ny - c * c * nz * nz * t2
    qb = 2.0 * (a * a * x * nx + b * b * y * ny - c * c * z * nz * t2)
    qc = a * a * x * x + b * b * y * y - c * c * z * z * t2
    s1, s2 = _quadratic(qa, qb, qc)

    def nappe_ok(s):
        z_test = z + s * nz
        # reject roots on the wrong nappe (ARTES.f90:3038-3051)
        wrong = ((z_test > 0.0) & ~above) | ((z_test < 0.0) & above)
        return jnp.where((s > g.pos_eps) & wrong, 0.0, s)

    d_cone = _pick_root(nappe_ok(s1), nappe_ok(s2), eps)

    # z=0 plane face (thetaplane==2): crossed moving up for the "above" side
    # of the cell, moving down otherwise (ARTES.f90:3066-3070, :3116-3120).
    s_plane = -z / jnp.where(nz == 0.0, 1.0, nz)
    return is_cone, d_cone, s_plane


def _phi_plane_distance(g: GridGeometry, pos, dirn, sin_p, cos_p, eps):
    """Distance to a phi half-plane with pre-gathered face trig
    (ARTES.f90:3300-3318)."""
    a, b = g.ob_ax, g.ob_by
    x, y = pos[..., 0], pos[..., 1]
    nx, ny = dirn[..., 0], dirn[..., 1]
    denom = b * ny * cos_p - a * nx * sin_p
    s = (a * x * sin_p - b * y * cos_p) / jnp.where(denom == 0.0, 1.0, denom)
    valid = (jnp.abs(denom) > 0.0) & (s > eps) & (s < BIG)
    return jnp.where(valid, s, 0.0)


def cell_face(g: GridGeometry, pos, dirn, cell, cur_face, cell_depth):
    """One traversal step for a batch of photons.

    Args:
      pos: (B, 3) scaled positions.
      dirn: (B, 3) unit directions.
      cell: (B, 3) int32 (ir, itheta, iphi).
      cur_face: (B, 2) int32 — axis (0 none / 1 r / 2 theta / 3 phi), index.
      cell_depth: scalar int — photon floor radial face (ARTES.f90:2329-2393).

    Returns dict with ``next_face`` (B,2), ``distance`` (B,), ``cell_out``
    (B,3), ``grid_exit`` (B,), ``error`` (B,).
    """
    cr, ct, cp = cell[..., 0], cell[..., 1], cell[..., 2]
    axis, fidx = cur_face[..., 0], cur_face[..., 1]
    cur_r = axis == 1
    cur_t = axis == 2
    cur_p = axis == 3

    dt = pos.dtype
    pos_eps = jnp.asarray(g.pos_eps, dt)
    same_eps = jnp.asarray(g.same_eps, dt)

    # ---- radial candidates ----
    rp = gather_rows(g.r_pair, cr)  # (B, 2): rfront[cr], rfront[cr+1]
    # inner sphere rfront[cr]: skipped when the photon just crossed it
    # moving outward (ARTES.f90:2909-2931 computes only the outward face then)
    r_in_active = ~(cur_r & (cr == fidx))
    d_r_in = jnp.where(
        r_in_active,
        _sphere_distance(g, pos, dirn, rp[..., 0], pos_eps),
        0.0,
    )
    # outer sphere rfront[cr+1]; when the photon sits on it after crossing
    # inward, it is the reference's "same face" with the 1e-3 threshold
    # (ARTES.f90:2933-2954)
    r_same = cur_r & (cr == fidx - 1)
    d_r_out = _sphere_distance(
        g, pos, dirn, rp[..., 1], jnp.where(r_same, same_eps, pos_eps)
    )

    # ---- theta candidates (skipped entirely for 1-cell polar grids: the only
    # faces are the degenerate poles, never crossable) ----
    if g.ntheta > 1:
        tc = gather_rows(g.theta_combo, ct)  # (B, 6)
        tan_in, cone_in, above_in = tc[..., 0], tc[..., 1] > 0.5, tc[..., 2] > 0.5
        tan_out, cone_out, above_out = tc[..., 3], tc[..., 4] > 0.5, tc[..., 5] > 0.5
        # the same-face tests only fire when fidx equals ct (inner) or ct+1
        # (outer), so the pre-gathered face properties apply
        t_in_same = cur_t & (ct == fidx) & ~above_in
        t_in_active = (ct > 0) & (
            ~cur_t | (cur_t & (ct == fidx - 1)) | t_in_same
        )
        is_cone_in, d_cone_in, s_plane_in = _cone_distance(
            g, pos, dirn, tan_in, cone_in, above_in,
            jnp.where(t_in_same, same_eps, pos_eps)
        )
        # plane branch: inner face is crossed moving up (ARTES.f90:3068)
        nz = dirn[..., 2]
        d_plane_in = jnp.where((s_plane_in > 0.0) & (nz > pos_eps), s_plane_in, 0.0)
        d_t_in = jnp.where(t_in_active, jnp.where(is_cone_in, d_cone_in, d_plane_in), 0.0)

        t_out_same = cur_t & (ct == fidx - 1) & above_out
        t_out_active = (ct + 1 < g.ntheta) & (
            ~cur_t | (cur_t & (ct == fidx)) | t_out_same
        )
        is_cone_out, d_cone_out, s_plane_out = _cone_distance(
            g, pos, dirn, tan_out, cone_out, above_out,
            jnp.where(t_out_same, same_eps, pos_eps)
        )
        d_plane_out = jnp.where((s_plane_out > 0.0) & (nz < -pos_eps), s_plane_out, 0.0)
        d_t_out = jnp.where(t_out_active, jnp.where(is_cone_out, d_cone_out, d_plane_out), 0.0)
    else:
        d_t_in = jnp.zeros_like(d_r_in)
        d_t_out = jnp.zeros_like(d_r_in)

    # ---- phi candidates ----
    if g.nphi > 1:
        pc = gather_rows(g.phi_combo, cp)  # (B, 4)
        p_outer_idx = jnp.where(cp + 1 == g.nphi, 0, cp + 1)
        p_inward = cur_p & ((cp == fidx - 1) | ((cp == g.nphi - 1) & (fidx == 0)))
        p_outward = cur_p & (cp == fidx) & ~p_inward
        p_in_active = ~cur_p | p_inward
        p_out_active = ~cur_p | p_outward
        d_p_in = jnp.where(
            p_in_active,
            _phi_plane_distance(g, pos, dirn, pc[..., 0], pc[..., 1], pos_eps), 0.0)
        d_p_out = jnp.where(
            p_out_active,
            _phi_plane_distance(g, pos, dirn, pc[..., 2], pc[..., 3], pos_eps), 0.0)
    else:
        p_outer_idx = jnp.zeros_like(cp)
        d_p_in = jnp.zeros_like(d_r_in)
        d_p_out = jnp.zeros_like(d_r_in)

    # ---- selection: two-tier epsilon (ARTES.f90:3356-3418) ----
    # candidate order mirrors the reference scan (slot-major): r,theta,phi in,
    # then r,theta,phi out.
    dists = jnp.stack([d_r_in, d_t_in, d_p_in, d_r_out, d_t_out, d_p_out], axis=-1)
    axes = jnp.broadcast_to(jnp.asarray([1, 2, 3, 1, 2, 3], jnp.int32), dists.shape)
    one = jnp.ones_like(cr)
    faces = jnp.stack([cr, ct, cp, cr + 1, ct + 1, p_outer_idx], axis=-1)

    def select(tier_eps):
        # min + argmin over the six candidates
        masked = jnp.where(dists > tier_eps, dists, BIG)
        best = jnp.argmin(masked, axis=-1)
        dist = jnp.min(masked, axis=-1)
        return best, dist

    best1, dist1 = select(jnp.asarray(g.sel1, dt))
    best2, dist2 = select(jnp.asarray(g.sel2, dt))
    use_fallback = dist1 >= BIG
    best = jnp.where(use_fallback, best2, best1)
    distance = jnp.where(use_fallback, dist2, dist1)
    no_candidate = distance >= BIG  # no candidate found (error 031)
    distance = jnp.where(no_candidate, 0.0, distance)

    # No-candidate rescue: float32 roundoff can land an interaction point
    # bitwise ON (or epsilon past) a radial boundary, where the sphere
    # quadratic sees qc >= 0 and yields no root even though the photon is
    # physically crossing. The reference never hits this in float64 (it
    # aborts the photon as error 031, ARTES.f90:3397-3416); at f32 the rate
    # is ~3e-4/interaction on thin shells, so boundary-pinned lanes are
    # resolved by position instead: on/over the outer face moving outward ->
    # grid exit; on/under the photon-floor face moving inward -> surface hit.
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    nx_, ny_, nz_ = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    rho2 = a * a * px * px + b * b * py * py + c * c * pz * pz
    rad_dot = a * a * px * nx_ + b * b * py * ny_ + c * c * pz * nz_
    tol = jnp.asarray(g.boundary_tol, dt)
    r_outer = g.rfront[g.nr]
    on_outer = no_candidate & (rho2 >= (r_outer * (1.0 - tol)) ** 2) & (rad_dot > 0.0)
    r_floor = g.rfront[cell_depth]
    on_floor = no_candidate & ~on_outer & (rho2 <= (r_floor * (1.0 + tol)) ** 2) \
        & (rad_dot < 0.0) & (cr == cell_depth)
    rescued = on_outer | on_floor
    error = no_candidate & ~rescued

    # the chosen candidate's axis and face: masked sums over the six slots
    slot = jax.lax.broadcasted_iota(jnp.int32, dists.shape, dists.ndim - 1)
    sel = slot == best[..., None]
    next_axis = jnp.sum(jnp.where(sel, axes, 0), axis=-1, dtype=jnp.int32)
    next_idx = jnp.sum(jnp.where(sel, faces, 0), axis=-1, dtype=jnp.int32)
    next_axis = jnp.where(rescued, 1, next_axis)
    next_idx = jnp.where(on_outer, g.nr,
                         jnp.where(on_floor, cell_depth, next_idx))

    # ---- next cell (ARTES.f90:2671-2798) ----
    outward = jnp.where(rescued, on_outer, best >= 3)
    cr_out = jnp.where(next_axis == 1, jnp.where(outward, cr + 1, cr - 1), cr)
    ct_out = jnp.where(next_axis == 2, jnp.where(outward, ct + 1, ct - 1), ct)
    cp_next = jnp.where(outward, cp + 1, cp - 1)
    cp_next = jnp.where(cp_next < 0, g.nphi - 1, jnp.where(cp_next >= g.nphi, 0, cp_next))
    cp_out = jnp.where(next_axis == 3, cp_next, cp)
    cell_out = jnp.stack([cr_out, ct_out, cp_out], axis=-1)

    grid_exit = (next_axis == 1) & (next_idx == g.nr)
    # degenerate surface bounce (error 034, ARTES.f90:3438-3468)
    err_degen = (
        cur_r & (fidx == cell_depth) & (next_axis == 1) & (next_idx == cell_depth)
    )
    next_face = jnp.stack([next_axis, next_idx * one], axis=-1)
    return {
        "next_face": next_face,
        "distance": distance,
        "cell_out": cell_out,
        "grid_exit": grid_exit,
        "error": error | err_degen,
        "err_nocand": error,       # error 031: no candidate face
        "err_degen": err_degen,    # error 034: degenerate surface bounce
    }


def heal_cell(g: GridGeometry, pos, cell, active):
    """Re-locate lanes whose tracked radial cell disagrees with the position.

    Float32 transport mislocates limb photons: the quadratic roots of a
    near-tangent sphere intersection carry O(sqrt(eps_f32)) ~ 3e-4 relative
    error, so the forced-first-interaction step can land a photon half a cell
    below its tracked cell. Every later peel walk from the inconsistent
    (pos, cell) state then fails (error 050 storms; measured 3.4k drops per
    20k photons on a thin-shell imaging config). The reference never sees
    this because f64 tangent roots err at ~1e-8 (ARTES.f90:2800-3470).

    Re-derives all three indices from the position, but only for ``active``
    lanes whose radius is outside the tracked cell by more than ``sel1`` —
    consistent lanes (and therefore f64 runs) are untouched bit-for-bit.
    """
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x = pos[..., 0] * a
    y = pos[..., 1] * b
    z = pos[..., 2] * c
    rho = jnp.sqrt(x * x + y * y + z * z)
    cr = cell[..., 0]
    r_lo = g.rfront[jnp.clip(cr, 0, g.nr - 1)]
    r_hi = g.rfront[jnp.clip(cr + 1, 0, g.nr)]
    bad = active & ((rho < r_lo - g.sel1) | (rho > r_hi + g.sel1))
    r_idx = jnp.clip(
        jnp.searchsorted(g.rfront, rho, side="right").astype(jnp.int32) - 1,
        0, g.nr - 1)
    located = locate_cell(g, pos, r_idx)
    return jnp.where(bad[..., None], located, cell)


def locate_cell(g: GridGeometry, pos, radial_index):
    """Find the (theta, phi) cell of a point; radial index supplied by the
    caller (nr-1 for stellar entry, sampled for thermal; ARTES.f90:2605-2669).
    """
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x = pos[..., 0] * a
    y = pos[..., 1] * b
    z = pos[..., 2] * c
    r = jnp.sqrt(x * x + y * y + z * z)
    theta = jnp.arccos(jnp.clip(z / jnp.maximum(r, 1e-300), -1.0, 1.0))
    phi = jnp.arctan2(y, x)
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    cos_t = jnp.cos(theta)
    # theta_cos is decreasing; cell j has cos in (cos[j+1], cos[j])
    ct = jnp.sum(cos_t[..., None] < g.theta_cos[1:-1][None, :], axis=-1) if g.ntheta > 1 \
        else jnp.zeros_like(radial_index)
    if g.nphi > 1:
        phifront = jnp.arctan2(g.phi_sin, g.phi_cos)
        phifront = jnp.where(phifront < 0.0, phifront + 2.0 * jnp.pi, phifront)
        cp = jnp.clip(jnp.sum(phi[..., None] >= phifront[None, 1:], axis=-1), 0, g.nphi - 1)
    else:
        cp = jnp.zeros_like(radial_index)
    return jnp.stack([radial_index, ct.astype(jnp.int32), cp.astype(jnp.int32)], axis=-1)
